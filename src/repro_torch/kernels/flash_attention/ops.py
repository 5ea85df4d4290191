"""Flash attention: a tensor on the CPU goes to the plain PyTorch version
(:mod:`.ref`, differentiable by autograd), a tensor on a CUDA device to
the CUDA kernels (:mod:`.kernel`), which launch or raise.

On a card, a call that needs a gradient (grad mode on and any input
requiring grad) runs as a ``torch.autograd.Function``: the forward kernel
also writes each row's log-sum-exp, and the backward is the hand-written
backward kernel (bf16 on the tensor cores at every head dim, f32 on the
CUDA cores: ``kernel.bwd_route``).  A call without grad (serving,
``torch.no_grad``) runs the forward alone and writes no log-sum-exp."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_kernel, flash_attention_kernel,
)
from repro_torch.kernels.flash_attention.ref import attention_ref


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_kernel(q, k, v, causal=causal, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(q, k, v, o, lse,
                                                do.contiguous(),
                                                causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B,H,S,hd); k/v (B,KV,S,hd) -> (B,H,S,hd)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _build.needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal)
    return flash_attention_kernel(q, k, v, causal=causal)
