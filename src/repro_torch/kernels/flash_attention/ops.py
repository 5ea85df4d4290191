"""Flash attention: a tensor on the CPU goes to the plain PyTorch version
(:mod:`.ref`), a tensor on a CUDA device to the CUDA kernel
(:mod:`.kernel`), which launches or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B,H,S,hd); k/v (B,KV,S,hd) -> (B,H,S,hd)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    return flash_attention_kernel(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal)
