"""RG-LRU scan: a tensor on the CPU goes to the plain PyTorch version
(:mod:`.ref`), a tensor on a CUDA device to the CUDA kernel
(:mod:`.kernel`), which launches or raises.

A call that needs a gradient (grad mode on and a or b requiring grad) runs
as a ``torch.autograd.Function``: on a card the forward kernel, then the
backward kernel (``rglru_scan_bwd_f32``); on the CPU the plain forward and
``rglru_scan_bwd_ref``.  It takes f32 a and b (the model's coefficients
are f32) and raises ``ValueError`` on any other dtype.  A call without
grad (serving, ``torch.no_grad``) runs the forward alone."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rg_lru.kernel import (
    rglru_scan_bwd_kernel, rglru_scan_kernel,
)
from repro_torch.kernels.rg_lru.ref import rglru_scan_bwd_ref, rglru_scan_ref


class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.set_materialize_grads(False)
        if a.device.type == "cpu":
            h, last = rglru_scan_ref(a, b)
        else:
            a = a.contiguous()
            h, last = rglru_scan_kernel(a, b.contiguous())
        ctx.save_for_backward(a, h)
        return h, last

    @staticmethod
    def backward(ctx, dh, dlast):
        a, h = ctx.saved_tensors
        dh = torch.zeros_like(h) if dh is None else dh.contiguous()
        if a.device.type == "cpu":
            return rglru_scan_bwd_ref(a, h, dh, dlast)
        return rglru_scan_bwd_kernel(
            a, h, dh, None if dlast is None else dlast.contiguous())


def rglru_scan(a: torch.Tensor, b: torch.Tensor):
    """h_t = a_t * h_{t-1} + b_t over axis 1 from a zero state.
    a/b (B,S,W) -> (h (B,S,W), h[:, -1] (B,W)) in a's dtype."""
    if _build.needs_grad(a, b):
        if a.dtype != torch.float32 or b.dtype != torch.float32:
            raise ValueError(f"rglru_scan under grad takes f32 a and b, got "
                             f"{a.dtype} and {b.dtype}")
        return _RGLRUScan.apply(a, b)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    return rglru_scan_kernel(a.contiguous(), b.contiguous())
