"""RG-LRU scan: a tensor on the CPU goes to the plain PyTorch version
(:mod:`.ref`), a tensor on a CUDA device to the CUDA kernel
(:mod:`.kernel`), which launches or raises.

The kernel has no backward yet: on a card, a call that needs a gradient
raises ``NotImplementedError`` before anything launches (the output of a
forward-only launch would carry no gradient back)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rg_lru.kernel import rglru_scan_kernel
from repro_torch.kernels.rg_lru.ref import rglru_scan_ref


def rglru_scan(a: torch.Tensor, b: torch.Tensor):
    """h_t = a_t * h_{t-1} + b_t over axis 1 from a zero state.
    a/b (B,S,W) -> (h (B,S,W), h[:, -1] (B,W)) in a's dtype."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if _build.needs_grad(a, b):
        raise NotImplementedError(
            "rglru_scan has no backward kernel yet: training the hybrid "
            "family on a card waits for the RG-LRU scan's backward kernel "
            "(ROADMAP.md queue A, item 1); call it under torch.no_grad(), or "
            "train on the CPU")
    return rglru_scan_kernel(a.contiguous(), b.contiguous())
