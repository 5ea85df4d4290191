"""RG-LRU scan: a tensor on the CPU goes to the plain PyTorch version
(:mod:`.ref`), a tensor on a CUDA device to the CUDA kernel
(:mod:`.kernel`), which launches or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.rg_lru.kernel import rglru_scan_kernel
from repro_torch.kernels.rg_lru.ref import rglru_scan_ref


def rglru_scan(a: torch.Tensor, b: torch.Tensor):
    """h_t = a_t * h_{t-1} + b_t over axis 1 from a zero state.
    a/b (B,S,W) -> (h (B,S,W), h[:, -1] (B,W)) in a's dtype."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    return rglru_scan_kernel(a.contiguous(), b.contiguous())
