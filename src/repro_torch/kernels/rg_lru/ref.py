"""Plain PyTorch RG-LRU recurrence: the version the CUDA kernel is held
against, and what a CPU tensor takes."""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor):
    """h_t = a_t * h_{t-1} + b_t over axis 1 from a zero state, a loop over
    S with an f32 carry (a product, then a sum, each rounded to f32, as the
    kernel computes).  a/b (B,S,W), S >= 1 -> (h (B,S,W), h[:, -1] (B,W)),
    both in a's dtype."""
    B, S, W = a.shape
    if S < 1:
        raise ValueError("the scan needs S >= 1")
    af, bf = a.float(), b.float()
    h = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    carry = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    for t in range(S):
        carry = af[:, t] * carry + bf[:, t]
        h[:, t] = carry
    return h.to(a.dtype), carry.to(a.dtype)
