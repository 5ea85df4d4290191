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


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                       dlast: torch.Tensor | None = None):
    """The gradient of :func:`rglru_scan_ref` with respect to a and b, from
    its output h and the gradients of h and of the final state (``dlast``,
    zero when None), all f32: the same recurrence run in reverse,
    g_{S-1} = dh_{S-1} + dlast, g_t = dh_t + a_{t+1} * g_{t+1}; then
    db_t = g_t and da_t = g_t * h_{t-1}, with h_{-1} = 0.  A loop over S
    from the end, each product and sum rounded to f32, as the kernel
    computes.  a/h/dh (B,S,W), dlast (B,W) -> (da, db), both f32 (B,S,W)."""
    B, S, W = a.shape
    if S < 1:
        raise ValueError("the scan needs S >= 1")
    af, hf, dhf = a.float(), h.float(), dh.float()
    da = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    db = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    g = dhf[:, S - 1] if dlast is None else dhf[:, S - 1] + dlast.float()
    for t in range(S - 1, -1, -1):
        if t < S - 1:
            g = dhf[:, t] + af[:, t + 1] * g
        db[:, t] = g
        da[:, t] = g * (hf[:, t - 1] if t else torch.zeros_like(g))
    return da, db
