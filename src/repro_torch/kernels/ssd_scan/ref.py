"""Plain PyTorch Mamba-2 SSD scan: the version the CUDA kernel is held
against, and what a CPU tensor takes.  It runs the kernel's own
chunk-sequential algorithm on the pre-arranged inputs, in f32; the tests
hold it against the reference's XLA ``ssd_chunked`` (``ssd_ref``) and its
Pallas kernel.
"""
from __future__ import annotations

import torch


def ssd_scan_ref(xdt, Bm, Cm, cums):
    """xdt (B,H,nc,Q,P); Bm/Cm (B,nc,Q,N); cums (B,H,nc,Q) f32 ->
    (y (B,H,nc,Q,P) in xdt's dtype, final state (B,H,P,N) f32)."""
    B, H, nc, Q, P = xdt.shape
    N = Bm.shape[-1]
    x = xdt.float()
    Bf = Bm.float()[:, None]                         # (B,1,nc,Q,N)
    Cf = Cm.float()[:, None]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xdt.device).tril()
    s = torch.zeros((B, H, P, N), dtype=torch.float32, device=xdt.device)
    ys = []
    for c in range(nc):
        cu = cums[:, :, c].float()                   # (B,H,Q)
        xc, Bc, Cc = x[:, :, c], Bf[:, :, c], Cf[:, :, c]
        L = torch.where(causal, torch.exp(cu[..., :, None] - cu[..., None, :]),
                        torch.zeros((), device=xdt.device))
        y_intra = ((Cc @ Bc.transpose(-1, -2)) * L) @ xc
        y_inter = (Cc * torch.exp(cu)[..., None]) @ s.transpose(-1, -2)
        ys.append((y_intra + y_inter).to(xdt.dtype))
        last = cu[..., -1:]                          # (B,H,1)
        delta = xc.transpose(-1, -2) @ (Bc * torch.exp(last - cu)[..., None])
        s = torch.exp(last)[..., None] * s + delta
    return torch.stack(ys, dim=2), s
