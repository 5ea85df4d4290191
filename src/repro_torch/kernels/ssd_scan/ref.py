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


def ssd_scan_bwd_ref(xdt, Bm, Cm, cums, dy, dstate=None):
    """The gradient of :func:`ssd_scan_ref` with respect to its four inputs:
    the chunked decomposition's transpose, in f32.  dy (B,H,nc,Q,P) is the
    gradient of y, dstate (B,H,P,N) that of the final state (zero when
    None) -> (dxdt, dBm, dCm in their inputs' dtypes, dcums f32).

    Per (b, h) and chunk, with G = C B^T, L_ij = exp(cu_i - cu_j) for
    i >= j (0 above), w_j = exp(cu_last - cu_j), s the state entering the
    chunk (recomputed here as the forward computes it) and dS the gradient
    of the state leaving it, walking the chunks from the last:
      dX  = (G o L)^T dY + (B o w) dS^T
      dM  = tril(dY X^T),  dG = dM o L
      dC  = dG B + (dY s) o exp(cu),  dB = dG^T C + (X dS) o w  (summed
            over the heads, which share B and C)
      dcu = rowsum(dG o G) - colsum(dG o G) + rowdot(dY, y_inter) - t,
            t_j = w_j (X dS B^T)_jj, and at the last position also
            sum_j t_j + exp(cu_last) <dS, s>
      dS <- exp(cu_last) dS + dY^T (C o exp(cu))   (the state entering)."""
    B, H, nc, Q, P = xdt.shape
    N = Bm.shape[-1]
    dev = xdt.device
    x = xdt.float()
    Bf = Bm.float()[:, None]                         # (B,1,nc,Q,N)
    Cf = Cm.float()[:, None]
    dyf = dy.float()
    causal = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    zero = torch.zeros((), device=dev)
    s = torch.zeros((B, H, P, N), dtype=torch.float32, device=dev)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        cu = cums[:, :, c].float()
        last = cu[..., -1:]
        delta = x[:, :, c].transpose(-1, -2) @ (
            Bf[:, :, c] * torch.exp(last - cu)[..., None])
        s = torch.exp(last)[..., None] * s + delta
    dS = (torch.zeros((B, H, P, N), dtype=torch.float32, device=dev)
          if dstate is None else dstate.float())
    dx = torch.empty((B, H, nc, Q, P), dtype=torch.float32, device=dev)
    dB = torch.empty((B, nc, Q, N), dtype=torch.float32, device=dev)
    dC = torch.empty((B, nc, Q, N), dtype=torch.float32, device=dev)
    dcums = torch.empty((B, H, nc, Q), dtype=torch.float32, device=dev)
    for c in range(nc - 1, -1, -1):
        cu = cums[:, :, c].float()                   # (B,H,Q)
        e, last = torch.exp(cu), cu[..., -1:]
        w = torch.exp(last - cu)
        xc, dyc, Bc, Cc = x[:, :, c], dyf[:, :, c], Bf[:, :, c], Cf[:, :, c]
        L = torch.where(causal, torch.exp(cu[..., :, None] - cu[..., None, :]),
                        zero)
        G = Cc @ Bc.transpose(-1, -2)                # (B,1,Q,Q)
        dx[:, :, c] = ((G * L).transpose(-1, -2) @ dyc
                       + (Bc * w[..., None]) @ dS.transpose(-1, -2))
        dG = torch.where(causal, dyc @ xc.transpose(-1, -2), zero) * L
        dys = dyc @ s_in[c]                          # (B,H,Q,N)
        xds = xc @ dS                                # (B,H,Q,N)
        dC[:, c] = (dG @ Bc + dys * e[..., None]).sum(1)
        dB[:, c] = (dG.transpose(-1, -2) @ Cc + xds * w[..., None]).sum(1)
        T = dG * G
        t = w * (xds * Bc).sum(-1)
        dcu = (T.sum(-1) - T.sum(-2) + e * (Cc * dys).sum(-1) - t)
        dcu[..., -1] += t.sum(-1) + torch.exp(last[..., 0]) * (
            dS * s_in[c]).sum((-1, -2))
        dcums[:, :, c] = dcu
        dS = (torch.exp(last)[..., None] * dS
              + dyc.transpose(-1, -2) @ (Cc * e[..., None]))
    return dx.to(xdt.dtype), dB.to(Bm.dtype), dC.to(Cm.dtype), dcums
