"""SSD scan with the reference wrapper's signature: pre-arranges ``x*dt``
and the within-chunk cumsums as ``repro/kernels/ssd_scan/ops.py`` does, then
a tensor on the CPU goes to the plain version (:func:`.ref.ssd_scan_ref`),
a tensor on a CUDA device to the CUDA kernel, which launches or raises.

The kernel has no backward yet: on a card, a call that needs a gradient
raises ``NotImplementedError`` before anything launches (the output of a
forward-only launch would carry no gradient back)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


def arrange(x, dt, A, B_in, C_in, chunk: int):
    """x (B,S,H,P); dt (B,S,H) post-softplus; A (H,) < 0; B_in/C_in (B,S,N)
    -> the kernel's inputs (xdt, Bm, Cm, cums), contiguous.  S % chunk == 0
    unless S < chunk (one chunk)."""
    B, S, H, P = x.shape
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"S={S} is not a multiple of the chunk {Q}; the "
                         f"caller pads (the model path does)")
    nc = S // Q
    dA = dt.float() * A.float()                               # (B,S,H)
    cums = torch.cumsum(dA.reshape(B, nc, Q, H), dim=2)
    cums = cums.permute(0, 3, 1, 2).contiguous()              # (B,H,nc,Q)
    xdt = x * dt[..., None].to(x.dtype)                       # (B,S,H,P)
    xdt = xdt.reshape(B, nc, Q, H, P).permute(0, 3, 1, 2, 4).contiguous()
    Bm = B_in.reshape(B, nc, Q, -1).contiguous()
    Cm = C_in.reshape(B, nc, Q, -1).contiguous()
    return xdt, Bm, Cm, cums


def ssd_scan(x, dt, A, B_in, C_in, *, chunk: int = 256):
    """Returns (y (B,S,H,P), final_state (B,H,P,N) in x's dtype)."""
    if x.device.type != "cpu" and _build.needs_grad(x, dt, A, B_in, C_in):
        raise NotImplementedError(
            "ssd_scan has no backward kernel yet: training the ssm family on "
            "a card waits for the SSD scan's backward kernel (ROADMAP.md "
            "queue A, item 1); call it under torch.no_grad(), or train on "
            "the CPU")
    B, S, H, P = x.shape
    xdt, Bm, Cm, cums = arrange(x, dt, A, B_in, C_in, chunk)
    if x.device.type == "cpu":
        y, state = ssd_scan_ref(xdt, Bm, Cm, cums)
    else:
        y, state = ssd_scan_kernel(xdt, Bm, Cm, cums)
    y = y.permute(0, 2, 3, 1, 4).reshape(B, S, H, P)
    return y, state.to(x.dtype)
