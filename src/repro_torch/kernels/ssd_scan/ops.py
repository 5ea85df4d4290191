"""SSD scan with the reference wrapper's signature: pre-arranges ``x*dt``
and the within-chunk cumsums as ``repro/kernels/ssd_scan/ops.py`` does, then
a tensor on the CPU goes to the plain version (:func:`.ref.ssd_scan_ref`),
a tensor on a CUDA device to the CUDA kernel, which launches or raises.

A call that needs a gradient (grad mode on and an input requiring grad)
runs the scan of the arranged inputs as a ``torch.autograd.Function``: on
a card the forward kernel, then the backward kernel
(``csrc/ssd_scan_bwd.cu``); on the CPU the plain forward and
``ssd_scan_bwd_ref``.  ``arrange`` stays in autograd, so the gradient of
the cumsums flows on to dt and A.  A call without grad (serving,
``torch.no_grad``) runs the forward alone."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.kernel import (
    ssd_scan_bwd_kernel, ssd_scan_kernel,
)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref, ssd_scan_ref


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


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xdt, Bm, Cm, cums):
        ctx.set_materialize_grads(False)
        scan = ssd_scan_ref if xdt.device.type == "cpu" else ssd_scan_kernel
        y, state = scan(xdt, Bm, Cm, cums)
        ctx.save_for_backward(xdt, Bm, Cm, cums)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        xdt, Bm, Cm, cums = ctx.saved_tensors
        dy = torch.zeros_like(xdt) if dy is None else dy.contiguous()
        if xdt.device.type == "cpu":
            return ssd_scan_bwd_ref(xdt, Bm, Cm, cums, dy, dstate)
        return ssd_scan_bwd_kernel(
            xdt, Bm, Cm, cums, dy,
            None if dstate is None else dstate.contiguous())


def ssd_scan(x, dt, A, B_in, C_in, *, chunk: int = 256):
    """Returns (y (B,S,H,P), final_state (B,H,P,N) in x's dtype)."""
    B, S, H, P = x.shape
    ins = arrange(x, dt, A, B_in, C_in, chunk)
    if _build.needs_grad(*ins):
        y, state = _SSDScan.apply(*ins)
    elif x.device.type == "cpu":
        y, state = ssd_scan_ref(*ins)
    else:
        y, state = ssd_scan_kernel(*ins)
    y = y.permute(0, 2, 3, 1, 4).reshape(B, S, H, P)
    return y, state.to(x.dtype)
