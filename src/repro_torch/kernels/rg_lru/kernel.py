"""CUDA RG-LRU scan and its backward (``csrc/rg_lru.cu``): the wrappers
that launch them.

It checks device, dtypes, shapes and contiguity and raises on anything the
kernel does not take, allocates the outputs, launches on PyTorch's current
stream and raises if the launch returned an error.  ``LAUNCHES`` counts
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = {"rglru_scan": 0, "rglru_scan_bwd": 0}

_ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def rglru_scan_kernel(a: torch.Tensor, b: torch.Tensor):
    """a/b (B,S,W), contiguous, one dtype (f32 or bf16), S >= 1 ->
    (h (B,S,W), h[:, -1] (B,W)), both in a's dtype.  Any S and W."""
    if a.dim() != 3:
        raise ValueError(f"a: expected (B,S,W), got {tuple(a.shape)}")
    B, S, W = a.shape
    if S < 1:
        raise ValueError("the scan needs S >= 1")
    if a.dtype not in _ENTRY or b.dtype != a.dtype:
        raise TypeError(f"a, b: dtypes {a.dtype}, {b.dtype}; the kernel takes "
                        f"one of {tuple(_ENTRY)} for both")
    if b.shape != a.shape:
        raise ValueError(f"b: shape {tuple(b.shape)}, expected {(B, S, W)}")
    _build.check_tensor(a, "a", tuple(_ENTRY), (B, S, W))
    _build.check_tensor(b, "b", (a.dtype,), (B, S, W))
    if b.device != a.device:
        raise ValueError("a and b lie on different devices")
    h = torch.empty_like(a)
    last = torch.empty((B, W), dtype=a.dtype, device=a.device)
    if a.numel() == 0:
        return h, last
    lib = _build.load("rg_lru")
    fn = getattr(lib, f"rglru_scan_{_ENTRY[a.dtype]}")
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), last.data_ptr(),
                 B, S, W, _build.stream_handle(a.device))
    _build.check(err, f"rglru_scan (B={B}, S={S}, W={W})")
    LAUNCHES["rglru_scan"] += 1
    return h, last


def rglru_scan_bwd_kernel(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                          dlast: torch.Tensor | None = None):
    """The gradient of :func:`rglru_scan_kernel` with respect to a and b:
    a/h/dh (B,S,W) f32 (h the forward's output), dlast (B,W) f32 or None
    (a zero gradient of the final state), all contiguous -> (da, db) f32
    (B,S,W), bit for bit ``ref.rglru_scan_bwd_ref``.  Any S >= 1 and W."""
    if a.dim() != 3:
        raise ValueError(f"a: expected (B,S,W), got {tuple(a.shape)}")
    B, S, W = a.shape
    if S < 1:
        raise ValueError("the scan needs S >= 1")
    for name, t in (("a", a), ("h", h), ("dh", dh)):
        _build.check_tensor(t, name, (torch.float32,), (B, S, W))
    if dlast is not None:
        _build.check_tensor(dlast, "dlast", (torch.float32,), (B, W))
    for t in (h, dh) if dlast is None else (h, dh, dlast):
        if t.device != a.device:
            raise ValueError("the inputs lie on different devices")
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    lib = _build.load("rg_lru")
    with torch.cuda.device(a.device):
        err = lib.rglru_scan_bwd_f32(
            a.data_ptr(), h.data_ptr(), dh.data_ptr(),
            None if dlast is None else dlast.data_ptr(), da.data_ptr(),
            db.data_ptr(), B, S, W, _build.stream_handle(a.device))
    _build.check(err, f"rglru_scan_bwd (B={B}, S={S}, W={W})")
    LAUNCHES["rglru_scan_bwd"] += 1
    return da, db
