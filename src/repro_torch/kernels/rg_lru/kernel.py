"""CUDA RG-LRU scan and its backward (``csrc/rg_lru.cu``): the wrappers
that launch them.

It checks device, dtypes, shapes and contiguity and raises on anything the
kernel does not take, allocates the outputs, launches on PyTorch's current
stream and raises if the launch returned an error.  ``LAUNCHES`` counts
launches.  The entry points are looked up once, and a launch on the current
device enters no device context: the scans are short enough that the
host's time before the launch shows in their wall time.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"rglru_scan": 0, "rglru_scan_bwd": 0}

_ENTRY = {torch.float32: "rglru_scan_f32", torch.bfloat16: "rglru_scan_bf16"}
_FNS: dict = {}


def _launch(name: str, device: torch.device, *args) -> int:
    """Call the entry point ``name`` with ``args`` and PyTorch's current
    stream on ``device``; returns its error code."""
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(_build.load("rg_lru"), name)
    if device.index == torch.cuda.current_device():
        # the current stream's raw cudaStream_t, without a torch.cuda.Stream
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return fn(*args, _build.stream_handle(device))


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
    err = _launch(_ENTRY[a.dtype], a.device, a.data_ptr(), b.data_ptr(),
                  h.data_ptr(), last.data_ptr(), B, S, W)
    if err:
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
    err = _launch("rglru_scan_bwd_f32", a.device, a.data_ptr(), h.data_ptr(),
                  dh.data_ptr(), None if dlast is None else dlast.data_ptr(),
                  da.data_ptr(), db.data_ptr(), B, S, W)
    if err:
        _build.check(err, f"rglru_scan_bwd (B={B}, S={S}, W={W})")
    LAUNCHES["rglru_scan_bwd"] += 1
    return da, db


def launch_config(B: int, S: int, W: int, dtype=torch.float32,
                  backward: bool = False) -> dict:
    """The launch the forward (f32 or bf16) or backward kernel makes on the
    current device for (B,S,W) inputs: ``{"grid": [x, y], "threads",
    "smem_bytes" (dynamic shared memory a block), "band" (channels a
    block), "copy_bytes" (16: cp.async of 16 bytes, for row pitches that
    are a multiple of 16 bytes; else one element: 4, an f32 by cp.async,
    or 2, a bf16 by a synchronous load and store)}``."""
    kind = 2 if backward else {torch.float32: 0, torch.bfloat16: 1}[dtype]
    out = (ctypes.c_int * 6)()
    err = _build.load("rg_lru").rglru_scan_config(B, S, W, kind,
                                                  ctypes.addressof(out))
    _build.check(err, f"rglru_scan config (B={B}, S={S}, W={W})")
    return {"grid": [out[0], out[1]], "threads": out[2],
            "smem_bytes": out[3], "band": out[4], "copy_bytes": out[5]}
