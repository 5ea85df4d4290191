"""CUDA SSD chunk scan (``csrc/ssd_scan.cu``) and its backward
(``csrc/ssd_scan_bwd.cu``): the wrappers that launch them.

It checks device, dtypes, shapes, head dim and contiguity and raises on
anything the kernel does not take (the kernel itself refuses sizes above
its shared-memory limit), allocates the outputs, launches on
PyTorch's current stream and raises if the launch returned an error.
``LAUNCHES`` counts calls that launched (one a call, however many kernels
run behind it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"ssd_scan": 0, "ssd_scan_bwd": 0}

HEAD_DIMS = (16, 32, 64, 128)
# the backward's limits and layout, as csrc/ssd_scan_bwd.cu sets them: N up
# to BWD_MAX_STATE (in bf16 a multiple of BWD_TC_STATE_STEP, the tensor
# cores' depth), blocks of BWD_HEAD_BLOCK heads, BWD_TILE-row tiles, the
# state passed in slices of BWD_PASS_ELEMS elements, each slice's share of
# exp(cu_last)<dS, s> in BWD_PASS_PARTS parts (one a warp in bf16)
BWD_MAX_STATE = 128
BWD_TC_STATE_STEP = 16
BWD_HEAD_BLOCK = 8
BWD_TILE = 64
BWD_PASS_ELEMS = 1024
BWD_PASS_PARTS = {torch.float32: 1, torch.bfloat16: 4}
_ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def ssd_scan_kernel(xdt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                    cums: torch.Tensor):
    """xdt (B,H,nc,Q,P); Bm/Cm (B,nc,Q,N) in xdt's dtype (f32 or bf16);
    cums (B,H,nc,Q) f32 -> (y (B,H,nc,Q,P) in xdt's dtype, state (B,H,P,N)
    f32).  P in ``HEAD_DIMS``; the kernel refuses (P, N, Q) whose tiles
    need more shared memory than a block may hold, and in bf16 an N that is
    not a multiple of 16 (see the .cu header)."""
    if xdt.dim() != 5 or Bm.dim() != 4:
        raise ValueError(f"xdt, Bm: expected 5-D and 4-D, got "
                         f"{tuple(xdt.shape)}, {tuple(Bm.shape)}")
    B, H, nc, Q, P = xdt.shape
    N = Bm.shape[-1]
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim {P} not in {HEAD_DIMS}")
    _build.check_tensor(xdt, "xdt", tuple(_ENTRY), (B, H, nc, Q, P))
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        _build.check_tensor(t, name, (xdt.dtype,), (B, nc, Q, N))
    _build.check_tensor(cums, "cums", (torch.float32,), (B, H, nc, Q))
    for t in (Bm, Cm, cums):
        if t.device != xdt.device:
            raise ValueError("the inputs lie on different devices")
    y = torch.empty_like(xdt)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=xdt.device)
    if xdt.numel() == 0 or N == 0:
        return y, state.zero_()
    lib = _build.load("ssd_scan")
    ptrs = [xdt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), cums.data_ptr(),
            y.data_ptr(), state.data_ptr()]
    if xdt.dtype == torch.bfloat16:
        # the tensor-core route's workspace: each chunk's own state (f32),
        # then the state entering it (bf16 hi and lo)
        work = torch.empty((2, B, H, nc, P, N), dtype=torch.float32,
                           device=xdt.device)
        ptrs.append(work.data_ptr())
    fn = getattr(lib, f"ssd_scan_{_ENTRY[xdt.dtype]}")
    with torch.cuda.device(xdt.device):
        err = fn(*ptrs, B, H, nc, Q, P, N, _build.stream_handle(xdt.device))
    _build.check(err, f"ssd_scan (P={P}, N={N}, Q={Q})")
    LAUNCHES["ssd_scan"] += 1
    return y, state


def ssd_scan_bwd_kernel(xdt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                        cums: torch.Tensor, dy: torch.Tensor,
                        dstate: torch.Tensor | None = None):
    """The gradient of :func:`ssd_scan_kernel` with respect to its four
    inputs: xdt/dy (B,H,nc,Q,P), Bm/Cm (B,nc,Q,N) in one dtype (f32 or
    bf16), cums (B,H,nc,Q) f32, dstate (B,H,P,N) f32 or None (a zero
    gradient of the final state), all contiguous -> (dxdt, dBm, dCm in the
    inputs' dtype, dcums f32).  P in ``HEAD_DIMS``, N up to
    ``BWD_MAX_STATE``, in bf16 (the tensor-core route) a multiple of
    ``BWD_TC_STATE_STEP``; the kernel refuses sizes whose tiles need more
    shared memory than a block may hold.  Deterministic (no atomics)."""
    if xdt.dim() != 5 or Bm.dim() != 4:
        raise ValueError(f"xdt, Bm: expected 5-D and 4-D, got "
                         f"{tuple(xdt.shape)}, {tuple(Bm.shape)}")
    B, H, nc, Q, P = xdt.shape
    N = Bm.shape[-1]
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim {P} not in {HEAD_DIMS}")
    if N > BWD_MAX_STATE:
        raise ValueError(f"state size {N} above the backward's "
                         f"{BWD_MAX_STATE}")
    if xdt.dtype == torch.bfloat16 and N % BWD_TC_STATE_STEP:
        raise ValueError(f"state size {N}: the bf16 backward takes a "
                         f"multiple of {BWD_TC_STATE_STEP}")
    _build.check_tensor(xdt, "xdt", tuple(_ENTRY), (B, H, nc, Q, P))
    _build.check_tensor(dy, "dy", (xdt.dtype,), (B, H, nc, Q, P))
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        _build.check_tensor(t, name, (xdt.dtype,), (B, nc, Q, N))
    _build.check_tensor(cums, "cums", (torch.float32,), (B, H, nc, Q))
    if dstate is not None:
        _build.check_tensor(dstate, "dstate", (torch.float32,), (B, H, P, N))
    for t in (Bm, Cm, cums, dy) if dstate is None else (Bm, Cm, cums, dy,
                                                         dstate):
        if t.device != xdt.device:
            raise ValueError("the inputs lie on different devices")
    dxdt, dB, dC = (torch.empty_like(t) for t in (xdt, Bm, Cm))
    dcums = torch.empty_like(cums)
    if xdt.numel() == 0 or N == 0:
        for t in (dxdt, dB, dC, dcums):
            t.zero_()
        return dxdt, dB, dC, dcums
    # the workspaces: the chunk states and state gradients (in bf16, after
    # the state passing, each 8 entries' 32 bytes hold them as bf16 hi + lo);
    # dB and dC per block of heads; per chunk, each tile's sum of t and each
    # slice's parts of exp(cu_last)<dS, s>
    tiles = -(-Q // BWD_TILE)
    slices = -(-P * N // BWD_PASS_ELEMS) * BWD_PASS_PARTS[xdt.dtype]
    nhb = -(-H // BWD_HEAD_BLOCK)
    f32, dev = torch.float32, xdt.device
    states = torch.empty((2, B, H, nc, P, N), dtype=f32, device=dev)
    parts = torch.empty((2, B, nhb, nc, Q, N), dtype=f32, device=dev)
    sdot = torch.empty((B, H, nc, tiles + slices), dtype=f32, device=dev)
    lib = _build.load("ssd_scan_bwd")
    fn = getattr(lib, f"ssd_scan_bwd_{_ENTRY[xdt.dtype]}")
    with torch.cuda.device(xdt.device):
        err = fn(xdt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), cums.data_ptr(),
                 dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
                 dxdt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                 dcums.data_ptr(), states.data_ptr(), parts.data_ptr(),
                 sdot.data_ptr(), B, H, nc, Q, P, N,
                 _build.stream_handle(xdt.device))
    _build.check(err, f"ssd_scan_bwd (P={P}, N={N}, Q={Q})")
    LAUNCHES["ssd_scan_bwd"] += 1
    return dxdt, dB, dC, dcums


def ssd_scan_bwd_occupancy(P: int, N: int, Q: int) -> dict:
    """The bf16 backward's three tensor-core launches at (P, N, Q) on the
    current device: ``{launch: {"smem_bytes", "blocks_per_sm"}}``, the
    dynamic shared memory a block and the resident blocks an SM."""
    out = (ctypes.c_int * 6)()
    lib = _build.load("ssd_scan_bwd")
    err = lib.ssd_scan_bwd_bf16_occupancy(P, N, Q, ctypes.addressof(out))
    _build.check(err, f"ssd_scan_bwd occupancy (P={P}, N={N}, Q={Q})")
    return {name: {"smem_bytes": out[2 * i], "blocks_per_sm": out[2 * i + 1]}
            for i, name in enumerate(("products", "pass", "tiles"))}
