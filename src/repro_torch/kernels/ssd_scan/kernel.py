"""CUDA SSD chunk scan (``csrc/ssd_scan.cu``): the wrapper that launches it.

It checks device, dtypes, shapes, head dim and contiguity and raises on
anything the kernel does not take (the kernel itself refuses sizes above
its shared-memory limit), allocates the outputs, launches on
PyTorch's current stream and raises if the launch returned an error.
``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = {"ssd_scan": 0}

HEAD_DIMS = (16, 32, 64, 128)
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
