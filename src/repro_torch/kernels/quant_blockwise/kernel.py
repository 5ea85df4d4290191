"""CUDA block-wise int8 quantize/dequantize (``csrc/quant_blockwise.cu``):
the wrappers that launch them.

Each wrapper checks device, dtype, shape, contiguity and alignment and
raises on anything the kernel does not take, allocates the outputs,
launches on PyTorch's current stream and raises if the launch returned an
error.  ``LAUNCHES`` counts launches per kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = {"quantize": 0, "dequantize": 0}

BLOCK = 1024
_ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def quantize_kernel(x2d: torch.Tensor):
    """x2d (nb, 1024) f32 or bf16 -> (q int8 (nb, 1024), scale f32 (nb,))."""
    if x2d.dim() != 2 or x2d.shape[1] != BLOCK:
        raise ValueError(f"x2d: expected (nb, {BLOCK}), got {tuple(x2d.shape)}")
    nb = x2d.shape[0]
    _build.check_tensor(x2d, "x2d", tuple(_ENTRY), (nb, BLOCK))
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=x2d.device)
    scale = torch.empty((nb,), dtype=torch.float32, device=x2d.device)
    if nb == 0:
        return q, scale
    lib = _build.load("quant_blockwise")
    fn = getattr(lib, f"quantize_rows_{_ENTRY[x2d.dtype]}")
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), q.data_ptr(), scale.data_ptr(), nb,
                 _build.stream_handle(x2d.device))
    _build.check(err, "quantize")
    LAUNCHES["quantize"] += 1
    return q, scale


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """q (nb, 1024) int8, scale (nb,) f32 -> (nb, 1024) ``dtype`` (f32 or
    bf16)."""
    if q.dim() != 2 or q.shape[1] != BLOCK:
        raise ValueError(f"q: expected (nb, {BLOCK}), got {tuple(q.shape)}")
    if dtype not in _ENTRY:
        raise TypeError(f"dequantize writes {tuple(_ENTRY)}, not {dtype}")
    nb = q.shape[0]
    _build.check_tensor(q, "q", (torch.int8,), (nb, BLOCK))
    _build.check_tensor(scale, "scale", (torch.float32,), (nb,))
    if scale.device != q.device:
        raise ValueError("q and scale lie on different devices")
    x = torch.empty((nb, BLOCK), dtype=dtype, device=q.device)
    if nb == 0:
        return x
    lib = _build.load("quant_blockwise")
    fn = getattr(lib, f"dequantize_rows_{_ENTRY[dtype]}")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), scale.data_ptr(), x.data_ptr(), nb,
                 _build.stream_handle(q.device))
    _build.check(err, "dequantize")
    LAUNCHES["dequantize"] += 1
    return x
