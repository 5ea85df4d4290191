"""CUDA block hash (``csrc/hash_delta.cu``): the wrappers that launch it.

Each wrapper checks what the kernel takes (a CUDA tensor, its dtype, shape,
contiguity and 16-byte alignment) and raises on anything else, allocates
the outputs, launches on PyTorch's current stream and raises if the launch
returned an error.  ``LAUNCHES`` counts launches per kernel; it is bumped
only where a kernel is launched.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = {"block_hash": 0, "block_hash_compare": 0}

_ENTRY = {torch.int32: "u32", torch.uint8: "u8"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_rows(x2d: torch.Tensor, weights: torch.Tensor) -> int:
    if x2d.dim() != 2:
        raise ValueError(f"x2d: expected (nb, blk), got {tuple(x2d.shape)}")
    nb, blk = x2d.shape
    if blk != 1024 or tuple(weights.shape) != (2, 1024):
        raise ValueError(f"the kernel hashes (nb, 1024) rows with (2, 1024) "
                         f"weights, got {tuple(x2d.shape)} and "
                         f"{tuple(weights.shape)}")
    _build.check_tensor(x2d, "x2d", tuple(_ENTRY), (nb, blk))
    _build.check_tensor(weights, "weights", (torch.int32,), (2, blk))
    if weights.device != x2d.device:
        raise ValueError("x2d and weights lie on different devices")
    return nb


def block_hash_kernel(x2d: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """x2d (nb, 1024) int32 bits or uint8; weights (2, 1024) int32 bits
    -> (nb, 2) int32 digest lanes."""
    nb = _check_rows(x2d, weights)
    h = torch.empty((nb, 2), dtype=torch.int32, device=x2d.device)
    if nb == 0:
        return h
    lib = _build.load("hash_delta")
    fn = getattr(lib, f"hash_rows_{_ENTRY[x2d.dtype]}")
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), weights.data_ptr(), h.data_ptr(), nb,
                 _build.stream_handle(x2d.device))
    _build.check(err, "block_hash")
    LAUNCHES["block_hash"] += 1
    return h


def block_hash_compare_kernel(x2d: torch.Tensor, weights: torch.Tensor,
                              prior: torch.Tensor, has_prior: torch.Tensor):
    """The hash plus the per-row compare with ``prior`` (nb, 2) int32 under
    ``has_prior`` (nb, 1) int32, in one launch -> ``(h, changed)``."""
    nb = _check_rows(x2d, weights)
    _build.check_tensor(prior, "prior", (torch.int32,), (nb, 2))
    _build.check_tensor(has_prior, "has_prior", (torch.int32,), (nb, 1))
    h = torch.empty((nb, 2), dtype=torch.int32, device=x2d.device)
    changed = torch.empty((nb, 1), dtype=torch.int32, device=x2d.device)
    if nb == 0:
        return h, changed
    lib = _build.load("hash_delta")
    fn = getattr(lib, f"hash_compare_rows_{_ENTRY[x2d.dtype]}")
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), weights.data_ptr(), prior.data_ptr(),
                 has_prior.data_ptr(), h.data_ptr(), changed.data_ptr(), nb,
                 _build.stream_handle(x2d.device))
    _build.check(err, "block_hash_compare")
    LAUNCHES["block_hash_compare"] += 1
    return h, changed
