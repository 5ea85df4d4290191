"""CUDA block hash (``csrc/hash_delta.cu``): the wrappers that launch it.

Each wrapper checks what the kernel takes (a CUDA tensor, its dtype, shape,
contiguity and 16-byte alignment) and raises on anything else, allocates
the outputs, launches on PyTorch's current stream and raises if the launch
returned an error.  ``LAUNCHES`` counts launches per kernel and
``ROUTE_LAUNCHES`` per kernel and element type (``"block_hash/u8"``); both
are bumped only where a kernel is launched.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = {"block_hash": 0, "block_hash_compare": 0, "block_hash_fold": 0}

_ENTRY = {torch.int32: "u32", torch.uint8: "u8"}
ROUTE_LAUNCHES = {f"{k}/{r}": 0 for k in LAUNCHES for r in _ENTRY.values()}
_MODE = {"block_hash": 0, "block_hash_compare": 1, "block_hash_fold": 2}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _count(name: str, x2d: torch.Tensor) -> None:
    LAUNCHES[name] += 1
    ROUTE_LAUNCHES[f"{name}/{_ENTRY[x2d.dtype]}"] += 1


def grid_warps(name: str, dtype: torch.dtype, device) -> int:
    """Warps of the persistent grid that kernel ``name`` launches for rows
    of ``dtype`` on ``device`` (each warp hashes one contiguous range of
    rows; fewer rows than warps leave some warps idle)."""
    lib = _build.load("hash_delta")
    with torch.cuda.device(device):
        n = lib.hash_grid_warps(1 if dtype == torch.uint8 else 4, _MODE[name])
    if n <= 0:
        raise RuntimeError(f"hash_grid_warps: CUDA error {-n}")
    return n


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
    _count("block_hash", x2d)
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
    _count("block_hash_compare", x2d)
    return h, changed


def block_hash_fold_kernel(x2d: torch.Tensor, weights: torch.Tensor,
                           idx: torch.Tensor, seg: torch.Tensor,
                           num_leaves: int) -> torch.Tensor:
    """The hash of every row folded per leaf in the same launch: row ``r``
    adds ``h[r] * idx[r]`` (mod 2^32) into the lanes of leaf ``seg[r]``.
    ``idx`` (nb,) int32 bits, ``seg`` (nb,) int32 in [0, num_leaves)
    -> (num_leaves, 2) int32 lanes (a leaf with no rows keeps 0)."""
    rows = x2d.shape[0] if x2d.dim() else 0
    for t, what in ((idx, "idx"), (seg, "seg")):      # one entry per row
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: dtype {t.dtype}, expected torch.int32")
        if tuple(t.shape) != (rows,):
            raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                             f"({rows},), one entry per row of x2d")
    nb = _check_rows(x2d, weights)
    _build.check_tensor(idx, "idx", (torch.int32,), (nb,))
    _build.check_tensor(seg, "seg", (torch.int32,), (nb,))
    if idx.device != x2d.device or seg.device != x2d.device:
        raise ValueError("x2d, idx and seg lie on different devices")
    if num_leaves < 0:
        raise ValueError(f"num_leaves must be >= 0, got {num_leaves}")
    lanes = torch.zeros((num_leaves, 2), dtype=torch.int32, device=x2d.device)
    if nb == 0 or num_leaves == 0:
        return lanes
    lib = _build.load("hash_delta")
    fn = getattr(lib, f"hash_fold_rows_{_ENTRY[x2d.dtype]}")
    with torch.cuda.device(x2d.device):
        err = fn(x2d.data_ptr(), weights.data_ptr(), idx.data_ptr(),
                 seg.data_ptr(), lanes.data_ptr(), nb, num_leaves,
                 _build.stream_handle(x2d.device))
    _build.check(err, "block_hash_fold")
    _count("block_hash_fold", x2d)
    return lanes
