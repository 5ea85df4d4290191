"""Plain PyTorch block hash: the version each CUDA hash kernel is held against.

torch has no shifts, sums or integer matmul for uint32 on the CPU, so the
arithmetic runs in int64 holding values in [0, 2^32), masked after every
step.  A product of two such values would overflow int64, so
:func:`mul32` splits one factor into 16-bit halves.  Rows are processed in
slabs so the (rows, lanes, BLOCK) int64 temporaries stay a few MiB whatever
the grid's size.  uint32 data travels as int32 tensors holding the same bits.
"""
from __future__ import annotations

import torch

PRIME = 2654435761             # Knuth multiplicative
MASK = 0xFFFFFFFF
_SLAB = 256                    # rows per slab


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits (or uint8 values) -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & MASK


def as_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 tensor with the same low 32 bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 operands in [0, 2^32) (``b`` may be an
    int): every partial product stays below 2^48."""
    lo = a * (b & 0xFFFF)
    hi = (a * (b >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK


def block_hash_ref(x2d: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """x2d (nb, blk) int32 bits or uint8; weights (lanes, blk) int32 bits
    -> (nb, lanes) int32 bits.  Elements are premixed (xorshift-multiply)
    before the weighted sum, then each lane is finalized."""
    nb = x2d.shape[0]
    w = u32(weights)[None]                                   # (1, lanes, blk)
    out = torch.empty((nb, weights.shape[0]), dtype=torch.int64,
                      device=x2d.device)
    for s in range(0, nb, _SLAB):
        x = u32(x2d[s:s + _SLAB])
        x = mul32(x ^ (x >> 16), PRIME)
        h = mul32(x[:, None, :], w).sum(-1) & MASK           # (slab, lanes)
        out[s:s + _SLAB] = mul32(h ^ (h >> 15), PRIME)
    return as_i32(out)


def block_hash_compare_ref(x2d, weights, prior, has_prior):
    """The hash plus a per-row compare with ``prior`` (nb, lanes) under
    ``has_prior`` (nb, 1); returns ``(h, changed)`` with ``changed`` an
    (nb, 1) int32 flag (1 = changed or no prior)."""
    h = block_hash_ref(x2d, weights)
    same = (h == prior).all(dim=1) & (has_prior[:, 0] != 0)
    return h, (~same).to(torch.int32)[:, None]


def block_hash_fold_ref(x2d, weights, idx, seg, num_leaves: int):
    """The hash of every row folded per leaf: row ``r`` adds ``h[r] *
    idx[r]`` (mod 2^32) into the lanes of leaf ``seg[r]``.  ``idx`` (nb,)
    int32 bits, ``seg`` (nb,) integer leaf ids -> (num_leaves, lanes) int32
    bits.  ``index_add_`` reorders the additions, but unsigned addition is
    exact mod 2^32 in any order, so this equals the per-leaf fold."""
    prod = mul32(u32(block_hash_ref(x2d, weights)), u32(idx)[:, None])
    lanes = torch.zeros((num_leaves, weights.shape[0]), dtype=torch.int64,
                        device=x2d.device)
    return as_i32(lanes.index_add_(0, seg.to(torch.int64), prod) & MASK)
