"""Content digests for the state plane, on the tensors' device.

``block_digests`` gives the per-1024-element block digest vector that the
content-addressed chunk store consumes (two uint32 lanes per block = one
64-bit identity).  ``tensor_digest`` folds it into one 64-bit leaf digest:
each lane is a weighted sum mod 2^32 over the blocks, combined on the host
as ``(hi << 32) | lo``.

**Batched manifest digesting.**  ``digest_leaves`` packs every leaf of a
manifest -- ragged sizes, numpy arrays and tensors -- into one block grid on
the device and digests the whole namespace in one kernel launch with one
device->host transfer.  ``digest_leaves_delta`` compares against the prior
digests on the device and brings lanes and changed flags home in that same
single transfer.  Both are bit-identical to the per-leaf path: each leaf is
padded to its own block boundary, and the per-leaf fold is an unsigned
32-bit weighted sum, exact in any order mod 2^32.

Dispatch: a grid on the CPU goes to the plain PyTorch version
(:mod:`.ref`); a grid on a CUDA device goes to the CUDA kernel
(:mod:`.kernel`), which launches or raises.

``HOST_SYNCS`` counts device->host transfers issued by this module (one per
``tensor_digest``, one per batched call), so tests and the chip smoke run
can hold the batched calls to one each.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.device import h2d
from repro_torch.kernels.hash_delta.kernel import (
    block_hash_compare_kernel, block_hash_kernel,
)
from repro_torch.kernels.hash_delta.ref import (
    MASK, block_hash_compare_ref, block_hash_ref, mul32, u32,
)

BLOCK = 1024
LANES = 2
_FOLD = 2246822519              # per-block position weight (golden-prime)

HOST_SYNCS = 0                  # device->host syncs since reset_host_syncs()


def _note_sync(n: int = 1) -> None:
    global HOST_SYNCS
    HOST_SYNCS += n


def reset_host_syncs() -> None:
    global HOST_SYNCS
    HOST_SYNCS = 0


def note_host_sync(n: int = 1) -> None:
    """Record a device->host sync issued by a caller (e.g. the chunk
    store's batched fold pulling the packed digest vector)."""
    _note_sync(n)


# one odd weight vector per lane; the same streams as the reference package
_W = np.stack([
    np.random.default_rng(0xD1657).integers(1, 2**32, size=BLOCK,
                                            dtype=np.uint32) | 1,
    np.random.default_rng(0xD1658).integers(1, 2**32, size=BLOCK,
                                            dtype=np.uint32) | 1,
])
_W_ON: dict[torch.device, torch.Tensor] = {}


def weights(device: torch.device) -> torch.Tensor:
    """The (LANES, BLOCK) weights as int32 bits on ``device`` (cached)."""
    w = _W_ON.get(device)
    if w is None:
        w = _W_ON[device] = h2d(_W.view(np.int32), device)
    return w


def _lanes(x2d: torch.Tensor) -> torch.Tensor:
    if x2d.device.type == "cpu":
        return block_hash_ref(x2d, weights(x2d.device))
    return block_hash_kernel(x2d, weights(x2d.device))


def _lanes_compare(x2d, prior, has_prior):
    if x2d.device.type == "cpu":
        return block_hash_compare_ref(x2d, weights(x2d.device), prior,
                                      has_prior)
    return block_hash_compare_kernel(x2d, weights(x2d.device), prior,
                                     has_prior)


# ----------------------------------------------------------------------
# widening: how the reference turns each dtype into uint32 words
# ----------------------------------------------------------------------

def _widen(x: torch.Tensor) -> torch.Tensor:
    """Any tensor -> flat int32 tensor of its uint32 words, on its device.

    Floats are cast to f32 and bitcast (f16/bf16 exactly, f64 with
    round-to-nearest); 4-byte ints are reinterpreted; narrow ints and bool
    are value-cast with wraparound (int8 -1 -> 0xFFFFFFFF, uint8
    zero-extended), as the reference's ``astype(uint32)`` does."""
    if x.is_complex():
        raise TypeError("complex tensors are re-laned by the reducer before "
                        "hashing")
    flat = x.detach().reshape(-1)
    if flat.is_floating_point():
        return flat.to(torch.float32).view(torch.int32)
    if flat.element_size() == 4:
        return flat.view(torch.int32)
    return flat.to(torch.int32)


def _as_u32_blocks(x: torch.Tensor) -> torch.Tensor:
    flat = _widen(x)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK)


def _fold_one(h: torch.Tensor) -> torch.Tensor:
    """(nb, LANES) int32 lanes -> (LANES,) int64 weighted fold mod 2^32."""
    nb = h.shape[0]
    idx = mul32(torch.arange(nb, dtype=torch.int64, device=h.device),
                _FOLD) + 1
    return mul32(u32(h), (idx & MASK)[:, None]).sum(0) & MASK


def block_digests(x: torch.Tensor) -> torch.Tensor:
    """Any tensor -> (nb, 2) int32 per-block digest lanes, on its device."""
    return _lanes(_as_u32_blocks(x))


def tensor_digest(x: torch.Tensor) -> int:
    """Any tensor -> one 64-bit int digest (content hash for delta migration)."""
    lo, hi = _fold_one(block_digests(x)).cpu().tolist()
    _note_sync()
    return (int(hi) << 32) | int(lo)


def block_digests_compare(x: torch.Tensor, prior: torch.Tensor,
                          has_prior: torch.Tensor):
    """Per-block digest + compare against a prior (nb, 2) int32 lane vector
    under (nb, 1) int32 validity flags, in one launch -> ``(h, changed)``."""
    return _lanes_compare(_as_u32_blocks(x), prior, has_prior)


def packed_block_digests(u8: torch.Tensor) -> torch.Tensor:
    """Pre-packed byte buffer (size % BLOCK == 0) -> (nb, 2) lanes.  The
    kernel reads the bytes as they are (each one zero-extended), so no
    widened copy of the payload is made."""
    return _lanes(u8.reshape(-1, BLOCK))


def packed_block_digests_compare(u8: torch.Tensor, prior: torch.Tensor,
                                 has_prior: torch.Tensor):
    """Fused variant of :func:`packed_block_digests`: digest + compare
    against a prior (nb, 2) lane vector in one launch."""
    return _lanes_compare(u8.reshape(-1, BLOCK), prior, has_prior)


# ----------------------------------------------------------------------
# staging: host bytes on their way to the device
# ----------------------------------------------------------------------

_STAGING_CAP = 3 << 29          # max bytes kept alive per dtype: covers a
                                # GiB-scale manifest plus block padding
_STAGING = threading.local()


def staging_buffer(n: int, dtype=np.uint32, *, pinned: bool = False
                   ) -> np.ndarray:
    """Host staging buffer, reused across calls (per thread, per dtype and
    kind, capped).

    ``pinned=True`` gives page-locked memory, so the copy to the card can
    be ``non_blocking``.  Reuse is safe only because every batched entry
    point ends in a device->host transfer on the same stream: once a call
    is over, its copies out of the buffer have completed.  Requests beyond
    the cap get a fresh buffer rather than holding manifest-sized memory
    forever."""
    dtype = np.dtype(dtype)
    nbytes = n * dtype.itemsize

    def fresh(count: int) -> np.ndarray:
        if not pinned:
            return np.empty(count, dtype)
        t = torch.empty(count * dtype.itemsize, dtype=torch.uint8,
                        pin_memory=True)
        return t.numpy().view(dtype)

    if nbytes > _STAGING_CAP:
        return fresh(n)
    pool = getattr(_STAGING, "pool", None)
    if pool is None:
        pool = _STAGING.pool = {}
    key = (dtype.str, pinned)
    buf = pool.get(key)
    if buf is None or buf.size < n:
        grown = 0 if buf is None else 2 * buf.size
        cap = _STAGING_CAP // dtype.itemsize
        buf = pool[key] = fresh(min(cap, max(n, grown)))
    return buf[:n]


def _np_u32_flat(a: np.ndarray) -> np.ndarray:
    """Host mirror of :func:`_widen` for numpy arrays, flat, as uint32."""
    if a.dtype.kind == "f":
        raw = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    elif a.dtype.itemsize == 4 and a.dtype.kind in "iu":
        raw = np.ascontiguousarray(a).view(np.uint32)
    else:
        raw = a.astype(np.uint32)
    return raw.reshape(-1)


def _host_words(a) -> np.ndarray:
    """A leaf packed through the host -> flat uint32 words."""
    if isinstance(a, torch.Tensor):
        return _widen(a).cpu().numpy().view(np.uint32)
    return _np_u32_flat(np.asarray(a))


# ----------------------------------------------------------------------
# batched manifest digesting: many ragged leaves, one launch, one sync
# ----------------------------------------------------------------------

def _on_device(a, device: torch.device) -> bool:
    return isinstance(a, torch.Tensor) and a.device.type == device.type \
        and device.type != "cpu"


def _pack_leaves(leaves, device: torch.device):
    """Ragged leaves -> one (NB, BLOCK) int32 grid on ``device`` + blocks
    per leaf.

    Each leaf is padded to its own block boundary, so every row of the grid
    equals the row the per-leaf path would have hashed.  Host leaves (numpy
    arrays, CPU tensors) are written into a staging buffer -- pinned when
    the grid lies on a card -- and copied over in one ``non_blocking``
    transfer; leaves already on the card are widened there and never visit
    the host."""
    nbs = [-(-_numel(a) // BLOCK) for a in leaves]
    total = sum(nbs)
    grid = torch.empty((total, BLOCK), dtype=torch.int32, device=device)
    if total == 0:
        return grid, nbs
    flat = grid.view(-1)
    starts = (np.concatenate([[0], np.cumsum(nbs)]) * BLOCK).tolist()
    on_card = [_on_device(a, device) for a in leaves]
    if device.type == "cpu":        # host words land in the grid itself
        dst = flat.numpy().view(np.uint32)
    else:
        dst = staging_buffer(sum(n for n, c in zip(nbs, on_card) if not c)
                             * BLOCK, pinned=True)
    runs: list[list[int]] = []      # [grid offset, staging offset, length]
    off = 0
    for i, a in enumerate(leaves):
        if on_card[i] or not nbs[i]:
            continue
        words = _host_words(a)
        at = starts[i] if device.type == "cpu" else off
        dst[at:at + words.size] = words
        dst[at + words.size:at + nbs[i] * BLOCK] = 0
        if runs and runs[-1][0] + runs[-1][2] == starts[i]:
            runs[-1][2] += nbs[i] * BLOCK
        else:
            runs.append([starts[i], off, nbs[i] * BLOCK])
        off += nbs[i] * BLOCK
    if device.type != "cpu":        # one non_blocking copy per run of rows
        stage = torch.from_numpy(dst.view(np.int32))
        for g, s, n in runs:
            flat[g:g + n].copy_(stage[s:s + n], non_blocking=True)
    for i, a in enumerate(leaves):
        if on_card[i] and nbs[i]:
            words = _widen(a)
            flat[starts[i]:starts[i] + words.numel()].copy_(words)
            flat[starts[i] + words.numel():starts[i + 1]] = 0
    return grid, nbs


def _numel(a) -> int:
    return a.numel() if isinstance(a, torch.Tensor) else int(np.asarray(a).size)


def _fold_weights(nbs) -> tuple[np.ndarray, np.ndarray]:
    """Per-block fold weight (as int32 bits) + leaf segment id, host-side."""
    nbs_a = np.asarray(nbs, np.int64)
    total = int(nbs_a.sum())
    seg = np.repeat(np.arange(len(nbs_a), dtype=np.int64), nbs_a)
    starts = np.repeat(np.cumsum(nbs_a) - nbs_a, nbs_a)
    local = (np.arange(total, dtype=np.int64) - starts).astype(np.uint32)
    idx = local * np.uint32(_FOLD) + np.uint32(1)
    return idx.view(np.int32), seg


def _batched_lanes(x2d: torch.Tensor, nbs) -> torch.Tensor:
    """One launch over the packed grid -> (num_leaves, 2) int64 lanes.

    The per-leaf fold is a weighted uint32 sum; ``index_add_`` reorders the
    additions, but unsigned addition is exact mod 2^32 in any order, so the
    result is bit-identical to the per-leaf fold."""
    idx, seg = _fold_weights(nbs)
    idx_t, seg_t = h2d(idx, x2d.device), h2d(seg, x2d.device)
    prod = mul32(u32(_lanes(x2d)), u32(idx_t)[:, None])
    lanes = torch.zeros((len(nbs), LANES), dtype=torch.int64,
                        device=x2d.device)
    return lanes.index_add_(0, seg_t, prod) & MASK


def _fold_digests(lanes: np.ndarray) -> list[int]:
    lanes = np.asarray(lanes).astype(np.uint64)
    return ((lanes[:, 1] << np.uint64(32)) | lanes[:, 0]).tolist()


def digest_leaves(leaves, *, device="cuda") -> list[int]:
    """Digest a whole manifest of leaves in one launch + one host sync.

    Returns one 64-bit digest per leaf, in order, bit-identical to calling
    :func:`tensor_digest` on each leaf individually."""
    device = torch.device(device)
    leaves = list(leaves)
    n = len(leaves)
    if n == 0:
        return []
    x2d, nbs = _pack_leaves(leaves, device)
    if x2d.shape[0] == 0:       # all leaves empty: digest of no blocks is 0
        return [0] * n
    lanes = _batched_lanes(x2d, nbs).cpu().numpy()
    _note_sync()
    return _fold_digests(lanes)


def digest_leaves_delta(leaves, prior_digests, *, device="cuda"):
    """Digest + delta for a whole manifest: one launch, one host sync.

    ``prior_digests`` aligns with ``leaves``: the prior 64-bit digest of
    each leaf, or ``None`` when there is no prior (leaf counts as changed).
    Returns ``(digests, changed)`` -- per-leaf 64-bit digests (bit-identical
    to :func:`tensor_digest`) and the sorted index list of leaves whose
    digest differs from its prior.  The compare runs on the device; the
    lanes and the changed flags come home in one transfer, and the indices
    are taken on the host (``torch.nonzero`` on a card would sync again)."""
    device = torch.device(device)
    leaves = list(leaves)
    n = len(leaves)
    if n == 0:
        return [], []
    prior = np.zeros((n, LANES), np.int64)
    has_prior = np.zeros(n, bool)
    for j, d in enumerate(prior_digests):
        if d is not None:
            prior[j, 0] = d & 0xFFFFFFFF
            prior[j, 1] = (d >> 32) & 0xFFFFFFFF
            has_prior[j] = True
    x2d, nbs = _pack_leaves(leaves, device)
    if x2d.shape[0] == 0:
        changed = [j for j in range(n)
                   if not has_prior[j] or prior_digests[j] != 0]
        return [0] * n, changed
    lanes = _batched_lanes(x2d, nbs)
    prior_t, has_t = h2d(prior, device), h2d(has_prior, device)
    changed = ~has_t | (lanes != prior_t).any(dim=1)
    both = torch.cat([lanes, changed[:, None].to(torch.int64)], 1)
    both = both.cpu().numpy()
    _note_sync()
    return _fold_digests(both[:, :LANES]), np.flatnonzero(both[:, LANES]).tolist()
