"""Content-addressed chunk store (CAS): the single substrate for state
movement (§II-D generalized to chunk granularity).

Every serialized payload — an array's raw buffer, a quantized buffer, a
pickle stream — is split into fixed-size chunks, each identified by a 64-bit
content digest of its *raw* bytes.  The digest is the address: migration
ships only chunks the receiver's store does not hold, checkpointing is
migration into an on-disk store, and concurrent sessions share one store per
physical environment so a dataset's chunks cross the wire once.

Array buffers (the bulk of notebook state) are what gets chunked: their
digests come from the ``hash_delta`` per-block digest vector (the CUDA
kernel on a card, its plain PyTorch version on the CPU)
(:func:`array_chunk_digests`) — per 1024-unit block, two uint32 lanes, so
only digests cross from the device, never the tensor.  Pickle streams are
typically small and travel whole alongside the chunk manifest.
:func:`digest_bytes` is the host-side blake2b utility for content-
addressing arbitrary byte blobs in the same 64-bit keyspace.

Stored values are *encoded* chunks: a 1-byte codec tag + the compressed
bytes, so a chunk written under one codec stays readable when a later
serialization uses another.  :class:`DiskChunkStore` adds an 8-byte blake2b
footer per file (atomic tmp->rename writes) so torn or corrupted chunks are
detected on read.
"""
from __future__ import annotations

import hashlib
import os
import threading
import zlib

import numpy as np
import torch

from repro_torch.device import h2d
from repro_torch.kernels.hash_delta.ops import (
    BLOCK, note_host_sync, packed_block_digests, packed_block_digests_compare,
    staging_buffer,
)

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover
    _zstd = None

# zstd contexts are reusable but not safe for simultaneous use; one per
# thread keeps the per-chunk hot loop allocation-free (AsyncCheckpointer
# serializes on a background thread while the engine may be migrating)
_TLS = threading.local()


def _zstd_compressor():
    c = getattr(_TLS, "compressor", None)
    if c is None:
        c = _TLS.compressor = _zstd.ZstdCompressor(level=6)
    return c


def _zstd_decompressor():
    d = getattr(_TLS, "decompressor", None)
    if d is None:
        d = _TLS.decompressor = _zstd.ZstdDecompressor()
    return d

CHUNK_BYTES = 1 << 18      # default chunk size: 256 KiB
_BLOCK_BYTES = BLOCK       # device hash block: 1024 bytes of the byte grid

_CODEC_IDS = {"none": 0, "zlib": 1, "zstd": 2}
_CODEC_NAMES = {v: k for k, v in _CODEC_IDS.items()}


# ----------------------------------------------------------------------
# digests + chunking
# ----------------------------------------------------------------------

def digest_bytes(data: bytes) -> int:
    """64-bit blake2b content digest of a raw byte chunk."""
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "little")


def effective_chunk_bytes(n: int, chunk_bytes: int) -> int:
    """The one chunk-boundary rule, shared by splitting and digesting.

    ``chunk_bytes <= 0`` or a payload that fits in one chunk => whole
    payload; otherwise the size is aligned down to the device hash block so
    chunk boundaries coincide with block-digest boundaries."""
    if chunk_bytes <= 0 or chunk_bytes >= n:
        return max(n, 1)
    return max(_BLOCK_BYTES, chunk_bytes - chunk_bytes % _BLOCK_BYTES)


def split_chunks(data: bytes, chunk_bytes: int = CHUNK_BYTES) -> list[bytes]:
    """Fixed-size split; the final chunk may be short."""
    n = len(data)
    if n == 0:
        return []
    eff = effective_chunk_bytes(n, chunk_bytes)
    return [data[i:i + eff] for i in range(0, n, eff)]


def _fold_chunks(h64: np.ndarray, n: int, chunk_bytes: int,
                 reuse=None, changed=None) -> list[int]:
    """Fold each chunk's span of block digests into one 64-bit digest
    (chunk length mixed in, so zero-padding of the final block cannot
    alias a shorter chunk).  With ``reuse`` (a prior chunk digest list) a
    chunk whose blocks are all unchanged keeps its prior digest."""
    eff = effective_chunk_bytes(n, chunk_bytes)
    digs = []
    for ci, start in enumerate(range(0, n, eff)):
        clen = min(eff, n - start)
        b0 = start // _BLOCK_BYTES
        b1 = (start + clen + _BLOCK_BYTES - 1) // _BLOCK_BYTES
        if reuse is not None and ci < len(reuse) and not changed[b0:b1].any():
            digs.append(reuse[ci])          # exact: lanes matched on device
        else:
            h = hashlib.blake2b(h64[b0:b1].tobytes(), digest_size=8)
            h.update(clen.to_bytes(8, "little"))
            digs.append(int.from_bytes(h.digest(), "little"))
    return digs


def _h64(h2: np.ndarray) -> np.ndarray:
    """(nb, 2) lanes as any 32-bit integer dtype -> (nb,) uint64."""
    h2 = h2.view(np.uint32).astype(np.uint64)
    return (h2[:, 1] << np.uint64(32)) | h2[:, 0]


def array_chunk_digests(raw: bytes, chunk_bytes: int = CHUNK_BYTES, *,
                        device="cuda") -> list[int]:
    """Per-chunk 64-bit digests of an array's raw buffer via the device
    block-digest vector (aligned 1:1 with :func:`split_chunks`).

    The buffer is hashed once on ``device`` (1024-byte blocks, two uint32
    lanes each); only the (nb, 2) digest vector crosses to the host, where
    each chunk's span of block digests is folded into one digest."""
    digs, _ = array_chunk_digests_many([raw], chunk_bytes, device=device)
    return digs[0]


def array_chunk_digests_many(payloads, chunk_bytes: int = CHUNK_BYTES, *,
                             device="cuda", priors=None):
    """Per-chunk digests for *many* raw buffers in one device launch and
    one host sync -- bit-identical to calling :func:`array_chunk_digests`
    on each payload.

    Each payload is zero-padded to the device block boundary in one host
    staging buffer (pinned when ``device`` is a card), which reaches the
    device in one ``non_blocking`` copy; the kernel reads the bytes as they
    are.  ``priors`` (optional, aligned with ``payloads``) carries
    ``(block_h64, chunk_digests, payload_len)`` tuples from a previous
    digesting of the same logical payload: when the length still matches,
    the fused compare kernel flags unchanged blocks **on device** and any
    chunk whose block span is unchanged reuses its prior digest without a
    host blake2b fold.  Lanes and flags come home in one transfer.

    Returns ``(chunk_digest_lists, block_h64_list)``: per payload, its
    chunk digests plus the per-block uint64 digest vector (cacheable as
    the next call's prior)."""
    device = torch.device(device)
    n = len(payloads)
    if n == 0:
        return [], []
    lens = [len(p) for p in payloads]
    nbs = [(ln + _BLOCK_BYTES - 1) // _BLOCK_BYTES for ln in lens]
    total_nb = sum(nbs)
    if total_nb == 0:                       # every payload empty
        return [[] for _ in payloads], [np.zeros(0, np.uint64)] * n
    # single copy pass: payloads land block-padded in one staging buffer
    host = staging_buffer(total_nb * _BLOCK_BYTES, np.uint8,
                          pinned=device.type != "cpu")
    off = 0
    for p, nb in zip(payloads, nbs):
        end = off + len(p)
        host[off:end] = np.frombuffer(p, dtype=np.uint8)
        off += nb * _BLOCK_BYTES
        if off != end:
            host[end:off] = 0
    packed = torch.from_numpy(host)
    if device.type != "cpu":
        packed = torch.empty(host.size, dtype=torch.uint8,
                             device=device).copy_(packed, non_blocking=True)

    usable = [pr is not None and pr[2] == lens[i] and len(pr[0]) == nbs[i]
              for i, pr in enumerate(priors or [None] * n)]
    if any(usable):
        prior_lanes = np.zeros((total_nb, 2), np.uint32)
        has = np.zeros((total_nb, 1), np.uint32)
        off = 0
        for i, nb in enumerate(nbs):
            if usable[i]:
                h64 = np.asarray(priors[i][0], np.uint64)
                prior_lanes[off:off + nb, 0] = h64 & np.uint64(0xFFFFFFFF)
                prior_lanes[off:off + nb, 1] = h64 >> np.uint64(32)
                has[off:off + nb, 0] = 1
            off += nb
        h2, ch = packed_block_digests_compare(
            packed, h2d(prior_lanes.view(np.int32), device),
            h2d(has.view(np.int32), device))
        both = torch.cat([h2, ch], 1).cpu().numpy()   # one transfer home
        h2, changed = both[:, :2], both[:, 2].astype(bool)
    else:
        h2 = packed_block_digests(packed).cpu().numpy()
        changed = None
    note_host_sync()
    h64_all = _h64(np.ascontiguousarray(h2))

    out_chunks, out_h64 = [], []
    off = 0
    for i in range(n):
        nb, nlen = nbs[i], lens[i]
        h64 = h64_all[off:off + nb]
        ch_i = None if changed is None else changed[off:off + nb]
        off += nb
        out_h64.append(h64)
        if nlen == 0:
            out_chunks.append([])
            continue
        reuse = priors[i][1] if usable[i] else None
        out_chunks.append(_fold_chunks(h64, nlen, chunk_bytes, reuse, ch_i))
    return out_chunks, out_h64


# ----------------------------------------------------------------------
# chunk encoding (codec-tagged, self-describing)
# ----------------------------------------------------------------------

def encode_chunk(raw: bytes, codec: str) -> bytes:
    """Raw chunk -> 1-byte codec tag + compressed bytes.  The tag records
    what was *actually* used (zstd falls back to zlib when unavailable), so
    decoding never depends on the requesting serialization's codec."""
    if codec == "none":
        return bytes([_CODEC_IDS["none"]]) + raw
    if codec in ("zstd", "quant8+zstd") and _zstd is not None:
        return bytes([_CODEC_IDS["zstd"]]) + _zstd_compressor().compress(raw)
    return bytes([_CODEC_IDS["zlib"]]) + zlib.compress(raw, level=6)


def decode_chunk(data: bytes) -> bytes:
    codec = _CODEC_NAMES[data[0]]
    body = data[1:]
    if codec == "none":
        return body
    if codec == "zstd":
        if _zstd is None:
            raise IOError("chunk was written with zstd but zstandard "
                          "is not installed")
        return _zstd_decompressor().decompress(body)
    return zlib.decompress(body)


# ----------------------------------------------------------------------
# stores
# ----------------------------------------------------------------------

class MemoryChunkStore:
    """In-memory CAS: digest -> encoded chunk.  Chunks are immutable, so one
    store may safely back any number of sessions/environments.

    Bounded: superseded chunk generations (every version of a mutating
    array ever migrated) would otherwise accumulate for the session's
    lifetime, so the store evicts least-recently-touched chunks past
    ``max_bytes``.  Eviction is always safe — a missing chunk is simply
    re-shipped by the next migration that references it."""

    def __init__(self, max_bytes: int = 1 << 30):
        self._chunks: dict[int, bytes] = {}     # insertion = recency order
        self.max_bytes = int(max_bytes)
        self._nbytes = 0

    def _touch(self, d: int) -> None:
        self._chunks[d] = self._chunks.pop(d)   # move to most-recent end

    def has(self, d: int) -> bool:
        if d in self._chunks:
            self._touch(d)
            return True
        return False

    def get(self, d: int) -> bytes:
        data = self._chunks[d]
        self._touch(d)
        return data

    def put(self, d: int, data: bytes) -> None:
        if d in self._chunks:
            self._touch(d)
            return
        if not isinstance(data, bytes):
            # zero-copy wire payloads arrive as memoryviews into transient
            # recv buffers; the store must own its bytes — this is the one
            # place the copy is required, so it happens here and only here
            data = bytes(data)
        self._chunks[d] = data
        self._nbytes += len(data)
        while self._nbytes > self.max_bytes and len(self._chunks) > 1:
            old = next(iter(self._chunks))
            if old == d:                        # never evict the newcomer
                break
            self._nbytes -= len(self._chunks.pop(old))

    def put_many(self, chunks: dict[int, bytes]) -> None:
        for d, c in chunks.items():
            self.put(d, c)

    # -- wire ingestion --------------------------------------------------
    def ingest_frame(self, frame) -> int:
        """Ingest one CHUNK wire frame incrementally (transport plane):
        the frame's store-encoded body lands under its digest.  A payload
        whose codec tag is unknown is rejected as a WireError before it can
        poison the store."""
        from repro_torch.core.wire import WireError, parse_chunk
        d, encoded = parse_chunk(frame)
        if not encoded or encoded[0] not in _CODEC_NAMES:
            raise WireError(
                f"chunk {d:016x}: unknown codec tag "
                f"{encoded[0] if encoded else None!r}")
        self.put(d, encoded)
        return d

    def ingest_frames(self, frames) -> tuple[int, int]:
        """Ingest a CHUNK-frame iterable; returns (chunks, encoded bytes)."""
        count = nbytes = 0
        for f in frames:
            d = self.ingest_frame(f)
            count += 1
            nbytes += f.payload_len - 8       # minus the digest prefix
        return count, nbytes

    def digests(self) -> set[int]:
        return set(self._chunks)

    def __len__(self) -> int:
        return len(self._chunks)

    @property
    def nbytes(self) -> int:
        return self._nbytes


class DiskChunkStore(MemoryChunkStore):
    """On-disk CAS directory: one ``chunk-<16 hex>.bin`` file per chunk.

    Writes are atomic (tmp -> rename) and append an 8-byte blake2b footer
    over the stored bytes; :meth:`get` verifies it, so torn writes and
    bit-flips surface as ``IOError`` instead of corrupt restores."""

    def __init__(self, directory: str):
        super().__init__()
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, d: int) -> str:
        return os.path.join(self.dir, f"chunk-{d:016x}.bin")

    def has(self, d: int) -> bool:
        return os.path.exists(self._path(d))

    def get(self, d: int) -> bytes:
        with open(self._path(d), "rb") as f:
            data = f.read()
        body, footer = data[:-8], data[-8:]
        if hashlib.blake2b(body, digest_size=8).digest() != footer:
            raise IOError(f"chunk {d:016x} failed its integrity check")
        return body

    def put(self, d: int, data: bytes) -> None:
        path = self._path(d)
        if os.path.exists(path):
            return                       # content-addressed: already correct
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.write(hashlib.blake2b(data, digest_size=8).digest())
        os.replace(tmp, path)

    def remove(self, d: int) -> None:
        try:
            os.remove(self._path(d))
        except FileNotFoundError:
            pass

    def digests(self) -> set[int]:
        out = set()
        for fn in os.listdir(self.dir):
            if fn.startswith("chunk-") and fn.endswith(".bin"):
                out.add(int(fn[len("chunk-"):-len(".bin")], 16))
        return out

    def __len__(self) -> int:
        return len(self.digests())

    @property
    def nbytes(self) -> int:
        return sum(os.path.getsize(self._path(d)) for d in self.digests())
