"""Notebook state reducer (paper §II-D): reduced capture, chunked
serialization onto a content-addressed store, content hashing, delta
migration, compression codecs.

Pipeline (faithful to the paper, then generalized from name to chunk
granularity).  This is the PyTorch counterpart of ``repro.core.reducer``:
it produces the same digests, chunk keys, payloads and pickle streams, and
reads what the reference writes.  On a CUDA device every digest, chunk key,
quantize and dequantize goes through the hand-written kernels.

1. ``reduce``: AST Load-closure over the live namespace -> needed names only.
2. ``serialize``: arrays leave the pickle stream and their raw buffers are
   split into fixed-size chunks, each compressed and content-addressed by a
   64-bit digest (optionally block-quantized to int8 on device first);
   everything else pickles.  Identical chunks dedup within one capture.
   Serialization failure => the caller executes locally (§II-D).
3. ``digests``: content hash per name -- array leaves (numpy arrays and
   torch tensors, CPU or CUDA) hash on the reducer's device with the
   ``hash_delta`` kernel (per-block digest lanes, not tensors, cross to
   host; folded to one 64-bit digest per leaf); host objects hash with
   blake2b over their serialized bytes.  Array chunk digests reuse the same
   per-block vector.
4. ``delta``: per-name digests pick which names move; per-chunk manifests
   then ship only the chunks the receiver's store does not already hold, so
   a 1-element update to a 1 GB array moves one chunk, not the array.
   Deletions are propagated as tombstones.
5. codecs: none | zlib (paper's choice) | zstd | quant8+zstd (lossy,
   opt-in), applied chunk-by-chunk and recorded per chunk.
"""
from __future__ import annotations

import contextvars
import hashlib
import io
import marshal
import pickle
import types
import zlib
from collections import OrderedDict, defaultdict
from dataclasses import dataclass, field
from typing import Any

import numpy as np

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover
    _zstd = None

import torch

from repro_torch.core.astdeps import cell_dependencies
from repro_torch.core.chunkstore import (
    CHUNK_BYTES, array_chunk_digests_many, decode_chunk, encode_chunk,
    split_chunks,
)
from repro_torch.core.state import ExecutionState
from repro_torch.device import h2d, resolve_device
from repro_torch.kernels.hash_delta.ops import (
    digest_leaves, digest_leaves_delta,
)
from repro_torch.kernels.quant_blockwise.ops import dequantize, quantize

CODECS = ("none", "zlib", "zstd", "quant8+zstd")

DIGEST_BYTES = 8     # manifest cost of advertising one chunk digest


class SerializationFailure(Exception):
    """Paper §II-D: on serialization failure the cell executes locally."""


# ----------------------------------------------------------------------
# codec helpers (scales + pickle streams; chunks carry their own codec tag)
# ----------------------------------------------------------------------

def _compress(data: bytes, codec: str) -> bytes:
    if codec == "none":
        return data
    if codec == "zlib":
        return zlib.compress(data, level=6)
    if codec in ("zstd", "quant8+zstd"):
        if _zstd is None:
            return zlib.compress(data, level=6)
        return _zstd.ZstdCompressor(level=6).compress(data)
    raise ValueError(codec)


def _decompress(data: bytes, codec: str) -> bytes:
    if codec == "none":
        return data
    if codec == "zlib":
        return zlib.decompress(data)
    if codec in ("zstd", "quant8+zstd"):
        if _zstd is None:
            return zlib.decompress(data)
        return _zstd.ZstdDecompressor().decompress(data)
    raise ValueError(codec)


# ----------------------------------------------------------------------
# array-aware pickling
# ----------------------------------------------------------------------

def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor)) and not np.isscalar(x)


def _dtype_name(a) -> str:
    """The reference's dtype string: numpy's name, ``"bfloat16"`` for bf16."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return str(a.dtype)


def _host_numpy(a) -> np.ndarray:
    """An array leaf as a host numpy array with the same bytes.  numpy has
    no bf16, so a bf16 tensor comes out as its uint16 bits."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    t = a.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _tree_flatten(obj) -> tuple[list, str]:
    """jax-compatible flatten: ``(leaves, str(treedef))`` as
    ``jax.tree_util.tree_flatten`` gives them for dicts (keys sorted),
    lists, tuples, None (an empty node, not a leaf), ``OrderedDict`` (keys
    in insertion order), ``defaultdict`` (keys sorted) and namedtuples (any
    tuple subclass with ``_fields``).  Anything else, subclasses of dict,
    list, ``OrderedDict`` and ``defaultdict`` included, is a leaf."""
    leaves: list = []

    def children(values) -> str:
        return ", ".join(walk(v) for v in values)

    def walk(x) -> str:
        t = type(x)
        if x is None:
            return "None"
        if t is dict:
            try:
                keys = sorted(x)
            except TypeError as e:
                raise ValueError("Comparator raised exception while sorting "
                                 "pytree dictionary keys.") from e
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}" for k in keys) + "}"
        if t is list:
            return "[" + children(x) + "]"
        if t is tuple:
            return "(" + children(x) + ("," if len(x) == 1 else "") + ")"
        if t is OrderedDict:
            keys = tuple(x)
            return (f"CustomNode(OrderedDict[{keys!r}], "
                    f"[{children(x[k] for k in keys)}])")
        if t is defaultdict:
            keys = tuple(sorted(x))
            return (f"CustomNode(defaultdict[{(x.default_factory, keys)!r}], "
                    f"[{children(x[k] for k in keys)}])")
        if isinstance(x, tuple) and hasattr(t, "_fields"):
            return f"CustomNode(namedtuple[{t.__name__}], [{children(x)}])"
        leaves.append(x)
        return "*"

    return leaves, f"PyTreeDef({walk(obj)})"


def tree_map_with_path(fn, obj):
    """The path-carrying twin of :func:`_tree_flatten`: rebuild ``obj``
    with every leaf ``x`` replaced by ``fn(path, x)``, called in jax's
    flatten order, where ``path`` is the leaf's
    ``jax.tree_util.keystr``: ``['a']`` for a dict, ``OrderedDict`` or
    ``defaultdict`` key (``[1]`` for an int key), ``[0]`` for a list or
    tuple item, ``.step`` for a namedtuple field, ``''`` for a leaf at
    the root.  ``None`` is an empty node and stays ``None``; the node
    types are those of :func:`_tree_flatten`, dicts rebuilt with their
    keys sorted as jax's ``tree_unflatten`` gives them."""
    def walk(x, path: str):
        t = type(x)
        if x is None:
            return None
        if t is dict or t is defaultdict:
            try:
                keys = sorted(x)
            except TypeError as e:
                raise ValueError("Comparator raised exception while sorting "
                                 "pytree dictionary keys.") from e
            items = [(k, walk(x[k], f"{path}[{k!r}]")) for k in keys]
            return (dict(items) if t is dict
                    else defaultdict(x.default_factory, items))
        if t is OrderedDict:
            return OrderedDict((k, walk(v, f"{path}[{k!r}]"))
                               for k, v in x.items())
        if t is list or t is tuple:
            return t(walk(v, f"{path}[{i}]") for i, v in enumerate(x))
        if isinstance(x, tuple) and hasattr(t, "_fields"):
            return t(*(walk(getattr(x, f), f"{path}.{f}") for f in t._fields))
        return fn(path, x)

    return walk(obj, "")


def tree_flatten_with_path(obj) -> list[tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs in jax's flatten order, as
    ``jax.tree_util.tree_flatten_with_path`` with ``keystr`` gives them."""
    out: list = []
    tree_map_with_path(lambda p, x: out.append((p, x)), obj)
    return out


# Target namespace for function-globals rebinding during deserialization:
# a migrated cell-defined function must resolve its globals in the
# *destination* environment's namespace (paper: the remote kernel).
_TARGET_NS: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "repro_target_ns", default=None)


def _make_function(code_bytes: bytes, name: str, defaults, closure_vals):
    code = marshal.loads(code_bytes)  # noqa: S302 — our own serialized stream
    g = _TARGET_NS.get()
    if g is None:
        g = {"__builtins__": __builtins__}
    closure = tuple(types.CellType(v) for v in closure_vals) or None
    fn = types.FunctionType(code, g, name, defaults, closure)
    return fn


def _by_value(fn: types.FunctionType) -> bool:
    """Cell/exec-defined functions can't be pickled by reference."""
    import sys
    mod = getattr(fn, "__module__", None)
    if mod in (None, "__main__"):
        return True
    m = sys.modules.get(mod)
    return m is None or getattr(m, fn.__qualname__.split(".")[0], None) is not fn


class _Pickler(pickle.Pickler):
    def __init__(self, f, store: list):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self._store = store

    def persistent_id(self, obj):
        if _is_array(obj):
            self._store.append(obj.detach() if isinstance(obj, torch.Tensor)
                               else np.asarray(obj))
            return ("arr", len(self._store) - 1)
        return None

    def reducer_override(self, obj):
        if isinstance(obj, types.FunctionType) and _by_value(obj):
            closure_vals = tuple(c.cell_contents for c in (obj.__closure__ or ()))
            return (_make_function, (marshal.dumps(obj.__code__), obj.__name__,
                                     obj.__defaults__, closure_vals))
        return NotImplemented


class _Unpickler(pickle.Unpickler):
    def __init__(self, f, store: list):
        super().__init__(f)
        self._store = store

    def persistent_load(self, pid):
        kind, idx = pid
        assert kind == "arr"
        return self._store[idx]

    def find_class(self, module, name):
        # a cell-defined function captured by the reference package names
        # the reference's rebuild helper; rebuild it with this one
        if (module, name) == ("repro.core.reducer", "_make_function"):
            return _make_function
        return super().find_class(module, name)


_QUANT_DTYPES = ("float32", "float64", "bfloat16")


def _prepare_array(a, codec: str,
                   device: torch.device) -> tuple[dict, bytes]:
    """Array (numpy or tensor) -> (chunk-manifest meta sans digests, raw
    payload bytes).

    Digesting is deferred so the caller can batch every payload of a
    capture into one device launch (:func:`array_chunk_digests_many`)."""
    dtype = _dtype_name(a)
    meta = {"shape": tuple(int(d) for d in a.shape), "dtype": dtype}
    if codec == "quant8+zstd" and dtype in _QUANT_DTYPES:
        x = a if isinstance(a, torch.Tensor) else h2d(a, device)
        # the reference quantizes jnp.asarray(a), which narrows float64 to
        # float32 (x64 is off there)
        if x.dtype == torch.float64:
            x = x.to(torch.float32)
        q, s = quantize(x.to(device))
        q = q.cpu().numpy()
        payload = q.tobytes()
        meta.update(quant=True, block=int(q.shape[1]),
                    scales=_compress(s.cpu().numpy().tobytes(), codec))
    else:
        payload = np.ascontiguousarray(_host_numpy(a)).tobytes()
        meta.update(quant=False)
    return meta, payload


def _bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """uint16 bits -> CPU bf16 tensor of the same bits and shape."""
    return torch.from_numpy(np.array(bits).view(np.int16)).view(torch.bfloat16)


def _decode_array(meta: dict, codec: str, chunks: dict[int, bytes],
                  store, device: torch.device):
    """Rebuild a host array as the reference does: a numpy array, or a CPU
    bf16 tensor with the reference's bits where the meta says bfloat16.
    A quantized array is dequantized on ``device``."""
    shape = tuple(meta["shape"])
    bf16 = meta["dtype"] == "bfloat16"

    def fetch(d: int) -> bytes:
        if d in chunks:
            return decode_chunk(chunks[d])
        if store is not None and store.has(d):
            return decode_chunk(store.get(d))
        raise KeyError(f"missing chunk {d:016x}")

    raw = b"".join(fetch(d) for d in meta["chunks"])
    if meta["quant"]:
        block = int(meta["block"])   # quant block size travels in the meta
        q = np.frombuffer(raw, np.int8).reshape(-1, block)
        s = np.frombuffer(_decompress(meta["scales"], codec), np.float32)
        # the reference decodes float64 through a float32 dequantize (x64
        # is off there), so the array comes back float32 under a float64
        # meta; the port gives the same array
        x = dequantize(h2d(q, device), h2d(s, device), shape,
                       torch.bfloat16 if bf16 else torch.float32).cpu()
        return x if bf16 else x.numpy()
    if bf16:
        return _bf16_tensor(np.frombuffer(raw, np.uint16).reshape(shape))
    return np.frombuffer(raw, np.dtype(meta["dtype"])).reshape(shape).copy()


# ----------------------------------------------------------------------
# public containers
# ----------------------------------------------------------------------

@dataclass
class SerializedName:
    pickle_bytes: bytes
    arrays: list[dict]

    @property
    def nbytes(self) -> int:
        """Standalone transfer cost of this name (chunks shared with other
        names in the same capture are counted here per reference)."""
        n = len(self.pickle_bytes)
        for a in self.arrays:
            n += sum(a["clens"]) + len(a.get("scales", b""))
        return n

    def chunk_digests(self) -> list[int]:
        return [d for a in self.arrays for d in a["chunks"]]


@dataclass
class SerializedState:
    codec: str
    blobs: dict[str, SerializedName]
    chunks: dict[int, bytes] = field(default_factory=dict)  # digest -> encoded
    deleted: tuple[str, ...] = ()
    modules: tuple[str, ...] = ()
    digests: dict[str, int] = field(default_factory=dict)
    skipped: tuple[str, ...] = ()

    @property
    def nbytes(self) -> int:
        """Full transfer cost: pickle streams + scales + every unique chunk
        (what crosses the wire to a receiver holding nothing)."""
        n = sum(len(b.pickle_bytes)
                + sum(len(a.get("scales", b"")) for a in b.arrays)
                for b in self.blobs.values())
        return n + sum(len(c) - 1 for c in self.chunks.values())

    @property
    def ref_nbytes(self) -> int:
        """Whole-name accounting (the pre-CAS protocol): every chunk counted
        once per reference, no cross-name dedup — the paper's Table-II
        measurement of a plain serialized transfer."""
        return sum(b.nbytes for b in self.blobs.values())

    def wire_nbytes(self, held: set[int]) -> int:
        """Transfer cost against a receiver advertising ``held`` chunk
        digests: full streams for pickles/scales, encoded bytes for missing
        chunks, and DIGEST_BYTES per referenced chunk (the manifest)."""
        n = sum(len(b.pickle_bytes)
                + sum(len(a.get("scales", b"")) for a in b.arrays)
                for b in self.blobs.values())
        refs = 0
        counted: set[int] = set()
        for b in self.blobs.values():
            for d in b.chunk_digests():
                refs += 1
                if d in held or d in counted or d not in self.chunks:
                    continue
                counted.add(d)
                n += len(self.chunks[d]) - 1
        return n + refs * DIGEST_BYTES

    def missing_chunks(self, held: set[int]) -> dict[int, bytes]:
        return {d: c for d, c in self.chunks.items() if d not in held}


# ----------------------------------------------------------------------
# the reducer
# ----------------------------------------------------------------------

class StateReducer:
    def __init__(self, codec: str = "zlib", reduce_state: bool = True,
                 device="cuda",
                 chunk_bytes: int = CHUNK_BYTES):
        assert codec in CODECS, codec
        self.codec = codec
        self.reduce_state = reduce_state
        # where digests, chunk keys and quantization run: "cuda" (the
        # hand-written kernels; raises without a card) or "cpu" (their plain
        # PyTorch versions)
        self.device = resolve_device(device)
        # chunk_bytes <= 0 => one chunk per payload (whole-name granularity,
        # the pre-CAS baseline; benchmarks compare against it)
        self.chunk_bytes = int(chunk_bytes)
        # (name, array-slot) -> (block_h64, chunk_digests, payload_len):
        # priors for the fused digest+compare launch, so re-serializing a
        # partially-changed array folds only its changed chunks on host.
        # Reuse is content-verified on device, so a stale entry can only
        # cost a recompute, never a wrong digest.
        self._chunk_cache: dict[tuple[str, int], tuple] = {}

    # -- step 1: which names does this cell need? ----------------------
    def reduce(self, state: ExecutionState, cell_source: str):
        if not self.reduce_state:
            names = set(state.names())
            return names, set(), None
        needed, modules, info = cell_dependencies(cell_source, state.ns)
        return needed, modules, info

    # -- step 2/3: serialize + digest -----------------------------------
    def serialize_names(self, state: ExecutionState, names,
                        codec: str | None = None,
                        on_error: str = "raise",
                        digests: dict[str, int] | None = None
                        ) -> SerializedState:
        """on_error="raise": SerializationFailure aborts (caller runs the cell
        locally, §II-D).  on_error="skip": unserializable names simply don't
        travel (used on return migrations — the object stays remote).

        ``digests`` lets a caller that already holds this capture's content
        digests (``delta_names`` returns them) pass them through instead of
        re-digesting.

        Chunk digesting is two-pass: pass 1 pickles every name and collects
        raw array payloads; pass 2 digests *all* payloads in one device
        launch + one host sync (with on-device compare against the previous
        capture's block lanes, so unchanged chunks skip their host fold);
        pass 3 encodes chunks with the original per-name rollback."""
        codec = codec or self.codec
        blobs: dict[str, SerializedName] = {}
        chunks: dict[int, bytes] = {}
        skipped: list[str] = []
        prepared: list[tuple[str, bytes, list]] = []
        for name in sorted(names):
            obj = state.ns[name]
            try:
                store: list = []
                buf = io.BytesIO()
                _Pickler(buf, store).dump(obj)
                arrays = [_prepare_array(a, codec, self.device)
                          for a in store]
                prepared.append((name, _compress(buf.getvalue(), codec),
                                 arrays))
            except Exception as e:  # noqa: BLE001 — paper: fall back to local
                if on_error == "skip":
                    skipped.append(name)
                    continue
                raise SerializationFailure(f"{name}: {e}") from e

        keys = [(name, k) for name, _, arrs in prepared
                for k in range(len(arrs))]
        payloads = [p for _, _, arrs in prepared for _, p in arrs]
        digest_lists, h64s = array_chunk_digests_many(
            payloads, self.chunk_bytes, device=self.device,
            priors=[self._chunk_cache.get(k) for k in keys])
        if len(self._chunk_cache) > 4096:   # bounded: priors are a cache
            self._chunk_cache.clear()
        for key, p, digs, h64 in zip(keys, payloads, digest_lists, h64s):
            self._chunk_cache[key] = (h64, digs, len(p))

        pos = 0
        for name, pickle_bytes, arrays in prepared:
            digs_here = digest_lists[pos:pos + len(arrays)]
            pos += len(arrays)
            # chunks newly inserted by this name; an earlier name's chunks
            # were inserted under *its* entry, so rolling these back on a
            # skip can never orphan a previous blob's references
            added: list[int] = []
            try:
                metas = []
                for (meta, payload), digests_a in zip(arrays, digs_here):
                    clens = []
                    for d, chunk in zip(digests_a,
                                        split_chunks(payload,
                                                     self.chunk_bytes)):
                        if d not in chunks:
                            chunks[d] = encode_chunk(chunk, codec)
                            added.append(d)
                        # the 1-byte codec tag is store framing, not wire
                        # payload
                        clens.append(len(chunks[d]) - 1)
                    metas.append(dict(meta, chunks=digests_a, clens=clens))
                blobs[name] = SerializedName(pickle_bytes=pickle_bytes,
                                             arrays=metas)
            except Exception as e:  # noqa: BLE001 — paper: fall back to local
                for d in added:
                    chunks.pop(d, None)
                if on_error == "skip":
                    skipped.append(name)
                    continue
                raise SerializationFailure(f"{name}: {e}") from e
        ser = SerializedState(codec=codec, blobs=blobs, chunks=chunks)
        if digests is None:
            ser.digests = self.digest_many({n: state.ns[n] for n in blobs})
        else:
            ser.digests = {n: digests[n] for n in blobs if n in digests}
            missing = [n for n in blobs if n not in digests]
            if missing:
                ser.digests.update(self.digest_many(
                    {n: state.ns[n] for n in missing}))
        ser.skipped = tuple(skipped)
        return ser

    def deserialize(self, ser: SerializedState,
                    target_ns: dict | None = None,
                    chunk_store=None) -> dict[str, Any]:
        """Rebuild objects; chunks resolve from ``ser.chunks`` first, then
        from ``chunk_store`` (the receiver's CAS)."""
        token = _TARGET_NS.set(target_ns)
        try:
            out: dict[str, Any] = {}
            for name, blob in ser.blobs.items():
                store = [_decode_array(m, ser.codec, ser.chunks, chunk_store,
                                       self.device)
                         for m in blob.arrays]
                buf = io.BytesIO(_decompress(blob.pickle_bytes, ser.codec))
                out[name] = _Unpickler(buf, store).load()
            return out
        finally:
            _TARGET_NS.reset(token)

    # -- step 3: content digests ---------------------------------------
    @staticmethod
    def _hashable_leaf(a):
        """Map a leaf to a form whose uint32 hashing keeps *every* bit.

        The reference re-lanes any dtype wider than 4 bytes, and any
        complex dtype, to a contiguous uint32 view on the host, so that a
        change confined to high bits or the imaginary part is never lost.
        A tensor is re-laned where it lies: ``view(torch.int32)`` of a
        contiguous tensor gives the same little-endian words as the host
        ``view(np.uint32)``, so a CUDA int64/float64/complex leaf digests
        as its numpy twin does, with no host round trip.  A numpy buffer
        that cannot be viewed as uint32 lanes is hashed via its zero-padded
        raw bytes, and an array with no stable bit pattern (object dtype)
        raises."""
        if isinstance(a, torch.Tensor):
            a = a.detach()
            if a.is_complex():
                a = torch.view_as_real(a)
            elif a.element_size() <= 4:
                return a                  # hashed where it lies
            return a.contiguous().reshape(-1).view(torch.int32)
        wide = a.dtype.itemsize > 4 or a.dtype.kind == "c"
        a = np.asarray(a)
        if a.dtype.kind == "O":
            raise TypeError("object arrays have no stable bit pattern")
        if not wide and a.dtype.kind in "biuf":
            return a
        a = np.ascontiguousarray(a)
        try:
            return a.reshape(-1).view(np.uint32)
        except (TypeError, ValueError):
            buf = a.tobytes()
            buf += b"\0" * ((-len(buf)) % 4)
            return np.frombuffer(buf, np.uint32)

    def _array_digest(self, a) -> int:
        """Per-leaf device digest (wide dtypes re-laned first)."""
        return digest_leaves([self._hashable_leaf(a)], device=self.device)[0]

    def _host_digest(self, obj) -> int:
        """Pickle-stream blake2b for objects that are not pure array trees."""
        try:
            store: list = []
            buf = io.BytesIO()
            _Pickler(buf, store).dump(obj)
        except Exception:
            return -1  # unhashable => always migrate (paper §II-D)
        h = hashlib.blake2b(buf.getvalue(), digest_size=8)
        for a in store:
            a = _host_numpy(a)
            h.update(np.ascontiguousarray(a).tobytes())
            h.update(str(a.shape).encode())
        return int.from_bytes(h.digest(), "little")

    def digest(self, obj) -> int:
        if _is_array(obj):
            return self._array_digest(obj)
        leaves, treedef = _tree_flatten(obj)
        if leaves and all(_is_array(l) for l in leaves):
            h = hashlib.blake2b(treedef.encode(), digest_size=8)
            for l in leaves:
                h.update(self._array_digest(l).to_bytes(8, "little"))
            return int.from_bytes(h.digest(), "little")
        return self._host_digest(obj)

    def _split_for_batch(self, objs: dict[str, Any]):
        """Partition names into the batched-digest plan.

        Returns (slots, leaves, host) where ``leaves`` is the flat leaf
        list for one batched launch and each slot is (name, treedef|None,
        leaf_count) consuming that many leaves in order; ``host`` holds the
        names digested via the pickle path."""
        slots: list[tuple[str, Any, int]] = []
        leaves: list = []
        host: dict[str, Any] = {}
        for n, obj in objs.items():
            if _is_array(obj):
                slots.append((n, None, 1))
                leaves.append(self._hashable_leaf(obj))
                continue
            ls, treedef = _tree_flatten(obj)
            if ls and all(_is_array(l) for l in ls):
                slots.append((n, treedef, len(ls)))
                leaves.extend(self._hashable_leaf(l) for l in ls)
            else:
                host[n] = obj
        return slots, leaves, host

    @staticmethod
    def _fold_slots(slots, leaf_digests) -> dict[str, int]:
        out: dict[str, int] = {}
        i = 0
        for n, treedef, k in slots:
            if treedef is None:
                out[n] = leaf_digests[i]
            else:
                h = hashlib.blake2b(treedef.encode(), digest_size=8)
                for d in leaf_digests[i:i + k]:
                    h.update(d.to_bytes(8, "little"))
                out[n] = int.from_bytes(h.digest(), "little")
            i += k
        return out

    def digest_many(self, objs: dict[str, Any]) -> dict[str, int]:
        """Digest a whole manifest: every array leaf across every name is
        packed into ONE kernel launch with ONE host sync (vs one launch +
        one ``np.asarray`` round-trip per leaf), bit-identical to calling
        :meth:`digest` per name."""
        slots, leaves, host = self._split_for_batch(objs)
        out = {n: self._host_digest(o) for n, o in host.items()}
        if slots:
            ds = digest_leaves(leaves, device=self.device)
            out.update(self._fold_slots(slots, ds))
        return out

    def digests(self, state: ExecutionState, names) -> dict[str, int]:
        return self.digest_many({n: state.ns[n] for n in names
                                 if n in state.ns})

    # -- step 4: delta ---------------------------------------------------
    def delta_names(self, state: ExecutionState, names,
                    known: dict[str, int]):
        """Returns (names to send, tombstones, sender digests).
        ``known`` = receiver's current content view.

        Pure-array names ride the fused digest->compare->gather path: the
        fresh digests are compared against ``known`` on device and only the
        changed-name index list crosses to the host — one launch, one sync
        for the whole manifest."""
        objs = {n: state.ns[n] for n in names if n in state.ns}
        slots, leaves, host = self._split_for_batch(objs)
        here = {n: self._host_digest(o) for n, o in host.items()}
        send = {n for n, d in here.items() if d == -1 or known.get(n) != d}
        if slots:
            # per-leaf priors: a single-array name compares on device
            # against the receiver's view of that name; tree leaves carry
            # no per-leaf prior (their name digest is a host-side blake2b
            # fold) so their real compare happens after the fold
            prior: list = []
            leaf_name: dict[int, str] = {}   # flat leaf idx -> array name
            i = 0
            for n, treedef, k in slots:
                if treedef is None:
                    prior.append(known.get(n))
                    leaf_name[i] = n
                else:
                    prior.extend([None] * k)
                i += k
            ds, changed = digest_leaves_delta(leaves, prior,
                                              device=self.device)
            folded = self._fold_slots(slots, ds)
            here.update(folded)
            send.update(leaf_name[j] for j in changed if j in leaf_name)
            send.update(n for n, treedef, _k in slots
                        if treedef is not None and known.get(n) != folded[n])
        dead = {n for n in known if n not in state.ns}
        return send, dead, here
