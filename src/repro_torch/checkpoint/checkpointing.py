"""Checkpointing *is* migration to a storage environment (port of
``repro/checkpoint/checkpointing.py``).

A checkpoint directory is a ``kind="storage"`` :class:`ExecutionEnvironment`
backed by an on-disk content-addressed chunk store.  ``save`` flattens the
trees and migrates them into that env with the same reducer/engine every
other state transfer uses: per-name delta (unchanged leaves don't
re-serialize), per-chunk dedup (changed leaves re-ship only changed chunks),
tombstones for leaves that disappeared.  Each save then writes one
*self-contained* JSON manifest: every leaf's chunk manifest + digest, so any
step restores without replaying a delta chain and GC is just "drop old
manifests, then drop unreferenced chunks".  Manifests are atomic
tmp->rename; chunk files carry an integrity footer, so corrupted or torn
writes surface on restore.  ``AsyncCheckpointer`` overlaps serialization
with compute (background thread).

The storage keys are the reference's: ``name/`` plus the leaf's jax
``keystr`` path, written without jax (:func:`tree_map_with_path`), so
either package restores what the other saved.  Tensor leaves stay where
they lie: on a card, every digest of a save runs there through the hash
kernels.  ``restore`` gives each leaf back as its template leaf is: a
tensor on the template's device in its dtype, with the saved bits; any
other leaf as the numpy array the reference gives back.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.chunkstore import CHUNK_BYTES
from repro_torch.core.fabric import ExecutionEnvironment
from repro_torch.core.migration import MigrationEngine
from repro_torch.core.reducer import (
    SerializedName, SerializedState, StateReducer, tree_flatten_with_path,
    tree_map_with_path,
)
from repro_torch.device import resolve_device


class _LeafReducer(StateReducer):
    """The reducer of a checkpoint, whose leaves are flattened to numpy in
    the reference before they are digested: a numpy bf16 array (ml_dtypes,
    dtype kind ``V``) digests as its raw bytes in 32-bit words, zero-padded,
    not widened to f32 as a jax or torch bf16 array is.  So a bf16 tensor
    leaf digests here as its bits, where it lies (a view; a copy only to
    pad an odd count), and the manifests carry the reference's digests."""

    @staticmethod
    def _hashable_leaf(a):
        if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
            bits = a.detach().contiguous().reshape(-1).view(torch.int16)
            if bits.numel() % 2:
                bits = torch.cat([bits, bits.new_zeros(1)])
            return bits.view(torch.int32)
        return StateReducer._hashable_leaf(a)


def _leaf(x):
    """A tensor as it lies; anything else as the reference's ``np.asarray``."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _flatten(tree, prefix: str) -> dict:
    return {prefix + path: _leaf(leaf)
            for path, leaf in tree_flatten_with_path(tree)}


def _placed(value, template):
    """A restored value (numpy, or a CPU bf16 tensor) on the template
    leaf's device, in the saved dtype; a non-tensor template takes the
    value as the reference gives it back (a bf16 one as the template's
    numpy bf16 dtype, viewed from the bits, where the template has it)."""
    if isinstance(template, torch.Tensor):
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(value)
        return t.to(template.device)
    if isinstance(value, torch.Tensor):            # bf16 bits
        dt = getattr(template, "dtype", None)
        if getattr(dt, "name", None) == "bfloat16":
            return value.view(torch.int16).numpy().view(dt)
    return value


def _as_template(value, template):
    """A placed value in the template tensor's dtype (a no-op, bits kept,
    when they agree)."""
    if isinstance(template, torch.Tensor) and value.dtype != template.dtype:
        return value.to(template.dtype)
    return value


def _unflatten(template, prefix: str, store: dict):
    return tree_map_with_path(
        lambda path, t: _as_template(store[prefix + path], t), template)


def _meta_to_json(blob: SerializedName) -> dict:
    return {"pickle": blob.pickle_bytes.hex(), "arrays": [
        {**a, "shape": list(a["shape"]),
         **({"scales": a["scales"].hex()} if "scales" in a else {})}
        for a in blob.arrays]}


def _meta_from_json(rec: dict) -> SerializedName:
    arrays = []
    for a in rec["arrays"]:
        a = dict(a)
        a["shape"] = tuple(a["shape"])
        if "scales" in a:
            a["scales"] = bytes.fromhex(a["scales"])
        arrays.append(a)
    return SerializedName(bytes.fromhex(rec["pickle"]), arrays)


@dataclass
class CheckpointInfo:
    step: int
    nbytes: int
    n_leaves_written: int
    n_leaves_total: int
    seconds: float


class Checkpointer:
    def __init__(self, directory: str, codec: str = "zstd", keep: int = 3,
                 delta: bool = True, rebase_every: int = 5,
                 chunk_bytes: int = CHUNK_BYTES, device="cuda"):
        self.dir = directory
        # where every digest and chunk key of a save and a restore runs:
        # "cuda" (the hash kernels; raises without a card) or "cpu"
        self.device = resolve_device(device)
        os.makedirs(directory, exist_ok=True)
        self.reducer = _LeafReducer(codec=codec, reduce_state=False,
                                    device=self.device,
                                    chunk_bytes=chunk_bytes)
        self.codec = codec
        self.keep = keep
        self.rebase_every = max(rebase_every, 1)
        self._count = 0
        # the checkpoint target: a storage env over an on-disk CAS -- saving
        # is the same engine call as migrating to any other environment
        self.storage = ExecutionEnvironment("ckpt-storage", kind="storage",
                                            storage_dir=directory)
        self.engine = MigrationEngine(self.reducer, delta=delta)
        self._blob_meta: dict[str, SerializedName] = {}  # leaf -> manifest

    # ------------------------------------------------------------------
    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.dir, f"manifest-{step:08d}.json")

    def save(self, step: int, trees: dict) -> CheckpointInfo:
        """trees: e.g. {"params": params, "opt": opt_state, "data_step": ...}"""
        t0 = time.perf_counter()
        store: dict = {}
        for k, tree in trees.items():
            store.update(_flatten(tree, k + "/"))
        live = ExecutionEnvironment("ckpt-live", globals_seed=store)
        names = set(store)

        res = self.engine.migrate(live, self.storage, names=names)
        for name in res.deleted:
            self._blob_meta.pop(name, None)
        if self.engine.last_ser is not None:
            self._blob_meta.update(self.engine.last_ser.blobs)

        # every k-th manifest is tagged "full" for operator tooling parity
        # with the pre-CAS delta chains -- but *every* manifest is
        # self-contained, so restore never replays a chain
        full = (self._count % self.rebase_every == 0)
        self._count += 1
        view = self.engine.synced.get(self.storage.name, {})
        manifest = {
            "step": step, "codec": self.codec, "full": full,
            "digests": {n: view[n] for n in names},
            "written": sorted(res.names), "deleted": sorted(res.deleted),
            "names": {n: _meta_to_json(self._blob_meta[n]) for n in names},
            "keys": sorted(trees),
        }
        mtmp = self._manifest_path(step) + ".tmp"
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, self._manifest_path(step))

        self._gc()
        return CheckpointInfo(step, res.nbytes, len(res.names), len(names),
                              time.perf_counter() - t0)

    # ------------------------------------------------------------------
    def _steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.dir):
            if fn.startswith("manifest-") and fn.endswith(".json"):
                out.append(int(fn[len("manifest-"):-len(".json")]))
        return sorted(out)

    def _manifest(self, step: int) -> dict:
        with open(self._manifest_path(step)) as f:
            return json.load(f)

    def _gc(self) -> None:
        """Drop manifests beyond ``keep`` (every one is self-contained),
        then drop chunks no surviving manifest references."""
        steps = self._steps()
        if len(steps) <= self.keep + 1:
            return
        drop, survive = steps[:-(self.keep + 1)], steps[-(self.keep + 1):]
        referenced: set[int] = set()
        for s in survive:
            for rec in self._manifest(s)["names"].values():
                for a in rec["arrays"]:
                    referenced.update(a["chunks"])
        for s in drop:
            p = self._manifest_path(s)
            if os.path.exists(p):
                os.remove(p)
        for d in self.storage.chunk_store.digests() - referenced:
            self.storage.chunk_store.remove(d)

    # ------------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, templates: dict, step: int | None = None) -> tuple[dict, int]:
        """Rebuild from the step's self-contained manifest + the disk CAS;
        verifies chunk integrity footers and per-leaf content digests (on
        the reducer's device, each leaf where its template puts it)."""
        steps = self._steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        target = step if step is not None else steps[-1]
        candidates = [x for x in steps if x <= target]
        if not candidates:
            raise FileNotFoundError(f"no checkpoint at or before {target}")
        manifest = self._manifest(candidates[-1])

        blobs = {n: _meta_from_json(rec)
                 for n, rec in manifest["names"].items()}
        ser = SerializedState(codec=manifest["codec"], blobs=blobs)
        store = self.reducer.deserialize(
            ser, chunk_store=self.storage.chunk_store)

        wanted = {k + "/" + path: t for k, tree in templates.items()
                  for path, t in tree_flatten_with_path(tree)}
        missing = [n for n in manifest["digests"] if n not in store]
        if missing:
            raise IOError(f"checkpoint missing leaf {missing[0]}")
        placed = {n: _placed(v, wanted.get(n)) for n, v in store.items()}
        got = self.reducer.digest_many(
            {n: placed[n] for n in manifest["digests"]})
        for name, want in manifest["digests"].items():
            if want != -1 and got[name] != want:
                raise IOError(f"checkpoint digest mismatch for {name}")

        out = {k: _unflatten(t, k + "/", placed) for k, t in templates.items()}
        return out, manifest["step"]


class AsyncCheckpointer:
    """Overlap checkpoint writes with compute (single background writer).

    ``save`` snapshots before it returns: each tensor is cloned on its own
    device (so the writer hashes a card's leaves on the card, at the cost
    of one copy of the trees there until the write ends), anything else
    copied on the host.  An error in the writer is raised by ``wait``."""

    def __init__(self, inner: Checkpointer):
        self.inner = inner
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last_info: CheckpointInfo | None = None

    def save(self, step: int, trees: dict) -> None:
        self.wait()
        snap = tree_map_with_path(
            lambda _p, x: x.detach().clone() if isinstance(x, torch.Tensor)
            else np.array(x), trees)

        def run():
            try:
                self.last_info = self.inner.save(step, snap)
            except BaseException as e:  # noqa: BLE001 -- raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
