"""Execution state: the live namespace a notebook session mutates (§II-D).

Values may be anything — JAX arrays (possibly sharded), pytrees, numpy
arrays, plain Python objects, functions.  The reducer serializes a *subset*
of names; the state itself is never mutated by capture ("objects are
attached back once the serialization process completes" — we simply never
detach, which is the functional equivalent).
"""
from __future__ import annotations

import itertools
from typing import Any, Iterator

_HIDDEN_PREFIX = "_"

# dirty epochs tick off ONE process-wide counter so epochs from different
# states (a session migrating between envs writes into several namespaces)
# stay comparable: "dirtied after that live-set snapshot" is well-defined
# even when snapshot and definition happened in different envs
_EPOCHS = itertools.count(1)


class ExecutionState:
    def __init__(self, ns: dict[str, Any] | None = None):
        self.ns: dict[str, Any] = dict(ns or {})
        # dirty-since-epoch ledger for the background replicator: ``epoch``
        # records the last mark, ``dirty[name]`` the epoch at which the
        # name was last (re)defined.  A trickle target that synced at epoch
        # E only needs names with dirty > E — the cheap prefilter before
        # the digest-level delta.  Names never marked (e.g. seeded at
        # construction) are epoch 0.
        self.epoch: int = 0
        self.dirty: dict[str, int] = {}

    # dirty-epoch ledger ----------------------------------------------
    def mark_dirty(self, names) -> None:
        """Record that ``names`` were just (re)defined (one call per
        completed cell; the epoch comes off the process-wide counter)."""
        self.epoch = next(_EPOCHS)
        for n in names:
            self.dirty[n] = self.epoch

    def dirty_since(self, epoch: int) -> set[str]:
        """Names (re)defined strictly after ``epoch``, still present."""
        return {n for n, e in self.dirty.items() if e > epoch and n in self.ns}

    # dict-ish API -----------------------------------------------------
    def __getitem__(self, k: str) -> Any:
        return self.ns[k]

    def __setitem__(self, k: str, v: Any) -> None:
        self.ns[k] = v

    def __contains__(self, k: str) -> bool:
        return k in self.ns

    def get(self, k: str, default: Any = None) -> Any:
        return self.ns.get(k, default)

    def names(self) -> Iterator[str]:
        """User-visible (serializable-candidate) names."""
        for k in self.ns:
            if not k.startswith(_HIDDEN_PREFIX) and k not in ("__builtins__",):
                yield k

    def subset(self, names) -> dict[str, Any]:
        return {k: self.ns[k] for k in names if k in self.ns}

    def update(self, objs: dict[str, Any]) -> None:
        self.ns.update(objs)

    def drop(self, names) -> None:
        for k in names:
            self.ns.pop(k, None)
