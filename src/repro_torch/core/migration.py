"""The migration engine and the hybrid runtime over the environment fabric.

This is the paper's server-side machinery assembled: sessions emit Table-I
telemetry on the MQ bus; the context detector listens; the analyzer decides
placement; the engine moves *reduced, delta, compressed* state between
environments; everything is recorded as provenance.

Environments live in :mod:`repro_torch.core.fabric`: an ExecutionEnvironment is
"a place code can run with its own namespace" — the user's machine, a cloud
node, or, in the TPU adaptation, a JAX mesh (``DistContext``), which is how
the same engine implements checkpointing (migration to a storage env) and
elastic rescaling (migration between meshes).  The runtime works over any
:class:`EnvironmentRegistry` (N environments, per-pair link costs); the
paper's local/remote dyad is the two-env instance.  Timing follows the
paper's §III protocol: declared cell costs (or measured wall time) divided
by the environment speedup, on a simulated clock.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core import telemetry as T
from repro_torch.core.analyzer import Decision, MigrationAnalyzer, PerfModel
from repro_torch.core.context import ContextDetector
from repro_torch.core.fabric import EnvironmentRegistry, ExecutionEnvironment
from repro_torch.core.interaction import (ConfidenceGate, InteractionModel,
                                    top_candidates)
from repro_torch.core.kb import KnowledgeBase, ProvRecord
from repro_torch.core.notebook import Cell, Notebook
from repro_torch.core.reducer import (DIGEST_BYTES, SerializationFailure,
                                SerializedState, StateReducer)
from repro_torch.core.simclock import SimClock
from repro_torch.core.state import ExecutionState

__all__ = [
    "EnvFailure", "ExecutionEnvironment", "MigrationResult",
    "MigrationEngine", "PipelinedMigrationEngine", "DeltaReplicator",
    "HybridRuntime",
]


class EnvFailure(Exception):
    """An environment died while a cell (or a migration into it) was in
    flight.  The clock has been advanced to the failure instant — the work
    up to then is charged and lost; the fleet scheduler owns recovery
    (checkpoint restore or rerun-from-home)."""

    def __init__(self, env: str, at: float, order: int | None = None, *,
                 during: str = "execute", wasted: float = 0.0):
        super().__init__(f"environment {env!r} failed at t={at:.3f} "
                         f"during {during} (cell order={order}, "
                         f"{wasted:.3f}s of work lost)")
        self.env = env
        self.at = at
        self.order = order
        self.during = during
        self.wasted = wasted


@dataclass
class MigrationResult:
    src: str
    dst: str
    names: tuple[str, ...]
    deleted: tuple[str, ...]
    nbytes: int
    seconds: float
    full_bytes: int = 0      # what a full-state migration would have cost
    noop: bool = False       # empty delta: nothing travelled, nothing charged
    prefetched: tuple[str, ...] = ()   # names applied from a pipelined prefetch
    wasted_prefetch_bytes: int = 0     # speculative bytes streamed but unused
    claimed: tuple[str, ...] = ()      # names claimed from trickled replication
    claim_bytes: int = 0               # manifest-only cost of that claim
    # transport plane: what the migration actually cost on a real transport.
    # ``seconds`` above stays the *modeled* charge (placement decisions and
    # the sim clock run on it); these record reality when frames moved.
    transport: str = "loopback"
    wire_frames: int = 0               # frames that crossed the transport
    wall_seconds: float = 0.0          # measured transfer wall time


@dataclass
class _PendingPrefetch:
    """An in-flight background transfer started by the pipelined engine."""
    src: str
    dst: str
    ser: SerializedState
    started_at: float
    ready_at: float
    nbytes: int
    held: frozenset = frozenset()   # chunks dst already had at begin time
    predicted_order: int | None = None   # cell this speculation bets on
    prob: float | None = None            # predicted probability (None=planned)
    dst_store: object = None             # receiver's chunk store (for banking)
    peer: object = None                  # transport peer when dst is remote


class MigrationEngine:
    """Reduced/delta/compressed state transfer between environments.

    Transfer cost resolves through the registry's per-pair links when a
    registry is attached; otherwise the scalar ``bandwidth``/``latency``
    model applies to every pair (the paper's uniform setup).  Optional
    ``serialize_bandwidth``/``compress_bandwidth`` model the capture and
    codec stages; this synchronous engine charges the three stages
    *serially* — :class:`PipelinedMigrationEngine` overlaps them.
    """

    def __init__(self, reducer: StateReducer, *, bandwidth: float = 1e9,
                 latency: float = 0.5, delta: bool = True,
                 registry: EnvironmentRegistry | None = None,
                 serialize_bandwidth: float = math.inf,
                 compress_bandwidth: float = math.inf):
        self.reducer = reducer
        self.bandwidth = bandwidth
        self.latency = latency
        self.delta = delta
        self.registry = registry
        self.serialize_bandwidth = serialize_bandwidth
        self.compress_bandwidth = compress_bandwidth
        # receiver's content view: env name -> {state name -> digest}
        self.synced: dict[str, dict[str, int]] = {}
        self.log: list[MigrationResult] = []
        # background delta replicator (attached by the runtime when live
        # replication is on); decision-time migrations claim its banked state
        self.replicator: "DeltaReplicator | None" = None
        # ONE waste ledger for every speculative byte that streamed but was
        # never claimed — pipelined prefetch and trickled replication both
        # charge here, so reports surface a single number
        self.prefetch_wasted_bytes = 0
        # chunk manifests of the most recent migrate() — consumed by the
        # Checkpointer; deliberately NOT kept per-log-entry, which would pin
        # every byte ever migrated in memory for the session's lifetime
        self.last_ser: SerializedState | None = None

    # -- cost model ------------------------------------------------------
    def _link_seconds(self, nbytes: int, src: str | None, dst: str | None) -> float:
        if self.registry is not None and src is not None and dst is not None:
            return self.registry.transfer_seconds(src, dst, nbytes)
        return self.latency + nbytes / self.bandwidth

    def _stage_seconds(self, nbytes: int) -> float:
        return nbytes / self.serialize_bandwidth + nbytes / self.compress_bandwidth

    def transfer_seconds(self, nbytes: int, src: str | None = None,
                         dst: str | None = None) -> float:
        """Serialize + compress + network, charged end to end (synchronous)."""
        return self._stage_seconds(nbytes) + self._link_seconds(nbytes, src, dst)

    # ------------------------------------------------------------------
    def migrate(self, src: ExecutionEnvironment, dst: ExecutionEnvironment,
                cell_source: str | None = None,
                names: set[str] | None = None,
                strict: bool = True, now: float | None = None) -> MigrationResult:
        """Move the state ``cell_source`` needs (or explicit ``names``) from
        src to dst; only new/changed names are serialized when delta is on.

        When either end carries a transport ``peer`` (socket / subprocess),
        the migration genuinely streams wire frames — chunk-manifest
        exchange, chunk payloads, tombstones — instead of moving objects in
        process; the modeled ``seconds`` are unchanged, and the real frame
        count and wall time land on the result."""
        if getattr(src, "peer", None) is not None:
            return self._migrate_pull(src, dst, cell_source, names, strict)
        import types as _types
        modules: set[str] = set()
        full_state = names is None and cell_source is None
        if names is None:
            if cell_source is not None:
                names, modules, _ = self.reducer.reduce(src.state, cell_source)
            else:
                names = set(src.state.names())
        rep = self.replicator
        if rep is not None and full_state and dst.kind != "storage":
            # liveness pruning: a full-state move (return home / block exit)
            # skips names no remaining cell can observe.  Checkpoints
            # (storage destinations) always carry everything — recovery may
            # replay from an older plan position than liveness assumed.
            names = rep.prune_dead(names, src.state)
        # re-import module aliases on the destination (paper: preamble/deps);
        # for a transport-bound destination the alias specs ride the
        # manifest instead and the receiver imports them itself
        dst_peer = getattr(dst, "peer", None)
        mod_aliases: list[str] = []
        for alias, val in list(src.state.ns.items()):
            if isinstance(val, _types.ModuleType) and (
                    alias in names or val.__name__.split(".")[0] in modules):
                mod_aliases.append(f"{alias}={val.__name__}")
                if dst_peer is not None:
                    continue
                try:
                    dst.state.ns[alias] = __import__(val.__name__)
                    if "." in val.__name__:  # alias points at a submodule
                        import importlib
                        dst.state.ns[alias] = importlib.import_module(val.__name__)
                except ImportError:
                    pass
        # module aliases are re-imported on the destination, never serialized
        names = {n for n in names
                 if not isinstance(src.state.get(n), _types.ModuleType)}
        known = self.synced.setdefault(dst.name, {})
        # claim trickled state: names the replicator already banked at dst
        # (content re-validated by digest) need only a manifest, not bytes
        claim_sub: SerializedState | None = None
        if rep is not None and self.delta and dst.kind != "storage":
            claim_sub = rep.peek_claim(src, dst, names, known)
        if self.delta:
            eff_known = (known if claim_sub is None
                         else {**known, **claim_sub.digests})
            send, dead, here = self.reducer.delta_names(src.state, names,
                                                        eff_known)
            send &= set(names)
        else:
            send, dead = set(names), set()
            here = self.reducer.digests(src.state, names)

        ser = self.reducer.serialize_names(
            src.state, send, on_error="raise" if strict else "skip",
            digests=here)      # delta already digested this capture
        # chunk-manifest exchange: the receiver advertises the chunk digests
        # its store already holds; only missing chunks cross the wire, so a
        # small in-place update to a large array moves one chunk, not the
        # array, and a dataset shared across sessions moves once.
        wire_frames, wall_seconds = 0, 0.0
        if dst_peer is not None and (send or dead or mod_aliases):
            # transport-bound destination: the manifest exchange happens
            # over real frames — the receiver's need-ack IS the held set.
            # Module aliases ride the manifest, so they must stream even
            # when the state delta is empty (the loopback path re-imports
            # them unconditionally; an alias-only stream keeps parity)
            stats = dst_peer.send_state(ser, deleted=dead,
                                        modules=mod_aliases)
            held = {d for d in ser.chunks if d in stats.held}
            wire_bytes = ser.wire_nbytes(held)
            # the mirror records what the remote store now holds
            dst.chunk_store.put_many(ser.chunks)
            src.chunk_store.put_many(ser.chunks)
            wire_frames, wall_seconds = stats.frames, stats.wall_seconds
        else:
            dst_store = dst.chunk_store
            held = {d for d in ser.chunks if dst_store.has(d)}
            wire_bytes = ser.wire_nbytes(held)
            dst_store.put_many(ser.missing_chunks(held))
            src.chunk_store.put_many(ser.chunks)  # sender holds its own content
            if dst.kind != "storage" and dst_peer is None:
                # storage envs are manifest+CAS only: restore reads the
                # store, so materializing leaves into the namespace would
                # just pin a second in-RAM copy of every checkpoint
                objs = self.reducer.deserialize(ser, target_ns=dst.state.ns,
                                                chunk_store=dst_store)
                dst.state.update(objs)
        dst.state.drop(dead)

        known.update(ser.digests)
        for n in dead:
            known.pop(n, None)
        # the sender's own content view is now also known
        self.synced.setdefault(src.name, {}).update(here)
        # a deletion on the source is a deletion on *every* synced receiver
        if dead:
            self._propagate_tombstones(dead, exclude=(dst.name,))

        # apply the replication claim: the bytes are already banked at dst,
        # so only the manifest (digest refs + pickle streams) travels — a
        # converged trickle turns the migration into this claim alone
        claim_names: tuple[str, ...] = ()
        claim_bytes = 0
        if claim_sub is not None:
            held_claim = {d for b in claim_sub.blobs.values()
                          for d in b.chunk_digests()}
            claim_bytes = claim_sub.wire_nbytes(held_claim)
            if dst_peer is not None:
                cstats = dst_peer.send_state(claim_sub)
                wire_frames += cstats.frames
                wall_seconds += cstats.wall_seconds
            else:
                objs = self.reducer.deserialize(claim_sub,
                                                target_ns=dst.state.ns,
                                                chunk_store=dst.chunk_store)
                dst.state.update(objs)
            known.update(claim_sub.digests)
            rep.commit_claim(dst.name, claim_sub)
            claim_names = tuple(sorted(claim_sub.blobs))
            wire_bytes += claim_bytes

        # an empty delta is a no-op: nothing crosses the wire, nothing charged
        noop = not send and not dead and not claim_names
        seconds = 0.0 if noop else self.transfer_seconds(
            wire_bytes, src.name, dst.name)
        res = MigrationResult(src.name, dst.name,
                              tuple(sorted(set(send) | set(claim_names))),
                              tuple(sorted(dead)), 0 if noop else wire_bytes,
                              seconds, noop=noop,
                              claimed=claim_names, claim_bytes=claim_bytes,
                              transport=(getattr(dst, "transport", "socket")
                                         if dst_peer is not None
                                         else "loopback"),
                              wire_frames=wire_frames,
                              wall_seconds=wall_seconds)
        self.last_ser = ser
        self.log.append(res)
        return res

    def _migrate_pull(self, src: ExecutionEnvironment,
                      dst: ExecutionEnvironment,
                      cell_source: str | None, names: set[str] | None,
                      strict: bool) -> MigrationResult:
        """``src``'s namespace lives behind a transport peer (a subprocess
        or socket-served env): the remote side reduces, computes the delta
        against our content view, serializes, and streams the state home.
        Chunks ``dst``'s store already holds are not re-requested."""
        from repro_torch.core.transport import import_alias_specs
        known = self.synced.setdefault(dst.name, {})
        ser, dead, modules, stats = src.peer.fetch_state(
            names=set(names) if names is not None else None,
            cell_source=cell_source,
            known=known if self.delta else {},
            strict=strict, delta=self.delta, store=dst.chunk_store)
        # module aliases re-import on the destination (paper: preamble/deps)
        import_alias_specs(dst.state.ns, modules)
        wire_bytes = ser.wire_nbytes(set(stats.held))
        dst.chunk_store.put_many(ser.chunks)
        if dst.kind != "storage":
            objs = self.reducer.deserialize(ser, target_ns=dst.state.ns,
                                            chunk_store=dst.chunk_store)
            dst.state.update(objs)
        dst.state.drop(dead)
        known.update(ser.digests)
        for n in dead:
            known.pop(n, None)
        self.synced.setdefault(src.name, {}).update(ser.digests)
        if dead:
            self._propagate_tombstones(dead, exclude=(dst.name,))
        send = set(ser.blobs)
        noop = not send and not dead
        seconds = 0.0 if noop else self.transfer_seconds(
            wire_bytes, src.name, dst.name)
        res = MigrationResult(src.name, dst.name, tuple(sorted(send)),
                              tuple(sorted(dead)), 0 if noop else wire_bytes,
                              seconds, noop=noop,
                              transport=getattr(src, "transport", "socket"),
                              wire_frames=stats.frames,
                              wall_seconds=stats.wall_seconds)
        self.last_ser = ser
        self.log.append(res)
        return res

    def _propagate_tombstones(self, dead, exclude=()) -> None:
        """Names deleted on the source are dropped on every env whose synced
        view records them, and their digests evicted from all views."""
        for env_name, view in self.synced.items():
            if env_name in exclude:
                continue
            held = [n for n in dead if n in view]
            if not held:
                continue
            for n in held:
                view.pop(n, None)
            if self.registry is not None and env_name in self.registry:
                self.registry[env_name].state.drop(held)

    def invalidate(self, env_name: str, names) -> None:
        """``env_name`` (re)defined these names: every peer's copy — and every
        recorded digest — is stale; force a re-send on the next migration."""
        for view in self.synced.values():
            for n in names:
                view.pop(n, None)


class PipelinedMigrationEngine(MigrationEngine):
    """Chunked serialize → compress → transfer pipeline on the sim clock.

    Two wins over the synchronous engine:

    * within one migration, the three stages overlap chunk-by-chunk, so the
      charge is dominated by the slowest stage instead of their sum;
    * :meth:`begin_prefetch` starts the predicted next hop's transfer in the
      background while the current cell executes — the eventual ``migrate``
      only charges whatever transfer time execution did not already cover.

    Prefetch is *confidence-gated speculation*: callers pass the predicted
    probability of the hop and the :class:`ConfidenceGate` admits only
    predictions whose mass clears its (self-calibrating) threshold
    (``prob=None`` marks a planned, non-speculative transfer — e.g. the
    next cell of a committed block — which always proceeds).  Stale claims
    can be cancelled, and every speculative byte that streamed without
    being applied is accounted in ``prefetch_wasted_bytes`` and on the
    claiming :class:`MigrationResult`.
    """

    def __init__(self, reducer: StateReducer, *,
                 chunk_bytes: int | None = None,
                 gate: ConfidenceGate | None = None,
                 prefetch_top_k: int = 2, **kw):
        super().__init__(reducer, **kw)
        # stage-overlap granularity defaults to the reducer's CAS chunk size
        # so the pipeline and the store chunk the same way
        self.chunk_bytes = int(chunk_bytes if chunk_bytes is not None
                               else max(reducer.chunk_bytes, 1))
        self._pending: dict[str, _PendingPrefetch] = {}
        self.gate = gate if gate is not None else ConfidenceGate()
        self.prefetch_top_k = int(prefetch_top_k)
        self.prefetch_hits = 0
        self.prefetch_issued = 0
        self.prefetch_gated = 0          # speculations the gate rejected
        self.prefetch_cancelled = 0
        self.prefetch_wasted_bytes = 0
        self.prefetch_useful_bytes = 0

    # -- speculative accounting ------------------------------------------
    @staticmethod
    def _delivered_bytes(p: _PendingPrefetch, now: float | None) -> int:
        """Bytes of the speculative transfer on the wire by ``now``."""
        if now is None or now >= p.ready_at:
            return p.nbytes
        span = p.ready_at - p.started_at
        if span <= 0:
            return p.nbytes
        frac = max(0.0, min(1.0, (now - p.started_at) / span))
        return int(p.nbytes * frac)

    def cancel_prefetch(self, dst_name: str,
                        now: float | None = None) -> int:
        """Cancel the pending speculative transfer to ``dst_name``; returns
        the wasted bytes (what already streamed).  Chunks that fully arrived
        are still banked into the receiver's store — content-addressed
        chunks are immutable, so they may yet pay off — but the bytes are
        charged as waste because this speculation did not.  A transport-
        bound destination additionally gets a CANCEL frame (a no-op when
        the synchronous speculative stream already completed; it clears
        remote stream state if the transfer was interrupted)."""
        p = self._pending.pop(dst_name, None)
        if p is None:
            return 0
        wasted = self._delivered_bytes(p, now)
        if now is not None and now >= p.ready_at and p.dst_store is not None:
            p.dst_store.put_many(p.ser.chunks)
        if p.peer is not None:
            p.peer.cancel()
        self.prefetch_cancelled += 1
        self.prefetch_wasted_bytes += wasted
        return wasted

    def cancel_stale(self, keep: set[str],
                     now: float | None = None) -> list[tuple[str, int, int | None]]:
        """Cancel every pending speculation whose destination is not in
        ``keep``; returns (dst, wasted_bytes, predicted_order) tuples."""
        out = []
        for dst in [d for d in self._pending if d not in keep]:
            order = self._pending[dst].predicted_order
            out.append((dst, self.cancel_prefetch(dst, now), order))
        return out

    # -- cost model ------------------------------------------------------
    def transfer_seconds(self, nbytes: int, src: str | None = None,
                         dst: str | None = None) -> float:
        """Chunk-pipelined: latency + one chunk through every stage +
        the remaining chunks behind the bottleneck stage."""
        if nbytes <= 0:
            return self._link_seconds(0, src, dst)
        link = (self.registry.link(src, dst)
                if self.registry is not None and src is not None
                and dst is not None else None)
        net_bw = link.bandwidth if link is not None else self.bandwidth
        lat = link.latency if link is not None else self.latency
        nchunks = max(1, math.ceil(nbytes / self.chunk_bytes))
        chunk = nbytes / nchunks
        stage = [chunk / self.serialize_bandwidth,
                 chunk / self.compress_bandwidth, chunk / net_bw]
        return lat + sum(stage) + (nchunks - 1) * max(stage)

    # -- prefetch --------------------------------------------------------
    def begin_prefetch(self, src: ExecutionEnvironment,
                       dst: ExecutionEnvironment,
                       cell_source: str | None = None,
                       names: set[str] | None = None,
                       now: float = 0.0,
                       prob: float | None = None,
                       predicted_order: int | None = None) -> _PendingPrefetch | None:
        """Snapshot the delta ``cell_source`` will need on ``dst`` and start
        its transfer in the background (completes at ``ready_at`` on the sim
        clock).  Nothing is applied to ``dst`` until ``migrate`` claims it.

        ``prob`` marks the transfer as *speculative* with that predicted
        probability: the confidence gate must admit it, and a superseded
        speculation to the same destination is cancelled (wasted bytes
        accounted).  ``prob=None`` is a planned transfer and bypasses the
        gate (the paper's unconditional next-hop prefetch)."""
        import types as _types
        if getattr(src, "peer", None) is not None:
            return None      # a remote namespace cannot be snapshotted here
        if prob is not None and self.gate is not None \
                and not self.gate.allow(prob):
            self.prefetch_gated += 1
            self.gate.rejected()
            return None
        if dst.name in self._pending:
            # a newer prediction supersedes the in-flight speculation
            self.cancel_prefetch(dst.name, now)
        if names is None:
            if cell_source is not None:
                names, _, _ = self.reducer.reduce(src.state, cell_source)
            else:
                names = set(src.state.names())
        # Speculatively carry the *whole* needed set, not just the current
        # delta: the overlapped cell may invalidate names that look synced
        # right now, and the claim only applies what actually must travel.
        names = {n for n in names if n in src.state.ns
                 and not isinstance(src.state.get(n), _types.ModuleType)}
        if not names:
            return None
        ser = self.reducer.serialize_names(src.state, names, on_error="skip")
        if not ser.blobs:
            return None
        # only chunks the receiver's store lacks actually stream
        dst_peer = getattr(dst, "peer", None)
        if dst_peer is not None:
            # speculative frames really travel: the receiver banks the
            # chunks (no namespace apply until a claiming stream lands)
            stats = dst_peer.send_state(ser, speculative=True)
            held = frozenset(d for d in ser.chunks if d in stats.held)
            dst.chunk_store.put_many(ser.chunks)    # mirror what was banked
        else:
            held = frozenset(d for d in ser.chunks if dst.chunk_store.has(d))
        nbytes = ser.wire_nbytes(set(held))
        pending = _PendingPrefetch(
            src.name, dst.name, ser, started_at=now,
            ready_at=now + self.transfer_seconds(nbytes, src.name, dst.name),
            nbytes=nbytes, held=held, predicted_order=predicted_order,
            prob=prob, dst_store=dst.chunk_store, peer=dst_peer)
        self._pending[dst.name] = pending
        self.prefetch_issued += 1
        return pending

    def migrate(self, src: ExecutionEnvironment, dst: ExecutionEnvironment,
                cell_source: str | None = None,
                names: set[str] | None = None,
                strict: bool = True, now: float | None = None) -> MigrationResult:
        p = self._pending.get(dst.name)
        valid: dict[str, int] = {}
        if p is not None and p.src == src.name:
            # a name is applied wholesale iff the source still holds the
            # snapshotted content (else it must travel fresh) AND the
            # receiver doesn't already have it (else the claim would turn a
            # free no-op delta into a charged wait)
            known = self.synced.setdefault(dst.name, {})
            cand = {n: d for n, d in p.ser.digests.items()
                    if n in p.ser.blobs and n in src.state.ns
                    and known.get(n) != d}
            # one batched launch re-digests every candidate at once
            cur = self.reducer.digest_many(
                {n: src.state.ns[n] for n in cand})
            valid = {n: d for n, d in cand.items() if cur.get(n) == d}
            # the claim then validates per-chunk: content-addressed chunks
            # are immutable, so prefetched chunks are banked into the
            # receiver's store — but only those the transfer has physically
            # delivered.  Once the background transfer completed, everything
            # banks (a name redefined mid-flight re-serializes fresh, yet
            # its unchanged chunks no longer re-cross the wire); before
            # that, only the valid names' chunks bank, because exactly those
            # are paid for via the residual wait below.
            if now is not None and now >= p.ready_at:
                dst.chunk_store.put_many(p.ser.chunks)
            elif valid:
                dst.chunk_store.put_many(
                    {d: p.ser.chunks[d] for n in valid
                     for d in p.ser.blobs[n].chunk_digests()
                     if d in p.ser.chunks})
        if not valid:
            wasted = 0
            if p is not None and p.src == src.name:
                del self._pending[dst.name]      # consumed, nothing useful
                wasted = self._delivered_bytes(p, now)
                self.prefetch_wasted_bytes += wasted
                # like cancel_prefetch: chunks that fully arrived are banked
                # (immutable, content-addressed) so the fallback migration
                # below doesn't re-ship what already crossed the wire — a
                # redefined name re-serializes, but its unchanged chunks
                # collapse to the manifest
                if now is not None and now >= p.ready_at:
                    dst.chunk_store.put_many(p.ser.chunks)
            res = super().migrate(src, dst, cell_source, names=names,
                                  strict=strict, now=now)
            res.wasted_prefetch_bytes = wasted
            return res

        # mark the claimed names synced so the base delta skips them, but
        # apply nothing until the residual migration has succeeded — a
        # SerializationFailure must leave dst untouched
        saved = {n: known[n] for n in valid if n in known}
        known.update(valid)
        try:
            res = super().migrate(src, dst, cell_source, names=names,
                                  strict=strict, now=now)
        except Exception:
            for n in valid:
                known.pop(n, None)
            known.update(saved)
            raise
        del self._pending[dst.name]
        sub = SerializedState(
            codec=p.ser.codec, blobs={n: p.ser.blobs[n] for n in valid},
            digests=dict(valid))
        sub.chunks = {d: p.ser.chunks[d]
                      for b in sub.blobs.values() for d in b.chunk_digests()
                      if d in p.ser.chunks}
        if p.peer is not None:
            # remote claim: the chunks are already banked over there, so
            # this stream is manifest-only — the receiver materializes the
            # names from its own store.  Its frames are real traffic and
            # count on the result (the residual migrate above was likely
            # a frameless noop)
            claim_stats = p.peer.send_state(sub)
            res.wire_frames += claim_stats.frames
            res.wall_seconds += claim_stats.wall_seconds
            res.transport = getattr(dst, "transport", res.transport)
        else:
            objs = self.reducer.deserialize(sub, target_ns=dst.state.ns,
                                            chunk_store=dst.chunk_store)
            dst.state.update(objs)
        # residual wait models the applied subset streaming since started_at
        # (not the full speculative snapshot, which may be mostly synced);
        # chunks the receiver already held at begin time never streamed
        sub_wire = sub.wire_nbytes(set(p.held))
        wait = 0.0
        if now is not None:
            ready = p.started_at + self.transfer_seconds(
                sub_wire, src.name, dst.name)
            wait = max(0.0, ready - now)
        self.prefetch_hits += 1
        self.prefetch_useful_bytes += sub_wire
        # speculative bytes that streamed but were not part of the applied
        # subset (the snapshot carried names that turned out synced/stale)
        overshoot = max(0, min(p.nbytes, self._delivered_bytes(p, now))
                        - sub_wire)
        self.prefetch_wasted_bytes += overshoot
        res.names = tuple(sorted(set(res.names) | set(valid)))
        res.prefetched = tuple(sorted(valid))
        res.nbytes += sub_wire
        res.seconds += wait
        res.noop = False
        res.wasted_prefetch_bytes = overshoot
        return res


@dataclass
class _BankedName:
    """One name's trickled snapshot banked at a destination."""
    blob: object                 # SerializedName (chunks live in dst's store)
    digest: int
    nbytes: int                  # wire bytes this entry cost to trickle


class DeltaReplicator:
    """Background delta replication during think time (the tentpole).

    Between cells — while the user reads output — the replicator wakes,
    asks the reducer which names changed since the last trickle to each
    likely target (the interaction model's next-cell distribution picks the
    top-k), and streams those deltas ahead of any decision, rate-limited on
    the transport's low-priority lane so interactive traffic always
    preempts.  Receivers *bank* trickled chunks exactly like speculative
    prefetch: nothing touches the namespace until a real migration claims
    it, and a mid-trickle redefinition tombstones the stale entry (bytes
    charged to the engine's single waste ledger).

    At decision time the engine's :meth:`MigrationEngine.migrate` calls
    :meth:`peek_claim`: banked names whose content still digests the same
    are shipped as a manifest-only claim, and the residual delta is computed
    against (synced ∪ banked) — a converged trickle means the migration
    moves only the manifest plus the last cell's delta.

    Liveness pruning rides along: :func:`repro_torch.core.astdeps.live_names`
    over the remaining plan bounds both what trickles and what full-state
    moves carry; on dynamic constructs (``exec``, star-imports, …) it
    degrades to "everything live".
    """

    def __init__(self, runtime: "HybridRuntime", *, rate: float = 50e6,
                 burst_seconds: float = 1.0, top_k: int = 2,
                 liveness: bool = True):
        self.rt = runtime
        self.engine = runtime.engine
        self.reducer = runtime.engine.reducer
        self.rate = float(rate)
        self.burst = self.rate * float(burst_seconds)
        self.top_k = int(top_k)
        self.liveness = bool(liveness)
        # dst env -> {name -> banked entry}; per-dst epoch of the last trickle
        self.banked: dict[str, dict[str, _BankedName]] = {}
        self._epochs: dict[str, int] = {}
        self._budget = self.burst
        self._last_step: float | None = None
        # latest live set over the remaining plan (None = everything live)
        # plus the dirty-epoch watermark at which it was computed: names
        # (re)defined after the snapshot are never pruned — the set was
        # computed with those definitions still ahead, so they appear as
        # kills, not as live-outs
        self._live: set[str] | None = None
        self._live_epoch = 0
        self.live_conservative = False
        # ledger
        self.trickled_bytes = 0
        self.claimed_bytes = 0
        self.claimed_names = 0
        self.cancelled_names = 0
        self.rounds = 0
        runtime.replicator = self
        runtime.engine.replicator = self
        runtime.analyzer.replication_view = self

    # -- liveness --------------------------------------------------------
    def update_liveness(self, remaining_sources) -> None:
        """Recompute the live set from the remaining cells' sources."""
        from repro_torch.core.astdeps import live_names
        if not self.liveness:
            self._live = None
            return
        src = self.rt.envs[self.rt.current_env]
        self._live = live_names(list(remaining_sources), src.state.ns)
        self._live_epoch = src.state.epoch
        self.live_conservative = self._live is None

    def _is_live(self, name: str, state: ExecutionState) -> bool:
        if self._live is None:
            return True
        return (name in self._live
                or state.dirty.get(name, 0) > self._live_epoch)

    def prune_dead(self, names: set[str],
                   state: ExecutionState) -> set[str]:
        """Drop provably-dead names from a full-state move (conservative:
        with no live set — liveness off or dynamic code — nothing drops;
        names dirtied since the live snapshot always survive)."""
        if not self.liveness or self._live is None:
            return names
        return {n for n in names if self._is_live(n, state)}

    # -- analyzer view ---------------------------------------------------
    def banked_bytes(self, dst: str) -> int:
        return sum(e.nbytes for e in self.banked.get(dst, {}).values())

    def residual_bytes(self, nbytes: float, src: str, dst: str) -> float:
        """Cost-model discount: bytes already banked at ``dst`` won't
        travel again, so placement prices only the residual."""
        return max(0.0, nbytes - self.banked_bytes(dst))

    # -- trickling -------------------------------------------------------
    def step(self, now: float, remaining_sources=None,
             budget_bytes: float | None = None) -> int:
        """One think-time wakeup: refresh liveness, pick targets, trickle
        dirty deltas within the byte budget.  Returns bytes trickled.

        Without an explicit ``budget_bytes`` the budget accrues at ``rate``
        bytes per second of elapsed time (capped at one burst)."""
        self.rounds += 1
        rt = self.rt
        src = rt.envs[rt.current_env]
        if getattr(src, "peer", None) is not None:
            return 0       # a remote namespace cannot be snapshotted here
        if budget_bytes is None:
            if self._last_step is not None:
                self._budget = min(
                    self.burst,
                    self._budget + (now - self._last_step) * self.rate)
            self._last_step = now
            budget = self._budget
        else:
            budget = float(budget_bytes)
        if budget <= 0:
            return 0
        if remaining_sources is not None:
            self.update_liveness(remaining_sources)
        total = 0
        for dst_name in self._select_targets():
            total += self._trickle_to(src, rt.envs[dst_name], budget - total)
            if total >= budget:
                break
        if budget_bytes is None:
            self._budget = max(0.0, self._budget - total)
        return total

    def _select_targets(self) -> list[str]:
        """Top-k likely destination envs: the interaction model's next-cell
        distribution, each candidate cell priced through the analyzer's
        peeked decision (mirrors ``_maybe_prefetch``'s selection rule)."""
        rt = self.rt
        pred = rt._last_pred
        dist = pred["dist"] if pred else {}
        if rt.block_plan:
            # inside a committed block the session stays on the block env,
            # but the block's exit ships everything home — trickling home
            # during in-block think gaps pre-replicates that return trip
            if rt.current_env != rt.home:
                return [rt.home]
            candidates = [(o, None) for o in rt.block_plan[:self.top_k]]
        elif dist:
            candidates = top_candidates(dist, self.top_k)
        elif pred is not None:
            candidates = [(pred["order"] + 1, None)]
        else:
            return []
        taken: list[str] = []
        for nxt, _prob in candidates:
            if not 0 <= nxt < len(rt.nb.cells):
                continue
            cell = rt.nb.cells[nxt]
            d = rt.analyzer.decide(rt.nb, cell, current_env=rt.current_env,
                                   peek=True)
            target = d.env
            if rt.block_plan and rt.block_env is not None:
                target = (rt.block_env if nxt in rt.block_plan else rt.home)
            if target == rt.current_env or target in taken:
                continue
            env = rt.envs.get(target)
            if env is None or env.kind != "compute":
                continue
            taken.append(target)
            if len(taken) >= self.top_k:
                break
        return taken

    def _trickle_to(self, src, dst, budget: float) -> int:
        """Trickle the dirty delta from ``src``'s namespace to ``dst``'s
        bank, clamped to ``budget`` wire bytes (always at least one name so
        a large object still makes progress across wakeups)."""
        import types as _types
        if budget <= 0:
            return 0
        state = src.state
        bank = self.banked.setdefault(dst.name, {})
        known = self.engine.synced.get(dst.name, {})
        eff_known = {**known, **{n: e.digest for n, e in bank.items()}}
        last_epoch = self._epochs.get(dst.name, -1)
        names = {n for n in state.names()
                 if not isinstance(state.get(n), _types.ModuleType)
                 and self._is_live(n, state)}
        # dirty-since prefilter: one dict probe per name instead of a
        # digest launch over the whole namespace
        cand = {n for n in names
                if n not in eff_known or state.dirty.get(n, 0) > last_epoch}
        if not cand:
            self._epochs[dst.name] = state.epoch
            return 0
        send, _dead, here = self.reducer.delta_names(state, cand, eff_known)
        send &= cand
        if not send:
            self._epochs[dst.name] = state.epoch
            return 0
        ser = self.reducer.serialize_names(state, send, on_error="skip",
                                           digests=here)
        if not ser.blobs:
            self._epochs[dst.name] = state.epoch
            return 0
        dst_peer = getattr(dst, "peer", None)
        held = {d for d in ser.chunks if dst.chunk_store.has(d)}
        # budget clamp: take names (deterministic order) while their
        # incremental wire cost fits; each entry's cost is recorded so
        # tombstoning and claims account the same bytes
        take: list[str] = []
        costs: dict[str, int] = {}
        counted = set(held)
        running = 0
        for n in sorted(ser.blobs):
            blob = ser.blobs[n]
            cost = (len(blob.pickle_bytes)
                    + sum(len(a.get("scales", b"")) for a in blob.arrays))
            for d in blob.chunk_digests():
                cost += DIGEST_BYTES
                if d in counted or d not in ser.chunks:
                    continue
                counted.add(d)
                cost += len(ser.chunks[d]) - 1
            if take and running + cost > budget:
                break
            take.append(n)
            costs[n] = cost
            running += cost
        sub = SerializedState(codec=ser.codec,
                              blobs={n: ser.blobs[n] for n in take},
                              digests={n: ser.digests[n] for n in take})
        sub.chunks = {d: ser.chunks[d]
                      for b in sub.blobs.values() for d in b.chunk_digests()
                      if d in ser.chunks}
        if dst_peer is not None:
            # real frames on the low-priority lane; receiver banks them
            stats = dst_peer.send_state(sub, trickle=True, low_priority=True)
            wire_bytes = sub.wire_nbytes({d for d in sub.chunks
                                          if d in stats.held})
            dst.chunk_store.put_many(sub.chunks)    # mirror what was banked
        else:
            wire_bytes = sub.wire_nbytes(held)
            dst.chunk_store.put_many(sub.missing_chunks(held))
        src.chunk_store.put_many(sub.chunks)
        for n in take:
            old = bank.get(n)
            if old is not None:
                # superseded before any claim: the earlier bytes are waste
                self.engine.prefetch_wasted_bytes += old.nbytes
            bank[n] = _BankedName(blob=ser.blobs[n], digest=ser.digests[n],
                                  nbytes=costs[n])
        self.trickled_bytes += wire_bytes
        if len(take) == len(ser.blobs):
            # everything dirty went out: advance the epoch watermark
            self._epochs[dst.name] = state.epoch
        self.rt._emit(T.STATE_TRICKLED, None, target=dst.name,
                      names=tuple(take), nbytes=wire_bytes)
        return wire_bytes

    # -- invalidation ----------------------------------------------------
    def invalidate(self, names) -> int:
        """A cell (re)defined these names: banked copies are stale.  Pop
        them everywhere, charge their bytes to the single waste ledger, and
        CANCEL transport-bound receivers (banked chunks stay — immutable,
        content-addressed — only the stream/claim bookkeeping clears)."""
        dropped = 0
        for dst_name, bank in self.banked.items():
            stale = [n for n in names if n in bank]
            if not stale:
                continue
            waste = 0
            for n in stale:
                waste += bank.pop(n).nbytes
                self.cancelled_names += 1
            dropped += waste
            self.engine.prefetch_wasted_bytes += waste
            env = self.rt.envs.get(dst_name)
            peer = getattr(env, "peer", None) if env is not None else None
            if peer is not None:
                peer.cancel()
            self.rt._emit(T.STATE_TRICKLE_CANCELLED, None, target=dst_name,
                          names=tuple(sorted(stale)), wasted_bytes=waste)
        return dropped

    # -- claiming --------------------------------------------------------
    def peek_claim(self, src, dst, names: set[str],
                   known: dict[str, int]) -> SerializedState | None:
        """Banked names still content-identical to ``src``'s namespace,
        packaged as a manifest-only SerializedState (chunks are already at
        ``dst``).  Genuinely stale entries — in-place mutations the AST
        invalidation cannot see — are dropped (and charged as waste) here;
        the surviving claim is only *committed* (removed from the bank,
        counted) by :meth:`commit_claim` once the migration succeeds."""
        bank = self.banked.get(dst.name)
        if not bank:
            return None
        cand = {n: e for n, e in bank.items()
                if n in names and n in src.state.ns
                and known.get(n) != e.digest}
        if not cand:
            return None
        cur = self.reducer.digest_many({n: src.state.ns[n] for n in cand})
        valid = {n: e for n, e in cand.items() if cur.get(n) == e.digest}
        for n in list(cand):
            if n not in valid:
                e = bank.pop(n)
                self.engine.prefetch_wasted_bytes += e.nbytes
                self.cancelled_names += 1
        if not valid:
            return None
        return SerializedState(
            codec=self.reducer.codec,
            blobs={n: e.blob for n, e in valid.items()},
            digests={n: e.digest for n, e in valid.items()})

    def commit_claim(self, dst_name: str, sub: SerializedState) -> None:
        bank = self.banked.get(dst_name, {})
        nbytes = 0
        for n in sub.blobs:
            e = bank.pop(n, None)
            if e is not None:
                nbytes += e.nbytes
        self.claimed_names += len(sub.blobs)
        self.claimed_bytes += nbytes
        self.rt._emit(T.STATE_TRICKLE_CLAIMED, None, target=dst_name,
                      names=tuple(sorted(sub.blobs)), nbytes=nbytes)

    # -- lifecycle -------------------------------------------------------
    def forget(self, env_name: str) -> int:
        """``env_name`` died: its banked state is gone (and waste)."""
        bank = self.banked.pop(env_name, None)
        self._epochs.pop(env_name, None)
        if not bank:
            return 0
        waste = sum(e.nbytes for e in bank.values())
        self.cancelled_names += len(bank)
        self.engine.prefetch_wasted_bytes += waste
        return waste

    def dispose(self) -> int:
        """Session over: everything still banked was trickled for nothing."""
        waste = 0
        for dst_name in list(self.banked):
            waste += self.forget(dst_name)
        return waste


class HybridRuntime:
    """Wires sessions, telemetry, context, analyzer, engine together (Fig. 1).

    Environments come from an :class:`EnvironmentRegistry` (N environments,
    per-pair links); the legacy ``envs={"local": ..., "remote": ...}`` dict
    is adapted into a two-env registry.  ``registry.home`` plays the paper's
    "local" role: sessions start there and state returns there when a block
    completes or the plan deviates (Fig. 3).
    """

    def __init__(self, notebook: Notebook, *,
                 envs: dict[str, ExecutionEnvironment] | None = None,
                 registry: EnvironmentRegistry | None = None,
                 kb: KnowledgeBase | None = None,
                 reducer: StateReducer | None = None,
                 clock: SimClock | None = None,
                 policy: str = "block", use_knowledge: bool = True,
                 bandwidth: float = 1e9, latency: float = 0.5,
                 delta: bool = True, pipeline: bool = False,
                 engine: MigrationEngine | None = None,
                 arbiter=None,
                 model: InteractionModel | str | None = None,
                 horizon: int = 4, session_id: str | None = None,
                 objective: str = "seconds", slo: float | None = None):
        if registry is None:
            assert envs, "pass envs={...} or registry=EnvironmentRegistry(...)"
            registry = EnvironmentRegistry.from_envs(
                envs, bandwidth=bandwidth, latency=latency)
        assert registry.home is not None and registry.candidates(), \
            "registry needs a home env and at least one placement candidate"
        self.nb = notebook
        self.registry = registry
        self.envs = registry.envs()          # name -> env (back-compat view)
        self.home = registry.home
        self.clock = clock or SimClock()
        self.bus = T.MQBus()
        self.kb = kb or KnowledgeBase()
        self.context = ContextDetector(model)
        self.context.attach(self.bus)
        self.reducer = reducer or StateReducer()
        if engine is not None:
            self.engine = engine
            if self.engine.registry is None:
                self.engine.registry = registry
        else:
            engine_cls = PipelinedMigrationEngine if pipeline else MigrationEngine
            self.engine = engine_cls(self.reducer, bandwidth=bandwidth,
                                     latency=latency, delta=delta,
                                     registry=registry)
        self.analyzer = MigrationAnalyzer(
            self.kb, self.context, PerfModel(), policy=policy,
            use_knowledge=use_knowledge, migration_latency=latency,
            migration_bandwidth=bandwidth, registry=registry,
            horizon=horizon, objective=objective, slo=slo)
        self.current_env = self.home
        self.block_plan: list[int] = []
        self.block_env: str | None = None
        # deterministic ids opt-in (seeded fleet runs must reproduce their
        # ScheduleReport bit-for-bit; uuid4 would break that)
        self.session_id = session_id or T.new_session_id()
        self.migrations = 0
        self.queue_wait = 0.0
        # cost plane: modeled execution seconds billed per env (the dollar
        # meter's input) + per-cell request→completion latency (the SLO
        # attainment meter's input).  Both are pure bookkeeping — no
        # decision reads them.
        self.exec_env_seconds: dict[str, float] = {}
        self.cell_latencies: list[float] = []
        self.arbiter = arbiter               # shared capacity (SessionScheduler)
        # fleet failure injection: fault_check(env, start, end) -> failure
        # instant inside [start, end) or None.  When set, executions and
        # migrations become *interruptible*: the clock stops at the failure
        # instant and EnvFailure propagates to the fleet scheduler.
        self.fault_check = None
        # prediction scoring: last emitted next-cell distribution + the
        # speculative prefetches issued on it, scored when the next cell
        # actually runs (KB provenance + confidence-gate calibration)
        self.prediction_hits = 0
        self.prediction_total = 0
        self._last_pred: dict | None = None
        self.last_decision: Decision | None = None
        # background delta replicator (attach_replicator); None = off and
        # every decision/byte path is bit-identical to the unreplicated run
        self.replicator: DeltaReplicator | None = None
        # replica plane (attach_replicas); None = off — K=0 keeps every
        # decision and byte bit-identical to the unreplicated runtime
        self.replicas = None
        self._closed = False
        self._emit(T.SESSION_STARTED, None)

    # ------------------------------------------------------------------
    def _emit(self, type_: str, cell_id: str | None, **payload) -> None:
        self.bus.publish("telemetry", T.TelemetryMessage(
            datetime=self.clock.now(), type=type_, cell_id=cell_id,
            notebook=self.nb.name, cell_ids=self.nb.cell_ids(),
            session=self.session_id, path=self.nb.path, payload=payload))

    def attach_replicator(self, *, rate: float = 50e6, top_k: int = 2,
                          liveness: bool = True,
                          burst_seconds: float = 1.0) -> DeltaReplicator:
        """Turn on background delta replication: think-time wakeups trickle
        dirty state to the top-k likely targets so decision-time migrations
        ship only the residual (claimed bytes are manifest-only)."""
        return DeltaReplicator(self, rate=rate, top_k=top_k,
                               liveness=liveness,
                               burst_seconds=burst_seconds)

    def attach_replicas(self, followers, *, race: bool = False,
                        race_band: float = 0.25,
                        race_threshold: float = 0.35,
                        rate: float = 50e6, burst_seconds: float = 1.0):
        """Turn on the replica plane: keep ``followers`` converged with the
        primary during think time (zero-replay promotion on failure) and —
        with ``race=True`` — race confident cells on two candidate envs,
        committing the first result."""
        from repro_torch.core.replica import SessionReplicaSet
        return SessionReplicaSet(self, followers, race=race,
                                 race_band=race_band,
                                 race_threshold=race_threshold,
                                 rate=rate, burst_seconds=burst_seconds)

    def probe(self, source: str, env_name: str) -> float:
        """Background probe for Algorithm 2 (no telemetry, no migration)."""
        env = self.envs[env_name]
        probe_ns = ExecutionEnvironment(f"probe-{env_name}", speedup=env.speedup,
                                        globals_seed=dict(env.state.ns))
        return probe_ns.execute(source)

    # ------------------------------------------------------------------
    def _do_migration(self, src: str, dst: str, cell_source: str | None) -> float:
        # return trips (no cell source) skip unserializable objects in place
        start = self.clock.now()
        res = self.engine.migrate(self.envs[src], self.envs[dst], cell_source,
                                  strict=cell_source is not None,
                                  now=start)
        if res.noop:          # empty delta: free, and not a migration at all
            return 0.0
        if self.fault_check is not None:
            tf = self.fault_check(dst, start, start + res.seconds)
            if tf is not None:
                # the transfer dies with its destination: charge the partial
                # stream, forget the receiver's content view (what landed
                # there is gone) and hand recovery to the fleet scheduler
                self.clock.advance(max(0.0, tf - start))
                self.engine.synced.pop(dst, None)
                self._emit(T.ENV_FAILED, None, env=dst, at=tf,
                           during="migration", wasted=tf - start)
                raise EnvFailure(dst, tf, during="migration",
                                 wasted=tf - start)
        self.clock.advance(res.seconds)
        self.migrations += 1
        self.analyzer.observe_state_size(self.nb.name, max(res.nbytes, 1))
        self.kb.record(ProvRecord(
            "migration", None, dst, self.clock.now() - res.seconds,
            self.clock.now(), params={"bytes": res.nbytes, "src": src},
            used=res.names))
        return res.seconds

    def _maybe_prefetch(self, order: int) -> None:
        """Pipelined engines push the predicted next hop's state while the
        current cell executes (transfer overlaps execution on the sim clock).

        Inside a committed block the next planned cell is a *planned*
        transfer (bypasses the gate).  Otherwise the interaction model's
        next-cell distribution drives *speculation*: the top-k candidates
        are prefetched, each admitted only if its probability mass clears
        the engine's confidence gate."""
        if not isinstance(self.engine, PipelinedMigrationEngine):
            return
        dist = self._last_pred["dist"] if self._last_pred else {}
        if self.block_plan:
            upcoming = [o for o in self.block_plan if o > order]
            nxt = upcoming[0] if upcoming else order + 1
            candidates: list[tuple[int, float | None]] = [(nxt, None)]
        elif dist:
            candidates = top_candidates(dist, self.engine.prefetch_top_k)
        else:
            # no evidence yet: the paper's unconditional next-cell walk
            candidates = [(order + 1, None)]
        issued: list[tuple[int, str, float | None]] = []
        taken = {self.current_env}
        gate = self.engine.gate
        for nxt, prob in candidates:
            if not 0 <= nxt < len(self.nb.cells):
                continue
            if prob is not None and gate is not None and not gate.allow(prob):
                # pre-gate: don't pay a full peeked placement decision for a
                # speculation the engine would reject anyway
                self.engine.prefetch_gated += 1
                gate.rejected()
                continue
            cell = self.nb.cells[nxt]
            d = self.analyzer.decide(self.nb, cell,
                                     current_env=self.current_env, peek=True)
            target = d.env
            if self.block_plan and self.block_env is not None:
                target = (self.block_env if nxt in self.block_plan
                          else self.home)
            if target in taken:
                continue
            p = self.engine.begin_prefetch(
                self.envs[self.current_env], self.envs[target], cell.source,
                now=self.clock.now(), prob=prob, predicted_order=nxt)
            if p is not None:
                taken.add(target)
                issued.append((nxt, target, prob))
                self._emit(T.STATE_PREFETCHED, cell.cell_id, target=target,
                           nbytes=p.nbytes, ready_at=p.ready_at,
                           predicted=nxt,
                           prob=prob if prob is not None else 1.0)
        if self._last_pred is not None:
            self._last_pred["issued"] = issued

    def _note_prediction(self, order: int) -> None:
        """Snapshot the model's next-cell distribution for the cell about to
        run (before its completion lands in the history) so the realized
        next cell can score it — every cell, pipelined or not."""
        self._last_pred = {
            "notebook": self.nb.name, "order": order,
            "dist": self.context.distribution(self.nb.name, order),
            "issued": []}

    def _score_prediction(self, cell: Cell, realized: int) -> None:
        """Score the previous cell's prediction against the cell that
        actually ran: KB provenance keeps (predicted distribution, realized)
        and every *issued* speculation's outcome calibrates the gate."""
        pred = self._last_pred
        self._last_pred = None
        if pred is None or pred["notebook"] != self.nb.name:
            return
        dist = pred["dist"]
        if dist:
            self.prediction_total += 1
            top = max(dist.items(), key=lambda kv: (kv[1], -kv[0]))[0]
            self.prediction_hits += int(top == realized)
            self.kb.record_prediction(cell.cell_id, self.nb.name, dist,
                                      realized, when=self.clock.now())
        if isinstance(self.engine, PipelinedMigrationEngine) \
                and self.engine.gate is not None:
            for nxt, _target, prob in pred["issued"]:
                if prob is not None:     # planned transfers don't calibrate
                    self.engine.gate.observe(nxt == realized)

    @property
    def prediction_hit_rate(self) -> float:
        if self.prediction_total == 0:
            return 0.0
        return self.prediction_hits / self.prediction_total

    def run_cell(self, ref, *, force_env: str | None = None) -> float:
        """Execute one cell under the policies; returns modeled duration."""
        cell = self.nb.cell(ref)
        order = self.nb.order(cell.cell_id)
        t_request = self.clock.now()
        self._emit(T.CELL_EXECUTION_REQUESTED, cell.cell_id, order=order)
        # the probability the interaction model gave THIS cell — the race
        # gate's admission signal — must be captured before scoring pops it
        pred = self._last_pred
        cell_prob = (pred["dist"].get(order)
                     if pred is not None and pred["notebook"] == self.nb.name
                     else None)
        self._score_prediction(cell, order)

        if force_env is not None:
            decision = Decision(force_env, force_env != self.current_env,
                                f"forced to {force_env}")
        elif self.block_plan and order in self.block_plan:
            decision = Decision(self.block_env or self.current_env, False,
                                "inside predicted block")
        elif self.block_plan and order not in self.block_plan:
            # deviation from predicted block: return home (Fig. 3)
            decision = Decision(self.home, False,
                                "deviated from predicted block")
            self.block_plan = []
            self.block_env = None
        else:
            decision = self.analyzer.decide(self.nb, cell,
                                            current_env=self.current_env)
        # exposed so the scheduler's forecast telemetry can reuse the
        # decision instead of re-running the policy chain per cell
        self.last_decision = decision

        target = decision.env
        # first-result-wins racing: with a replica set attached and the
        # confidence gate firing, launch the cell on the two cheapest
        # candidates; the modeled first RESULT (min expected cost) is where
        # the cell commits, and the loser is cancelled at commit time
        race = None
        if self.replicas is not None and force_env is None:
            race = self.replicas.plan_race(cell, order, decision,
                                           prob=cell_prob)
            if race is not None:
                target = race.winner
        # speculations that bet on a different destination are now stale:
        # cancel them before the migration below claims its own
        if isinstance(self.engine, PipelinedMigrationEngine):
            for dst, wasted, pred_order in self.engine.cancel_stale(
                    {target}, now=self.clock.now()):
                self._emit(T.STATE_PREFETCH_CANCELLED, cell.cell_id,
                           target=dst, wasted_bytes=wasted,
                           predicted=pred_order)
        if target != self.current_env:
            # committing to a block moves state once for the WHOLE block
            # (Fig. 3): later in-block cells run without migrating, so their
            # inputs must travel now, not just the current cell's
            move_source = cell.source
            if decision.block:
                move_source = "\n".join(
                    self.nb.cells[o].source for o in decision.block
                    if order <= o < len(self.nb.cells)) or cell.source
            try:
                self._do_migration(self.current_env, target, move_source)
                if decision.block:
                    self.block_plan = [o for o in decision.block if o >= order]
                    self.block_env = target
                self.current_env = target
            except SerializationFailure as e:
                cell.annotate(f"serialization failure -> {self.home}: {e}")
                target = self.home

        env = self.envs[self.current_env]
        # cold-start gate: a provisioning env accepts state (migration can
        # stream while it boots) but cannot execute before it is ready —
        # the wait is queue time, exactly what placement priced in
        ready_at = getattr(env, "ready_at", 0.0)
        if getattr(env, "status", "up") == "provisioning" \
                and ready_at > self.clock.now():
            wait = ready_at - self.clock.now()
            self.clock.advance(wait)
            self.queue_wait += wait
            self._emit(T.CELL_EXECUTION_QUEUED, cell.cell_id, order=order,
                       env=self.current_env, wait=wait, cold_start=True)
        # shared-capacity gate: queue when the target env is saturated
        if self.arbiter is not None:
            now = self.clock.now()
            est = (cell.cost / env.speedup) if cell.cost is not None else 0.0
            slot_start = self.arbiter.acquire(self.current_env, now, est)
            wait = slot_start - now
            if wait > 0:
                self.clock.advance(wait)
                self.queue_wait += wait
                self._emit(T.CELL_EXECUTION_QUEUED, cell.cell_id, order=order,
                           env=self.current_env, wait=wait)
        self._emit(T.CELL_EXECUTION_STARTED, cell.cell_id, order=order,
                   env=self.current_env)
        self._note_prediction(order)
        self._maybe_prefetch(order)
        exec_start = self.clock.now()
        duration = env.execute(cell.source, cell.cost)
        if self.fault_check is not None:
            tf = self.fault_check(self.current_env, exec_start,
                                  exec_start + duration)
            if tf is not None:
                # mid-cell env failure: the cell did NOT complete — charge
                # only the work up to the failure instant, free the slot,
                # and let the fleet scheduler drive recovery
                self.clock.advance(max(0.0, tf - exec_start))
                self.exec_env_seconds[self.current_env] = (
                    self.exec_env_seconds.get(self.current_env, 0.0)
                    + max(0.0, tf - exec_start))   # partial work still bills
                if self.arbiter is not None:
                    self.arbiter.release(self.current_env, exec_start, tf)
                self._emit(T.ENV_FAILED, cell.cell_id, env=self.current_env,
                           at=tf, during="execute", order=order,
                           wasted=tf - exec_start)
                raise EnvFailure(self.current_env, tf, order,
                                 wasted=tf - exec_start)
        self.clock.advance(duration)
        self.exec_env_seconds[self.current_env] = (
            self.exec_env_seconds.get(self.current_env, 0.0) + duration)
        if self.arbiter is not None:
            self.arbiter.release(self.current_env, exec_start, self.clock.now())
        base = cell.cost if cell.cost is not None else duration * env.speedup
        for name, e in self.registry.compute_envs().items():
            self.analyzer.perf.observe(cell.cell_id, name, base / e.speedup)
        # per-cell latency the user saw: request (incl. migration + queue +
        # cold-start waits) to result — what the SLO is stated against
        self.cell_latencies.append(self.clock.now() - t_request)
        self._emit(T.CELL_EXECUTION_COMPLETED, cell.cell_id, order=order,
                   env=self.current_env, duration=duration)

        # names this cell (re)defined are now stale on every peer
        from repro_torch.core.astdeps import analyze_cell
        stores = analyze_cell(cell.source).stores
        self.engine.invalidate(self.current_env, stores)
        # dirty-epoch ledger feeds the replicator's dirty-since prefilter;
        # banked trickles of redefined names are tombstoned right here
        env.state.mark_dirty(stores)
        if self.replicator is not None:
            self.replicator.invalidate(stores)
        if self.replicas is not None:
            # the cell committed: followers are one cell behind until the
            # next think-time sync; a raced cell settles (loser CANCELLED,
            # waste charged) the moment its first RESULT lands
            self.replicas.note_cell(order)
            if race is not None:
                self.replicas.settle_race(race, duration=duration,
                                          now=self.clock.now())

        # block bookkeeping: leave the block env when it completes (Fig. 3)
        if self.block_plan:
            self.block_plan = [o for o in self.block_plan if o != order]
            if not self.block_plan:
                self.block_env = None
                if self.current_env != self.home:
                    self._do_migration(self.current_env, self.home, None)
                    self.current_env = self.home
        elif self.current_env != self.home and not decision.block:
            # single-cell strategy: immediately switch state back
            self._do_migration(self.current_env, self.home, None)
            self.current_env = self.home

        return duration

    def recover_from_failure(self, failed_env: str) -> None:
        """Reset session placement state after ``failed_env`` died: the
        session falls back to home, any committed block is abandoned, the
        engine forgets what the dead env held (its namespace is gone), and
        in-flight speculations targeting it are cancelled.  State *content*
        recovery (checkpoint restore or rerun) is the fleet scheduler's
        job — this only makes the runtime consistent again."""
        self.block_plan = []
        self.block_env = None
        if self.current_env == failed_env:
            self.current_env = self.home
        self.engine.synced.pop(failed_env, None)
        if self.replicator is not None:
            self.replicator.forget(failed_env)
        if self.replicas is not None:
            # a race interrupted by the failure is aborted WITHOUT touching
            # the loser's namespace: if that loser is the follower about to
            # be promoted, its converged state must survive the cancel
            self.replicas.abort_race(reason=f"{failed_env} failed")
            self.replicas.forget(failed_env)
        if isinstance(self.engine, PipelinedMigrationEngine):
            wasted = self.engine.cancel_prefetch(failed_env, self.clock.now())
            if wasted:
                self._emit(T.STATE_PREFETCH_CANCELLED, None, target=failed_env,
                           wasted_bytes=wasted, predicted=None)
        self._emit(T.SESSION_RECOVERED, None, failed_env=failed_env,
                   env=self.current_env)

    def reset_for_replay(self) -> None:
        """Rerun-from-home recovery: replaying the plan must not see the
        previous attempt's state, so every compute env gets a fresh
        namespace and the engine forgets all content views.  Chunk stores
        are untouched — content-addressed chunks are immutable, so the
        replay's migrations re-ship manifests, not bytes."""
        if isinstance(self.engine, PipelinedMigrationEngine):
            self.engine.cancel_stale(set(), now=self.clock.now())
        for env in self.envs.values():
            if env.kind == "compute":
                env.state = ExecutionState({})
        self.engine.synced.clear()

    def close(self) -> None:
        """Dispose the session: cancel in-flight speculations (their bytes
        are waste — nothing will ever claim them), emit the Table-I disposal
        message, and detach the context detector's bus subscription
        (idempotent — subscribers must not leak across sessions)."""
        if self._closed:
            return
        self._closed = True
        if self.replicator is not None:
            # unclaimed banked trickles are waste, same as dead speculation
            self.replicator.dispose()
        if isinstance(self.engine, PipelinedMigrationEngine):
            for dst, wasted, pred_order in self.engine.cancel_stale(
                    set(), now=self.clock.now()):
                self._emit(T.STATE_PREFETCH_CANCELLED, None, target=dst,
                           wasted_bytes=wasted, predicted=pred_order)
        self._emit(T.SESSION_DISPOSED, None)
        self.context.detach()
