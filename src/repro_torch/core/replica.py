"""Replica plane: converged follower namespaces, zero-replay failover, and
first-result-wins cell racing.

Checkpoint recovery (PR 6) pays detect + restore + replay; the NotebookOS
observation (PAPERS.md) is that a session replicated across environments
turns failure into an instant *promotion*.  :class:`SessionReplicaSet`
keeps K follower namespaces converged by shipping each committed cell's
delta — new chunks plus tombstones — to the followers during think time,
riding the same reducer/CAS machinery the :class:`DeltaReplicator` trickles
with, but *applying* the delta at the follower instead of banking it.  A
per-follower **convergence watermark** (the commit sequence number of the
last cell whose effects are fully applied there) is tracked in telemetry;
on heartbeat-detected primary failure the scheduler promotes the
most-converged follower, applies only the residual banked trickle, and
resumes the plan with ``commit_seq - watermark`` cells to replay — zero
when the follower had converged.

Replication and trickling share bytes both ways (the dedupe satellite):

* a delta the replica set *applied* lands in ``engine.synced[follower]``,
  so the DeltaReplicator's effective-known view skips those names — they
  never trickle again;
* a delta the replicator already *banked* at a follower is claimed via
  :meth:`DeltaReplicator.peek_claim` — manifest-only, the chunks are
  already in the follower's store — instead of re-serializing.

On top of converged followers sits **first-result-wins racing**: when the
interaction model's confidence gate fires for the cell about to run and two
candidate envs disagree on expected total cost within a configurable band,
the cell launches on both (the loser leg via the transport's RACE frame
when it is socket-bound), the first RESULT commits, the loser is CANCELLED
— its namespace untouched, so the committed result is bit-identical to a
solo run — and the loser's wasted work is charged to the engine's single
speculation-waste ledger.

With ``replicas=0`` (the default — no :class:`SessionReplicaSet` attached)
none of these hooks exist and every decision and byte is bit-identical to
the unreplicated runtime.
"""
from __future__ import annotations

import types as _types
from dataclasses import dataclass, field

from repro_torch.core import telemetry as T
from repro_torch.core.analyzer import Decision, _modeled_exec_seconds
from repro_torch.core.interaction import ConfidenceGate
from repro_torch.core.reducer import DIGEST_BYTES, SerializedState

__all__ = ["SessionReplicaSet", "RaceTicket"]


@dataclass
class RaceTicket:
    """One in-flight first-result-wins race."""
    race_id: str
    order: int
    winner: str                  # env the cell commits on (modeled min cost)
    loser: str                   # env whose leg is cancelled
    winner_est: float
    loser_est: float
    started_at: float
    policy_env: str = ""         # what the policy alone would have picked
    leg_bytes: int = 0           # wire bytes the loser leg cost to launch
    settled: bool = field(default=False)


class SessionReplicaSet:
    """Keep K follower namespaces converged with the primary (tentpole).

    ``followers`` are compute-env names in the runtime's registry.  The
    primary is wherever the session currently runs (``rt.current_env``);
    a follower the session migrates onto is trivially converged and sync
    skips it.  :meth:`sync` runs during think time (the fleet scheduler's
    replica proc, mirroring the trickle proc); :meth:`note_cell` advances
    the commit sequence after every committed cell; :meth:`promote` is the
    failover path.
    """

    def __init__(self, runtime, followers, *, race: bool = False,
                 race_band: float = 0.25, race_threshold: float = 0.35,
                 rate: float = 50e6, burst_seconds: float = 1.0):
        self.rt = runtime
        self.engine = runtime.engine
        self.reducer = runtime.engine.reducer
        seen: list[str] = []
        for f in followers:
            env = runtime.envs.get(f)
            assert env is not None, f"unknown follower env {f!r}"
            assert env.kind == "compute", f"follower {f!r} must be compute"
            if f not in seen:
                seen.append(f)
        self.followers: tuple[str, ...] = tuple(seen)
        self.race_enabled = bool(race)
        self.race_band = float(race_band)
        self.race_gate = ConfidenceGate(threshold=float(race_threshold))
        self.rate = float(rate)
        self.burst = self.rate * float(burst_seconds)
        self._budget = self.burst
        self._last_sync: float | None = None
        # convergence bookkeeping: one commit sequence for the session,
        # a watermark per follower (commit seq it has fully converged to),
        # and the dirty-epoch of the primary namespace at that watermark
        # (the dirty-since prefilter, same trick as the trickle ledger)
        self.commit_seq = 0
        self.watermark: dict[str, int] = {f: 0 for f in self.followers}
        self._epochs: dict[str, int] = {}
        # ledger
        self.replicated_bytes = 0
        self.shared_bytes = 0        # claimed from the trickle bank (dedupe)
        self.promotions = 0
        self.races = 0
        self.race_wins: dict[str, int] = {}
        self.race_waste_seconds = 0.0
        self.race_leg_bytes = 0      # wire bytes the losing legs cost
        self._active_race: RaceTicket | None = None
        self._race_seq = 0
        runtime.replicas = self

    # -- convergence -----------------------------------------------------
    def lag(self, follower: str | None = None) -> int:
        """Cells a follower is behind the primary (max over followers when
        none is named); the promotion path replays exactly this many."""
        if follower is not None:
            return max(0, self.commit_seq - self.watermark.get(follower, 0))
        if not self.watermark:
            return 0
        return max(self.lag(f) for f in self.watermark)

    def note_cell(self, order: int) -> None:
        """A cell committed on the primary: every follower not hosting the
        primary is now one cell behind until the next sync converges it."""
        self.commit_seq += 1
        cur = self.rt.current_env
        for f in self.watermark:
            if f == cur:
                self.watermark[f] = self.commit_seq

    # -- think-time sync -------------------------------------------------
    def sync(self, now: float, budget_bytes: float | None = None) -> int:
        """One think-time wakeup: ship each follower the primary's delta and
        *apply* it (namespace + tombstones), advancing the watermark when a
        follower fully converges.  Returns wire bytes shipped.  Without an
        explicit budget, bytes accrue at ``rate`` per second (one burst cap)
        — mirroring the trickle's pacing so replication never outruns the
        low-priority lane it shares."""
        rt = self.rt
        src = rt.envs[rt.current_env]
        if getattr(src, "peer", None) is not None:
            return 0        # a remote primary cannot be snapshotted here
        if budget_bytes is None:
            if self._last_sync is not None:
                self._budget = min(
                    self.burst,
                    self._budget + (now - self._last_sync) * self.rate)
            self._last_sync = now
            budget = self._budget
        else:
            budget = float(budget_bytes)
        if budget <= 0:
            return 0
        total = 0
        for f in self.followers:
            if f == rt.current_env:
                continue        # hosting the primary: trivially converged
            env = rt.envs.get(f)
            if env is None or not env.placeable_now():
                continue
            total += self._sync_to(src, env, budget - total)
            if total >= budget:
                break
        if budget_bytes is None:
            self._budget = max(0.0, self._budget - total)
        return total

    def _sync_to(self, src, dst, budget: float) -> int:
        """Converge one follower: claim whatever the trickle already banked
        there (manifest-only — the shared-bytes half of the dedupe), then
        serialize and apply the residual delta, then drop tombstones."""
        if budget <= 0:
            return 0
        state = src.state
        known = self.engine.synced.setdefault(dst.name, {})
        # tombstones first: names the follower's view holds that the
        # primary no longer does converge even mid-stream
        dead = sorted(n for n in known if n not in state.ns)
        if dead:
            dst.state.drop(dead)
            for n in dead:
                known.pop(n, None)
        # claim the trickle bank (dedupe): content re-validated by digest,
        # chunks already at the follower, only the manifest applies
        rep = self.rt.replicator
        names = {n for n in state.names()
                 if not isinstance(state.get(n), _types.ModuleType)}
        claimed: tuple[str, ...] = ()
        if rep is not None:
            claim = rep.peek_claim(src, dst, names, known)
            if claim is not None:
                objs = self.reducer.deserialize(
                    claim, target_ns=dst.state.ns,
                    chunk_store=dst.chunk_store)
                dst.state.update(objs)
                known.update(claim.digests)
                rep.commit_claim(dst.name, claim)
                held = {d for b in claim.blobs.values()
                        for d in b.chunk_digests()}
                self.shared_bytes += claim.wire_nbytes(held)
                claimed = tuple(sorted(claim.blobs))
        # residual delta, dirty-since prefiltered like the trickle
        last_epoch = self._epochs.get(dst.name, -1)
        cand = {n for n in names
                if n not in known or state.dirty.get(n, 0) > last_epoch}
        applied: list[str] = []
        wire_bytes = 0
        converged = True
        if cand:
            send, _dead, here = self.reducer.delta_names(state, cand, known)
            send &= cand
            if send:
                ser = self.reducer.serialize_names(
                    state, send, on_error="skip", digests=here)
                if ser.blobs:
                    wire_bytes, applied, converged = self._apply(
                        src, dst, ser, budget)
        if converged:
            self._epochs[dst.name] = state.epoch
            old = self.watermark.get(dst.name, 0)
            self.watermark[dst.name] = self.commit_seq
            advanced = self.watermark[dst.name] != old
        else:
            advanced = False
        if applied or dead or claimed or advanced:
            self.rt._emit(T.STATE_REPLICATED, None, follower=dst.name,
                          names=tuple(applied), claimed=claimed,
                          deleted=tuple(dead), nbytes=wire_bytes,
                          watermark=self.watermark.get(dst.name, 0),
                          commit_seq=self.commit_seq)
        return wire_bytes

    def _apply(self, src, dst, ser, budget: float):
        """Ship and apply a serialized delta within ``budget`` wire bytes
        (always at least one name, so a large object still progresses).
        Returns (wire_bytes, applied_names, fully_converged)."""
        known = self.engine.synced.setdefault(dst.name, {})
        dst_peer = getattr(dst, "peer", None)
        held = {d for d in ser.chunks if dst.chunk_store.has(d)}
        take: list[str] = []
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
            running += cost
        sub = SerializedState(codec=ser.codec,
                              blobs={n: ser.blobs[n] for n in take},
                              digests={n: ser.digests[n] for n in take})
        sub.chunks = {d: ser.chunks[d]
                      for b in sub.blobs.values() for d in b.chunk_digests()
                      if d in ser.chunks}
        if dst_peer is not None:
            # real frames: a REPLICA header announces the convergence delta,
            # then a normal non-speculative state stream applies at the far
            # side (the receiver's END handler materializes it)
            dst_peer.replicate(self.rt.session_id, self.commit_seq, sub)
            wire_bytes = sub.wire_nbytes({d for d in sub.chunks
                                          if dst.chunk_store.has(d)})
            dst.chunk_store.put_many(sub.chunks)    # mirror the remote store
        else:
            wire_bytes = sub.wire_nbytes(held)
            dst.chunk_store.put_many(sub.missing_chunks(held))
            objs = self.reducer.deserialize(sub, target_ns=dst.state.ns,
                                            chunk_store=dst.chunk_store)
            dst.state.update(objs)
        src.chunk_store.put_many(sub.chunks)
        known.update(sub.digests)
        self.replicated_bytes += wire_bytes
        return wire_bytes, take, len(take) == len(ser.blobs)

    # -- promotion -------------------------------------------------------
    def pick_follower(self, exclude=()) -> str | None:
        """Most-converged live follower (deterministic name tie-break)."""
        live = [f for f in self.followers
                if f not in exclude and f in self.rt.envs
                and self.rt.envs[f].placeable_now()]
        if not live:
            return None
        return sorted(live,
                      key=lambda f: (-self.watermark.get(f, 0), f))[0]

    def promote(self, failed_env: str, now: float) -> tuple[str, int] | None:
        """Failover: promote the most-converged follower to primary.

        Applies only the *residual* banked trickle (manifest-only — the
        chunks already sit in the follower's store), hands the primary role
        over, and returns ``(follower, cells_to_replay)`` — zero when the
        follower had converged.  Returns None when no live follower is
        left (the caller falls back to checkpoint/rerun recovery)."""
        rt = self.rt
        follower = self.pick_follower(exclude=(failed_env,))
        if follower is None:
            return None
        env = rt.envs[follower]
        known = self.engine.synced.setdefault(follower, {})
        # residual banked delta: entries were digest-validated when banked
        # and tombstoned on every later redefinition, so what is left is
        # the freshest shipped content — the primary that could re-validate
        # them is gone, which is exactly why they were replicated ahead
        rep = rt.replicator
        residual: tuple[str, ...] = ()
        if rep is not None:
            bank = rep.banked.get(follower)
            if bank:
                sub = SerializedState(
                    codec=self.reducer.codec,
                    blobs={n: e.blob for n, e in bank.items()},
                    digests={n: e.digest for n, e in bank.items()})
                objs = self.reducer.deserialize(
                    sub, target_ns=env.state.ns, chunk_store=env.chunk_store)
                env.state.update(objs)
                known.update(sub.digests)
                rep.commit_claim(follower, sub)
                residual = tuple(sorted(sub.blobs))
        peer = getattr(env, "peer", None)
        epoch = self.watermark.get(follower, 0)
        if peer is not None:
            # handshake: the follower's own watermark is authoritative (a
            # stale promoter learns the real residual from the reply)
            epoch = min(epoch, peer.promote(rt.session_id, epoch))
        replay = max(0, self.commit_seq - epoch)
        rt.current_env = follower
        self.promotions += 1
        # the new primary no longer follows itself; its watermark rides
        # the commit sequence from here on (note_cell keeps it pinned)
        self.watermark[follower] = self.commit_seq - replay
        rt._emit(T.SESSION_PROMOTED, None, follower=follower,
                 failed_env=failed_env, watermark=epoch,
                 commit_seq=self.commit_seq, replay=replay,
                 residual=residual)
        return follower, replay

    def forget(self, env_name: str) -> None:
        """``env_name`` died: a dead follower cannot be promoted until it
        re-converges from scratch (its watermark and epoch ledger reset)."""
        if env_name in self.watermark:
            self.watermark[env_name] = 0
        self._epochs.pop(env_name, None)

    # -- first-result-wins racing ----------------------------------------
    def plan_race(self, cell, order: int, decision: Decision,
                  prob: float | None) -> RaceTicket | None:
        """Race admission: gate on the interaction model's confidence for
        the cell about to run, then race only when the two best candidate
        envs disagree on expected total cost within ``race_band``.  The
        modeled first RESULT — the env with minimum expected cost — is the
        winner; the runtime commits the cell there and the loser leg is
        cancelled at commit time."""
        if not self.race_enabled or self._active_race is not None:
            return None
        if len(decision.block) > 1:
            return None     # a committed multi-cell block pins placement
        if prob is None or not self.race_gate.allow(prob):
            if prob is not None:
                self.race_gate.rejected()
            return None
        rt = self.rt
        an = rt.analyzer
        nbytes = an.state_size_estimate.get(rt.nb.name, 0.0)

        def total_cost(env_name: str) -> float | None:
            t = _modeled_exec_seconds(an, cell, env_name)
            if t is None:
                return None
            return (t + an.pair_migration_time(nbytes, rt.current_env,
                                               env_name)
                    + an.env_overhead(env_name))

        # rivals: the policy's choice vs the converged followers (plus the
        # current env — racing in place against a follower is the common
        # shape); a lagging follower would commit a stale namespace
        cands = {decision.env, rt.current_env}
        for f in self.followers:
            if self.watermark.get(f, 0) == self.commit_seq:
                cands.add(f)
        priced = []
        for name in sorted(cands):
            env = rt.envs.get(name)
            if env is None or env.kind != "compute" \
                    or not env.placeable_now():
                continue
            c = total_cost(name)
            if c is not None:
                priced.append((c, name))
        if len(priced) < 2:
            return None
        priced.sort()
        (a_cost, a_env), (b_cost, b_env) = priced[0], priced[1]
        if b_cost - a_cost > self.race_band * max(a_cost, b_cost, 1e-12):
            return None     # clear winner: no point paying a second leg
        self._race_seq += 1
        ticket = RaceTicket(
            race_id=f"{rt.session_id}-race-{self._race_seq}",
            order=order, winner=a_env, loser=b_env,
            winner_est=a_cost, loser_est=b_cost,
            started_at=rt.clock.now(), policy_env=decision.env)
        self._active_race = ticket
        self.races += 1
        # the loser leg launches over the wire when it is transport-bound;
        # in-process legs are modeled only — the loser's namespace is never
        # mutated, which is what keeps the committed result bit-identical
        loser_env = rt.envs.get(b_env)
        peer = getattr(loser_env, "peer", None) if loser_env is not None \
            else None
        if peer is not None:
            ticket.leg_bytes = peer.race(ticket.race_id, cell.source)
        rt._emit(T.CELL_RACED, cell.cell_id, order=order,
                 race_id=ticket.race_id, winner=a_env, loser=b_env,
                 winner_est=a_cost, loser_est=b_cost, prob=prob)
        return ticket

    def settle_race(self, ticket: RaceTicket, *, duration: float,
                    now: float) -> None:
        """The winner's RESULT committed: CANCEL the loser and charge its
        wasted work — it ran for the winner's wall time (first-result-wins)
        or its own estimate, whichever is less — into the race ledger; any
        bytes the losing leg streamed go to the engine's single
        speculation-waste ledger, same as a dead prefetch."""
        if ticket.settled:
            return
        ticket.settled = True
        self._active_race = None
        rt = self.rt
        wasted = min(max(duration, 0.0), ticket.loser_est)
        self.race_waste_seconds += wasted
        self.race_wins[ticket.winner] = self.race_wins.get(
            ticket.winner, 0) + 1
        self.engine.prefetch_wasted_bytes += ticket.leg_bytes
        self.race_leg_bytes += ticket.leg_bytes
        self._cancel_leg(ticket)
        # calibration: an upset (the race committed somewhere the policy
        # alone would not have) justifies the second leg; a race the
        # policy's own pick won anyway was wasted breadth — tighten
        self.race_gate.observe(ticket.winner != ticket.policy_env)
        rt._emit(T.CELL_RACE_CANCELLED, None, race_id=ticket.race_id,
                 loser=ticket.loser, wasted_seconds=wasted,
                 committed=ticket.winner)

    def abort_race(self, *, reason: str = "failure") -> None:
        """The primary died mid-race: cancel the loser leg WITHOUT touching
        its namespace — if that loser is about to be promoted, its committed
        (converged) state must survive the cancel."""
        ticket = self._active_race
        if ticket is None:
            return
        ticket.settled = True
        self._active_race = None
        self._cancel_leg(ticket)
        self.rt._emit(T.CELL_RACE_CANCELLED, None, race_id=ticket.race_id,
                      loser=ticket.loser, wasted_seconds=0.0,
                      committed=None, reason=reason)

    def _cancel_leg(self, ticket: RaceTicket) -> None:
        env = self.rt.envs.get(ticket.loser)
        peer = getattr(env, "peer", None) if env is not None else None
        if peer is not None:
            peer.race_cancel(ticket.race_id)
