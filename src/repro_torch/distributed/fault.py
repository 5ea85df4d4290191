"""Fault tolerance and elasticity runtime (simulation harness + real logic).

At 1000+ nodes, failures are routine.  The control plane here is the same
one a real deployment runs — only the transport (heartbeats over a SimClock
instead of RPC) is simulated:

* ``Coordinator``: tracks worker heartbeats; a worker missing
  ``miss_threshold`` beats is declared dead -> training pauses, the cluster
  restores from the latest delta checkpoint, and (if spares exist) resumes
  at the original scale, else *elastically rescales* to the surviving mesh.
* Straggler mitigation: per-step worker durations feed a robust z-score;
  persistent stragglers are evicted exactly like failures (re-dispatched),
  transient ones are absorbed by the synchronous barrier.
* Elastic rescale is a state migration: params/opt state move through the
  MigrationEngine with a new target sharding (DESIGN.md §1 mapping).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.simclock import SimClock


@dataclass
class WorkerState:
    name: str
    last_beat: float = 0.0
    alive: bool = True
    step_times: list[float] = field(default_factory=list)


@dataclass
class FaultEvent:
    time: float
    kind: str       # failure | straggler | restart | rescale
    worker: str
    detail: str = ""


class Coordinator:
    def __init__(self, workers: list[str], clock: SimClock | None = None, *,
                 beat_interval: float = 1.0, miss_threshold: int = 3,
                 straggler_factor: float = 2.5, straggler_patience: int = 3):
        self.clock = clock or SimClock()
        self.workers = {w: WorkerState(w, self.clock.now()) for w in workers}
        self.beat_interval = beat_interval
        self.miss_threshold = miss_threshold
        self.straggler_factor = straggler_factor
        self.straggler_patience = straggler_patience
        self._strag_count: dict[str, int] = {w: 0 for w in workers}
        self.events: list[FaultEvent] = []

    @property
    def detection_delay(self) -> float:
        """Worst-case lag between a death and its detection: the miss
        window.  The fleet scheduler charges this to a recovering session
        (same protocol, session-level instead of training-step-level)."""
        return self.beat_interval * self.miss_threshold

    # ------------------------------------------------------------------
    def heartbeat(self, worker: str) -> None:
        ws = self.workers[worker]
        ws.last_beat = self.clock.now()

    def report_step(self, worker: str, seconds: float) -> None:
        self.workers[worker].step_times.append(seconds)

    # ------------------------------------------------------------------
    def check_failures(self) -> list[str]:
        """Workers whose heartbeat lapsed; marks them dead."""
        now = self.clock.now()
        dead = []
        for ws in self.workers.values():
            if ws.alive and now - ws.last_beat > self.beat_interval * self.miss_threshold:
                ws.alive = False
                dead.append(ws.name)
                self.events.append(FaultEvent(now, "failure", ws.name,
                                              f"missed {self.miss_threshold} beats"))
        return dead

    def check_stragglers(self) -> list[str]:
        """Robust z-score on the latest step durations; persistent offenders."""
        latest = {w: ws.step_times[-1] for w, ws in self.workers.items()
                  if ws.alive and ws.step_times}
        if len(latest) < 3:
            return []
        vals = np.array(list(latest.values()))
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-9
        out = []
        for w, t in latest.items():
            if (t - med) / (1.4826 * mad) > self.straggler_factor and t > med * 1.5:
                self._strag_count[w] += 1
                if self._strag_count[w] >= self.straggler_patience:
                    out.append(w)
                    self.events.append(FaultEvent(
                        self.clock.now(), "straggler", w,
                        f"{t:.2f}s vs median {med:.2f}s "
                        f"x{self.straggler_patience} steps"))
            else:
                self._strag_count[w] = 0
        return out

    def alive(self) -> list[str]:
        return [w for w, ws in self.workers.items() if ws.alive]

    def revive(self, worker: str) -> None:
        ws = self.workers[worker]
        ws.alive = True
        ws.last_beat = self.clock.now()
        self._strag_count[worker] = 0
        self.events.append(FaultEvent(self.clock.now(), "restart", worker))


class ElasticTrainer:
    """Drives a train loop with failure injection, checkpoint/restart and
    elastic rescale.  ``step_fn(step, world)`` does one synchronous step and
    returns per-worker durations; ``save_fn(step)``/``restore_fn()`` bind to
    a Checkpointer; ``rescale_fn(world)`` re-lowers the step for a new world
    size (a state migration + new shardings in the real runtime)."""

    def __init__(self, coord: Coordinator, *, step_fn, save_fn, restore_fn,
                 rescale_fn=None, checkpoint_every: int = 10, spares: int = 0):
        self.coord = coord
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.rescale_fn = rescale_fn
        self.checkpoint_every = checkpoint_every
        self.spares = spares
        self.restarts = 0
        self.rescales = 0

    def run(self, n_steps: int) -> dict:
        step = 0
        world = self.coord.alive()
        while step < n_steps:
            # step_fn returns per-worker durations; a worker missing from the
            # dict crashed mid-step (and therefore does not heartbeat)
            durations = self.step_fn(step, world)
            present = [w for w in world if w in durations]
            complete = len(present) == len(world)
            if complete:
                barrier = max([durations[w] for w in present], default=1.0)
            else:
                # a crashed member stalls the synchronous collective: the
                # survivors wait one beat interval, no training progress
                barrier = self.coord.beat_interval
            self.coord.clock.advance(barrier)
            for w in present:
                self.coord.heartbeat(w)        # survivors beat at the barrier
                if complete:
                    self.coord.report_step(w, durations[w])

            dead = self.coord.check_failures()
            stragglers = self.coord.check_stragglers() if complete else []
            for w in stragglers:
                self.coord.workers[w].alive = False  # evict & re-dispatch
            if dead or stragglers:
                step = self.restore_fn()
                self.restarts += 1
                if self.spares > 0:
                    for w in dead + stragglers:
                        self.spares -= 1
                        self.coord.revive(w)
                        if self.spares <= 0:
                            break
                new_world = self.coord.alive()
                if len(new_world) != len(world) and self.rescale_fn:
                    self.rescale_fn(new_world)
                    self.rescales += 1
                    self.coord.events.append(FaultEvent(
                        self.coord.clock.now(), "rescale", ",".join(new_world),
                        f"{len(world)} -> {len(new_world)} workers"))
                world = new_world
                continue

            if not complete:
                continue  # stalled barrier: no progress this round
            step += 1
            if step % self.checkpoint_every == 0:
                self.save_fn(step)
        return {"steps": n_steps, "restarts": self.restarts,
                "rescales": self.rescales, "events": self.coord.events,
                "wall": self.coord.clock.now()}
