"""Persistent multi-tenant gateway: warm-pool scheduling on the event loop.

:class:`~repro_torch.core.scheduler.SessionScheduler` is a batch loop — it
consumes a :class:`~repro_torch.core.scheduler.WorkloadTrace` and exits.  A
production gateway (Jupyter Enterprise Gateway, Noteburst) is a *service*:
sessions attach and detach at will, a warm pool of pre-provisioned workers
absorbs cold starts, and per-tenant admission keeps one noisy tenant from
starving the rest.  :class:`GatewayService` is that shape on the existing
:class:`~repro_torch.core.events.EventLoop` (SimClock for deterministic
benchmarks, WallClock for a real deployment):

* **attach/detach at any time** — programmatic (:meth:`GatewayService
  .attach`) or over the wire protocol (:class:`WireFrontend` speaks the
  ``ATTACH``/``DETACH`` frames of :mod:`repro_torch.core.wire`, and rides a
  plain transport or one stream of a
  :class:`~repro_torch.core.transport.MuxPeer`);
* **warm pool** — :class:`WarmPool` keeps K pre-provisioned workers (each
  a ``registry.clone_topology()`` with fresh kernel namespaces) ready, so
  a pool hit attaches with zero provisioning wait; a miss walks the
  worker's compute envs through the fabric lifecycle state machine
  (``up → down → provisioning → up``, audit-logged) and pays the cold
  start.  Every acquire schedules a background refill, so the pool
  sustains ``K / cold_start`` attaches per second invisibly;
* **fair-share admission** — per-tenant quotas (max concurrent sessions)
  plus deficit-round-robin arbitration of the gateway-wide
  ``max_sessions`` budget: each backlogged tenant earns
  ``quantum x weight`` deficit per round and admits sessions while its
  deficit and quota allow, so admission bandwidth divides by weight
  instead of by who floods the queue hardest;
* **indexed hot paths** — admission and placement go through the
  interval-indexed :class:`~repro_torch.core.scheduler.CapacityArbiter`
  (bisect probes, not scans), and the fleet-minimum-clock watermark the
  arbiter prunes against comes from a lazy min-heap of session wake
  times, so no per-event work is O(sessions).

The degenerate instance — one tenant, no quota, everyone attached before
``run()`` — reproduces the batch scheduler's semantics: sessions still
gate through the same arbiter and the same placement policies, so paper
decision traces stay bit-identical.
"""
from __future__ import annotations

import heapq
import itertools
import math
import time
from collections import deque
from dataclasses import dataclass, field

from repro_torch.core import wire
from repro_torch.core.events import EventLoop
from repro_torch.core.fabric import EnvironmentRegistry
from repro_torch.core.migration import HybridRuntime
from repro_torch.core.notebook import Notebook
from repro_torch.core.reducer import StateReducer
from repro_torch.core.scheduler import CapacityArbiter
from repro_torch.core.wire import WireError
from repro_torch.device import resolve_device


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[min(rank, len(xs)) - 1])


# ----------------------------------------------------------------------
# warm pool
# ----------------------------------------------------------------------

@dataclass
class WarmWorker:
    """A pre-provisioned kernel slot: a private clone of the fabric
    topology (fresh namespaces, shared physical chunk stores)."""
    registry: EnvironmentRegistry
    warm: bool = True


class WarmPool:
    """K pre-provisioned workers; ``acquire`` pops one instantly on a hit.

    A hit costs zero provisioning wait and schedules a background refill
    ``cold_start`` seconds out — the replacement provisions while nobody
    is waiting on it, which is the entire point of a warm pool.  A miss
    builds a worker on the spot and charges the caller the cold start
    (its envs walk the lifecycle machine like any provisioning env).
    Used workers are never re-pooled: their namespaces are dirty, and
    their replacement was already scheduled at acquire time.  ``size=0``
    disables the pool (every attach pays the cold start) — the
    cold-provision baseline the gateway bench compares against."""

    def __init__(self, size: int, *, cold_start: float, factory):
        assert size >= 0 and cold_start >= 0.0
        self.size = int(size)
        self.cold_start = float(cold_start)
        self._factory = factory           # () -> EnvironmentRegistry clone
        self._ready: deque[WarmWorker] = deque()
        self._filling = 0
        self._loop: EventLoop | None = None
        self.hits = 0
        self.misses = 0
        self.refills = 0

    def bind(self, loop: EventLoop, *, prewarm: bool = True) -> None:
        self._loop = loop
        if prewarm:
            for _ in range(self.size):
                self._ready.append(WarmWorker(self._factory()))

    @property
    def level(self) -> int:
        return len(self._ready)

    def acquire(self, now: float) -> tuple[WarmWorker, float]:
        """Returns (worker, provisioning delay): 0.0 on a pool hit, the
        cold start on a miss."""
        self._refill_later()
        if self._ready:
            self.hits += 1
            return self._ready.popleft(), 0.0
        self.misses += 1
        worker = WarmWorker(self._factory(), warm=False)
        self._provision(worker, now)
        return worker, self.cold_start

    def release(self, worker: WarmWorker) -> None:
        """A detached session's worker is discarded, not re-pooled: its
        namespaces are dirty and its replacement is already provisioning
        (scheduled when it was acquired)."""

    def _refill_later(self) -> None:
        if self._loop is None or self.size == 0:
            return
        if self.level + self._filling < self.size:
            self._filling += 1
            self._loop.call_later(self.cold_start, self._refill, priority=-20)

    def _refill(self) -> None:
        self._filling -= 1
        if self.level < self.size:
            self._ready.append(WarmWorker(self._factory()))
            self.refills += 1

    def _provision(self, worker: WarmWorker, now: float) -> None:
        """Walk a cold worker's compute envs through the fabric lifecycle
        machine: ``up → down → provisioning`` now, ``→ up`` at readiness
        (audit-logged on the worker's registry)."""
        reg = worker.registry
        ready = now + self.cold_start
        for name, env in reg.envs().items():
            if env.kind != "compute" or env.status != "up":
                continue
            env.cold_start = max(env.cold_start, self.cold_start)
            reg.set_status(name, "down", now=now)
            reg.set_status(name, "provisioning", now=now)
            env.ready_at = ready
            if self._loop is not None:
                self._loop.call_at(ready, self._mark_up, reg, name, ready,
                                   priority=-20)

    @staticmethod
    def _mark_up(reg: EnvironmentRegistry, name: str, now: float) -> None:
        if name in reg and reg[name].status == "provisioning":
            reg.set_status(name, "up", now=now)


# ----------------------------------------------------------------------
# tenants + fair-share admission
# ----------------------------------------------------------------------

@dataclass
class GatewayTenant:
    """Admission state for one tenant: a FIFO of waiting attach requests,
    a deficit-round-robin account, and a concurrency quota."""
    name: str
    quota: int | None = None          # max concurrent sessions (None = ∞)
    weight: float = 1.0               # DRR share of admission bandwidth
    deficit: float = 0.0
    queue: deque = field(default_factory=deque)
    admitted: int = 0                 # currently-running sessions
    attached_total: int = 0
    admission_wait: float = 0.0       # summed seconds spent queued

    def can_admit(self) -> bool:
        return bool(self.queue) and (self.quota is None
                                     or self.admitted < self.quota)


@dataclass
class _AttachRequest:
    session_id: str
    tenant: str
    notebook: Notebook
    plan: list
    think: list
    requested_at: float = 0.0
    frontend: "WireFrontend | None" = None
    runtime_kw: dict = field(default_factory=dict)


@dataclass
class _GwSession:
    id: str
    idx: int                          # attach order: event-priority tie-break
    tenant: str
    runtime: HybridRuntime
    worker: WarmWorker
    plan: list
    think: list
    frontend: "WireFrontend | None" = None
    cursor: int = 0
    think_used: int = 0
    think_total: float = 0.0
    attached_at: float = 0.0
    attach_wait: float = 0.0
    next_wake: float = 0.0
    detached: bool = False
    step_event = None

    def next_think(self) -> float:
        if self.think_used < len(self.think):
            t = self.think[self.think_used]
            self.think_used += 1
            return float(t)
        return 0.0


@dataclass
class GatewaySessionReport:
    session: str
    tenant: str
    notebook: str
    cells_run: int
    attach_wait: float                # admission wait + provisioning wait
    warm: bool
    queue_wait: float                 # capacity waits during the session
    makespan: float                   # session clock at detach
    migrations: int
    reason: str                       # complete | client | error:...
    # replica plane (zero with replicas=0): convergence lag at detach,
    # promotions taken, races run and their win/waste tallies
    replica_lag: int = 0
    promotions: int = 0
    races: int = 0
    race_wins: dict = field(default_factory=dict)
    race_waste_seconds: float = 0.0


@dataclass
class GatewayReport:
    sessions: int
    completed: int
    client_detached: int
    errors: int
    peak_concurrent: int
    makespan: float
    attach_wait_p50: float
    attach_wait_p99: float
    warm_attach_p99: float
    cold_attach_p99: float
    queue_wait_p50: float
    queue_wait_p99: float
    decision_ms_p50: float
    decision_ms_p99: float
    decisions: int
    pool_hits: int
    pool_misses: int
    pool_refills: int
    pruned_intervals: int
    env_utilization: dict
    tenants: dict
    # replica plane aggregates (zero with replicas=0)
    promotions: int = 0
    races: int = 0
    race_waste_seconds: float = 0.0
    session_reports: list = field(default_factory=list)


# ----------------------------------------------------------------------
# the service
# ----------------------------------------------------------------------

class GatewayService:
    """A long-running gateway process over one shared fabric registry.

    Sessions gate through one interval-indexed
    :class:`~repro_torch.core.scheduler.CapacityArbiter` (the physical pool)
    while each runs on a private worker clone from the :class:`WarmPool`.
    ``attach()`` may be called before or during :meth:`run` — including
    from event callbacks, which is how :class:`WireFrontend` injects
    wire-borne attach storms.

    ``device`` (``"cuda"``, the default, or ``"cpu"``) is where every
    session's digests, chunk keys and quantization run: a session started
    without a ``reducer`` gets its own ``StateReducer`` on it.  Asking for
    ``"cuda"`` without a card raises."""

    def __init__(self, registry: EnvironmentRegistry, *,
                 warm_pool: int = 4, cold_start: float = 5.0,
                 max_sessions: int | None = None,
                 quantum: float = 1.0, share_chunks: bool = True,
                 clock=None, poll_interval: float = 0.05,
                 prune_interval: float = 10.0, prewarm: bool = True,
                 replicas: int = 0, race: bool = False, device="cuda",
                 **runtime_defaults):
        if replicas < 0:
            raise ValueError(f"replicas must be >= 0, got {replicas}")
        self.device = resolve_device(device)
        self.replicas_k = int(replicas)
        self.race = bool(race)
        self.registry = registry
        self.share_chunks = bool(share_chunks)
        self.loop = EventLoop(clock)
        self.arbiter = CapacityArbiter(registry)
        self.pool = WarmPool(warm_pool, cold_start=cold_start,
                             factory=self._clone)
        self.pool.bind(self.loop, prewarm=prewarm)
        self.max_sessions = max_sessions
        self.quantum = float(quantum)
        self.poll_interval = float(poll_interval)
        self.prune_interval = float(prune_interval)
        self.runtime_defaults = dict(runtime_defaults)
        self.tenants: dict[str, GatewayTenant] = {}
        self.stop_when_idle = False
        self._pending_storm = 0        # scheduled-but-not-yet-admitted
        self._sessions: dict[str, _GwSession] = {}
        self._active = 0
        self._queued = 0
        self._seq = itertools.count()
        self._drr_ring: deque[str] = deque()
        self._wake_heap: list[tuple[float, int, _GwSession]] = []
        self._last_prune = float("-inf")
        self._frontends: list[WireFrontend] = []
        # telemetry
        self.peak_concurrent = 0
        self.warm_waits: list[float] = []
        self.cold_waits: list[float] = []
        self.decision_seconds: list[float] = []
        self.reports: list[GatewaySessionReport] = []

    def _clone(self) -> EnvironmentRegistry:
        return self.registry.clone_topology(
            share_chunk_stores=self.share_chunks)

    # -- tenants ---------------------------------------------------------
    def add_tenant(self, name: str, *, quota: int | None = None,
                   weight: float = 1.0) -> GatewayTenant:
        if weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be positive")
        if quota is not None and quota < 1:
            raise ValueError(f"tenant {name!r}: quota must be >= 1")
        t = self.tenants[name] = GatewayTenant(name, quota=quota,
                                               weight=float(weight))
        self._drr_ring.append(name)
        return t

    def _tenant(self, name: str) -> GatewayTenant:
        if name not in self.tenants:
            self.add_tenant(name)
        return self.tenants[name]

    # -- attach / detach -------------------------------------------------
    def attach(self, notebook: Notebook, plan=None, *,
               tenant: str = "default", think=None, at: float | None = None,
               session: str | None = None, frontend=None,
               **runtime_kw) -> str:
        """Queue a session attach (admission happens on the loop, under
        fair-share).  ``at`` schedules the request for a future sim time;
        default is now.  Returns the session id immediately."""
        sid = session or f"g{next(self._seq):05d}-{notebook.name}"
        kw = dict(self.runtime_defaults)
        kw.update(runtime_kw)
        req = _AttachRequest(
            session_id=sid, tenant=tenant, notebook=notebook,
            plan=list(plan) if plan is not None
            else list(range(len(notebook.cells))),
            think=list(think or []), frontend=frontend, runtime_kw=kw)
        when = self.loop.now() if at is None else at
        self.loop.call_at(when, self._admit_request, req, priority=-2)
        return sid

    def detach(self, session_id: str, reason: str = "client") -> None:
        """Client-initiated detach: stops the session wherever it is (its
        pending step event is cancelled) and frees its worker + quota."""
        sess = self._sessions.get(session_id)
        if sess is None:
            raise KeyError(f"no attached session {session_id!r}")
        if sess.step_event is not None:
            sess.step_event.cancel()
        self._finish(sess, reason)

    def _admit_request(self, req: _AttachRequest) -> None:
        req.requested_at = self.loop.now()
        if self._pending_storm > 0:
            self._pending_storm -= 1
        self._tenant(req.tenant).queue.append(req)
        self._queued += 1
        self._pump_admission()

    def _free_slots(self) -> float:
        if self.max_sessions is None:
            return float("inf")
        return self.max_sessions - self._active

    def _pump_admission(self) -> None:
        """Deficit round robin over backlogged tenants: one visit earns
        ``quantum x weight``; a session costs 1 deficit.  Tenants at
        quota are skipped without earning (deficit must not hoard while
        the tenant cannot spend it)."""
        while self._queued and self._free_slots() > 0:
            admitted_this_round = False
            for _ in range(len(self._drr_ring)):
                name = self._drr_ring[0]
                self._drr_ring.rotate(-1)
                t = self.tenants[name]
                if not t.can_admit():
                    if not t.queue:
                        t.deficit = 0.0
                    continue
                t.deficit += self.quantum * t.weight
                while t.can_admit() and t.deficit >= 1.0 \
                        and self._free_slots() > 0:
                    t.deficit -= 1.0
                    self._start_session(t, t.queue.popleft())
                    admitted_this_round = True
                if not t.queue:
                    t.deficit = 0.0
            if not admitted_this_round:
                return                 # everyone blocked on quota or slots

    def _start_session(self, tenant: GatewayTenant,
                       req: _AttachRequest) -> None:
        now = self.loop.now()
        self._queued -= 1
        if req.session_id in self._sessions:   # client reused a live id
            req.session_id = f"{req.session_id}#{next(self._seq)}"
        worker, delay = self.pool.acquire(now)
        kw = dict(req.runtime_kw)
        if kw.get("reducer") is None:
            kw["reducer"] = StateReducer(device=self.device)
        rt = HybridRuntime(req.notebook, registry=worker.registry,
                           arbiter=self.arbiter, session_id=req.session_id,
                           **kw)
        self._time_decisions(rt)
        if self.replicas_k > 0:
            followers = sorted(
                n for n, e in worker.registry.envs().items()
                if e.kind == "compute" and n != rt.home)[:self.replicas_k]
            if followers:
                rt.attach_replicas(followers, race=self.race)
        admission_wait = now - req.requested_at
        attach_wait = admission_wait + delay
        (self.warm_waits if worker.warm else self.cold_waits).append(
            attach_wait)
        tenant.admitted += 1
        tenant.attached_total += 1
        tenant.admission_wait += admission_wait
        sess = _GwSession(
            id=req.session_id, idx=next(self._seq), tenant=tenant.name,
            runtime=rt, worker=worker, plan=req.plan, think=req.think,
            frontend=req.frontend, attached_at=now, attach_wait=attach_wait)
        self._sessions[sess.id] = sess
        self._active += 1
        self.peak_concurrent = max(self.peak_concurrent, self._active)
        ready = now + delay
        sess.next_wake = ready
        heapq.heappush(self._wake_heap, (ready, sess.idx, sess))
        sess.step_event = self.loop.call_at(ready, self._step, sess,
                                            priority=sess.idx)
        if req.frontend is not None:
            req.frontend.notify_attached(sess, admission_wait, ready)

    def _time_decisions(self, rt: HybridRuntime) -> None:
        """Wall-clock every placement decision this runtime makes (the
        bench's decision-latency distribution)."""
        orig = rt.analyzer.decide
        sink = self.decision_seconds

        def timed(nb, cell, **kw):
            t0 = time.perf_counter()
            d = orig(nb, cell, **kw)
            sink.append(time.perf_counter() - t0)
            return d

        rt.analyzer.decide = timed

    # -- the per-session step --------------------------------------------
    def _step(self, sess: _GwSession) -> None:
        if sess.detached:
            return
        sess.step_event = None
        rt = sess.runtime
        now = self.loop.now()
        gap = now - rt.clock.now()
        if gap > 0:
            rt.clock.advance_to(now)
            if sess.cursor > 0:
                sess.think_total += gap
        if rt.replicas is not None:
            # think time just ended: converge the followers on whatever the
            # last cell committed before the next one runs
            rt.replicas.sync(now)
        self._prune_tick()
        try:
            rt.run_cell(sess.plan[sess.cursor])
        except Exception as e:  # noqa: BLE001 — a dying cell detaches, not crashes
            self._finish(sess, f"error:{type(e).__name__}")
            return
        sess.cursor += 1
        if sess.cursor >= len(sess.plan):
            self._finish(sess, "complete")
            return
        t_next = rt.clock.now() + sess.next_think()
        sess.next_wake = t_next
        heapq.heappush(self._wake_heap, (t_next, sess.idx, sess))
        sess.step_event = self.loop.call_at(t_next, self._step, sess,
                                            priority=sess.idx)

    def _prune_tick(self) -> None:
        """Arbiter pruning without an O(sessions) scan: the fleet-minimum
        clock watermark is the min of the lazy wake-time heap (stale
        entries — detached sessions, superseded wake times — pop on
        contact), and the actual prune runs at most once per
        ``prune_interval`` of watermark progress."""
        heap = self._wake_heap
        while heap and (heap[0][2].detached
                        or heap[0][0] != heap[0][2].next_wake):
            heapq.heappop(heap)
        if not heap:
            return
        watermark = heap[0][0]
        if watermark - self._last_prune >= self.prune_interval:
            self._last_prune = watermark
            self.arbiter.prune(watermark)

    def _finish(self, sess: _GwSession, reason: str) -> None:
        sess.detached = True
        rt = sess.runtime
        rs = rt.replicas
        self.reports.append(GatewaySessionReport(
            session=sess.id, tenant=sess.tenant, notebook=rt.nb.name,
            cells_run=sess.cursor, attach_wait=sess.attach_wait,
            warm=sess.worker.warm, queue_wait=rt.queue_wait,
            makespan=rt.clock.now(), migrations=rt.migrations,
            reason=reason,
            replica_lag=rs.lag() if rs else 0,
            promotions=rs.promotions if rs else 0,
            races=rs.races if rs else 0,
            race_wins=dict(rs.race_wins) if rs else {},
            race_waste_seconds=rs.race_waste_seconds if rs else 0.0))
        rt.close()
        self.pool.release(sess.worker)
        self.tenants[sess.tenant].admitted -= 1
        self._active -= 1
        del self._sessions[sess.id]
        if sess.frontend is not None:
            sess.frontend.notify_detached(sess, reason)
        self._pump_admission()

    # -- wire frontends --------------------------------------------------
    def add_frontend(self, transport) -> "WireFrontend":
        """Serve gateway control frames (ATTACH/DETACH) arriving on
        ``transport`` — a plain transport or one
        :class:`~repro_torch.core.transport.MuxStream` of a shared socket.  The
        frontend is polled from the event loop (no blocked thread per
        connection)."""
        fe = WireFrontend(self, transport)
        self._frontends.append(fe)
        self.loop.every(self.poll_interval, fe._tick, priority=-3)
        return fe

    def expect_storm(self, n: int) -> None:
        """Declare ``n`` future attach requests so ``stop_when_idle``
        drains only after they all arrived (wire storms reach the
        gateway with polling latency; an idle instant in between must
        not stop the service)."""
        self._pending_storm += int(n)
        self.stop_when_idle = True

    def _idle(self) -> bool:
        return (self._pending_storm == 0 and self._active == 0
                and self._queued == 0)

    # -- driving ---------------------------------------------------------
    def run(self, until: float | None = None) -> GatewayReport:
        """Drive the loop until drained (or ``until``); returns the
        aggregate report.  With ``stop_when_idle`` set (storm benches),
        frontend pollers stand down once the declared storm has fully
        drained, letting the loop empty."""
        self.loop.run(until)
        return self.report()

    def report(self) -> GatewayReport:
        reasons = [r.reason for r in self.reports]
        queue_waits = [r.queue_wait for r in self.reports]
        attach_waits = self.warm_waits + self.cold_waits
        dec_ms = [s * 1e3 for s in self.decision_seconds]
        return GatewayReport(
            sessions=len(self.reports),
            completed=sum(1 for r in reasons if r == "complete"),
            client_detached=sum(1 for r in reasons if r == "client"),
            errors=sum(1 for r in reasons if r.startswith("error")),
            peak_concurrent=self.peak_concurrent,
            makespan=self.loop.now(),
            attach_wait_p50=percentile(attach_waits, 50),
            attach_wait_p99=percentile(attach_waits, 99),
            warm_attach_p99=percentile(self.warm_waits, 99),
            cold_attach_p99=percentile(self.cold_waits, 99),
            queue_wait_p50=percentile(queue_waits, 50),
            queue_wait_p99=percentile(queue_waits, 99),
            decision_ms_p50=percentile(dec_ms, 50),
            decision_ms_p99=percentile(dec_ms, 99),
            decisions=len(dec_ms),
            pool_hits=self.pool.hits, pool_misses=self.pool.misses,
            pool_refills=self.pool.refills,
            pruned_intervals=self.arbiter.pruned_intervals,
            env_utilization={n: self.arbiter.utilization(n)
                             for n in self.registry.names()},
            tenants={
                name: {"attached": t.attached_total, "quota": t.quota,
                       "weight": t.weight,
                       "admission_wait": t.admission_wait}
                for name, t in self.tenants.items()},
            promotions=sum(r.promotions for r in self.reports),
            races=sum(r.races for r in self.reports),
            race_waste_seconds=sum(r.race_waste_seconds
                                   for r in self.reports),
            session_reports=list(self.reports))


# ----------------------------------------------------------------------
# the wire frontend
# ----------------------------------------------------------------------

class WireFrontend:
    """Gateway control plane over one transport: handles inbound ATTACH
    (builds the Notebook from the payload, queues admission, acks with
    the session id) and DETACH; notifies the client with a DETACH frame
    when a session completes.  Driven by a loop timer calling
    ``transport.poll()`` — many frontends share the one gateway thread."""

    def __init__(self, gw: GatewayService, transport):
        self.gw = gw
        self.transport = transport
        self.closed = False
        self.attaches = 0
        self.detaches = 0

    # -- gateway-side notifications --------------------------------------
    def notify_attached(self, sess: _GwSession, admission_wait: float,
                        ready_at: float) -> None:
        self._send(wire.json_frame(wire.ACK, {
            "session": sess.id, "admission_wait": admission_wait,
            "ready_at": ready_at, "warm": sess.worker.warm}))

    def notify_detached(self, sess: _GwSession, reason: str) -> None:
        self._send(wire.detach_frame(sess.id, reason))

    def _send(self, frame) -> None:
        if self.closed:
            return
        try:
            self.transport.send(frame)
        except WireError:
            self.closed = True

    # -- the poll tick ----------------------------------------------------
    def _tick(self):
        if self.closed:
            return False
        while True:
            try:
                frame = self.transport.poll()
            except WireError:
                self.closed = True         # connection died: stand down
                return False
            if frame is None:
                break
            self._handle(frame)
        if self.gw.stop_when_idle and self.gw._idle():
            return False                   # storm drained: let the loop empty
        return None

    def _handle(self, frame) -> None:
        t = frame.ftype
        if t == wire.ATTACH:
            doc = wire.parse_attach(frame)
            nb = Notebook(doc["notebook"])
            for c in doc["cells"]:
                nb.add_cell(c["source"], cost=c["cost"])
            sid = self.gw.attach(nb, tenant=doc["tenant"],
                                 think=doc["think"],
                                 session=doc["session"], frontend=self)
            self.attaches += 1
            self._send(wire.json_frame(wire.ACK, {"queued": sid}))
        elif t == wire.DETACH:
            sid, reason = wire.parse_detach(frame)
            try:
                self.gw.detach(sid, reason)
                self.detaches += 1
            except KeyError:
                self._send(wire.json_frame(wire.ERROR, {
                    "error": f"no attached session {sid!r}",
                    "kind": "gateway"}))
        elif t == wire.HELLO:
            wire.parse_hello(frame)
            self._send(wire.hello_frame())
        elif t == wire.BYE:
            self.closed = True
        else:
            self._send(wire.json_frame(wire.ERROR, {
                "error": f"unexpected {wire.TYPE_NAMES.get(t, t)} frame "
                         f"on the gateway control plane",
                "kind": "gateway"}))


# ----------------------------------------------------------------------
# attach storms
# ----------------------------------------------------------------------

def poisson_attach_storm(gw: GatewayService, *, n_sessions: int,
                         rate: float, think_mean: float,
                         make_notebook, tenants=("default",),
                         seed: int = 0, client=None,
                         **runtime_kw) -> list[str]:
    """Schedule a seeded Poisson attach storm against ``gw`` and arm it to
    stop when drained.  ``make_notebook(i) -> Notebook`` builds the i-th
    session's notebook; tenants are assigned round-robin.  Direct mode
    queues :meth:`GatewayService.attach` calls on the loop; pass
    ``client`` (the client end of a frontend's transport) to instead send
    real ``ATTACH`` frames across the wire at each arrival, exercising
    the full decode → admit → ack path.  Returns the session ids (direct
    mode) or the ids encoded in the frames (wire mode)."""
    from repro_torch.core.scheduler import WorkloadTrace

    trace = WorkloadTrace.poisson(
        n_sessions, rate=rate, think_mean=think_mean,
        cells_per_session=len(make_notebook(0).cells), seed=seed)
    gw.expect_storm(n_sessions)
    sids = []
    for i, arrival in enumerate(trace.arrivals):
        nb = make_notebook(i)
        tenant = tenants[i % len(tenants)]
        sid = f"storm{seed}x{i:05d}-{nb.name}"
        sids.append(sid)
        if client is None:
            gw.attach(nb, tenant=tenant, think=trace.think[i], at=arrival,
                      session=sid, **runtime_kw)
        else:
            frame = wire.attach_frame(
                tenant, nb.name,
                [{"source": c.source, "cost": c.cost} for c in nb.cells],
                think=trace.think[i], session=sid)
            gw.loop.call_at(arrival, client.send, frame, priority=-2)
    return sids
