"""Event-driven fleet scheduler: many notebook sessions on one live fabric.

The paper serves a single user on a single cloud node; its §II-B insight is
that *think-time gaps* between cell executions are what make migration free.
This module puts those gaps (and everything else a fleet has: arrivals,
cold starts, idle culls, failures, autoscaling) on a discrete-event loop
(:mod:`repro_torch.core.events`):

* **sessions** arrive from a :class:`WorkloadTrace` (Poisson or recorded)
  and think between cells; each session still owns a private
  :class:`HybridRuntime` over a ``registry.clone_topology()`` while one
  shared :class:`CapacityArbiter` models the physical pool;
* **env lifecycle** rides the loop: provisioning (cold start), idle culls
  and failure injection transition the shared registry's state machine and
  mirror into every session clone;
* **failure recovery** goes through the state plane: periodic background
  checkpoints (:class:`SessionCheckpointer` — migration into a storage env's
  CAS) let a session restore and replay only the cells since the last
  checkpoint instead of rerunning from scratch;
* **autoscaling** (:class:`AutoscalePolicy`) watches queue-wait/idle
  telemetry and provisions or culls pool environments.

The paper's setup is the degenerate instance: zero arrival gaps, zero
think-time, no failures, a static always-up fleet — then the event loop
replays the historical earliest-clock-first interleave exactly (session
index breaks ties, as ``min()`` over the session list used to).
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right, insort
from dataclasses import dataclass, field

from repro_torch.core import telemetry as T
from repro_torch.core.analyzer import _modeled_exec_seconds
from repro_torch.core.events import EventLoop
from repro_torch.core.fabric import EnvironmentRegistry
from repro_torch.core.migration import EnvFailure, HybridRuntime
from repro_torch.core.notebook import Cell, Notebook
from repro_torch.core.reducer import SerializedState, StateReducer
from repro_torch.device import resolve_device


class CapacityArbiter:
    """Per-env slot accounting shared by every session in the fleet.

    ``acquire(env, now)`` returns the earliest start time a slot is free
    (== ``now`` when under capacity); ``release`` records the busy interval.
    """

    def __init__(self, registry: EnvironmentRegistry):
        self._cap = {n: registry.capacity(n) for n in registry.names()}
        # interval history per env: acquire times are NOT monotone across
        # sessions (migrations advance a session's clock between the
        # scheduler's earliest-first pick and the gate), so freed slots
        # can't be popped destructively — admission is computed against the
        # retained intervals.  ``prune`` drops intervals that end before the
        # fleet's minimum session clock (no later acquire can see them),
        # which keeps this scan from growing O(total-history).
        self._busy: dict[str, list[tuple[float, float]]] = {
            n: [] for n in registry.names()}
        # interval index: per-env sorted start/end arrays kept alongside the
        # insertion-ordered history, so admission probes are bisects instead
        # of scans — running(t) = |starts ≤ t| − |ends ≤ t| — and each
        # acquire costs O(log live + probes-in-window), not O(live)
        self._starts: dict[str, list[float]] = {n: [] for n in registry.names()}
        self._ends: dict[str, list[float]] = {n: [] for n in registry.names()}
        self.busy_seconds: dict[str, float] = {n: 0.0 for n in registry.names()}
        self.last_release: dict[str, float] = {}
        self.queue_events: list[tuple[str, float, float]] = []  # env, asked, got
        self.horizon = 0.0
        self.pruned_intervals = 0

    def _earliest(self, env: str, now: float, duration: float) -> float:
        """Earliest start ≥ ``now`` with a free slot for all of ``duration``.

        Checking only the start instant would let a session slip in ahead of
        a later-starting recorded interval and overlap it (per-session sim
        clocks are not globally ordered); probing every interval start
        inside the candidate window keeps utilization ≤ 1 whenever declared
        cell costs match actual durations."""
        cap = self._cap.get(env, 1)
        if cap <= 0:
            raise ValueError(f"acquire on env {env!r} with capacity {cap}: "
                             f"placement should never target it")
        self._busy.setdefault(env, [])
        starts = self._starts.setdefault(env, [])
        ends = self._ends.setdefault(env, [])

        def running(q: float) -> int:
            # intervals with start ≤ q < end; closed starts cancel against
            # closed ends, so zero-length intervals never count
            return bisect_right(starts, q) - bisect_right(ends, q)

        t = now
        while True:
            lo = bisect_right(starts, t)
            hi = bisect_left(starts, t + duration)
            blocked_at = None
            for q in (t, *starts[lo:hi]):
                if running(q) >= cap:
                    blocked_at = q
                    break
            if blocked_at is None:
                return t
            # advance to the earliest end after the blocked probe: never
            # past the earliest *running* end, so no admission is skipped —
            # the loop re-probes from there
            t = ends[bisect_right(ends, blocked_at)]

    def acquire(self, env: str, now: float, duration: float = 0.0) -> float:
        t = self._earliest(env, now, duration)
        if t > now:
            self.queue_events.append((env, now, t))
        return t

    def expected_wait(self, env: str, now: float) -> float:
        """Peek the current queue wait without recording a queue event —
        the fleet view's placement-pricing probe."""
        if self._cap.get(env, 1) <= 0:
            return float("inf")
        return self._earliest(env, now, 0.0) - now

    def release(self, env: str, start: float, end: float) -> None:
        self._busy.setdefault(env, []).append((start, end))
        insort(self._starts.setdefault(env, []), start)
        insort(self._ends.setdefault(env, []), end)
        self.busy_seconds[env] = self.busy_seconds.get(env, 0.0) + (end - start)
        self.last_release[env] = max(self.last_release.get(env, 0.0), end)
        self.horizon = max(self.horizon, end)

    def prune(self, before: float) -> int:
        """Drop intervals that ended at or before ``before`` (the fleet's
        minimum session clock): every future ``acquire`` passes ``now >=
        before``, and an interval with ``end <= now`` can never block a
        probe at ``q >= now`` — so the scan stays bounded by the number of
        *live* intervals instead of the whole history."""
        dropped = 0
        for env, intervals in self._busy.items():
            keep = [iv for iv in intervals if iv[1] > before]
            if len(keep) != len(intervals):
                dropped += len(intervals) - len(keep)
                self._busy[env] = keep
                self._starts[env] = sorted(s for s, _ in keep)
                self._ends[env] = sorted(e for _, e in keep)
        self.pruned_intervals += dropped
        return dropped

    def set_capacity(self, env: str, cap: int) -> None:
        self._cap[env] = int(cap)

    def capacity(self, env: str) -> int:
        return self._cap.get(env, 1)

    def utilization(self, env: str) -> float:
        if self.horizon <= 0:
            return 0.0
        return self.busy_seconds.get(env, 0.0) / (
            max(self._cap.get(env, 1), 1) * self.horizon)


# ----------------------------------------------------------------------
# workload traces: arrivals + think-time
# ----------------------------------------------------------------------

@dataclass
class WorkloadTrace:
    """Session arrival offsets and per-cell think-time gaps.

    ``arrivals[i]`` is when session *i* starts; ``think[i][k]`` is the idle
    gap the user leaves after that session's *k*-th executed cell (§II-B —
    these gaps are what migration and prefetch hide inside).  Recorded
    traces pass the lists directly; :meth:`poisson` draws both from a
    seeded generator so runs are reproducible."""

    arrivals: list[float]
    think: list[list[float]]

    @classmethod
    def static(cls, n_sessions: int) -> "WorkloadTrace":
        """The paper's degenerate instance: everyone at t=0, no gaps."""
        return cls([0.0] * n_sessions, [[] for _ in range(n_sessions)])

    @classmethod
    def poisson(cls, n_sessions: int, *, rate: float, think_mean: float,
                cells_per_session: int, seed: int = 0) -> "WorkloadTrace":
        """Poisson arrivals at ``rate``/s, exponential think-times with mean
        ``think_mean`` s — both pre-drawn from ``seed`` (determinism)."""
        import numpy as np
        rng = np.random.default_rng(seed)
        if rate > 0:
            gaps = rng.exponential(1.0 / rate, n_sessions)
            arrivals = [float(t) for t in np.cumsum(gaps) - gaps[0]]
        else:
            arrivals = [0.0] * n_sessions
        think = []
        for _ in range(n_sessions):
            if think_mean > 0:
                think.append([float(x) for x in
                              rng.exponential(think_mean, cells_per_session)])
            else:
                think.append([])
        return cls(arrivals, think)


# ----------------------------------------------------------------------
# workload families (cost plane)
# ----------------------------------------------------------------------

def gpu_training_notebook(name: str = "gpu-train", *, steps: int = 4,
                          step_cost: float = 45.0, params_mb: float = 4.0,
                          data_mb: float = 8.0) -> Notebook:
    """A GPU-heavy training notebook (NotebookOS-style on-demand
    accelerator binding): one cheap setup cell, ``steps`` expensive train
    steps that each mutate the model weights (checkpoint-heavy — every
    step dirties the largest name in the namespace), and a cheap eval
    cell.  Declared costs are home-seconds; an accelerator env's speedup
    divides them, which is exactly the asymmetry the placement DP trades
    against its $/hour price tag."""
    p_elems = max(1, int(params_mb * 131072))     # float64 MB -> elements
    d_elems = max(1, int(data_mb * 131072))
    cells = [Cell((
        "import numpy as np\n"
        f"data = np.arange({d_elems}, dtype=np.float64)\n"
        f"weights = np.zeros({p_elems}, dtype=np.float64)\n"
        "losses = []\n"), cost=2.0, cell_id="setup")]
    for i in range(steps):
        cells.append(Cell((
            f"weights = weights + {float(i + 1)}\n"
            "losses.append(float(weights[0] + data[0]))\n"),
            cost=float(step_cost), cell_id=f"train-{i}"))
    cells.append(Cell("summary = (len(losses), float(weights[-1]))\n",
                      cost=1.0, cell_id="eval"))
    return Notebook(name, cells)


def remote_sensing_notebook(name: str = "remote-sensing", *, scenes: int = 4,
                            scene_mb: float = 6.0,
                            band_cost: float = 30.0) -> Notebook:
    """A remote-sensing pipeline whose working set is dominated by the
    ingested scene stack: heavy per-band computations reference the whole
    stack, so migrating the computation means migrating the dataset.  With
    the dataset homed next to a storage env and egress priced on the link
    out, data gravity must pull compute *to* the data — shipping the stack
    pays egress dollars and loses the placement comparison."""
    s_elems = max(1, int(scene_mb * 131072))
    cells = [Cell((
        "import numpy as np\n"
        f"scenes = np.ones(({scenes}, {s_elems}), dtype=np.float64)\n"
        "products = {}\n"), cost=3.0, cell_id="ingest")]
    for i, stage in enumerate(("ndvi", "cloudmask", "mosaic")):
        cells.append(Cell(
            f"products['{stage}'] = float(scenes[{i % scenes}].sum())\n",
            cost=float(band_cost), cell_id=stage))
    cells.append(Cell("report = sorted(products.items())\n",
                      cost=1.0, cell_id="report"))
    return Notebook(name, cells)


# ----------------------------------------------------------------------
# autoscaling
# ----------------------------------------------------------------------

class AutoscalePolicy:
    """Provision/cull pool environments from queue + idle telemetry.

    ``pool`` names registry envs the policy may scale (they must exist in
    the registry — registered ``status="down"`` for burst capacity the
    policy can bring up).  Every ``check_interval`` seconds of sim time:

    * if any up compute env's expected queue wait exceeds
      ``scale_up_wait``, the first down pool env is provisioned (it comes
      up after its ``cold_start``);
    * an up pool env idle longer than its ``idle_timeout`` — with no
      session currently placed on it — is culled (``draining → down``).
    """

    def __init__(self, pool: list[str], *, check_interval: float = 5.0,
                 scale_up_wait: float = 1.0):
        assert pool, "autoscale needs at least one pool env"
        self.pool = list(pool)
        self.check_interval = float(check_interval)
        self.scale_up_wait = float(scale_up_wait)

    def decide(self, stats: dict) -> list[tuple[str, str]]:
        """``stats``: {env: {status, expected_wait, idle_for, idle_timeout,
        occupied}}.  Returns [(action, env)] with action provision|cull."""
        actions: list[tuple[str, str]] = []
        pressure = max((s["expected_wait"] for s in stats.values()
                        if s["status"] == "up"), default=0.0)
        if pressure > self.scale_up_wait:
            for name in self.pool:
                if stats.get(name, {}).get("status") == "down":
                    actions.append(("provision", name))
                    break
        for name in self.pool:
            s = stats.get(name)
            if (s and s["status"] == "up" and not s["occupied"]
                    and s["idle_timeout"] is not None
                    and s["idle_for"] > s["idle_timeout"]):
                actions.append(("cull", name))
        return actions


# ----------------------------------------------------------------------
# checkpoint/restore through the state plane
# ----------------------------------------------------------------------

class SessionCheckpointer:
    """Periodic background checkpoints of one session into a storage env.

    A save *is* a migration: the session's engine moves the current env's
    namespace into the storage env's content-addressed chunk store (delta
    against the previous save — unchanged names cost a manifest entry,
    unchanged chunks nothing) and the cumulative per-name manifests are
    kept so every checkpoint is self-contained.  ``restore`` deserializes
    the manifest into the home namespace and charges only the chunks home's
    store doesn't already hold — usually a small fraction, because the
    session's own earlier migrations banked most of them."""

    def __init__(self, runtime: HybridRuntime, storage_env):
        self.rt = runtime
        self.storage = storage_env
        self._blobs: dict[str, object] = {}    # name -> SerializedName
        self._digests: dict[str, int] = {}
        self._skipped: set[str] = set()        # unserializable: never captured
        self.cursor = 0                        # plan cursor the save captured
        self.saves = 0
        self.bytes_written = 0

    def save(self, cursor: int, now: float) -> int:
        src = self.rt.envs[self.rt.current_env]
        res = self.rt.engine.migrate(src, self.storage, names=None,
                                     strict=False, now=now)
        for n in res.deleted:
            self._blobs.pop(n, None)
            self._digests.pop(n, None)
        ser = self.rt.engine.last_ser
        if ser is not None:
            self._blobs.update(ser.blobs)
            self._digests.update(ser.digests)
            self._skipped |= set(ser.skipped)
        self.cursor = cursor
        self.saves += 1
        self.bytes_written += res.nbytes
        return res.nbytes

    def restore(self, now: float) -> tuple[int, float]:
        """Rebuild the checkpointed namespace on home; returns (wire bytes,
        modeled seconds).  Chunks already in home's CAS never re-travel."""
        rt = self.rt
        home = rt.envs[rt.home]
        ser = SerializedState(codec=rt.reducer.codec, blobs=dict(self._blobs),
                              digests=dict(self._digests))
        held: set[int] = set()
        for blob in ser.blobs.values():
            for d in blob.chunk_digests():
                if home.chunk_store.has(d):
                    held.add(d)
                elif d not in ser.chunks and self.storage.chunk_store.has(d):
                    ser.chunks[d] = self.storage.chunk_store.get(d)
        wire = ser.wire_nbytes(held)
        seconds = rt.registry.transfer_seconds(self.storage.name, rt.home,
                                               wire)
        objs = rt.reducer.deserialize(ser, target_ns=home.state.ns,
                                      chunk_store=self.storage.chunk_store)
        home.state.update(objs)
        home.chunk_store.put_many(ser.chunks)
        # roll back names the session defined *after* this checkpoint —
        # replay must not see them.  Module aliases survive (never
        # serialized; re-imports are free) and so do names the save had to
        # skip as unserializable (dropping those would lose state replay
        # cannot rebuild from the checkpointed cells).
        import types as _types
        keep = set(self._blobs) | self._skipped
        extra = [n for n in home.state.names()
                 if n not in keep
                 and not isinstance(home.state.get(n), _types.ModuleType)]
        home.state.drop(extra)
        # restored content supersedes whatever any peer thought it held
        rt.engine.invalidate(rt.home, list(objs) + extra)
        return wire, seconds


# ----------------------------------------------------------------------
# reports
# ----------------------------------------------------------------------

@dataclass
class SessionReport:
    session: str
    notebook: str
    cells_run: int
    makespan: float
    queue_wait: float
    migrations: int
    prediction_hits: int = 0
    prediction_total: int = 0
    arrival: float = 0.0
    think_time: float = 0.0
    recoveries: int = 0
    # live replication: think-time bytes trickled ahead / bytes a migration
    # claimed from the bank / speculative bytes (prefetch + trickle) wasted
    trickled_bytes: int = 0
    trickle_claimed_bytes: int = 0
    wasted_bytes: int = 0
    # replica plane (all zero with --replicas 0): follower convergence lag
    # at drain, bytes applied / claimed-from-bank, promotions and races
    replica_lag: int = 0
    replicated_bytes: int = 0
    replica_shared_bytes: int = 0
    promotions: int = 0
    races: int = 0
    race_wins: dict = field(default_factory=dict)
    race_waste_seconds: float = 0.0
    # cost plane (all zero on an unpriced fleet): execution dollars billed
    # per-env, egress dollars for migration bytes, and the fraction of this
    # session's cells that completed within the per-cell latency SLO
    compute_dollars: float = 0.0
    egress_dollars: float = 0.0
    slo_attainment: float = 1.0

    @property
    def dollars(self) -> float:
        return self.compute_dollars + self.egress_dollars

    @property
    def prediction_hit_rate(self) -> float:
        if self.prediction_total == 0:
            return 0.0
        return self.prediction_hits / self.prediction_total


@dataclass
class _Session:
    runtime: HybridRuntime
    plan: list
    cursor: int = 0
    arrival: float = 0.0
    think: list[float] = field(default_factory=list)
    think_used: int = 0
    think_total: float = 0.0
    recoveries: int = 0
    ckpt: SessionCheckpointer | None = None
    rep: object | None = None          # DeltaReplicator when replication on
    replicas: object | None = None     # SessionReplicaSet when replicas on

    def done(self) -> bool:
        return self.cursor >= len(self.plan)

    def next_think(self) -> float:
        if self.think_used < len(self.think):
            t = self.think[self.think_used]
            self.think_used += 1
            return float(t)
        return 0.0


@dataclass
class ScheduleReport:
    sessions: list[SessionReport]
    env_utilization: dict[str, float]
    queue_events: int
    makespan: float
    # predicted per-env demand (modeled seconds the scheduler expected each
    # env to absorb, from peeked placement decisions) next to the realized
    # busy-seconds — the queue telemetry's forecast-vs-actual pair
    predicted_env_seconds: dict[str, float] = field(default_factory=dict)
    actual_env_seconds: dict[str, float] = field(default_factory=dict)
    # fleet plane: lifecycle + failure + recovery + autoscale telemetry
    failures: list[tuple[str, float]] = field(default_factory=list)
    recoveries: int = 0
    checkpoints: int = 0
    checkpoint_bytes: int = 0
    restored_bytes: int = 0
    scale_events: list[tuple[float, str, str]] = field(default_factory=list)
    lifecycle_events: list[tuple[float, str, str, str]] = field(
        default_factory=list)
    fault_events: list[tuple[float, str, str, str]] = field(
        default_factory=list)
    pruned_intervals: int = 0
    # transport plane: which transport each env's migration traffic rides
    env_transports: dict[str, str] = field(default_factory=dict)
    # live replication plane (zero when replication is off): ONE waste
    # ledger covers prefetch speculation and trickled-but-never-claimed
    trickled_bytes: int = 0
    trickle_claimed_bytes: int = 0
    wasted_speculation_bytes: int = 0
    # replica plane (zero with --replicas 0): fleet-wide sums
    replicated_bytes: int = 0
    replica_shared_bytes: int = 0
    promotions: int = 0
    races: int = 0
    race_waste_seconds: float = 0.0
    # cost plane (zero on an unpriced fleet): fleet-wide dollar meter and
    # SLO attainment (cell-weighted across sessions); ``preemptions`` counts
    # injected failures on spot (hazard-rated) envs
    compute_dollars: float = 0.0
    egress_dollars: float = 0.0
    total_dollars: float = 0.0
    preemptions: int = 0
    slo_attainment: float = 1.0
    total_queue_wait: float = field(init=False)
    total_think_time: float = field(init=False)
    prediction_hit_rate: float = field(init=False)

    def __post_init__(self):
        self.total_queue_wait = sum(s.queue_wait for s in self.sessions)
        self.total_think_time = sum(s.think_time for s in self.sessions)
        hits = sum(s.prediction_hits for s in self.sessions)
        total = sum(s.prediction_total for s in self.sessions)
        self.prediction_hit_rate = hits / total if total else 0.0


class _FleetView:
    """What placement policies see of the live fleet: per-env overhead =
    remaining provisioning cold-start + current expected queue wait."""

    def __init__(self, sched: "SessionScheduler"):
        self.sched = sched

    def overhead_seconds(self, env: str) -> float:
        sched = self.sched
        if env not in sched.registry:
            return 0.0
        e = sched.registry[env]
        now = sched._loop.now() if sched._loop is not None else 0.0
        overhead = 0.0
        if e.status == "provisioning":
            overhead += max(0.0, e.ready_at - now)
        wait = sched.arbiter.expected_wait(env, now)
        if wait == float("inf"):
            return wait
        return overhead + wait


class _RecoveryView:
    """What the price-aware placement DP sees of the fleet's recovery
    ladder: the expected (seconds, dollars) ONE preemption costs under the
    configured recovery mode — replica promotion (detection only; the
    follower already converged), checkpoint restore (detection + expected
    replay since the last save, half the checkpoint interval), or rerun
    (detection + expected half-plan replay at home).  Replay runs at the
    home env, so its seconds bill at the home price."""

    def __init__(self, sched: "SessionScheduler"):
        self.sched = sched
        self._plan_cache: float | None = None

    def _mean_plan_seconds(self) -> float:
        if self._plan_cache is None:
            totals = []
            for s in self.sched._sessions:
                nb = s.runtime.nb
                totals.append(sum(nb.cell(ref).cost or 0.0
                                  for ref in s.plan))
            self._plan_cache = (sum(totals) / len(totals)) if totals else 0.0
        return self._plan_cache

    def expected_recovery(self, env: str) -> tuple[float, float]:
        sched = self.sched
        detect = sched.detect_delay
        if sched.replica_cfg is not None:
            sec = detect
        elif sched.recovery == "checkpoint":
            sec = detect + sched.checkpoint_interval / 2.0
        else:
            sec = detect + self._mean_plan_seconds() / 2.0
        home = sched.registry[sched.registry.home]
        return sec, sec * home.price_per_hour / 3600.0


class SessionScheduler:
    """Multiplex N sessions over shared environments with per-env capacity.

    Sessions also share the fabric's *state plane*: every per-session env
    clone fronts the registry-level chunk store of the physical env it
    stands for, so when N sessions load the same dataset its chunks cross
    the wire once and every later session ships only a manifest
    (``share_chunks=False`` isolates the stores instead).

    ``run()`` drives everything on a discrete-event loop.  With the default
    knobs (no workload trace, no failures, no autoscaling) the event order
    is exactly the historical earliest-clock-first interleave; the fleet
    features are strictly additive:

    * ``add_notebook(..., arrival=, think=)`` / ``set_workload(trace)``
      give sessions arrival offsets and per-cell think-time gaps;
    * ``inject_failure(env, at)`` kills an env mid-flight; sessions on it
      recover via checkpoint restore (``enable_recovery("checkpoint")``)
      or by rerunning their plan from the start (``"rerun"``);
    * ``enable_autoscale(policy)`` provisions/culls pool envs from queue
      telemetry and attaches a fleet view so cost/horizon placement prices
      cold starts and queue depth.

    ``device`` (``"cuda"``, the default, or ``"cpu"``) is where the
    digests, chunk keys and quantization of every session run: a session
    added without a ``reducer`` gets its own ``StateReducer`` on it, one
    per session as the launcher gives them.  Asking for ``"cuda"`` without
    a card raises.
    """

    def __init__(self, registry: EnvironmentRegistry, *,
                 share_chunks: bool = True,
                 beat_interval: float = 1.0, miss_threshold: int = 3,
                 device="cuda"):
        self.registry = registry
        self.device = resolve_device(device)
        self.share_chunks = share_chunks
        self.arbiter = CapacityArbiter(registry)
        self.beat_interval = float(beat_interval)
        self.miss_threshold = int(miss_threshold)
        self._sessions: list[_Session] = []
        self._failures: list[tuple[str, float, float | None]] = []
        self._env_failures: dict[str, list[float]] = {}
        self.autoscale: AutoscalePolicy | None = None
        self.recovery: str | None = None       # checkpoint | rerun | None
        self.checkpoint_interval = 30.0
        self.ckpt_storage_name: str | None = None
        self.scale_events: list[tuple[float, str, str]] = []
        self.replication: dict | None = None
        self.replica_cfg: dict | None = None
        self._loop: EventLoop | None = None
        self._coord = None

    # -- fleet configuration -------------------------------------------
    def set_transport(self, env: str, kind: str, *, now: float = 0.0) -> None:
        """Transport plane: mark which transport carries migration traffic
        to ``env`` ("loopback" | "socket" | "subprocess").  The mark lands
        on the physical registry (audit-logged) and is mirrored into every
        session clone, so engines that later attach a live peer — and the
        report below — agree on the binding."""
        self.registry.set_transport(env, kind, now=now)
        for s in self._sessions:
            if env in s.runtime.registry:
                s.runtime.registry[env].transport = kind

    def env_transports(self) -> dict[str, str]:
        """Current transport binding per registered env."""
        return {n: getattr(e, "transport", "loopback")
                for n, e in self.registry.envs().items()}

    @property
    def detect_delay(self) -> float:
        """Failure-detection latency: the heartbeat protocol's miss window
        (``distributed/fault.py``: a worker missing ``miss_threshold``
        beats is declared dead)."""
        if self._coord is not None:
            return self._coord.detection_delay
        return self.beat_interval * self.miss_threshold

    def inject_failure(self, env: str, at: float,
                       recover_after: float | None = None) -> None:
        """Schedule env death at sim time ``at``; with ``recover_after`` the
        env re-provisions that many seconds later (cold start applies)."""
        if env == self.registry.home:
            raise ValueError("cannot fail the home environment")
        if env not in self.registry:
            raise KeyError(env)
        self._failures.append((env, float(at), recover_after))
        self._env_failures.setdefault(env, []).append(float(at))

    def enable_spot_hazards(self, *, seed: int = 0, horizon: float = 900.0,
                            recover_after: float | None = 20.0) -> int:
        """Draw seeded preemption times for every spot env (``hazard_rate
        > 0``) and inject them through the ordinary failure path — the
        heartbeat detector, recovery ladder and EnvFailure machinery treat
        a preemption exactly like any other env death.  Inter-preemption
        gaps are exponential at the env's hazard rate, pre-drawn from a
        per-env substream of ``seed`` out to ``horizon`` sim-seconds, so
        two runs with the same seed see identical preemptions.  With
        ``recover_after`` the capacity comes back that many seconds later
        (spot pools refill).  Returns the number injected."""
        import numpy as np
        injected = 0
        for i, name in enumerate(sorted(self.registry.names())):
            env = self.registry[name]
            if env.hazard_rate <= 0 or name == self.registry.home:
                continue
            rng = np.random.default_rng([int(seed), i])
            t = 0.0
            while True:
                t += float(rng.exponential(1.0 / env.hazard_rate))
                if t > horizon:
                    break
                self.inject_failure(name, t, recover_after=recover_after)
                injected += 1
        return injected

    def enable_recovery(self, mode: str = "checkpoint", *,
                        interval: float = 30.0,
                        storage: str = "fleet-ckpt") -> None:
        """``checkpoint``: periodic background saves into a storage env's
        CAS, restore + replay-since-checkpoint on failure.  ``rerun``:
        no checkpoints — a failed session replays its whole plan."""
        assert mode in ("checkpoint", "rerun"), mode
        self.recovery = mode
        self.checkpoint_interval = float(interval)
        if mode == "checkpoint":
            from repro_torch.core.fabric import ExecutionEnvironment
            if storage not in self.registry:
                self.registry.register(
                    ExecutionEnvironment(storage, kind="storage"))
            self.ckpt_storage_name = storage

    def enable_autoscale(self, policy: AutoscalePolicy) -> None:
        self.autoscale = policy

    def enable_replication(self, *, rate: float = 50e6, top_k: int = 2,
                           liveness: bool = True,
                           interval: float = 1.0) -> None:
        """Live replication: every session gets a background process on the
        event loop that wakes each ``interval`` seconds of think time and
        trickles dirty state to the top-k likely targets at ``rate`` bytes
        per second (the transport's low-priority lane).  ``liveness`` prunes
        provably-dead names from both trickle and full-state moves."""
        self.replication = {"rate": float(rate), "top_k": int(top_k),
                            "liveness": bool(liveness),
                            "interval": float(interval)}

    def enable_replicas(self, k: int = 1, *, followers: list[str] | None = None,
                        race: bool = False, race_band: float = 0.25,
                        race_threshold: float = 0.35, rate: float = 50e6,
                        interval: float = 1.0) -> None:
        """Replica plane: every session keeps ``k`` follower namespaces
        converged during think time (a background sync process on the event
        loop, mirroring the trickle proc) so a primary failure promotes the
        most-converged follower and replays only the unconverged tail —
        zero cells when it had caught up.  ``followers`` pins the follower
        envs explicitly; otherwise the first ``k`` non-home compute envs
        (sorted) follow each session.  ``race=True`` adds first-result-wins
        cell racing on top (see :class:`repro_torch.core.replica.SessionReplicaSet`).
        ``k=0`` without explicit followers is a no-op — today's behavior."""
        k = int(k)
        if k < 0:
            raise ValueError(f"replicas must be >= 0, got {k}")
        if followers is not None and len(set(followers)) != len(followers):
            raise ValueError(f"duplicate follower envs: {followers}")
        if k == 0 and not followers:
            self.replica_cfg = None
            return
        self.replica_cfg = {"k": k, "followers": list(followers or []),
                            "race": bool(race), "race_band": float(race_band),
                            "race_threshold": float(race_threshold),
                            "rate": float(rate), "interval": float(interval)}

    def _pick_followers(self, rt: HybridRuntime) -> list[str]:
        cfg = self.replica_cfg
        if cfg["followers"]:
            return [f for f in cfg["followers"] if f in rt.registry]
        cands = sorted(n for n, e in rt.registry.envs().items()
                       if e.kind == "compute" and n != rt.home)
        return cands[:cfg["k"]]

    # ------------------------------------------------------------------
    def add_session(self, runtime: HybridRuntime, plan, *,
                    arrival: float = 0.0,
                    think: list[float] | None = None) -> HybridRuntime:
        """Attach an existing runtime (it must gate through our arbiter)."""
        runtime.arbiter = self.arbiter
        self._sessions.append(_Session(runtime, list(plan), arrival=arrival,
                                       think=list(think or [])))
        return runtime

    def add_notebook(self, notebook: Notebook, plan=None, *,
                     arrival: float = 0.0, think: list[float] | None = None,
                     **runtime_kw) -> HybridRuntime:
        """Spawn a session on a private clone of the shared fabric topology."""
        reg = self.registry.clone_topology(
            share_chunk_stores=self.share_chunks)
        runtime_kw.setdefault(
            "session_id",
            f"s{len(self._sessions):03d}-{notebook.name}")
        if runtime_kw.get("reducer") is None:
            runtime_kw["reducer"] = StateReducer(device=self.device)
        rt = HybridRuntime(notebook, registry=reg, **runtime_kw)
        if plan is None:
            plan = list(range(len(notebook.cells)))
        return self.add_session(rt, plan, arrival=arrival, think=think)

    def set_workload(self, trace: WorkloadTrace) -> None:
        """Apply a workload trace to the sessions added so far, by index."""
        for i, s in enumerate(self._sessions):
            if i < len(trace.arrivals):
                s.arrival = float(trace.arrivals[i])
            if i < len(trace.think):
                s.think = list(trace.think[i])

    # ------------------------------------------------------------------
    @staticmethod
    def _note_predicted_load(s: _Session, cell_ref,
                             predicted: dict[str, float]) -> None:
        """Accumulate the env the cell's placement decision chose and its
        modeled duration into the forecast telemetry.  The decision is the
        one ``run_cell`` just made (``runtime.last_decision``) — the
        forecast is free, no second policy evaluation — while the *actual*
        side of the pair comes from the arbiter's realized busy-seconds
        (which diverge e.g. when a serialization failure forces home)."""
        rt = s.runtime
        d = rt.last_decision
        if d is None:
            return
        cell = rt.nb.cell(cell_ref)
        est = 0.0
        if d.env in rt.registry:
            # measured per-env history first (real .ipynb cells rarely carry
            # a declared cost), then declared-cost / speedup
            est = _modeled_exec_seconds(rt.analyzer, cell, d.env) or 0.0
        predicted[d.env] = predicted.get(d.env, 0.0) + est

    # -- lifecycle plumbing ---------------------------------------------
    def _set_status(self, name: str, status: str, now: float) -> None:
        """Transition the shared registry (audit-logged) and mirror the new
        state into every session's clone — the clones stand for the same
        physical environment."""
        self.registry.set_status(name, status, now=now)
        for s in self._sessions:
            if name in s.runtime.registry:
                clone = s.runtime.registry[name]
                clone.status = self.registry[name].status
                clone.ready_at = self.registry[name].ready_at

    def _fault_check(self, env: str, start: float, end: float) -> float | None:
        """Fault hook handed to every runtime: a failure instant inside the
        work window, or the window start when the env is already dead."""
        if env in self.registry and self.registry[env].status == "failed":
            return start
        for tf in self._env_failures.get(env, ()):
            if start <= tf < end:
                return tf
        return None

    def _fail_env(self, env: str, at: float, recover_after: float | None):
        if env not in self.registry:
            return
        if self.registry[env].status in ("failed", "down"):
            return
        self._set_status(env, "failed", at)
        if recover_after is not None:
            self._loop.call_at(at + recover_after, self._reprovision, env,
                               priority=-10)

    def _reprovision(self, env: str) -> None:
        now = self._loop.now()
        if env not in self.registry:
            return
        if self.registry[env].status not in ("failed", "down"):
            return
        self._set_status(env, "provisioning", now)
        # stale failure times at/before the re-provision can no longer
        # interrupt new work (windows always start at now or later)
        self._env_failures[env] = [
            t for t in self._env_failures.get(env, ()) if t > now]
        ready = self.registry[env].ready_at
        self._loop.call_at(ready, self._mark_up, env, priority=-10)

    def _mark_up(self, env: str) -> None:
        if env not in self.registry:
            return
        e = self.registry[env]
        now = self._loop.now()
        # a provision cycle interrupted by a failure leaves this event
        # stale: the re-provision pushed ready_at later, so only the event
        # that fires at (or after) the *current* ready_at may transition
        if e.status == "provisioning" and now >= e.ready_at - 1e-9:
            self._set_status(env, "up", now)
            # a fresh env's idle clock starts at readiness, not at t=0 —
            # otherwise it could be culled before it ever ran a cell
            self.arbiter.last_release[env] = max(
                self.arbiter.last_release.get(env, 0.0), now)

    # -- autoscale -------------------------------------------------------
    def _occupied(self, env: str) -> bool:
        return any(not s.done() and s.runtime.current_env == env
                   for s in self._sessions)

    def _autoscale_tick(self):
        if all(s.done() for s in self._sessions):
            # fleet drained: reclaim whatever burst capacity is still up
            # (idle-kernel reclamation), then stop the timer
            now = self._loop.now()
            for env in self.autoscale.pool:
                if env in self.registry \
                        and self.registry[env].status == "up":
                    self._set_status(env, "draining", now)
                    self._set_status(env, "down", now)
                    self.scale_events.append((now, "cull", env))
            return False
        now = self._loop.now()
        stats = {}
        for name, e in self.registry.envs().items():
            if e.kind != "compute":
                continue
            wait = (self.arbiter.expected_wait(name, now)
                    if e.status == "up" else 0.0)
            stats[name] = {
                "status": e.status,
                "expected_wait": wait,
                "idle_for": now - self.arbiter.last_release.get(name, 0.0),
                "idle_timeout": e.idle_timeout,
                "occupied": self._occupied(name),
            }
        for action, env in self.autoscale.decide(stats):
            if action == "provision":
                self._set_status(env, "provisioning", now)
                self._loop.call_at(self.registry[env].ready_at,
                                   self._mark_up, env, priority=-10)
            elif action == "cull":
                self._set_status(env, "draining", now)
                self._set_status(env, "down", now)
            self.scale_events.append((now, action, env))

    # -- heartbeats (audit trail via distributed/fault.py) ---------------
    def _beat(self):
        if all(s.done() for s in self._sessions):
            return False                  # fleet drained: stop the timer
        for name, e in self.registry.envs().items():
            if name in self._coord.workers and e.status not in ("failed",
                                                                "down"):
                self._coord.heartbeat(name)
        self._coord.check_failures()

    # -- checkpoints ------------------------------------------------------
    def _checkpoint_tick(self, s: _Session):
        if s.done():
            return False                  # stop this session's timer series
        if self._loop.now() < s.arrival:
            return None
        rt = s.runtime
        env = rt.registry[rt.current_env] if rt.current_env in rt.registry \
            else None
        if env is None or not env.placeable_now():
            return None                   # nothing trustworthy to capture
        nbytes = s.ckpt.save(s.cursor, self._loop.now())
        rt._emit(T.SESSION_CHECKPOINTED, None, cursor=s.cursor,
                 nbytes=nbytes, env=rt.current_env)
        return None

    # -- the session step process ----------------------------------------
    def _prune_arbiter(self) -> None:
        active = [max(s.runtime.clock.now(), s.arrival)
                  for s in self._sessions if not s.done()]
        if active:
            self.arbiter.prune(min(active))

    def _step(self, s: _Session, idx: int, predicted: dict[str, float]):
        if s.done():
            return
        gap = self._loop.now() - s.runtime.clock.now()
        if gap > 0:
            # arrival offset or think-time: the user was idle, the session
            # clock absorbs the gap (queue wait is tracked separately)
            s.runtime.clock.advance_to(self._loop.now())
            if s.cursor > 0:
                s.think_total += gap
        self._prune_arbiter()
        try:
            s.runtime.run_cell(s.plan[s.cursor])
        except EnvFailure as e:
            self._recover(s, idx, e, predicted)
            return
        self._note_predicted_load(s, s.plan[s.cursor], predicted)
        s.cursor += 1
        if s.done():
            return
        t_next = s.runtime.clock.now() + s.next_think()
        self._loop.call_at(t_next, self._step, s, idx, predicted,
                           priority=idx)

    def _trickle_proc(self, s: _Session):
        """Per-session background replication process on the event loop:
        wakes every ``interval`` seconds, and — only while the session is
        idle in think time (its clock has caught up to the loop) — trickles
        the dirty delta over the remaining plan's live set.  Budget accrual
        inside the replicator rate-limits the stream; the transport's
        low-priority lane keeps it out of interactive traffic's way."""
        interval = self.replication["interval"]
        while not s.done():
            yield interval
            if s.done():
                break
            rt = s.runtime
            now = self._loop.now()
            if now < s.arrival or rt.clock.now() > now + 1e-9:
                continue           # not arrived yet, or mid-cell
            remaining = [rt.nb.cell(ref).source
                         for ref in s.plan[s.cursor:]]
            s.rep.step(now, remaining_sources=remaining)

    def _replica_proc(self, s: _Session):
        """Per-session follower-convergence process: wakes every
        ``interval`` seconds of think time (same idle guard as the trickle
        proc) and ships the primary's committed delta to each follower,
        applying it there.  Runs at priority 1001 — after a same-instant
        trickle step — so whatever the trickle just banked at a follower is
        claimed manifest-only instead of re-serialized (the dedupe)."""
        interval = self.replica_cfg["interval"]
        while not s.done():
            yield interval
            if s.done():
                break
            rt = s.runtime
            now = self._loop.now()
            if now < s.arrival or rt.clock.now() > now + 1e-9:
                continue           # not arrived yet, or mid-cell
            s.replicas.sync(now)

    def _recover(self, s: _Session, idx: int, e: EnvFailure,
                 predicted: dict[str, float]) -> None:
        """Failure recovery: detection (heartbeat miss window), then — in
        preference order — follower promotion (replay only the unconverged
        tail), checkpoint restore + replay-since-checkpoint, or
        rerun-from-home."""
        s.recoveries += 1
        rt = s.runtime
        rt.recover_from_failure(e.env)
        rt.clock.advance(self.detect_delay)
        if s.replicas is not None:
            res = s.replicas.promote(e.env, rt.clock.now())
            if res is not None:
                _follower, replay = res
                s.cursor = max(0, s.cursor - replay)
                self._loop.call_at(rt.clock.now(), self._step, s, idx,
                                   predicted, priority=idx)
                return
        if self.recovery == "checkpoint" and s.ckpt is not None \
                and s.ckpt.saves > 0:
            wire, seconds = s.ckpt.restore(rt.clock.now())
            rt.clock.advance(seconds)
            s.cursor = min(s.ckpt.cursor, s.cursor)
            self._restored_bytes += wire
        else:
            s.cursor = 0               # rerun the whole plan from home
            rt.reset_for_replay()      # fresh namespaces: no double-exec state
        self._loop.call_at(rt.clock.now(), self._step, s, idx, predicted,
                           priority=idx)

    # ------------------------------------------------------------------
    def run(self) -> ScheduleReport:
        """Drive arrivals, cells, think-time, lifecycle, failures,
        checkpoints and autoscaling to completion on the event loop."""
        from repro_torch.distributed.fault import Coordinator

        loop = self._loop = EventLoop()
        self._restored_bytes = 0
        predicted: dict[str, float] = {n: 0.0 for n in self.registry.names()}
        dynamic = bool(self._failures or self.autoscale is not None
                       or any(s.arrival or s.think for s in self._sessions))
        if dynamic:
            for s in self._sessions:
                s.runtime.fault_check = self._fault_check
            self._coord = Coordinator(
                [n for n, e in self.registry.envs().items()
                 if e.kind == "compute"],
                clock=loop.clock, beat_interval=self.beat_interval,
                miss_threshold=self.miss_threshold)
            loop.every(self.beat_interval, self._beat, priority=-5)
        if dynamic:
            # live-fleet placement pricing: cost/horizon policies see the
            # remaining cold start of a provisioning env and each env's
            # current expected queue wait (the degenerate static fleet
            # stays unpriced — decisions bit-identical to the paper's)
            view = _FleetView(self)
            for s in self._sessions:
                s.runtime.analyzer.fleet_view = view
        if any(e.price_per_hour > 0 or e.hazard_rate > 0
               for e in self.registry.envs().values()):
            # cost plane: price-aware placement sees the recovery ladder so
            # a spot env's hazard is weighed at what a preemption actually
            # costs under the configured recovery mode (an unpriced fleet
            # attaches nothing — decisions bit-identical to the seed)
            rview = _RecoveryView(self)
            for s in self._sessions:
                s.runtime.analyzer.recovery_view = rview
        if self.autoscale is not None:
            loop.every(self.autoscale.check_interval, self._autoscale_tick,
                       priority=-5)
        if self.recovery == "checkpoint":
            storage = self.registry[self.ckpt_storage_name]
            for s in self._sessions:
                s.ckpt = SessionCheckpointer(s.runtime, storage)
                loop.every(self.checkpoint_interval, self._checkpoint_tick, s,
                           priority=-1, start_after=max(
                               s.arrival, self.checkpoint_interval))
        if self.replication is not None:
            cfg = self.replication
            for s in self._sessions:
                s.rep = s.runtime.attach_replicator(
                    rate=cfg["rate"], top_k=cfg["top_k"],
                    liveness=cfg["liveness"])
                # priority 1000: a same-instant session step always fires
                # first, so the trickle sees the post-cell namespace
                loop.process(self._trickle_proc(s), priority=1000,
                             delay=max(s.arrival, cfg["interval"]))
        if self.replica_cfg is not None:
            cfg = self.replica_cfg
            for s in self._sessions:
                followers = self._pick_followers(s.runtime)
                if not followers:
                    continue
                s.replicas = s.runtime.attach_replicas(
                    followers, race=cfg["race"],
                    race_band=cfg["race_band"],
                    race_threshold=cfg["race_threshold"], rate=cfg["rate"])
                loop.process(self._replica_proc(s), priority=1001,
                             delay=max(s.arrival, cfg["interval"]))
        for env, at, recover_after in self._failures:
            loop.call_at(at, self._fail_env, env, at, recover_after,
                         priority=-10)
        for idx, s in enumerate(self._sessions):
            loop.call_at(s.arrival, self._step, s, idx, predicted,
                         priority=idx)
        try:
            loop.run()
        finally:
            # every runtime closes — and its speculations cancel — even when
            # a cell raises mid-drain (bus subscribers must not leak)
            for s in self._sessions:
                s.runtime.close()
        slo = next((s.runtime.analyzer.slo for s in self._sessions
                    if s.runtime.analyzer.slo is not None), None)

        def _dollars(rt: HybridRuntime) -> tuple[float, float]:
            comp = sum(self.registry[e].price_per_hour * sec / 3600.0
                       for e, sec in rt.exec_env_seconds.items()
                       if e in self.registry)
            egress = sum(self.registry.transfer_dollars(m.src, m.dst, m.nbytes)
                         for m in rt.engine.log
                         if m.src in self.registry and m.dst in self.registry)
            return comp, egress

        def _attainment(rt: HybridRuntime) -> float:
            if slo is None or not rt.cell_latencies:
                return 1.0
            ok = sum(1 for lat in rt.cell_latencies if lat <= slo + 1e-9)
            return ok / len(rt.cell_latencies)

        reports = []
        for s in self._sessions:
            comp_d, egress_d = _dollars(s.runtime)
            reports.append(SessionReport(
                session=s.runtime.session_id,
                notebook=s.runtime.nb.name,
                cells_run=s.cursor,
                makespan=s.runtime.clock.now(),
                queue_wait=s.runtime.queue_wait,
                migrations=s.runtime.migrations,
                prediction_hits=s.runtime.prediction_hits,
                prediction_total=s.runtime.prediction_total,
                arrival=s.arrival,
                think_time=s.think_total,
                recoveries=s.recoveries,
                trickled_bytes=s.rep.trickled_bytes if s.rep else 0,
                trickle_claimed_bytes=s.rep.claimed_bytes if s.rep else 0,
                wasted_bytes=getattr(s.runtime.engine,
                                     "prefetch_wasted_bytes", 0),
                replica_lag=s.replicas.lag() if s.replicas else 0,
                replicated_bytes=(s.replicas.replicated_bytes
                                  if s.replicas else 0),
                replica_shared_bytes=(s.replicas.shared_bytes
                                      if s.replicas else 0),
                promotions=s.replicas.promotions if s.replicas else 0,
                races=s.replicas.races if s.replicas else 0,
                race_wins=dict(s.replicas.race_wins) if s.replicas else {},
                race_waste_seconds=(s.replicas.race_waste_seconds
                                    if s.replicas else 0.0),
                compute_dollars=comp_d,
                egress_dollars=egress_d,
                slo_attainment=_attainment(s.runtime)))
        util = {n: self.arbiter.utilization(n) for n in self.registry.names()}
        makespan = max((r.makespan for r in reports), default=0.0)
        return ScheduleReport(
            sessions=reports, env_utilization=util,
            queue_events=len(self.arbiter.queue_events),
            makespan=makespan,
            predicted_env_seconds=predicted,
            actual_env_seconds=dict(self.arbiter.busy_seconds),
            failures=[(env, at) for env, at, _ in self._failures],
            recoveries=sum(s.recoveries for s in self._sessions),
            checkpoints=sum(s.ckpt.saves for s in self._sessions if s.ckpt),
            checkpoint_bytes=sum(s.ckpt.bytes_written
                                 for s in self._sessions if s.ckpt),
            restored_bytes=self._restored_bytes,
            scale_events=list(self.scale_events),
            lifecycle_events=list(self.registry.lifecycle_log),
            fault_events=[(ev.time, ev.kind, ev.worker, ev.detail)
                          for ev in (self._coord.events if self._coord
                                     else [])],
            pruned_intervals=self.arbiter.pruned_intervals,
            env_transports=self.env_transports(),
            trickled_bytes=sum(r.trickled_bytes for r in reports),
            trickle_claimed_bytes=sum(r.trickle_claimed_bytes
                                      for r in reports),
            wasted_speculation_bytes=sum(r.wasted_bytes for r in reports),
            replicated_bytes=sum(r.replicated_bytes for r in reports),
            replica_shared_bytes=sum(r.replica_shared_bytes
                                     for r in reports),
            promotions=sum(r.promotions for r in reports),
            races=sum(r.races for r in reports),
            race_waste_seconds=sum(r.race_waste_seconds for r in reports),
            compute_dollars=sum(r.compute_dollars for r in reports),
            egress_dollars=sum(r.egress_dollars for r in reports),
            total_dollars=sum(r.dollars for r in reports),
            preemptions=sum(1 for env, _, _ in self._failures
                            if env in self.registry
                            and self.registry[env].hazard_rate > 0),
            slo_attainment=(
                sum(r.slo_attainment * len(s.runtime.cell_latencies)
                    for r, s in zip(reports, self._sessions))
                / max(1, sum(len(s.runtime.cell_latencies)
                             for s in self._sessions))
                if any(s.runtime.cell_latencies for s in self._sessions)
                else 1.0))
