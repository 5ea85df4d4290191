"""Environment fabric: N heterogeneous execution environments + links.

The paper's runtime moves notebook state between exactly two places (the
user's machine and one cloud node).  This module generalizes that dyad into
an *environment fabric*: an :class:`EnvironmentRegistry` holds any number of
heterogeneous :class:`ExecutionEnvironment`s (cpu-local, gpu-cloud, a TPU
mesh via ``DistContext``, a disk/checkpoint target) with per-pair
bandwidth/latency :class:`Link`s.  Placement policies, the migration engine
and the session scheduler all resolve environments and transfer costs
through the registry instead of hardcoded ``"local"``/``"remote"`` strings.

The paper's two-env setup is the smallest instance:
``EnvironmentRegistry.two_env()`` builds it, and ``from_envs()`` adapts the
legacy ``{"local": ..., "remote": ...}`` dict API.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Iterator

from repro_torch.core.chunkstore import DiskChunkStore, MemoryChunkStore
from repro_torch.core.state import ExecutionState


# lifecycle state machine: which transitions an environment may take.
# ``up`` is the default (and the paper's implicit state — its two envs are
# always on); everything else is fleet-plane machinery.
LIFECYCLE = {
    "provisioning": {"up", "failed", "down"},
    "up": {"draining", "failed", "down"},
    "draining": {"down", "failed", "up"},   # draining can be cancelled
    "down": {"provisioning"},
    "failed": {"provisioning"},
}


class ExecutionEnvironment:
    """A place code can run with its own namespace (§II): the user's machine,
    a cloud node, a JAX mesh (``DistContext``) — or a non-compute target such
    as disk, which the engine migrates to for checkpointing.

    Every environment fronts a content-addressed chunk store — the state
    plane's substrate: migration ships only chunks the target store lacks.
    ``kind="storage"`` environments back theirs with an on-disk CAS
    directory (``storage_dir``), which is how checkpointing *is* migration.

    Fleet lifecycle: ``status`` walks the :data:`LIFECYCLE` state machine
    (``provisioning → up → draining → down/failed``).  ``cold_start`` is the
    modeled seconds a provision takes before the env is usable; the fleet
    scheduler records ``ready_at`` when it starts one.  ``idle_timeout``
    (None = never) is how long the env may sit idle before the autoscaler
    culls it.  The default status is ``up``, so a registry that never
    touches the lifecycle behaves exactly as before.

    Cost plane: ``price_per_hour`` is what occupying this env costs in
    dollars per wall-clock hour (0 = free, the paper's implicit price).
    ``hazard_rate`` is the preemption hazard in events per *second* of
    uptime; a non-zero rate marks the env as spot/preemptible capacity —
    the scheduler draws seeded preemption times from it and the price-aware
    placement DP weighs it against the cheaper price tag."""

    def __init__(self, name: str, *, speedup: float = 1.0,
                 mesh_ctx=None, globals_seed: dict | None = None,
                 kind: str = "compute", chunk_store=None,
                 storage_dir: str | None = None, status: str = "up",
                 cold_start: float = 0.0, idle_timeout: float | None = None,
                 transport: str = "loopback", price_per_hour: float = 0.0,
                 hazard_rate: float = 0.0):
        assert status in LIFECYCLE, status
        self.name = name
        self.speedup = float(speedup)
        self.mesh_ctx = mesh_ctx
        self.kind = kind                 # compute | storage
        self.storage_dir = storage_dir
        self.status = status
        self.cold_start = float(cold_start)
        self.idle_timeout = idle_timeout
        self.ready_at = 0.0              # when a provisioning env comes up
        self.price_per_hour = float(price_per_hour)
        self.hazard_rate = float(hazard_rate)
        if self.price_per_hour < 0 or self.hazard_rate < 0:
            raise ValueError(
                f"env {name!r}: price_per_hour and hazard_rate must be >= 0")
        # transport plane: how migration traffic reaches this env.
        # "loopback" (default) = in-process, zero-copy, simulated timing —
        # the paper's setup.  "socket"/"subprocess" envs additionally carry
        # a ``peer`` (a transport.MigrationPeer) once one is attached; the
        # engine streams real wire frames through it.
        self.transport = transport
        self.peer = None
        if chunk_store is None:
            chunk_store = (DiskChunkStore(storage_dir) if storage_dir
                           else MemoryChunkStore())
        self.chunk_store = chunk_store
        self.state = ExecutionState(dict(globals_seed or {}))

    # -- lifecycle -------------------------------------------------------
    def set_status(self, status: str, *, now: float = 0.0) -> str:
        """Transition the lifecycle state machine; returns the old status.
        Illegal transitions raise (e.g. ``down`` cannot jump to ``up``
        without provisioning)."""
        if status == self.status:
            return status
        allowed = LIFECYCLE[self.status]
        if status not in allowed:
            raise ValueError(
                f"env {self.name!r}: illegal lifecycle transition "
                f"{self.status!r} -> {status!r} (allowed: {sorted(allowed)})")
        old, self.status = self.status, status
        if status == "provisioning":
            self.ready_at = now + self.cold_start
        return old

    def placeable_now(self) -> bool:
        """Whether new work may target this env: up, or provisioning (the
        cold-start wait is then priced into placement)."""
        return self.status in ("up", "provisioning")

    @property
    def spot(self) -> bool:
        """Preemptible capacity: a non-zero preemption hazard was declared."""
        return self.hazard_rate > 0.0

    def execute(self, source: str, cost: float | None = None) -> float:
        """Run real code against this env's namespace; return modeled seconds."""
        t0 = time.perf_counter()
        exec(compile(source, f"<{self.name}>", "exec"), self.state.ns)  # noqa: S102
        wall = time.perf_counter() - t0
        base = cost if cost is not None else wall
        return base / self.speedup

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ExecutionEnvironment({self.name!r}, speedup={self.speedup})"


@dataclass(frozen=True)
class Link:
    """Directed transfer cost between two environments.  ``transport``
    names which transport binding the pair's migration traffic rides
    (loopback = in-process simulated movement; socket = real framed TCP,
    optionally shaped).  The *cost model* is the same either way — real
    transports record measured wall time alongside the modeled seconds.

    Links are directed, so a pair may be asymmetric: cloud downlinks are
    commonly faster than uplinks, and providers bill *egress* — dollars per
    GB leaving the source — in one direction only.  ``egress_per_gb`` prices
    that; the default 0.0 keeps every pre-cost-plane topology free."""
    bandwidth: float = 1e9          # bytes/second
    latency: float = 0.5            # seconds per transfer
    transport: str = "loopback"
    egress_per_gb: float = 0.0      # dollars per 1e9 bytes crossing the link

    def transfer_seconds(self, nbytes: int | float) -> float:
        return self.latency + nbytes / self.bandwidth

    def transfer_dollars(self, nbytes: int | float) -> float:
        return self.egress_per_gb * nbytes / 1e9


class EnvironmentRegistry:
    """N environments + per-pair links + per-env capacity.

    One environment is the *home* (the paper's "local"): where the user
    sits, where sessions start, and where state returns after a block
    completes.  Links default to (``default_bandwidth``, ``default_latency``)
    so a registry behaves exactly like the legacy scalar-cost engine until
    pairs are given their own costs via :meth:`connect`.
    """

    def __init__(self, *, default_bandwidth: float = 1e9,
                 default_latency: float = 0.5):
        self._envs: dict[str, ExecutionEnvironment] = {}
        self._links: dict[tuple[str, str], Link] = {}
        self._capacity: dict[str, int] = {}
        self._placeable: dict[str, bool] = {}
        self.default_link = Link(default_bandwidth, default_latency)
        self.home: str | None = None
        # fleet-plane audit trail: (time, env, old_status, new_status)
        self.lifecycle_log: list[tuple[float, str, str, str]] = []

    # -- membership ----------------------------------------------------
    def register(self, env: ExecutionEnvironment, *, home: bool = False,
                 capacity: int = 1,
                 placeable: bool | None = None) -> ExecutionEnvironment:
        if env.name in self._envs:
            raise ValueError(f"environment {env.name!r} already registered")
        self._envs[env.name] = env
        self._capacity[env.name] = int(capacity)
        if placeable is None:
            placeable = env.kind == "compute"
        self._placeable[env.name] = bool(placeable)
        if home or self.home is None:
            self.home = env.name
        return env

    def retire(self, name: str) -> ExecutionEnvironment:
        """Remove an environment from the live registry (dynamic fleet
        membership): its links, capacity and placement eligibility go with
        it.  The home env cannot be retired — sessions start and return
        there."""
        if name == self.home:
            raise ValueError(f"cannot retire the home environment {name!r}")
        env = self._envs.pop(name)
        self._capacity.pop(name, None)
        self._placeable.pop(name, None)
        self._links = {pair: link for pair, link in self._links.items()
                       if name not in pair}
        return env

    def set_status(self, name: str, status: str, *,
                   now: float = 0.0) -> None:
        """Lifecycle transition with an audit-log entry (fleet plane)."""
        old = self._envs[name].set_status(status, now=now)
        if old != status:
            self.lifecycle_log.append((now, name, old, status))

    def set_transport(self, name: str, kind: str, *,
                      now: float = 0.0) -> None:
        """Mark which transport carries migration traffic to ``name``
        (fleet plane); audit-logged like a lifecycle transition."""
        from repro_torch.core.transport import TRANSPORTS
        if kind not in TRANSPORTS:
            raise ValueError(f"unknown transport {kind!r} "
                             f"(expected one of {TRANSPORTS})")
        env = self._envs[name]
        old = getattr(env, "transport", "loopback")
        env.transport = kind
        if old != kind:
            self.lifecycle_log.append(
                (now, name, f"transport:{old}", f"transport:{kind}"))

    def __getitem__(self, name: str) -> ExecutionEnvironment:
        return self._envs[name]

    def __contains__(self, name: str) -> bool:
        return name in self._envs

    def __len__(self) -> int:
        return len(self._envs)

    def __iter__(self) -> Iterator[str]:
        return iter(self._envs)

    def names(self) -> list[str]:
        return list(self._envs)

    def envs(self) -> dict[str, ExecutionEnvironment]:
        return dict(self._envs)

    def compute_envs(self) -> dict[str, ExecutionEnvironment]:
        """Environments cells may be *placed* on: excludes storage targets
        and envs whose lifecycle state is not placeable (down / failed /
        draining)."""
        return {n: e for n, e in self._envs.items()
                if self._placeable[n] and e.placeable_now()}

    def candidates(self) -> list[str]:
        """Placement candidates other than home, registration order."""
        return [n for n in self.compute_envs() if n != self.home]

    def capacity(self, name: str) -> int:
        return self._capacity[name]

    # -- links ----------------------------------------------------------
    def connect(self, a: str, b: str, *, bandwidth: float | None = None,
                latency: float | None = None, symmetric: bool = True,
                transport: str | None = None,
                egress_per_gb: float | None = None,
                reverse_bandwidth: float | None = None,
                reverse_latency: float | None = None,
                reverse_egress_per_gb: float | None = None) -> Link:
        """Set the a→b link.  ``symmetric=True`` (default) also sets b→a;
        pass any ``reverse_*`` override to make the pair asymmetric — the
        reverse direction then gets its own Link falling back to the
        forward values for anything not overridden."""
        link = Link(bandwidth if bandwidth is not None
                    else self.default_link.bandwidth,
                    latency if latency is not None
                    else self.default_link.latency,
                    transport if transport is not None
                    else self.default_link.transport,
                    egress_per_gb if egress_per_gb is not None
                    else self.default_link.egress_per_gb)
        self._links[(a, b)] = link
        asymmetric = (reverse_bandwidth is not None
                      or reverse_latency is not None
                      or reverse_egress_per_gb is not None)
        if symmetric:
            if asymmetric:
                self._links[(b, a)] = Link(
                    reverse_bandwidth if reverse_bandwidth is not None
                    else link.bandwidth,
                    reverse_latency if reverse_latency is not None
                    else link.latency,
                    link.transport,
                    reverse_egress_per_gb if reverse_egress_per_gb is not None
                    else link.egress_per_gb)
            else:
                self._links[(b, a)] = link
        return link

    def set_egress(self, a: str, b: str, per_gb: float, *,
                   symmetric: bool = False) -> None:
        """Price egress on an existing (or default) link without touching
        its bandwidth/latency.  Egress is directional by default — billing
        usually charges data *leaving* a provider, not entering it."""
        self._links[(a, b)] = replace(
            self.link(a, b), egress_per_gb=float(per_gb))
        if symmetric:
            self._links[(b, a)] = replace(
                self.link(b, a), egress_per_gb=float(per_gb))

    def link(self, src: str, dst: str) -> Link:
        if src == dst:
            return Link(float("inf"), 0.0)
        return self._links.get((src, dst), self.default_link)

    def transfer_seconds(self, src: str, dst: str, nbytes: int | float) -> float:
        if src == dst:
            return 0.0
        return self.link(src, dst).transfer_seconds(nbytes)

    def transfer_dollars(self, src: str, dst: str, nbytes: int | float) -> float:
        """Egress dollars for shipping ``nbytes`` src→dst (0 on self-pairs)."""
        if src == dst:
            return 0.0
        return self.link(src, dst).transfer_dollars(nbytes)

    def pairs(self) -> list[tuple[str, str]]:
        ns = self.names()
        return [(a, b) for a in ns for b in ns if a != b]

    def clone_topology(self, *,
                       share_chunk_stores: bool = True) -> "EnvironmentRegistry":
        """Same env names/speedups/links/capacities with *fresh namespaces*.

        The session scheduler gives each session a private clone (its own
        kernel namespaces) while a shared CapacityArbiter models the actual
        hardware the clones stand for.  By default the clones also share the
        original envs' chunk stores — content-addressed chunks are immutable,
        so N sessions loading the same dataset transfer its chunks once;
        pass ``share_chunk_stores=False`` to isolate the in-memory stores.
        Storage-backed envs keep pointing at their on-disk directory either
        way: the disk *is* the physical medium the clones stand for."""
        reg = EnvironmentRegistry(
            default_bandwidth=self.default_link.bandwidth,
            default_latency=self.default_link.latency)
        for name, env in self._envs.items():
            clone = ExecutionEnvironment(
                name, speedup=env.speedup, mesh_ctx=env.mesh_ctx,
                kind=env.kind, storage_dir=env.storage_dir,
                cold_start=env.cold_start, idle_timeout=env.idle_timeout,
                transport=getattr(env, "transport", "loopback"),
                price_per_hour=env.price_per_hour,
                hazard_rate=env.hazard_rate,
                chunk_store=env.chunk_store if share_chunk_stores
                else None)
            # lifecycle state carries over verbatim (the clone stands for
            # the same physical env); bypass the transition checker
            clone.status = env.status
            clone.ready_at = env.ready_at
            reg.register(
                clone,
                home=(name == self.home), capacity=self._capacity[name],
                placeable=self._placeable[name])
        reg._links = dict(self._links)
        return reg

    # -- constructors ----------------------------------------------------
    @classmethod
    def two_env(cls, *, remote_speedup: float = 10.0, bandwidth: float = 1e9,
                latency: float = 0.5) -> "EnvironmentRegistry":
        """The paper's local/remote dyad as the smallest fabric."""
        reg = cls(default_bandwidth=bandwidth, default_latency=latency)
        reg.register(ExecutionEnvironment("local"), home=True)
        reg.register(ExecutionEnvironment("remote", speedup=remote_speedup))
        return reg

    @classmethod
    def from_envs(cls, envs: dict[str, ExecutionEnvironment], *,
                  bandwidth: float = 1e9,
                  latency: float = 0.5) -> "EnvironmentRegistry":
        """Adapt the legacy ``{"local": ..., "remote": ...}`` dict API."""
        reg = cls(default_bandwidth=bandwidth, default_latency=latency)
        for name, env in envs.items():
            reg.register(env, home=(name == "local"))
        return reg
