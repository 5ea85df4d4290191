"""Run a Jupyter notebook file under the context-aware migration runtime.

    PYTHONPATH=src python -m repro_torch.launch.notebook path/to/nb.ipynb \\
        --sessions 3 --remote-speedup 10 --policy block \\
        [--model frequency|markov|recency|ensemble] \\
        [--bandwidth 1e9] [--latency 0.5] [--codec zlib] [--report out.json] \\
        [--env tpu-mesh:40:1] [--link local:tpu-mesh:1e8:1.0] [--pipeline] \\
        [--fleet 4] [--arrivals 0.2] [--think-time 5] [--seed 0] \\
        [--fail-env remote:30] [--autoscale] [--recovery checkpoint] \\
        [--transport loopback|socket] \\
        [--replicate] [--trickle-rate 50MB/s] [--liveness on|off] \\
        [--replicas K] [--race on|off] \\
        [--price remote:3.0] [--hazard spot:6/h] [--egress remote:local:0.09] \\
        [--slo 30] [--workload gpu-training|remote-sensing] \\
        [--device cuda|cpu]

The PyTorch counterpart of ``repro.launch.notebook``: every option of the
reference is accepted and does what it does there.  State digests, chunk
keys and the ``quant8+zstd`` codec run on ``--device`` (default ``cuda``:
the hand-written kernels; ``cpu``: their plain PyTorch versions), in every
fleet session's reducer and in a socket child too.  Asking for ``cuda``
without a card is an error.

``--transport socket`` is the two-process demo: the remote env runs as a
child Python process (``repro_torch.core.remote_worker``) and every
migration genuinely streams CRC-framed chunk traffic over TCP (cells
execute in the child; results round-trip home; knowledge probing is off).
The default ``loopback`` keeps the paper's in-process simulated movement.

``--replicate`` (fleet only) turns on background delta replication: while
the user "thinks" between cells, each session trickles its dirty state to
the most likely next environments at ``--trickle-rate`` bytes/second, so a
later migration ships only the residual delta.  ``--liveness off`` disables
the dead-name pruning that otherwise bounds what trickles and what
full-state return trips carry.

Cost plane: ``--price env:dollars_per_hour`` (repeatable) puts a price tag
on an env, ``--hazard env:rate[/h|/s]`` (fleet only, repeatable) marks it
as spot capacity with a seeded preemption hazard, ``--egress a:b:$per_gb``
(repeatable) prices data leaving a link, and ``--slo seconds`` states the
per-cell latency SLO.  Giving any of ``--price``/``--egress``/``--slo``
switches the horizon policy's DP to minimize *expected dollars subject to
the SLO* instead of seconds (``--hazard`` alone keeps the seconds
objective, so a spot fleet can be measured under both).  ``--workload
gpu-training|remote-sensing`` runs a built-in synthetic notebook family
instead of an .ipynb file.

``--replicas K`` (fleet only) turns on the replica plane: each session
keeps K follower namespaces converged during think time, so a primary
failure *promotes* the most-converged follower and replays only the
unconverged tail — zero cells when it had caught up — instead of paying a
checkpoint restore or a full rerun.  ``--race on`` adds first-result-wins
cell racing on top of the converged followers.  ``--replicas 0`` (the
default) is today's behavior exactly.

Cells execute for real (exec against the session namespace); timing follows
the paper's forced-speedup protocol when cells carry a
``metadata.repro.cost``, else measured wall time scaled by the env speedup.

By default this is the paper's local/remote dyad.  ``--env
name:speedup[:capacity[:down]]`` (repeatable) registers extra environments
(``down`` marks burst capacity the autoscaler may bring up) and ``--link
a:b:bw:lat`` gives a pair its own transfer cost; ``--policy cost`` scores
every env per cell.  ``--fleet N`` replays N concurrent sessions of the
notebook through the event-driven SessionScheduler over the shared fabric;
``--arrivals``/``--think-time`` draw a seeded Poisson workload trace,
``--fail-env name:time[:recover_after]`` kills an env mid-run (recovery via
``--recovery checkpoint|rerun``), and ``--autoscale`` lets the fleet
provision/cull the ``down`` envs from queue telemetry.

Prints the decision/migration report and writes the annotated notebook back
(explainability annotations land in ``metadata.repro.annotations``).
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.core import (
    AutoscalePolicy, EnvironmentRegistry, ExecutionEnvironment, HybridRuntime,
    Notebook, SessionScheduler, StateReducer, WorkloadTrace,
)
from repro_torch.device import resolve_device


def parse_env_spec(spec: str) -> tuple[str, float, int, str]:
    """``name:speedup[:capacity[:down]]`` -> (name, speedup, capacity,
    status); raises ValueError with a user-facing message on bad input."""
    parts = spec.split(":")
    name = parts[0]
    if not name:
        raise ValueError(f"--env {spec!r}: empty environment name")
    try:
        speedup = float(parts[1]) if len(parts) > 1 else 1.0
    except ValueError:
        raise ValueError(
            f"--env {spec!r}: speedup {parts[1]!r} is not a number "
            f"(expected name:speedup[:capacity[:down]])") from None
    try:
        cap = int(parts[2]) if len(parts) > 2 else 1
    except ValueError:
        raise ValueError(
            f"--env {spec!r}: capacity {parts[2]!r} is not an integer "
            f"(expected name:speedup[:capacity[:down]])") from None
    status = "up"
    if len(parts) > 3:
        if parts[3] not in ("up", "down"):
            raise ValueError(
                f"--env {spec!r}: status {parts[3]!r} must be 'up' or "
                f"'down' (down = burst capacity for --autoscale)")
        status = parts[3]
    return name, speedup, cap, status


def parse_link_spec(spec: str) -> tuple[str, str, float, float]:
    """``a:b:bandwidth:latency`` -> parts; friendly errors on bad shape."""
    parts = spec.split(":")
    if len(parts) != 4:
        raise ValueError(
            f"--link {spec!r}: expected a:b:bandwidth:latency "
            f"(got {len(parts)} field(s))")
    a, b, bw, lat = parts
    try:
        return a, b, float(bw), float(lat)
    except ValueError:
        raise ValueError(
            f"--link {spec!r}: bandwidth/latency must be numbers "
            f"(got {bw!r}, {lat!r})") from None


def parse_fail_spec(spec: str) -> tuple[str, float, float | None]:
    """``env:time[:recover_after]`` -> (env, at, recover_after|None)."""
    parts = spec.split(":")
    if len(parts) not in (2, 3):
        raise ValueError(
            f"--fail-env {spec!r}: expected env:time[:recover_after]")
    try:
        at = float(parts[1])
        rec = float(parts[2]) if len(parts) == 3 else None
    except ValueError:
        raise ValueError(
            f"--fail-env {spec!r}: time/recover_after must be numbers") \
            from None
    return parts[0], at, rec


_RATE_UNITS = {"": 1.0, "B": 1.0, "KB": 1e3, "MB": 1e6, "GB": 1e9}


def parse_rate_spec(spec: str) -> float:
    """``--trickle-rate`` value -> bytes/second.  Accepts a plain number
    (bytes/s) or a number with a KB/MB/GB suffix and an optional ``/s``
    (``50MB/s``, ``1.5GB``); friendly errors on anything else."""
    s = spec.strip()
    body = s[:-2] if s.upper().endswith("/S") else s
    num = body.rstrip("BKMGbkmg")
    unit = body[len(num):].upper()
    if unit not in _RATE_UNITS:
        raise ValueError(
            f"--trickle-rate {spec!r}: unknown unit {unit!r} "
            f"(expected B, KB, MB or GB, e.g. 50MB/s)")
    try:
        rate = float(num) * _RATE_UNITS[unit]
    except ValueError:
        raise ValueError(
            f"--trickle-rate {spec!r}: {num!r} is not a number "
            f"(expected e.g. 50MB/s, 1e6, 200KB)") from None
    if rate <= 0:
        raise ValueError(
            f"--trickle-rate {spec!r}: rate must be positive")
    return rate


def parse_price_spec(spec: str) -> tuple[str, float]:
    """``env:dollars_per_hour`` -> (env, price); friendly errors."""
    parts = spec.split(":")
    if len(parts) != 2 or not parts[0]:
        raise ValueError(
            f"--price {spec!r}: expected env:dollars_per_hour "
            f"(e.g. remote:3.0)")
    try:
        price = float(parts[1])
    except ValueError:
        raise ValueError(
            f"--price {spec!r}: {parts[1]!r} is not a number "
            f"(dollars per hour, e.g. remote:3.0)") from None
    if price < 0:
        raise ValueError(f"--price {spec!r}: price must be >= 0")
    return parts[0], price


def parse_hazard_spec(spec: str) -> tuple[str, float]:
    """``env:rate[/h|/s]`` -> (env, preemptions per *second*).  The rate
    defaults to per-hour — ``spot:6/h`` (or just ``spot:6``) is one
    expected preemption every 10 minutes; ``/s`` gives it per-second."""
    parts = spec.split(":")
    if len(parts) != 2 or not parts[0]:
        raise ValueError(
            f"--hazard {spec!r}: expected env:rate[/h|/s] (e.g. spot:6/h)")
    body = parts[1].strip()
    per_second = False
    if body.lower().endswith("/s"):
        per_second, body = True, body[:-2]
    elif body.lower().endswith("/h"):
        body = body[:-2]
    try:
        rate = float(body)
    except ValueError:
        raise ValueError(
            f"--hazard {spec!r}: {body!r} is not a number "
            f"(preemption rate, e.g. spot:6/h or spot:0.002/s)") from None
    if rate < 0:
        raise ValueError(f"--hazard {spec!r}: rate must be >= 0")
    return parts[0], rate if per_second else rate / 3600.0


def parse_egress_spec(spec: str) -> tuple[str, str, float]:
    """``a:b:dollars_per_gb`` -> (src, dst, per_gb); friendly errors."""
    parts = spec.split(":")
    if len(parts) != 3 or not parts[0] or not parts[1]:
        raise ValueError(
            f"--egress {spec!r}: expected src:dst:dollars_per_gb "
            f"(e.g. remote:local:0.09)")
    try:
        per_gb = float(parts[2])
    except ValueError:
        raise ValueError(
            f"--egress {spec!r}: {parts[2]!r} is not a number "
            f"(dollars per GB, e.g. remote:local:0.09)") from None
    if per_gb < 0:
        raise ValueError(f"--egress {spec!r}: egress price must be >= 0")
    return parts[0], parts[1], per_gb


def build_registry(*, remote_speedup: float = 10.0, bandwidth: float = 1e9,
                   latency: float = 0.5, extra_envs=(), links=(),
                   cold_start: float = 5.0,
                   idle_timeout: float = 60.0,
                   transport: str = "loopback",
                   prices=(), hazards=(), egress=(),
                   device="cuda") -> EnvironmentRegistry:
    """Two-env default plus any ``name:speedup[:capacity[:down]]`` extras
    and ``a:b:bandwidth:latency`` link overrides.  ``down`` envs get the
    fleet ``cold_start``/``idle_timeout`` knobs — they're the autoscaler's
    burst pool.  ``transport="socket"`` is the two-process demo: the remote
    env becomes a real child Python process (SubprocessEnv) whose reducer
    runs on ``device``, and every migration streams wire frames over TCP."""
    reg = EnvironmentRegistry(default_bandwidth=bandwidth,
                              default_latency=latency)
    reg.register(ExecutionEnvironment("local"), home=True, capacity=8)
    if transport == "socket":
        from repro_torch.core.transport import SubprocessEnv
        reg.register(SubprocessEnv("remote", speedup=remote_speedup,
                                   device=device),
                     capacity=4)
    else:
        reg.register(ExecutionEnvironment("remote", speedup=remote_speedup),
                     capacity=4)
    for spec in extra_envs:
        name, speedup, cap, status = parse_env_spec(spec)
        if name in reg:
            raise ValueError(
                f"--env {spec!r}: duplicate environment name {name!r} "
                f"(registered: {', '.join(reg.names())})")
        kw = {}
        if status == "down":
            kw = {"status": "down", "cold_start": cold_start,
                  "idle_timeout": idle_timeout}
        reg.register(ExecutionEnvironment(name, speedup=speedup, **kw),
                     capacity=cap)
    for spec in links:
        a, b, bw, lat = parse_link_spec(spec)
        for end in (a, b):
            if end not in reg:
                raise ValueError(
                    f"--link {spec!r}: unknown environment {end!r} "
                    f"(registered: {', '.join(reg.names())})")
        reg.connect(a, b, bandwidth=bw, latency=lat)
    # cost plane: env price tags, spot preemption hazards, link egress
    for spec in prices:
        name, price = parse_price_spec(spec)
        if name not in reg:
            raise ValueError(
                f"--price {spec!r}: unknown environment {name!r} "
                f"(registered: {', '.join(reg.names())})")
        reg[name].price_per_hour = price
    for spec in hazards:
        name, rate = parse_hazard_spec(spec)
        if name not in reg:
            raise ValueError(
                f"--hazard {spec!r}: unknown environment {name!r} "
                f"(registered: {', '.join(reg.names())})")
        if name == reg.home:
            raise ValueError(
                f"--hazard {spec!r}: the home environment cannot be "
                f"preempted (sessions live there)")
        reg[name].hazard_rate = rate
    for spec in egress:
        a, b, per_gb = parse_egress_spec(spec)
        for end in (a, b):
            if end not in reg:
                raise ValueError(
                    f"--egress {spec!r}: unknown environment {end!r} "
                    f"(registered: {', '.join(reg.names())})")
        reg.set_egress(a, b, per_gb)
    return reg


def _timed(rt: HybridRuntime, spent: list) -> None:
    """Accumulate the host wall seconds of every ``run_cell`` of ``rt``
    (its cells and migrations) into ``spent[0]``."""
    run_cell = rt.run_cell

    def timed(ref):
        t0 = time.perf_counter()
        try:
            return run_cell(ref)
        finally:
            spent[0] += time.perf_counter() - t0

    rt.run_cell = timed


def _migration_log(rt: HybridRuntime) -> list[dict]:
    return [{"src": m.src, "dst": m.dst, "names": list(m.names),
             "nbytes": m.nbytes, "seconds": m.seconds, "noop": m.noop}
            for m in rt.engine.log]


def run_notebook(path: str, *, sessions: int = 3, remote_speedup: float = 10.0,
                 policy: str = "block", use_knowledge: bool = True,
                 bandwidth: float = 1e9, latency: float = 0.5,
                 codec: str = "zlib", extra_envs=(), links=(),
                 pipeline: bool = False, fleet: int = 0,
                 model: str | None = None,
                 arrivals: float = 0.0, think_time: float = 0.0,
                 seed: int = 0, fail_envs=(), autoscale: bool = False,
                 recovery: str | None = None,
                 checkpoint_interval: float = 30.0,
                 transport: str = "loopback",
                 replicate: bool = False, trickle_rate: float = 50e6,
                 liveness: bool = True, replicas: int = 0,
                 race: bool = False, prices=(), hazards=(), egress=(),
                 slo: float | None = None,
                 workload: str | None = None,
                 device="cuda") -> tuple[dict, Notebook]:
    """The notebook at ``path`` (or the ``workload`` family) run
    ``sessions`` times over in one session, or, with ``fleet`` N, as N
    concurrent sessions through the :class:`SessionScheduler`; returns
    ``(report, annotated notebook)``.

    The report carries the reference's keys plus the reducer's ``device``
    and the chunks each env's store holds at the end (``chunks_held``).
    A single session adds ``migration_log``, one entry per migration in
    order; a fleet adds each session's ``cells_run``, ``migrated_bytes``,
    ``replicated_bytes``, reducer ``device`` and host ``wall_seconds`` to
    ``per_session``, its migration log to ``migration_logs`` and every
    env's chunk keys to ``chunk_keys``."""
    def load_notebook() -> Notebook:
        if workload is not None:
            from repro_torch.core import (gpu_training_notebook,
                                          remote_sensing_notebook)
            factory = {"gpu-training": gpu_training_notebook,
                       "remote-sensing": remote_sensing_notebook}[workload]
            return factory()
        with open(path) as f:
            return Notebook.from_ipynb(json.load(f))

    nb = load_notebook()
    # any priced dimension switches the placement objective to expected
    # dollars under the SLO; --hazard alone keeps the seconds objective so
    # a spot fleet can be measured under both
    objective = "dollars" if (prices or egress or slo is not None) \
        else "seconds"
    if transport == "socket":
        if fleet:
            raise ValueError(
                "--transport socket is the two-process demo mode and is "
                "incompatible with --fleet (the fleet plane marks env "
                "transports declaratively instead)")
        # Algorithm-2 probing snapshots the env namespace, which for a
        # subprocess env lives in the child: knowledge probing stays off
        use_knowledge = False
    # resolved once, before any child is spawned: every reducer of the run
    # (each fleet session's, a socket child's) lives on this device
    dev = resolve_device(device)
    reducer = None if fleet else StateReducer(codec=codec, device=dev)
    registry = build_registry(remote_speedup=remote_speedup,
                              bandwidth=bandwidth, latency=latency,
                              extra_envs=extra_envs, links=links,
                              transport=transport, prices=prices,
                              hazards=hazards, egress=egress, device=dev)
    code = [c for c in nb.cells if c.cell_type == "code"]

    if hazards and not fleet:
        raise ValueError(
            "--hazard needs --fleet: preemptions are injected through the "
            "scheduler's failure machinery (try --fleet 2 --recovery "
            "checkpoint)")

    if replicate and not fleet:
        raise ValueError(
            "--replicate needs --fleet: think-time trickling runs as a "
            "background process on the scheduler's event loop")
    if replicas and not fleet:
        raise ValueError(
            "--replicas needs --fleet: follower convergence runs as a "
            "background process on the scheduler's event loop")

    if fleet:
        sched = SessionScheduler(registry, device=dev)
        if replicate:
            sched.enable_replication(rate=trickle_rate, liveness=liveness)
        if replicas:
            sched.enable_replicas(replicas, race=race)
        if recovery:
            sched.enable_recovery(recovery, interval=checkpoint_interval)
        if autoscale:
            pool = [n for n, e in registry.envs().items()
                    if e.status == "down"]
            if not pool:
                raise ValueError(
                    "--autoscale needs at least one burst env "
                    "(--env name:speedup:capacity:down)")
            sched.enable_autoscale(AutoscalePolicy(pool))
        for env, at, rec in fail_envs:
            sched.inject_failure(env, at, recover_after=rec)
        # plan by index: re-parsed notebooks regenerate ids for cells that
        # have none in the file, so cell_ids don't survive a second parse
        plan = [i for i, c in enumerate(nb.cells)
                if c.cell_type == "code"] * sessions
        runtimes, walls = [], []
        for _ in range(fleet):
            session_nb = load_notebook()
            rt = sched.add_notebook(
                session_nb, plan=plan,
                reducer=StateReducer(codec=codec, device=dev),
                policy=policy, use_knowledge=use_knowledge,
                pipeline=pipeline, model=model,
                objective=objective, slo=slo)
            runtimes.append(rt)
            walls.append([0.0])
            _timed(rt, walls[-1])
        if any(e.hazard_rate > 0 for e in registry.envs().values()):
            sched.enable_spot_hazards(seed=seed)
        if arrivals or think_time:
            sched.set_workload(WorkloadTrace.poisson(
                fleet, rate=arrivals, think_mean=think_time,
                cells_per_session=len(plan), seed=seed))
        rep = sched.run()
        report = {
            "notebook": nb.name,
            "fleet": fleet,
            "sessions_each": sessions,
            "policy": policy,
            "model": model or "frequency",
            "makespan": rep.makespan,
            "total_queue_wait": rep.total_queue_wait,
            "total_think_time": rep.total_think_time,
            "queue_events": rep.queue_events,
            "env_utilization": rep.env_utilization,
            "prediction_hit_rate": rep.prediction_hit_rate,
            "predicted_env_seconds": rep.predicted_env_seconds,
            "actual_env_seconds": rep.actual_env_seconds,
            "failures": rep.failures,
            "recoveries": rep.recoveries,
            "checkpoints": rep.checkpoints,
            "checkpoint_bytes": rep.checkpoint_bytes,
            "restored_bytes": rep.restored_bytes,
            "scale_events": rep.scale_events,
            "lifecycle_events": rep.lifecycle_events,
            "replicate": replicate,
            "trickled_bytes": rep.trickled_bytes,
            "trickle_claimed_bytes": rep.trickle_claimed_bytes,
            "wasted_speculation_bytes": rep.wasted_speculation_bytes,
            "replicas": replicas,
            "replicated_bytes": rep.replicated_bytes,
            "replica_shared_bytes": rep.replica_shared_bytes,
            "promotions": rep.promotions,
            "races": rep.races,
            "race_waste_seconds": rep.race_waste_seconds,
            "objective": objective,
            "slo": slo,
            "total_dollars": rep.total_dollars,
            "compute_dollars": rep.compute_dollars,
            "egress_dollars": rep.egress_dollars,
            "preemptions": rep.preemptions,
            "slo_attainment": rep.slo_attainment,
            "per_session": [
                {"session": s.session[:12], "makespan": s.makespan,
                 "arrival": s.arrival, "think_time": s.think_time,
                 "queue_wait": s.queue_wait, "migrations": s.migrations,
                 "recoveries": s.recoveries,
                 "dollars": s.dollars,
                 "slo_attainment": s.slo_attainment,
                 "trickled_bytes": s.trickled_bytes,
                 "trickle_claimed_bytes": s.trickle_claimed_bytes,
                 "replica_lag": s.replica_lag,
                 "promotions": s.promotions,
                 "races": s.races, "race_wins": s.race_wins,
                 "race_waste_seconds": s.race_waste_seconds,
                 "prediction_hit_rate": s.prediction_hit_rate,
                 "cells_run": s.cells_run,
                 "migrated_bytes": sum(m.nbytes for m in rt.engine.log),
                 "replicated_bytes": s.replicated_bytes,
                 "device": str(rt.reducer.device),
                 "wall_seconds": wall[0]}
                for s, rt, wall in zip(rep.sessions, runtimes, walls)],
            "device": str(dev),
            "chunks_held": {n: len(e.chunk_store)
                            for n, e in registry.envs().items()},
            "chunk_keys": {n: sorted(f"{d:016x}"
                                  for d in e.chunk_store.digests())
                           for n, e in registry.envs().items()},
            "migration_logs": {s.session: _migration_log(rt)
                               for s, rt in zip(rep.sessions, runtimes)},
        }
        return report, nb

    rt = None
    try:
        rt = HybridRuntime(
            nb, registry=registry, reducer=reducer,
            policy=policy, use_knowledge=use_knowledge, pipeline=pipeline,
            model=model, objective=objective, slo=slo)
        for _ in range(sessions):
            for cell in code:
                rt.run_cell(cell.cell_id)
    finally:
        if rt is not None:
            rt.close()
        for env in registry.envs().values():
            if hasattr(env, "close"):      # tear down subprocess envs
                env.close()

    local_only = sessions * sum(
        c.cost if c.cost is not None else 0.0 for c in code)
    report = {
        "notebook": nb.name,
        "sessions": sessions,
        "policy": policy,
        "environments": registry.names(),
        "modeled_seconds": rt.clock.now(),
        "local_only_seconds": local_only or None,
        "speedup_vs_local": (local_only / rt.clock.now()
                             if local_only and rt.clock.now() else None),
        "model": rt.context.model.name,
        "migrations": rt.migrations,
        "migrated_bytes": sum(m.nbytes for m in rt.engine.log),
        "transport": transport,
        "wire_frames": sum(m.wire_frames for m in rt.engine.log),
        "transfer_wall_seconds": sum(m.wall_seconds for m in rt.engine.log),
        "prefetch_hits": getattr(rt.engine, "prefetch_hits", 0),
        "prefetch_wasted_bytes": getattr(rt.engine,
                                         "prefetch_wasted_bytes", 0),
        "prediction_hit_rate": rt.prediction_hit_rate,
        "objective": objective,
        "slo": slo,
        "compute_dollars": sum(
            getattr(registry[e], "price_per_hour", 0.0) * sec / 3600.0
            for e, sec in rt.exec_env_seconds.items() if e in registry),
        "egress_dollars": sum(
            registry.transfer_dollars(m.src, m.dst, m.nbytes)
            for m in rt.engine.log),
        "slo_attainment": (
            sum(1 for lat in rt.cell_latencies if lat <= slo + 1e-9)
            / len(rt.cell_latencies)
            if slo is not None and rt.cell_latencies else 1.0),
        "decisions": {c.cell_id: c.annotations[-1] if c.annotations else None
                      for c in code},
        "provenance_records": len(rt.kb.provenance),
        "device": str(rt.engine.reducer.device),
        "chunks_held": {n: len(e.chunk_store)
                        for n, e in registry.envs().items()},
        "migration_log": _migration_log(rt),
    }
    return report, nb


# report keys too long for the terminal (kept in --report)
_NOT_PRINTED = ("decisions", "migration_log", "migration_logs", "chunk_keys")


class _OnceAction(argparse.Action):
    """Reject a flag given more than once (a silently-overridden repeat of
    ``--replicas`` is almost always a typo in a long fleet command line)."""

    def __call__(self, parser, namespace, values, option_string=None):
        if getattr(namespace, f"_seen_{self.dest}", False):
            parser.error(f"{option_string} given more than once "
                         f"(got {getattr(namespace, self.dest)!r} "
                         f"then {values!r})")
        setattr(namespace, f"_seen_{self.dest}", True)
        setattr(namespace, self.dest, values)



def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("notebook", nargs="?", default=None,
                    help=".ipynb path (omit when using --workload)")
    ap.add_argument("--workload",
                    choices=["gpu-training", "remote-sensing"],
                    default=None,
                    help="built-in notebook family instead of an .ipynb "
                         "path: gpu-training (GPU-heavy train loop) or "
                         "remote-sensing (data-gravity pipeline)")
    ap.add_argument("--sessions", type=int, default=3)
    ap.add_argument("--remote-speedup", type=float, default=10.0)
    ap.add_argument("--policy",
                    choices=["single", "block", "cost", "horizon"],
                    default="block")
    ap.add_argument("--model",
                    choices=["frequency", "markov", "recency", "ensemble"],
                    default=None,
                    help="interaction model (default: the paper's "
                         "Algorithm-1 frequency miner)")
    ap.add_argument("--no-knowledge", action="store_true")
    ap.add_argument("--bandwidth", type=float, default=1e9)
    ap.add_argument("--latency", type=float, default=0.5)
    ap.add_argument("--codec", default="zlib")
    ap.add_argument("--env", action="append", default=[],
                    help="extra environment: name:speedup[:capacity[:down]] "
                         "(down = burst pool for --autoscale)")
    ap.add_argument("--link", action="append", default=[],
                    help="pair link override: a:b:bandwidth:latency")
    ap.add_argument("--pipeline", action="store_true",
                    help="pipelined engine (prefetch overlaps execution)")
    ap.add_argument("--transport", choices=["loopback", "socket"],
                    default="loopback",
                    help="how migration traffic moves: loopback = "
                         "in-process, zero-copy, simulated timing (the "
                         "paper's setup, default); socket = two-process "
                         "demo — the remote env is a child Python process "
                         "and every migration streams CRC-framed chunks "
                         "over real TCP (incompatible with --fleet)")
    ap.add_argument("--fleet", type=int, default=0,
                    help="run N concurrent sessions through the scheduler")
    ap.add_argument("--arrivals", type=float, default=0.0,
                    help="fleet: Poisson session-arrival rate per second")
    ap.add_argument("--think-time", type=float, default=0.0,
                    help="fleet: mean think-time gap between cells (s)")
    ap.add_argument("--seed", type=int, default=0,
                    help="fleet: workload-trace seed (determinism)")
    ap.add_argument("--fail-env", action="append", default=[],
                    help="fleet: kill env mid-run: env:time[:recover_after]")
    ap.add_argument("--recovery", choices=["checkpoint", "rerun"],
                    default=None,
                    help="fleet: failure-recovery mode (checkpoint = "
                         "periodic CAS checkpoints + restore)")
    ap.add_argument("--checkpoint-interval", type=float, default=30.0)
    ap.add_argument("--autoscale", action="store_true",
                    help="fleet: provision/cull 'down' burst envs from "
                         "queue telemetry")
    ap.add_argument("--replicate", action="store_true",
                    help="fleet: trickle dirty state to likely targets "
                         "during think time (background delta replication; "
                         "decision-time migrations ship only the residual)")
    ap.add_argument("--trickle-rate", default=None, metavar="RATE",
                    help="replication rate limit, e.g. 50MB/s, 1e6, 200KB "
                         "(default 50MB/s; requires --replicate)")
    ap.add_argument("--liveness", choices=["on", "off"], default="on",
                    help="prune provably-dead names from trickle and "
                         "full-state moves (live-variable analysis over "
                         "the remaining cells; default on)")
    ap.add_argument("--replicas", type=int, default=0, metavar="K",
                    action=_OnceAction,
                    help="fleet: keep K follower namespaces converged "
                         "during think time; a primary failure promotes "
                         "the most-converged follower with zero replay "
                         "(0 = off, today's behavior)")
    ap.add_argument("--race", choices=["on", "off"], default="off",
                    help="first-result-wins cell racing on converged "
                         "followers (requires --replicas >= 1)")
    ap.add_argument("--price", action="append", default=[],
                    metavar="ENV:DOLLARS_PER_HOUR",
                    help="cost plane: hourly compute price for an env, "
                         "e.g. remote:3.0 (any price switches the horizon "
                         "DP to minimize expected dollars)")
    ap.add_argument("--hazard", action="append", default=[],
                    metavar="ENV:RATE[/h|/s]",
                    help="cost plane: spot-preemption hazard rate, e.g. "
                         "spot:6/h (requires --fleet; preemptions are "
                         "seeded and deterministic)")
    ap.add_argument("--egress", action="append", default=[],
                    metavar="SRC:DST:DOLLARS_PER_GB",
                    help="cost plane: per-GB egress price on a directed "
                         "link, e.g. remote:local:0.09")
    ap.add_argument("--slo", type=float, default=None, metavar="SECONDS",
                    help="cost plane: per-cell latency SLO; the dollars DP "
                         "only considers placements whose expected per-cell "
                         "latency stays within this bound")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where digests, chunk keys and quantization run, "
                         "in every session and in a socket child: cuda = "
                         "the hand-written kernels (default), cpu = their "
                         "plain PyTorch versions")
    ap.add_argument("--report", default=None)
    ap.add_argument("--write-annotated", default=None,
                    help="write the notebook back with decision annotations")
    args = ap.parse_args(argv)

    try:
        # validate every spec up front (duplicate env names, malformed
        # floats, unknown envs) so mistakes die as friendly argparse
        # errors — runtime failures below keep their real tracebacks
        if args.notebook is None and args.workload is None:
            raise ValueError(
                "give a notebook path or pick a built-in family with "
                "--workload gpu-training|remote-sensing")
        if args.notebook is not None and args.workload is not None:
            raise ValueError(
                "--workload replaces the notebook path; give one or the "
                "other, not both")
        if args.slo is not None and args.slo <= 0:
            raise ValueError(
                f"--slo must be a positive number of seconds "
                f"(got {args.slo})")
        fail_envs = [parse_fail_spec(s) for s in args.fail_env]
        reg = build_registry(remote_speedup=args.remote_speedup,
                             bandwidth=args.bandwidth, latency=args.latency,
                             extra_envs=args.env, links=args.link,
                             prices=args.price, hazards=args.hazard,
                             egress=args.egress)
        if args.hazard and not args.fleet:
            raise ValueError(
                "--hazard needs --fleet: seeded preemptions run on the "
                "scheduler's event loop (try --fleet 2)")
        for env, _at, _rec in fail_envs:
            if env not in reg:
                raise ValueError(
                    f"--fail-env: unknown environment {env!r} "
                    f"(registered: {', '.join(reg.names())})")
        if args.autoscale and args.fleet \
                and not any(e.status == "down" for e in reg.envs().values()):
            raise ValueError(
                "--autoscale needs at least one burst env "
                "(--env name:speedup:capacity:down)")
        if args.transport == "socket" and args.fleet:
            raise ValueError(
                "--transport socket (two-process demo) is incompatible "
                "with --fleet")
        if args.trickle_rate is not None and not args.replicate:
            raise ValueError(
                "--trickle-rate only applies with --replicate")
        trickle_rate = (parse_rate_spec(args.trickle_rate)
                        if args.trickle_rate is not None else 50e6)
        if args.replicate and not args.fleet:
            raise ValueError(
                "--replicate needs --fleet: think-time trickling runs on "
                "the scheduler's event loop (try --fleet 2 --think-time 5)")
        if args.replicate and args.transport == "socket":
            raise ValueError(
                "--replicate rides the fleet plane and is incompatible "
                "with --transport socket (the two-process demo)")
        if args.replicas < 0:
            raise ValueError(
                f"--replicas must be >= 0 (got {args.replicas})")
        if args.replicas and not args.fleet:
            raise ValueError(
                "--replicas needs --fleet: follower convergence runs on "
                "the scheduler's event loop (try --fleet 2 --think-time 5)")
        if args.race == "on" and not args.replicas:
            raise ValueError(
                "--race on races cells against converged followers and "
                "needs --replicas >= 1")
    except ValueError as e:
        ap.error(str(e))

    report, nb = run_notebook(
        args.notebook, sessions=args.sessions,
        remote_speedup=args.remote_speedup, policy=args.policy,
        use_knowledge=not args.no_knowledge, bandwidth=args.bandwidth,
        latency=args.latency, codec=args.codec, extra_envs=args.env,
        links=args.link, pipeline=args.pipeline, fleet=args.fleet,
        model=args.model, arrivals=args.arrivals,
        think_time=args.think_time, seed=args.seed, fail_envs=fail_envs,
        autoscale=args.autoscale, recovery=args.recovery,
        checkpoint_interval=args.checkpoint_interval,
        transport=args.transport, replicate=args.replicate,
        trickle_rate=trickle_rate, liveness=args.liveness == "on",
        replicas=args.replicas, race=args.race == "on",
        prices=args.price, hazards=args.hazard, egress=args.egress,
        slo=args.slo, workload=args.workload, device=args.device)

    print(json.dumps({k: v for k, v in report.items()
                      if k not in _NOT_PRINTED}, indent=2))
    if "decisions" in report:
        print("\nper-cell decisions:")
        for cid, note in report["decisions"].items():
            print(f"  {cid[:8]}: {note}")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
    if args.write_annotated:
        with open(args.write_annotated, "w") as f:
            json.dump(nb.to_ipynb(), f, indent=1)


if __name__ == "__main__":
    main()
