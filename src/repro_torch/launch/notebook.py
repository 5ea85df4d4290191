"""Run a Jupyter notebook file under the context-aware migration runtime.

    PYTHONPATH=src python -m repro_torch.launch.notebook path/to/nb.ipynb \\
        --sessions 3 --remote-speedup 10 --policy block \\
        [--model frequency|markov|recency|ensemble] \\
        [--bandwidth 1e9] [--latency 0.5] [--codec zlib] [--report out.json] \\
        [--env tpu-mesh:40:1] [--link local:tpu-mesh:1e8:1.0] [--pipeline] \\
        [--price remote:3.0] [--egress remote:local:0.09] [--slo 30] \\
        [--transport loopback|socket] [--device cuda|cpu]

The PyTorch counterpart of ``repro.launch.notebook``, single-session part:
the paper's local/remote dyad (plus any ``--env``/``--link`` extras) with
in-process loopback movement.  ``--transport socket`` is the two-process
demo: the remote env runs as a child Python process
(``repro_torch.core.remote_worker``) and every migration streams wire
frames over TCP; knowledge probing is then off, as in the reference.
State digests, chunk keys and the ``quant8+zstd`` codec run on
``--device`` (default ``cuda``: the hand-written kernels; ``cpu``: their
plain PyTorch versions), in the child too.  Asking for ``cuda`` without a
card is an error.

The fleet, replication, replica and hazard options of the reference need
modules that are not ported yet; giving one of them is an argparse error
that names it.

Cells execute for real (exec against the session namespace); timing follows
the paper's forced-speedup protocol when cells carry a
``metadata.repro.cost``, else measured wall time scaled by the env speedup.
Prints the decision/migration report and can write the annotated notebook
back (explainability annotations land in ``metadata.repro.annotations``).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core import (
    EnvironmentRegistry, ExecutionEnvironment, HybridRuntime, Notebook,
    StateReducer,
)


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
                   cold_start: float = 5.0, idle_timeout: float = 60.0,
                   transport: str = "loopback", prices=(), egress=(),
                   device="cuda") -> EnvironmentRegistry:
    """Two-env default plus any ``name:speedup[:capacity[:down]]`` extras
    and ``a:b:bandwidth:latency`` link overrides, with optional ``env:$/h``
    prices and ``a:b:$/GB`` egress prices.  ``transport="socket"`` makes
    the remote env a child Python process (``SubprocessEnv``) whose reducer
    runs on ``device``; every migration to or from it streams wire frames
    over TCP."""
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
    for spec in prices:
        name, price = parse_price_spec(spec)
        if name not in reg:
            raise ValueError(
                f"--price {spec!r}: unknown environment {name!r} "
                f"(registered: {', '.join(reg.names())})")
        reg[name].price_per_hour = price
    for spec in egress:
        a, b, per_gb = parse_egress_spec(spec)
        for end in (a, b):
            if end not in reg:
                raise ValueError(
                    f"--egress {spec!r}: unknown environment {end!r} "
                    f"(registered: {', '.join(reg.names())})")
        reg.set_egress(a, b, per_gb)
    return reg


def run_notebook(path: str, *, sessions: int = 3, remote_speedup: float = 10.0,
                 policy: str = "block", use_knowledge: bool = True,
                 bandwidth: float = 1e9, latency: float = 0.5,
                 codec: str = "zlib", extra_envs=(), links=(),
                 pipeline: bool = False, model: str | None = None,
                 prices=(), egress=(), slo: float | None = None,
                 transport: str = "loopback",
                 device="cuda") -> tuple[dict, Notebook]:
    """The notebook at ``path`` run ``sessions`` times over in one session;
    returns ``(report, annotated notebook)``.  ``transport="socket"`` runs
    the remote env in a child process (see :func:`build_registry`).

    The report carries the reference's single-session keys plus the
    reducer's ``device``, the chunks each env's store holds at the end
    (``chunks_held``) and ``migration_log``, one entry per migration in
    order."""
    with open(path) as f:
        nb = Notebook.from_ipynb(json.load(f))
    # any priced dimension switches the placement objective to expected
    # dollars under the SLO
    objective = "dollars" if (prices or egress or slo is not None) \
        else "seconds"
    if transport == "socket":
        # Algorithm-2 probing snapshots the env namespace, which for a
        # subprocess env lives in the child: knowledge probing stays off
        use_knowledge = False
    reducer = StateReducer(codec=codec, device=device)
    registry = build_registry(remote_speedup=remote_speedup,
                              bandwidth=bandwidth, latency=latency,
                              extra_envs=extra_envs, links=links,
                              transport=transport, prices=prices,
                              egress=egress, device=device)
    code = [c for c in nb.cells if c.cell_type == "code"]
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
        "migration_log": [
            {"src": m.src, "dst": m.dst, "names": list(m.names),
             "nbytes": m.nbytes, "seconds": m.seconds, "noop": m.noop}
            for m in rt.engine.log],
    }
    return report, nb


# options of the reference launcher that need modules not ported yet
_NOT_PORTED = {
    "--workload": "the built-in notebook families live in the scheduler",
    "--fleet": "the fleet scheduler",
    "--arrivals": "the fleet scheduler",
    "--think-time": "the fleet scheduler",
    "--seed": "the fleet scheduler",
    "--fail-env": "the fleet scheduler",
    "--recovery": "the fleet scheduler",
    "--checkpoint-interval": "the fleet scheduler",
    "--autoscale": "the fleet scheduler",
    "--replicate": "the fleet scheduler",
    "--trickle-rate": "the fleet scheduler",
    "--liveness": "the fleet scheduler",
    "--replicas": "the fleet scheduler (follower convergence runs on its "
                  "event loop)",
    "--race": "the fleet scheduler (races run against --replicas "
              "followers)",
    "--hazard": "the fleet scheduler",
}


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported to repro_torch yet "
                     f"(it needs {_NOT_PORTED[option_string]}); use "
                     f"python -m repro.launch.notebook for it")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("notebook", help=".ipynb path")
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
                    help="extra environment: name:speedup[:capacity[:down]]")
    ap.add_argument("--link", action="append", default=[],
                    help="pair link override: a:b:bandwidth:latency")
    ap.add_argument("--pipeline", action="store_true",
                    help="pipelined engine (prefetch overlaps execution)")
    ap.add_argument("--price", action="append", default=[],
                    metavar="ENV:DOLLARS_PER_HOUR",
                    help="cost plane: hourly compute price for an env")
    ap.add_argument("--egress", action="append", default=[],
                    metavar="SRC:DST:DOLLARS_PER_GB",
                    help="cost plane: per-GB egress price on a directed link")
    ap.add_argument("--slo", type=float, default=None, metavar="SECONDS",
                    help="cost plane: per-cell latency SLO")
    ap.add_argument("--transport", choices=["loopback", "socket"],
                    default="loopback",
                    help="socket = two-process demo: the remote env is a "
                         "child Python process and migrations stream wire "
                         "frames over TCP (knowledge probing off)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where digests, chunk keys and quantization run, "
                         "in this process and in a socket child: cuda = "
                         "the hand-written kernels (default), cpu = their "
                         "plain PyTorch versions")
    ap.add_argument("--report", default=None)
    ap.add_argument("--write-annotated", default=None,
                    help="write the notebook back with decision annotations")
    for flag in _NOT_PORTED:
        ap.add_argument(flag, nargs="?", action=_NotPorted,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    try:
        if args.slo is not None and args.slo <= 0:
            raise ValueError(
                f"--slo must be a positive number of seconds "
                f"(got {args.slo})")
        build_registry(remote_speedup=args.remote_speedup,
                       bandwidth=args.bandwidth, latency=args.latency,
                       extra_envs=args.env, links=args.link,
                       prices=args.price, egress=args.egress)
    except ValueError as e:
        ap.error(str(e))

    report, nb = run_notebook(
        args.notebook, sessions=args.sessions,
        remote_speedup=args.remote_speedup, policy=args.policy,
        use_knowledge=not args.no_knowledge, bandwidth=args.bandwidth,
        latency=args.latency, codec=args.codec, extra_envs=args.env,
        links=args.link, pipeline=args.pipeline, model=args.model,
        prices=args.price, egress=args.egress, slo=args.slo,
        transport=args.transport, device=args.device)

    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("decisions", "migration_log")}, indent=2))
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
