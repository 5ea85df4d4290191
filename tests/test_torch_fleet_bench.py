"""The port's fleet scheduler against the JAX reference's on the seeded
``--smoke`` configurations of ``benchmarks/bench_fleet.py`` (2 sessions,
256 intervals), ``bench_live.py`` (30 interactions, 20,000 elements) and
``bench_cost.py`` (2 sessions: the frontier's three fleets under both
objectives, data gravity, the degenerate fleet, determinism), on the CPU.

Each configuration is rebuilt here from one helper that takes the package
(nothing of ``benchmarks`` is imported on the port's side) and run once
per package; the ``ScheduleReport``s must be equal, floats within rtol
1e-12, and hold the benchmark's own claims.  The port runs with
``device="cpu"``.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_fleet import PACKAGES, _cpu_budget, both  # noqa: E402,F401


# ======================================================================
# the benchmarks' smoke configurations
# ======================================================================

# -- benchmarks/bench_fleet.py (run(smoke=True): 2 sessions, 256 intervals)

FLEET_RATES = (0.05, 0.1, 0.2)
FLEET_THINK = 4.0
FLEET_SEED = 20260731


def fleet_notebook(pkg, tag=""):
    nb = pkg.core.Notebook(f"fleet-session{tag}")
    nb.add_cell("import numpy as np\n"
                "data = np.arange(400_000, dtype=np.float64)", cost=4.0)
    nb.add_cell("model = float(((data - data.mean()) ** 2).sum())", cost=80.0)
    nb.add_cell("model2 = model * 0.5 + float(data.std())", cost=80.0)
    nb.add_cell("report = model2 / len(data)", cost=0.3)
    return nb


def fleet_registry(pkg, *, burst, always_up=False):
    c = pkg.core
    reg = c.EnvironmentRegistry(default_bandwidth=2e8, default_latency=0.3)
    reg.register(c.ExecutionEnvironment("local"), home=True, capacity=8)
    reg.register(c.ExecutionEnvironment("gpu-cloud", speedup=10.0),
                 capacity=1)
    if burst:
        reg.register(c.ExecutionEnvironment(
            "gpu-burst", speedup=10.0,
            status="up" if always_up else "down", cold_start=6.0,
            idle_timeout=12.0), capacity=1)
    return reg


def bench_fleet_arrivals(pkg, rate):
    out = {}
    for mode in ("static", "overprovisioned", "autoscale"):
        sched = pkg.sched(fleet_registry(
            pkg, burst=mode != "static", always_up=mode == "overprovisioned"))
        if mode == "autoscale":
            sched.enable_autoscale(pkg.core.AutoscalePolicy(
                ["gpu-burst"], check_interval=4.0, scale_up_wait=1.0))
        for i in range(2):
            sched.add_notebook(fleet_notebook(pkg, f"-{rate}-{mode}-{i}"),
                               policy="cost", use_knowledge=False)
        sched.set_workload(pkg.core.WorkloadTrace.poisson(
            2, rate=rate, think_mean=FLEET_THINK, cells_per_session=4,
            seed=FLEET_SEED))
        out[mode] = sched.run()
    return out


def bench_fleet_failure(pkg):
    out = {}
    for mode in ("rerun", "checkpoint"):
        sched = pkg.sched(fleet_registry(pkg, burst=False))
        sched.enable_recovery(mode, interval=8.0)
        rt = sched.add_notebook(fleet_notebook(pkg, f"-fail-{mode}"),
                                policy="cost", use_knowledge=False,
                                think=[1.0] * 4)
        sched.inject_failure("gpu-cloud", at=14.0, recover_after=10.0)
        rep = sched.run()
        assert rep.recoveries >= 1
        assert rt.envs["local"].state.get("report") is not None
        out[mode] = rep
    assert out["checkpoint"].makespan < out["rerun"].makespan
    return out


def bench_fleet_arbiter(pkg):
    reg = pkg.core.EnvironmentRegistry()
    reg.register(pkg.core.ExecutionEnvironment("local"), home=True,
                 capacity=2)
    out = {}
    for prune in (False, True):
        arb = pkg.core.CapacityArbiter(reg)
        starts, now = [], 0.0
        for i in range(256):
            start = arb.acquire("local", now, 1.0)
            arb.release("local", start, start + 1.0)
            starts.append(start)
            now = start + 0.5
            if prune and i % 64 == 0:
                arb.prune(now)
        out[prune] = (starts, arb.pruned_intervals)
    assert out[False][0] == out[True][0]
    return out


def bench_fleet_determinism(pkg):
    def run_once():
        sched = pkg.sched(fleet_registry(pkg, burst=True))
        sched.enable_recovery("checkpoint", interval=8.0)
        sched.enable_autoscale(pkg.core.AutoscalePolicy(["gpu-burst"]))
        for i in range(3):
            sched.add_notebook(fleet_notebook(pkg, f"-det-{i}"),
                               policy="cost", use_knowledge=False)
        sched.set_workload(pkg.core.WorkloadTrace.poisson(
            3, rate=0.1, think_mean=FLEET_THINK, cells_per_session=4,
            seed=FLEET_SEED))
        sched.inject_failure("gpu-cloud", at=20.0, recover_after=15.0)
        return sched.run()

    a, b = run_once(), run_once()
    assert a == b
    return a


@pytest.mark.parametrize("rate", FLEET_RATES)
def test_bench_fleet_arrivals_match_the_reference(rate):
    both(bench_fleet_arrivals, rate)


@pytest.mark.parametrize("part", [bench_fleet_failure, bench_fleet_arbiter,
                                  bench_fleet_determinism],
                         ids=lambda f: f.__name__)
def test_bench_fleet_part_matches_the_reference(part):
    both(part)


# -- benchmarks/bench_live.py (run(smoke=True): 30 interactions, 20,000) ----

LIVE_BANDWIDTH = 2e5
LIVE_LATENCY = 0.01
LIVE_THINK = 6.0
LIVE_RATE = 1e6
LIVE_SIZE_DIV = {0: 1, 1: 2, 2: 16}
LIVE_INTERACTIONS = 30
LIVE_ELEMS = 20_000


def live_registry(pkg):
    c = pkg.core
    reg = c.EnvironmentRegistry(default_bandwidth=LIVE_BANDWIDTH,
                                default_latency=LIVE_LATENCY)
    reg.register(c.ExecutionEnvironment("local"), home=True, capacity=8)
    reg.register(c.ExecutionEnvironment("remote", speedup=10.0), capacity=4)
    return reg


def live_trace_notebook(pkg, trace, arr_elems):
    nb = pkg.core.Notebook(f"live-{trace.name}")
    for i in range(max(trace.order) + 1):
        if i == 0:
            src = "\n".join(["import numpy as np"] + [
                f"d{j} = np.arange({arr_elems // LIVE_SIZE_DIV[j]},"
                f" dtype=np.float64) + {j}" for j in range(3)])
        elif trace.costs[i] >= 5.0:
            src = f"m{i} = " + " + ".join(
                f"float((d{j} * {i}).sum())" for j in range(3))
        else:
            j = i % 3
            src = f"d{j} = d{j} * 1.0001 + {i}"
        cost = (trace.costs[i] if trace.costs[i] >= 5.0
                else min(trace.costs[i], LIVE_LATENCY * 0.4))
        nb.add_cell(src, cost=cost)
    return nb


def live_arm(pkg, trace_name, *, replicate, pipeline):
    trace = getattr(pkg.simulator, trace_name)()
    sched = pkg.sched(live_registry(pkg))
    plan = list(trace.order[:LIVE_INTERACTIONS])
    sched.add_notebook(live_trace_notebook(pkg, trace, LIVE_ELEMS),
                       plan=plan, policy="cost", use_knowledge=False,
                       pipeline=pipeline, think=[LIVE_THINK] * len(plan))
    if replicate:
        sched.enable_replication(rate=LIVE_RATE, interval=LIVE_THINK / 4.0)
    rep = sched.run()
    s = sched._sessions[0]
    log = [(m.src, m.dst, sorted(m.names), m.nbytes, m.seconds, m.noop)
           for m in s.runtime.engine.log]
    return rep, log, (s.rep.trickled_bytes, s.rep.claimed_bytes) \
        if s.rep else None


def live_dead_state(pkg):
    out = {}
    for liveness in (True, False):
        nb = pkg.core.Notebook("live-deadstate")
        nb.add_cell(f"import numpy as np\n"
                    f"raw = np.arange({LIVE_ELEMS * 4}, dtype=np.float64)",
                    cost=0.2)
        nb.add_cell("feat = raw * 2.0 + 1.0", cost=0.2)
        nb.add_cell("model = float(feat.sum())", cost=60.0)
        nb.add_cell("result = model * 0.5 + 1.0", cost=60.0)
        nb.add_cell("summary = result / 1e6", cost=0.1)
        sched = pkg.sched(live_registry(pkg))
        plan = list(range(len(nb.cells)))
        sched.add_notebook(nb, plan=plan, policy="cost", use_knowledge=False,
                           think=[LIVE_THINK] * len(plan))
        sched.enable_replication(rate=LIVE_RATE, liveness=liveness,
                                 interval=LIVE_THINK / 4.0)
        rep = sched.run()
        s = sched._sessions[0]
        out[liveness] = (rep, sum(m.nbytes for m in s.runtime.engine.log)
                         + s.rep.trickled_bytes)
    assert out[True][1] < out[False][1]
    return out


@pytest.mark.parametrize("arm", [(False, True), (True, False)],
                         ids=["pipelined", "replicated"])
@pytest.mark.parametrize("trace", ["synthetic_loops_trace", "tf_guide_trace"])
def test_bench_live_arm_matches_the_reference(trace, arm):
    replicate, pipeline = arm
    both(live_arm, trace, replicate=replicate, pipeline=pipeline)


def test_bench_live_dead_state_matches_the_reference():
    both(live_dead_state)


# -- benchmarks/bench_cost.py (run(smoke=True): 2 sessions, 3 scenes) -------

COST_SEED = 2
COST_SLO = 30.0
GRAVITY_SLO = 12.0


def cost_registry(pkg, fleet):
    c = pkg.core
    reg = c.EnvironmentRegistry(default_bandwidth=2e8, default_latency=0.3)
    reg.register(c.ExecutionEnvironment("local"), home=True, capacity=8)
    reg.register(c.ExecutionEnvironment(
        "ondemand-gpu", speedup=10.0, price_per_hour=3.0), capacity=2)
    if fleet == "autoscaled":
        reg.register(c.ExecutionEnvironment(
            "gpu-burst", speedup=10.0, price_per_hour=3.0, status="down",
            cold_start=6.0, idle_timeout=12.0), capacity=2)
    if fleet == "spot":
        reg.register(c.ExecutionEnvironment(
            "spot-gpu", speedup=8.0, price_per_hour=0.9,
            hazard_rate=120.0 / 3600.0), capacity=4)
    return reg


def cost_fleet(pkg, fleet, objective, n_sessions=2):
    sched = pkg.sched(cost_registry(pkg, fleet))
    sched.enable_recovery("checkpoint", interval=15.0)
    if fleet == "autoscaled":
        sched.enable_autoscale(pkg.core.AutoscalePolicy(
            ["gpu-burst"], check_interval=4.0, scale_up_wait=1.0))
    for i in range(n_sessions):
        sched.add_notebook(
            pkg.core.gpu_training_notebook(f"gpu-{fleet}-{objective}-{i}"),
            policy="horizon", use_knowledge=False, objective=objective,
            slo=COST_SLO)
    if fleet == "spot":
        sched.enable_spot_hazards(seed=COST_SEED, recover_after=10.0)
    return sched.run()


def cost_gravity(pkg):
    c = pkg.core
    out = {}
    for objective in ("seconds", "dollars"):
        reg = c.EnvironmentRegistry(default_bandwidth=2e8,
                                    default_latency=0.3)
        reg.register(c.ExecutionEnvironment("local"), home=True, capacity=8)
        reg.register(c.ExecutionEnvironment(
            "near-data", speedup=6.0, price_per_hour=1.0), capacity=4)
        reg.register(c.ExecutionEnvironment(
            "far-gpu", speedup=8.0, price_per_hour=3.0), capacity=4)
        for src in ("local", "near-data"):
            reg.set_egress(src, "far-gpu", 40.0)
            reg.set_egress("far-gpu", src, 80.0)
        sched = pkg.sched(reg)
        rt = sched.add_notebook(
            c.remote_sensing_notebook(f"rs-{objective}", scenes=3),
            policy="horizon", use_knowledge=False, objective=objective,
            slo=GRAVITY_SLO)
        out[objective] = (sched.run(), dict(rt.exec_env_seconds))
    rep, env_seconds = out["dollars"]
    assert rep.egress_dollars == 0.0
    assert env_seconds.get("near-data", 0.0) > 0.0
    assert env_seconds.get("far-gpu", 0.0) == 0.0
    return out


def cost_degenerate(pkg):
    def run_plain(objective):
        c = pkg.core
        reg = c.EnvironmentRegistry(default_bandwidth=2e8,
                                    default_latency=0.3)
        reg.register(c.ExecutionEnvironment("local"), home=True, capacity=8)
        reg.register(c.ExecutionEnvironment("remote", speedup=10.0),
                     capacity=4)
        sched = pkg.sched(reg)
        for i in range(2):
            sched.add_notebook(c.gpu_training_notebook(f"deg-{i}"),
                               policy="horizon", use_knowledge=False,
                               objective=objective)
        return sched.run()

    a, b = run_plain("seconds"), run_plain("dollars")
    assert a.makespan == b.makespan
    assert a.actual_env_seconds == b.actual_env_seconds
    assert [s.makespan for s in a.sessions] == [s.makespan for s in b.sessions]
    assert b.total_dollars == 0.0
    return a, b


def cost_determinism(pkg):
    a, b = cost_fleet(pkg, "spot", "dollars"), cost_fleet(pkg, "spot",
                                                           "dollars")
    assert a == b and a.preemptions > 0
    return a


@pytest.mark.parametrize("objective", ["seconds", "dollars"])
@pytest.mark.parametrize("fleet", ["static", "autoscaled", "spot"])
def test_bench_cost_frontier_matches_the_reference(fleet, objective):
    both(cost_fleet, fleet, objective)


@pytest.mark.parametrize("part", [cost_gravity, cost_degenerate,
                                  cost_determinism], ids=lambda f: f.__name__)
def test_bench_cost_part_matches_the_reference(part):
    both(part)
