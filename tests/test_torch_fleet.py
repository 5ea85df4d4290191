"""The port's fleet scheduler against the JAX reference's, on the CPU.

Each case runs once per package on the same inputs and the results are
compared:

* every case of ``tests/test_fleet.py`` (env lifecycle, arrivals and
  think time, failure recovery through CAS checkpoints, autoscaling,
  arbiter pruning, seeded determinism);
* the fleet cases of ``tests/test_replica.py`` and the failover sweep of
  ``benchmarks/bench_replica.py`` at its smoke sizes (50,000 and 500,000).

The ``--smoke`` configurations of bench_fleet, bench_live and bench_cost
are in ``tests/test_torch_fleet_bench.py``.

Decisions, placements, lifecycle events, byte counts and draws must be
equal; modeled seconds, makespans and dollars agree within rtol 1e-12.
Wall-clock fields are not compared.  The port runs with ``device="cpu"``.
"""
import dataclasses
import hashlib
import math
import types
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro.core.simulator as ref_simulator  # noqa: E402
import repro.distributed.fault as ref_fault  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.core.simulator as port_simulator  # noqa: E402
import repro_torch.distributed.fault as port_fault  # noqa: E402


def _pkg(core, simulator, fault, device_kw):
    def sched(reg, **kw):
        return core.SessionScheduler(reg, **device_kw, **kw)

    def runtime(nb, **kw):
        kw.setdefault("reducer", core.StateReducer(**device_kw))
        return core.HybridRuntime(nb, **kw)

    return types.SimpleNamespace(core=core, simulator=simulator, fault=fault,
                                 sched=sched, runtime=runtime)


PACKAGES = {
    "reference": _pkg(ref_core, ref_simulator, ref_fault, {}),
    "port": _pkg(port_core, port_simulator, port_fault, {"device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _cpu_budget():
    """Keeps the parity runs cheap on a CPU that other test workers share.

    Both packages compress the same chunks many times over (one dataset,
    many sessions and arms); zlib is deterministic, so a memo keyed by the
    input's digest gives the same bytes.  The port's plain hash runs many
    small torch ops, which one thread a worker serves best."""
    real = zlib.compress
    memo = {}

    def compress(data, level=-1, wbits=15):
        if len(data) < 1 << 14:
            return real(data, level, wbits)
        key = (hashlib.blake2b(data, digest_size=16).digest(), len(data),
               level, wbits)
        out = memo.get(key)
        if out is None:
            if len(memo) >= 512:
                memo.clear()
            out = memo[key] = real(data, level, wbits)
        return out

    threads = torch.get_num_threads()
    zlib.compress = compress
    torch.set_num_threads(1)
    yield
    zlib.compress = real
    torch.set_num_threads(threads)


def assert_same(a, b, path="$"):
    """Equal, except floats: within rtol 1e-12."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert dataclasses.is_dataclass(b), path
        assert type(a).__name__ == type(b).__name__, path
        a = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
        b = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and isinstance(b, float):
        assert a == b or math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0) \
            or (math.isnan(a) and math.isnan(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def both(fn, *args, **kw):
    outs = {name: fn(pkg, *args, **kw) for name, pkg in PACKAGES.items()}
    assert_same(outs["port"], outs["reference"])
    return outs["port"]


# ======================================================================
# part 1: the cases of tests/test_fleet.py
# ======================================================================

def make_nb(pkg, tag="", heavy=100.0):
    nb = pkg.core.Notebook(f"fleet{tag}")
    nb.add_cell("import numpy as np\n"
                "data = np.arange(50_000, dtype=np.float64)", cost=4.0)
    nb.add_cell("a = float(data.sum())", cost=heavy)
    nb.add_cell("b = a * 2", cost=heavy)
    nb.add_cell("report = b + a", cost=0.2)
    return nb


def make_reg(pkg, *, burst=False):
    c = pkg.core
    reg = c.EnvironmentRegistry(default_bandwidth=2e8, default_latency=0.3)
    reg.register(c.ExecutionEnvironment("local"), home=True, capacity=8)
    reg.register(c.ExecutionEnvironment("gpu", speedup=10.0), capacity=1)
    if burst:
        reg.register(c.ExecutionEnvironment(
            "burst", speedup=10.0, status="down", cold_start=5.0,
            idle_timeout=10.0), capacity=1)
    return reg


REPORT_WANT = float(np.arange(50_000, dtype=np.float64).sum()) * 3


def lifecycle_transitions_and_audit_log(pkg):
    reg = make_reg(pkg)
    reg.set_status("gpu", "draining", now=1.0)
    reg.set_status("gpu", "down", now=2.0)
    reg.set_status("gpu", "provisioning", now=3.0)
    reg.set_status("gpu", "up", now=4.0)
    assert [(e[1], e[3]) for e in reg.lifecycle_log] == [
        ("gpu", "draining"), ("gpu", "down"), ("gpu", "provisioning"),
        ("gpu", "up")]
    return list(reg.lifecycle_log)


def lifecycle_illegal_transition_raises(pkg):
    env = pkg.core.ExecutionEnvironment("x", status="down")
    with pytest.raises(ValueError, match="illegal lifecycle transition") \
            as e:
        env.set_status("up")
    return str(e.value)


def cold_start_sets_ready_at(pkg):
    env = pkg.core.ExecutionEnvironment("x", status="down", cold_start=7.5)
    env.set_status("provisioning", now=10.0)
    assert env.ready_at == 17.5
    assert env.placeable_now()
    return env.ready_at, env.status


def down_and_failed_envs_are_not_candidates(pkg):
    reg = make_reg(pkg, burst=True)
    assert "burst" not in reg.compute_envs()
    assert reg.candidates() == ["gpu"]
    reg.set_status("gpu", "failed")
    assert reg.candidates() == []
    return sorted(reg.compute_envs()), reg.candidates()


def retire_removes_env_and_links(pkg):
    reg = make_reg(pkg, burst=True)
    reg.connect("local", "burst", bandwidth=1e9, latency=0.1)
    reg.retire("burst")
    assert "burst" not in reg
    assert ("local", "burst") not in reg._links
    with pytest.raises(ValueError, match="cannot retire the home"):
        reg.retire("local")
    return reg.names(), sorted(reg._links)


def clone_topology_preserves_lifecycle_state(pkg):
    reg = make_reg(pkg, burst=True)
    reg.set_status("burst", "provisioning", now=3.0)
    clone = reg.clone_topology()
    b = clone["burst"]
    assert b.status == "provisioning" and b.ready_at == reg["burst"].ready_at
    assert b.cold_start == 5.0 and b.idle_timeout == 10.0
    return b.status, b.ready_at, b.cold_start, b.idle_timeout


def arrivals_and_think_time_show_in_report(pkg):
    sched = pkg.sched(make_reg(pkg))
    sched.add_notebook(make_nb(pkg, "-0"), policy="cost", use_knowledge=False)
    sched.add_notebook(make_nb(pkg, "-1"), policy="cost", use_knowledge=False,
                       arrival=50.0, think=[2.0, 3.0, 4.0])
    rep = sched.run()
    s0, s1 = rep.sessions
    assert s0.arrival == 0.0 and s0.think_time == 0.0
    assert s1.arrival == 50.0 and s1.makespan >= 50.0
    assert s1.think_time == pytest.approx(9.0)
    assert rep.total_think_time == pytest.approx(9.0)
    return rep


def workload_trace_poisson_is_seeded(pkg):
    W = pkg.core.WorkloadTrace
    a = W.poisson(4, rate=0.2, think_mean=3.0, cells_per_session=5, seed=42)
    b = W.poisson(4, rate=0.2, think_mean=3.0, cells_per_session=5, seed=42)
    c = W.poisson(4, rate=0.2, think_mean=3.0, cells_per_session=5, seed=43)
    assert a == b and a != c
    assert a.arrivals[0] == 0.0 and a.arrivals == sorted(a.arrivals)
    # the draws are numpy's: equal to the reference's draw for draw
    return a, c


def static_trace_is_the_degenerate_instance(pkg):
    def run(workload):
        sched = pkg.sched(make_reg(pkg))
        for i in range(3):
            sched.add_notebook(make_nb(pkg, f"-{i}"), policy="cost",
                               use_knowledge=False)
        if workload is not None:
            sched.set_workload(workload)
        return sched.run()

    a, b = run(None), run(pkg.core.WorkloadTrace.static(3))
    assert a == b
    return a


def _failure_run(pkg, mode, fail_at=15.0):
    sched = pkg.sched(make_reg(pkg))
    sched.enable_recovery(mode, interval=5.0)
    rt = sched.add_notebook(make_nb(pkg, f"-{mode}"), policy="cost",
                            use_knowledge=False, think=[1.0] * 4)
    sched.inject_failure("gpu", at=fail_at, recover_after=10.0)
    rep = sched.run()
    return sched, rt, rep


def mid_cell_failure_triggers_recovery_and_completes(pkg):
    _, rt, rep = _failure_run(pkg, "rerun")
    assert rep.recoveries == 1 and rep.failures == [("gpu", 15.0)]
    assert rep.sessions[0].cells_run == 4
    assert rt.envs["local"].state.get("report") == REPORT_WANT
    assert any(kind == "failure" and worker == "gpu"
               for _, kind, worker, _ in rep.fault_events)
    return rep


def checkpoint_recovery_beats_rerun_on_makespan(pkg):
    _, _, rep_rerun = _failure_run(pkg, "rerun")
    _, rt_c, rep_ckpt = _failure_run(pkg, "checkpoint")
    assert rep_ckpt.recoveries == 1 and rep_rerun.recoveries == 1
    assert rep_ckpt.checkpoints > 0
    assert rep_ckpt.makespan < rep_rerun.makespan
    assert rt_c.envs["local"].state.get("report") == REPORT_WANT
    return rep_rerun, rep_ckpt


def failure_before_first_checkpoint_falls_back_to_rerun(pkg):
    _, rt, rep = _failure_run(pkg, "checkpoint", fail_at=8.0)
    assert rep.recoveries == 1 and rep.sessions[0].cells_run == 4
    assert rt.envs["local"].state.get("report") == REPORT_WANT
    return rep


def failed_env_recovers_after_reprovision(pkg):
    sched, _, rep = _failure_run(pkg, "rerun")
    assert sched.registry["gpu"].status == "up"
    transitions = [(e[1], e[3]) for e in rep.lifecycle_events]
    for want in (("gpu", "failed"), ("gpu", "provisioning"), ("gpu", "up")):
        assert want in transitions
    return rep.lifecycle_events


def rerun_recovery_does_not_double_execute_state(pkg):
    nb = pkg.core.Notebook("nonidem")
    nb.add_cell("acc = []", cost=2.0)
    nb.add_cell("acc.append(1)", cost=100.0)
    nb.add_cell("acc.append(2)", cost=100.0)
    nb.add_cell("total = len(acc)", cost=0.2)
    sched = pkg.sched(make_reg(pkg))
    sched.enable_recovery("rerun")
    rt = sched.add_notebook(nb, policy="cost", use_knowledge=False)
    sched.inject_failure("gpu", at=5.0, recover_after=10.0)
    rep = sched.run()
    assert rep.recoveries >= 1
    total = (rt.envs["local"].state.get("total")
             or rt.envs["gpu"].state.get("total"))
    assert total == 2
    return rep, total


def provisioning_env_waits_for_cold_start(pkg):
    c = pkg.core
    reg = c.EnvironmentRegistry()
    reg.register(c.ExecutionEnvironment("local"), home=True)
    cold = c.ExecutionEnvironment("cold-gpu", speedup=10.0,
                                  status="provisioning", cold_start=25.0)
    cold.ready_at = 25.0
    reg.register(cold)
    nb = c.Notebook("cold")
    nb.add_cell("x = 1", cost=1.0)
    rt = pkg.runtime(nb, registry=reg, use_knowledge=False)
    rt.run_cell(0, force_env="cold-gpu")
    assert rt.clock.now() >= 25.0 and rt.queue_wait > 0.0
    out = rt.clock.now(), rt.queue_wait
    rt.close()
    return out


def stale_mark_up_event_respects_new_ready_at(pkg):
    sched = pkg.sched(make_reg(pkg, burst=True))
    loop = sched._loop = pkg.core.EventLoop()
    sched._set_status("burst", "provisioning", 10.0)
    loop.call_at(15.0, sched._mark_up, "burst")
    loop.call_at(12.0, sched._fail_env, "burst", 12.0, 1.0)
    loop.run()
    ups = [(t, e) for t, e, _o, new in sched.registry.lifecycle_log
           if new == "up" and e == "burst"]
    assert ups == [(18.0, "burst")]
    return sched.registry.lifecycle_log


def detection_delay_follows_heartbeat_protocol(pkg):
    sched = pkg.sched(make_reg(pkg), beat_interval=2.0, miss_threshold=4)
    coord = pkg.fault.Coordinator(["a"], beat_interval=2.0, miss_threshold=4)
    assert sched.detect_delay == 8.0 and coord.detection_delay == 8.0
    return sched.detect_delay, coord.detection_delay


def _autoscale_run(pkg, burst):
    sched = pkg.sched(make_reg(pkg, burst=burst))
    if burst:
        sched.enable_autoscale(pkg.core.AutoscalePolicy(
            ["burst"], check_interval=3.0, scale_up_wait=1.0))
    for i in range(4):
        sched.add_notebook(make_nb(pkg, f"-{i}"), policy="cost",
                           use_knowledge=False)
    sched.set_workload(pkg.core.WorkloadTrace.poisson(
        4, rate=0.2, think_mean=2.0, cells_per_session=4, seed=5))
    return sched.run()


def autoscale_provisions_and_culls_burst_env(pkg):
    rep = _autoscale_run(pkg, True)
    actions = [a for _, a, _ in rep.scale_events]
    assert "provision" in actions and "cull" in actions
    assert rep.actual_env_seconds.get("burst", 0.0) > 0.0
    return rep


def autoscale_reduces_queue_wait_vs_static(pkg):
    elastic, static = _autoscale_run(pkg, True), _autoscale_run(pkg, False)
    assert elastic.total_queue_wait < static.total_queue_wait
    return elastic.total_queue_wait, static


def seeded_fleet_runs_are_deterministic(pkg):
    def run_once():
        sched = pkg.sched(make_reg(pkg, burst=True))
        sched.enable_recovery("checkpoint", interval=5.0)
        sched.enable_autoscale(pkg.core.AutoscalePolicy(["burst"]))
        for i in range(3):
            sched.add_notebook(make_nb(pkg, f"-{i}"), policy="cost",
                               use_knowledge=False)
        sched.set_workload(pkg.core.WorkloadTrace.poisson(
            3, rate=0.15, think_mean=3.0, cells_per_session=4, seed=99))
        sched.inject_failure("gpu", at=8.0, recover_after=12.0)
        return sched.run()

    a, b = run_once(), run_once()
    assert a == b
    return a


def run_closes_sessions_when_a_cell_raises(pkg):
    sched = pkg.sched(make_reg(pkg))
    good = sched.add_notebook(make_nb(pkg, "-ok"), policy="cost",
                              use_knowledge=False, pipeline=True)
    bad_nb = pkg.core.Notebook("bad")
    bad_nb.add_cell("x = 1", cost=0.1)
    bad_nb.add_cell("raise RuntimeError('boom')", cost=0.1)
    bad = sched.add_notebook(bad_nb, policy="cost", use_knowledge=False,
                             pipeline=True)
    with pytest.raises(RuntimeError, match="boom"):
        sched.run()
    for rt in (good, bad):
        assert rt.bus.subscriber_count("telemetry") == 0
        assert not rt.engine._pending
    return [rt.clock.now() for rt in (good, bad)]


def _arbiter_replay(pkg, prune, n=200):
    arb = pkg.core.CapacityArbiter(make_reg(pkg))
    starts, now = [], 0.0
    for i in range(n):
        start = arb.acquire("gpu", now, 1.0)
        arb.release("gpu", start, start + 1.0)
        starts.append(start)
        now = start + 0.25
        if prune and i % 16 == 0:
            arb.prune(now)
    return starts, arb


def arbiter_prune_preserves_admission_decisions(pkg):
    plain, _ = _arbiter_replay(pkg, False)
    pruned, arb = _arbiter_replay(pkg, True)
    assert plain == pruned and arb.pruned_intervals > 0
    assert sum(len(v) for v in arb._busy.values()) < 200
    return pruned, arb.pruned_intervals, arb.queue_events


def arbiter_prune_never_drops_live_intervals(pkg):
    arb = pkg.core.CapacityArbiter(make_reg(pkg))
    arb.release("gpu", 0.0, 10.0)
    arb.release("gpu", 5.0, 20.0)
    arb.prune(10.0)
    assert arb._busy["gpu"] == [(5.0, 20.0)]
    assert arb.acquire("gpu", 12.0, 1.0) == 20.0
    return arb._busy


def expected_wait_peeks_without_recording_queue_events(pkg):
    arb = pkg.core.CapacityArbiter(make_reg(pkg))
    arb.release("gpu", 0.0, 10.0)
    assert arb.expected_wait("gpu", 2.0) == 8.0 and arb.queue_events == []
    assert arb.acquire("gpu", 2.0) == 10.0
    assert len(arb.queue_events) == 1
    return arb.queue_events


FLEET_CASES = [
    lifecycle_transitions_and_audit_log, lifecycle_illegal_transition_raises,
    cold_start_sets_ready_at, down_and_failed_envs_are_not_candidates,
    retire_removes_env_and_links, clone_topology_preserves_lifecycle_state,
    arrivals_and_think_time_show_in_report, workload_trace_poisson_is_seeded,
    static_trace_is_the_degenerate_instance,
    mid_cell_failure_triggers_recovery_and_completes,
    checkpoint_recovery_beats_rerun_on_makespan,
    failure_before_first_checkpoint_falls_back_to_rerun,
    failed_env_recovers_after_reprovision,
    rerun_recovery_does_not_double_execute_state,
    provisioning_env_waits_for_cold_start,
    stale_mark_up_event_respects_new_ready_at,
    detection_delay_follows_heartbeat_protocol,
    autoscale_provisions_and_culls_burst_env,
    autoscale_reduces_queue_wait_vs_static,
    seeded_fleet_runs_are_deterministic,
    run_closes_sessions_when_a_cell_raises,
    arbiter_prune_preserves_admission_decisions,
    arbiter_prune_never_drops_live_intervals,
    expected_wait_peeks_without_recording_queue_events,
]


@pytest.mark.parametrize("case", FLEET_CASES, ids=lambda f: f.__name__)
def test_fleet_case_matches_the_reference(case):
    both(case)


def test_port_sessions_get_their_own_reducer_on_the_device():
    sched = PACKAGES["port"].sched(make_reg(PACKAGES["port"]))
    rts = [sched.add_notebook(make_nb(PACKAGES["port"], f"-{i}"),
                              policy="cost", use_knowledge=False)
           for i in range(3)]
    assert len({id(rt.reducer) for rt in rts}) == 3
    assert all(rt.reducer.device.type == "cpu" for rt in rts)
    assert all(rt.engine.reducer is rt.reducer for rt in rts)
    sched.run()


# ======================================================================
# part 2: the replica plane in the fleet (tests/test_replica.py, fleet
# cases; benchmarks/bench_replica.py's failover sweep at its smoke sizes)
# ======================================================================

def _failover_fleet(pkg, mode):
    c = pkg.core
    reg = c.EnvironmentRegistry(default_bandwidth=2e8, default_latency=0.3)
    reg.register(c.ExecutionEnvironment("local"), home=True, capacity=8)
    reg.register(c.ExecutionEnvironment("gpu-cloud", speedup=10.0),
                 capacity=1)
    reg.register(c.ExecutionEnvironment("gpu-standby", speedup=10.0),
                 capacity=1)
    sched = pkg.sched(reg)
    if mode == "replica":
        sched.enable_replicas(2)
        sched.enable_recovery("rerun")
    else:
        sched.enable_recovery(mode)
    sched.inject_failure("gpu-cloud", at=14.0, recover_after=10.0)
    nb = c.Notebook("failover")
    nb.add_cell("import numpy as np\n"
                "data = np.arange(50_000, dtype=np.float64)", cost=4.0)
    nb.add_cell("model = float((data ** 2).sum())", cost=80.0)
    nb.add_cell("model2 = model + 1", cost=80.0)
    nb.add_cell("out = model2 / 2", cost=0.3)
    sched.add_notebook(nb, policy="cost", use_knowledge=False,
                       think=[1.0] * 4)
    return sched.run()


def scheduler_promotes_instead_of_rerunning(pkg):
    rep, rerun = _failover_fleet(pkg, "replica"), _failover_fleet(pkg,
                                                                  "rerun")
    s = rep.sessions[0]
    assert s.cells_run == 4 and rep.recoveries == 1
    assert rep.promotions == 1 and s.promotions == 1
    assert s.replicated_bytes > 0 and rep.replica_shared_bytes >= 0
    assert rep.makespan < rerun.makespan
    return rep, rerun


def scheduler_replicas_validation(pkg):
    c = pkg.core
    reg = c.EnvironmentRegistry(default_bandwidth=2e8, default_latency=0.3)
    reg.register(c.ExecutionEnvironment("local"), home=True)
    sched = pkg.sched(reg)
    msgs = []
    for args, kw in (((-1,), {}), ((2,), {"followers": ["a", "a"]})):
        with pytest.raises(ValueError) as e:
            sched.enable_replicas(*args, **kw)
        msgs.append(str(e.value))
    sched.enable_replicas(0)
    assert sched.replica_cfg is None
    return msgs


def degenerate_no_replicas_reports_zero(pkg):
    c = pkg.core
    reg = c.EnvironmentRegistry(default_bandwidth=1e6, default_latency=0.01)
    reg.register(c.ExecutionEnvironment("local"), home=True, capacity=4)
    reg.register(c.ExecutionEnvironment("remote", speedup=10.0), capacity=4)
    sched = pkg.sched(reg)
    nb = c.Notebook("plain")
    nb.add_cell("v = 1", cost=0.1)
    nb.add_cell("w = v + 1", cost=0.1)
    sched.add_notebook(nb, plan=[0, 1], policy="cost", use_knowledge=False)
    rep = sched.run()
    assert rep.promotions == 0 and rep.races == 0
    assert rep.replicated_bytes == 0
    s = rep.sessions[0]
    assert s.replica_lag == 0 and s.promotions == 0 and s.races == 0
    return rep


@pytest.mark.parametrize("case", [scheduler_promotes_instead_of_rerunning,
                                  scheduler_replicas_validation,
                                  degenerate_no_replicas_reports_zero],
                         ids=lambda f: f.__name__)
def test_replica_fleet_case_matches_the_reference(case):
    both(case)


# benchmarks/bench_replica.py: FAIL_AT 29.9, CKPT_INTERVAL 15.0,
# BEAT_INTERVAL 0.2, N_CELLS 5 and its registry and notebook (:34-75)
REPLICA_FAIL_AT = 29.9
REPLICA_CKPT_INTERVAL = 15.0
REPLICA_BEAT_INTERVAL = 0.2
REPLICA_N_CELLS = 5


def replica_arm(pkg, n_elems, mode):
    c = pkg.core
    reg = c.EnvironmentRegistry(default_bandwidth=2e8, default_latency=0.3)
    reg.register(c.ExecutionEnvironment("local"), home=True, capacity=8)
    reg.register(c.ExecutionEnvironment("gpu-cloud", speedup=10.0),
                 capacity=1)
    reg.register(c.ExecutionEnvironment("gpu-standby", speedup=10.0),
                 capacity=1)
    sched = pkg.sched(reg, beat_interval=REPLICA_BEAT_INTERVAL)
    if mode == "replica":
        sched.enable_replicas(2)
        sched.enable_recovery("rerun")
    elif mode is not None:
        sched.enable_recovery(mode, interval=REPLICA_CKPT_INTERVAL)
    if mode is not None:
        sched.inject_failure("gpu-cloud", at=REPLICA_FAIL_AT,
                             recover_after=10.0)
    nb = c.Notebook(f"replica-session-{n_elems}-{mode}")
    nb.add_cell("import numpy as np\n"
                f"data = np.arange({n_elems}, dtype=np.float64)", cost=4.0)
    nb.add_cell("model = float((data ** 2).sum())", cost=80.0)
    nb.add_cell("model2 = model + float(data.sum())", cost=80.0)
    nb.add_cell("model3 = model2 * 0.5 + float(data[-1])", cost=80.0)
    nb.add_cell("out = model3 / 2", cost=5.0)
    sched.add_notebook(nb, policy="cost", use_knowledge=False,
                       think=[1.0] * REPLICA_N_CELLS)
    return sched.run()


def replica_failover(pkg, n_elems):
    base = replica_arm(pkg, n_elems, None)
    reps = {m: replica_arm(pkg, n_elems, m)
            for m in ("rerun", "checkpoint", "replica")}
    overhead = {m: r.makespan - base.makespan for m, r in reps.items()}
    for r in reps.values():
        assert r.recoveries >= 1
        assert r.sessions[0].cells_run == REPLICA_N_CELLS
    assert reps["replica"].promotions == 1
    if n_elems == 500_000:
        assert overhead["checkpoint"] / max(overhead["replica"], 1e-9) >= 10
    return base, reps


@pytest.mark.parametrize("n_elems", [50_000, 500_000])
def test_bench_replica_failover_matches_the_reference(n_elems):
    both(replica_failover, n_elems)
