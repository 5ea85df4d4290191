"""The port's cost plane against the JAX reference's, on the CPU.

Every case of ``tests/test_cost_plane.py`` (price and hazard tags,
directional egress, asymmetric links, the analyzer's dollar helpers and
hazard surcharge, the SLO-bound dollars DP in the fleet, the zero-price
degenerate case, seeded spot hazards, data gravity, the workload families
and the CLI spec parsers) runs through both packages, and what each
returns must be equal (floats within rtol 1e-12).  The reference's golden
case is held to a live reference run and to the goldens at rtol 1e-12,
labels and notes exact, as in ``tests/test_torch_replication.py``.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from test_torch_fleet import (  # noqa: E402,F401
    PACKAGES, _cpu_budget, assert_same, both,
)
from test_torch_replication import (  # noqa: E402
    GOLDEN, assert_rows_hold, port_and_live_decision_sweeps,
)

import repro.launch.notebook as ref_cli  # noqa: E402
import repro_torch.launch.notebook as port_cli  # noqa: E402

CLI = {"reference": ref_cli, "port": port_cli}


def _cli(pkg):
    return CLI["port" if pkg is PACKAGES["port"] else "reference"]


def _raises(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


def env_price_and_hazard_tags(pkg):
    E = pkg.core.ExecutionEnvironment
    e = E("spot", speedup=8.0, price_per_hour=0.9, hazard_rate=1 / 600)
    assert e.price_per_hour == 0.9 and e.spot
    assert not E("ondemand", price_per_hour=3.0).spot
    return (e.price_per_hour, e.hazard_rate, e.spot,
            _raises(E, "bad", price_per_hour=-1.0),
            _raises(E, "bad", hazard_rate=-1.0))


def _reg(pkg, **envs):
    c = pkg.core
    reg = c.EnvironmentRegistry(default_bandwidth=1e9, default_latency=0.1)
    reg.register(c.ExecutionEnvironment("local"), home=True)
    for name, kw in envs.items():
        reg.register(c.ExecutionEnvironment(name, **kw))
    return reg


def egress_pricing_is_directional(pkg):
    reg = _reg(pkg, remote={"speedup": 10.0})
    reg.set_egress("remote", "local", 90.0)
    out = [reg.transfer_dollars(a, b, 2e9) for a, b in (
        ("remote", "local"), ("local", "remote"), ("local", "local"))]
    assert out == [180.0, 0.0, 0.0]
    return out


def asymmetric_link_via_connect_reverse_overrides(pkg):
    reg = _reg(pkg, remote={"speedup": 10.0})
    reg.connect("local", "remote", bandwidth=1e9, latency=0.1,
                egress_per_gb=0.0, reverse_bandwidth=2e8,
                reverse_egress_per_gb=0.09)
    fwd, back = reg.link("local", "remote"), reg.link("remote", "local")
    assert fwd.bandwidth == 1e9 and back.bandwidth == 2e8
    assert fwd.egress_per_gb == 0.0 and back.egress_per_gb == 0.09
    assert back.latency == fwd.latency
    return [(lk.bandwidth, lk.latency, lk.egress_per_gb)
            for lk in (fwd, back)]


def clone_topology_carries_prices_and_hazards(pkg):
    reg = _reg(pkg, spot={"speedup": 8.0, "price_per_hour": 0.9,
                          "hazard_rate": 1 / 300})
    clone = reg.clone_topology()
    assert clone["spot"].price_per_hour == 0.9
    assert clone["spot"].hazard_rate == 1 / 300
    return clone["spot"].price_per_hour, clone["spot"].hazard_rate


def _analyzer(pkg, **kw):
    c = pkg.core
    reg = _reg(pkg, ondemand={"speedup": 10.0, "price_per_hour": 3.6},
               spot={"speedup": 8.0, "price_per_hour": 0.9,
                     "hazard_rate": 1 / 100})
    an = c.MigrationAnalyzer(c.KnowledgeBase(), c.ContextDetector(),
                             registry=reg, **kw)
    return an, reg


def exec_dollars_and_transfer_dollars(pkg):
    an, reg = _analyzer(pkg, objective="dollars")
    assert an.exec_dollars(3600.0, "ondemand") == pytest.approx(3.6)
    assert an.exec_dollars(3600.0, "local") == 0.0
    reg.set_egress("spot", "local", 10.0)
    assert an.transfer_dollars(1e9, "spot", "local") == pytest.approx(10.0)
    return (an.exec_dollars(3600.0, "ondemand"),
            an.transfer_dollars(1e9, "spot", "local"))


def hazard_surcharge_scales_with_exposure(pkg):
    an, _ = _analyzer(pkg, objective="dollars")
    s1, d1 = an.hazard_surcharge("spot", 10.0, 1 << 20)
    s2, d2 = an.hazard_surcharge("spot", 20.0, 1 << 20)
    assert s2 > s1 > 0.0 and d2 >= d1 >= 0.0
    assert an.hazard_surcharge("ondemand", 20.0, 1 << 20) == (0.0, 0.0)
    return s1, d1, s2, d2


def objective_validation(pkg):
    c = pkg.core
    return (_raises(c.MigrationAnalyzer, c.KnowledgeBase(),
                    c.ContextDetector(), objective="euros"),
            _raises(c.MigrationAnalyzer, c.KnowledgeBase(),
                    c.ContextDetector(), objective="dollars"),
            _raises(_analyzer, pkg, objective="dollars", slo=-1.0))


def _run_gpu(pkg, objective, slo, *, prices=True):
    c = pkg.core
    reg = c.EnvironmentRegistry(default_bandwidth=2e8, default_latency=0.3)
    reg.register(c.ExecutionEnvironment("local"), home=True, capacity=8)
    reg.register(c.ExecutionEnvironment(
        "ondemand", speedup=10.0,
        price_per_hour=3.0 if prices else 0.0), capacity=4)
    reg.register(c.ExecutionEnvironment(
        "cheap", speedup=8.0,
        price_per_hour=0.9 if prices else 0.0), capacity=4)
    sched = pkg.sched(reg)
    rt = sched.add_notebook(c.gpu_training_notebook(f"t-{objective}"),
                            policy="horizon", use_knowledge=False,
                            objective=objective, slo=slo)
    rep = sched.run()
    return rt, rep


def slo_forces_training_off_home_and_dollars_picks_cheap(pkg):
    rt, rep = _run_gpu(pkg, "dollars", 30.0)
    assert rt.exec_env_seconds.get("cheap", 0.0) > 0.0
    assert rt.exec_env_seconds.get("ondemand", 0.0) == 0.0
    assert rep.slo_attainment == 1.0 and rep.total_dollars > 0.0
    rt2, rep2 = _run_gpu(pkg, "seconds", 30.0)
    assert rt2.exec_env_seconds.get("ondemand", 0.0) > 0.0
    assert rep2.total_dollars > rep.total_dollars
    return rep, rt.exec_env_seconds, rep2, rt2.exec_env_seconds


def without_slo_dollars_dp_stays_on_free_home(pkg):
    rt, rep = _run_gpu(pkg, "dollars", None)
    assert rep.total_dollars == 0.0
    assert {e for e, s in rt.exec_env_seconds.items() if s > 0} == {"local"}
    return rep


def zero_price_fleet_matches_seconds_dp_schedule(pkg):
    rt_d, rep_d = _run_gpu(pkg, "dollars", None, prices=False)
    rt_s, rep_s = _run_gpu(pkg, "seconds", None, prices=False)
    assert rep_d.makespan == rep_s.makespan
    assert rep_d.actual_env_seconds == rep_s.actual_env_seconds
    assert rt_d.exec_env_seconds == rt_s.exec_env_seconds
    assert rep_d.total_dollars == rep_s.total_dollars == 0.0
    return rep_d, rep_s


def _spot_fleet(pkg, seed):
    c = pkg.core
    reg = c.EnvironmentRegistry(default_bandwidth=2e8, default_latency=0.3)
    reg.register(c.ExecutionEnvironment("local"), home=True, capacity=8)
    reg.register(c.ExecutionEnvironment(
        "spot", speedup=8.0, price_per_hour=0.9, hazard_rate=1 / 30),
        capacity=4)
    sched = pkg.sched(reg)
    sched.enable_recovery("checkpoint", interval=15.0)
    for i in range(2):
        sched.add_notebook(c.gpu_training_notebook(f"s{i}"),
                           policy="horizon", use_knowledge=False,
                           objective="dollars", slo=30.0)
    injected = sched.enable_spot_hazards(seed=seed, recover_after=10.0)
    return sched, injected


def spot_hazards_inject_through_failure_machinery(pkg):
    sched, injected = _spot_fleet(pkg, seed=2)
    assert injected > 0
    rep = sched.run()
    assert rep.preemptions == injected
    assert rep.recoveries > 0 and rep.total_dollars > 0.0
    return injected, rep


def seeded_spot_run_is_deterministic(pkg):
    rep_a = _spot_fleet(pkg, seed=2)[0].run()
    rep_b = _spot_fleet(pkg, seed=2)[0].run()
    assert rep_a == rep_b
    return rep_a


def another_seed_draws_other_preemptions(pkg):
    """The second half of the reference's determinism case, run apart so
    that each half stays short."""
    rep_a = _spot_fleet(pkg, seed=2)[0].run()
    rep_c = _spot_fleet(pkg, seed=3)[0].run()
    assert list(rep_c.failures) != list(rep_a.failures)
    return rep_c


def home_env_never_gets_hazard_injection(pkg):
    c = pkg.core
    reg = c.EnvironmentRegistry()
    reg.register(c.ExecutionEnvironment("local", hazard_rate=0.0), home=True)
    reg.register(c.ExecutionEnvironment("spot", speedup=4.0,
                                        hazard_rate=1 / 10))
    sched = pkg.sched(reg)
    sched.enable_spot_hazards(seed=0, horizon=100.0)
    assert all(env == "spot" for env, _at, _rec in sched._failures)
    return list(sched._failures)


def dollars_dp_keeps_compute_at_the_data(pkg):
    c = pkg.core
    reg = c.EnvironmentRegistry(default_bandwidth=2e8, default_latency=0.3)
    reg.register(c.ExecutionEnvironment("local"), home=True, capacity=8)
    reg.register(c.ExecutionEnvironment("near", speedup=6.0,
                                        price_per_hour=1.0), capacity=4)
    reg.register(c.ExecutionEnvironment("far", speedup=8.0,
                                        price_per_hour=3.0), capacity=4)
    for src in ("local", "near"):
        reg.set_egress(src, "far", 40.0)
        reg.set_egress("far", src, 80.0)
    sched = pkg.sched(reg)
    rt = sched.add_notebook(c.remote_sensing_notebook("rs", scenes=3),
                            policy="horizon", use_knowledge=False,
                            objective="dollars", slo=12.0)
    rep = sched.run()
    assert rt.exec_env_seconds.get("near", 0.0) > 0.0
    assert rt.exec_env_seconds.get("far", 0.0) == 0.0
    assert rep.egress_dollars == 0.0 and rep.slo_attainment == 1.0
    return rep, rt.exec_env_seconds


def workload_factories_execute_end_to_end(pkg):
    c = pkg.core
    out = []
    for nb in (c.gpu_training_notebook(steps=2, step_cost=5.0),
               c.remote_sensing_notebook(scenes=2, band_cost=5.0)):
        rt = pkg.runtime(nb, registry=_reg(pkg, remote={"speedup": 10.0}),
                         use_knowledge=False)
        for i in range(len(nb.cells)):
            rt.run_cell(i)
        home = rt.envs[rt.analyzer.home].state
        assert home
        out.append((rt.clock.now(), sorted(home.names()),
                    [list(cell.annotations) for cell in nb.cells]))
        rt.close()
    return out


def parse_price_spec(pkg):
    p = _cli(pkg).parse_price_spec
    assert p("remote:3.0") == ("remote", 3.0)
    return [p("remote:3.0")] + [_raises(p, bad) for bad in
                                ("remote", "remote:-1", "remote:x")]


def parse_hazard_spec_units(pkg):
    p = _cli(pkg).parse_hazard_spec
    env, rate = p("spot:6/h")
    assert env == "spot" and rate == pytest.approx(6 / 3600)
    assert p("spot:0.1/s")[1] == pytest.approx(0.1)
    assert p("spot:6")[1] == pytest.approx(6 / 3600)
    return [p("spot:6/h"), p("spot:0.1/s"), p("spot:6")] + [
        _raises(p, bad) for bad in ("spot", "spot:-6/h", "spot:6/d")]


def parse_egress_spec(pkg):
    p = _cli(pkg).parse_egress_spec
    assert p("remote:local:0.09") == ("remote", "local", 0.09)
    return [p("remote:local:0.09")] + [
        _raises(p, bad) for bad in ("remote:0.09", "remote:local:-1",
                                    "a:b:x")]


CASES = [
    env_price_and_hazard_tags, egress_pricing_is_directional,
    asymmetric_link_via_connect_reverse_overrides,
    clone_topology_carries_prices_and_hazards,
    exec_dollars_and_transfer_dollars, hazard_surcharge_scales_with_exposure,
    objective_validation,
    slo_forces_training_off_home_and_dollars_picks_cheap,
    without_slo_dollars_dp_stays_on_free_home,
    zero_price_fleet_matches_seconds_dp_schedule,
    spot_hazards_inject_through_failure_machinery,
    seeded_spot_run_is_deterministic, another_seed_draws_other_preemptions,
    home_env_never_gets_hazard_injection,
    dollars_dp_keeps_compute_at_the_data,
    workload_factories_execute_end_to_end,
    parse_price_spec, parse_hazard_spec_units, parse_egress_spec,
]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_cost_plane_case_matches_the_reference(case):
    both(case)


def test_fig_decisions_bit_identical_with_cost_plane_in_tree():
    """Zero prices, no hazards, symmetric links: the port's fig5/fig11
    decision sweeps equal a live reference run and the committed goldens,
    labels and notes exact, values within rtol 1e-12."""
    golden = json.loads(GOLDEN.read_text())
    (p5, p11), (r5, r11) = port_and_live_decision_sweeps()
    for got, live, gold in ((p5, r5, golden["fig5_fig6"]),
                            (p11, r11, golden["fig11"])):
        assert_rows_hold(got, live)
        assert_rows_hold(got, gold)
