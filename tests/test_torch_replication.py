"""The port's live delta replication against the JAX reference's, on the CPU.

Every case of ``tests/test_replication.py`` (trickle, bank and claim;
banks invisible until claimed; tombstones and supersedes charged to the
one waste ledger; liveness pruning; the bus events; recovery forgetting
banks; the scheduler's report fields) runs through both packages, and
what each returns must be equal.  The reference's golden case compares
the fig5/fig11 decision sweeps with committed goldens that the reference
itself now misses in the last ULP; here the port's sweeps are held to a
live reference run and to the goldens at rtol 1e-12, labels and notes
exact.
"""
import functools
import json
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_fleet import (  # noqa: E402,F401
    PACKAGES, _cpu_budget, assert_same, both,
)

import repro.core.telemetry as ref_T  # noqa: E402
import repro_torch.core.telemetry as port_T  # noqa: E402
from repro_torch import figures  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "fig_decisions_golden.json"
TELEMETRY = {"reference": ref_T, "port": port_T}


def _T(pkg):
    return TELEMETRY["port" if pkg is PACKAGES["port"] else "reference"]


def _replicated_runtime(pkg):
    c = pkg.core
    nb = c.Notebook("rep-demo")
    nb.add_cell("import numpy as np\n"
                "a = np.arange(4000, dtype=np.float64)\n"
                "b = np.arange(100, dtype=np.float64)", cost=0.1)
    nb.add_cell("c = float(a.sum() + b.sum())", cost=30.0)
    nb.add_cell("d = c + 1", cost=0.1)
    rt = pkg.runtime(
        nb, envs={"local": c.ExecutionEnvironment("local"),
                  "remote": c.ExecutionEnvironment("remote", speedup=10.0)},
        policy="cost", use_knowledge=False, latency=0.01, bandwidth=1e6)
    return nb, rt, rt.attach_replicator(rate=1e9, top_k=2)


def _bank(rep):
    return {dst: {n: e.nbytes for n, e in names.items()}
            for dst, names in rep.banked.items()}


def trickle_banks_then_claim_ships_manifest_only(pkg):
    nb, rt, rep = _replicated_runtime(pkg)
    rt.run_cell(0)
    shipped = rep.step(rt.clock.now() + 1.0, budget_bytes=1 << 30)
    assert shipped > 0 and "a" in rep.banked.get("remote", {})
    banked_before = rep.banked_bytes("remote")
    assert banked_before == shipped
    rt.run_cell(1)
    mig = next(m for m in rt.engine.log if m.dst == "remote" and not m.noop)
    assert set(mig.claimed) >= {"a"}
    assert mig.nbytes < banked_before / 10
    assert rep.claimed_bytes > 0
    assert "remote" not in rep.banked or "a" not in rep.banked["remote"]
    want = float(np.arange(4000, dtype=np.float64).sum()
                 + np.arange(100, dtype=np.float64).sum())
    assert float(rt.envs["remote"].state["c"]) == pytest.approx(want)
    out = (shipped, sorted(mig.claimed), mig.nbytes, rep.claimed_bytes,
           _bank(rep), rt.clock.now())
    rt.close()
    return out


def trickle_does_not_touch_target_namespace_until_claim(pkg):
    nb, rt, rep = _replicated_runtime(pkg)
    rt.run_cell(0)
    rep.step(rt.clock.now() + 1.0, budget_bytes=1 << 30)
    assert "a" in rep.banked.get("remote", {})
    assert "a" not in rt.envs["remote"].state.ns
    out = _bank(rep), sorted(rt.envs["remote"].state.ns)
    rt.close()
    return out


def midtrickle_redefinition_tombstones_bank_and_charges_waste(pkg):
    nb, rt, rep = _replicated_runtime(pkg)
    rt.run_cell(0)
    rep.step(rt.clock.now() + 1.0, budget_bytes=1 << 30)
    wasted_entry = rep.banked["remote"]["a"].nbytes
    assert wasted_entry > 0
    before = rt.engine.prefetch_wasted_bytes
    rt.run_cell(0)
    assert "a" not in rep.banked.get("remote", {})
    assert rt.engine.prefetch_wasted_bytes >= before + wasted_entry
    assert rep.cancelled_names >= 1
    cancels = [m for m in rt.bus.messages()
               if m.type == _T(pkg).STATE_TRICKLE_CANCELLED]
    assert cancels and "a" in cancels[-1].payload["names"]
    out = (wasted_entry, rt.engine.prefetch_wasted_bytes,
           rep.cancelled_names, sorted(cancels[-1].payload["names"]))
    rt.close()
    return out


def superseded_trickle_charges_old_bytes_to_waste_ledger(pkg):
    nb, rt, rep = _replicated_runtime(pkg)
    rt.run_cell(0)
    rep.step(rt.clock.now() + 1.0, budget_bytes=1 << 30)
    old = rep.banked["remote"]["a"].nbytes
    rt.envs["local"].execute("a = a * 2.0")
    rt.envs["local"].state.mark_dirty(["a"])
    before = rt.engine.prefetch_wasted_bytes
    rep.step(rt.clock.now() + 2.0, budget_bytes=1 << 30)
    assert rep.banked["remote"]["a"].nbytes > 0
    assert rt.engine.prefetch_wasted_bytes >= before + old
    out = old, _bank(rep), rt.engine.prefetch_wasted_bytes
    rt.close()
    return out


def liveness_prunes_dead_names_from_trickle_and_return(pkg):
    c = pkg.core
    nb = c.Notebook("rep-dead")
    nb.add_cell("import numpy as np\n"
                "big_dead = np.arange(50000, dtype=np.float64)\n"
                "keep = np.arange(100, dtype=np.float64)", cost=0.1)
    nb.add_cell("r = float(keep.sum())", cost=30.0)
    nb.add_cell("s = r + 1", cost=0.1)
    rt = pkg.runtime(
        nb, envs={"local": c.ExecutionEnvironment("local"),
                  "remote": c.ExecutionEnvironment("remote", speedup=10.0)},
        policy="cost", use_knowledge=False, latency=0.01, bandwidth=1e6)
    rep = rt.attach_replicator(rate=1e9, liveness=True)
    rt.run_cell(0)
    remaining = [nb.cells[1].source, nb.cells[2].source]
    rep.step(rt.clock.now() + 1.0, remaining_sources=remaining,
             budget_bytes=1 << 30)
    banked = rep.banked.get("remote", {})
    assert "keep" in banked and "big_dead" not in banked
    rt.run_cell(1)
    shipped = {n for m in rt.engine.log for n in m.names}
    assert "big_dead" not in shipped
    assert float(rt.envs["remote"].state["r"]) == pytest.approx(
        float(np.arange(100, dtype=np.float64).sum()))
    out = sorted(shipped), [m.nbytes for m in rt.engine.log]
    rt.close()
    return out


def replication_events_on_bus(pkg):
    nb, rt, rep = _replicated_runtime(pkg)
    rt.run_cell(0)
    rep.step(rt.clock.now() + 1.0, budget_bytes=1 << 30)
    rt.run_cell(1)
    T = _T(pkg)
    kinds = {T.STATE_TRICKLED, T.STATE_TRICKLE_CLAIMED,
             T.STATE_TRICKLE_CANCELLED}
    seen = [(m.type, sorted(m.payload.get("names", [])))
            for m in rt.bus.messages() if m.type in kinds]
    types_ = [t for t, _ in seen]
    assert T.STATE_TRICKLED in types_ and T.STATE_TRICKLE_CLAIMED in types_
    rt.close()
    return seen


def recover_from_failure_forgets_banks(pkg):
    nb, rt, rep = _replicated_runtime(pkg)
    rt.run_cell(0)
    rep.step(rt.clock.now() + 1.0, budget_bytes=1 << 30)
    wasted_entry = rep.banked_bytes("remote")
    assert wasted_entry > 0
    before = rt.engine.prefetch_wasted_bytes
    rt.recover_from_failure("remote")
    assert rep.banked_bytes("remote") == 0
    assert rt.engine.prefetch_wasted_bytes >= before + wasted_entry
    out = wasted_entry, rt.engine.prefetch_wasted_bytes
    rt.close()
    return out


def _fleet(pkg, replicate):
    c = pkg.core
    reg = c.EnvironmentRegistry(default_bandwidth=1e6, default_latency=0.01)
    reg.register(c.ExecutionEnvironment("local"), home=True, capacity=4)
    reg.register(c.ExecutionEnvironment("remote", speedup=10.0), capacity=4)
    sched = pkg.sched(reg)
    nb = c.Notebook("fleet-rep")
    nb.add_cell("import numpy as np\n"
                "v = np.arange(4000, dtype=np.float64)", cost=0.1)
    nb.add_cell("t = float(v.sum())", cost=30.0)
    nb.add_cell("u = t + 1", cost=0.1)
    sched.add_notebook(nb, plan=[0, 1, 2], policy="cost",
                       use_knowledge=False, think=[5.0, 5.0, 5.0])
    if replicate:
        sched.enable_replication(rate=1e9, interval=1.0)
    return sched


def scheduler_replication_report_fields(pkg):
    rep = _fleet(pkg, True).run()
    assert rep.trickled_bytes > 0 and rep.trickle_claimed_bytes > 0
    s = rep.sessions[0]
    assert s.trickled_bytes == rep.trickled_bytes
    assert s.trickle_claimed_bytes == rep.trickle_claimed_bytes
    assert rep.wasted_speculation_bytes >= 0
    return rep


def scheduler_without_replication_reports_zero_trickle(pkg):
    rep = _fleet(pkg, False).run()
    assert rep.trickled_bytes == 0 and rep.trickle_claimed_bytes == 0
    return rep


CASES = [
    trickle_banks_then_claim_ships_manifest_only,
    trickle_does_not_touch_target_namespace_until_claim,
    midtrickle_redefinition_tombstones_bank_and_charges_waste,
    superseded_trickle_charges_old_bytes_to_waste_ledger,
    liveness_prunes_dead_names_from_trickle_and_return,
    replication_events_on_bus,
    recover_from_failure_forgets_banks,
    scheduler_replication_report_fields,
    scheduler_without_replication_reports_zero_trickle,
]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_replication_case_matches_the_reference(case):
    both(case)


# -- the degenerate case: the figure sweeps with replication off ---------

def _port_benchmark(name):
    """A benchmark module of the reference with its imports rebound to the
    port and the port's reducer on the CPU."""
    path = ROOT / "benchmarks" / f"{name}.py"
    src = path.read_text().replace("from repro.core import",
                                   "from repro_torch.core import")
    mod = types.ModuleType(f"port_{name}")
    exec(compile(src, str(path), "exec"), mod.__dict__)  # noqa: S102
    if hasattr(mod, "StateReducer"):
        mod.StateReducer = functools.partial(mod.StateReducer, device="cpu")
    return mod


def assert_rows_hold(got, want):
    """Labels and notes exact; values within rtol 1e-12."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2] == w[2], (g, w)
        assert g[1] == pytest.approx(w[1], rel=1e-12, abs=0), g[0]


def port_and_live_decision_sweeps():
    from benchmarks import fig5_fig6_policy_speedups, fig11_knowledge_policy
    port = ([list(r) for r in figures.fig5_fig6(smoke=True)],
            [list(r) for r in _port_benchmark(
                "fig11_knowledge_policy").run(smoke=True)])
    live = ([list(r) for r in fig5_fig6_policy_speedups.run(smoke=True)],
            [list(r) for r in fig11_knowledge_policy.run(smoke=True)])
    return port, live


def test_fig_decisions_bit_identical_with_replication_off():
    """No replicator attached (the default): the port's fig5/fig11 decision
    sweeps equal a live reference run and the committed goldens, labels
    and notes exact, values within rtol 1e-12."""
    golden = json.loads(GOLDEN.read_text())
    (p5, p11), (r5, r11) = port_and_live_decision_sweeps()
    for got, live, gold in ((p5, r5, golden["fig5_fig6"]),
                            (p11, r11, golden["fig11"])):
        assert_rows_hold(got, live)
        assert_rows_hold(got, gold)
