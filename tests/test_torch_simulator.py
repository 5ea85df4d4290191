"""The port's policy simulator and figure rows against the JAX reference's,
on the CPU.

``simulate`` under every policy on both interaction traces, with forced
scalars and through a two-env registry, gives the reference's
``SimResult``; the grids and the per-cell frequencies are equal.  The rows
of ``repro_torch.figures`` (Figs. 5-6, 8-9 and 10) equal a live run of the
reference's benchmark scripts: labels and notes exact, values within rtol
1e-12 (the reference's own speedups drift in the last ULP between
environments, so the goldens in ``tests/data`` are not compared with
``==``; ROADMAP queue C).
"""
import importlib
import io
from contextlib import redirect_stdout

import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro_torch import figures

POLICIES = ("local", "remote", "single", "block")
POINTS = [(0.1, 2), (0.5, 10), (1.0, 50), (5.0, 150), (30.0, 200), (1e9, 200)]
REF_SCRIPTS = {"fig5_fig6": "benchmarks.fig5_fig6_policy_speedups",
               "fig8_fig9": "benchmarks.fig8_fig9_ratio",
               "fig10": "benchmarks.fig10_migration_counts"}


def _result(r):
    return (type(r).__name__, r.policy, r.total_seconds, r.migrations)


@pytest.mark.parametrize("trace", sorted(ref_core.TRACES))
def test_traces_equal_the_reference(trace):
    got, want = port_core.TRACES[trace](), ref_core.TRACES[trace]()
    assert (got.name, got.order, got.costs) == \
        (want.name, want.order, want.costs)
    assert port_core.cell_frequency(got) == ref_core.cell_frequency(want)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("trace", sorted(ref_core.TRACES))
def test_simulate_gives_the_reference_result(trace, policy):
    got_tr, want_tr = port_core.TRACES[trace](), ref_core.TRACES[trace]()
    for mt, rs in POINTS:
        got = port_core.simulate(got_tr, policy, migration_time=mt,
                                 remote_speedup=rs)
        want = ref_core.simulate(want_tr, policy, migration_time=mt,
                                 remote_speedup=rs)
        assert _result(got) == _result(want), (mt, rs)
    # the fabric route: offload env and link cost from a registry
    link = {"remote_speedup": 25.0, "bandwidth": 1e8, "latency": 0.3}
    got = port_core.simulate(
        got_tr, policy, state_nbytes=5e7,
        registry=port_core.EnvironmentRegistry.two_env(**link))
    want = ref_core.simulate(
        want_tr, policy, state_nbytes=5e7,
        registry=ref_core.EnvironmentRegistry.two_env(**link))
    assert _result(got) == _result(want)


@pytest.mark.parametrize("use_registry", [False, True])
def test_policy_grid_equals_the_reference(use_registry):
    for trace in sorted(ref_core.TRACES):
        args = ([0.1, 1.0, 10.0], [2, 50, 200])
        got = port_core.policy_grid(port_core.TRACES[trace](), *args,
                                    use_registry=use_registry)
        want = ref_core.policy_grid(ref_core.TRACES[trace](), *args,
                                    use_registry=use_registry)
        assert got == want


@pytest.fixture(scope="module", params=[False, True], ids=["full", "smoke"])
def figure_rows(request):
    """Each package's rows of each figure, computed once per size."""
    smoke = request.param
    return {name: (fn(smoke),
                   importlib.import_module(REF_SCRIPTS[name]).run(smoke))
            for name, fn in figures.FIGURES.items()}


@pytest.mark.parametrize("name", sorted(REF_SCRIPTS))
def test_figure_rows_equal_a_live_reference_run(figure_rows, name):
    got, want = figure_rows[name]
    assert len(got) == len(want) > 0
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [r[2] for r in got] == [r[2] for r in want]
    for (label, g, _), (_, w, _) in zip(got, want):
        assert g == pytest.approx(w, rel=1e-12, abs=0), label


def test_headline_rows_hold_the_paper_claims(figure_rows):
    rows = {label: v for label, v, _ in figure_rows["fig5_fig6"][0]}
    for fig, trace in (("fig5", "synthetic-loops"), ("fig6", "tf-guide")):
        assert rows[f"{fig}/{trace}/block_ge_single_everywhere"] == 1.0
        assert rows[f"{fig}/{trace}/block/speedup@mig1s_rs50"] >= \
            rows[f"{fig}/{trace}/single/speedup@mig1s_rs50"]


def test_run_and_the_cli_give_every_figure_in_order():
    rows = figures.run(smoke=True)
    assert rows == [r for fn in figures.FIGURES.values() for r in fn(True)]
    out = io.StringIO()
    with redirect_stdout(out):
        figures.main(["--smoke"])
    lines = out.getvalue().splitlines()
    assert [ln.split(",")[0] for ln in lines] == [r[0] for r in rows]
