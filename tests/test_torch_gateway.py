"""The port's gateway against the JAX reference's, on the CPU.

* Every case of ``tests/test_gateway.py`` (attach and detach at any time,
  the warm pool, fair-share admission and quotas, the indexed hot paths,
  the wire frontend) runs through both packages; the ``GatewayReport``s
  and what else each case returns must be equal, wall-clock fields
  (``decision_ms_*``) aside.
* ``benchmarks/bench_gateway.py``'s smoke storm (300 sessions) and its
  warm-pool sweep (30 sessions), rebuilt here for each package.
* Across packages: a reference client sends ATTACH frames into the port's
  ``WireFrontend``, and a port client into the reference's, each frame
  encoded by the sender's wire module and decoded by the receiver's.  The
  sessions, acks and DETACH-complete frames equal a storm inside one
  package.
* The port without jax or the reference, in a subprocess, and the port's
  ``device=`` handling.
"""
import queue
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_fleet import _cpu_budget, assert_same  # noqa: E402,F401
from test_torch_notebook_cli import (  # noqa: E402
    assert_reports_agree, serve_cli,
)

import repro.core.gateway as ref_gateway  # noqa: E402
import repro.core.scheduler as ref_scheduler  # noqa: E402
import repro.core.transport as ref_transport  # noqa: E402
import repro.core.wire as ref_wire  # noqa: E402
import repro.launch.serve as ref_serve  # noqa: E402
import repro_torch.core.gateway as port_gateway  # noqa: E402
import repro_torch.core.scheduler as port_scheduler  # noqa: E402
import repro_torch.core.transport as port_transport  # noqa: E402
import repro_torch.core.wire as port_wire  # noqa: E402
from repro.core import fabric as ref_fabric  # noqa: E402
from repro.core import notebook as ref_notebook  # noqa: E402
from repro_torch.core import fabric as port_fabric  # noqa: E402
from repro_torch.core import notebook as port_notebook  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


class Pkg:
    def __init__(self, name, gateway, scheduler, transport, wire, fabric,
                 notebook, device_kw):
        self.name = name
        self.gateway, self.scheduler = gateway, scheduler
        self.transport, self.wire = transport, wire
        self.fabric, self.notebook = fabric, notebook
        self.device_kw = device_kw

    def service(self, reg, **kw):
        return self.gateway.GatewayService(reg, **self.device_kw, **kw)


PACKAGES = {
    "reference": Pkg("reference", ref_gateway, ref_scheduler, ref_transport,
                     ref_wire, ref_fabric, ref_notebook, {}),
    "port": Pkg("port", port_gateway, port_scheduler, port_transport,
                port_wire, port_fabric, port_notebook, {"device": "cpu"}),
}
WALL_FIELDS = ("decision_ms_p50", "decision_ms_p99")


def sim(rep):
    """A GatewayReport's sim-derived fields (wall-clock ones dropped)."""
    out = {f: getattr(rep, f) for f in rep.__dataclass_fields__
           if f not in WALL_FIELDS}
    out["session_reports"] = sorted(out["session_reports"],
                                    key=lambda r: r.session)
    return out


def both(fn, *args, **kw):
    outs = {name: fn(pkg, *args, **kw) for name, pkg in PACKAGES.items()}
    assert_same(outs["port"], outs["reference"])
    return outs["port"]


def _registry(pkg, gpu_capacity=8):
    E = pkg.fabric.ExecutionEnvironment
    reg = pkg.fabric.EnvironmentRegistry()
    reg.register(E("local"), home=True, capacity=1024)
    reg.register(E("gpu", speedup=8.0), capacity=gpu_capacity)
    reg.connect("local", "gpu", bandwidth=1e9, latency=0.05)
    return reg


def _nb(pkg, i=0):
    nb = pkg.notebook.Notebook(f"nb{i}")
    nb.add_cell("x = 2.0", cost=0.5)
    nb.add_cell("y = x * 3.0", cost=30.0)
    nb.add_cell("z = y + 1.0", cost=1.0)
    return nb


def _gateway(pkg, **kw):
    kw.setdefault("policy", "cost")
    kw.setdefault("use_knowledge", False)
    return pkg.service(_registry(pkg), **kw)


def _drain(client):
    frames = []
    while (f := client.poll()) is not None:
        frames.append(f)
    return frames


# -- attach / detach lifecycle ---------------------------------------------

def sessions_attach_and_complete(pkg):
    gw = _gateway(pkg, warm_pool=4)
    sids = [gw.attach(_nb(pkg, i), think=[1.0, 1.0, 1.0]) for i in range(6)]
    rep = gw.run()
    assert rep.sessions == 6 and rep.completed == 6 and rep.errors == 0
    assert {r.session for r in rep.session_reports} == set(sids)
    assert all(r.cells_run == 3 for r in rep.session_reports)
    return sids, sim(rep)


def attach_during_run_is_admitted(pkg):
    gw = _gateway(pkg, warm_pool=2)
    gw.attach(_nb(pkg, 0), think=[5.0, 5.0, 5.0])
    late = []
    gw.loop.call_at(7.0, lambda: late.append(
        gw.attach(_nb(pkg, 1), think=[1.0, 1.0, 1.0])))
    rep = gw.run()
    assert rep.sessions == 2 and rep.completed == 2
    late_rep = [r for r in rep.session_reports if r.session == late[0]][0]
    assert late_rep.cells_run == 3
    return sim(rep)


def detach_mid_session_frees_slot_and_records_partial(pkg):
    gw = _gateway(pkg, warm_pool=2)
    sid = gw.attach(_nb(pkg, 0), think=[100.0, 100.0, 100.0])
    gw.loop.call_at(50.0, gw.detach, sid)
    rep = gw.run()
    assert rep.client_detached == 1
    (r,) = rep.session_reports
    assert 0 < r.cells_run < 3 and r.reason == "client"
    return sim(rep)


def detach_unknown_session_raises_keyerror(pkg):
    with pytest.raises(KeyError) as e:
        _gateway(pkg).detach("ghost")
    return str(e.value)


def failing_cell_detaches_with_error_not_crash(pkg):
    gw = _gateway(pkg, warm_pool=1)
    nb = pkg.notebook.Notebook("bad")
    nb.add_cell("x = 1", cost=0.1)
    nb.add_cell("boom()", cost=0.1)
    gw.attach(nb)
    gw.attach(_nb(pkg, 1))
    rep = gw.run()
    assert rep.errors == 1 and rep.completed == 1
    bad = [r for r in rep.session_reports if r.notebook == "bad"][0]
    assert bad.reason == "error:NameError" and bad.cells_run == 1
    return sim(rep)


# -- warm pool ----------------------------------------------------------------

def warm_attach_skips_cold_start_and_cold_attach_pays_it(pkg):
    gw = _gateway(pkg, warm_pool=2, cold_start=8.0)
    for i in range(3):
        gw.attach(_nb(pkg, i))
    rep = gw.run()
    assert rep.sessions == 3 and gw.pool.hits == 2 and gw.pool.misses == 1
    assert rep.warm_attach_p99 == 0.0
    assert rep.cold_attach_p99 == pytest.approx(8.0)
    return sim(rep)


def pool_refills_in_background(pkg):
    gw = _gateway(pkg, warm_pool=2, cold_start=5.0)
    for i in range(6):
        gw.attach(_nb(pkg, i), at=i * 10.0)
    rep = gw.run()
    assert gw.pool.misses == 0 and gw.pool.hits == 6
    assert gw.pool.refills >= 4 and rep.cold_attach_p99 == 0.0
    return sim(rep)


def cold_provision_walks_the_lifecycle_audit_log(pkg):
    gw = _gateway(pkg, warm_pool=0, cold_start=5.0)
    gw.attach(_nb(pkg, 0))
    rep = gw.run()
    assert rep.sessions == 1 and gw.pool.misses == 1
    (r,) = gw.reports
    assert r.attach_wait == pytest.approx(5.0)
    worker, delay = gw.pool.acquire(gw.loop.now())
    assert delay == 5.0 and not worker.warm
    states = [(env, to) for _t, env, _old, to in
              worker.registry.lifecycle_log]
    assert ("gpu", "down") in states and ("gpu", "provisioning") in states
    return sim(rep), worker.registry.lifecycle_log


def warm_pool_zero_disables_pooling(pkg):
    gw = _gateway(pkg, warm_pool=0, cold_start=3.0)
    for i in range(3):
        gw.attach(_nb(pkg, i))
    rep = gw.run()
    assert gw.pool.hits == 0 and gw.pool.misses == 3
    assert all(w == pytest.approx(3.0) for w in gw.cold_waits)
    return sim(rep), gw.cold_waits


# -- fair share and quotas ----------------------------------------------------

def tenant_quota_bounds_concurrency(pkg):
    gw = _gateway(pkg, warm_pool=8)
    gw.add_tenant("capped", quota=2)
    for i in range(6):
        gw.attach(_nb(pkg, i), tenant="capped", think=[1.0, 1.0, 1.0])
    concurrency = []
    gw.loop.every(5.0, lambda: concurrency.append(
        gw.tenants["capped"].admitted))
    rep = gw.run(until=500.0)
    assert rep.sessions == 6 and rep.completed == 6
    assert max(concurrency) <= 2
    assert gw.tenants["capped"].admission_wait > 0
    return sim(rep), concurrency


def max_sessions_caps_the_whole_gateway(pkg):
    gw = _gateway(pkg, warm_pool=8, max_sessions=3)
    for i in range(9):
        gw.attach(_nb(pkg, i), think=[1.0, 1.0, 1.0])
    rep = gw.run()
    assert rep.sessions == 9 and rep.completed == 9
    assert rep.peak_concurrent <= 3
    return sim(rep)


def drr_divides_admission_by_weight(pkg):
    gw = _gateway(pkg, warm_pool=16, max_sessions=3)
    gw.add_tenant("heavy", weight=2.0)
    gw.add_tenant("light", weight=1.0)
    for i in range(12):
        gw.attach(_nb(pkg, i), tenant="heavy", think=[1.0])
        gw.attach(_nb(pkg, i), tenant="light", think=[1.0])
    rep = gw.run()
    assert rep.sessions == 24 and rep.completed == 24
    heavy = gw.tenants["heavy"].admission_wait
    light = gw.tenants["light"].admission_wait
    assert heavy < light and light / max(heavy, 1e-9) > 1.3
    return sim(rep)


def unknown_tenant_is_autoregistered_with_defaults(pkg):
    gw = _gateway(pkg, warm_pool=2)
    gw.attach(_nb(pkg, 0), tenant="walk-in")
    rep = gw.run()
    assert rep.completed == 1 and gw.tenants["walk-in"].quota is None
    return sim(rep)


def add_tenant_validates_inputs(pkg):
    gw = _gateway(pkg)
    msgs = []
    for kw in ({"weight": 0.0}, {"quota": 0}):
        with pytest.raises(ValueError) as e:
            gw.add_tenant("bad", **kw)
        msgs.append(str(e.value))
    return msgs


# -- indexed hot paths --------------------------------------------------------

def wake_heap_prunes_arbiter_without_scanning_sessions(pkg):
    gw = _gateway(pkg, warm_pool=8, prune_interval=5.0)
    for i in range(20):
        gw.attach(_nb(pkg, i), at=i * 2.0, think=[10.0, 10.0, 10.0])
    rep = gw.run()
    assert rep.completed == 20 and rep.pruned_intervals > 0
    assert all(e[2].detached for e in gw._wake_heap)
    return sim(rep)


def session_clock_gap_absorbs_into_think_time(pkg):
    gw = _gateway(pkg, warm_pool=2)
    gw.attach(_nb(pkg, 0), think=[7.0, 3.0])
    rep = gw.run()
    (r,) = rep.session_reports
    assert rep.completed == 1 and r.makespan >= 10.0
    return sim(rep)


def percentile_is_nearest_rank(pkg):
    p = pkg.gateway.percentile
    xs = list(range(1, 101))
    out = [p([], 99), p([5.0], 50), p(xs, 50), p(xs, 99), p(xs, 100)]
    assert out == [0.0, 5.0, 50, 99, 100]
    return out


# -- wire frontend ------------------------------------------------------------

def _frames(pkg, frames):
    """Client-side frames as (type, decoded payload)."""
    w = pkg.wire
    out = []
    for f in frames:
        if f.ftype in (w.ACK, w.ERROR):
            out.append((f.ftype, w.parse_json(f)))
        elif f.ftype == w.DETACH:
            out.append((f.ftype, w.parse_detach(f)))
        else:
            out.append((f.ftype, None))
    return out


def wire_storm_end_to_end(pkg):
    gw = _gateway(pkg, warm_pool=4, cold_start=2.0)
    client, server = pkg.transport.LoopbackTransport.pair()
    gw.add_frontend(server)
    sids = pkg.gateway.poisson_attach_storm(
        gw, n_sessions=10, rate=10.0, think_mean=5.0,
        make_notebook=lambda i: _nb(pkg, i), seed=7, client=client)
    rep = gw.run()
    assert rep.sessions == 10 and rep.completed == 10
    assert {r.session for r in rep.session_reports} == set(sids)
    frames = _frames(pkg, _drain(client))
    acks = sum(1 for t, _ in frames if t == pkg.wire.ACK)
    completes = [p for t, p in frames if t == pkg.wire.DETACH]
    assert acks == 20 and len(completes) == 10
    assert all(reason == "complete" for _, reason in completes)
    return sids, sim(rep), frames


def wire_detach_mid_session(pkg):
    gw = _gateway(pkg, warm_pool=2, cold_start=1.0)
    client, server = pkg.transport.LoopbackTransport.pair()
    gw.add_frontend(server)
    gw.expect_storm(1)
    nb = _nb(pkg, 0)
    gw.loop.call_at(0.0, client.send, pkg.wire.attach_frame(
        "default", nb.name,
        [{"source": c.source, "cost": c.cost} for c in nb.cells],
        think=[1000.0], session="s-long"))
    gw.loop.call_at(10.0, client.send, pkg.wire.detach_frame("s-long"))
    rep = gw.run()
    assert rep.client_detached == 1
    assert rep.session_reports[0].cells_run == 1
    return sim(rep), _frames(pkg, _drain(client))


def wire_detach_unknown_session_gets_error_frame(pkg):
    gw = _gateway(pkg, warm_pool=0)
    client, server = pkg.transport.LoopbackTransport.pair()
    gw.add_frontend(server)
    gw.expect_storm(0)
    client.send(pkg.wire.detach_frame("ghost"))
    gw.run(until=1.0)
    frames = _frames(pkg, _drain(client))
    assert pkg.wire.ERROR in [t for t, _ in frames]
    return frames


def frontend_rejects_noncontrol_frames(pkg):
    gw = _gateway(pkg, warm_pool=0)
    client, server = pkg.transport.LoopbackTransport.pair()
    gw.add_frontend(server)
    gw.expect_storm(0)
    client.send(pkg.wire.json_frame(pkg.wire.EXEC, {"source": "x = 1"}))
    gw.run(until=1.0)
    frames = _frames(pkg, _drain(client))
    assert [t for t, _ in frames] == [pkg.wire.ERROR]
    return frames


def duplicate_session_id_is_uniquified_not_clobbered(pkg):
    gw = _gateway(pkg, warm_pool=4)
    gw.attach(_nb(pkg, 0), session="dup", think=[5.0])
    gw.attach(_nb(pkg, 1), session="dup", think=[5.0])
    rep = gw.run()
    assert rep.sessions == 2 and rep.completed == 2
    ids = {r.session for r in rep.session_reports}
    assert len(ids) == 2 and "dup" in ids
    return sim(rep)


GATEWAY_CASES = [
    sessions_attach_and_complete, attach_during_run_is_admitted,
    detach_mid_session_frees_slot_and_records_partial,
    detach_unknown_session_raises_keyerror,
    failing_cell_detaches_with_error_not_crash,
    warm_attach_skips_cold_start_and_cold_attach_pays_it,
    pool_refills_in_background,
    cold_provision_walks_the_lifecycle_audit_log,
    warm_pool_zero_disables_pooling, tenant_quota_bounds_concurrency,
    max_sessions_caps_the_whole_gateway, drr_divides_admission_by_weight,
    unknown_tenant_is_autoregistered_with_defaults,
    add_tenant_validates_inputs,
    wake_heap_prunes_arbiter_without_scanning_sessions,
    session_clock_gap_absorbs_into_think_time, percentile_is_nearest_rank,
    wire_storm_end_to_end, wire_detach_mid_session,
    wire_detach_unknown_session_gets_error_frame,
    frontend_rejects_noncontrol_frames,
    duplicate_session_id_is_uniquified_not_clobbered,
]


@pytest.mark.parametrize("case", GATEWAY_CASES, ids=lambda f: f.__name__)
def test_gateway_case_matches_the_reference(case):
    both(case)


# -- benchmarks/bench_gateway.py: the smoke storm and the warm-pool sweep -----
# (COLD_START, THINK_MEAN, GPU_CAPACITY, make_registry and make_notebook
# at bench_gateway.py:49-72)

COLD_START = 5.0
THINK_MEAN = 120.0
GPU_CAPACITY = 256


def bench_registry(pkg, local_capacity):
    E = pkg.fabric.ExecutionEnvironment
    reg = pkg.fabric.EnvironmentRegistry(default_bandwidth=1e9,
                                         default_latency=0.05)
    reg.register(E("local"), home=True, capacity=local_capacity)
    reg.register(E("gpu-cloud", speedup=8.0), capacity=GPU_CAPACITY)
    reg.connect("local", "gpu-cloud", bandwidth=5e8, latency=0.3)
    return reg


def bench_notebook(pkg, i):
    nb = pkg.notebook.Notebook(f"user-{i % 16}")
    nb.add_cell("x = 2.0", cost=0.5)
    nb.add_cell("y = x * 3.0", cost=30.0)
    nb.add_cell("z = y + 1.0", cost=1.0)
    return nb


def bench_storm(pkg, n_sessions=300):
    gw = pkg.service(bench_registry(pkg, n_sessions + 64), warm_pool=64,
                     cold_start=COLD_START, policy="cost",
                     use_knowledge=False)
    gw.add_tenant("research", weight=2.0)
    gw.add_tenant("teaching", weight=1.0)
    pkg.gateway.poisson_attach_storm(
        gw, n_sessions=n_sessions, rate=n_sessions / 5.0,
        think_mean=THINK_MEAN, make_notebook=lambda i: bench_notebook(pkg, i),
        tenants=("research", "teaching"), seed=11)
    rep = gw.run()
    assert rep.sessions == n_sessions and rep.errors == 0
    assert rep.peak_concurrent == n_sessions
    return sim(rep)


def bench_warm_pool(pkg, n_sessions=30):
    pool = 16
    out = {}
    for label, k in (("warm", pool), ("cold", 0)):
        gw = pkg.service(bench_registry(pkg, n_sessions + pool),
                         warm_pool=k, cold_start=COLD_START, policy="cost",
                         use_knowledge=False)
        pkg.gateway.poisson_attach_storm(
            gw, n_sessions=n_sessions, rate=pool / COLD_START / 2.0,
            think_mean=10.0, make_notebook=lambda i: bench_notebook(pkg, i),
            seed=13)
        rep = gw.run()
        assert rep.errors == 0
        out[label] = sim(rep)
    assert out["warm"]["pool_misses"] == 0
    speedup = out["cold"]["attach_wait_p99"] / max(
        out["warm"]["attach_wait_p99"], COLD_START / 100.0)
    assert speedup >= 5.0
    return out


@pytest.mark.parametrize("sweep", [bench_storm, bench_warm_pool],
                         ids=lambda f: f.__name__)
def test_bench_gateway_sweep_matches_the_reference(sweep):
    both(sweep)


# -- across packages: one package's client, the other's frontend -------------

class _Recode(queue.Queue):
    """A loopback queue that carries bytes: the sender's frame is encoded
    by its own wire module and the receiver's wire module decodes it."""

    def __init__(self, decode):
        super().__init__()
        self._decode = decode

    def _put(self, frame):
        super()._put(frame.encoded())

    def _get(self):
        (frame,) = self._decode(super()._get())
        return frame


def cross_storm(client_pkg, server_pkg, n_sessions=12, seed=5):
    """A Poisson storm of ATTACH frames that ``client_pkg`` builds and sends
    into ``server_pkg``'s gateway (the client half of
    ``poisson_attach_storm``)."""
    up = _Recode(server_pkg.wire.decode_frames)
    down = _Recode(client_pkg.wire.decode_frames)
    client = client_pkg.transport.LoopbackTransport(up, down)
    server = server_pkg.transport.LoopbackTransport(down, up)
    gw = _gateway(server_pkg, warm_pool=4, cold_start=2.0)
    gw.add_frontend(server)
    trace = client_pkg.scheduler.WorkloadTrace.poisson(
        n_sessions, rate=4.0, think_mean=3.0, cells_per_session=3, seed=seed)
    gw.expect_storm(n_sessions)
    for i, arrival in enumerate(trace.arrivals):
        nb = _nb(client_pkg, i)
        frame = client_pkg.wire.attach_frame(
            "t0" if i % 3 else "t1", nb.name,
            [{"source": c.source, "cost": c.cost} for c in nb.cells],
            think=trace.think[i], session=f"x{i:03d}")
        gw.loop.call_at(arrival, client.send, frame, priority=-2)
    rep = gw.run()
    assert rep.sessions == n_sessions and rep.completed == n_sessions
    frames = _frames(client_pkg, _drain(client))
    completes = [p for t, p in frames if t == client_pkg.wire.DETACH]
    assert sorted(completes) == [(f"x{i:03d}", "complete")
                                 for i in range(n_sessions)]
    return sim(rep), frames


@pytest.mark.parametrize("client,server", [("reference", "port"),
                                           ("port", "reference")])
def test_attach_frames_cross_the_packages(client, server):
    want = cross_storm(PACKAGES["reference"], PACKAGES["reference"])
    got = cross_storm(PACKAGES[client], PACKAGES[server])
    assert_same(got, want)


def test_serve_gateway_stress_equals_the_reference(capsys):
    """``repro_torch.launch.serve --gateway 0 --stress 200 --device cpu``:
    200 sessions as ATTACH frames through a wire frontend."""
    port = serve_cli(["--gateway", "0", "--stress", "200"], capsys)
    assert port["device"] == "cpu" and port["wire_sessions"] == 200
    assert port["completed"] == 200 and port["errors"] == 0
    assert_reports_agree(port, ref_serve.serve_gateway(0, stress=200))


# -- the port alone -----------------------------------------------------------

JAX_FREE = textwrap.dedent("""
    import json, sys, tempfile, os
    sys.modules["jax"] = None          # any import of jax now fails
    sys.modules["repro"] = None        # and so does any of the reference
    import repro_torch.core
    import repro_torch.core.gateway as gateway
    import repro_torch.distributed.fault
    from repro_torch.launch.notebook import run_notebook

    cells = [("import numpy as np\\nx = np.arange(20000, dtype=np.float64)",
              1.0), ("y = float(x.sum())", 30.0), ("z = y + 1", 0.5)]
    nb = {"cells": [{"cell_type": "code", "source": s, "outputs": [],
                     "execution_count": None,
                     "metadata": {"repro": {"cost": c}}} for s, c in cells],
          "metadata": {}, "nbformat": 4, "nbformat_minor": 5}
    path = os.path.join(tempfile.mkdtemp(), "nb.ipynb")
    with open(path, "w") as f:
        json.dump(nb, f)
    rep, _ = run_notebook(path, fleet=2, sessions=1, policy="cost",
                          use_knowledge=False,
                          fail_envs=[("remote", 3.0, 5.0)],
                          recovery="checkpoint", checkpoint_interval=1.0,
                          device="cpu")
    assert rep["recoveries"] >= 1 and rep["checkpoints"] > 0, rep

    reg = repro_torch.core.EnvironmentRegistry()
    reg.register(repro_torch.core.ExecutionEnvironment("local"), home=True,
                 capacity=64)
    reg.register(repro_torch.core.ExecutionEnvironment("gpu", speedup=8.0),
                 capacity=8)
    gw = gateway.GatewayService(reg, warm_pool=4, device="cpu",
                                policy="cost", use_knowledge=False)

    def make_nb(i):
        n = repro_torch.core.Notebook(f"nb{i}")
        n.add_cell("x = 2.0", cost=0.5)
        n.add_cell("y = x * 3.0", cost=30.0)
        return n

    gateway.poisson_attach_storm(gw, n_sessions=20, rate=10.0,
                                 think_mean=5.0, make_notebook=make_nb)
    g = gw.run()
    assert g.completed == 20 and g.errors == 0, g
    assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                   for m in sys.modules if sys.modules[m] is not None)
    print("ok", rep["recoveries"], rep["checkpoints"], g.completed)
""")


def test_the_fleet_and_gateway_run_without_jax_or_the_reference():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", JAX_FREE], env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok ")


def _no_cuda(*_a, **_k):
    raise AssertionError("a device='cpu' run asked for CUDA")


def test_a_cpu_gateway_and_fleet_never_touch_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", _no_cuda)
    port = PACKAGES["port"]
    rep = bench_storm(port, n_sessions=20)
    assert rep["completed"] == 20
    sched = port_scheduler.SessionScheduler(_registry(port), device="cpu")
    for i in range(2):
        nb = port_notebook.Notebook(f"f{i}")
        nb.add_cell("import numpy as np\nd = np.arange(5000.0)", cost=1.0)
        nb.add_cell("s = float(d.sum())", cost=30.0)
        sched.add_notebook(nb, policy="cost", use_knowledge=False)
    fleet = sched.run()
    assert [s.cells_run for s in fleet.sessions] == [2, 2]
    assert all(s.runtime.reducer.device.type == "cpu"
               for s in sched._sessions)
    assert sum(s.migrations for s in fleet.sessions) > 0


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_gateway.GatewayService(_registry(PACKAGES["port"]))
    with pytest.raises(RuntimeError, match="cuda"):
        port_scheduler.SessionScheduler(_registry(PACKAGES["port"]))
