"""The port's replica plane against the JAX reference's, on the CPU.

The ``attach_replicas`` cases of ``tests/test_replica.py`` (those without
a fleet scheduler: follower convergence, tombstones, budget pacing, the
trickle-bank dedupe, promotion, racing, and RACE/REPLICA/PROMOTE over a
live transport) run as one schedule through both packages.  Watermarks,
shipped bytes, promotion replays, race results and the replica plane's
telemetry must be equal, and hold what the reference's own tests expect.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro.core.replica as ref_replica  # noqa: E402
import repro.core.telemetry as ref_T  # noqa: E402
import repro.core.transport as ref_transport  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.core.replica as port_replica  # noqa: E402
import repro_torch.core.telemetry as port_T  # noqa: E402
import repro_torch.core.transport as port_transport  # noqa: E402


def _pkg(core, T, replica, transport, reducer_kw):
    return types.SimpleNamespace(
        core=core, T=T, replica=replica, transport=transport,
        reducer=lambda **kw: core.StateReducer(**reducer_kw, **kw))


PACKAGES = {
    "reference": _pkg(ref_core, ref_T, ref_replica, ref_transport, {}),
    "port": _pkg(port_core, port_T, port_replica, port_transport,
                 {"device": "cpu"}),
}


def _runtime(pkg, *, race=False, replicator=False):
    c = pkg.core
    nb = c.Notebook("replica-demo")
    nb.add_cell("import numpy as np\n"
                "a = np.arange(4000, dtype=np.float64)\n"
                "b = np.arange(100, dtype=np.float64)", cost=0.1)
    nb.add_cell("c = float(a.sum() + b.sum())", cost=30.0)
    nb.add_cell("d = c + 1", cost=0.1)
    envs = {"local": c.ExecutionEnvironment("local"),
            "standby": c.ExecutionEnvironment("standby", speedup=10.0)}
    rt = c.HybridRuntime(nb, envs=envs, policy="cost", use_knowledge=False,
                         latency=0.01, bandwidth=1e6,
                         reducer=pkg.reducer(codec="zlib"))
    rep = rt.attach_replicator(rate=1e9, top_k=2) if replicator else None
    rs = rt.attach_replicas(["standby"], race=race, rate=1e9)
    assert type(rs).__module__ == pkg.replica.__name__
    return rt, rs, rep


REPLICA_TYPES = ("STATE_REPLICATED", "SESSION_PROMOTED", "CELL_RACED",
                 "CELL_RACE_CANCELLED")


def _messages(pkg, rt):
    """The replica plane's telemetry: (type, payload) in order.  A race id
    is the session's random id plus ``-race-<n>``; only ``<n>`` compares."""
    kinds = {getattr(pkg.T, k) for k in REPLICA_TYPES}
    out = []
    for m in rt.bus.messages():
        if m.type in kinds:
            payload = dict(m.payload)
            if "race_id" in payload:
                payload["race_id"] = payload["race_id"].rpartition("-race-")[2]
            out.append((m.type, payload))
    return out


def _counters(rs):
    return {"commit_seq": rs.commit_seq, "watermark": dict(rs.watermark),
            "lag": rs.lag(), "replicated_bytes": rs.replicated_bytes,
            "shared_bytes": rs.shared_bytes, "promotions": rs.promotions,
            "races": rs.races, "race_wins": dict(rs.race_wins),
            "race_waste_seconds": rs.race_waste_seconds}


# -- the scenarios: each returns what both packages must agree on ---------

def converge(pkg):
    rt, rs, _ = _runtime(pkg)
    rt.run_cell(0)
    before = (rs.commit_seq, rs.lag("standby"))
    shipped = rs.sync(rt.clock.now() + 1.0, budget_bytes=1 << 30)
    a = rt.envs["standby"].state["a"]
    np.testing.assert_array_equal(a, rt.envs["local"].state["a"])
    out = (before, shipped, _counters(rs), _messages(pkg, rt))
    rt.close()
    return out


def tombstones(pkg):
    rt, rs, _ = _runtime(pkg)
    rt.run_cell(0)
    rs.sync(rt.clock.now() + 1.0, budget_bytes=1 << 30)
    held = sorted(k for k in ("a", "b") if k in rt.envs["standby"].state.ns)
    rt.envs["local"].execute("del b")
    rt.envs["local"].state.mark_dirty([])
    rs.sync(rt.clock.now() + 2.0, budget_bytes=1 << 30)
    after = sorted(k for k in ("a", "b") if k in rt.envs["standby"].state.ns)
    out = (held, after, _counters(rs), _messages(pkg, rt))
    rt.close()
    return out


def budget(pkg):
    rt, rs, _ = _runtime(pkg)
    rt.run_cell(0)
    shipped = rs.sync(rt.clock.now() + 1.0, budget_bytes=1)
    lag_mid = rs.lag("standby")
    rs.sync(rt.clock.now() + 2.0, budget_bytes=1 << 30)
    out = (shipped, lag_mid, rs.lag("standby"), _counters(rs))
    rt.close()
    return out


def claims_trickle_bank(pkg):
    rt, rs, rep = _runtime(pkg, replicator=True)
    rt.run_cell(0)
    rep.step(rt.clock.now() + 1.0, budget_bytes=1 << 30)
    banked = sorted(rep.banked.get("standby", {}))
    trickled = rep.trickled_bytes
    rs.sync(rt.clock.now() + 2.0, budget_bytes=1 << 30)
    banked_after = sorted(rep.banked.get("standby", {}))
    rep.step(rt.clock.now() + 3.0, budget_bytes=1 << 30)
    out = (banked, trickled, banked_after, rep.trickled_bytes,
           "a" in rt.envs["standby"].state.ns, _counters(rs))
    rt.close()
    return out


def trickle_after_sync(pkg):
    rt, rs, rep = _runtime(pkg, replicator=True)
    rt.run_cell(0)
    rs.sync(rt.clock.now() + 1.0, budget_bytes=1 << 30)
    shipped = rep.step(rt.clock.now() + 2.0, budget_bytes=1 << 30)
    out = (shipped, sorted(rep.banked.get("standby", {})), _counters(rs))
    rt.close()
    return out


def promote_converged(pkg):
    rt, rs, _ = _runtime(pkg)
    rt.run_cell(0)
    rs.sync(rt.clock.now() + 1.0, budget_bytes=1 << 30)
    res = rs.promote("local", rt.clock.now())
    out = (res, rt.current_env, _counters(rs), _messages(pkg, rt))
    rt.close()
    return out


def promote_with_residual(pkg):
    rt, rs, rep = _runtime(pkg, replicator=True)
    rt.run_cell(0)
    rep.step(rt.clock.now() + 1.0, budget_bytes=1 << 30)
    res = rs.promote("local", rt.clock.now())
    np.testing.assert_array_equal(rt.envs["standby"].state["a"],
                                  rt.envs["local"].state["a"])
    out = (res, _counters(rs), _messages(pkg, rt))
    rt.close()
    return out


def promote_none_and_forget(pkg):
    rt, rs, _ = _runtime(pkg)
    rt.run_cell(0)
    rs.sync(rt.clock.now() + 1.0, budget_bytes=1 << 30)
    wm = rs.watermark["standby"]
    rs.forget("standby")
    forgotten = rs.watermark["standby"]
    rt.envs["standby"].status = "failed"
    res = rs.promote("local", rt.clock.now())
    rt.close()
    return wm, forgotten, res


def _raced_runtime(pkg, race):
    c = pkg.core
    nb = c.Notebook("race-demo")
    nb.add_cell("import numpy as np\n"
                "a = np.arange(2000, dtype=np.float64)", cost=0.1)
    nb.add_cell("t = float(a.sum())", cost=30.0)
    nb.add_cell("u = t + 1", cost=0.1)
    envs = {"local": c.ExecutionEnvironment("local"),
            "fast-a": c.ExecutionEnvironment("fast-a", speedup=10.0),
            "fast-b": c.ExecutionEnvironment("fast-b", speedup=10.0)}
    rt = c.HybridRuntime(nb, envs=envs, policy="cost", use_knowledge=False,
                         latency=0.01, bandwidth=1e8,
                         reducer=pkg.reducer(codec="zlib"))
    rs = rt.attach_replicas(["fast-a", "fast-b"], race=race, rate=1e9)
    for _pass in range(2):
        for order in range(3):
            rt.run_cell(order)
            rs.sync(rt.clock.now() + 1.0, budget_bytes=1 << 30)
    return rt, rs


def race(pkg):
    out = []
    for raced in (False, True):
        rt, rs = _raced_runtime(pkg, raced)
        env = next(e for e in rt.envs.values() if "t" in e.state.ns)
        out.append((float(env.state["t"]),
                    float(rt.envs[rt.current_env].state["u"]),
                    rt.current_env, _counters(rs), _messages(pkg, rt)))
        rt.close()
    return out


def primary_failure_during_race(pkg):
    rt, rs = _raced_runtime(pkg, True)
    rs._active_race = pkg.replica.RaceTicket(
        race_id="test-race-inflight", order=1, winner="fast-a",
        loser="fast-b", winner_est=3.0, loser_est=3.0,
        started_at=rt.clock.now(), policy_env="fast-a")
    before = {n: rt.envs["fast-b"].state.ns[n]
              for n in ("a", "t") if n in rt.envs["fast-b"].state.ns}
    waste = rs.race_waste_seconds
    rt.recover_from_failure("fast-a")
    kept = all(rt.envs["fast-b"].state.ns[n] is v for n, v in before.items())
    res = rs.promote("fast-a", rt.clock.now())
    out = (sorted(before), rs._active_race is None,
           rs.race_waste_seconds == waste, kept, res, _counters(rs))
    rt.close()
    return out


def race_cancel_over_transport(pkg):
    env = pkg.core.ExecutionEnvironment("remote", speedup=10.0)
    peer = pkg.transport.attach_peer(env, pkg.reducer(codec="zlib"),
                                     kind="loopback")
    peer.race_cancel("r-dead")
    peer.race("r-dead", "boom = 1")
    recv = env._server.receiver
    dead = (recv.races_cancelled, recv.races_run, "boom" in env.state.ns)
    env.state.ns["x"] = 2
    nbytes = peer.race("r-live", "y = x * 2")
    out = (dead, nbytes, recv.races_run, "y" in env.state.ns)
    peer.close()
    env._server.join(10.0)
    return out


def replicate_and_promote_frames(pkg):
    env = pkg.core.ExecutionEnvironment("remote", speedup=10.0)
    red = pkg.reducer(codec="zlib")
    peer = pkg.transport.attach_peer(env, red, kind="loopback")
    src = pkg.core.ExecutionState({"a": np.arange(64, dtype=np.float32)})
    stats = peer.replicate("sess", 5, red.serialize_names(src, {"a"}))
    recv = env._server.receiver
    np.testing.assert_array_equal(env.state.ns["a"], src.ns["a"])
    out = (recv.replica_epoch, recv.replicas_applied, stats.frames,
           stats.wire_bytes, peer.promote("sess", 9), recv.promotions)
    peer.close()
    env._server.join(10.0)
    return out


SCENARIOS = {f.__name__: f for f in (
    converge, tombstones, budget, claims_trickle_bank, trickle_after_sync,
    promote_converged, promote_with_residual, promote_none_and_forget,
    race, primary_failure_during_race, race_cancel_over_transport,
    replicate_and_promote_frames)}


@pytest.fixture(scope="module")
def observed():
    """Every scenario, once per package."""
    return {name: {p: fn(pkg) for p, pkg in PACKAGES.items()}
            for name, fn in SCENARIOS.items()}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_replica_plane_matches_the_reference(observed, name):
    got, want = observed[name]["port"], observed[name]["reference"]
    assert got == want


def test_the_port_holds_what_the_reference_tests_expect(observed):
    def port(name):
        return observed[name]["port"]

    before, shipped, c, msgs = port("converge")
    assert before == (1, 1) and shipped > 0
    assert c["watermark"] == {"standby": 1} and c["lag"] == 0
    assert msgs and msgs[-1][1]["watermark"] == 1
    held, after, _, msgs = port("tombstones")
    assert held == ["a", "b"] and after == ["a"]
    assert "b" in msgs[-1][1]["deleted"]
    shipped, lag_mid, lag_end, _ = port("budget")
    assert shipped > 0 and lag_mid == 1 and lag_end == 0
    banked, trickled, banked_after, trickled_end, applied, c = \
        port("claims_trickle_bank")
    assert "a" in banked and "a" not in banked_after and applied
    assert c["shared_bytes"] > 0 and c["replicated_bytes"] == 0
    assert trickled_end == trickled
    shipped, banked, c = port("trickle_after_sync")
    assert shipped == 0 and "a" not in banked and c["replicated_bytes"] > 0
    res, current, c, msgs = port("promote_converged")
    assert res == ("standby", 0) and current == "standby"
    assert c["promotions"] == 1 and msgs[-1][1]["replay"] == 0
    res, _, msgs = port("promote_with_residual")
    assert res == ("standby", 1) and "a" in msgs[-1][1]["residual"]
    assert port("promote_none_and_forget") == (1, 0, None)
    (solo, raced) = port("race")
    want = float(np.arange(2000, dtype=np.float64).sum())
    for t, u, _, _, _ in (solo, raced):
        assert (t, u) == (want, want + 1)
    assert solo[3]["races"] == 0 and raced[3]["races"] >= 1
    assert sum(raced[3]["race_wins"].values()) == raced[3]["races"]
    before, aborted, no_waste, kept, res, _ = \
        port("primary_failure_during_race")
    assert before and aborted and no_waste and kept and res[0] == "fast-b"
    dead, nbytes, runs, leaked = port("race_cancel_over_transport")
    assert dead == (1, 0, False) and nbytes > 0 and runs == 1 and not leaked
    epoch, applied, _, _, promoted, promotions = \
        port("replicate_and_promote_frames")
    assert (epoch, applied, promoted, promotions) == (5, 1, 5, 1)
