"""The port's fault-tolerance runtime against the JAX reference's, on the CPU.

Each case of ``tests/test_fault.py`` (heartbeat failure and restart from
the last checkpoint, elastic rescale without spares, a spare keeping the
world size, straggler eviction, a clean run) runs through both packages'
``Coordinator`` and ``ElasticTrainer``.  The fault events, the steps run
with their worlds, the rescales and the saved step must be equal, and hold
what the reference's own tests expect.
"""
import types

import pytest

import repro.core.simclock as ref_simclock
import repro.distributed.fault as ref_fault
import repro_torch.core.simclock as port_simclock
import repro_torch.distributed as port_distributed
import repro_torch.distributed.fault as port_fault

PACKAGES = {
    "reference": types.SimpleNamespace(SimClock=ref_simclock.SimClock,
                                       fault=ref_fault),
    "port": types.SimpleNamespace(SimClock=port_simclock.SimClock,
                                  fault=port_fault),
}


def _trainer(pkg, fail_at=None, straggle=None, spares=0, workers=4):
    clock = pkg.SimClock()
    coord = pkg.fault.Coordinator([f"w{i}" for i in range(workers)], clock,
                                  beat_interval=1.0, miss_threshold=3,
                                  straggler_patience=2)
    saved = {"step": 0}
    log = {"steps_run": []}
    detected = set()

    def step_fn(step, world):
        log["steps_run"].append((step, tuple(world)))
        out = {}
        for w in world:
            if (fail_at is not None and w == fail_at["worker"]
                    and step >= fail_at["step"] and w not in detected):
                if not coord.workers[w].alive:
                    detected.add(w)
                continue
            t = 1.0
            if straggle and w == straggle["worker"] \
                    and step >= straggle["from"]:
                t = straggle["factor"]
            out[w] = t
        return out

    def save_fn(step):
        saved["step"] = step

    def restore_fn():
        for w in list(coord.workers):
            if not coord.workers[w].alive:
                detected.add(w)
        return saved["step"]

    rescales = {"worlds": []}

    def rescale_fn(world):
        rescales["worlds"].append(tuple(world))

    et = pkg.fault.ElasticTrainer(coord, step_fn=step_fn, save_fn=save_fn,
                                  restore_fn=restore_fn,
                                  rescale_fn=rescale_fn, checkpoint_every=5,
                                  spares=spares)
    return et, saved, log, rescales


def _run(pkg, n_steps, **kw):
    et, saved, log, rescales = _trainer(pkg, **kw)
    res = et.run(n_steps)
    events = [(e.time, e.kind, e.worker, e.detail) for e in res["events"]]
    return {"steps": res["steps"], "restarts": res["restarts"],
            "rescales": res["rescales"], "wall": res["wall"],
            "events": events, "steps_run": log["steps_run"],
            "worlds": rescales["worlds"], "saved": saved["step"]}


def failure_restarts_from_checkpoint(out):
    assert out["restarts"] == 1
    assert "failure" in [k for _, k, _, _ in out["events"]]
    resumed = [s for s, _ in out["steps_run"]]
    assert resumed.count(5) >= 2 and out["steps"] == 12


def failure_without_spares_rescales(out):
    assert out["rescales"] == 1
    assert out["worlds"] and len(out["worlds"][0]) == 3
    assert all("w2" not in world for _, world in out["steps_run"][-2:])


def failure_with_spare_keeps_world_size(out):
    assert out["rescales"] == 0
    assert "restart" in [k for _, k, _, _ in out["events"]]
    assert len(out["steps_run"][-1][1]) == 4


def straggler_evicted(out):
    assert "straggler" in [k for _, k, _, _ in out["events"]]
    assert all("w3" not in world for _, world in out["steps_run"][-2:])


def no_faults_clean_run(out):
    assert out["restarts"] == 0 and out["rescales"] == 0
    assert out["saved"] == 5
    assert len(out["steps_run"]) == 8


CASES = {
    "failure_restarts_from_checkpoint": (
        12, {"fail_at": {"step": 7, "worker": "w2"}, "spares": 1},
        failure_restarts_from_checkpoint),
    "failure_without_spares_rescales": (
        12, {"fail_at": {"step": 7, "worker": "w2"}, "spares": 0},
        failure_without_spares_rescales),
    "failure_with_spare_keeps_world_size": (
        12, {"fail_at": {"step": 7, "worker": "w2"}, "spares": 1},
        failure_with_spare_keeps_world_size),
    "straggler_evicted": (
        10, {"straggle": {"worker": "w3", "from": 4, "factor": 30.0},
             "spares": 0, "workers": 5}, straggler_evicted),
    "no_faults_clean_run": (8, {}, no_faults_clean_run),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fault_case_matches_the_reference(case):
    n_steps, kw, check = CASES[case]
    outs = {name: _run(pkg, n_steps, **kw) for name, pkg in PACKAGES.items()}
    for out in outs.values():
        check(out)
    assert outs["port"] == outs["reference"]


def test_the_package_exports_only_what_is_ported():
    from repro_torch.distributed import context as port_context
    assert port_distributed.Coordinator is port_fault.Coordinator
    assert port_distributed.ElasticTrainer is port_fault.ElasticTrainer
    # the data-parallel half of the distributed layer, the prefill and
    # decode steps, SP decode attention and the local-routing
    # moe_ffn_shardmap are ported; the reference's shard_map version shim
    # has no counterpart
    from repro_torch.distributed import decode_attn, steps
    from repro_torch.models import moe as port_moe
    assert port_distributed.DistContext is port_context.DistContext
    for name in ("build_prefill_step", "build_decode_step", "cache_specs"):
        assert getattr(port_distributed, name) is getattr(steps, name), name
    assert port_distributed.sp_decode_attention is \
        decode_attn.sp_decode_attention
    assert not hasattr(port_distributed, "shard_map")
    assert callable(port_moe.moe_ffn_shardmap)
