"""Tensor-parallel compute over the ``model`` axis for the ssm and hybrid
families (``repro_torch/models/{ssm,griffin,transformer}.py`` under a tp
context, ``tensor_parallel.sum_model`` in mamba2's gated norm) through
``build_train_step`` and the serve steps in ``tp`` mode, on gloo ranks on
the CPU, against the reference's own sharded steps.

As ``tests/test_torch_tp.py``: the parent draws the inputs (the port's
``LM.init``, seed 0, f32; the token pipeline's batches and prompts),
writes them into an ``.npz`` and starts, all together, one
``tests/_jax_sharded_ref.py`` process a family (the reference's steps in
tp on the same meshes, ``Auto`` axes over 8 host devices) and one spawn of
``tests/_torch_tp_worker.py`` ranks a mesh: (1, 2), (2, 2) and (1, 4),
each with reduced mamba2-370m (8 SSD heads of 16 channels: 4, 2 or 1 a
``model`` rank, with their ``d_inner`` block; ``w_B``, ``w_C`` and
``conv_w`` whole) and reduced recurrentgemma-9b (RG-LRU width 64 in 8
gate blocks: 4, 2 or 1 blocks a rank's; the MQA attention's 4 heads
split, its one kv head whole; ``d_ff`` split).

Each runs two train steps, remat none (at (2, 2) both also with dots and
full, against the reference's none: remat changes no value), over 4
rows of 40 tokens for mamba2 (the scan pads 40 to its chunk, 32) and of
64 for recurrentgemma (S a multiple of its window, 32: the banded local
attention); and the serve steps with ``sp_decode`` off and on: mamba2 a
prompt of 40 (padded) and 4 steps; recurrentgemma a prompt of 64 (the
banded path) and 4 steps, and, ``sp_decode`` on, one of 48 (S > window
but not a multiple of it: full causal attention) and 18 steps, whose
ring writes wrap past slot 0.  The caches compared: mamba2's conv state whole (every rank's x
channels, then B and C), its ssm state split on the heads; the hybrid's
conv and lru states split on the width, its window rings whole.

Tolerances as ``tests/test_torch_tp.py``'s (PERF.md section 2), mamba2's
gradients and serving 1e-3 (its SSD sums run in another order): loss
1e-5; the gradients, read as m after step 1, within 1e-4 of each leaf's
max-abs; grad norm rtol 1e-5; masters and parameters after step 2
within 1e-6 of max-abs plus 0.1 x (lr_1 + lr_2); serve logits and caches
1e-4, ids equal.  Also each leaf's ``grad_sq`` against the reference's m,
no step gathering a byte, and each rank's bytes against
``launch/memmodel.py``'s tp count.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import _torch_serve_worker as serve_worker  # noqa: E402
import _torch_tp_worker as worker  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.distributed.context import DistContext as RefContext  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.distributed import DistContext  # noqa: E402
from repro_torch.launch.memmodel import model_memory  # noqa: E402
from repro_torch.models import LM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_tp_worker.py"
SHARDED_REF = Path(__file__).resolve().parent / "_jax_sharded_ref.py"
# case -> (arch, train tokens a row, serve prompts: {input set: (prompt,
# decode steps, the sp_decode settings)}, tolerance of the gradients and
# of serving).  The hybrid's decode takes its window ring before
# sp_decode, and its caches have no slots on cache_seq: the prompt of 48
# runs with sp_decode on only
SP = (False, True)
CASES = {"mamba2": ("mamba2-370m", 40, {"mamba2": (40, 4, SP)}, 1e-3),
         "rgemma": ("recurrentgemma-9b", 64,
                    {"rgemma": (64, 4, SP), "rgemma48": (48, 18, (True,))},
                    1e-4)}
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
REMAT_MESH, REMATS = "2x2", ("dots", "full")
BATCH = 4
# (mesh, case, remat)
TRAIN_RUNS = [(m, c, "none") for m in MESHES for c in CASES] \
    + [(REMAT_MESH, c, r) for c in CASES for r in REMATS]
# (mesh, case, input set, sp_decode)
SERVE_RUNS = [(m, c, p, sp) for m in MESHES for c, (_, _, ps, _) in
              CASES.items() for p, (_, _, sps) in ps.items() for sp in sps]
LOSS_TOL = 1e-5
NORM_RTOL = 1e-5
MASTER_TOL = 1e-6
FLIP_SHARE = 0.1                # of lr_1 + lr_2
SPAWN_TIMEOUT = 300
PIPE_SEED = 3


def _cfg(case: str, get=get_config):
    return worker.config(CASES[case][0], {}, get)


def _inputs() -> dict:
    """Each input set's weights, train batches and prompt."""
    out = {}
    for case, (_, seq, prompts, _) in CASES.items():
        cfg = _cfg(case)
        weights = {f"|params|{p}": t.numpy().copy() for p, t in
                   serve_worker._flat(LM(cfg, max_seq=seq, device="cpu")
                                      .init(0, torch.float32)).items()}
        pipe = TokenPipeline(cfg, ShapeConfig("t", "train", seq, BATCH),
                             seed=PIPE_SEED)
        batches = {f"|batch{s}|{k}": v for s in range(2)
                   for k, v in pipe.train_batch(s).items()}
        for name, (prompt, _, _) in prompts.items():
            out.update({name + k: v for k, v in weights.items()})
            out.update({name + k: v for k, v in batches.items()})
            p = TokenPipeline(cfg, ShapeConfig("p", "prefill", prompt, BATCH),
                              seed=PIPE_SEED).prefill_batch(0)
            out.update({f"{name}|batch|{k}": v for k, v in p.items()})
    return out


def _train_key(mesh, case, remat):
    return f"train/{mesh}/{case}/{remat}"


def _serve_key(mesh, inputs, sp):
    return f"serve/{mesh}/{inputs}/{'sp' if sp else 'nosp'}"


def _jobs() -> tuple[list, list]:
    """(the port's jobs, the reference's): the reference runs remat none
    only."""
    port, ref = [], []
    for mesh, case, remat in TRAIN_RUNS:
        arch, seq, _, _ = CASES[case]
        job = {"kind": "train", "key": _train_key(mesh, case, remat),
               "inputs": case, "arch": arch, "replace": {},
               "mesh": list(MESHES[mesh]), "remat": remat,
               "microbatches": 1, "seq": seq, "batch": BATCH}
        port.append(job)
        if remat == "none":
            ref.append({**job, "train": worker.TRAIN})
    for mesh, case, inputs, sp in SERVE_RUNS:
        prompt, steps, _ = CASES[case][2][inputs]
        job = {"kind": "serve", "key": _serve_key(mesh, inputs, sp),
               "inputs": inputs, "arch": CASES[case][0], "replace": {},
               "mesh": list(MESHES[mesh]), "sp_decode": sp,
               "prompt": prompt, "batch": BATCH, "steps": steps,
               "cache": prompt + steps}
        port.append(job)
        ref.append(job)
    return port, ref


def _start(mesh: str, tmp: Path):
    shape = MESHES[mesh]
    world = shape[0] * shape[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    procs = []
    for r in range(world):
        with open(tmp / mesh / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), "--rank", str(r), "--world",
                 str(world), "--store", str(tmp / mesh / "store"), "--mesh",
                 f"{shape[0]},{shape[1]}", "--jobs", str(tmp / "jobs.json"),
                 "--cases", str(tmp / "cases.npz"), "--out", str(tmp / mesh)],
                stdout=log, stderr=subprocess.STDOUT, env=env))
    return procs


def _wait(procs, deadline: float) -> None:
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the reference's outputs, mesh: {"result", "bytes"}}: the
    reference processes (one a family) and every spawn run together."""
    tmp = tmp_path_factory.mktemp("tp-recurrent")
    np.savez(tmp / "cases.npz", **_inputs())
    port, ref = _jobs()
    (tmp / "jobs.json").write_text(json.dumps(port))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    refs = {}
    for case, (arch, _, _, _) in CASES.items():
        (tmp / f"ref-jobs-{case}.json").write_text(json.dumps(
            [j for j in ref if j["arch"] == arch]))
        with open(tmp / f"ref-{case}.log", "w") as log:
            refs[case] = subprocess.Popen(
                [sys.executable, str(SHARDED_REF), "--jobs",
                 str(tmp / f"ref-jobs-{case}.json"), "--inputs",
                 str(tmp / "cases.npz"), "--out", str(tmp / f"ref-{case}.npz")],
                stdout=log, stderr=subprocess.STDOUT, env=env)
    started = {}
    for mesh in MESHES:
        (tmp / mesh).mkdir()
        started[mesh] = _start(mesh, tmp)
    deadline = time.monotonic() + SPAWN_TIMEOUT
    got = {}
    for mesh, procs in started.items():
        _wait(procs, deadline)
        text = "\n".join((tmp / mesh / f"rank{r}.log").read_text()
                         for r in range(len(procs)))
        assert all(p.returncode == 0 for p in procs), text[-6000:]
        got[mesh] = {"result": dict(np.load(tmp / mesh / "result.npz")),
                     "bytes": [json.loads((tmp / mesh / f"bytes-{r}.json")
                                          .read_text())
                               for r in range(len(procs))]}
    want = {}
    for case, p in refs.items():
        _wait([p], deadline)
        assert p.returncode == 0, \
            (tmp / f"ref-{case}.log").read_text()[-6000:]
        want.update(np.load(tmp / f"ref-{case}.npz"))
    return {"ref": want, **got}


def _leaves(out: dict, key: str, name: str) -> dict:
    return {k.split("|", 2)[2]: v for k, v in out.items()
            if k.startswith(f"{key}|{name}|")}


def _close(got: dict, want: dict, tol: float, what: str, extra=0.0):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-30) + extra,
            err_msg=f"{what} {k}")


@pytest.mark.parametrize("mesh,case,remat", TRAIN_RUNS)
def test_train_steps_match_the_sharded_reference(runs, mesh, case, remat):
    res, want = runs[mesh]["result"], runs["ref"]
    key = _train_key(mesh, case, remat)
    rkey = _train_key(mesh, case, "none")
    lrs = [float(want[f"{rkey}|lr{s}"]) for s in range(2)]
    for s in range(2):
        np.testing.assert_allclose(res[f"{key}|loss{s}"],
                                   want[f"{rkey}|loss{s}"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(res[f"{key}|grad_norm{s}"],
                                   want[f"{rkey}|grad_norm{s}"],
                                   rtol=NORM_RTOL)
        np.testing.assert_allclose(res[f"{key}|lr{s}"], lrs[s], rtol=1e-6)
    _close(_leaves(res, key, "m1"), _leaves(want, rkey, "m1"),
           CASES[case][3], f"{key} m after step 1")
    flip = FLIP_SHARE * sum(lrs)
    for name in ("master2", "params2"):
        _close(_leaves(res, key, name), _leaves(want, rkey, name),
               MASTER_TOL, f"{key} {name}", flip)


@pytest.mark.parametrize("mesh,case,remat", TRAIN_RUNS)
def test_grad_sq_is_each_leafs_share_of_the_grad_norm(runs, mesh, case,
                                                      remat):
    """``step_fn.grad_sq`` after step 1: each leaf's squared gradient norm
    over every rank, read against the reference's m after step 1
    ((1 - beta1) times the clipped gradient), adding up to the squared
    grad norm."""
    res, want = runs[mesh]["result"], runs["ref"]
    key = _train_key(mesh, case, remat)
    rkey = _train_key(mesh, case, "none")
    tc = TrainConfig(**worker.TRAIN)
    norm = float(want[f"{rkey}|grad_norm0"])
    scale = (1 - tc.beta1) * min(1.0, tc.grad_clip / norm)
    got = _leaves(res, key, "grad_sq1")
    m1 = _leaves(want, rkey, "m1")
    assert sorted(got) == sorted(m1)
    for p, m in m1.items():
        np.testing.assert_allclose(np.sqrt(got[p]) * scale,
                                   np.linalg.norm(m.astype(np.float64)),
                                   rtol=CASES[case][3], err_msg=f"{key} {p}")
    np.testing.assert_allclose(np.sqrt(sum(got.values())), norm,
                               rtol=NORM_RTOL)


@pytest.mark.parametrize("mesh,case,inputs,sp", SERVE_RUNS)
def test_serve_steps_match_the_sharded_reference(runs, mesh, case, inputs,
                                                 sp):
    res, want = runs[mesh]["result"], runs["ref"]
    key = _serve_key(mesh, inputs, sp)
    tol = CASES[case][3]
    np.testing.assert_array_equal(res[f"{key}|ids"], want[f"{key}|ids"])
    got = res[f"{key}|logits"]
    assert got.shape == want[f"{key}|logits"].shape
    np.testing.assert_allclose(got, want[f"{key}|logits"], atol=tol,
                               rtol=tol)
    for c in ("cache0", "cache1"):
        mine, theirs = _leaves(res, key, c), _leaves(want, key, c)
        assert sorted(mine) == sorted(theirs), (key, c)
        for p, w in theirs.items():
            if p == "['pos']":
                np.testing.assert_array_equal(mine[p], w)
            else:
                np.testing.assert_allclose(mine[p], w, atol=tol, rtol=tol,
                                           err_msg=f"{key} {c} {p}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_no_step_gathers_over_model(runs, mesh):
    """Every rank reads its blocks in place: no train, prefill or decode
    step gathers a parameter byte (the whole leaves, ``w_B``, ``w_C``,
    ``conv_w`` and the gates, are replicated), and no full gradient of a
    stacked leaf outlives its unit."""
    for r, rec in enumerate(runs[mesh]["bytes"]):
        for key, got in rec.items():
            stats = [got["gather_stats"]] if key.startswith("train") else got
            for st in stats:
                assert st["gathered_bytes_peak"] == 0, (mesh, r, key, st)
                assert st.get("stale_stacked_grads", 0) == 0, (mesh, r, key)


@pytest.mark.parametrize("mesh,case", [(m, c) for m in MESHES
                                       for c in CASES])
def test_each_rank_holds_its_blocks_as_the_memory_model_counts(runs, mesh,
                                                               case):
    """Before the steps and after each, every rank holds of each leaf of
    the parameters 1/k of it and of each leaf of m, v and master 1/k' of
    it, k and k' the ways the reference's ``params_shardings`` and
    ``opt_shardings`` split it in tp on this mesh; its parameters (bf16,
    2 bytes an element) and its m, v and master (f32: 12 bytes) add up to
    ``model_memory``'s ``params`` and ``opt`` terms for tp."""
    shape = MESHES[mesh]
    seq = CASES[case][1]
    sizes = {"data": shape[0], "model": shape[1]}
    rcfg = _cfg(case, ref_config)
    rlm = RefLM(rcfg, max_seq=seq)
    rctx = RefContext.create(rcfg, AbstractMesh(shape, ("data", "model")))

    def ways(tree) -> dict:
        return {jax.tree_util.keystr(p): int(np.prod(
            [sizes[a] for e in sh.spec if e
             for a in ((e,) if isinstance(e, str) else e)]))
            for p, sh in jax.tree_util.tree_flatten_with_path(tree)[0]}
    p_ways = ways(ref_shd.params_shardings(rctx, rlm.axes(), rlm.abstract()))
    o_ways = ways(ref_shd.opt_shardings(rctx, rlm.axes(), rlm.abstract()).m)
    cfg = _cfg(case)
    mm = model_memory(cfg, ShapeConfig("t", "train", seq, BATCH),
                      DistContext.create(cfg, sizes, mode="tp"),
                      TrainConfig(), LM(cfg, max_seq=seq, device="cpu"),
                      hbm_bytes=80e9)
    split = 0
    for rec in runs[mesh]["bytes"]:
        held_all = rec[_train_key(mesh, case, "none")]["held"]
        assert len(held_all) == 3
        for held in held_all:
            for name, want in (("params", p_ways), ("m", o_ways),
                               ("v", o_ways), ("master", o_ways)):
                assert sorted(held[name]) == sorted(want), name
                for p, (local, full) in held[name].items():
                    assert local * want[p] == full, (mesh, case, name, p)
                    split += want[p] > 1
            assert 2 * sum(lf[0] for lf in held["params"].values()) == \
                mm["params"]
            assert 4 * sum(lf[0] for n in ("m", "v", "master")
                           for lf in held[n].values()) == mm["opt"]
    assert split
