"""Tensor-parallel compute over the ``model`` axis for the encdec family
(``repro_torch/models/encdec.py`` under a tp context: whisper's encoder
self attention, decoder self attention, cross attention, mlp and vocab at
this rank's blocks) through ``build_train_step`` and the serve steps in
``tp`` mode, on gloo ranks on the CPU, against the reference's own
sharded steps.

As ``tests/test_torch_tp.py``: the parent draws the inputs (the port's
``LM.init``, seed 0, f32; the token pipeline's batches and prompts with
their encoder frames), writes them into an ``.npz`` and starts, all
together, one ``tests/_jax_sharded_ref.py`` process (the reference's
steps in tp on the same meshes, ``Auto`` axes over 4 host devices) and
one spawn of ``tests/_torch_tp_worker.py`` ranks a mesh:

- (1, 2) and (2, 2): reduced whisper-tiny (4 heads, 4 kv heads: both
  split);
- (1, 4): reduced whisper-tiny (both split, one head a rank); with 6
  heads, 6 kv heads and ``d_model`` 96, whose heads ``make_rules`` leaves
  whole (every rank runs every attention whole, only the mlp and the
  vocab split: full whisper-tiny's pattern at 4 ranks, where summing the
  encoder output's gradient over ``model`` would count it 4 times); with
  2 kv heads (the q heads split, the kv heads whole: each rank reads the
  kv head its q head maps to, of the self and the cross K/V).

Each runs two train steps (remat none) and a prefill with 4 decode
steps, ``sp_decode`` on, and at (1, 2) also off.  Tolerances as
``tests/test_torch_tp.py``'s (PERF.md section 2): loss 1e-5; the
gradients, read as m after step 1, within 1e-4 of each leaf's max-abs;
grad norm rtol 1e-5; masters and parameters after step 2 within 1e-6 of
max-abs plus 0.1 x (lr_1 + lr_2); serve logits and caches 1e-4, ids
equal.  Also each leaf's ``grad_sq`` against the reference's m; no step
gathers a byte; each rank's bytes against ``launch/memmodel.py``'s tp
count; and the cache's specs and placements against the reference's.
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
from repro.distributed.steps import cache_specs as ref_cache_specs  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.distributed import DistContext, cache_specs  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.memmodel import model_memory  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.layers import spec_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_tp_worker.py"
SHARDED_REF = Path(__file__).resolve().parent / "_jax_sharded_ref.py"
ARCH = "whisper-tiny"
# case -> config fields replaced in reduced whisper-tiny
CONFIGS = {"whisper": {},
           "heads6": {"num_heads": 6, "num_kv_heads": 6, "d_model": 96},
           "kv2": {"num_kv_heads": 2}}
# mesh -> (shape, its cases)
MESHES = {"1x2": ((1, 2), ("whisper",)),
          "2x2": ((2, 2), ("whisper",)),
          "1x4": ((1, 4), ("whisper", "heads6", "kv2"))}
# (mesh, case) -> whether make_rules splits (heads, kv heads) over model
SPLITS = {("1x2", "whisper"): (True, True), ("2x2", "whisper"): (True, True),
          ("1x4", "whisper"): (True, True), ("1x4", "heads6"): (False, False),
          ("1x4", "kv2"): (True, False)}
TRAIN_RUNS = list(SPLITS)
SERVE_RUNS = [(m, c, sp) for m, c in SPLITS
              for sp in ((False, True) if m == "1x2" else (True,))]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
NORM_RTOL = 1e-5
MASTER_TOL = 1e-6
FLIP_SHARE = 0.1                # of lr_1 + lr_2
SERVE_TOL = 1e-4
SPAWN_TIMEOUT = 600            # the reference runs every job in one process
PIPE_SEED = 3


def _cfg(case: str, get=get_config):
    return worker.config(ARCH, CONFIGS[case], get)


def _inputs() -> dict:
    """The weights, train batches and prompt (with their frames) of every
    case."""
    out = {}
    for case in CONFIGS:
        cfg = _cfg(case)
        weights = serve_worker._flat(LM(cfg, max_seq=worker.SEQ,
                                        device="cpu").init(0, torch.float32))
        out.update({f"{case}|params|{p}": t.numpy().copy()
                    for p, t in weights.items()})
        pipe = TokenPipeline(cfg, ShapeConfig("t", "train", worker.SEQ,
                                              worker.BATCH), seed=PIPE_SEED)
        for s in range(2):
            batch = pipe.train_batch(s)
            assert "encoder_frames" in batch
            out.update({f"{case}|batch{s}|{k}": v for k, v in batch.items()})
        prompt = TokenPipeline(cfg, ShapeConfig(
            "p", "prefill", worker.PROMPT, worker.BATCH),
            seed=PIPE_SEED).prefill_batch(0)
        assert "encoder_frames" in prompt
        out.update({f"{case}|batch|{k}": v for k, v in prompt.items()})
    return out


def _train_key(mesh, case):
    return f"train/{mesh}/{case}"


def _serve_key(mesh, case, sp):
    return f"serve/{mesh}/{case}/{'sp' if sp else 'nosp'}"


def _jobs() -> list:
    """The jobs, the same for the port and the reference (which reads
    ``seq``, ``batch``, ``train``, ``cache`` and ``steps``)."""
    jobs = []
    for mesh, case in TRAIN_RUNS:
        jobs.append({"kind": "train", "key": _train_key(mesh, case),
                     "inputs": case, "arch": ARCH, "replace": CONFIGS[case],
                     "mesh": list(MESHES[mesh][0]), "remat": "none",
                     "microbatches": 1, "seq": worker.SEQ,
                     "batch": worker.BATCH, "train": worker.TRAIN})
    for mesh, case, sp in SERVE_RUNS:
        jobs.append({"kind": "serve", "key": _serve_key(mesh, case, sp),
                     "inputs": case, "arch": ARCH, "replace": CONFIGS[case],
                     "mesh": list(MESHES[mesh][0]), "sp_decode": sp,
                     "cache": worker.cache_len(_cfg(case)),
                     "steps": worker.STEPS})
    return jobs


def _start(mesh: str, tmp: Path):
    shape = MESHES[mesh][0]
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
    reference process and every spawn run together."""
    tmp = tmp_path_factory.mktemp("tp-encdec")
    np.savez(tmp / "cases.npz", **_inputs())
    (tmp / "jobs.json").write_text(json.dumps(_jobs()))
    # one reference process on 4 host devices (the largest mesh), its ops
    # single-threaded and its code generated without LLVM's optimizations
    # (the same HLO, so the same arithmetic), as tests/test_torch_tp_moe.py
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "--xla_backend_optimization_level=0")
    with open(tmp / "ref.log", "w") as log:
        refp = subprocess.Popen(
            [sys.executable, str(SHARDED_REF), "--jobs",
             str(tmp / "jobs.json"), "--inputs", str(tmp / "cases.npz"),
             "--out", str(tmp / "ref.npz")],
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
    _wait([refp], deadline)
    assert refp.returncode == 0, (tmp / "ref.log").read_text()[-6000:]
    return {"ref": dict(np.load(tmp / "ref.npz")), **got}


def _leaves(out: dict, key: str, name: str) -> dict:
    return {k.split("|", 2)[2]: v for k, v in out.items()
            if k.startswith(f"{key}|{name}|")}


def _close(got: dict, want: dict, tol: float, what: str, extra=0.0):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-30) + extra,
            err_msg=f"{what} {k}")


@pytest.mark.parametrize("mesh,case", TRAIN_RUNS)
def test_the_cases_split_the_heads_as_planned(mesh, case):
    """Each case's heads and kv heads split over ``model`` where the
    module docstring says, by the port's rules and the reference's."""
    shape = MESHES[mesh][0]
    heads, kv = SPLITS[(mesh, case)]
    ctx = DistContext.create(_cfg(case), dict(zip(("data", "model"), shape)),
                             mode="tp")
    rctx = RefContext.create(_cfg(case, ref_config),
                             AbstractMesh(shape, ("data", "model")))
    for rules in (ctx.rules, rctx.rules):
        assert (rules["heads"] == "model", rules["kv_heads"] == "model") == \
            (heads, kv)
        assert rules["mlp"] == rules["vocab"] == "model"
        assert rules["enc_seq"] is None and rules["pos"] is None


@pytest.mark.parametrize("mesh,case", TRAIN_RUNS)
def test_train_steps_match_the_sharded_reference(runs, mesh, case):
    res, want = runs[mesh]["result"], runs["ref"]
    key = _train_key(mesh, case)
    lrs = [float(want[f"{key}|lr{s}"]) for s in range(2)]
    for s in range(2):
        np.testing.assert_allclose(res[f"{key}|loss{s}"],
                                   want[f"{key}|loss{s}"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(res[f"{key}|grad_norm{s}"],
                                   want[f"{key}|grad_norm{s}"],
                                   rtol=NORM_RTOL)
        np.testing.assert_allclose(res[f"{key}|lr{s}"], lrs[s], rtol=1e-6)
    _close(_leaves(res, key, "m1"), _leaves(want, key, "m1"), GRAD_TOL,
           f"{key} m after step 1")
    flip = FLIP_SHARE * sum(lrs)
    for name in ("master2", "params2"):
        _close(_leaves(res, key, name), _leaves(want, key, name),
               MASTER_TOL, f"{key} {name}", flip)


@pytest.mark.parametrize("mesh,case", TRAIN_RUNS)
def test_grad_sq_is_each_leafs_share_of_the_grad_norm(runs, mesh, case):
    """``step_fn.grad_sq`` after step 1: each leaf's squared gradient norm
    over every rank, read against the reference's m after step 1
    ((1 - beta1) times the clipped gradient), adding up to the squared
    grad norm."""
    res, want = runs[mesh]["result"], runs["ref"]
    key = _train_key(mesh, case)
    tc = TrainConfig(**worker.TRAIN)
    norm = float(want[f"{key}|grad_norm0"])
    scale = (1 - tc.beta1) * min(1.0, tc.grad_clip / norm)
    got = _leaves(res, key, "grad_sq1")
    m1 = _leaves(want, key, "m1")
    assert sorted(got) == sorted(m1)
    for p, m in m1.items():
        np.testing.assert_allclose(np.sqrt(got[p]) * scale,
                                   np.linalg.norm(m.astype(np.float64)),
                                   rtol=GRAD_TOL, err_msg=f"{key} {p}")
    np.testing.assert_allclose(np.sqrt(sum(got.values())), norm,
                               rtol=NORM_RTOL)


@pytest.mark.parametrize("mesh,case", TRAIN_RUNS)
def test_encoder_gradients_match_layer_by_layer(runs, mesh, case):
    """The encoder's leaves' gradients (m after step 1), layer by layer,
    within 1e-4 of that layer's max-abs: they reach the encoder only
    through the cross K/V, summed over ``model`` once where each rank
    reads the encoder's output for its own heads, and not at all where
    every rank runs the whole cross attention (there a sum would count
    the encoder's gradients once a rank)."""
    res, want = runs[mesh]["result"], runs["ref"]
    key = _train_key(mesh, case)
    enc = [p for p in _leaves(want, key, "m1") if p.startswith("['encoder']")]
    assert len(enc) == 9                # ln1, attn (4), ln2, mlp (3)
    for p in enc:
        got, ref = res[f"{key}|m1|{p}"], want[f"{key}|m1|{p}"]
        assert got.shape == ref.shape
        for layer, (g, w) in enumerate(zip(got, ref)):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=GRAD_TOL * np.abs(w).max(),
                                       err_msg=f"{key} {p} layer {layer}")


@pytest.mark.parametrize("mesh,case,sp", SERVE_RUNS)
def test_serve_steps_match_the_sharded_reference(runs, mesh, case, sp):
    res, want = runs[mesh]["result"], runs["ref"]
    key = _serve_key(mesh, case, sp)
    np.testing.assert_array_equal(res[f"{key}|ids"], want[f"{key}|ids"])
    got = res[f"{key}|logits"]
    assert got.shape == want[f"{key}|logits"].shape
    np.testing.assert_allclose(got, want[f"{key}|logits"], atol=SERVE_TOL,
                               rtol=SERVE_TOL)
    for c in ("cache0", "cache1"):
        mine, theirs = _leaves(res, key, c), _leaves(want, key, c)
        assert sorted(mine) == sorted(theirs), (key, c)
        for p, w in theirs.items():
            if p == "['pos']":
                np.testing.assert_array_equal(mine[p], w)
            else:
                np.testing.assert_allclose(mine[p], w, atol=SERVE_TOL,
                                           rtol=SERVE_TOL,
                                           err_msg=f"{key} {c} {p}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_no_step_gathers_over_model(runs, mesh):
    """Every rank reads its blocks in place: no train, prefill or decode
    step gathers a byte (tp splits whisper's leaves over ``model`` only),
    and no full gradient of a stacked leaf outlives its unit."""
    for r, rec in enumerate(runs[mesh]["bytes"]):
        for key, got in rec.items():
            if key.startswith("train"):
                assert got["split_axes"] == {}, (mesh, r, key)
            stats = [got["gather_stats"]] if key.startswith("train") else got
            for st in stats:
                assert st["gathered_bytes_peak"] == 0, (mesh, r, key, st)
                assert st.get("stale_stacked_grads", 0) == 0, (mesh, r, key)


@pytest.mark.parametrize("mesh,case", TRAIN_RUNS)
def test_each_rank_holds_its_blocks_as_the_memory_model_counts(runs, mesh,
                                                               case):
    """Before the steps and after each, every rank holds of each leaf of
    the parameters 1/k of it and of each leaf of m, v and master 1/k' of
    it, k and k' the ways the reference's ``params_shardings`` and
    ``opt_shardings`` split it in tp on this mesh; its parameters (bf16,
    2 bytes an element) and its m, v and master (f32: 12 bytes) add up to
    ``model_memory``'s ``params`` and ``opt`` terms for tp."""
    shape = MESHES[mesh][0]
    sizes = {"data": shape[0], "model": shape[1]}
    rcfg = _cfg(case, ref_config)
    rlm = RefLM(rcfg, max_seq=worker.SEQ)
    rctx = RefContext.create(rcfg, AbstractMesh(shape, ("data", "model")))

    def ways(tree) -> dict:
        return {jax.tree_util.keystr(p): int(np.prod(
            [sizes[a] for e in sh.spec if e
             for a in ((e,) if isinstance(e, str) else e)]))
            for p, sh in jax.tree_util.tree_flatten_with_path(tree)[0]}
    p_ways = ways(ref_shd.params_shardings(rctx, rlm.axes(), rlm.abstract()))
    o_ways = ways(ref_shd.opt_shardings(rctx, rlm.axes(), rlm.abstract()).m)
    cfg = _cfg(case)
    mm = model_memory(cfg, ShapeConfig("t", "train", worker.SEQ,
                                       worker.BATCH),
                      DistContext.create(cfg, sizes, mode="tp"),
                      TrainConfig(), LM(cfg, max_seq=worker.SEQ,
                                        device="cpu"), hbm_bytes=80e9)
    split = 0
    for rec in runs[mesh]["bytes"]:
        held_all = rec[_train_key(mesh, case)]["held"]
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


@pytest.mark.parametrize("mesh,case", TRAIN_RUNS)
def test_cache_specs_and_placements_match_the_reference(mesh, case):
    """The serve cache keeps the reference's layout under tp: every leaf's
    shape and dtype (``cache_specs``: every kv head of the self and cross
    K/V, whatever the heads' split) and its placement on the mesh, with
    and without ``sp_decode`` (which splits the self slots only)."""
    shape = MESHES[mesh][0]
    cfg, rcfg = _cfg(case), _cfg(case, ref_config)
    total = worker.cache_len(cfg)
    lm = LM(cfg, max_seq=total, device="cpu")
    rlm = RefLM(rcfg, max_seq=total)
    acache = ref_cache_specs(rlm, worker.BATCH, total)
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(acache)[0]}
    got = {p: (tuple(s.shape), str(s.dtype).replace("torch.", ""))
           for p, s in serve_worker._flat(cache_specs(
               lm, worker.BATCH, total)).items()}
    assert got == want
    for sp in (False, True):
        ctx = DistContext.create(cfg, dict(zip(("data", "model"), shape)),
                                 mode="tp", sp_decode=sp)
        rctx = RefContext.create(rcfg, AbstractMesh(shape, ("data", "model")),
                                 sp_decode=sp)
        mine = dict(spec_leaves(shd.cache_shardings(ctx, lm.cache_axes(ctx),
                                                    worker.BATCH)))
        theirs = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
                  jax.tree_util.tree_flatten_with_path(ref_shd.cache_shardings(
                      rctx, rlm.cache_axes(rctx), acache, worker.BATCH))[0]}
        assert mine == theirs, (sp, mine, theirs)
        self_k = mine["['stack']['self_k']"]
        assert (self_k[3] == "model") == sp
        assert all(e in (None, "data") for e in
                   mine["['stack']['cross_k']"]), mine
