"""Tensor-parallel compute over the ``model`` axis for the moe family
(``repro_torch/models/moe.py`` under a tp context,
``tensor_parallel.gather_model_grad`` for the EP router's logits)
through ``build_train_step`` and the serve steps in ``tp`` mode, on gloo
ranks on the CPU, against the reference's own sharded steps.

As ``tests/test_torch_tp.py``: the parent draws the inputs (the port's
``LM.init``, seed 0, f32; the token pipeline's batches and prompts),
writes them into an ``.npz`` and starts, all together, one
``tests/_jax_sharded_ref.py`` process (the reference's steps in tp on the
same meshes, ``Auto`` axes over 4 host devices) and one spawn of
``tests/_torch_tp_worker.py`` ranks a mesh:

- (1, 2): reduced qwen2-moe-a2.7b (8 experts, EP: 4 a rank, the router's
  columns of them; its shared expert split as an mlp) under the global
  routing (``moe_ffn``, the reference's GSPMD program) and under the
  local one (``moe_impl="shardmap"``);
- (2, 2): qwen2-moe with 5 experts (expert-TP: every expert's 48 of its
  96 ffn columns) at capacity factor 0.5, so that tokens drop; reduced
  qwen3-moe-235b-a22b (8 experts, EP, no shared expert; the experts' ffn
  dim also split over ``data``, gathered by the step's per-unit gather);
- (1, 4): qwen2-moe with 6 experts (expert-TP) under both routings;
  reduced qwen3-moe (EP, 2 experts a rank).

Each runs two train steps (remat none) and a prefill with 4 decode
steps, ``sp_decode`` on, and at (1, 2) under the global routing also
off.  Tolerances as ``tests/test_torch_tp.py``'s (PERF.md section 2):
loss 1e-5; the gradients, read as m after step 1, within 1e-4 of each
leaf's max-abs; grad norm rtol 1e-5; masters and parameters after step 2
within 1e-6 of max-abs plus 0.1 x (lr_1 + lr_2); serve logits and caches
1e-4, ids equal.  Also each leaf's ``grad_sq`` against the reference's m;
the router's gradient layer by layer (an aux loss counted once on each of
the m ranks and then summed over ``model`` would count it m times); no
leaf gathered over ``model`` (bytes gathered only where EP splits the
experts' ffn dim over ``data``); and each rank's bytes against
``launch/memmodel.py``'s tp count.
"""
import json
import math
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
from repro_torch.models.layers import spec_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_tp_worker.py"
SHARDED_REF = Path(__file__).resolve().parent / "_jax_sharded_ref.py"
# case -> (arch, config fields replaced)
CONFIGS = {"qwen2-moe": ("qwen2-moe-a2.7b", {}),
           "qwen2-moe-e5-cf0.5": ("qwen2-moe-a2.7b", {
               "num_experts": 5, "capacity_factor": 0.5}),
           "qwen2-moe-e6": ("qwen2-moe-a2.7b", {"num_experts": 6}),
           "qwen3-moe": ("qwen3-moe-235b-a22b", {})}
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
# (mesh, case, moe_impl), and the expert mode make_rules gives it
RUNS = {("1x2", "qwen2-moe", "gspmd"): "ep",
        ("1x2", "qwen2-moe", "shardmap"): "ep",
        ("2x2", "qwen2-moe-e5-cf0.5", "gspmd"): "tp",
        ("2x2", "qwen3-moe", "gspmd"): "ep",
        ("1x4", "qwen2-moe-e6", "gspmd"): "tp",
        ("1x4", "qwen2-moe-e6", "shardmap"): "tp",
        ("1x4", "qwen3-moe", "gspmd"): "ep"}
SP_BOTH = ("1x2", "qwen2-moe", "gspmd")
SERVE_RUNS = [run + (sp,) for run in RUNS
              for sp in ((False, True) if run == SP_BOTH else (True,))]
ROUTER = "['decoder']['stack']['ffn']['router']"
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
NORM_RTOL = 1e-5
MASTER_TOL = 1e-6
FLIP_SHARE = 0.1                # of lr_1 + lr_2
SERVE_TOL = 1e-4
SPAWN_TIMEOUT = 600            # the reference runs every job in one process
PIPE_SEED = 3


def _cfg(case: str, get=get_config):
    arch, replace = CONFIGS[case]
    return worker.config(arch, replace, get)


def _inputs() -> dict:
    """The weights, train batches and prompt of every case."""
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
            out.update({f"{case}|batch{s}|{k}": v
                        for k, v in pipe.train_batch(s).items()})
        prompt = TokenPipeline(cfg, ShapeConfig(
            "p", "prefill", worker.PROMPT, worker.BATCH),
            seed=PIPE_SEED).prefill_batch(0)
        out.update({f"{case}|batch|{k}": v for k, v in prompt.items()})
    return out


def _train_key(mesh, case, impl):
    return f"train/{mesh}/{case}/{impl}"


def _serve_key(mesh, case, impl, sp):
    return f"serve/{mesh}/{case}/{impl}/{'sp' if sp else 'nosp'}"


def _jobs() -> list:
    """The jobs, the same for the port and the reference (which reads
    ``seq``, ``batch``, ``train``, ``cache`` and ``steps``)."""
    jobs = []
    for mesh, case, impl in RUNS:
        arch, replace = CONFIGS[case]
        jobs.append({"kind": "train", "key": _train_key(mesh, case, impl),
                     "inputs": case, "arch": arch, "replace": replace,
                     "mesh": list(MESHES[mesh]), "moe_impl": impl,
                     "remat": "none", "microbatches": 1, "seq": worker.SEQ,
                     "batch": worker.BATCH, "train": worker.TRAIN})
    for mesh, case, impl, sp in SERVE_RUNS:
        arch, replace = CONFIGS[case]
        jobs.append({"kind": "serve", "key": _serve_key(mesh, case, impl, sp),
                     "inputs": case, "arch": arch, "replace": replace,
                     "mesh": list(MESHES[mesh]), "moe_impl": impl,
                     "sp_decode": sp, "cache": worker.cache_len(_cfg(case)),
                     "steps": worker.STEPS})
    return jobs


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
    reference process and every spawn run together."""
    tmp = tmp_path_factory.mktemp("tp-moe")
    np.savez(tmp / "cases.npz", **_inputs())
    jobs = _jobs()
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    # one reference process on 4 host devices (the largest mesh), its ops
    # single-threaded and its code generated without LLVM's optimizations
    # (the same HLO, so the same arithmetic; a third of the CPU time): the
    # other gloo test files run their own references beside it, and each
    # of those waits on all of its devices
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


def test_the_runs_cover_both_expert_modes():
    """Each run's expert mode is what ``make_rules`` gives its config on
    its mesh, and EP and expert-TP both run under both routings."""
    for (mesh, case, impl), mode in RUNS.items():
        cfg = _cfg(case)
        ctx = DistContext.create(cfg, dict(zip(("data", "model"),
                                               MESHES[mesh])), mode="tp")
        assert ctx.rules["expert_mode"] == mode, (mesh, case)
    assert {(m, i) for (_, _, i), m in RUNS.items()} == {
        (m, i) for m in ("ep", "tp") for i in ("gspmd", "shardmap")}


@pytest.mark.parametrize("mesh,case,impl", list(RUNS))
def test_train_steps_match_the_sharded_reference(runs, mesh, case, impl):
    res, want = runs[mesh]["result"], runs["ref"]
    key = _train_key(mesh, case, impl)
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


@pytest.mark.parametrize("mesh,case,impl", list(RUNS))
def test_grad_sq_is_each_leafs_share_of_the_grad_norm(runs, mesh, case,
                                                      impl):
    """``step_fn.grad_sq`` after step 1: each leaf's squared gradient norm
    over every rank, read against the reference's m after step 1
    ((1 - beta1) times the clipped gradient), adding up to the squared
    grad norm."""
    res, want = runs[mesh]["result"], runs["ref"]
    key = _train_key(mesh, case, impl)
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


@pytest.mark.parametrize("mesh,case,impl", [r for r in RUNS
                                            if r[0] in ("1x2", "1x4")])
def test_router_gradient_matches_the_reference(runs, mesh, case, impl):
    """The router's gradient (m after step 1), layer by layer, within
    1e-4 of that layer's max-abs: the combine's part summed over the
    ``model`` ranks (each combines its own experts' or ffn blocks' slots)
    and the aux loss's part, which every rank holds whole, counted
    once."""
    res, want = runs[mesh]["result"], runs["ref"]
    key = _train_key(mesh, case, impl)
    got, ref = res[f"{key}|m1|{ROUTER}"], want[f"{key}|m1|{ROUTER}"]
    assert got.shape == ref.shape == (_cfg(case).num_layers,) + \
        ref.shape[1:]
    for layer, (g, w) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=f"{key} layer {layer}")


@pytest.mark.parametrize("mesh,case,impl,sp", SERVE_RUNS)
def test_serve_steps_match_the_sharded_reference(runs, mesh, case, impl,
                                                 sp):
    res, want = runs[mesh]["result"], runs["ref"]
    key = _serve_key(mesh, case, impl, sp)
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
    """Every rank reads its blocks over ``model`` in place: no leaf a
    step gathers is split over ``model``, and only EP's experts, whose
    ffn dim ``make_rules`` splits over ``data`` as well, are gathered
    (over ``data``): elsewhere no train, prefill or decode step gathers a
    byte.  No full gradient of a stacked leaf outlives its unit."""
    for r, rec in enumerate(runs[mesh]["bytes"]):
        for key, got in rec.items():
            if not key.startswith("train"):
                continue
            split = got["split_axes"]
            assert all("model" not in axes for axes in split.values()), \
                (mesh, r, key, split)
            ep_over_data = {p for p in split if p.rsplit("[", 1)[-1] in
                            ("'w_gate']", "'w_up']", "'w_down']")
                            and "shared" not in p}
            assert set(split) == ep_over_data, (mesh, r, key, split)
            assert all(axes == ["data"] for axes in split.values())
            serve = [st for k, sts in rec.items() if k.startswith("serve")
                     and k.split("/")[1:4] == key.split("/")[1:4]
                     for st in sts]
            for st in [got["gather_stats"]] + serve:
                assert (st["gathered_bytes_peak"] == 0) == (not split), \
                    (mesh, r, key, st)
                assert st.get("stale_stacked_grads", 0) == 0, (mesh, r, key)


@pytest.mark.parametrize("mesh,case,impl", list(RUNS))
def test_each_rank_holds_its_blocks_as_the_memory_model_counts(runs, mesh,
                                                               case, impl):
    """Before the steps and after each, every rank holds of each leaf of
    the parameters 1/k of it and of each leaf of m, v and master 1/k' of
    it, k and k' the ways the reference's ``params_shardings`` and
    ``opt_shardings`` split it in tp on this mesh; its parameters (bf16,
    2 bytes an element) add up to ``model_memory``'s ``params`` term for
    tp, and its m, v and master (f32: 12 bytes) to the ``opt`` term, but
    where EP splits the experts' ffn dim over ``data``: the memory model
    (the reference's formula, ``src/repro/launch/memmodel.py:50-55``,
    which the port's equals) splits those leaves over the data axes a
    second time for ZeRO-1, where the placements, the reference's as the
    port's, do not; there the ranks hold exactly the bytes it leaves
    out."""
    shape = MESHES[mesh]
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
    # the memory model's second ZeRO-1 split: a leaf whose placement
    # already names the data axis, and that has a dim it leaves whole and
    # the data axis divides, counted at 1/data of what a rank holds
    ctx, data = DistContext.create(cfg, sizes, mode="tp"), sizes["data"]
    twice = 0.0
    for _, leaf in spec_leaves(LM(cfg, max_seq=worker.SEQ,
                                  device="cpu").spec):
        spec = ctx.pspec(leaf.axes)
        ways = int(np.prod([sizes[a] for e in spec if e
                            for a in ((e,) if isinstance(e, str) else e)]))
        if data > 1 and any(e == "data" or (isinstance(e, tuple) and
                                            "data" in e) for e in spec) \
                and any(e is None and n % data == 0
                        for e, n in zip(spec, leaf.shape)):
            twice += 12 * math.prod(leaf.shape) / ways * (1 - 1 / data)
    assert (twice > 0) == (mesh == "2x2" and case == "qwen3-moe")
    split = 0
    for rec in runs[mesh]["bytes"]:
        held_all = rec[_train_key(mesh, case, impl)]["held"]
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
                           for lf in held[n].values()) == mm["opt"] + twice
    assert split
