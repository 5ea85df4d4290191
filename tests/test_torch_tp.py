"""Tensor-parallel compute over the ``model`` axis
(``repro_torch/distributed/tensor_parallel.py`` and the tp paths of
``models/{layers,attention,transformer,model}.py``) through
``build_train_step`` and the serve steps in ``tp`` mode, on gloo ranks on
the CPU, against the reference's own sharded steps.

The parent draws the inputs (the port's ``LM.init``, seed 0, f32; the
token pipeline's batches and prompts, a vlm's patch embeddings), writes
them into an ``.npz`` and starts, all together, one
``tests/_jax_sharded_ref.py`` process (the reference's
``build_train_step``, ``build_prefill_step`` and ``build_decode_step`` in
tp on the same meshes, ``jax.make_mesh`` with ``Auto`` axes over 8 host
devices) and one spawn a mesh of ``tests/_torch_tp_worker.py`` ranks:
(1, 2) with reduced yi-6b (GQA 4:2, the kv heads split) and internvl2-2b
(vlm); (2, 2) with minicpm-2b (tied embeddings) and internvl2-2b; (1, 4)
with phi3-medium-14b (GQA 4:2: the kv heads whole, each rank reading the
one its q head maps to), minicpm-2b, and yi-6b with 6 heads and 6 kv
heads, whose heads ``make_rules`` leaves whole (attention on every rank;
the mlp and vocab still split).  The padded vocab's 9 padded
columns lie in the last rank's block.  Each runs two train steps (remat
none, and at (2, 2) minicpm-2b also dots and full against the
reference's none: remat changes no value; internvl2-2b at (2, 2) also in
two microbatches) and the serve steps with ``sp_decode`` off and on.

Tolerances as ``tests/test_torch_distributed.py``'s (PERF.md section 2):
loss 1e-5; the gradients, read as m after step 1, within 1e-4 of each
leaf's max-abs; grad norm rtol 1e-5; masters and parameters after step 2
within 1e-6 of max-abs plus 0.1 x (lr_1 + lr_2).  The serve steps as
``tests/test_torch_serve_steps.py``'s: logits and caches 1e-4, ids equal.

The train step's ``grad_sq`` (each leaf's squared gradient norm over
every rank, the terms of the grad norm) after step 1: each leaf's within
1e-4 of what the reference's m after step 1 gives, their sum the squared
grad norm within 1e-5.

Bytes, counted on every rank: no step gathers a byte (each rank reads its
blocks in place), and between steps each rank holds of each leaf of the
parameters and of m, v and master exactly its block at the placement the
reference gives it, adding up to ``launch/memmodel.py``'s ``params`` and
``opt`` terms for tp on the mesh.
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
# case -> (arch, config fields replaced)
CONFIGS = {"yi-6b": ("yi-6b", {}), "minicpm-2b": ("minicpm-2b", {}),
           "phi3-medium-14b": ("phi3-medium-14b", {}),
           "internvl2-2b": ("internvl2-2b", {}),
           "heads6": ("yi-6b", {"num_heads": 6, "num_kv_heads": 6})}
# mesh -> (shape, its cases): every case on one mesh at least, each mesh
# with its heads split, the kv heads split at 2 ranks and whole at 4
MESHES = {"1x2": ((1, 2), ("yi-6b", "internvl2-2b")),
          "2x2": ((2, 2), ("minicpm-2b", "internvl2-2b")),
          "1x4": ((1, 4), ("phi3-medium-14b", "minicpm-2b", "heads6"))}
REMAT_MESH, REMAT_CASE, REMATS = "2x2", "minicpm-2b", ("dots", "full")
# (mesh, case, remat, microbatches)
TRAIN_RUNS = [(m, c, "none", 1) for m, (_, cs) in MESHES.items()
              for c in cs] \
    + [(REMAT_MESH, REMAT_CASE, r, 1) for r in REMATS] \
    + [("2x2", "internvl2-2b", "none", 2)]
SERVE_RUNS = [(m, c, sp) for m, (_, cs) in MESHES.items() for c in cs
              for sp in (False, True)]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
NORM_RTOL = 1e-5
MASTER_TOL = 1e-6
FLIP_SHARE = 0.1                # of lr_1 + lr_2
SERVE_TOL = 1e-4
SPAWN_TIMEOUT = 300
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


def _train_key(mesh, case, remat, mb=1):
    return f"train/{mesh}/{case}/{remat}/mb{mb}"


def _serve_key(mesh, case, sp):
    return f"serve/{mesh}/{case}/{'sp' if sp else 'nosp'}"


def _jobs() -> tuple[list, list]:
    """(the port's jobs, the reference's): the reference runs remat none
    only."""
    port, ref = [], []
    for mesh, case, remat, mb in TRAIN_RUNS:
        arch, replace = CONFIGS[case]
        job = {"kind": "train", "key": _train_key(mesh, case, remat, mb),
               "inputs": case, "arch": arch, "replace": replace,
               "mesh": list(MESHES[mesh][0]), "remat": remat,
               "microbatches": mb}
        port.append(job)
        if remat == "none":
            ref.append({**job, "seq": worker.SEQ, "batch": worker.BATCH,
                        "train": worker.TRAIN})
    for mesh, case, sp in SERVE_RUNS:
        arch, replace = CONFIGS[case]
        job = {"kind": "serve", "key": _serve_key(mesh, case, sp),
               "inputs": case, "arch": arch, "replace": replace,
               "mesh": list(MESHES[mesh][0]), "sp_decode": sp}
        port.append(job)
        ref.append({**job, "cache": worker.cache_len(_cfg(case)),
                    "steps": worker.STEPS})
    return port, ref


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
    tmp = tmp_path_factory.mktemp("tp")
    np.savez(tmp / "cases.npz", **_inputs())
    port, ref = _jobs()
    (tmp / "jobs.json").write_text(json.dumps(port))
    (tmp / "ref-jobs.json").write_text(json.dumps(ref))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    with open(tmp / "ref.log", "w") as log:
        refp = subprocess.Popen(
            [sys.executable, str(SHARDED_REF), "--jobs",
             str(tmp / "ref-jobs.json"), "--inputs", str(tmp / "cases.npz"),
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


@pytest.mark.parametrize("mesh,case,remat,mb", TRAIN_RUNS)
def test_train_steps_match_the_sharded_reference(runs, mesh, case, remat,
                                                 mb):
    res, want = runs[mesh]["result"], runs["ref"]
    key = _train_key(mesh, case, remat, mb)
    rkey = _train_key(mesh, case, "none", mb)
    lrs = [float(want[f"{rkey}|lr{s}"]) for s in range(2)]
    for s in range(2):
        np.testing.assert_allclose(res[f"{key}|loss{s}"],
                                   want[f"{rkey}|loss{s}"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(res[f"{key}|grad_norm{s}"],
                                   want[f"{rkey}|grad_norm{s}"],
                                   rtol=NORM_RTOL)
        np.testing.assert_allclose(res[f"{key}|lr{s}"], lrs[s], rtol=1e-6)
    _close(_leaves(res, key, "m1"), _leaves(want, rkey, "m1"), GRAD_TOL,
           f"{key} m after step 1")
    flip = FLIP_SHARE * sum(lrs)
    for name in ("master2", "params2"):
        _close(_leaves(res, key, name), _leaves(want, rkey, name),
               MASTER_TOL, f"{key} {name}", flip)


@pytest.mark.parametrize("mesh,case,remat,mb", TRAIN_RUNS)
def test_grad_sq_is_each_leafs_share_of_the_grad_norm(runs, mesh, case,
                                                      remat, mb):
    """``step_fn.grad_sq`` after step 1: each leaf's squared gradient norm
    over every rank, read against the reference's m after step 1
    ((1 - beta1) times the clipped gradient), adding up to the squared
    grad norm."""
    res, want = runs[mesh]["result"], runs["ref"]
    key = _train_key(mesh, case, remat, mb)
    rkey = _train_key(mesh, case, "none", mb)
    tc = TrainConfig(**worker.TRAIN)
    norm = float(want[f"{rkey}|grad_norm0"])
    scale = (1 - tc.beta1) * min(1.0, tc.grad_clip / norm)
    got = _leaves(res, key, "grad_sq1")
    m1 = _leaves(want, rkey, "m1")
    assert sorted(got) == sorted(m1)
    for p, m in m1.items():
        np.testing.assert_allclose(np.sqrt(got[p]) * scale,
                                   np.linalg.norm(m.astype(np.float64)),
                                   rtol=GRAD_TOL, err_msg=f"{key} {p}")
    np.testing.assert_allclose(np.sqrt(sum(got.values())), norm,
                               rtol=NORM_RTOL)


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
    step gathers a byte (tp splits the dense and vlm leaves over ``model``
    only), and no full gradient of a stacked leaf outlives its unit."""
    for r, rec in enumerate(runs[mesh]["bytes"]):
        for key, got in rec.items():
            stats = [got["gather_stats"]] if key.startswith("train") else got
            for st in stats:
                assert st["gathered_bytes_peak"] == 0, (mesh, r, key, st)
                assert st.get("stale_stacked_grads", 0) == 0, (mesh, r, key)


@pytest.mark.parametrize("mesh,case", [(m, c) for m, (_, cs) in MESHES.items()
                                       for c in cs])
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
