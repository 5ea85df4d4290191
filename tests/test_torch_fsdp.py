"""FSDP's per-unit gather (``repro_torch/distributed/fsdp.py``: each unit's
parameters gathered just in time, its gradients reduced to the shards as
the backward reaches them) through ``build_train_step`` and the serve
steps in ``fsdp`` mode, on gloo ranks on the CPU, against the reference.

The parent draws the inputs (the port's ``LM.init``, seed 0, f32; the
token pipeline's batches), writes them into an ``.npz`` and starts one
spawn a mesh of ``tests/_torch_fsdp_worker.py`` ranks ((2, 1) with the
serve steps, and (2, 2); torch and the port only, a ``FileStore``
rendezvous in the test's own directory, every process bounded by its own
timeout) and, beside them, one process a config of
``tests/_jax_sharded_ref.py`` for the reference's own
``build_train_step`` (remat none: remat changes no value,
``tests/test_torch_distributed.py``) and ``build_prefill_step`` /
``build_decode_step`` (fsdp, ``sp_decode=False``) on a 1 x 1 mesh.  The cases cut reduced configs so that each placement
shows: yi-6b at 4 layers (the layers axis split at 2 and at 4 ranks: each
layer broadcast from its owner, its gradient reduced back to it),
recurrentgemma-9b at 5 layers (one group and a tail of two, every leaf
split on a width dimension: all-gathers and reduce-scatters), whisper-tiny
(an encoder and a decoder stack, its position tables and tied embedding
outside them); 1 and 2 microbatches; remat none and full.

Tolerances as ``tests/test_torch_distributed.py``'s (PERF.md section 2):
loss 1e-5; the gradients, read as m after step 1, within 1e-4 of each
leaf's max-abs; grad norm rtol 1e-5; masters and parameters after step 2
within 1e-6 of max-abs plus 0.1 x (lr_1 + lr_2).  The serve steps as
``tests/test_torch_serve_steps.py``'s: logits and caches 1e-4, ids equal.

Bytes, counted on every rank: between steps each rank holds exactly its
shard of every parameter at the reference's ``fsdp_sharding`` placement,
and the shards add up to ``launch/memmodel.py``'s ``params`` term for the
mesh; the gathered bytes alive at once (the step's ``gather_stats``)
never exceed twice the largest unit (a layer, a group, a tail layer, or a
leaf outside the stacks, counted here from the spec), in training under
both remats and in serving; no full gradient of a stacked leaf is alive
once the backward has moved past its unit.
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

import _torch_fsdp_worker as worker  # noqa: E402
import _torch_serve_worker as serve_worker  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.distributed.context import DistContext as RefContext  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.distributed import DistContext  # noqa: E402
from repro_torch.distributed.fsdp import split_of  # noqa: E402
from repro_torch.launch.memmodel import model_memory  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.layers import spec_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_fsdp_worker.py"
SHARDED_REF = Path(__file__).resolve().parent / "_jax_sharded_ref.py"
MESHES = {"2x1": (2, 1), "2x2": (2, 2)}
SERVE_MESH = "2x1"
CASES = [worker.case_key(a, mb) for a in worker.ARCHS for mb in worker.MICRO]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
NORM_RTOL = 1e-5
MASTER_TOL = 1e-6
FLIP_SHARE = 0.1                # of lr_1 + lr_2
SERVE_TOL = 1e-4
SPAWN_TIMEOUT = 300
PIPE_SEED = 3


def _inputs() -> dict:
    """The weights and batches of every train case and serve config."""
    out = {}
    for arch in worker.ARCHS:
        cfg = worker.config(arch, get_config)
        weights = serve_worker._flat(LM(cfg, max_seq=worker.SEQ,
                                        device="cpu").init(0, torch.float32))
        pipe = TokenPipeline(cfg, ShapeConfig("t", "train", worker.SEQ,
                                              worker.BATCH), seed=PIPE_SEED)
        batches = [pipe.train_batch(s) for s in range(2)]
        for mb in worker.MICRO:
            case = worker.case_key(arch, mb)
            out.update({f"{case}|params|{p}": t.numpy().copy()
                        for p, t in weights.items()})
            for s, b in enumerate(batches):
                out.update({f"{case}|batch{s}|{k}": v for k, v in b.items()})
        serve = serve_worker._flat(LM(cfg, max_seq=worker.CACHE,
                                      device="cpu").init(0, torch.float32))
        out.update({f"serve/{arch}|params|{p}": t.numpy().copy()
                    for p, t in serve.items()})
        batch = TokenPipeline(cfg, ShapeConfig(
            "p", "prefill", worker.PROMPT, worker.SERVE_BATCH),
            seed=PIPE_SEED).prefill_batch(0)
        out.update({f"serve/{arch}|batch|{k}": v for k, v in batch.items()})
    return out


def _start(mesh: str, cases: Path, tmp: Path):
    n_data, n_model = MESHES[mesh]
    world = n_data * n_model
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    procs = []
    for r in range(world):
        with open(tmp / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), "--rank", str(r), "--world",
                 str(world), "--store", str(tmp / "store"), "--mesh",
                 f"{n_data},{n_model}", "--cases", str(cases), "--out",
                 str(tmp)] + (["--serve"] if mesh == SERVE_MESH else []),
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


def _collect(mesh: str, procs, tmp: Path, deadline: float) -> dict:
    _wait(procs, deadline)
    world = len(procs)
    text = "\n".join((tmp / f"rank{r}.log").read_text() for r in range(world))
    assert all(p.returncode == 0 for p in procs), text[-6000:]
    out = {"world": world, "result": dict(np.load(tmp / "result.npz")),
           "bytes": [json.loads((tmp / f"bytes-{r}.json").read_text())
                     for r in range(world)]}
    if mesh == SERVE_MESH:
        out["serve"] = dict(np.load(tmp / "serve.npz"))
        out["serve_bytes"] = [json.loads(
            (tmp / f"serve-bytes-{r}.json").read_text()) for r in range(world)]
    return out


def _reference_jobs(arch: str) -> list:
    """The reference's single-device runs of one config: its train cases
    and its serve steps (``tests/_jax_sharded_ref.py`` jobs, fsdp on a
    1 x 1 mesh)."""
    common = {"arch": arch, "replace": worker.ARCHS[arch], "mesh": [1, 1],
              "mode": "fsdp"}
    jobs = [{**common, "kind": "train", "key": worker.case_key(arch, mb),
             "microbatches": mb, "seq": worker.SEQ, "batch": worker.BATCH,
             "train": worker.TRAIN} for mb in worker.MICRO]
    jobs.append({**common, "kind": "serve", "key": f"serve/{arch}",
                 "cache": worker.CACHE, "steps": worker.STEPS,
                 "sp_decode": False})
    return jobs


def _reference(out: dict) -> tuple:
    """The reference's outputs -> ({case: train results}, {arch: serve
    results}), each as ``tests/test_torch_distributed.py`` and
    ``tests/test_torch_serve_steps.py`` hold them."""
    def leaves(key, name):
        return {k.split("|", 2)[2]: v for k, v in out.items()
                if k.startswith(f"{key}|{name}|")}
    train = {}
    for case in CASES:
        got = {k: [float(out[f"{case}|{k}{s}"]) for s in range(2)]
               for k in ("loss", "grad_norm", "lr")}
        got.update({n: leaves(case, n) for n in ("m1", "master2", "params2")})
        train[case] = got
    serve = {}
    for arch in worker.ARCHS:
        key = f"serve/{arch}"
        serve[arch] = {"logits": out[f"{key}|logits"], "ids": out[f"{key}|ids"],
                       "cache0": leaves(key, "cache0"),
                       "cache1": leaves(key, "cache1")}
    return train, serve


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the reference's train results, "ref_serve": its serve
    results, mesh: that spawn's outputs}: every spawn and one reference
    process a config run together."""
    tmp = tmp_path_factory.mktemp("fsdp")
    cases = tmp / "cases.npz"
    np.savez(cases, **_inputs())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    refs = []
    for i, arch in enumerate(worker.ARCHS):
        (tmp / f"jobs{i}.json").write_text(json.dumps(_reference_jobs(arch)))
        with open(tmp / f"ref{i}.log", "w") as log:
            refs.append(subprocess.Popen(
                [sys.executable, str(SHARDED_REF), "--jobs",
                 str(tmp / f"jobs{i}.json"), "--inputs", str(cases),
                 "--out", str(tmp / f"ref{i}.npz")],
                stdout=log, stderr=subprocess.STDOUT, env=env))
    started = {}
    for mesh in MESHES:
        (tmp / mesh).mkdir()
        started[mesh] = _start(mesh, cases, tmp / mesh)
    deadline = time.monotonic() + SPAWN_TIMEOUT
    got = {m: _collect(m, p, tmp / m, deadline) for m, p in started.items()}
    _wait(refs, deadline)
    for i, p in enumerate(refs):
        assert p.returncode == 0, (tmp / f"ref{i}.log").read_text()[-6000:]
    out = {}
    for i in range(len(refs)):
        out.update(np.load(tmp / f"ref{i}.npz"))
    train, serve = _reference(out)
    return {"ref": train, "ref_serve": serve, **got}


def _close(got: dict, want: dict, tol: float, what: str, extra=0.0):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-30) + extra,
            err_msg=f"{what} {k}")


@pytest.mark.parametrize("remat", worker.REMATS)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_steps_match_the_single_device_reference(runs, mesh, case,
                                                       remat):
    res, want = runs[mesh]["result"], runs["ref"][case]
    key = f"{case}/{remat}"
    for s in range(2):
        np.testing.assert_allclose(res[f"{key}|loss{s}"], want["loss"][s],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(res[f"{key}|grad_norm{s}"],
                                   want["grad_norm"][s], rtol=NORM_RTOL)
        np.testing.assert_allclose(res[f"{key}|lr{s}"], want["lr"][s],
                                   rtol=1e-6)

    def leaves(name):
        return {k.split("|", 2)[2]: v for k, v in res.items()
                if k.startswith(f"{key}|{name}|")}
    _close(leaves("m1"), want["m1"], GRAD_TOL, f"{mesh} {key} m after step 1")
    flip = FLIP_SHARE * sum(want["lr"])
    _close(leaves("master2"), want["master2"], MASTER_TOL,
           f"{mesh} {key} master after step 2", flip)
    _close(leaves("params2"), want["params2"], MASTER_TOL,
           f"{mesh} {key} params after step 2", flip)


@pytest.mark.parametrize("arch", list(worker.ARCHS))
def test_serve_steps_match_the_reference(runs, arch):
    res, want = runs[SERVE_MESH]["serve"], runs["ref_serve"][arch]
    np.testing.assert_array_equal(res[f"{arch}|ids"], want["ids"])
    got = res[f"{arch}|logits"]
    assert got.shape == want["logits"].shape
    np.testing.assert_allclose(got, want["logits"], atol=SERVE_TOL,
                               rtol=SERVE_TOL)
    for c in ("cache0", "cache1"):
        mine = {k.split("|", 2)[2]: v for k, v in res.items()
                if k.startswith(f"{arch}|{c}|")}
        assert sorted(mine) == sorted(want[c]), (arch, c)
        for p, w in want[c].items():
            if p == "['pos']":
                np.testing.assert_array_equal(mine[p], w)
            else:
                np.testing.assert_allclose(mine[p], w, atol=SERVE_TOL,
                                           rtol=SERVE_TOL,
                                           err_msg=f"{arch} {c} {p}")


def _unit_bytes(arch: str, max_seq: int) -> list:
    """The full bytes (f32) of every unit the model gathers: each layer of
    a ``stack`` and of whisper's ``encoder`` and ``decoder``, each group of
    ``groups``, each layer of the ``tail``, and each leaf outside them."""
    lm = LM(worker.config(arch, get_config), max_seq=max_seq, device="cpu")
    units: dict = {}
    for path, p in spec_leaves(lm.spec):
        keys = path[2:-2].split("']['")
        if lm.cfg.family == "encdec" and keys[0] in ("encoder", "decoder"):
            name, n = keys[0], math.prod(p.shape[1:])
        elif keys[0] == "decoder" and keys[1] in ("stack", "groups"):
            name, n = keys[1], math.prod(p.shape[1:])
        elif keys[0] == "decoder":                  # a layer of the tail
            name, n = "/".join(keys[:3]), math.prod(p.shape)
        else:
            name, n = path, math.prod(p.shape)
        units[name] = units.get(name, 0) + 4 * n
    return list(units.values())


@pytest.mark.parametrize("arch", list(worker.ARCHS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_holds_its_shard_between_steps(runs, mesh, arch):
    """Before the first step and after each, every rank holds of each
    parameter leaf 1/k of it, k the ways the reference's ``fsdp_sharding``
    splits it on this mesh, and its leaves add up to ``model_memory``'s
    ``params`` term (bf16 bytes, 2 an element) for the mesh."""
    n_data, n_model = MESHES[mesh]
    sizes = {"data": n_data, "model": n_model}
    rcfg = worker.config(arch, ref_config)
    rlm = RefLM(rcfg, max_seq=worker.SEQ)
    rctx = RefContext.create(rcfg, AbstractMesh((n_data, n_model),
                                                ("data", "model")),
                             mode="fsdp")
    specs = ref_shd.params_shardings(rctx, rlm.axes(), rlm.abstract())
    ways = {jax.tree_util.keystr(p): int(np.prod(
        [sizes[a] for e in sh.spec if e
         for a in ((e,) if isinstance(e, str) else e)]))
        for p, sh in jax.tree_util.tree_flatten_with_path(specs)[0]}
    cfg = worker.config(arch, get_config)
    mm = model_memory(cfg, ShapeConfig("t", "train", worker.SEQ,
                                       worker.BATCH),
                      DistContext.create(cfg, sizes, mode="fsdp"),
                      TrainConfig(), LM(cfg, max_seq=worker.SEQ,
                                        device="cpu"), hbm_bytes=80e9)
    split = 0
    for r in range(runs[mesh]["world"]):
        for mb in worker.MICRO:
            for remat in worker.REMATS:
                rec = runs[mesh]["bytes"][r][
                    f"{worker.case_key(arch, mb)}/{remat}"]
                assert len(rec["held"]) == 3
                for held in rec["held"]:
                    assert sorted(held) == sorted(ways)
                    for p, (local, full) in held.items():
                        assert local * ways[p] == full, (mesh, arch, p)
                        split += ways[p] > 1
                    assert 2 * sum(lf[0] for lf in held.values()) == \
                        mm["params"]
    assert split


@pytest.mark.parametrize("remat", worker.REMATS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_gathered_bytes_stay_within_two_units(runs, mesh, remat):
    """The high-water mark of gathered bytes in every train step, on every
    rank, is at most twice the largest unit, and that unit is the one the
    spec gives (so the gather holds no more than a unit at a time, plus
    one leaf's staging)."""
    for arch in worker.ARCHS:
        largest = max(_unit_bytes(arch, worker.SEQ))
        for r in range(runs[mesh]["world"]):
            for mb in worker.MICRO:
                st = runs[mesh]["bytes"][r][
                    f"{worker.case_key(arch, mb)}/{remat}"]["gather_stats"]
                assert st["largest_unit_bytes"] == largest, (arch, st)
                assert 0 < st["gathered_bytes_peak"] <= 2 * largest, \
                    (mesh, arch, mb, remat, st, largest)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_no_full_stacked_gradient_outlives_its_unit(runs, mesh):
    """Each unit's backward finds no full gradient of a stacked leaf left
    from the units before it, on every rank, in every case."""
    for r in range(runs[mesh]["world"]):
        for key, rec in runs[mesh]["bytes"][r].items():
            assert rec["gather_stats"]["stale_stacked_grads"] == 0, \
                (mesh, r, key, rec["gather_stats"])


def test_serve_steps_gather_a_unit_at_a_time(runs):
    """The prefill and every decode step hold at most twice the largest
    unit gathered at once, on every rank."""
    for arch in worker.ARCHS:
        largest = max(_unit_bytes(arch, worker.CACHE))
        for r in range(runs[SERVE_MESH]["world"]):
            stats = runs[SERVE_MESH]["serve_bytes"][r][arch]
            assert len(stats) == 1 + worker.STEPS
            for st in stats:
                assert st["largest_unit_bytes"] == largest, (arch, st)
                assert 0 < st["gathered_bytes_peak"] <= 2 * largest, \
                    (arch, st, largest)


# ----------------------------------------------------------------------
# in the test process: no ranks
# ----------------------------------------------------------------------

class _Mesh:
    def __init__(self, coord):
        self.coord = coord

    def get_coordinate(self):
        return self.coord


class _Ctx:
    """What ``split_of`` reads of a ``DistContext``: the axis sizes, this
    rank's coordinate and the process group over some axes."""

    def __init__(self, axes, coord):
        self.axes, self.mesh = axes, _Mesh(coord)

    def group(self, axes):
        return axes


@pytest.mark.parametrize("placements,coord,want", [
    # nested over both axes, data major: chunk = i_data * 2 + i_model
    ((("S", 0), ("S", 0)), (1, 0), (0, 4, 2, ("data", "model"))),
    ((("S", 1), ("S", 1)), (0, 1), (1, 4, 1, ("data", "model"))),
    # a Shard over an axis of one rank splits nothing (tp's model rule)
    ((("S", 2), ("S", 1)), (1, 0), (2, 2, 1, ("data",))),
    ((("R",), ("S", 0)), (1, 1), (0, 2, 1, ("model",))),
    ((("R",), ("R",)), (1, 1), (None, 1, 0, ())),
])
def test_split_of_reads_the_nested_order(placements, coord, want):
    from torch.distributed.tensor import Replicate, Shard
    axes = {"data": 2, "model": 2 if want[3] != ("data",) else 1}
    pl = tuple(Shard(p[1]) if p[0] == "S" else Replicate()
               for p in placements)
    sp = split_of(_Ctx(axes, coord), pl)
    assert (sp.dim, sp.n, sp.chunk, sp.axes) == want
    assert sp.group == (want[3] or None)


def test_two_dimensions_split_raise():
    from torch.distributed.tensor import Shard
    with pytest.raises(NotImplementedError, match="several"):
        split_of(_Ctx({"data": 2, "model": 2}, (0, 0)), (Shard(0), Shard(1)))
