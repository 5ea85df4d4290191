"""The port's data-parallel train step (``repro_torch.distributed.steps``
``build_train_step``, FSDP and ZeRO-1 on ``torch.distributed``) on gloo
ranks on the CPU, against the reference's single-device step, and its moe
case also against the reference's sharded step.

The test process keeps its one CPU device (``tests/conftest.py``), so the
parent computes the reference's own ``build_train_step`` on a 1 x 1 mesh of
its one CPU device (``jax.value_and_grad(lm.loss)`` over the reference's
microbatches, then ``adamw_update``) for every case: reduced dense, ssm,
hybrid, moe, vlm and encdec configs in f32, 1 and 2 microbatches, a global
batch of 8 x 32 tokens, two steps.  The moe config's capacity factor is cut
to 0.5, so routing the global tokens and routing each rank's tokens drop
different tokens (``test_the_moe_case_drops_tokens_by_global_routing``).
Meanwhile a process of its own with 8 host devices
(``tests/_jax_sharded_ref.py``) runs the reference's sharded
``build_train_step`` of the moe cases on (2, 1) and (4, 1) meshes with
``Auto`` axis types (on the default Explicit axes it fails under jax 0.9.0,
ROADMAP queue C): the GSPMD program, which routes each microbatch's global
tokens, as the port's tp runs must.
It writes the weights and batches into an ``.npz``; one spawn a mesh then
starts ``tests/_torch_dist_worker.py`` once a rank (torch and the port
only, a ``FileStore`` rendezvous in the test's own directory, every
process bounded by its own timeout) and runs every case there: (2, 1) and
(4, 1) in ``tp`` mode (data parallel with ZeRO-1), (2, 2) in ``fsdp`` mode,
and (1, 1) in ``fsdp`` mode, where the worker also holds the step to
``launch/train.py``'s ``train_step`` bit for bit.  The meshes run remat
none, full and dots, which the reference's step (run without remat)
matches: remat changes no value (``test_remat_changes_no_value``).

Tolerances (PERF.md section 2): loss 1e-5; the gradients, read as m after
step 1 (``(1 - b1)`` times the clipped gradient), within 1e-4 of each
leaf's max-abs (1e-3 for mamba2, whose SSD sums run in another order);
the grad norm rtol 1e-5; the masters and parameters after step 2 within
1e-6 of each leaf's max-abs, plus 0.1 x (lr_1 + lr_2).  That margin: the
two packages' gradients differ in their last bits (1e-4 above; on several
ranks they are also summed in another order), and AdamW divides each
element's step by that element's own RMS, so an element whose gradient
cancels to near zero carries the difference into its whole step; 0.1 x
the learning rates is a twentieth of what one step of the other sign
would move an element (2 lr a step).  Where the gradients are the same
bits, the 1e-6 alone holds (``tests/test_torch_train.py``), and on the
one-rank mesh the step is ``train_step``'s, bit for bit.
"""
import functools
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
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import _torch_dist_worker as worker  # noqa: E402
from repro.configs import TrainConfig as RefTrainConfig  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import ShapeConfig as RefShapeConfig  # noqa: E402
from repro.distributed.context import DistContext as RefContext  # noqa: E402
from repro.distributed.steps import build_train_step as ref_build  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.optim import init_opt_state as ref_init_opt  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.reducer import tree_flatten_with_path  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.distributed import DistContext, build_train_step  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_dist_worker.py"
# mesh name -> (data, model), mode, remat
MESHES = {"2x1-tp": ((2, 1), "tp", "none"),
          "4x1-tp": ((4, 1), "tp", "full"),
          "2x2-fsdp": ((2, 2), "fsdp", "dots"),
          "1x1-fsdp": ((1, 1), "fsdp", "none")}
CASES = [worker.case_key(a, mb) for a, mb in worker.CASES]
MOE_CASES = [(a, mb) for a, mb in worker.CASES if a == "qwen2-moe-a2.7b"]
SHARDED = ("2x1-tp", "4x1-tp")     # the meshes the sharded reference runs
SHARDED_REF = Path(__file__).resolve().parent / "_jax_sharded_ref.py"
LOSS_TOL = 1e-5
GRAD_TOL = {"mamba2-370m": 1e-3}
DEFAULT_GRAD_TOL = 1e-4
NORM_RTOL = 1e-5
MASTER_TOL = 1e-6
FLIP_SHARE = 0.1                # of lr_1 + lr_2
SPAWN_TIMEOUT = 300
PIPE_SEED = 3


def _batches(arch):
    cfg = worker.config(arch, get_config)
    pipe = TokenPipeline(cfg, ShapeConfig("t", "train", worker.SEQ,
                                          worker.BATCH), seed=PIPE_SEED)
    return [pipe.train_batch(s) for s in range(2)]


def _np_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.array(x, np.float32) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's two steps of every case, and the ``.npz`` of the
    cases' weights and batches the workers read."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    inputs, want = {}, {}
    tmp = tmp_path_factory.mktemp("dist-cases")
    sharded = None
    # the moe cases first: the sharded reference starts once their inputs
    # are written and runs beside the other cases
    for arch, mb in sorted(worker.CASES, key=lambda c: c not in MOE_CASES):
        if sharded is None and (arch, mb) not in MOE_CASES:
            sharded = _start_sharded_reference(inputs, tmp)
        key = worker.case_key(arch, mb)
        cfg = worker.config(arch, ref_config)
        lm = RefLM(cfg, max_seq=worker.SEQ)
        tc = RefTrainConfig(microbatches=mb, remat="none", **worker.TRAIN)
        ctx = RefContext.create(cfg, mesh)
        params = lm.init(jax.random.PRNGKey(0), jnp.float32)
        for p, x in _np_leaves(params).items():
            inputs[f"{key}|params|{p}"] = x
        batches = _batches(arch)
        got = {"loss": [], "grad_norm": [], "lr": []}
        with mesh:
            step, _ = ref_build(lm, tc, ctx, RefShapeConfig(
                "t", "train", worker.SEQ, worker.BATCH))
            opt = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                         ref_init_opt(params))
            for s, b in enumerate(batches):
                for k, v in b.items():
                    inputs[f"{key}|batch{s}|{k}"] = v
                params, opt, m = step(params, opt, {
                    k: jnp.asarray(v) for k, v in b.items()})
                for k in ("loss", "grad_norm", "lr"):
                    got[k].append(float(m[k]))
                if s == 0:
                    got["m1"] = _np_leaves(opt.m)
        got["master2"] = _np_leaves(opt.master)
        got["params2"] = _np_leaves(params)
        want[key] = got
    if sharded is None:
        sharded = _start_sharded_reference(inputs, tmp)
    path = tmp / "cases.npz"
    np.savez(path, **inputs)
    return path, want, _sharded_results(sharded, tmp)


def _start_sharded_reference(inputs: dict, tmp: Path):
    """Start the reference's sharded ``build_train_step`` of the moe cases
    (gspmd, no remat) on every tp mesh of ``SHARDED``, from the moe cases'
    weights and batches in ``inputs``."""
    np.savez(tmp / "moe-cases.npz", **{
        k: v for k, v in inputs.items()
        if any(k.startswith(worker.case_key(*c) + "|") for c in MOE_CASES)})
    jobs = [{"kind": "train", "key": f"{mesh}|{worker.case_key(arch, mb)}",
             "inputs": worker.case_key(arch, mb), "arch": arch,
             "replace": {"capacity_factor": worker.MOE_CAPACITY_FACTOR},
             "mesh": list(MESHES[mesh][0]), "microbatches": mb,
             "seq": worker.SEQ, "batch": worker.BATCH, "train": worker.TRAIN}
            for mesh in SHARDED for arch, mb in MOE_CASES]
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    log = open(tmp / "sharded.log", "w")
    try:
        return subprocess.Popen(
            [sys.executable, str(SHARDED_REF), "--jobs",
             str(tmp / "jobs.json"), "--inputs", str(tmp / "moe-cases.npz"),
             "--out", str(tmp / "sharded.npz")],
            stdout=log, stderr=subprocess.STDOUT, env=env)
    finally:
        log.close()


def _sharded_results(proc, tmp: Path) -> dict:
    """The sharded reference's outputs: {mesh: {case: {"loss": [...],
    "grad_norm": [...], "lr": [...], "m1": leaves, "master2": ...,
    "params2": ...}}}."""
    try:
        proc.wait(timeout=SPAWN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
    assert proc.returncode == 0, (tmp / "sharded.log").read_text()[-6000:]
    res = dict(np.load(tmp / "sharded.npz"))
    out: dict = {}
    for mesh in SHARDED:
        for arch, mb in MOE_CASES:
            case = worker.case_key(arch, mb)
            key = f"{mesh}|{case}"
            got = {k: [float(res[f"{key}|{k}{s}"]) for s in range(2)]
                   for k in ("loss", "grad_norm", "lr")}
            for name in ("m1", "master2", "params2"):
                got[name] = {k.split("|", 3)[3]: v for k, v in res.items()
                             if k.startswith(f"{key}|{name}|")}
            out.setdefault(mesh, {})[case] = got
    return out


def _spawn(mesh: str, cases: Path, tmp: Path) -> dict:
    (n_data, n_model), mode, remat = MESHES[mesh]
    world = n_data * n_model
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    procs, logs = [], []
    for r in range(world):
        log = open(tmp / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), "--rank", str(r), "--world",
             str(world), "--store", str(tmp / "store"), "--mesh",
             f"{n_data},{n_model}", "--mode", mode, "--remat", remat,
             "--cases", str(cases), "--out", str(tmp)],
            stdout=log, stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + SPAWN_TIMEOUT
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
        for log in logs:
            log.close()
    text = "\n".join((tmp / f"rank{r}.log").read_text() for r in range(world))
    assert all(p.returncode == 0 for p in procs), text[-6000:]
    res = dict(np.load(tmp / "result.npz"))
    nbytes = [json.loads((tmp / f"bytes-{r}.json").read_text())
              for r in range(world)]
    return {"result": res, "bytes": nbytes, "world": world}


@pytest.fixture(scope="module")
def spawned(reference, tmp_path_factory):
    """One spawn of a mesh's ranks over every case, run once for all the
    tests that read it."""
    @functools.lru_cache(maxsize=None)
    def get(mesh):
        return _spawn(mesh, reference[0],
                      tmp_path_factory.mktemp(f"dist-{mesh}"))
    return get


@pytest.fixture(scope="module", params=list(MESHES))
def run(request, spawned):
    return request.param, spawned(request.param)


def _close(got: dict, want: dict, tol: float, what: str, extra=0.0):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-30) + extra,
            err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", CASES)
def test_two_steps_match_the_single_device_reference(run, reference, case):
    mesh, out = run
    res, want = out["result"], reference[1][case]
    for s in range(2):
        np.testing.assert_allclose(res[f"{case}|loss{s}"], want["loss"][s],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(res[f"{case}|grad_norm{s}"],
                                   want["grad_norm"][s], rtol=NORM_RTOL)
        np.testing.assert_allclose(res[f"{case}|lr{s}"], want["lr"][s],
                                   rtol=1e-6)

    def leaves(name):
        return {k.split("|", 2)[2]: v for k, v in res.items()
                if k.startswith(f"{case}|{name}|")}
    arch = case.split("/")[0]
    _close(leaves("m1"), want["m1"], GRAD_TOL.get(arch, DEFAULT_GRAD_TOL),
           f"{mesh} {case} m after step 1")
    flip = FLIP_SHARE * sum(want["lr"])
    _close(leaves("master2"), want["master2"], MASTER_TOL,
           f"{mesh} {case} master after step 2", flip)
    _close(leaves("params2"), want["params2"], MASTER_TOL,
           f"{mesh} {case} params after step 2", flip)
    if MESHES[mesh][0] == (1, 1) and case.endswith("/mb1"):
        assert res[f"{case}|same_bits_as_train_step"] == 1.0


@pytest.mark.parametrize("mesh", SHARDED)
@pytest.mark.parametrize("case", [worker.case_key(*c) for c in MOE_CASES])
def test_the_moe_case_matches_the_sharded_reference(spawned, reference,
                                                    mesh, case):
    """The tp runs' moe case (global routing) against the reference's own
    sharded step on the same mesh, at the tolerances above: the port's
    global routing under data parallelism is the GSPMD program's."""
    res, want = spawned(mesh)["result"], reference[2][mesh][case]
    for s in range(2):
        np.testing.assert_allclose(res[f"{case}|loss{s}"], want["loss"][s],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(res[f"{case}|grad_norm{s}"],
                                   want["grad_norm"][s], rtol=NORM_RTOL)
        np.testing.assert_allclose(res[f"{case}|lr{s}"], want["lr"][s],
                                   rtol=1e-6)

    def leaves(name):
        return {k.split("|", 2)[2]: v for k, v in res.items()
                if k.startswith(f"{case}|{name}|")}
    flip = FLIP_SHARE * sum(want["lr"])
    _close(leaves("m1"), want["m1"], DEFAULT_GRAD_TOL,
           f"{mesh} {case} m after step 1 (sharded reference)")
    _close(leaves("master2"), want["master2"], MASTER_TOL,
           f"{mesh} {case} master after step 2 (sharded reference)", flip)
    _close(leaves("params2"), want["params2"], MASTER_TOL,
           f"{mesh} {case} params after step 2 (sharded reference)", flip)


def test_each_rank_holds_its_share_of_the_optimizer_state(run):
    """Counting bytes: each rank holds of m, v and master the share the
    reference's placements give (ZeRO-1 on the tp meshes: 1/data of every
    leaf with a dimension left to the data ranks; FSDP: 1/world, or
    1/model), and the ranks' shares add up to the whole."""
    from jax.sharding import AbstractMesh
    from repro.distributed import sharding as ref_shd
    mesh, out = run
    (n_data, n_model), mode, _ = MESHES[mesh]
    sizes = {"data": n_data, "model": n_model}
    divided = 0
    for arch, mb in worker.CASES:
        case = worker.case_key(arch, mb)
        cfg = worker.config(arch, ref_config)
        lm = RefLM(cfg, max_seq=worker.SEQ)
        ctx = RefContext.create(cfg, AbstractMesh((n_data, n_model),
                                                  ("data", "model")),
                                mode=mode)
        opt = ref_shd.opt_shardings(ctx, lm.axes(), lm.abstract())
        shapes = {jax.tree_util.keystr(p): a.shape for p, a in
                  jax.tree_util.tree_flatten_with_path(lm.abstract())[0]}
        for name in ("m", "v", "master"):
            total, whole, kept = 0, 0, 0
            for p, sh in jax.tree_util.tree_flatten_with_path(
                    getattr(opt, name))[0]:
                path = jax.tree_util.keystr(p)
                k = int(np.prod([sizes[a] for e in sh.spec if e
                                 for a in ((e,) if isinstance(e, str)
                                           else e)]))
                numel = int(np.prod(shapes[path]))
                divided += k > 1
                whole += numel * 4
                kept += numel * 4 if k == 1 else 0
                for r in range(out["world"]):
                    local, full = out["bytes"][r][case][name][path]
                    assert full == numel and local * k == numel, \
                        (mesh, case, name, path, local, numel, k)
                    total += local * 4
            assert total == whole + kept * (out["world"] - 1)
    assert divided or out["world"] == 1


# ----------------------------------------------------------------------
# in the test process: no ranks
# ----------------------------------------------------------------------

# one config of each family whose layers have no tensor-parallel compute
NOT_TP = ("mamba2-370m", "recurrentgemma-9b", "qwen2-moe-a2.7b",
          "whisper-tiny")


@pytest.mark.parametrize("arch", NOT_TP)
def test_tp_mode_with_a_model_axis_raises_not_implemented(arch):
    """The ssm, hybrid, moe and encdec families have no tensor-parallel
    compute over ``model`` yet: ``build_train_step`` in tp with a
    ``model`` axis above one rank raises, naming ROADMAP A10b-4b (the
    dense and vlm families run there: ``tests/test_torch_tp.py``)."""
    cfg = get_config(arch, reduced=True)
    lm = LM(cfg, max_seq=32, device="cpu")
    shape = ShapeConfig("t", "train", 32, 8)
    for axes in ({"data": 2, "model": 2}, {"data": 1, "model": 4},
                 {"pod": 2, "data": 2, "model": 2}):
        ctx = DistContext.create(cfg, axes, mode="tp")
        with pytest.raises(NotImplementedError, match="A10b-4b"):
            build_train_step(lm, TrainConfig(), ctx, shape)


def test_vocab_parallel_raises_not_implemented():
    """(Named from when the port refused the flag.)  The reference's
    ``DistContext`` takes ``vocab_parallel`` and never reads it; the
    port's takes it too, from ``create`` and from the constructor, keeps
    it, and nothing changes: the loss and every gradient are the same
    bits with it and without it, and the reference's loss with it is the
    reference's loss without it."""
    cfg, rcfg = get_config("yi-6b", reduced=True), ref_config(
        "yi-6b", reduced=True)
    axes = {"data": 1, "model": 1}
    lm = LM(cfg, max_seq=16, device="cpu")
    lm.init(0, torch.float32)
    batch = TokenPipeline(cfg, ShapeConfig("t", "train", 16, 2),
                          seed=1).train_batch(0)
    base = DistContext.create(cfg, axes)
    leaves = dict(tree_flatten_with_path(lm.params))
    got = []
    for ctx in (base, DistContext.create(cfg, axes, vocab_parallel=True),
                DistContext(base.mesh, base.rules, vocab_parallel=True)):
        assert ctx.vocab_parallel == (ctx is not base)
        for t in leaves.values():
            t.grad = None
            t.requires_grad_(True)
        loss, _ = lm.loss(lm.params, batch, ctx)
        loss.backward()
        got.append((loss.detach(), {k: t.grad.clone()
                                    for k, t in leaves.items()}))
    for loss, grads in got[1:]:
        assert torch.equal(loss, got[0][0])
        assert all(torch.equal(g, got[0][1][k]) for k, g in grads.items())
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rlm = RefLM(rcfg, max_seq=16)
    params = rlm.init(jax.random.PRNGKey(0), jnp.float32)
    with mesh:
        ref = [float(rlm.loss(params, batch, RefContext.create(
            rcfg, mesh, vocab_parallel=vp))[0]) for vp in (False, True)]
    assert ref[0] == ref[1]


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_shardmap_loss_on_one_rank_equals_the_gspmd_loss(arch):
    """``extra["moe_impl"] = "shardmap"`` on a 1 x 1 mesh (EP, every expert
    on the one rank) where the two capacities agree: ``lm.loss`` gives the
    global routing's cross entropy bits and its loss within rtol 1e-6 (the
    aux loss sums in another order), and the gradients within 1e-6 of each
    leaf's max-abs."""
    cfg = get_config(arch, reduced=True)
    lm = LM(cfg, max_seq=16, device="cpu")
    lm.init(0, torch.float32)
    batch = TokenPipeline(cfg, ShapeConfig("t", "train", 16, 2),
                          seed=1).train_batch(0)
    assert moe.shardmap_capacity(32, cfg) == moe._capacity(32, cfg)
    leaves = dict(tree_flatten_with_path(lm.params))
    got = {}
    for impl in ("gspmd", "shardmap"):
        ctx = DistContext.create(cfg, {"data": 1, "model": 1})
        ctx.extra["moe_impl"] = impl
        for t in leaves.values():
            t.grad = None
            t.requires_grad_(True)
        loss, metrics = lm.loss(lm.params, batch, ctx)
        loss.backward()
        got[impl] = (loss.detach(), metrics["ce"].detach(),
                     {k: t.grad.clone() for k, t in leaves.items()})
    (loss, ce, g), (want_loss, want_ce, want_g) = got["shardmap"], got["gspmd"]
    assert torch.isfinite(loss)
    assert torch.equal(ce, want_ce)
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)
    for k, w in want_g.items():
        torch.testing.assert_close(g[k], w, rtol=0,
                                   atol=1e-6 * float(w.abs().max()) + 1e-30)


FAMILIES = ["yi-6b", "mamba2-370m", "recurrentgemma-9b", "qwen2-moe-a2.7b",
            "internvl2-2b", "whisper-tiny"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_changes_no_value(arch):
    """``LM.loss`` under remat none, dots and full on one CPU rank: the
    same loss and the same gradient bits (the recomputed forward repeats
    the same ops)."""
    cfg = get_config(arch, reduced=True)
    lm = LM(cfg, max_seq=48, device="cpu")
    lm.init(0, torch.float32)
    batch = TokenPipeline(cfg, ShapeConfig("t", "train", 48, 2),
                          seed=1).train_batch(0)
    leaves = dict(tree_flatten_with_path(lm.params))
    got = {}
    for remat in ("none", "dots", "full"):
        for t in leaves.values():
            t.grad = None
            t.requires_grad_(True)
        loss, _ = lm.loss(lm.params, batch, remat=remat)
        loss.backward()
        got[remat] = (loss.detach(), {k: t.grad.clone()
                                      for k, t in leaves.items()
                                      if t.grad is not None})
    want_loss, want_g = got["none"]
    assert len(want_g) > 0
    for remat in ("dots", "full"):
        loss, g = got[remat]
        assert torch.equal(loss, want_loss), remat
        assert sorted(g) == sorted(want_g)
        for k in want_g:
            assert torch.equal(g[k], want_g[k]), (remat, k)


def test_remat_names_and_prefill_are_checked():
    cfg = get_config("yi-6b", reduced=True)
    lm = LM(cfg, max_seq=16, device="cpu")
    lm.init(0, torch.float32)
    batch = TokenPipeline(cfg, ShapeConfig("t", "train", 16, 1),
                          seed=1).train_batch(0)
    with pytest.raises(ValueError, match="remat"):
        lm.loss(lm.params, batch, remat="some")
    from repro_torch.models import transformer
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="prefill"):
        transformer.decoder_forward(lm.params["decoder"], x, cfg,
                                    torch.zeros((1, 4), dtype=torch.long),
                                    lm.init_cache(1, 4), remat="full")


def test_the_moe_case_drops_tokens_by_global_routing():
    """The moe case's first batch: routing the global 8 x 32 tokens and
    routing each of 2 (or 4) ranks' rows drop different numbers of tokens
    in layer 0's router, and the mean of the ranks' local gradients of the
    experts' weights misses the global gradient by far more than the
    gradient tolerance: a step that routed locally would fail the gloo
    tests."""
    arch = "qwen2-moe-a2.7b"
    cfg = worker.config(arch, get_config)
    lm = LM(cfg, max_seq=worker.SEQ, device="cpu")
    rlm = RefLM(worker.config(arch, ref_config), max_seq=worker.SEQ)
    lm.load_reference(jax.tree_util.tree_map(
        np.asarray, rlm.init(jax.random.PRNGKey(0), jnp.float32)))
    batch = _batches(arch)[0]
    w = lm.params["decoder"]["stack"]["ffn"]["w_gate"].requires_grad_(True)
    dropped = []
    real = moe._routed

    def counting(p, xt, c):
        logits = (xt @ p["router"]).float()
        _, idx = moe.top_k(torch.softmax(logits, -1), c.experts_per_tok)
        load = torch.bincount(idx.reshape(-1), minlength=c.num_experts)
        dropped.append(int((load - moe._capacity(xt.shape[0], c))
                           .clamp(min=0).sum()))
        return real(p, xt, c)

    def grad(rows):
        w.grad = None
        lm.loss(lm.params, rows)[0].backward()
        return w.grad.clone()

    moe._routed = counting
    try:
        whole = grad(batch)
        n_layers = len(dropped)
        scale = float(whole.abs().max())
        for ranks in (2, 4):
            rows = worker.BATCH // ranks
            local = sum(grad({k: v[r * rows:(r + 1) * rows]
                              for k, v in batch.items()})
                        for r in range(ranks)) / ranks
            err = float((local - whole).abs().max())
            assert err > 10 * DEFAULT_GRAD_TOL * scale, (ranks, err, scale)
            first = dropped[n_layers::n_layers][-ranks:]
            assert dropped[0] > 0 and sum(first) != dropped[0], dropped
    finally:
        moe._routed = real
