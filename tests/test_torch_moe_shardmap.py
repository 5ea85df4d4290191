"""The port's local-routing moe layer (``repro_torch.models.moe``
``moe_ffn_shardmap``, ``ctx.extra["moe_impl"] = "shardmap"``) on gloo
ranks on the CPU, against the reference's own sharded runs.

The reference runs in a process of its own with 8 host devices
(``tests/_jax_sharded_ref.py``, ``XLA_FLAGS=--xla_force_host_platform_
device_count=8``, meshes with ``Auto`` axis types); the test process keeps
its one device.  The parent draws the inputs with numpy (seed 0) and the
steps' weights with the port's ``LM.init`` (seed 0), writes them into an
``.npz``, and starts the reference's process and one spawn a mesh of
``tests/_torch_moe_worker.py`` (torch and the port only, a ``FileStore``
rendezvous in the test's own directory) together, every process bounded
by its own timeout:

- the layer driven directly, f32, at capacity factors 0.5 (drops) and 16
  (none): EP (reduced qwen3-moe, 8 experts) at (2,2), (1,4) and (4,1),
  where the ff dim is sharded over ``data``; expert-TP (reduced qwen2-moe
  with its shared expert, 6 experts at (1,4), 5 at (2,2)).  Output and aux
  within 1e-5 of their max-abs, every gradient of ``sum(out * c) / T +
  aux`` (averaged over the batch group, as the train step reduces it)
  within 1e-4 of its leaf's max-abs, on every rank; at factor 16 the
  output also within 1e-4 of the dense ``moe_ffn`` (the reference test's
  own limit, ``tests/test_sharding_subprocess.py:92``);
- the tp steps at (2,1) and (4,1) with the moe case of
  ``tests/_torch_dist_worker.py`` (reduced qwen2-moe at factor 0.5): two
  train steps against the reference's ``build_train_step`` at PERF.md
  section 2's distributed-step tolerances (those of
  ``tests/test_torch_distributed.py``), and a prefill and 4 decode steps
  against the reference's serve steps at ``tests/test_torch_serve_steps.py``'s
  f32 tolerances.  The global routing's loss from the same weights misses
  the local routing's by more than the loss tolerance.
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

import _torch_dist_worker as dist_worker  # noqa: E402
import _torch_moe_worker as worker  # noqa: E402
import _torch_serve_worker as serve_worker  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.distributed import DistContext  # noqa: E402
from repro_torch.models import LM, moe  # noqa: E402
from repro_torch.models.layers import init_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
# spawn name -> (data, model), the worker's jobs
SPAWNS = {"2x2": ((2, 2), "layer"), "1x4": ((1, 4), "layer"),
          "4x1": ((4, 1), "layer,steps"), "2x1": ((2, 1), "steps")}
STEP_SPAWNS = ("2x1", "4x1")
LAYER_TOL = 1e-5            # output, aux: of their max-abs
LAYER_GRAD_TOL = 1e-4       # each gradient leaf: of its max-abs
DENSE_TOL = 1e-4            # the reference test's own
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
NORM_RTOL = 1e-5
MASTER_TOL = 1e-6
FLIP_SHARE = 0.1            # of lr_1 + lr_2
SERVE_TOL = 1e-4
TIMEOUT = 300
PIPE_SEED = 3


def _layer_inputs(key: str, rng) -> dict:
    """Weights, x and the loss's weights c of one layer case (numpy)."""
    cfg = worker.layer_config(key, get_config)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.d_ff
    shapes = {"['router']": (d, E), "['w_gate']": (E, d, ff),
              "['w_up']": (E, d, ff), "['w_down']": (E, ff, d)}
    if cfg.shared_expert_d_ff:
        sf = cfg.shared_expert_d_ff
        shapes.update({"['shared']['w_gate']": (d, sf),
                       "['shared']['w_up']": (d, sf),
                       "['shared']['w_down']": (sf, d),
                       "['shared']['gate']": (d, 1)})
    out = {f"{key}|p|{k}": (rng.standard_normal(s) / np.sqrt(s[-2]))
           .astype(np.float32) for k, s in shapes.items()}
    for n in ("x", "c"):
        out[f"{key}|{n}"] = rng.standard_normal(
            (worker.LAYER_B, worker.LAYER_S, d)).astype(np.float32)
    return out


def _step_inputs() -> dict:
    cfg = dist_worker.config(worker.STEP_ARCH, get_config)
    out = {f"steps|params|{p}": t.numpy().copy() for p, t in
           serve_worker._flat(LM(cfg, max_seq=serve_worker.CACHE,
                                 device="cpu").init(0, torch.float32)).items()}
    pipe = TokenPipeline(cfg, ShapeConfig("t", "train", dist_worker.SEQ,
                                          dist_worker.BATCH), seed=PIPE_SEED)
    for s in range(2):
        out[f"steps|batch{s}|tokens"] = pipe.train_batch(s)["tokens"]
    out["steps|batch|tokens"] = TokenPipeline(cfg, ShapeConfig(
        "p", "prefill", serve_worker.PROMPT, serve_worker.BATCH),
        seed=PIPE_SEED).prefill_batch(0)["tokens"]
    return out


def _reference_jobs() -> list:
    jobs = [{"kind": "layer", "key": key, "arch": arch, "mesh": list(mesh),
             "replace": {"num_experts": E, "capacity_factor": cf},
             "moe_impl": "shardmap"}
            for key, (arch, E, mesh, cf) in worker.LAYER_CASES.items()]
    step = {"arch": worker.STEP_ARCH, "moe_impl": "shardmap",
            "replace": {"capacity_factor": dist_worker.MOE_CAPACITY_FACTOR}}
    for mesh, (mb, _) in worker.STEP_MESHES.items():
        name = worker.mesh_name(mesh)
        jobs.append({**step, "kind": "train", "key": f"{name}|train",
                     "mesh": list(mesh), "microbatches": mb,
                     "seq": dist_worker.SEQ, "batch": dist_worker.BATCH,
                     "train": dist_worker.TRAIN, "inputs": "steps"})
        jobs.append({**step, "kind": "serve", "key": f"{name}|serve",
                     "mesh": list(mesh), "cache": serve_worker.CACHE,
                     "steps": serve_worker.STEPS, "inputs": "steps"})
    return jobs


def _wait(procs, deadline) -> None:
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
    """The reference's sharded runs and every mesh's spawn, started
    together: {"ref": outputs, spawn name: {"layer": [each rank's],
    "steps": rank 0's}}."""
    tmp = tmp_path_factory.mktemp("moe-shardmap")
    rng = np.random.default_rng(0)
    inputs = {}
    for key in worker.LAYER_CASES:
        inputs.update(_layer_inputs(key, rng))
    inputs.update(_step_inputs())
    cases = tmp / "cases.npz"
    np.savez(cases, **inputs)
    (tmp / "jobs.json").write_text(json.dumps(_reference_jobs()))

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
    logs, procs, spawns = [], [], {}
    deadline = time.monotonic() + TIMEOUT
    try:
        log = open(tmp / "ref.log", "w")
        logs.append(log)
        ref = subprocess.Popen(
            [sys.executable, str(TESTS / "_jax_sharded_ref.py"), "--jobs",
             str(tmp / "jobs.json"), "--inputs", str(cases), "--out",
             str(tmp / "ref.npz")], stdout=log, stderr=subprocess.STDOUT,
            env=ref_env)
        procs.append(ref)
        for name, ((n_data, n_model), jobs_) in SPAWNS.items():
            d = tmp / name
            d.mkdir()
            world = n_data * n_model
            ranks = []
            for r in range(world):
                log = open(d / f"rank{r}.log", "w")
                logs.append(log)
                ranks.append(subprocess.Popen(
                    [sys.executable, str(TESTS / "_torch_moe_worker.py"),
                     "--rank", str(r), "--world", str(world), "--store",
                     str(d / "store"), "--mesh", f"{n_data},{n_model}",
                     "--jobs", jobs_, "--cases", str(cases), "--out",
                     str(d)], stdout=log, stderr=subprocess.STDOUT, env=env))
            spawns[name] = ranks
            procs.extend(ranks)
    finally:
        _wait(procs, deadline)
        for log in logs:
            log.close()
    assert ref.returncode == 0, (tmp / "ref.log").read_text()[-6000:]
    out = {"ref": dict(np.load(tmp / "ref.npz")), "inputs": inputs}
    for name, ranks in spawns.items():
        d = tmp / name
        text = "\n".join((d / f"rank{r}.log").read_text()
                         for r in range(len(ranks)))
        assert all(p.returncode == 0 for p in ranks), (name, text[-6000:])
        got = {}
        if "layer" in SPAWNS[name][1]:
            got["layer"] = [dict(np.load(d / f"layer-{r}.npz"))
                            for r in range(len(ranks))]
        if "steps" in SPAWNS[name][1]:
            got["steps"] = dict(np.load(d / "steps.npz"))
        out[name] = got
    return out


def _of_max(got, want, tol, what, extra=0.0):
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30) + extra,
        err_msg=what)


# ----------------------------------------------------------------------
# the layer
# ----------------------------------------------------------------------

def _port_drops(key: str, inputs: dict) -> int:
    """Slots past capacity in the port's local routing of each data
    shard's rows (``moe._route`` and ``shardmap_capacity``)."""
    cfg = worker.layer_config(key, get_config)
    n_data = worker.LAYER_CASES[key][2][0]
    x = torch.from_numpy(inputs[f"{key}|x"])
    router = torch.from_numpy(inputs[f"{key}|p|['router']"])
    dropped = 0
    for xs in x.chunk(n_data):
        xt = xs.reshape(-1, cfg.d_model)
        _, _, idx = moe._route(xt, router, cfg)
        load = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
        C = moe.shardmap_capacity(xt.shape[0], cfg)
        dropped += int((load - C).clamp(min=0).sum())
    return dropped


@pytest.mark.parametrize("key", list(worker.LAYER_CASES))
def test_layer_matches_the_reference_shardmap(runs, key):
    arch, E, mesh, cf = worker.LAYER_CASES[key]
    ranks = runs[worker.mesh_name(mesh)]["layer"]
    ref = runs["ref"]
    want_out = ref[f"{key}|out"]
    assert len(ranks) == mesh[0] * mesh[1]
    grads = [k.split("|", 2)[2] for k in ref if k.startswith(f"{key}|grad|")]
    assert grads and ("['shared']['gate']" in grads) == (
        arch == "qwen2-moe-a2.7b")
    rows = worker.LAYER_B // mesh[0]
    for r in ranks:
        i, j = (int(v) for v in r["coord"])
        what = f"{key} rank ({i},{j})"
        rs = slice(i * rows, (i + 1) * rows)
        _of_max(r[f"{key}|out"], want_out[rs], LAYER_TOL, f"{what} out")
        _of_max(r[f"{key}|aux"], ref[f"{key}|aux"], LAYER_TOL, f"{what} aux")
        _of_max(r[f"{key}|gx"], ref[f"{key}|gx"][rs], LAYER_GRAD_TOL,
                f"{what} gradient of x")
        for g in grads:
            _of_max(r[f"{key}|grad|{g}"], ref[f"{key}|grad|{g}"],
                    LAYER_GRAD_TOL, f"{what} gradient of {g}")
    drops = _port_drops(key, runs["inputs"])
    if cf < 1:
        assert drops > 0, key
        # local routing drops other slots than the dense layer's global one
        assert np.abs(want_out - ref[f"{key}|dense"]).max() > \
            LAYER_TOL * np.abs(want_out).max() or mesh[0] == 1, key
    else:
        assert drops == 0, key
        for r in ranks:
            i = int(r["coord"][0])
            np.testing.assert_allclose(
                r[f"{key}|out"], ref[f"{key}|dense"][i * rows:(i + 1) * rows],
                atol=DENSE_TOL, rtol=DENSE_TOL, err_msg=f"{key} dense")


# ----------------------------------------------------------------------
# the steps
# ----------------------------------------------------------------------

@pytest.mark.parametrize("spawn", STEP_SPAWNS)
def test_train_steps_match_the_reference_sharded_step(runs, spawn):
    res, ref = runs[spawn]["steps"], runs["ref"]
    key = f"{spawn}|train"
    for s in range(2):
        np.testing.assert_allclose(res[f"{key}|loss{s}"], ref[f"{key}|loss{s}"],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(res[f"{key}|grad_norm{s}"],
                                   ref[f"{key}|grad_norm{s}"], rtol=NORM_RTOL)
        np.testing.assert_allclose(res[f"{key}|lr{s}"], ref[f"{key}|lr{s}"],
                                   rtol=1e-6)
    flip = FLIP_SHARE * float(ref[f"{key}|lr0"] + ref[f"{key}|lr1"])
    for tag, tol, extra in (("m1", GRAD_TOL, 0.0), ("master2", MASTER_TOL, flip),
                            ("params2", MASTER_TOL, flip)):
        want = {k.split("|", 3)[3]: v for k, v in ref.items()
                if k.startswith(f"{key}|{tag}|")}
        got = {k.split("|", 3)[3]: v for k, v in res.items()
               if k.startswith(f"{key}|{tag}|")}
        assert sorted(got) == sorted(want) and want, (spawn, tag)
        for p, w in want.items():
            _of_max(got[p], w, tol, f"{spawn} {tag} {p}", extra)


@pytest.mark.parametrize("spawn", STEP_SPAWNS)
def test_local_routing_changes_the_loss(runs, spawn):
    """The same weights and batch under the global routing (``gspmd``)
    give a first loss further from the local routing's than the loss
    tolerance: the steps above really route each rank's rows."""
    res = runs[spawn]["steps"]
    local, glob = float(res[f"{spawn}|train|loss0"]), \
        float(res[f"{spawn}|gspmd|loss0"])
    assert abs(local - glob) > LOSS_TOL * (1 + abs(glob)), (local, glob)


@pytest.mark.parametrize("spawn", STEP_SPAWNS)
def test_serve_steps_match_the_reference_serve_steps(runs, spawn):
    res, ref = runs[spawn]["steps"], runs["ref"]
    key = f"{spawn}|serve"
    np.testing.assert_array_equal(res[f"{key}|ids"], ref[f"{key}|ids"])
    np.testing.assert_allclose(res[f"{key}|logits"], ref[f"{key}|logits"],
                               atol=SERVE_TOL, rtol=SERVE_TOL)
    assert int(res[f"{key}|filled"]) == serve_worker.CACHE
    for c in ("cache0", "cache1"):
        want = {k.split("|", 3)[3]: v for k, v in ref.items()
                if k.startswith(f"{key}|{c}|")}
        got = {k.split("|", 3)[3]: v for k, v in res.items()
               if k.startswith(f"{key}|{c}|")}
        assert sorted(got) == sorted(want) and want, (spawn, c)
        for p, w in want.items():
            if p == "['pos']":
                np.testing.assert_array_equal(got[p], w)
            else:
                np.testing.assert_allclose(got[p], w, atol=SERVE_TOL,
                                           rtol=SERVE_TOL,
                                           err_msg=f"{spawn} {c} {p}")


# ----------------------------------------------------------------------
# in the test process: one rank
# ----------------------------------------------------------------------

def _one_rank_ctx(cfg, mode="tp"):
    ctx = DistContext.create(cfg, {"data": 1, "model": 1}, mode=mode)
    ctx.extra["moe_impl"] = "shardmap"
    return ctx


def test_shardmap_capacity_is_the_reference_formula():
    """The local routing's capacity is the reference's ceiling
    (``moe.py:82``), not ``_capacity``'s truncation: at tokens K cf / E =
    24.5 they give 32 and 24; where the quotient is whole, or truncates to
    no multiple of 8, they agree."""
    import dataclasses
    cfg = get_config("qwen3-moe-235b-a22b", reduced=True)
    for T in range(1, 400):
        for cf in (0.5, 1.0, 1.25, 2.0, 16.0):
            c = dataclasses.replace(cfg, capacity_factor=cf)
            want = max(8, int(np.ceil(T * c.experts_per_tok * cf
                                      / c.num_experts / 8)) * 8)
            assert moe.shardmap_capacity(T, c) == want, (T, cf)
    c = dataclasses.replace(cfg, capacity_factor=0.5)
    assert (196 * 2 * 0.5 / 8) == 24.5
    assert moe.shardmap_capacity(196, c) == 32 and moe._capacity(196, c) == 24
    # the smoke's qwen2-moe-a2.7b leg: prefill 4 x 2048, decode 4 x 1
    full = get_config("qwen2-moe-a2.7b")
    for T, C in ((4 * 2048, 688), (4, 8)):
        assert moe.shardmap_capacity(T, full) == moe._capacity(T, full) == C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "qwen2-moe-a2.7b"])
def test_one_rank_gives_the_global_routings_bits(arch, dtype):
    """On a 1 x 1 mesh (EP, E/m = E) where the two capacities agree, the
    local routing is the global routing op for op: the same output and aux
    bits, f32 and bf16 (the smoke's card leg rests on this)."""
    cfg = get_config(arch, reduced=True)
    g = torch.Generator().manual_seed(0)
    p = init_params(moe.moe_spec(cfg), g, dtype, torch.device("cpu"))
    x = torch.randn((2, 24, cfg.d_model), generator=g).to(dtype)
    assert moe.shardmap_capacity(48, cfg) == moe._capacity(48, cfg)
    want = moe.moe_ffn(p, x, cfg)
    got = moe.moe_ffn(p, x, cfg, _one_rank_ctx(cfg))
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
