"""The port's serve steps (``repro_torch.distributed.steps``
``build_prefill_step``, ``build_decode_step``, ``cache_specs``) and its
sequence-parallel decode attention (``distributed/decode_attn.py``
``sp_decode_attention``) on gloo ranks on the CPU, against the reference.

The reference's own steps run on a 1 x 1 ``Auto`` mesh of its one CPU
device (``fsdp``, ``sp_decode=False``; the sharded reference fails under
the installed jax, ROADMAP queue C): for the reduced dense, ssm, hybrid,
moe, vlm and encdec configs in f32, with weights drawn by the port's
``LM.init`` (seed 0) and carried across, a prefill of a 48-position prompt
(batch 4, a cache of 52 slots), then 4 greedy decode steps on its own ids.
The parent writes the weights, prompts and the attention's inputs into an
``.npz``; one spawn a mesh starts ``tests/_torch_serve_worker.py`` once a
rank (torch and the port only, a ``FileStore`` rendezvous in the test's
own directory, every process bounded by its own timeout):

- (2, 1) and (4, 1) in ``tp`` with ``sp_decode`` (its attention over a
  ``model`` group of one rank), (2, 2) and (1, 1) in ``fsdp`` without:
  logits after prefill and after each decode step, and the caches after
  prefill and after the last step, within ``tests/test_torch_model.py``'s
  f32 tolerances (1e-4, mamba2 1e-3), greedy ids equal; on (1, 1) the
  same bits as ``LM.prefill``/``LM.decode_step``;
- ``sp_decode_attention`` with a ``model`` axis of 2 and of 4 ((1, 2),
  (1, 4) and (2, 2) in ``tp``) on the reference test's inputs
  (``tests/test_sharding_subprocess.py:58-82``), with every row at slot 0
  and with rows on the slices' boundaries: output within 1e-5 of the
  reference's ``cache_write_plain`` + ``decode_attention_plain``, the
  caches bit-equal.

The two raises (``tp`` with a ``model`` axis above 1; ``fsdp`` with
``sp_decode`` on a full-attention config, where the reference's decode
step raises ``DuplicateSpecError``) run in the test process.
"""
import functools
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

import _torch_serve_worker as worker  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import ShapeConfig as RefShapeConfig  # noqa: E402
from repro.distributed.context import DistContext as RefContext  # noqa: E402
from repro.distributed.steps import build_decode_step as ref_decode  # noqa: E402
from repro.distributed.steps import build_prefill_step as ref_prefill  # noqa: E402
from repro.distributed.steps import cache_specs as ref_cache_specs  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.models.attention import cache_write_plain, decode_attention_plain  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import _ARCH_MODULES  # noqa: E402
from repro_torch.core.reducer import tree_map_with_path  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    DistContext, build_decode_step, build_prefill_step, cache_specs,
)
from repro_torch.models import LM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_serve_worker.py"
# spawn name -> (data, model), the worker's jobs
SPAWNS = {"2x1": ((2, 1), "steps:tp"), "4x1": ((4, 1), "steps:tp"),
          "2x2": ((2, 2), "steps:fsdp,sp"), "1x1": ((1, 1), "steps:fsdp"),
          "1x2": ((1, 2), "sp"), "1x4": ((1, 4), "sp")}
STEP_MESHES = {"2x1": "tp", "4x1": "tp", "2x2": "fsdp", "1x1": "fsdp"}
SP_MESHES = ("1x2", "1x4", "2x2")
TOL = {"mamba2-370m": 1e-3}
DEFAULT_TOL = 1e-4
SP_TOL = 1e-5
SPAWN_TIMEOUT = 300
PIPE_SEED = 3


def _np(tree) -> dict:
    return {jax.tree_util.keystr(p): np.array(x, np.float32) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's prefill and decode steps for every family, and the
    ``.npz`` of the weights, prompts and attention inputs the workers
    read."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    inputs, want = {}, {}
    for arch in worker.FAMILIES:
        cfg = ref_config(arch, reduced=True)
        lm = RefLM(cfg, max_seq=worker.CACHE)
        ctx = RefContext.create(cfg, mesh, mode="fsdp", sp_decode=False)
        # the port's init (the reference's rules, from a torch generator):
        # the reference's own jitted init takes seconds a config
        weights = LM(get_config(arch, reduced=True), max_seq=worker.CACHE,
                     device="cpu").init(0, torch.float32)
        params = tree_map_with_path(lambda _, t: jnp.asarray(t.numpy()),
                                    weights)
        for p, x in _np(params).items():
            inputs[f"{arch}|params|{p}"] = x
        batch = TokenPipeline(get_config(arch, reduced=True), ShapeConfig(
            "p", "prefill", worker.PROMPT, worker.BATCH),
            seed=PIPE_SEED).prefill_batch(0)
        for k, v in batch.items():
            inputs[f"{arch}|batch|{k}"] = v
        got = {"logits": [], "ids": []}
        with mesh:
            pf, _ = ref_prefill(lm, ctx, RefShapeConfig(
                "p", "prefill", worker.PROMPT, worker.BATCH),
                cache_len=worker.CACHE)
            df, _ = ref_decode(lm, ctx, RefShapeConfig(
                "d", "decode", worker.CACHE, worker.BATCH))
            logits, cache = pf(params, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
            got["cache0"] = _np(cache)
            got["logits"].append(np.array(logits, np.float32))
            for _ in range(worker.STEPS):
                tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
                got["ids"].append(np.array(tok[:, 0]))
                logits, cache = df(params, cache, {"token": tok})
                got["logits"].append(np.array(logits, np.float32))
        got["cache1"] = _np(cache)
        want[arch] = got
    rng = np.random.default_rng(0)
    shapes = {"q": (worker.SP_B, 1, worker.SP_H, worker.SP_HD),
              "k": (worker.SP_B, worker.SP_KV, worker.SP_S, worker.SP_HD),
              "v": (worker.SP_B, worker.SP_KV, worker.SP_S, worker.SP_HD),
              "nk": (worker.SP_B, 1, worker.SP_KV, worker.SP_HD),
              "nv": (worker.SP_B, 1, worker.SP_KV, worker.SP_HD)}
    sp = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    for k, v in sp.items():
        inputs[f"sp|{k}"] = v
    for case, pos in worker.sp_positions().items():
        pos = jnp.array(pos, jnp.int32)
        k, v = cache_write_plain(jnp.asarray(sp["k"]), jnp.asarray(sp["v"]),
                                 jnp.asarray(sp["nk"]), jnp.asarray(sp["nv"]),
                                 pos)
        o = decode_attention_plain(jnp.asarray(sp["q"]), k, v, pos)
        want[f"sp|{case}"] = {"out": np.array(o), "k": np.array(k),
                              "v": np.array(v)}
    path = tmp_path_factory.mktemp("serve-cases") / "cases.npz"
    np.savez(path, **inputs)
    return path, want


def _spawn(name: str, cases: Path, tmp: Path) -> dict:
    (n_data, n_model), jobs = SPAWNS[name]
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
             f"{n_data},{n_model}", "--jobs", jobs, "--cases", str(cases),
             "--out", str(tmp)],
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
    out = {"world": world}
    if "steps" in jobs:
        out["steps"] = dict(np.load(tmp / "steps.npz"))
    if "sp" in jobs.split(","):
        out["sp"] = [dict(np.load(tmp / f"sp-{r}.npz")) for r in range(world)]
    return out


@pytest.fixture(scope="module")
def spawned(reference, tmp_path_factory):
    """One spawn a mesh, run once for all the tests that read it."""
    @functools.lru_cache(maxsize=None)
    def get(name):
        return _spawn(name, reference[0],
                      tmp_path_factory.mktemp(f"serve-{name}"))
    return get


def _close(got, want, tol, what):
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in STEP_MESHES
                                       for a in worker.FAMILIES])
def test_serve_steps_match_the_reference(spawned, reference, mesh, arch):
    res, want = spawned(mesh)["steps"], reference[1][arch]
    key = f"{STEP_MESHES[mesh]}|{arch}"
    tol = TOL.get(arch, DEFAULT_TOL)
    np.testing.assert_array_equal(res[f"{key}|ids"],
                                  np.stack(want["ids"], axis=1))
    _close(res[f"{key}|logits"], np.stack(want["logits"]), tol,
           f"{mesh} {arch} logits")
    for c in ("cache0", "cache1"):
        mine = {k.split("|", 3)[3]: v for k, v in res.items()
                if k.startswith(f"{key}|{c}|")}
        assert sorted(mine) == sorted(want[c]), (mesh, arch, c)
        for p, w in want[c].items():
            if p == "['pos']":
                np.testing.assert_array_equal(mine[p], w)
            else:
                _close(mine[p], w, tol, f"{mesh} {arch} {c} {p}")
    assert int(res[f"{key}|filled"]) == worker.CACHE
    if mesh == "1x1":
        assert bool(res[f"{key}|same_bits_as_lm"])


@pytest.mark.parametrize("mesh,case", [(m, c) for m in SP_MESHES
                                       for c in worker.sp_positions()])
def test_sp_decode_attention_matches_plain(spawned, reference, mesh, case):
    """Each rank's output is its rows' output (the same on every ``model``
    rank), and its caches its rows and slots of the plain write's."""
    ranks = spawned(mesh)["sp"]
    want = reference[1][f"sp|{case}"]
    (n_data, n_model), _ = SPAWNS[mesh]
    rows, slots = worker.SP_B // n_data, worker.SP_S // n_model
    covered = np.zeros((worker.SP_B, worker.SP_S), bool)
    for r in ranks:
        i, j = (int(x) for x in r["coord"])
        rs = slice(i * rows, (i + 1) * rows)
        ss = slice(j * slots, (j + 1) * slots)
        np.testing.assert_allclose(r[f"{case}|out"], want["out"][rs],
                                   atol=SP_TOL, rtol=SP_TOL,
                                   err_msg=f"{mesh} {case} rank {i},{j}")
        for c in ("k", "v"):
            np.testing.assert_array_equal(r[f"{case}|{c}"],
                                          want[c][rs, :, ss])
        covered[rs, ss] = True
    assert covered.all()


def test_sp_decode_attention_on_one_rank_is_the_plain_decode():
    """Without a ``model`` group (one rank), the write and the attention on
    a bf16 cache: the written cache the plain write's bits, the output
    within a bf16 ulp of the plain decode attention's."""
    from repro_torch.distributed import sp_decode_attention
    from repro_torch.models.attention import (
        cache_write_plain as port_write, decode_attention_plain as port_attn,
    )
    cfg = get_config("yi-6b", reduced=True)
    ctx = DistContext.create(cfg, {"data": 1, "model": 1})
    g = torch.Generator().manual_seed(0)

    def rand(*s):
        return torch.randn(s, generator=g).to(torch.bfloat16)
    q, k, v = rand(4, 1, 8, 32), rand(4, 2, 40, 32), rand(4, 2, 40, 32)
    nk, nv = rand(4, 1, 2, 32), rand(4, 1, 2, 32)
    pos = torch.tensor([0, 7, 38, 39], dtype=torch.int32)
    k1, v1 = port_write(k.clone(), v.clone(), nk, nv, pos)
    want = port_attn(q, k1, v1, pos)
    o, k2, v2 = sp_decode_attention(ctx, q, k.clone(), v.clone(), nk, nv,
                                    pos)
    assert torch.equal(k2, k1) and torch.equal(v2, v1)
    torch.testing.assert_close(o.float(), want.float(), atol=8e-3, rtol=8e-3)


@pytest.mark.parametrize("arch", sorted(_ARCH_MODULES))
def test_cache_specs_match_the_reference(arch):
    """Shapes and dtypes leaf for leaf, every config at full size, bf16 and
    f32, from the ``meta`` device."""
    rlm, lm = RefLM(ref_config(arch)), LM(get_config(arch), device="cpu")
    for B, S in ((1, 4096), (128, 32768)):
        for rdt, dt in ((jnp.bfloat16, torch.bfloat16),
                        (jnp.float32, torch.float32)):
            want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
                    for p, x in jax.tree_util.tree_flatten_with_path(
                        ref_cache_specs(rlm, B, S, rdt))[0]}
            got = {p: (tuple(s.shape), str(s.dtype).replace("torch.", ""))
                   for p, s in worker._flat(cache_specs(lm, B, S,
                                                        dt)).items()}
            assert got == want, (arch, B, S, dt)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b",
                                  "qwen2-moe-a2.7b", "whisper-tiny"])
def test_tp_with_a_model_axis_raises_not_implemented(arch):
    """The serve steps of the ssm, hybrid, moe and encdec families in tp
    with a ``model`` axis above one rank raise, naming ROADMAP A10b-4b
    (the dense and vlm families serve there: ``tests/test_torch_tp.py``)."""
    cfg = get_config(arch, reduced=True)
    lm = LM(cfg, max_seq=32, device="cpu")
    for axes in ({"data": 2, "model": 2}, {"data": 1, "model": 4},
                 {"pod": 2, "data": 2, "model": 2}):
        ctx = DistContext.create(cfg, axes, mode="tp")
        with pytest.raises(NotImplementedError, match="A10b-4b"):
            build_prefill_step(lm, ctx, ShapeConfig("p", "prefill", 32, 8))
        with pytest.raises(NotImplementedError, match="A10b-4b"):
            build_decode_step(lm, ctx, ShapeConfig("d", "decode", 32, 8))


@pytest.mark.parametrize("arch", worker.FAMILIES)
def test_fsdp_with_sp_decode_raises_where_the_reference_fails(arch):
    """fsdp's batch rule already splits the rows over ``model``, so a decode
    that splits the cache's slots over it too names ``model`` twice: the
    reference's ``build_decode_step`` raises ``DuplicateSpecError`` when it
    runs, the port's ``build_decode_step`` ``ValueError`` before any work.
    Configs with no full attention cache (mamba2, recurrentgemma) build and
    run in both; without ``sp_decode`` every config builds."""
    from jax._src.named_sharding import DuplicateSpecError
    cfg, rcfg = get_config(arch, reduced=True), ref_config(arch, reduced=True)
    lm, rlm = LM(cfg, max_seq=8, device="cpu"), RefLM(rcfg, max_seq=8)
    shape = ShapeConfig("d", "decode", 8, 2)
    axes = {"data": 1, "model": 1}
    full_attn = arch not in ("mamba2-370m", "recurrentgemma-9b")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rctx = RefContext.create(rcfg, mesh, mode="fsdp", sp_decode=True)
    params = tree_map_with_path(lambda _, t: jnp.asarray(t.numpy()),
                                lm.init(0, torch.float32))
    with mesh:
        df, (_, acache, _) = ref_decode(rlm, rctx, RefShapeConfig(
            "d", "decode", 8, 2))
        cache = jax.tree_util.tree_map(
            lambda a: jnp.zeros(a.shape, jnp.float32 if a.dtype ==
                                jnp.bfloat16 else a.dtype), acache)
        tok = {"token": jnp.zeros((2, 1), jnp.int32)}
        if full_attn:
            with pytest.raises(DuplicateSpecError):
                df(params, cache, tok)
        else:
            df(params, cache, tok)
    ctx = DistContext.create(cfg, axes, mode="fsdp", sp_decode=True)
    if full_attn:
        with pytest.raises(ValueError, match="sp_decode=False"):
            build_decode_step(lm, ctx, shape)
    else:
        build_decode_step(lm, ctx, shape)
    build_decode_step(lm, DistContext.create(cfg, axes, mode="fsdp",
                                             sp_decode=False), shape)
