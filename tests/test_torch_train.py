"""The port's training path (``LM.loss``, ``softmax_xent``,
``repro_torch.optim`` and ``repro_torch.launch.train``) against the JAX
reference's, on the CPU.

Every input comes from a numpy seed, or from the reference's own ``lm.init``
weights carried across with ``LM.load_reference``.  On the CPU every kernel
takes its plain PyTorch version, which autograd differentiates (the SSD and
RG-LRU scans through their ``autograd.Function``s, whose backward on the CPU
is the plain backward formulas); the card's backward kernels are held
against the same plain formulas by chip_smoke.py.
Tolerances (stated per test):
- loss 1e-5 and every gradient leaf within 1e-4 of the leaf's max-abs in
  f32 (1e-3 for mamba2, whose SSD sums run in another order, as in
  serving);
- the optimizer, fed the reference's own gradients: rtol 1e-6, and for
  the state within 1e-6 of each leaf's max-abs (the schedules'
  transcendental functions and the clip's sums may differ in the last f32
  ulp), bf16 parameters equal wherever the f32 masters are;
- the CLI runs in bf16 from the same weights: per-step losses within 2e-2
  (bf16 rounds at other places in the two packages; AdamW's first step
  moves each weight by about lr whatever the gradient's size, so the
  differences stay at the bf16 level).
"""
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as RefCheckpointer  # noqa: E402
from repro.configs import TrainConfig as RefTrainConfig  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.models import griffin as ref_griffin  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.optim import adamw_update as ref_adamw  # noqa: E402
from repro.optim import global_norm as ref_norm  # noqa: E402
from repro.optim import init_opt_state as ref_init_opt  # noqa: E402
from repro.optim import make_schedule as ref_schedule  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.reducer import (  # noqa: E402
    tree_flatten_with_path, tree_map_with_path,
)
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.kernels.rg_lru.ops import rglru_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import griffin, ssm  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_reference, tensor_from_numpy,
)
from repro_torch.models.layers import softmax_xent  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    OptState, adamw_update, global_norm, init_opt_state, make_schedule,
)

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5
GRAD_TOL = {"mamba2-370m": 1e-3}          # relative to each leaf's max-abs
DEFAULT_GRAD_TOL = 1e-4
CLI_LOSS_TOL = 2e-2


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _leaves(tree):
    return dict(tree_flatten_with_path(tree))


def _ref_leaves(tree):
    return {jax.tree_util.keystr(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ----------------------------------------------------------------------
# softmax_xent
# ----------------------------------------------------------------------

def test_softmax_xent_and_its_gradient_match_the_reference():
    """Padded vocab (503 -> 512 columns), labels at 0 and at vocab_size - 1;
    the padded columns get exactly 0 gradient.  f32, rtol 1e-6."""
    V, Vp = 503, 512
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, Vp)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (2, 7)).astype(np.int32)
    labels[0, 0], labels[1, -1] = 0, V - 1
    want, want_g = jax.value_and_grad(ref_layers.softmax_xent)(
        jnp.asarray(logits), jnp.asarray(labels), V)
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = softmax_xent(lt, torch.from_numpy(labels), V)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(_np(lt.grad), np.asarray(want_g), rtol=1e-6,
                               atol=1e-9)
    assert not lt.grad[..., V:].any()
    # bf16 logits are widened to f32 first, as the reference does
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    want_b = ref_layers.softmax_xent(jnp.asarray(logits).astype(jnp.bfloat16),
                                     jnp.asarray(labels), V)
    np.testing.assert_allclose(float(softmax_xent(lb, torch.from_numpy(labels),
                                                  V)), float(want_b),
                               rtol=1e-6)


# ----------------------------------------------------------------------
# the scans' gradients (the Functions' plain backward on the CPU)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(64, 32), (48, 32), (32, 32)])
def test_ssd_scan_gradients_match_jax_grad_of_ssd_chunked(S, chunk):
    """The port's SSD scan under autograd (its Function, the plain backward
    formulas on the CPU) against ``jax.grad`` of the reference's
    ``ssd_chunked`` (48: ragged, padded as the model pads).
    f32, within 1e-4 of each gradient's max-abs."""
    rng = np.random.default_rng(1)
    B, H, P, N = 2, 3, 8, 16
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1))
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    wy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ws = rng.standard_normal((B, H, P, N)).astype(np.float32)

    def ref_loss(x, dt, A, Bm, Cm):
        y, st = ref_ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk)
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, A, Bm, Cm)]
    Q = min(chunk, S)
    xs, dts, Bs, Cs = ssm.pad_to_chunk(ts[0], ts[1], ts[3], ts[4], Q)
    y, st = ssd_scan(xs, dts, ts[2], Bs, Cs, chunk=Q)
    (torch.sum(y[:, :S] * torch.from_numpy(wy))
     + torch.sum(st * torch.from_numpy(ws))).backward()
    for t, w in zip(ts, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(t.grad), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_rglru_scan_gradients_match_jax_grad_of_the_reference():
    """The port's RG-LRU (gates and the scan's Function, the plain backward
    on the CPU) under autograd against ``jax.grad`` of the reference's
    associative scan, with respect to the
    input and every parameter.  f32, within 1e-4 of each max-abs."""
    cfg = get_config("recurrentgemma-9b", reduced=True)
    rcfg = ref_config("recurrentgemma-9b", reduced=True)
    spec = griffin.rglru_spec(cfg)
    ref_p = ref_layers.init_params(ref_griffin.rglru_spec(rcfg),
                                   jax.random.PRNGKey(2), jnp.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, cfg.lru_width)).astype(np.float32)
    wy = rng.standard_normal(x.shape).astype(np.float32)

    def ref_loss(p, x):
        y, last = ref_griffin.rglru_scan(p, x)
        return jnp.sum(y * wy) + jnp.sum(last)

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(ref_p, jnp.asarray(x))
    p = params_from_reference(spec, jax.tree_util.tree_map(np.asarray, ref_p),
                              "cpu")
    for t in p.values():
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, last = griffin.rglru_scan(p, xt)
    (torch.sum(y * torch.from_numpy(wy)) + torch.sum(last)).backward()
    # a leaf the scan never reads (conv_w) gets no grad here, zeros there
    got = {f"[{k!r}]": torch.zeros_like(t) if t.grad is None else t.grad
           for k, t in p.items()}
    got["x"] = xt.grad
    want = {**_ref_leaves(want_p), "x": want_x}
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(_np(got[k]), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


# ----------------------------------------------------------------------
# LM.loss and its gradients, every family
# ----------------------------------------------------------------------

LOSS_CASES = [("yi-6b", 48), ("minicpm-2b", 48), ("qwen2-moe-a2.7b", 48),
              ("internvl2-2b", 48), ("whisper-tiny", 48),
              ("mamba2-370m", 48), ("recurrentgemma-9b", 48),
              ("recurrentgemma-9b", 64)]


def _train_pair(arch, seq, dtype=jnp.float32):
    rcfg, cfg = ref_config(arch, reduced=True), get_config(arch, reduced=True)
    ref_lm = RefLM(rcfg, max_seq=seq)
    params = ref_lm.init(jax.random.PRNGKey(0), dtype)
    lm = LM(cfg, max_seq=seq, device="cpu")
    lm.load_reference(jax.tree_util.tree_map(np.asarray, params))
    batch = TokenPipeline(cfg, ShapeConfig("t", "train", seq, 2),
                          seed=5).train_batch(0)
    return ref_lm, params, lm, batch


@pytest.mark.parametrize("arch,seq", LOSS_CASES)
def test_loss_and_every_gradient_match_jax_value_and_grad(arch, seq):
    """f32 weights of the reference's ``lm.init``; the pipeline's seeded
    batch (a vlm's patch embeddings, an encdec's frames).  The moe config
    carries its aux loss; recurrentgemma at 48 (full causal attention) and
    64 (banded)."""
    ref_lm, params, lm, batch = _train_pair(arch, seq)
    (want, wm), want_g = jax.value_and_grad(ref_lm.loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    p = lm.params
    for t in _leaves(p).values():
        t.requires_grad_(True)
    got, gm = lm.loss(p, batch)
    got.backward()
    got = got.detach()
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(float(gm["ce"].detach()), float(wm["ce"]),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(float(gm["aux"].detach()), float(wm["aux"]),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    if lm.cfg.family == "moe":
        assert float(gm["aux"].detach()) > 0
    tol = GRAD_TOL.get(arch, DEFAULT_GRAD_TOL)
    mine, theirs = _leaves(p), _ref_leaves(want_g)
    assert sorted(mine) == sorted(theirs)
    for path, w in theirs.items():
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(_np(mine[path].grad), w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{arch} {path}")


def test_tied_embedding_gets_both_gradients_and_pad_rows_none():
    """minicpm-2b ties its embeddings: the lookup's scatter-add and the
    logits' product land on one leaf.  The padded vocab rows get exactly 0
    from the loss (and are still decayed by AdamW)."""
    _, _, lm, batch = _train_pair("minicpm-2b", 32)
    emb = lm.params["embed"].requires_grad_(True)
    loss, _ = lm.loss(lm.params, batch)
    loss.backward()
    V = lm.cfg.vocab_size
    assert lm.cfg.tie_embeddings and lm.cfg.padded_vocab > V
    assert not emb.grad[V:].any()
    seen = np.unique(batch["tokens"][:, :-1])
    unseen = np.setdiff1d(np.arange(V), seen)[:5]
    # rows no input token looks up still get the logits' gradient
    assert emb.grad[torch.from_numpy(unseen)].abs().sum() > 0
    tc = TrainConfig(warmup_steps=1, total_steps=4, weight_decay=0.1)
    opt = init_opt_state(lm.params)
    grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t))
             for k, t in _leaves(lm.params).items()}
    grads = _rebuild(lm.params, grads)
    _, new, _ = adamw_update(tc, opt, grads, lm.params)
    pad_before = lm.params["embed"][V:].detach()
    nz = pad_before != 0
    assert (new["embed"][V:][nz].abs() < pad_before[nz].abs()).all()


def _rebuild(template, by_path):
    return tree_map_with_path(lambda path, _: by_path[path], template)


# ----------------------------------------------------------------------
# the optimizer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "wsd"])
def test_schedules_match_the_reference_at_every_step(schedule):
    for tc_kw in ({"warmup_steps": 3, "total_steps": 20},
                  {"warmup_steps": 0, "total_steps": 20,
                   "wsd_decay_frac": 0.25}):
        ref = ref_schedule(RefTrainConfig(schedule=schedule, **tc_kw))
        mine = make_schedule(TrainConfig(schedule=schedule, **tc_kw))
        for step in range(21):
            want = float(ref(jnp.asarray(step, jnp.int32)))
            got = mine(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                       atol=1e-12, err_msg=f"step {step}")
            np.testing.assert_allclose(float(mine(step)), want, rtol=1e-6,
                                       atol=1e-12)


def _opt_inputs(dtype, scale):
    rng = np.random.default_rng(7)
    shapes = {"a": {"w": (6, 5), "b": (5,)}, "emb": (11, 4), "z": (3, 2, 2)}

    def draw(s):
        return (rng.standard_normal(s) * 0.5).astype(np.float32)
    params = {"a": {k: draw(s) for k, s in shapes["a"].items()},
              "emb": draw(shapes["emb"]), "z": draw(shapes["z"])}
    grads = [{"a": {k: draw(s) * scale for k, s in shapes["a"].items()},
              "emb": draw(shapes["emb"]) * scale,
              "z": draw(shapes["z"]) * scale} for _ in range(2)]
    grads[0]["emb"][3] = 0.0                 # a row the batch never touched
    return params, grads


def _t(tree, dtype=None):
    """numpy (ml_dtypes bf16 too) -> tensors, bit for bit, in ``dtype``."""
    return jax.tree_util.tree_map(
        lambda a: tensor_from_numpy(a, "cpu").to(dtype or torch.float32),
        tree)


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.01, 100.0])   # 100: clipped at 1.0
@pytest.mark.parametrize("schedule", ["cosine", "wsd"])
def test_adamw_on_identical_gradients_matches_the_reference(pdtype, scale,
                                                            schedule):
    """Two updates fed the same gradients (as numpy) on both sides: the new
    state (step, m, v, master) at rtol 1e-6 and within 1e-6 of each leaf's
    max-abs (the global norm's sum runs in another order, one ulp apart,
    so the clip factor can be; the second step's m = b1 m + (1-b1) g then
    cancels that ulp into a larger relative error in small entries), lr
    and grad_norm at rtol 1e-6, and the new parameters equal wherever the
    f32 masters are equal (a bf16 parameter is the master rounded to
    nearest even)."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[pdtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[pdtype]
    kw = {"warmup_steps": 1, "total_steps": 4, "schedule": schedule,
          "learning_rate": 1e-2}
    p0, grads = _opt_inputs(pdtype, scale)
    rp = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), p0)
    ropt = ref_init_opt(rp)
    tp = jax.tree_util.tree_map(lambda a: np.asarray(a), rp)
    mp = _t(tp, tdt)
    mopt = init_opt_state(mp)
    assert mopt.step.dtype == torch.int32 and mopt.step.dim() == 0
    for g in grads:
        ropt, rp, rm = ref_adamw(RefTrainConfig(**kw), ropt,
                                 jax.tree_util.tree_map(jnp.asarray, g), rp)
        mopt, mp, mm = adamw_update(TrainConfig(**kw), mopt, _t(g), mp)
        assert int(mopt.step) == int(ropt.step)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(mm[key]), float(rm[key]),
                                       rtol=1e-6)
        if scale > 1:
            assert float(mm["grad_norm"]) > TrainConfig().grad_clip
        for name in ("m", "v", "master"):
            got, want = _leaves(getattr(mopt, name)), \
                _ref_leaves(getattr(ropt, name))
            assert sorted(got) == sorted(want)
            for k in want:
                w = np.asarray(want[k])
                np.testing.assert_allclose(_np(got[k]), w, rtol=1e-6,
                                           atol=1e-6 * np.abs(w).max(),
                                           err_msg=f"{name}{k}")
        got_p, want_p = _leaves(mp), _ref_leaves(rp)
        masters = _leaves(mopt.master)
        rmasters = _ref_leaves(ropt.master)
        for k in want_p:
            assert got_p[k].dtype == tdt
            assert torch.equal(got_p[k], masters[k].to(tdt))
            same = _np(masters[k]) == np.asarray(rmasters[k])
            np.testing.assert_array_equal(_np(got_p[k])[same],
                                          np.asarray(want_p[k],
                                                     np.float32)[same])
            assert same.mean() > 0.5, k


def test_global_norm_sums_leaves_in_f32():
    rng = np.random.default_rng(3)
    tree = {"b": rng.standard_normal((4, 3)).astype(np.float32),
            "a": {"x": rng.standard_normal(7).astype(np.float32)}}
    want = float(ref_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = global_norm(_t(tree, torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        float(global_norm(_t(tree))), want, rtol=1e-6)
    np.testing.assert_allclose(
        float(got), float(ref_norm(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree))), rtol=1e-6)


def test_the_state_is_updated_in_place_and_handed_back():
    """m, v and master are the state's own tensors, updated in place (the
    port's one departure from the reference, for memory); the parameters
    are new tensors, never the masters themselves."""
    p = {"w": torch.ones(4)}
    opt = init_opt_state(p)
    m, master = opt.m["w"], opt.master["w"]
    new_opt, new_p, _ = adamw_update(TrainConfig(warmup_steps=0,
                                                 total_steps=2), opt,
                                     {"w": torch.full((4,), 0.5)}, p)
    assert new_opt.m["w"] is m and new_opt.master["w"] is master
    assert m.abs().sum() > 0
    assert new_p["w"].data_ptr() != master.data_ptr()
    assert isinstance(new_opt, OptState) and int(new_opt.step) == 1


# ----------------------------------------------------------------------
# whole steps: the quickstart, the CLI, checkpoints across packages
# ----------------------------------------------------------------------

def _quickstart_part1() -> str:
    text = (ROOT / "examples" / "quickstart.py").read_text()
    return text[:text.index("# 2. Prefill")]


def test_quickstart_part_one_trains_alike_on_the_port():
    """``examples/quickstart.py`` part 1 (reduced yi-6b, bf16 weights, two
    AdamW steps) runs as written on the reference; the port takes the same
    weights and tokens through ``LM.loss``, autograd and ``adamw_update``.
    Losses within 2e-2 (bf16)."""
    ns: dict = {}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        exec(compile(_quickstart_part1(), "quickstart.py", "exec"), ns)
    want = [float(x) for x in re.findall(r"loss (\S+)", out.getvalue())]
    assert len(want) == 2
    cfg = get_config("yi-6b", reduced=True)
    lm = LM(cfg, max_seq=64, device="cpu")
    params = lm.load_reference(jax.tree_util.tree_map(
        np.asarray, ns["lm"].init(jax.random.PRNGKey(0))))
    tc = TrainConfig(total_steps=10, warmup_steps=2)
    opt = init_opt_state(params)
    batch = {"tokens": np.array(ns["toks"])}
    got = []
    for _ in range(2):
        params, opt, m = port_train.train_step(lm, tc, params, opt, batch)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, atol=CLI_LOSS_TOL)
    assert got[1] < got[0]


def _ref_cli(argv) -> str:
    """The reference's ``train.py`` as a user runs it; returns its stdout."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["train.py", *argv]
    try:
        with contextlib.redirect_stdout(out):
            ref_train.main()
    finally:
        sys.argv = old
    return out.getvalue()


def _losses(text: str) -> dict[int, float]:
    return {int(s): float(v) for s, v in
            re.findall(r"step\s+(\d+) loss (\S+)", text)}


def _ref_init(arch, seq):
    """The reference CLI's weights: ``lm.init(PRNGKey(tc.seed))``, seed 0."""
    return jax.tree_util.tree_map(np.asarray, RefLM(
        ref_config(arch, reduced=True), max_seq=seq).init(
            jax.random.PRNGKey(0)))


CLI = ["--arch", "demo-100m", "--reduced", "--steps", "5", "--batch", "4",
       "--seq", "32"]


def test_cli_losses_follow_the_reference_cli():
    """``launch/train.py --device cpu --reduced`` for 5 steps against the
    reference's ``train.py`` from the same weights: per-step losses within
    2e-2 (bf16), falling; the same line printed."""
    want = _losses(_ref_cli(CLI))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = port_train.main([*CLI, "--device", "cpu"],
                               params=_ref_init("demo-100m", 32))
    assert [h["step"] for h in hist] == list(range(5)) == sorted(want)
    got = _losses(out.getvalue())
    np.testing.assert_allclose([got[s] for s in range(5)],
                               [want[s] for s in range(5)], atol=CLI_LOSS_TOL)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert out.getvalue().rstrip().endswith("done")


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_cli_losses_follow_the_reference_cli_for_the_scan_families(arch):
    """The ssm and hybrid families through ``launch/train.py --device cpu
    --reduced`` (the scans' Functions with their plain backward formulas)
    against the reference's ``train.py`` from the same weights, 4 steps of
    2 x 64 (mamba2: two chunks of 32; recurrentgemma: twice its window of
    32, banded attention): per-step losses within 2e-2 (bf16); the same
    line printed."""
    argv = ["--arch", arch, "--reduced", "--steps", "4", "--batch", "2",
            "--seq", "64"]
    want = _losses(_ref_cli(argv))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = port_train.main([*argv, "--device", "cpu"],
                               params=_ref_init(arch, 64))
    assert [h["step"] for h in hist] == list(range(4)) == sorted(want)
    got = _losses(out.getvalue())
    np.testing.assert_allclose([got[s] for s in range(4)],
                               [want[s] for s in range(4)], atol=CLI_LOSS_TOL)
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    assert out.getvalue().rstrip().endswith("done")


def test_cli_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert port_train.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.main(["--reduced", "--steps", "1"])


def _manifest(d, step):
    with open(os.path.join(d, f"manifest-{step:08d}.json")) as f:
        return json.load(f)


def _shape_of(man: dict) -> dict:
    """A manifest without its content: every leaf's name, dtype and shape,
    the trees saved, the step."""
    return {"step": man["step"], "keys": man["keys"], "full": man["full"],
            "names": {n: [(a["dtype"], list(a["shape"])) for a in rec["arrays"]]
                      for n, rec in man["names"].items()}}


def _spy_states(monkeypatch, calls: set[int]) -> dict[int, dict]:
    """Wraps the port CLI's step function: returns a dict that fills, for
    each 0-based call index in ``calls`` (counted over every run of the
    CLI from here on), with the {keystr: f32 numpy copy} of the params and
    opt state handed to that step, taken before it updates them in
    place."""
    seen, step_fn, n = {}, port_train.train_step, [0]

    def spy(lm, tc, params, opt, batch):
        if n[0] in calls:
            seen[n[0]] = {p: _np(x).copy() for p, x in _leaves(
                {"params": params, "opt": opt._asdict()}).items()}
        n[0] += 1
        return step_fn(lm, tc, params, opt, batch)

    monkeypatch.setattr(port_train, "train_step", spy)
    return seen


def _ref_restored(d, seq, step) -> dict:
    """The reference's ``Checkpointer`` reading the checkpoint of ``step``
    in ``d`` into its CLI's templates: {keystr: f32 numpy}."""
    params = RefLM(ref_config("demo-100m", reduced=True), max_seq=seq).init(
        jax.random.PRNGKey(0))
    tree, _ = RefCheckpointer(d).restore(
        {"params": params, "opt": ref_init_opt(params)._asdict()}, step=step)
    return {p: np.asarray(x, np.float32) for p, x in _ref_leaves(tree).items()}


def _assert_same_state(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def test_checkpoints_resume_across_packages(tmp_path, monkeypatch):
    """The reference's ``train.py --ckpt-dir`` checkpoint (reduced demo-100m,
    step 2 of 4) resumes in the port's ``train.py --resume``, and the port's
    in the reference's.  The two manifests name the same leaves (keystr
    paths of params and opt, the 0-d int32 step) with the same dtypes and
    shapes.  The state each package resumes from is the one the other
    saved, every leaf equal: the port starts step 2 from what the
    reference's own ``Checkpointer`` reads back from its checkpoint, and
    the reference's ``Checkpointer`` reads back from the port's checkpoint
    the params, master, m, v and step the port held after step 2 (the
    losses alone cannot tell a lost optimizer state at this size: see
    the next test).  Each resumed step-2 and step-3 loss equals the other
    package's uninterrupted one within 2e-2 (bf16)."""
    argv = ["--arch", "demo-100m", "--reduced", "--steps", "4", "--batch",
            "2", "--seq", "32", "--ckpt-every", "2"]
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    states = _spy_states(monkeypatch, {2, 4})
    want = _losses(_ref_cli([*argv, "--ckpt-dir", ref_dir]))
    with contextlib.redirect_stdout(io.StringIO()):
        hist = port_train.main([*argv, "--ckpt-dir", port_dir, "--device",
                                "cpu"], params=_ref_init("demo-100m", 32))
    mine = {h["step"]: h["loss"] for h in hist}
    rman, pman = _manifest(ref_dir, 2), _manifest(port_dir, 2)
    assert _shape_of(pman) == _shape_of(rman)
    assert "opt/.step" in pman["names"] or "opt/['step']" in pman["names"]
    step_leaf = [rec for n, rec in pman["names"].items() if "step" in n][0]
    assert step_leaf["arrays"][0]["dtype"] == "int32"
    assert step_leaf["arrays"][0]["shape"] == []

    # each run "stopped" after its step-2 save: drop the later manifest
    for d in (ref_dir, port_dir):
        cut = d + "-at2"
        shutil.copytree(d, cut)
        os.remove(os.path.join(cut, "manifest-00000004.json"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        resumed = port_train.main([*argv, "--ckpt-dir", ref_dir + "-at2",
                                   "--resume", "--device", "cpu"])
    assert "resumed from step 2" in out.getvalue()
    assert [h["step"] for h in resumed] == [2, 3]
    _assert_same_state(states[4], _ref_restored(ref_dir + "-at2", 32, 2))
    np.testing.assert_allclose([h["loss"] for h in resumed],
                               [want[2], want[3]], atol=CLI_LOSS_TOL)
    _assert_same_state(_ref_restored(port_dir + "-at2", 32, 2), states[2])
    back = _losses(_ref_cli([*argv, "--ckpt-dir", port_dir + "-at2",
                             "--resume"]))
    assert sorted(back) == [2, 3]
    np.testing.assert_allclose([back[2], back[3]], [mine[2], mine[3]],
                               atol=CLI_LOSS_TOL)


def test_a_lost_optimizer_state_fails_the_state_check_not_the_losses(
        tmp_path, monkeypatch):
    """Why the resume test compares the state leaf for leaf: the port's
    CLI resumed with its optimizer state lost (m, v and step reset, the
    master recast from the params, as ``init_opt_state`` makes it) gives
    step-2 and step-3 losses within the 2e-2 bf16 tolerance of the
    unbroken run's, while the restored state differs from the saved
    one."""
    argv = ["--arch", "demo-100m", "--reduced", "--steps", "4", "--batch",
            "2", "--seq", "32", "--ckpt-every", "2", "--device", "cpu"]
    d = str(tmp_path / "port")
    states = _spy_states(monkeypatch, {2, 4})
    with contextlib.redirect_stdout(io.StringIO()):
        full = port_train.main([*argv, "--ckpt-dir", d],
                               params=_ref_init("demo-100m", 32))
    shutil.copytree(d, d + "-at2")
    os.remove(os.path.join(d + "-at2", "manifest-00000004.json"))
    monkeypatch.setattr(port_train, "OptState",
                        lambda **kw: init_opt_state(kw["master"]))
    with contextlib.redirect_stdout(io.StringIO()):
        lost = port_train.main([*argv, "--ckpt-dir", d + "-at2",
                                "--resume"])
    assert [h["step"] for h in lost] == [2, 3]
    np.testing.assert_allclose([h["loss"] for h in lost],
                               [h["loss"] for h in full[2:]],
                               atol=CLI_LOSS_TOL)
    with pytest.raises(AssertionError, match=r"\['opt'\]"):
        _assert_same_state(states[4], states[2])


# ----------------------------------------------------------------------
# the kernels' dispatch under grad, and serving without a graph
# ----------------------------------------------------------------------

def test_scans_refuse_grad_on_a_device_before_launching():
    """Off the CPU (a meta tensor stands in for a card's here) the SSD and
    RG-LRU scans under grad run their ``autograd.Function``, whose forward
    reaches the kernel's wrapper, which refuses the non-CUDA tensor before
    anything launches; without grad the same call reaches the wrapper too.
    Nothing falls back to the plain version.  On the CPU the same call
    under grad runs the Function over the plain versions: the outputs carry
    its backward."""
    meta = torch.device("meta")
    a = torch.rand(1, 4, 8, device=meta, requires_grad=True)
    b = torch.rand(1, 4, 8, device=meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rglru_scan(a, b)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        rglru_scan(a, b)
    x = torch.rand(1, 32, 2, 16, device=meta, requires_grad=True)
    dt = torch.rand(1, 32, 2, device=meta)
    A = torch.rand(2, device=meta)
    Bm = torch.rand(1, 32, 16, device=meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_scan(x, dt, A, Bm, Bm, chunk=32)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        ssd_scan(x, dt, A, Bm, Bm, chunk=32)
    h, _ = rglru_scan(torch.rand(1, 4, 8, requires_grad=True),
                      torch.rand(1, 4, 8))
    assert type(h.grad_fn).__name__ == "_RGLRUScanBackward"
    y, _ = ssd_scan(torch.rand(1, 32, 2, 16, requires_grad=True),
                    torch.rand(1, 32, 2), torch.rand(2),
                    torch.rand(1, 32, 16), torch.rand(1, 32, 16), chunk=32)
    assert y.grad_fn is not None


def test_serving_builds_no_graph_even_from_trainable_params():
    """``prefill`` and ``decode_step`` run without grad: parameters that
    require grad (a model mid-training) give logits and caches with no
    autograd history."""
    _, _, lm, _ = _train_pair("yi-6b", 16)
    for t in _leaves(lm.params).values():
        t.requires_grad_(True)
    toks = torch.from_numpy(np.arange(16, dtype=np.int64).reshape(2, 8))
    logits, cache = lm.prefill(toks, cache_len=12)
    assert logits.grad_fn is None and not logits.requires_grad
    assert not cache["stack"]["k"].requires_grad
    logits, cache = lm.decode_step(cache, logits.argmax(-1)[:, None])
    assert logits.grad_fn is None and not cache["stack"]["v"].requires_grad


def test_forward_with_explicit_params_matches_the_default():
    cfg = dataclasses.replace(get_config("yi-6b", reduced=True), num_layers=2)
    lm = LM(cfg, max_seq=16, device="cpu")
    lm.init(0, torch.float32)
    toks = torch.from_numpy(np.arange(16, dtype=np.int64).reshape(2, 8))
    a, _ = lm.forward(toks)
    b, _ = lm.forward(toks, params=lm.params)
    other = {k: v for k, v in lm.params.items()}
    other["ln_f"] = lm.params["ln_f"] + 1.0
    c, _ = lm.forward(toks, params=other)
    assert torch.equal(a, b) and not torch.equal(a, c)
