"""The port's LM (every family: dense, moe, ssm, hybrid, vlm and encdec)
against the JAX reference's, on the CPU, with the reference's own weights
carried across.

Weights come from the reference's ``LM.init(PRNGKey(0), dtype)`` as numpy
arrays; both models see one 48-token prompt (not a multiple of the reduced
mamba2's SSD chunk of 32, so the pad path runs), then four greedy decode
steps.  The vlm prompt is the pipeline's 8 patch embeddings and 40 text
tokens; the encdec one 48 decoder tokens over the pipeline's 24 encoder
frames (the reduced whisper's encoder_seq).  The reduced recurrentgemma (window 32; 3 layers, and 5 with a
tail) sees prompts of 48 (the reference's full causal attention for S >
window when S is not a multiple of it), 64 (banded attention) and 16
(below the window), and decodes until four steps past the window's end;
the whole ``groups``/``tail`` cache is compared after prefill and after
the last step.  Tolerances (atol = rtol):
- f32 dense, moe, vlm, encdec and recurrentgemma 1e-4 (the RG-LRU scan sums in another
  order than the reference's associative scan; 4e-6 measured); f32
  mamba2 1e-3, because the SSD sums are taken in another order (chunk by
  chunk, as the kernel does);
- bf16 5e-2 for all families: activations round to bf16 at other places
  (the port's attention keeps f32 scores where the reference's XLA
  attention rounds them to bf16; torch's bf16 sigmoid rounds once where
  XLA's rounds each step); the largest difference measured on these inputs
  is 2.7e-2 (cache entries), 1.4e-2 on logits for dense and mamba2, 4.2e-2
  on the cache and 2.5e-2 on logits for the 3-layer recurrentgemma.  The
  5-layer recurrentgemma's cache is held to 1e-1: its deepest entries,
  the last tail layer's conv state (the projection of the residual
  stream after four layers), carry those one-ulp differences through
  four layers, 7.9e-2 measured on 2 of 384 entries; its logits stay at
  5e-2 (2.8e-2 measured).
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import attention, layers, moe  # noqa: E402

PROMPT, CACHE, STEPS = 48, 56, 4
F32_TOL = {"yi-6b": 1e-4, "demo-100m": 1e-4, "mamba2-370m": 1e-3,
           "stablelm-12b": 1e-4, "phi3-medium-14b": 1e-4, "minicpm-2b": 1e-4,
           "qwen2-moe-a2.7b": 1e-4, "qwen3-moe-235b-a22b": 1e-4,
           "internvl2-2b": 1e-4, "whisper-tiny": 1e-4}
# stablelm-12b at its own head dim, 160 (d_model 5120 / 32 heads), which
# every other reduced config (head dim 16) misses
STABLELM_HD160 = {"d_model": 320, "num_heads": 2, "num_kv_heads": 2,
                  "num_layers": 2}
BF16_TOL = 5e-2
HYBRID = "recurrentgemma-9b"
HYBRID_BF16_CACHE_TOL = {3: 5e-2, 5: 1e-1}
# a moe router's choice may differ from the reference's only at a near
# tie: at each of the K ranks, the port's probabilities of its expert and
# of the reference's within this relative distance (f32: exact ties only;
# bf16: two bf16 ulps, 2**-6, of the logits' rounding)
ROUTE_TIE_RTOL = {jnp.float32: 0.0, jnp.bfloat16: 2.0 ** -6}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _pair(arch, dtype, num_layers=None, cache_len=CACHE, overrides=None):
    rcfg, cfg = ref_config(arch, reduced=True), get_config(arch, reduced=True)
    overrides = dict(overrides or {})
    if num_layers is not None:
        overrides["num_layers"] = num_layers
    rcfg = dataclasses.replace(rcfg, **overrides)
    cfg = dataclasses.replace(cfg, **overrides)
    ref_lm = RefLM(rcfg, max_seq=cache_len)
    params = ref_lm.init(jax.random.PRNGKey(0), dtype)
    lm = LM(cfg, max_seq=cache_len, device="cpu")
    lm.load_reference(jax.tree_util.tree_map(np.asarray, params))
    return ref_lm, params, lm


def _cache_close(got, want, tol, path="cache"):
    """Walk the reference's cache tree (``stack``, or ``groups`` and
    ``tail``) and hold every leaf of the port's against it."""
    if isinstance(want, dict):
        mine = sorted(k for k in got if k != "filled")
        assert mine == sorted(want), (path, mine, sorted(want))
        for k in want:
            if k != "pos":
                _cache_close(got[k], want[k], tol, f"{path}[{k!r}]")
        return
    assert tuple(got.shape) == want.shape, path
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol,
                               err_msg=path)


def _modality(cfg, prompt):
    """The seeded pipeline's modality inputs for a prompt of ``prompt``
    positions: a vlm's ``vision_embeds`` and an encdec's ``encoder_frames``
    (numpy f32), nothing for the other families."""
    batch = TokenPipeline(cfg, ShapeConfig("test", "prefill", prompt, 2),
                          seed=3).prefill_batch(0)
    return {k: v for k, v in batch.items()
            if k in ("vision_embeds", "encoder_frames")}


@contextlib.contextmanager
def _routing_as_in_reference(rtol):
    """Route the port's moe layers as the reference routes the same call.

    One ulp apart in bf16 upstream, two experts can tie in one package's
    router and not in the other's (ROADMAP queue C, qwen3-moe bf16), and
    a token then goes to another expert: a discrete flip that no tolerance
    on the outputs covers.  Inside this context the reference's moe layers
    record their top-K choice (a debug callback, in call order) and the
    port's ``top_k`` takes it; every call where the two choices differ
    must be a near tie in the port's own probabilities (``rtol`` at each
    rank), so only the tie rule is taken from the reference, never a
    decision the port's numbers contradict.  Yields the list of flips
    (call, token, port's experts, reference's experts)."""
    choices, flips = [], []
    ref_ffn, port_top_k = ref_moe.moe_ffn, moe.top_k

    def recording(p, x, cfg, ctx=None):
        xt = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(jnp.einsum("td,de->te", xt, p["router"])
                               .astype(jnp.float32), axis=-1)
        jax.debug.callback(lambda i: choices.append(np.array(i)),
                           jax.lax.top_k(probs, cfg.experts_per_tok)[1],
                           ordered=True)
        return ref_ffn(p, x, cfg, ctx)

    def following(probs, k):
        call = following.calls
        following.calls += 1
        got = port_top_k(probs, k)[1]
        want = torch.from_numpy(choices[call]).long()
        for t in torch.nonzero((got != want).any(dim=1)).ravel().tolist():
            pg, pw = probs[t, got[t]], probs[t, want[t]]
            assert bool(((pg - pw).abs() <= rtol * pg).all()), \
                (call, t, got[t].tolist(), pg.tolist(), want[t].tolist(),
                 pw.tolist())
            flips.append((call, t, got[t].tolist(), want[t].tolist()))
        return torch.gather(probs, 1, want), want

    following.calls = 0
    ref_moe.moe_ffn, moe.top_k = recording, following
    try:
        yield flips
    finally:
        ref_moe.moe_ffn, moe.top_k = ref_ffn, port_top_k


def _run(arch, dtype, tol, check_ids, **kw):
    """A moe config takes the reference's routing at near ties
    (:func:`_routing_as_in_reference`); every other family runs as it is."""
    with (_routing_as_in_reference(ROUTE_TIE_RTOL[dtype])
          if get_config(arch, reduced=True).family == "moe"
          else contextlib.nullcontext()):
        _compare(arch, dtype, tol, check_ids, **kw)


def _compare(arch, dtype, tol, check_ids, *, prompt=PROMPT, steps=STEPS,
             num_layers=None, cache_tol=None, overrides=None):
    cache_len = CACHE if prompt + steps <= CACHE else prompt + steps
    ref_lm, params, lm = _pair(arch, dtype, num_layers, cache_len, overrides)
    cache_tol = cache_tol or tol
    rng = np.random.default_rng(3)
    extra = _modality(lm.cfg, prompt)
    n_text = prompt - (lm.cfg.num_patches if "vision_embeds" in extra else 0)
    toks = rng.integers(0, lm.cfg.vocab_size, (2, n_text)).astype(np.int32)
    want, rcache = ref_lm.prefill(
        params, {"tokens": jnp.asarray(toks),
                 **{k: jnp.asarray(v) for k, v in extra.items()}},
        cache_len=cache_len)
    got, cache = lm.prefill(torch.from_numpy(toks), cache_len=cache_len,
                            **extra)
    assert tuple(got.shape) == (2, lm.cfg.padded_vocab)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    _cache_close(cache, rcache, cache_tol)
    assert cache["pos"].tolist() == np.asarray(rcache["pos"]).tolist()
    # the hybrid decodes many steps: its reference step is compiled once
    decode = jax.jit(ref_lm.decode_step) if lm.cfg.family == "hybrid" \
        else ref_lm.decode_step
    rtok = jnp.argmax(want, axis=-1)[:, None].astype(jnp.int32)
    tok = got.argmax(dim=-1)[:, None]
    for _ in range(steps):
        if check_ids:
            assert tok[:, 0].tolist() == np.asarray(rtok)[:, 0].tolist()
        want, rcache = decode(params, rcache, {"token": rtok})
        got, cache = lm.decode_step(cache, tok if check_ids
                                    else torch.from_numpy(np.array(rtok)))
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
        rtok = jnp.argmax(want, axis=-1)[:, None].astype(jnp.int32)
        tok = got.argmax(dim=-1)[:, None]
    _cache_close(cache, rcache, cache_tol)
    assert cache["pos"].tolist() == np.asarray(rcache["pos"]).tolist()


@pytest.mark.parametrize("arch", sorted(F32_TOL))
def test_prefill_and_decode_match_the_reference_f32(arch):
    _run(arch, jnp.float32, F32_TOL[arch], check_ids=True)


@pytest.mark.parametrize("arch", sorted(F32_TOL))
def test_prefill_and_decode_match_the_reference_bf16(arch):
    """bf16 weights: the port decodes the reference's tokens (no id check)."""
    _run(arch, jnp.bfloat16, BF16_TOL, check_ids=False)


@pytest.mark.parametrize("dtype,tol,check_ids", [
    (jnp.float32, 1e-4, True), (jnp.bfloat16, BF16_TOL, False)])
def test_stablelm_at_head_dim_160_matches_the_reference(dtype, tol, check_ids):
    """stablelm-12b's head dim (160) and partial rotary (40 of 160 dims)
    through the port's plain attention path (the flash kernel's plain
    version on the CPU) against the reference's XLA attention."""
    cfg = dataclasses.replace(get_config("stablelm-12b", reduced=True),
                              **STABLELM_HD160)
    assert cfg.resolved_head_dim == 160
    _run("stablelm-12b", dtype, tol, check_ids, overrides=STABLELM_HD160)


def _hybrid_steps(prompt):
    """Decode until four steps past the end of the reduced window (32)."""
    window = get_config(HYBRID, reduced=True).local_window
    return max(STEPS, window - prompt + STEPS)


@pytest.mark.parametrize("prompt", [48, 64, 16])
@pytest.mark.parametrize("num_layers", [3, 5])
def test_recurrentgemma_matches_the_reference_f32(prompt, num_layers):
    """48: S > window but not a multiple of it, so the reference (and the
    port) run full causal attention (flash on the card); 64: banded
    attention; 16: below the window, decoding past its end into the ring.
    5 layers: a group of (rec, rec, attn) and a tail of two rec layers."""
    _run(HYBRID, jnp.float32, 1e-4, check_ids=True, prompt=prompt,
         steps=_hybrid_steps(prompt), num_layers=num_layers)


@pytest.mark.parametrize("prompt", [48, 64, 16])
@pytest.mark.parametrize("num_layers", [3, 5])
def test_recurrentgemma_matches_the_reference_bf16(prompt, num_layers):
    """bf16 weights: the port decodes the reference's tokens (no id check)."""
    _run(HYBRID, jnp.bfloat16, BF16_TOL, check_ids=False, prompt=prompt,
         steps=_hybrid_steps(prompt), num_layers=num_layers,
         cache_tol=HYBRID_BF16_CACHE_TOL[num_layers])


def test_recurrentgemma_cache_layout_and_the_ring_never_runs_out():
    """groups stacked on a leading axis, the tail unstacked; window caches
    of min(window, cache_len) slots, which decode wraps without end (the
    prefill rolls the ring: the f32 tests above hold its layout against
    the reference's at prompts 48 and 64)."""
    cfg = dataclasses.replace(get_config(HYBRID, reduced=True), num_layers=5)
    lm = LM(cfg, device="cpu")
    lm.init(0, torch.float32)
    cache = lm.init_cache(2, 20)
    assert sorted(cache) == ["filled", "groups", "pos", "tail"]
    assert sorted(cache["groups"]) == ["b0_rec", "b1_rec", "b2_attn"]
    assert sorted(cache["tail"]) == ["t0_rec", "t1_rec"]
    assert tuple(cache["groups"]["b2_attn"]["k"].shape) == (1, 2, 1, 20, 16)
    assert tuple(cache["groups"]["b0_rec"]["lru"].shape) == (1, 2, 64)
    assert tuple(cache["tail"]["t1_rec"]["conv"].shape) == (2, 3, 64)
    assert tuple(lm.init_cache(2, 100)["groups"]["b2_attn"]["v"].shape) == \
        (1, 2, 1, 32, 16)
    toks = torch.randint(0, cfg.vocab_size, (2, 45),
                         generator=torch.Generator().manual_seed(0))
    _, cache = lm.prefill(toks, cache_len=50)
    for _ in range(40):                  # past cache_len: the ring wraps
        logits, cache = lm.decode_step(cache, toks[:, :1])
    assert cache["filled"] == 85 and cache["pos"].tolist() == [85, 85]
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-370m"])
def test_own_init_follows_the_reference_rules(arch):
    """Same tree, shapes and dtypes as the reference's init; truncated
    normals within 2 sigma; the zeros, ones, dt_bias and a_log rules."""
    ref_lm = RefLM(ref_config(arch, reduced=True))
    want = jax.eval_shape(lambda: ref_lm.init(jax.random.PRNGKey(0)))
    lm = LM(get_config(arch, reduced=True), device="cpu")
    got = lm.init(torch.Generator().manual_seed(0), torch.float32)
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = layers.spec_leaves(got)
    assert [jax.tree_util.keystr(p) for p, _ in flat_want] == \
        [p for p, _ in flat_got]
    assert all(tuple(t.shape) == w.shape for (_, w), (_, t) in
               zip(flat_want, flat_got))
    emb = got["embed"]
    assert float(emb.abs().max()) <= 2 * 0.02 + 1e-6
    assert abs(float(emb.std()) - 0.02 * 0.88) < 2e-3      # truncated sigma
    stack = got["decoder"]["stack"]
    if arch == "mamba2-370m":
        mixer = stack["mixer"]
        dt = torch.nn.functional.softplus(mixer["dt_bias"])
        assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) <= 0.1 + 1e-7
        a = mixer["A_log"].exp()
        assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
        assert bool((mixer["D"] == 1).all()) and bool((stack["ln"] == 0).all())
        w = mixer["w_x"]                                     # (L, d, din)
    else:
        assert bool((stack["ln1"] == 0).all())
        w = stack["attn"]["wq"]                              # (L, d, H, hd)
    fan_in = int(np.prod(w.shape[1:-1]))
    assert float(w.abs().max()) <= 2 / np.sqrt(fan_in) + 1e-6


def test_apply_rope_pairs_even_and_odd_elements():
    """The reference rotates (0::2, 1::2) pairs and interleaves them back,
    not the rotate-half layout; partial rotary leaves the tail as it is."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1)) + 7
    for pct, theta in ((1.0, 10_000.0), (0.25, 5e6)):
        want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     rope_pct=pct, theta=theta)
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                rope_pct=pct, theta=theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    half = x.shape[-1] // 2
    rotate_half = np.concatenate([-x[..., half:], x[..., :half]], -1)
    assert not np.allclose(got.numpy()[..., :4], rotate_half[..., :4])


def test_rms_norm_scales_by_one_plus_w_in_f32():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 64)).astype(np.float32) * 4
    w = rng.standard_normal(64).astype(np.float32) * 0.1
    want = ref_layers.rms_norm(jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(w).astype(jnp.bfloat16), 1e-5)
    got = layers.rms_norm(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(w).bfloat16(), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_cache_write_stays_in_range_where_the_reference_clamps():
    rng = np.random.default_rng(2)
    kc, vc = (rng.standard_normal((2, 2, 6, 4)).astype(np.float32)
              for _ in range(2))
    nk, nv = (rng.standard_normal((2, 1, 2, 4)).astype(np.float32)
              for _ in range(2))
    pos = np.array([1, 5], np.int32)
    want = ref_attn.cache_write_plain(*map(jnp.asarray, (kc, vc, nk, nv, pos)))
    got = attention.cache_write_plain(*(torch.from_numpy(a.copy())
                                        for a in (kc, vc, nk, nv, pos)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # one past the end: the reference overwrites the last slot, the port's
    # decode step raises before it writes
    past = np.array([6, 6], np.int32)
    clamped = ref_attn.cache_write_plain(*map(jnp.asarray, (kc, vc, nk, nv, past)))
    np.testing.assert_array_equal(np.asarray(clamped[0])[0, :, 5], nk[0, 0])
    lm = LM(get_config("yi-6b", reduced=True), max_seq=6, device="cpu")
    lm.init(0, torch.float32)
    toks = torch.zeros((2, 5), dtype=torch.long)
    _, cache = lm.prefill(toks, cache_len=6)
    _, cache = lm.decode_step(cache, toks[:, :1])            # slot 5, the last
    assert cache["pos"].tolist() == [6, 6] and cache["filled"] == 6
    k_before = cache["stack"]["k"].clone()
    with pytest.raises(IndexError, match="outside a cache of 6 slots"):
        lm.decode_step(cache, toks[:, :1])
    assert torch.equal(cache["stack"]["k"], k_before)


def test_mamba2_decode_state_stays_in_the_cache_dtype():
    _, _, lm = _pair("mamba2-370m", jnp.bfloat16)
    toks = torch.zeros((2, 8), dtype=torch.long)
    _, cache = lm.prefill(toks, cache_len=10)
    assert cache["stack"]["ssm"].dtype == torch.bfloat16
    _, cache = lm.decode_step(cache, toks[:, :1])
    assert cache["stack"]["ssm"].dtype == torch.bfloat16
    assert cache["pos"].tolist() == [9, 9]


@pytest.mark.parametrize("arch", sorted(ASSIGNED_ARCHS) + ["demo-100m"])
def test_configs_equal_the_reference(arch):
    """The port's configs are copies: field for field equal, full and
    reduced, with the same derived sizes."""
    import dataclasses
    for reduced in (False, True):
        got, want = get_config(arch, reduced), ref_config(arch, reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.padded_vocab, got.resolved_head_dim, got.layer_kinds(),
                got.count_params()) == \
            (want.padded_vocab, want.resolved_head_dim, want.layer_kinds(),
             want.count_params())


@pytest.mark.parametrize("arch", sorted(ASSIGNED_ARCHS))
def test_unported_families_name_their_roadmap_item(arch):
    """Every family is ported now, so no config names a ROADMAP item any
    more: each assigned config builds on the CPU from its own seeded init
    and prefills (with the pipeline's modality inputs) and decodes one
    step to finite logits."""
    cfg = get_config(arch, reduced=True)
    lm = LM(cfg, max_seq=24, device="cpu")
    assert lm.cfg is cfg
    lm.init(0, torch.float32)
    extra = _modality(cfg, 16)
    n_text = 16 - (cfg.num_patches if "vision_embeds" in extra else 0)
    toks = torch.zeros((2, n_text), dtype=torch.long)
    logits, cache = lm.prefill(toks, cache_len=20, **extra)
    assert tuple(logits.shape) == (2, cfg.padded_vocab)
    assert cache["pos"].tolist() == [16, 16] and cache["filled"] == 16
    logits, cache = lm.decode_step(cache, logits.argmax(-1)[:, None])
    assert bool(torch.isfinite(logits).all()) and cache["filled"] == 17


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        LM(get_config("yi-6b", reduced=True))


@pytest.mark.parametrize("name", ["synthetic_patch_embeds",
                                  "synthetic_frame_embeds"])
def test_synthetic_frontends_draw_as_the_reference(name):
    """The stub frontends: the reference's shapes and dtype, N(0, 0.02^2)
    values, the same draw again from a generator seeded alike."""
    from repro.models import frontends as ref_frontends
    from repro_torch.models import frontends
    want = getattr(ref_frontends, name)(jax.random.PRNGKey(0), 2, 300, 64)
    draw = getattr(frontends, name)
    got = draw(torch.Generator().manual_seed(0), 2, 300, 64)
    assert tuple(got.shape) == want.shape and got.dtype == torch.bfloat16
    assert str(want.dtype) == "bfloat16"
    assert abs(float(got.float().std()) - 0.02) < 1e-3
    assert abs(float(got.float().mean())) < 1e-3
    again = draw(torch.Generator().manual_seed(0), 2, 300, 64,
                 dtype=torch.float32)
    assert again.dtype == torch.float32
    assert torch.equal(again.bfloat16(), got)
