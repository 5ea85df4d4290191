"""The port's Griffin pieces against the JAX reference, on the CPU: the
recurrent mixer (prefill and one decode step), the RG-LRU step, banded
local attention, the ring-buffer window decode and its cache write, the
``lambda`` init rule and the linear causal conv.

Weights and inputs are drawn with numpy (or by the reference's own init)
and handed to both packages.  Tolerances: f32 1e-5 (atol = rtol) where the
two compute the same sums in the same order, 1e-4 where the prefill scan
sums in another order (the reference's associative scan, the port's loop);
bf16 3e-2 (one or two bf16 ulps of values near 1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import griffin as ref_griffin  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, griffin, layers  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

ARCH = "recurrentgemma-9b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def _mixer(dtype, seed=0):
    """The reference's RG-LRU mixer weights (its own init) and the port's
    copy of them."""
    rcfg = ref_config(ARCH, reduced=True)
    spec = ref_griffin.rglru_spec(rcfg)
    params = ref_layers.init_params(spec, jax.random.PRNGKey(seed), dtype)
    ported = params_from_reference(griffin.rglru_spec(get_config(ARCH, True)),
                                   jax.tree_util.tree_map(np.asarray, params),
                                   "cpu")
    return rcfg, params, ported


def _x(shape, jdt, tdt, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("S", [48, 64, 1])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_recurrent_forward_prefill_matches_the_reference(S, dtype):
    jdt, tdt = DTYPES[dtype]
    rcfg, rp, pp = _mixer(jdt)
    xj, xt = _x((2, S, rcfg.d_model), jdt, tdt)
    want, (wconv, wlru) = ref_griffin.recurrent_forward(rp, xj, rcfg)
    got, (gconv, glru) = griffin.recurrent_forward(pp, xt, get_config(ARCH, True))
    assert got.dtype == tdt and glru.dtype == tdt
    tol = 1e-4 if dtype == "float32" else 3e-2
    for g, w in ((got, want), (gconv, wconv), (glru, wlru)):
        assert tuple(g.shape) == w.shape
        _close(g, w, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_recurrent_forward_decode_step_matches_the_reference(dtype):
    """One decode step from cached conv and LRU states."""
    jdt, tdt = DTYPES[dtype]
    rcfg, rp, pp = _mixer(jdt, seed=2)
    W, C = rcfg.lru_width, rcfg.conv_width
    xj, xt = _x((3, 1, rcfg.d_model), jdt, tdt, seed=3)
    cj, ct = _x((3, C - 1, W), jdt, tdt, seed=4)
    lj, lt = _x((3, W), jdt, tdt, seed=5)
    want, (wconv, wlru) = ref_griffin.recurrent_forward(
        rp, xj, rcfg, conv_state=cj, lru_state=lj, decode=True)
    got, (gconv, glru) = griffin.recurrent_forward(
        pp, xt, get_config(ARCH, True), conv_state=ct, lru_state=lt,
        decode=True)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for g, w in ((got, want), (gconv, wconv), (glru, wlru)):
        assert tuple(g.shape) == w.shape
        _close(g, w, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rglru_step_matches_the_reference_and_continues_the_scan(dtype):
    jdt, tdt = DTYPES[dtype]
    rcfg, rp, pp = _mixer(jdt, seed=6)
    xj, xt = _x((2, 9, rcfg.lru_width), jdt, tdt, seed=7)
    sj, st = _x((2, rcfg.lru_width), jdt, tdt, seed=8)
    want = ref_griffin.rglru_step(rp, xj[:, :1], sj)
    got = griffin.rglru_step(pp, xt[:, :1], st)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for g, w in zip(got, want):
        _close(g, w, tol)
    if dtype == "float32":   # eight steps from zero equal the prefill scan
        h, last = griffin.rglru_scan(pp, xt[:, :8])
        state = torch.zeros_like(st)
        for t in range(8):
            y, state = griffin.rglru_step(pp, xt[:, t:t + 1], state)
            _close(y[:, 0], h[:, t], 1e-6)
        _close(state, last, 1e-6)


def test_gelu_is_the_reference_tanh_approximation_bit_for_bit():
    """The gate's GeLU is ``jax.nn.gelu``'s default, the tanh
    approximation, not the erf form; in bf16 the port rounds as the
    reference does (its constants in bf16), bit for bit."""
    x = np.random.default_rng(9).standard_normal(50_000).astype(np.float32) * 3
    xb = torch.from_numpy(x).bfloat16()
    want = _f32(jax.nn.gelu(jnp.asarray(x).astype(jnp.bfloat16)))
    np.testing.assert_array_equal(_f32(griffin.gelu_tanh(xb)), want)
    want32 = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got32 = griffin.gelu_tanh(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got32, want32, atol=1e-6, rtol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want32).max() > 1e-4


@pytest.mark.parametrize("S,window", [(64, 32), (96, 32), (32, 16)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_banded_local_attention_matches_the_reference(S, window, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(10)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, S, 4, 16), (2, S, 1, 16), (2, S, 1, 16)))
    want = ref_attn.banded_local_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), window=window)
    got = attention.banded_local_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), window=window)
    _close(got, want, 1e-5 if dtype == "float32" else 2e-2)
    with pytest.raises(ValueError, match="not a multiple of the window"):
        attention.banded_local_attention(
            *(torch.from_numpy(a[:, :S - 1]) for a in (q, k, v)), window=window)


def test_banded_attention_is_causal_within_the_window():
    """Token i sees keys (i - window, i]: the band of the full causal
    attention with the older keys masked."""
    rng = np.random.default_rng(11)
    S, W = 64, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((1, S, 2, 8)).astype(
        np.float32)) for _ in range(3))
    got = attention.banded_local_attention(q, k, v, window=W)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 8 ** -0.5
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    s = s.masked_fill(~((j <= i) & (j > i - W)), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("slots,window,positions", [
    (8, 8, [3, 8, 13]),       # a ring of the window: before and after a wrap
    (8, 8, [0, 7, 31]),
    (5, 8, [4, 5, 9]),        # a cache shorter than the window (cache_len < W)
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_window_decode_and_write_match_the_reference(slots, window, positions,
                                                     dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(12)
    B = len(positions)
    kc, vc = (rng.standard_normal((B, 1, slots, 16)).astype(np.float32)
              for _ in range(2))
    nk, nv = (rng.standard_normal((B, 1, 1, 16)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((B, 1, 4, 16)).astype(np.float32)
    pos = np.array(positions, np.int32)
    jk, jv = ref_attn.cache_write_window(
        *(jnp.asarray(a).astype(jdt) for a in (kc, vc, nk, nv)),
        jnp.asarray(pos))
    tk, tv = attention.cache_write_window(
        *(torch.from_numpy(a.copy()).to(tdt) for a in (kc, vc, nk, nv)),
        torch.from_numpy(pos))
    np.testing.assert_array_equal(_f32(tk), _f32(jk))
    np.testing.assert_array_equal(_f32(tv), _f32(jv))
    want = ref_attn.decode_attention_window(
        jnp.asarray(q).astype(jdt), jk, jv, jnp.asarray(pos), window=window)
    got = attention.decode_attention_window(
        torch.from_numpy(q).to(tdt), tk, tv, torch.from_numpy(pos),
        window=window)
    _close(got, want, 1e-5 if dtype == "float32" else 2e-2)


def test_lambda_init_follows_the_reference_rule():
    """a = sigmoid(Lambda)^8 lies in [0.9, 0.999], as the reference's
    rule draws it, for the port's own init (stacked on the groups axis)."""
    from repro_torch.models import LM
    lm = LM(get_config(ARCH, reduced=True), device="cpu")
    params = lm.init(torch.Generator().manual_seed(0), torch.float32)
    lam = params["decoder"]["groups"]["b0_rec"]["mixer"]["lambda_p"]
    assert tuple(lam.shape) == (1, 64)
    a = torch.sigmoid(lam) ** 8
    assert float(a.min()) >= 0.9 - 1e-5 and float(a.max()) <= 0.999 + 1e-5
    assert float(a.max() - a.min()) > 0.05                  # spread, not one value
    p = layers.P((4096,), ("lru",), init="lambda")
    mine = layers.materialize(p, torch.Generator().manual_seed(1),
                              torch.float32, "cpu")
    theirs = np.asarray(ref_layers._materialize(p, jax.random.PRNGKey(1),
                                                jnp.float32))
    # different generators: compare the distributions of a
    qs = [0.1, 0.5, 0.9]
    a_mine = (torch.sigmoid(mine) ** 8).numpy()
    a_theirs = (1 / (1 + np.exp(-theirs))) ** 8
    np.testing.assert_allclose(np.quantile(a_mine, qs),
                               np.quantile(a_theirs, qs), atol=5e-3)


@pytest.mark.parametrize("activation", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_activation_flag_matches_the_reference(activation,
                                                            with_state):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((12, 4)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    wy, ws = ref_layers.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w),
        None if st is None else jnp.asarray(st), activation=activation)
    gy, gs = layers.causal_conv1d(
        torch.from_numpy(x), torch.from_numpy(w),
        None if st is None else torch.from_numpy(st), activation=activation)
    _close(gy, wy, 1e-6)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    if not activation:        # linear: scaling the input scales the output
        gy2, _ = layers.causal_conv1d(2 * torch.from_numpy(x),
                                      torch.from_numpy(w), None,
                                      activation=False)
        if st is None:
            torch.testing.assert_close(gy2, 2 * gy)
