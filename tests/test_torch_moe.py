"""The port's MoE FFN, per-head q/k norm and cross attention against the
JAX reference's, on the CPU, on the same seeded numpy inputs and the
reference's own weights.

Tolerances (atol = rtol): 1e-5 for f32 outputs and the aux loss (the
products sum in another order than XLA's); bf16 outputs 1.6e-2, two bf16
ulps (2**-6), where torch and XLA round the f32 scores once, at other
places.  Router choices (which experts, and which tokens overflow an
expert's capacity) must be equal, not close.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, layers, moe  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -6
MOE_ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _pair(arch, overrides=None, dtype=jnp.float32):
    """(reference cfg, port cfg, reference params, port params) of one moe
    layer's FFN, the reference's weights carried across."""
    overrides = overrides or {}
    rcfg = dataclasses.replace(ref_config(arch, reduced=True), **overrides)
    cfg = dataclasses.replace(get_config(arch, reduced=True), **overrides)
    rp = ref_layers.init_params(ref_moe.moe_spec(rcfg),
                                jax.random.PRNGKey(1), dtype)
    p = params_from_reference(moe.moe_spec(cfg),
                              jax.tree_util.tree_map(np.asarray, rp), "cpu")
    return rcfg, cfg, rp, p


def _both(arch, x, *, overrides=None, router=None):
    """Run the reference's and the port's ``moe_ffn`` on x (numpy f32),
    with an optional router (numpy) in place of the drawn one."""
    rcfg, cfg, rp, p = _pair(arch, overrides)
    if router is not None:
        rp = dict(rp, router=jnp.asarray(router))
        p = dict(p, router=torch.from_numpy(router))
    want, waux = ref_moe.moe_ffn(rp, jnp.asarray(x), rcfg)
    got, aux = moe.moe_ffn(p, torch.from_numpy(x), cfg)
    return (got, aux), (want, waux)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_the_reference_f32(arch):
    """qwen2-moe: a shared expert, no top-k norm; qwen3-moe: top-k norm."""
    cfg = get_config(arch, reduced=True)
    assert bool(cfg.shared_expert_d_ff) == (arch == "qwen2-moe-a2.7b")
    assert cfg.norm_topk_prob == (arch == "qwen3-moe-235b-a22b")
    x = np.random.default_rng(0).standard_normal((2, 24, cfg.d_model)) \
        .astype(np.float32)
    (got, aux), (want, waux) = _both(arch, x)
    assert tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(float(aux), float(waux), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_tied_router_columns_pick_the_reference_experts(arch):
    """Experts 3 and 5 share one router column, so every token sees them
    tied; expert 0's column is twice theirs and the rest are zero, so a
    token with x.v > 0 ties 3 and 5 for its second slot and one with
    x.v < 0 ties the five zero-logit experts for both slots.  jax's
    ``top_k`` takes the lower index first; so must the port."""
    cfg = get_config(arch, reduced=True)
    rng = np.random.default_rng(1)
    v = rng.standard_normal(cfg.d_model).astype(np.float32) * 0.1
    router = np.zeros((cfg.d_model, cfg.num_experts), np.float32)
    router[:, 0], router[:, 3], router[:, 5] = 2 * v, v, v
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    s = x.reshape(-1, cfg.d_model) @ v
    assert (s > 0).any() and (s < 0).any()
    (got, aux), (want, waux) = _both(arch, x, router=router)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(float(aux), float(waux), atol=F32_TOL,
                               rtol=F32_TOL)
    # the choices themselves, equal
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, cfg.d_model) @ router),
                           axis=-1)
    _, ridx = jax.lax.top_k(probs, cfg.experts_per_tok)
    _, idx = moe.top_k(torch.from_numpy(np.array(probs)),
                       cfg.experts_per_tok)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    assert {tuple(r) for r in np.asarray(ridx).tolist()} >= {(0, 3), (1, 2)}


def test_top_k_breaks_ties_as_jax_does():
    """Probabilities on a coarse grid (many ties in every row): the same
    indices and values as ``jax.lax.top_k``, for every k."""
    rng = np.random.default_rng(2)
    probs = (rng.integers(0, 4, (64, 60)) / 4.0).astype(np.float32)
    for k in (1, 2, 4, 8, 60):
        rv, ri = jax.lax.top_k(jnp.asarray(probs), k)
        v, i = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_overflow_drops_the_reference_tokens(arch):
    """Every token's first choice is expert 2, far past its capacity (48
    tokens, C = 16): the tokens the port drops there are the reference's,
    found as the rows that differ from a run whose capacity holds them
    all."""
    cfg = get_config(arch, reduced=True)
    rng = np.random.default_rng(3)
    router = rng.standard_normal((cfg.d_model, cfg.num_experts)) \
        .astype(np.float32) * 0.01
    router[:, 2] = 1.0
    x = np.abs(rng.standard_normal((2, 24, cfg.d_model))).astype(np.float32)
    T = 48
    assert moe._capacity(T, cfg) == ref_moe._capacity(T, cfg) == 16
    (got, _), (want, _) = _both(arch, x, router=router)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
    roomy = {"capacity_factor": 8.0}    # C = 96: no token dropped
    (got_all, _), (want_all, _) = _both(arch, x, overrides=roomy,
                                        router=router)

    def dropped(out, full):
        diff = np.abs(_f32(out) - _f32(full)).reshape(T, -1).max(axis=1)
        return np.flatnonzero(diff > 1e-3).tolist()
    mine = dropped(got, got_all)
    assert mine == dropped(want, want_all)
    assert len(mine) == T - 16        # every token past the first 16


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32_TOL),
                                       (jnp.bfloat16, 0.0)])
def test_head_rms_norm_matches_the_reference(dtype, tol):
    """Normalizes each head's hd values with the ``1 + w`` scale; bf16 is
    bit-equal (both compute in f32 and round once)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    w = rng.standard_normal(16).astype(np.float32) * 0.1
    want = ref_layers.head_rms_norm(jnp.asarray(x).astype(dtype),
                                    jnp.asarray(w).astype(dtype), 1e-6)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = layers.head_rms_norm(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(w).to(tdt), 1e-6)
    assert got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32_TOL),
                                       (jnp.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("heads,kv", [(4, 4), (4, 2), (6, 6)])
def test_cross_attention_matches_the_reference(dtype, tol, heads, kv):
    """Unmasked GQA attention of 5 queries over a memory of 24 frames (q
    and kv lengths differ, as in the whisper decoder)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 5, heads, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, kv, 16)).astype(np.float32)
            for _ in range(2))
    want = ref_attn.cross_attention(*(jnp.asarray(a).astype(dtype)
                                      for a in (q, k, v)))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = attention.cross_attention(*(torch.from_numpy(a).to(tdt)
                                      for a in (q, k, v)))
    assert tuple(got.shape) == q.shape and got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_qkv_project_normalizes_q_and_k_before_rope():
    """qwen3's per-head q/k norm in the projection, then rope, against the
    reference's ``qkv_project`` with its own weights."""
    rcfg = ref_config("qwen3-moe-235b-a22b", reduced=True)
    cfg = get_config("qwen3-moe-235b-a22b", reduced=True)
    assert cfg.qk_norm
    rp = ref_layers.init_params(ref_attn.attn_spec(rcfg),
                                jax.random.PRNGKey(2), jnp.float32)
    rp = dict(rp, q_norm=rp["q_norm"] + 0.3, k_norm=rp["k_norm"] - 0.2)
    p = params_from_reference(attention.attn_spec(cfg),
                              jax.tree_util.tree_map(np.asarray, rp), "cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32), (2, 1)) + 3
    want = ref_attn.qkv_project(rp, jnp.asarray(x), rcfg, jnp.asarray(pos))
    got = attention.qkv_project(p, torch.from_numpy(x), cfg,
                                torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL,
                                   rtol=F32_TOL)
