"""The port's flash attention, forward and backward, against the JAX
reference, on the CPU.

The same numpy inputs go through the JAX Pallas kernel (interpret mode,
64x64 blocks, as tests/test_kernels.py runs it), the JAX oracle and the
port's ``flash_attention``, which on a CPU tensor is its plain version.
The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as ref_oracle  # noqa: E402
from repro.models.attention import full_causal_attention  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    HEAD_DIMS, flash_attention_bwd_kernel, flash_attention_kernel,
)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_lse_ref, attention_ref,
)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, H, KV, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)))


def _f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


@pytest.mark.parametrize("B,H,KV,S,hd,causal", [
    (1, 4, 4, 128, 64, True),      # MHA
    (2, 8, 2, 256, 64, True),      # GQA 4:1
    (1, 8, 1, 128, 128, True),     # MQA
    (1, 6, 6, 192, 32, True),      # non-pow2 heads/seq
    (1, 2, 2, 128, 32, False),     # non-causal
    (4, 4, 2, 48, 16, True),       # the reduced yi-6b's prefill: S=48, hd=16
    (4, 4, 1, 48, 16, True),       # the reduced recurrentgemma's: MQA
    (1, 4, 1, 128, 256, True),     # recurrentgemma's head dim, 256
    (2, 4, 2, 128, 160, True),     # stablelm-12b's head dim, 160
    (1, 2, 2, 64, 160, False),     # hd 160, full attention
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_matches_the_reference(B, H, KV, S, hd, causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(B, H, KV, S, hd)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want_kernel = ref_flash(jq, jk, jv, causal=causal, interpret=True,
                            block_q=64, block_k=64)
    want_oracle = ref_oracle(jq, jk, jv, causal=causal)
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == (B, H, S, hd)
    for want in (want_kernel, want_oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_a_cuda_tensor_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 16, 16))
    with pytest.raises((RuntimeError, AssertionError)):
        flash_attention(q.to("cuda"), k.to("cuda"), v.to("cuda"))
    # the kernel's wrapper takes CUDA tensors only, and says so
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_kernel(q, k, v)


@pytest.mark.parametrize("shape,match", [
    ((1, 2, 2, 16, 24), "head dim 24"),
    ((1, 3, 2, 16, 16), "do not group"),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(shape, match):
    B, H, KV, S, hd = shape
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, H, KV, S, hd))
    with pytest.raises(ValueError, match=match):
        flash_attention_kernel(q, k, v)


# -- the CUDA bf16 route's rounding, emulated on the CPU ----------------------

SMOKE_BF16_TOL = 8e-3     # chip_smoke.py: the bf16 kernel against plain_f32


def tensor_core_emulation(q, k, v, *, causal=True):
    """The bf16 route of ``csrc/flash_attention.cu`` in plain PyTorch, with
    its rounding: f32 scores of the bf16 inputs (exact products, f32 sums)
    scaled into the exp2 domain, an online softmax over kv tiles of 64 rows
    (32 at hd 256), P rounded to bf16 after the row max, l summed from the
    rounded P, P.V summed in f32, the output rounded to bf16 at the end."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    bk = 32 if hd == 256 else 64
    scale_log2 = float(np.float32(hd ** -0.5) * np.float32(np.log2(np.e)))
    qf = q.float().reshape(B, KV, H // KV, S, hd)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    rows = torch.arange(S)[:, None]
    m = torch.full((B, KV, H // KV, S, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, S, bk):
        s = (qf @ kf[..., k0:k0 + bk, :].transpose(-1, -2)) * scale_log2
        if causal:
            keys = torch.arange(k0, min(k0 + bk, S))[None, :]
            s = torch.where(keys <= rows, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new).to(torch.bfloat16).float()
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p @ vf[..., k0:k0 + bk, :]
        m = m_new
    return (acc / l.clamp_min(1e-30)).reshape(B, H, S, hd).to(q.dtype)


def _plain_f32(q, k, v, causal):
    """chip_smoke.py's yardstick for the kernel: the plain version on the
    bf16 values widened to f32, rounded to bf16 at the end."""
    return flash_attention(q.float(), k.float(), v.float(),
                           causal=causal).to(q.dtype)


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (1, 8, 1, 1024, 128),      # GQA 8:1 at yi-6b's head dim
    (1, 4, 1, 1024, 256),      # MQA at recurrentgemma's head dim
    (1, 8, 2, 512, 160),       # GQA 4:1 at stablelm-12b's head dim
])
def test_tensor_core_rounding_matches_the_reference(B, H, KV, S, hd):
    """P rounded to bf16 (the design's one new rounding) stays within the
    bf16 tolerances: 2e-2 against the Pallas kernel (interpret mode) and the
    oracle, and chip_smoke.py's 8e-3 against the plain version in f32."""
    q, k, v = _inputs(B, H, KV, S, hd, seed=3)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tensor_core_emulation(tq, tk, tv)
    want_kernel = ref_flash(jq, jk, jv, causal=True, interpret=True,
                            block_q=128, block_k=128)
    want_oracle = ref_oracle(jq, jk, jv, causal=True)
    for want in (want_kernel, want_oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_f32(got), _f32(_plain_f32(tq, tk, tv, True)),
                               atol=SMOKE_BF16_TOL, rtol=SMOKE_BF16_TOL)


@pytest.mark.parametrize("B,H,KV,S,hd,causal", [
    (1, 4, 2, 1, 128, True),       # one key
    (2, 16, 1, 17, 256, True),     # under one tile, H/KV = 16
    (1, 4, 2, 200, 128, False),    # ragged, full attention
    (1, 4, 1, 97, 256, True),      # ragged against the 32-row kv tile
    (2, 4, 2, 17, 160, True),      # hd 160 under one tile, H/KV = 2
    (1, 4, 2, 97, 160, False),     # hd 160 ragged against the 64-row tiles
])
def test_tensor_core_rounding_on_the_smoke_edges(B, H, KV, S, hd, causal):
    """The emulation at chip_smoke.py's edge shapes, within its tolerance of
    the plain version in f32 and 2e-2 of the oracle."""
    q, k, v = _inputs(B, H, KV, S, hd, seed=4)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tensor_core_emulation(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_f32(got),
                               _f32(_plain_f32(tq, tk, tv, causal)),
                               atol=SMOKE_BF16_TOL, rtol=SMOKE_BF16_TOL)
    want = ref_oracle(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                      causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)


# -- the backward: the plain formulas the CUDA backward kernel implements ----

# f32, relative to the largest gradient entry of the call (dq, dk, dv): at
# S = 1 dq is exactly 0 in jax and a rounding residue of 1e-8 here
BWD_TOL = 1e-5

BWD_CASES = [(2, 8, 2, 40, 64, True),       # GQA 4:1
             (1, 4, 1, 33, 32, True),       # MQA, ragged S
             (1, 4, 4, 24, 16, False),      # unmasked
             (2, 6, 3, 17, 128, False),     # GQA 2:1, unmasked, ragged
             (1, 2, 2, 1, 64, True)]        # one row
BWD_CASES += [(1, 4, 2, 20, hd, True) for hd in HEAD_DIMS]


def _bwd_inputs(B, H, KV, S, hd, seed=6):
    q, k, v = _inputs(B, H, KV, S, hd, seed=seed)
    do = np.random.default_rng(seed + 1).standard_normal(
        (B, H, S, hd)).astype(np.float32)
    return q, k, v, do


def _close_scaled(got, want, atol, what=""):
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                               rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("B,H,KV,S,hd,causal", BWD_CASES)
def test_attention_bwd_ref_matches_jax_vjp_of_the_reference(B, H, KV, S, hd,
                                                            causal):
    """dq/dk/dv of ``attention_bwd_ref`` (the kernel's formulas, from the
    output and the row log-sum-exp) against ``jax.vjp`` of the reference's
    oracle and, when causal, of ``full_causal_attention`` (the function the
    reference's training differentiates); the port's autograd through its
    plain forward too.  f32, within 1e-5 of the largest gradient entry."""
    q, k, v, do = _bwd_inputs(B, H, KV, S, hd)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    fns = [lambda a, b, c: ref_oracle(a, b, c, causal=causal)]
    if causal:
        fns.append(lambda a, b, c: jnp.swapaxes(full_causal_attention(
            *(jnp.swapaxes(t, 1, 2) for t in (a, b, c))), 1, 2))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    lse = attention_lse_ref(tq, tk, causal=causal)
    o = flash_attention(tq, tk, tv, causal=causal)
    got = attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    flash_attention(*leaves, causal=causal).backward(tdo)
    for fn in fns:
        out, vjp = jax.vjp(fn, jq, jk, jv)
        np.testing.assert_allclose(_f32(o), np.asarray(out), atol=1e-5,
                                   rtol=1e-5)
        want = vjp(jdo)
        atol = BWD_TOL * max(float(jnp.abs(w).max()) for w in want)
        for name, g, a, w in zip("qkv", got, leaves, want):
            _close_scaled(g, w, atol, f"d{name}")
            _close_scaled(a.grad, w, atol, f"autograd d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_lse_is_the_natural_log_sum_exp_of_the_scaled_scores(causal):
    """What the forward kernel writes for the backward: per row, the
    natural-log log-sum-exp of the hd^-0.5-scaled, masked scores (the
    reference's oracle's, computed in jax); padded rows carry none."""
    B, H, KV, S, hd = 1, 4, 2, 37, 64
    q, k, _ = _inputs(B, H, KV, S, hd)
    s = jnp.einsum("bkgqh,bksh->bkgqs",
                   jnp.asarray(q).reshape(B, KV, H // KV, S, hd),
                   jnp.asarray(k)) * (hd ** -0.5)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((S, S), bool)), s, -1e30)
    want = jax.nn.logsumexp(s, axis=-1).reshape(B, H, S)
    got = attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                            causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_the_masked_entries_get_no_gradient():
    """Keys above the diagonal add nothing: perturbing the last key and
    value moves every row's gradient except the last query's, never dq of
    the rows that cannot see it."""
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(1, 2, 1, 9, 16))
    lse = attention_lse_ref(q, k)
    o = attention_ref(q, k, v)
    dq, dk, dv = attention_bwd_ref(q, k, v, o, lse, do)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, -1] += 1.0
    v2[:, :, -1] -= 1.0
    o2 = attention_ref(q, k2, v2)
    dq2, _, _ = attention_bwd_ref(q, k2, v2, o2, attention_lse_ref(q, k2), do)
    assert torch.equal(dq[:, :, :-1], dq2[:, :, :-1])
    assert not torch.equal(dq[:, :, -1], dq2[:, :, -1])


def test_bwd_wrapper_refuses_what_its_kernel_does_not_take():
    B, H, KV, S, hd = 1, 2, 2, 16, 16
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(B, H, KV, S, hd))
    lse = torch.zeros((B, H, S))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_bwd_kernel(q, k, v, q, lse, do)
    q24 = torch.zeros((B, H, S, 24))
    with pytest.raises(ValueError, match="head dim 24"):
        flash_attention_bwd_kernel(q24, q24, q24, q24, lse, q24)
