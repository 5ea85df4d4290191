"""The port's flash attention against the JAX reference, on the CPU.

The same numpy inputs go through the JAX Pallas kernel (interpret mode,
64x64 blocks, as tests/test_kernels.py runs it), the JAX oracle and the
port's ``flash_attention``, which on a CPU tensor is its plain version.
The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as ref_oracle  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402

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
