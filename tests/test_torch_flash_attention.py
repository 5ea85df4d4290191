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
