"""The port's RG-LRU scan against the JAX reference, on the CPU.

The same numpy inputs go through the JAX Pallas kernel (interpret mode, at
the block sizes of tests/test_kernels.py), the JAX oracle ``rglru_ref``
(an associative scan) and the port's ``rglru_scan``, which on a CPU tensor
is its plain version (a loop over S with an f32 carry).  Tolerances are the
reference's own: 1e-4 in f32 (the two sum in another order), 3e-2 in bf16
(h is rounded to bf16).  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it against the plain version there).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rg_lru.ops import rglru_scan as ref_scan  # noqa: E402
from repro.kernels.rg_lru.ref import rglru_ref  # noqa: E402
from repro_torch.kernels.rg_lru.kernel import rglru_scan_kernel  # noqa: E402
from repro_torch.kernels.rg_lru.ops import rglru_scan  # noqa: E402
from repro_torch.kernels.rg_lru.ref import rglru_scan_ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(B, S, W, seed=0):
    """a in (0, 0.98) and b about 0.1, as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    a = 0.98 / (1 + np.exp(-rng.standard_normal((B, S, W))))
    b = rng.standard_normal((B, S, W)) * 0.1
    return a.astype(np.float32), b.astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,W,bs,bw", [
    (2, 128, 64, 32, 32),
    (1, 256, 128, 64, 128),
    (3, 64, 32, 64, 32),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_matches_the_reference(B, S, W, bs, bw, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    a, b = _inputs(B, S, W)
    ja, jb = (jnp.asarray(x).astype(jdt) for x in (a, b))
    want_kernel = ref_scan(ja, jb, block_s=bs, block_w=bw, interpret=True)
    want_oracle = rglru_ref(ja, jb)
    h, last = rglru_scan(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
    assert h.dtype == tdt and last.dtype == tdt
    assert tuple(h.shape) == (B, S, W) and tuple(last.shape) == (B, W)
    assert torch.equal(last, h[:, -1])
    for want_h, want_last in (want_kernel, want_oracle):
        _close(h, want_h, tol)
        _close(last, want_last, tol)


@pytest.mark.parametrize("B,S,W", [
    (4, 48, 64),      # the reduced recurrentgemma's prompt: not a block multiple
    (2, 77, 100),
    (3, 1, 33),       # one step
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ragged_s_and_w_match_the_oracle(B, S, W, dtype):
    """The Pallas kernel asserts S % block_s == 0; the port takes any S
    and W, as serve's prompts need."""
    jdt, tdt, tol = DTYPES[dtype]
    a, b = _inputs(B, S, W, seed=1)
    want_h, want_last = rglru_ref(*(jnp.asarray(x).astype(jdt) for x in (a, b)))
    h, last = rglru_scan(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
    _close(h, want_h, tol)
    _close(last, want_last, tol)


def test_a_cpu_tensor_takes_the_plain_version():
    """ops sends a CPU tensor to the plain version: the same bits, and the
    kernel's launch count does not move."""
    from repro_torch.kernels.rg_lru import kernel as rk
    a, b = (torch.from_numpy(x) for x in _inputs(2, 40, 24))
    before = rk.LAUNCHES["rglru_scan"]
    got = rglru_scan(a, b)
    want = rglru_scan_ref(a, b)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert rk.LAUNCHES["rglru_scan"] == before
    # the recurrence itself, one step at a time in f32
    h = torch.zeros(2, 24)
    for t in range(40):
        h = a[:, t] * h + b[:, t]
        assert torch.equal(got[0][:, t], h)


def test_a_cuda_tensor_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a, b = (torch.from_numpy(x) for x in _inputs(1, 16, 8))
    with pytest.raises((RuntimeError, AssertionError)):
        rglru_scan(a.to("cuda"), b.to("cuda"))
    # the kernel's wrapper takes CUDA tensors only, and says so
    with pytest.raises(ValueError, match="CUDA tensor"):
        rglru_scan_kernel(a, b)


@pytest.mark.parametrize("a_shape,b_shape,a_dtype,b_dtype,exc,match", [
    ((2, 8), (2, 8), torch.float32, torch.float32, ValueError,
     r"expected \(B,S,W\)"),
    ((2, 0, 8), (2, 0, 8), torch.float32, torch.float32, ValueError, "S >= 1"),
    ((2, 8, 4), (2, 8, 4), torch.float16, torch.float16, TypeError,
     "the kernel takes"),
    ((2, 8, 4), (2, 8, 4), torch.float32, torch.bfloat16, TypeError,
     "the kernel takes"),
    ((2, 8, 4), (2, 8, 5), torch.float32, torch.float32, ValueError,
     r"shape \(2, 8, 5\)"),
    ((2, 8, 4), (2, 8, 4), torch.float32, torch.float32, ValueError,
     "expected a CUDA tensor"),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(
        a_shape, b_shape, a_dtype, b_dtype, exc, match):
    """Rank, S, dtype and shape are checked before the device, so each
    refusal shows here on CPU tensors; the last case is the device."""
    a = torch.zeros(a_shape, dtype=a_dtype)
    b = torch.zeros(b_shape, dtype=b_dtype)
    with pytest.raises(exc, match=match):
        rglru_scan_kernel(a, b)
