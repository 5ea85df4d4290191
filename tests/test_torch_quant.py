"""The PyTorch port's block-wise int8 quantizer against the JAX reference.

q must be equal and scales within rtol 1e-6 (the tolerance of
tests/test_kernels.py); in fact they are equal, because the port follows the
reference's rounding: IEEE division for x / scale, and amax * f32(1/127) for
the scale, which is what XLA makes of amax / 127.  q feeds the chunk keys, so
equality is what the shared chunk store needs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.quant_blockwise import ops as J  # noqa: E402
from repro_torch.kernels.quant_blockwise import kernel as TK  # noqa: E402
from repro_torch.kernels.quant_blockwise import ops as T  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, name: str):
    jd, td = DTYPES[name]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _bits(a) -> np.ndarray:
    """Any float array as unsigned ints of its width (bf16 via int16)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _assert_same_values(got, want):
    """Bit-equal, except that any NaN matches any NaN: 0 * inf in an inf
    block is NaN, and NaN payload bits differ between implementations."""
    gb, wb = _bits(got), _bits(want)
    gnan = np.isnan(got.float().numpy())
    wnan = np.isnan(np.asarray(want, np.float32))
    np.testing.assert_array_equal(gnan, wnan)
    np.testing.assert_array_equal(gb[~wnan], wb[~wnan])


@pytest.mark.parametrize("shape", [(33, 77), (1024,), (5, 5, 5), (3000,)])
@pytest.mark.parametrize("name", list(DTYPES))
def test_quantize_and_dequantize_match_reference(shape, name):
    x = np.random.default_rng(sum(shape)).standard_normal(shape)
    x = (x * 10).astype(np.float32)
    xj, xt = _both(x, name)
    qj, sj = J.quantize(xj, impl="xla")
    qt, st = T.quantize(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    np.testing.assert_array_equal(_bits(st), _bits(sj))
    yj = J.dequantize(qj, sj, shape, DTYPES[name][0], impl="xla")
    yt = T.dequantize(qt, st, shape, DTYPES[name][1])
    assert tuple(yt.shape) == shape
    _assert_same_values(yt, yj)


@pytest.mark.parametrize("name", list(DTYPES))
def test_nan_and_inf_blocks_match_reference(name):
    x = np.random.default_rng(4).standard_normal((6, 1024)).astype(np.float32)
    x[0, 5] = np.nan          # amax is NaN -> scale 1.0, the NaN -> 0
    x[1, 7] = np.inf          # scale inf -> every q 0
    x[2, 9] = -np.inf
    x[3] = np.round(x[3] * 50)  # ties at scale 1 after the next line
    x[3, 0] = 127.0
    x[4] = 0.0                # amax 0 -> scale 1.0
    xj, xt = _both(x, name)
    qj, sj = J.quantize(xj, impl="xla")
    qt, st = T.quantize(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st), _bits(sj))
    assert float(st[0]) == 1.0 and np.isinf(float(st[1]))
    assert int(qt[0, 5]) == 0 and not qt[1].any()
    yj = J.dequantize(qj, sj, (6, 1024), DTYPES[name][0], impl="xla")
    _assert_same_values(T.dequantize(qt, st, (6, 1024), DTYPES[name][1]), yj)


def test_scale_rounds_as_the_reference_does():
    # amax 9: 9 / 127 in IEEE f32 is one ulp above 9 * f32(1/127), which
    # is what the reference computes
    x = np.arange(10.0, dtype=np.float32)
    _qj, sj = J.quantize(jnp.asarray(x), impl="xla")
    _qt, st = T.quantize(torch.from_numpy(x))
    assert _bits(st)[0] == _bits(sj)[0]
    ieee = np.array([np.float32(9) / np.float32(127)])
    assert _bits(sj)[0] != _bits(ieee)[0]


def test_float64_input_is_narrowed_like_the_reference():
    x = np.random.default_rng(8).standard_normal(2500) * 1e3
    qj, sj = J.quantize(jnp.asarray(x), impl="xla")     # x64 off: f32
    qt, st = T.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st), _bits(sj))


@pytest.mark.parametrize("name", list(DTYPES))
def test_matches_reference_pallas_kernels_in_interpret_mode(name):
    x = np.random.default_rng(6).standard_normal((3, 1024)).astype(np.float32)
    xj, xt = _both(x, name)
    qj, sj = J.quantize(xj, interpret=True)
    qt, st = T.quantize(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    yj = J.dequantize(qj, sj, (3, 1024), DTYPES[name][0], interpret=True)
    _assert_same_values(T.dequantize(qt, st, (3, 1024), DTYPES[name][1]), yj)


def test_kernel_wrappers_reject_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.quantize_kernel(torch.zeros((2, 1024)))
    with pytest.raises(ValueError, match="1024"):
        TK.quantize_kernel(torch.zeros((2, 100)))
    with pytest.raises(TypeError, match="dequantize writes"):
        TK.dequantize_kernel(torch.zeros((2, 1024), dtype=torch.int8),
                             torch.ones(2), torch.float16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TK.dequantize_kernel(torch.zeros((2, 1024), dtype=torch.int8),
                             torch.ones(2))
