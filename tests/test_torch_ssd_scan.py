"""The port's SSD scan against the JAX reference, on the CPU.

The same numpy inputs go through the JAX Pallas kernel (interpret mode) and
the JAX oracle ``ssd_ref``, and through the port's ``ssd_scan`` (its
pre-arrangement, then on a CPU tensor the kernel's plain version), padded
to whole chunks as the port's model pads where S is ragged.  Tolerances are the reference's own
(tests/test_kernels.py): 5e-4 in f32, 1.5e-1 in bf16, where long chunks'
decay chains accumulate rounding.  The CUDA kernel itself runs only on the
card (``chip_smoke.py`` holds it against the plain version there).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ops import ssd_scan as ref_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import arrange, ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models.ssm import pad_to_chunk  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 5e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1.5e-1)}


def _inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S, H)) - 1, 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bi = rng.standard_normal((B, S, N)).astype(np.float32)
    Ci = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bi, Ci


def _both(arrays, jdt, tdt):
    """(jax args, torch args): x, B and C in the dtype, dt and A in f32."""
    x, dt, A, Bi, Ci = arrays
    j = (jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(Bi).astype(jdt), jnp.asarray(Ci).astype(jdt))
    t = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(A),
         torch.from_numpy(Bi).to(tdt), torch.from_numpy(Ci).to(tdt))
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


SHAPES = [
    (2, 128, 4, 16, 32, 32),
    (1, 256, 2, 64, 128, 64),
    (1, 64, 8, 32, 16, 64),   # single chunk
]


@pytest.mark.parametrize("B,S,H,P,N,Q", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_scan_matches_the_reference(B, S, H, P, N, Q, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    j, t = _both(_inputs(B, S, H, P, N), jdt, tdt)
    y_k, s_k = ref_scan(*j, chunk=Q, interpret=True)
    y_o, s_o = ssd_ref(*j, Q)
    y, s = ssd_scan(*t, chunk=Q)
    assert y.dtype == tdt and s.dtype == tdt
    assert tuple(y.shape) == (B, S, H, P) and tuple(s.shape) == (B, H, P, N)
    for want_y, want_s in ((y_k, s_k), (y_o, s_o)):
        _close(y, want_y, tol)
        _close(s, want_s, tol)


@pytest.mark.parametrize("B,S,H,P,N,Q", [
    (2, 48, 8, 16, 16, 32),
    (1, 200, 2, 64, 128, 64),
    (2, 40, 4, 32, 16, 16),
    (1, 65, 2, 16, 32, 64),   # one position past a chunk
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ragged_s_padded_as_the_model_pads_matches_the_oracle(B, S, H, P, N, Q,
                                                            dtype):
    """The reference's ``ssd_chunked`` pads internally; the port's model
    pads before the scan (dt = 0): same y on the first S rows, same state."""
    jdt, tdt, tol = DTYPES[dtype]
    j, t = _both(_inputs(B, S, H, P, N, seed=1), jdt, tdt)
    y_o, s_o = ssd_ref(*j, Q)
    x, dt, A, Bi, Ci = t
    xs, dts, Bs, Cs = pad_to_chunk(x, dt, Bi, Ci, Q)
    assert xs.shape[1] % Q == 0 and xs.shape[1] - S < Q
    y, s = ssd_scan(xs, dts, A, Bs, Cs, chunk=Q)
    _close(y[:, :S], y_o, tol)
    _close(s, s_o, tol)


def test_plain_version_returns_the_kernels_layout():
    x, dt, A, Bi, Ci = (torch.from_numpy(a) for a in _inputs(2, 64, 4, 16, 16))
    xdt, Bm, Cm, cums = arrange(x, dt, A, Bi, Ci, 32)
    assert tuple(xdt.shape) == (2, 4, 2, 32, 16)
    assert tuple(Bm.shape) == tuple(Cm.shape) == (2, 2, 32, 16)
    assert tuple(cums.shape) == (2, 4, 2, 32) and cums.dtype == torch.float32
    y, state = ssd_scan_ref(xdt, Bm, Cm, cums)
    assert tuple(y.shape) == tuple(xdt.shape) and state.dtype == torch.float32
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        arrange(x[:, :50], dt[:, :50], A, Bi[:, :50], Ci[:, :50], 32)


def test_a_cuda_tensor_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = tuple(torch.from_numpy(a) for a in _inputs(1, 32, 2, 16, 16))
    with pytest.raises((RuntimeError, AssertionError)):
        ssd_scan(*(a.to("cuda") for a in args), chunk=32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_scan_kernel(*arrange(*args, 32))


@pytest.mark.parametrize("P,N,Q,match", [
    (24, 16, 32, "head dim 24"),
    (16, 16, 32, "expected a CUDA tensor"),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(P, N, Q, match):
    """On the CPU; the kernel's own refusal of sizes above its shared-memory
    limit is checked on the card (``chip_smoke.py``)."""
    args = tuple(torch.from_numpy(a) for a in _inputs(1, Q, 1, P, N))
    with pytest.raises(ValueError, match=match):
        ssd_scan_kernel(*arrange(*args, Q))


# -- the CUDA bf16 route's rounding, emulated on the CPU ----------------------

SMOKE_BF16_TOL = (1e-3, 1.6e-2)   # chip_smoke.py: y against the plain version
SMOKE_STATE_TOL = 5e-4            # chip_smoke.py: the f32 state


def _split(v):
    """An f32 operand as the kernel feeds it to bf16 products: hi + lo."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def tensor_core_emulation(xdt, Bm, Cm, cums):
    """The bf16 route of ``csrc/ssd_scan.cu`` in plain PyTorch, with its
    rounding: every product f32-summed; C B^T from the exact bf16 values; the
    f32 operands of the other three products (the decayed xdt of the chunk
    states, G o L, and the state entering a chunk) split into bf16 hi + lo,
    each half multiplied by the exact bf16 operand; the state passed in f32
    from chunk to chunk; y rounded to xdt's dtype once."""
    B, H, nc, Q, P = xdt.shape
    x = xdt.float()
    Bf, Cf = Bm.float()[:, None], Cm.float()[:, None]       # (B,1,nc,Q,N)
    last = cums[..., -1:]                                   # (B,H,nc,1)
    xd_hi, xd_lo = _split(x * torch.exp(last - cums)[..., None])
    own = xd_hi.transpose(-1, -2) @ Bf + xd_lo.transpose(-1, -2) @ Bf
    s = torch.zeros_like(own[:, :, 0])
    entering = []
    for c in range(nc):
        entering.append(s)
        s = torch.exp(last[:, :, c])[..., None] * s + own[:, :, c]
    s_hi, s_lo = _split(torch.stack(entering, dim=2))       # (B,H,nc,P,N)
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.where(causal, torch.exp(cums[..., :, None] - cums[..., None, :]),
                    torch.zeros(()))
    m_hi, m_lo = _split((Cf @ Bf.transpose(-1, -2)) * L)
    y = (Cf @ s_hi.transpose(-1, -2) + Cf @ s_lo.transpose(-1, -2)) \
        * torch.exp(cums)[..., None]
    y = y + (m_hi @ x + m_lo @ x)
    return y.to(xdt.dtype), s


@pytest.mark.parametrize("nc", [2, 3, 4])
def test_tensor_core_rounding_matches_the_reference(nc):
    """At mamba2's chunk shape (Q 256, P 64, N 128) the hi/lo split keeps
    the emulated kernel within the file's bf16 tolerance of the Pallas
    kernel (interpret mode) and ``ssd_ref``, and within chip_smoke.py's
    tolerances of the port's plain version on the same bf16 values."""
    B, H, P, N, Q = 1, 3, 64, 128, 256
    _, _, tol = DTYPES["bfloat16"]
    j, t = _both(_inputs(B, Q * nc, H, P, N, seed=5), jnp.bfloat16,
                 torch.bfloat16)
    ins = arrange(*t, chunk=Q)
    y, s = tensor_core_emulation(*ins)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    y = y.permute(0, 2, 3, 1, 4).reshape(B, Q * nc, H, P)
    y_k, s_k = ref_scan(*j, chunk=Q, interpret=True)
    y_o, s_o = ssd_ref(*j, Q)
    for want_y, want_s in ((y_k, s_k), (y_o, s_o)):
        _close(y, want_y, tol)
        _close(s, want_s, tol)
    y_p, s_p = ssd_scan_ref(*ins)
    atol, rtol = SMOKE_BF16_TOL
    torch.testing.assert_close(y.float(), y_p.permute(0, 2, 3, 1, 4).reshape(
        B, Q * nc, H, P).float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(s, s_p, atol=SMOKE_STATE_TOL,
                               rtol=SMOKE_STATE_TOL)


@pytest.mark.parametrize("B,S,H,P,N,Q", [
    (2, 256, 4, 64, 128, 256),    # one chunk
    (1, 500, 3, 64, 128, 100),    # Q ragged against the 64-row tiles
    (3, 200, 3, 16, 48, 100),
])
def test_tensor_core_rounding_on_the_smoke_edges(B, S, H, P, N, Q):
    """The emulation at chip_smoke.py's edge shapes, within its tolerances
    of the plain version on the same bf16 values."""
    _, t = _both(_inputs(B, S, H, P, N, seed=6), jnp.bfloat16, torch.bfloat16)
    ins = arrange(*t, chunk=Q)
    y, s = tensor_core_emulation(*ins)
    y_p, s_p = ssd_scan_ref(*ins)
    atol, rtol = SMOKE_BF16_TOL
    torch.testing.assert_close(y.float(), y_p.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(s, s_p, atol=SMOKE_STATE_TOL,
                               rtol=SMOKE_STATE_TOL)
