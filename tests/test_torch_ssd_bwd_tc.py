"""The rounding of the SSD backward's bf16 route on the tensor cores
(``csrc/ssd_scan_bwd.cu``, ``ssd_scan_bwd_bf16``), emulated in plain PyTorch
on the CPU, against the plain backward formulas (``ssd_scan_bwd_ref``, what
chip_smoke.py holds the kernel to) and against ``jax.vjp`` of the
reference's ``ssd_chunked``; and the wrapper's refusal of a state size the
route does not take.

The emulation computes every product as the kernel does: C B^T and dY X^T
from the exact bf16 values; each f32 operand (the decayed X and dY of the
chunk products, G o L, dG, the state entering a chunk, the state's gradient
leaving it) as bf16 hi + lo; f32 sums; the row scales w and e applied to f32
results; the states passed from chunk to chunk in f32.  Tolerances are
chip_smoke.py's ``SSD_BWD_TOL``: the bf16 outputs (dxdt, dBm, dCm) within
2^-7 of each output's max-abs, about two bf16 ulps of its largest element,
dcums (f32) within 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import arrange  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref  # noqa: E402

SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}   # chip_smoke.py


def _hilo(v):
    """An f32 operand as the kernel feeds it to bf16 products: hi + lo."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


def tensor_core_bwd_emulation(xdt, Bm, Cm, cums, dy, dstate=None):
    """The bf16 route of ``csrc/ssd_scan_bwd.cu`` in plain PyTorch, with its
    rounding, on the arranged inputs -> (dxdt, dBm, dCm in bf16, dcums f32).
    Launch by launch: the chunk products X^T (B o w) and dY^T (C o e) with
    the scale on the P-side operand, split; the state passing in f32, each
    chunk's entering state and leaving gradient stored as hi + lo, and
    exp(cu_last) <dS, s_hi + s_lo>; the tile products."""
    B, H, nc, Q, P = xdt.shape
    N = Bm.shape[-1]
    x, dyf = xdt.float(), dy.float()
    Bf, Cf = Bm.float()[:, None], Cm.float()[:, None]        # (B,1,nc,Q,N)
    last = cums[..., -1:]                                    # (B,H,nc,1)
    w, e = torch.exp(last - cums), torch.exp(cums)           # (B,H,nc,Q)
    dec = torch.exp(last[..., 0])                            # (B,H,nc)
    own = _hilo(x * w[..., None]).transpose(-1, -2) @ Bf     # (B,H,nc,P,N)
    gterm = _hilo(dyf * e[..., None]).transpose(-1, -2) @ Cf
    s = torch.zeros((B, H, P, N))
    entering = []
    for c in range(nc):
        entering.append(s)
        s = dec[:, :, c, None, None] * s + own[:, :, c]
    s_in = _hilo(torch.stack(entering, dim=2))
    v = torch.zeros((B, H, P, N)) if dstate is None else dstate.float()
    leaving, sdot = [None] * nc, torch.empty((B, H, nc))
    for c in range(nc - 1, -1, -1):
        leaving[c] = v
        sdot[:, :, c] = dec[:, :, c] * (v * s_in[:, :, c]).sum((-1, -2))
        v = dec[:, :, c, None, None] * v + gterm[:, :, c]
    dS = _hilo(torch.stack(leaving, dim=2))
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.where(causal, torch.exp(cums[..., :, None] - cums[..., None, :]),
                    torch.zeros(()))
    G = Cf @ Bf.transpose(-1, -2)
    dG = (dyf @ x.transpose(-1, -2)) * L
    dys, xds = dyf @ s_in, x @ dS                            # (B,H,nc,Q,N)
    dx = (_hilo(G * L).transpose(-1, -2) @ dyf
          + w[..., None] * (Bf @ dS.transpose(-1, -2)))
    dC = (_hilo(dG) @ Bf + e[..., None] * dys).sum(1)
    dB = (_hilo(dG).transpose(-1, -2) @ Cf + w[..., None] * xds).sum(1)
    T = dG * G
    t = w * (xds * Bf).sum(-1)
    dcu = T.sum(-1) - T.sum(-2) + e * (Cf * dys).sum(-1) - t
    dcu[..., -1] += t.sum(-1) + sdot
    return (dx.to(xdt.dtype), dB.to(Bm.dtype), dC.to(Cm.dtype), dcu)


def _inputs(B, S, H, P, N, seed, pow2_dt=False):
    """x, B, C bf16-exact; with ``pow2_dt`` dt a power of two from 1/64 to
    1/8, so that x * dt is bf16-exact too and the reference sees the
    kernel's values (and a chunk's decay stays within what the reference's
    f32 exponentials carry: at dt near 1 its gradient overflows to NaN)."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()

    x = bf(rng.standard_normal((B, S, H, P)))
    if pow2_dt:
        dt = (2.0 ** rng.integers(-6, -2, (B, S, H))).astype(np.float32)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1)).astype(
            np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm, Cm = bf(rng.standard_normal((B, S, N))), bf(rng.standard_normal((B, S, N)))
    wy = bf(rng.standard_normal((B, S, H, P)))
    ws = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return (x, dt, A, Bm, Cm), wy, ws


def _arranged(ins, wy, ws, Q, with_dstate):
    """The kernel's bf16 inputs: arrange() of the f32 values, then xdt, Bm,
    Cm and dy in bf16 (the training path's dtype)."""
    xdt, Bm, Cm, cums = arrange(*(torch.from_numpy(a) for a in ins), Q)
    B, H, nc, _, P = xdt.shape
    dy = torch.from_numpy(wy).reshape(B, nc, Q, H, P).permute(
        0, 3, 1, 2, 4).contiguous()
    bf = torch.bfloat16
    return (xdt.to(bf), Bm.to(bf), Cm.to(bf), cums, dy.to(bf),
            torch.from_numpy(ws) if with_dstate else None)


def _err_of_max_abs(got, want):
    scale = max(float(want.float().abs().max()), 1e-30)
    return float((got.float() - want.float()).abs().max()) / scale


# chip_smoke.py's bf16 cases of phase_scan_bwd, B and H cut where the CPU
# needs it (B, S, H, P, N, Q, dstate given)
SMOKE_BF16_CASES = [
    (1, 2048, 3, 64, 128, 256, False),   # mamba2-370m's training shape: nc 8
    (1, 2048, 2, 64, 128, 256, True),
    (2, 256, 4, 64, 128, 256, True),     # one chunk
    (1, 500, 12, 64, 128, 100, False),   # Q ragged against the 64-row tiles
    (1, 512, 10, 128, 64, 256, True),    # P 128, H not a multiple of 8
    (2, 128, 9, 16, 16, 64, False),      # P 16, N 16
    (1, 256, 2, 32, 64, 64, True),
    (1, 256, 3, 64, 128, 32, True),      # Q 32: half a tile
    (1, 256, 2, 64, 128, 64, False),     # Q 64: one tile
    (1, 256, 2, 64, 128, 128, True),     # Q 128
    (1, 384, 1, 64, 128, 192, False),    # Q 192, one head
    (1, 256, 17, 64, 128, 128, True),    # H 17: a block of one head
    (2, 64, 3, 64, 128, 64, False),      # S of exactly one chunk
]


@pytest.mark.parametrize("B,S,H,P,N,Q,with_dstate", SMOKE_BF16_CASES)
def test_tensor_core_bwd_rounding_matches_the_plain_backward(
        B, S, H, P, N, Q, with_dstate):
    """The emulated route against ``ssd_scan_bwd_ref`` on the same bf16
    inputs: dxdt, dBm, dCm within 2^-7 and dcums within 1e-4 of each
    output's max-abs, the smoke's tolerances for the kernel."""
    ins, wy, ws = _inputs(B, S, H, P, N, seed=S + 7 * H + P + N + Q)
    args = _arranged(ins, wy, ws, Q, with_dstate)
    got = tensor_core_bwd_emulation(*args)
    want = ssd_scan_bwd_ref(*args)
    for what, g, w in zip(("dxdt", "dBm", "dCm", "dcums"), got, want):
        assert g.dtype == w.dtype, what
        tol = SSD_BWD_TOL[str(g.dtype).removeprefix("torch.")]
        assert _err_of_max_abs(g, w) <= tol, what


@pytest.mark.parametrize("B,S,H,P,N,Q,with_dstate", [
    (1, 2048, 3, 64, 128, 256, False),   # nc 8
    (1, 512, 2, 64, 128, 256, True),
    (1, 500, 12, 64, 128, 100, True),    # Q 100, H 12
    (1, 512, 10, 128, 64, 256, False),   # P 128, H 10
    (2, 128, 3, 16, 16, 64, True),       # P 16, N 16
    (1, 256, 3, 64, 128, 32, False),     # Q 32
    (2, 256, 4, 64, 128, 256, False),    # nc 1
])
def test_tensor_core_bwd_rounding_matches_jax_vjp_of_ssd_chunked(
        B, S, H, P, N, Q, with_dstate):
    """The emulated route carried on through ``arrange`` to (x, dt, A, B, C)
    against ``jax.vjp`` of the reference's ``ssd_chunked`` (run as
    tests/test_torch_scan_grads.py runs it), on inputs the bf16 route takes
    exactly (x, B, C, dy bf16-exact, dt a power of two so x dt is too), the
    final state's cotangent given or zero.  x, dt, B and C, which carry the
    bf16 outputs, within 2^-7 of each gradient's max-abs; A, which only
    dcums reaches, within 1e-4."""
    ins, wy, ws = _inputs(B, S, H, P, N, seed=3 * S + H + Q, pow2_dt=True)
    if not with_dstate:
        ws = np.zeros_like(ws)
    _, vjp = jax.vjp(lambda *a: ref_ssm.ssd_chunked(*a, Q),
                     *(jnp.asarray(a) for a in ins))
    want = vjp((jnp.asarray(wy), jnp.asarray(ws)))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    arranged = arrange(*ts, Q)
    kernel_ins = _arranged(ins, wy, ws, Q, with_dstate)
    for a, k in zip(arranged, kernel_ins):   # the kernel sees these values
        assert torch.equal(a.detach().to(k.dtype), k)
    grads = tensor_core_bwd_emulation(*kernel_ins)
    got = torch.autograd.grad(arranged, ts, [g.float() for g in grads])
    tols = {"x": 2.0 ** -7, "dt": 2.0 ** -7, "A": 1e-4, "B": 2.0 ** -7,
            "C": 2.0 ** -7}
    for (what, tol), g, w in zip(tols.items(), got, want):
        assert _err_of_max_abs(g, torch.tensor(np.asarray(w))) <= tol, what


@pytest.mark.parametrize("N", [24, 8, 120])
def test_bf16_backward_refuses_a_state_size_not_a_multiple_of_16(N):
    """The bf16 route takes N in multiples of 16 (the mma depth), as the
    bf16 forward does; the wrapper refuses any other N before it looks at
    the device, naming the size.  The f32 route takes it (the CPU tensor
    is then refused for its device)."""
    assert ssd_kernel.BWD_TC_STATE_STEP == 16
    xdt = torch.rand(1, 2, 1, 32, 16)
    cums = torch.rand(1, 2, 1, 32)
    Bm = torch.rand(1, 1, 32, N)
    bf = torch.bfloat16
    with pytest.raises(ValueError, match=f"state size {N}: the bf16 backward "
                                         f"takes a multiple of 16"):
        ssd_kernel.ssd_scan_bwd_kernel(xdt.to(bf), Bm.to(bf), Bm.to(bf), cums,
                                       xdt.to(bf))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_kernel.ssd_scan_bwd_kernel(xdt, Bm, Bm, cums, xdt)


def test_emulation_without_splits_would_miss_the_tolerance():
    """Why the route splits its f32 operands: with each one rounded once to
    bf16 instead (hi alone), the same emulation at mamba2-370m's chunk shape
    leaves dcums outside the smoke's 1e-4, which the hi + lo split meets."""
    ins, wy, ws = _inputs(1, 1024, 2, 64, 128, 9)
    args = _arranged(ins, wy, ws, 256, True)
    want = ssd_scan_bwd_ref(*args)
    split = tensor_core_bwd_emulation(*args)
    global _hilo
    keep = _hilo
    try:
        _hilo = lambda v: v.to(torch.bfloat16).float()   # noqa: E731
        single = tensor_core_bwd_emulation(*args)
    finally:
        _hilo = keep
    assert _err_of_max_abs(split[3], want[3]) <= SSD_BWD_TOL["float32"]
    assert _err_of_max_abs(single[3], want[3]) > SSD_BWD_TOL["float32"]
