"""The plain backward formulas of the SSD and RG-LRU scans
(``ssd_scan_bwd_ref``, ``rglru_scan_bwd_ref``: what the CPU takes, and what
chip_smoke.py holds the CUDA backward kernels to) against ``torch.autograd``
of the plain forwards and against ``jax.vjp`` of the reference's
``ssd_chunked`` and ``griffin.rglru_scan``, on the CPU, from numpy seeds;
and the dispatch of the scans' ``torch.autograd.Function``s.

Tolerances (stated per test): against autograd of the same plain forward,
f32 within 1e-6 of each gradient's max-abs (the same products, summed in
another order), the RG-LRU bit for bit; against the reference, f32 within
1e-5 (RG-LRU) and 1e-4 (SSD, whose chunked sums run in another order) of
each gradient's max-abs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import griffin as ref_griffin  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.rg_lru import kernel as rg_kernel  # noqa: E402
from repro_torch.kernels.rg_lru import ops as rg_ops  # noqa: E402
from repro_torch.kernels.rg_lru.ref import (  # noqa: E402
    rglru_scan_bwd_ref, rglru_scan_ref,
)
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import arrange  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_bwd_ref, ssd_scan_ref,
)
from repro_torch.models import griffin, ssm  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got) if isinstance(got, torch.Tensor)
                               else got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


# ----------------------------------------------------------------------
# RG-LRU
# ----------------------------------------------------------------------

def _rglru_inputs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    a = (0.98 / (1 + np.exp(-rng.standard_normal((B, S, W))))
         ).astype(np.float32)
    b = (rng.standard_normal((B, S, W)) * 0.1).astype(np.float32)
    dh = rng.standard_normal((B, S, W)).astype(np.float32)
    dlast = rng.standard_normal((B, W)).astype(np.float32)
    return a, b, dh, dlast


@pytest.mark.parametrize("B,S,W", [(2, 1, 8), (1, 17, 33), (3, 64, 16)])
@pytest.mark.parametrize("with_dlast", [True, False])
def test_rglru_bwd_ref_matches_autograd_of_the_plain_scan(B, S, W,
                                                         with_dlast):
    """``rglru_scan_bwd_ref`` against ``torch.autograd`` through the plain
    forward's S-step loop: bit for bit (the same products and sums, each
    rounded to f32)."""
    a, b, dh, dlast = _rglru_inputs(B, S, W, seed=S)
    at, bt = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    h, last = rglru_scan_ref(at, bt)
    outs, grads = [h], [torch.from_numpy(dh)]
    if with_dlast:
        outs.append(last)
        grads.append(torch.from_numpy(dlast))
    want = torch.autograd.grad(outs, (at, bt), grads)
    got = rglru_scan_bwd_ref(at.detach(), h.detach(), torch.from_numpy(dh),
                             torch.from_numpy(dlast) if with_dlast else None)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)


@pytest.mark.parametrize("S", [1, 24, 40])
def test_rglru_bwd_ref_matches_jax_vjp_of_the_reference(S):
    """The plain backward carried on through the port's gates
    (``_rglru_coeffs``) against ``jax.vjp`` of the reference's associative
    ``rglru_scan``, with respect to the input and every parameter, the
    cotangents of h and of the final state both given.  f32, within 1e-5
    of each max-abs."""
    cfg = get_config("recurrentgemma-9b", reduced=True)
    rcfg = ref_config("recurrentgemma-9b", reduced=True)
    ref_p = ref_layers.init_params(ref_griffin.rglru_spec(rcfg),
                                   jax.random.PRNGKey(S), jnp.float32)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.lru_width)).astype(np.float32)
    wy = rng.standard_normal(x.shape).astype(np.float32)
    wl = rng.standard_normal((2, cfg.lru_width)).astype(np.float32)
    _, vjp = jax.vjp(ref_griffin.rglru_scan, ref_p, jnp.asarray(x))
    want_p, want_x = vjp((jnp.asarray(wy), jnp.asarray(wl)))

    p = params_from_reference(griffin.rglru_spec(cfg),
                              jax.tree_util.tree_map(np.asarray, ref_p), "cpu")
    used = ("gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b", "lambda_p")
    for k in used:
        p[k].requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    a, bx = griffin._rglru_coeffs(p, xt)
    h, _ = rglru_scan_ref(a.detach(), bx.detach())
    da, db = rglru_scan_bwd_ref(a.detach(), h, torch.from_numpy(wy),
                                torch.from_numpy(wl))
    got = torch.autograd.grad((a, bx), [p[k] for k in used] + [xt], (da, db))
    for k, g in zip(used, got):
        _close(g, want_p[k], 1e-5, k)
    _close(got[-1], want_x, 1e-5, "x")


# ----------------------------------------------------------------------
# SSD
# ----------------------------------------------------------------------

def _ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1)).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    wy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ws = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return (x, dt, A, Bm, Cm), wy, ws


@pytest.mark.parametrize("nc,Q", [(1, 16), (4, 16), (3, 32)])
@pytest.mark.parametrize("with_dstate", [True, False])
def test_ssd_bwd_ref_matches_autograd_of_the_plain_scan(nc, Q, with_dstate):
    """``ssd_scan_bwd_ref`` against ``torch.autograd`` of ``ssd_scan_ref``
    on the arranged inputs (xdt, B, C, cums), the final state's cotangent
    given or None.  f32, within 1e-6 of each gradient's max-abs."""
    B, H, P, N = 2, 3, 8, 5
    rng = np.random.default_rng(nc * Q)
    xdt = torch.from_numpy(rng.standard_normal((B, H, nc, Q, P)).astype(
        np.float32)).requires_grad_(True)
    Bm, Cm = (torch.from_numpy(rng.standard_normal((B, nc, Q, N)).astype(
        np.float32)).requires_grad_(True) for _ in range(2))
    cums = torch.from_numpy(np.cumsum(
        -rng.uniform(0, 0.3, (B, H, nc, Q)), -1).astype(np.float32)
    ).requires_grad_(True)
    y, state = ssd_scan_ref(xdt, Bm, Cm, cums)
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    ds = torch.from_numpy(rng.standard_normal(state.shape).astype(np.float32))
    outs, cot = ([y, state], [dy, ds]) if with_dstate else ([y], [dy])
    want = torch.autograd.grad(outs, (xdt, Bm, Cm, cums), cot)
    got = ssd_scan_bwd_ref(xdt.detach(), Bm.detach(), Cm.detach(),
                           cums.detach(), dy, ds if with_dstate else None)
    for what, g, w in zip(("dxdt", "dBm", "dCm", "dcums"), got, want):
        assert g.dtype == torch.float32
        _close(g, w.numpy(), 1e-6, what)


@pytest.mark.parametrize("S,chunk", [(32, 32), (128, 32), (100, 32),
                                     (40, 64)])
@pytest.mark.parametrize("with_dstate", [True, False])
def test_ssd_bwd_ref_matches_jax_vjp_of_ssd_chunked(S, chunk, with_dstate):
    """The plain backward carried on through ``arrange`` (and the model's
    padding of a ragged S, with dt = 0 on the pads) to (x, dt, A, B, C)
    against ``jax.vjp`` of the reference's ``ssd_chunked``: nc 1 (S 32 and
    40 in one chunk), nc 4, S 100 ragged against chunks of 32; the final
    state's cotangent given, or zero (None on the port's side).  f32, within
    1e-4 of each gradient's max-abs."""
    B, H, P, N = 2, 3, 8, 16
    ins, wy, ws = _ssd_inputs(B, S, H, P, N, seed=S + chunk)
    if not with_dstate:
        ws = np.zeros_like(ws)
    _, vjp = jax.vjp(lambda *a: ref_ssm.ssd_chunked(*a, chunk),
                     *(jnp.asarray(a) for a in ins))
    want = vjp((jnp.asarray(wy), jnp.asarray(ws)))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    x, dt, A, Bm, Cm = ts
    Q = min(chunk, S)
    xs, dts, Bs, Cs = ssm.pad_to_chunk(x, dt, Bm, Cm, Q)
    arranged = arrange(xs, dts, A, Bs, Cs, Q)
    pad = xs.shape[1] - S
    dy = np.pad(wy, ((0, 0), (0, pad), (0, 0), (0, 0)))
    nc = xs.shape[1] // Q
    dy = torch.from_numpy(dy).reshape(B, nc, Q, H, P).permute(
        0, 3, 1, 2, 4).contiguous()
    grads = ssd_scan_bwd_ref(*(t.detach() for t in arranged), dy,
                             torch.from_numpy(ws) if with_dstate else None)
    got = torch.autograd.grad(arranged, ts, grads)
    for what, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
        _close(g, w, 1e-4, what)


def test_ssd_bwd_ref_keeps_the_input_dtype_and_computes_in_f32():
    """bf16 inputs: dxdt, dBm and dCm come back in bf16, each the f32
    gradient of the same (bf16) values rounded once; dcums stays f32."""
    rng = np.random.default_rng(3)
    B, H, nc, Q, P, N = 1, 2, 2, 16, 8, 4
    xdt = torch.from_numpy(rng.standard_normal((B, H, nc, Q, P)).astype(
        np.float32)).bfloat16()
    Bm, Cm = (torch.from_numpy(rng.standard_normal((B, nc, Q, N)).astype(
        np.float32)).bfloat16() for _ in range(2))
    cums = torch.from_numpy(np.cumsum(-rng.uniform(0, 0.3, (B, H, nc, Q)),
                                      -1).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((B, H, nc, Q, P)).astype(
        np.float32)).bfloat16()
    got = ssd_scan_bwd_ref(xdt, Bm, Cm, cums, dy)
    want = ssd_scan_bwd_ref(xdt.float(), Bm.float(), Cm.float(), cums,
                            dy.float())
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w.bfloat16())
    assert torch.equal(got[3], want[3])


# ----------------------------------------------------------------------
# the autograd Functions' dispatch
# ----------------------------------------------------------------------

def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_rglru_grad_on_the_cpu_runs_the_function_with_the_plain_backward(
        monkeypatch):
    """Under grad on the CPU, ``rglru_scan`` runs its Function: the plain
    forward once and ``rglru_scan_bwd_ref`` once at backward, with the
    final state's gradient None when only h is used; the gradients equal
    the plain backward's bit for bit.  Without grad, the plain forward
    alone."""
    a, b, dh, _ = _rglru_inputs(2, 9, 12, seed=4)
    fwd = _counting(monkeypatch, rg_ops, "rglru_scan_ref")
    bwd = _counting(monkeypatch, rg_ops, "rglru_scan_bwd_ref")
    at, bt = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    h, _ = rg_ops.rglru_scan(at, bt)
    assert h.grad_fn is not None and len(fwd) == 1 and not bwd
    h.backward(torch.from_numpy(dh))
    assert len(fwd) == 1 and len(bwd) == 1
    want = rglru_scan_bwd_ref(at.detach(), h.detach(), torch.from_numpy(dh))
    assert torch.equal(at.grad, want[0]) and torch.equal(bt.grad, want[1])
    with torch.no_grad():
        h2, _ = rg_ops.rglru_scan(at, bt)
    assert h2.grad_fn is None and len(fwd) == 2 and len(bwd) == 1


def test_rglru_grad_refuses_bf16_coefficients():
    """The model's a and b are f32; bf16 under grad raises, naming the
    dtype, on the CPU as on a card; without grad bf16 is served."""
    a = torch.rand(1, 4, 8, dtype=torch.bfloat16, requires_grad=True)
    b = torch.rand(1, 4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        rg_ops.rglru_scan(a, b)
    with torch.no_grad():
        h, _ = rg_ops.rglru_scan(a, b)
    assert h.dtype == torch.bfloat16


def test_ssd_grad_on_the_cpu_runs_the_function_with_the_plain_backward(
        monkeypatch):
    """Under grad on the CPU, ``ssd_scan`` runs its Function over the
    arranged inputs: the plain forward once, ``ssd_scan_bwd_ref`` once at
    backward (the final state unused: its gradient None), and the gradient
    of the cumsums reaches dt and A through ``arrange``."""
    (x, dt, A, Bm, Cm), wy, _ = _ssd_inputs(1, 64, 2, 8, 4, seed=9)
    fwd = _counting(monkeypatch, ssd_ops, "ssd_scan_ref")
    bwd = _counting(monkeypatch, ssd_ops, "ssd_scan_bwd_ref")
    ts = [torch.from_numpy(v).requires_grad_(True) for v in (x, dt, A, Bm, Cm)]
    y, _ = ssd_ops.ssd_scan(*ts, chunk=32)
    assert len(fwd) == 1 and not bwd
    (y * torch.from_numpy(wy)).sum().backward()
    assert len(bwd) == 1
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in ts)


@pytest.mark.parametrize("which", ["rglru", "ssd"])
def test_backward_wrappers_refuse_a_non_cuda_tensor(which):
    """The backward kernels' wrappers check the device before anything
    launches: a CPU tensor is refused (the CPU takes the plain versions in
    the Functions, never the wrappers)."""
    if which == "rglru":
        t = torch.rand(1, 4, 8)
        with pytest.raises(ValueError, match="CUDA tensor"):
            rg_kernel.rglru_scan_bwd_kernel(t, t, t)
    else:
        xdt = torch.rand(1, 2, 1, 32, 16)
        Bm = torch.rand(1, 1, 32, 16)
        cums = torch.rand(1, 2, 1, 32)
        with pytest.raises(ValueError, match="CUDA tensor"):
            ssd_kernel.ssd_scan_bwd_kernel(xdt, Bm, Bm, cums, xdt)


def test_ssd_backward_wrapper_refuses_what_the_kernel_does_not_take():
    """A head dim outside HEAD_DIMS, or a state wider than the backward's
    128, is refused before the device is looked at."""
    with pytest.raises(ValueError, match="head dim"):
        ssd_kernel.ssd_scan_bwd_kernel(
            torch.rand(1, 1, 1, 32, 8), torch.rand(1, 1, 32, 16),
            torch.rand(1, 1, 32, 16), torch.rand(1, 1, 1, 32),
            torch.rand(1, 1, 1, 32, 8))
    with pytest.raises(ValueError, match="state size"):
        ssd_kernel.ssd_scan_bwd_kernel(
            torch.rand(1, 1, 1, 32, 16), torch.rand(1, 1, 32, 256),
            torch.rand(1, 1, 32, 256), torch.rand(1, 1, 1, 32),
            torch.rand(1, 1, 1, 32, 16))


@pytest.mark.parametrize("lib", ["ssd_scan_bwd", "rg_lru"])
def test_c_entry_points_match_the_ctypes_signatures(lib):
    """Every ``extern "C"`` entry point of the source takes as many
    arguments as ``_build.SIGNATURES`` declares, pointers (``void*``) where
    it says c_void_p and ``long long`` where it says c_longlong: ctypes
    would pass a mismatched call without a word."""
    import ctypes
    import re

    from repro_torch.kernels import _build

    src = (_build.CSRC / f"{lib}.cu").read_text()
    body = src[src.index('extern "C" {'):]
    found = dict(re.findall(r"\bint (\w+)\(([^)]*)\)", body))
    assert set(found) == set(_build.SIGNATURES[lib])
    for name, params in found.items():
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_longlong
                 for p in params.split(",")]
        assert kinds == list(_build.SIGNATURES[lib][name]), name
