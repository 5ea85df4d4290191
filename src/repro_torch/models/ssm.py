"""Mamba-2 block (port of ``repro/models/ssm.py``): SSD (state-space
duality) [arXiv:2405.21060].

The reference's model runs its XLA ``ssd_chunked`` and keeps the Pallas
SSD kernel as the TPU's route; the port's scan goes through
:func:`repro_torch.kernels.ssd_scan.ops.ssd_scan` (the CUDA kernel on the
card, its plain version on the CPU).  Training goes through the same call:
under grad it runs the scan's ``autograd.Function``, whose backward is the
hand-written backward kernel on the card and the plain backward formulas on
the CPU.  The one-token decode step is plain PyTorch, as in the reference.

Shapes: x (B,S,H,P)  dt (B,S,H)  A (H,)<0  B/C (B,S,N) (one group).
Decays are computed in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import P, causal_conv1d, rms_norm, silu


def ssm_spec(cfg):
    d, din, H, N, W = (cfg.d_model, cfg.d_inner, cfg.ssm_heads,
                       cfg.ssm_state, cfg.conv_width)
    return {
        "w_z": P((d, din), ("embed", "ssm_inner")),
        "w_x": P((d, din), ("embed", "ssm_inner")),
        "w_B": P((d, N), ("embed", "ssm_state")),
        "w_C": P((d, N), ("embed", "ssm_state")),
        "w_dt": P((d, H), ("embed", "ssm_heads")),
        "conv_w": P((din + 2 * N, W), ("conv", None)),
        "dt_bias": P((H,), ("ssm_heads",), init="dt_bias"),
        "A_log": P((H,), ("ssm_heads",), init="a_log"),
        "D": P((H,), ("ssm_heads",), init="ones"),
        "norm_w": P((din,), ("ssm_inner",), init="zeros"),
        "w_out": P((din, d), ("ssm_inner", "embed")),
    }


def _in_proj(p, x_res, cfg, conv_state):
    """The projections, the causal conv and the dt/A transforms shared by
    the forward pass and the decode step."""
    din, N = cfg.d_inner, cfg.ssm_state
    z = x_res @ p["w_z"]
    conv_in = torch.cat([x_res @ p["w_x"], x_res @ p["w_B"], x_res @ p["w_C"]],
                        dim=-1)
    dt_raw = x_res @ p["w_dt"]
    conv_out, new_conv = causal_conv1d(conv_in, p["conv_w"], conv_state)
    xb, Bv, Cv = torch.split(conv_out, [din, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    return z, xb, Bv, Cv, dt, A, new_conv


def _out_proj(p, y, z, cfg):
    y = rms_norm(y * silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["w_out"]


def pad_to_chunk(x, dt, B_in, C_in, Q: int):
    """Pad S to a multiple of the chunk ``Q`` with dt = 0 (decay 1,
    contribution 0), as the reference's ``ssd_chunked`` pads: the scan of
    the padded inputs gives the same y[:, :S] and the same final state."""
    pad = -x.shape[1] % Q
    if not pad:
        return x, dt, B_in, C_in
    return (F.pad(x, (0, 0, 0, 0, 0, pad)),
            *(F.pad(t, (0, 0, 0, pad)) for t in (dt, B_in, C_in)))


def ssm_forward(p, x_res, cfg):
    """The mamba2 mixer over a whole prompt from zero state.
    x_res (B,S,d) -> (y (B,S,d), (conv_state, ssm_state in x's dtype)).

    The scan kernel takes whole chunks, so S is padded to a chunk multiple
    (:func:`pad_to_chunk`)."""
    B, S, _ = x_res.shape
    H, Pd = cfg.ssm_heads, cfg.ssm_headdim
    z, xb, Bv, Cv, dt, A, new_conv = _in_proj(p, x_res, cfg, None)
    xh = xb.reshape(B, S, H, Pd)
    Q = min(cfg.ssm_chunk, S)
    xs, dts, Bs, Cs = pad_to_chunk(xh, dt, Bv, Cv, Q)
    y, final_state = ssd_scan(xs, dts, A, Bs, Cs, chunk=Q)
    y = y[:, :S] + xh * p["D"].to(x_res.dtype)[None, None, :, None]
    out = _out_proj(p, y.reshape(B, S, cfg.d_inner), z, cfg)
    return out, (new_conv, final_state)


def ssm_decode_step(p, x_res, cfg, conv_state, ssm_state):
    """One-token decode.  x_res (B,1,d); conv_state (B,W-1,C); ssm_state
    (B,H,P,N), which stays in its own dtype (the cache's)."""
    B = x_res.shape[0]
    H, Pd = cfg.ssm_heads, cfg.ssm_headdim
    xt = x_res.dtype
    z, xb, Bv, Cv, dt, A, new_conv = _in_proj(p, x_res, cfg, conv_state)
    dA = torch.exp(dt[:, 0, :] * A)                          # (B,H)

    xh = xb[:, 0].reshape(B, H, Pd)
    contrib = (dt[:, 0, :].to(xt)[:, :, None, None] * xh[..., None]
               * Bv[:, 0].to(xt)[:, None, None, :])          # (B,H,P,N)
    new_state = dA[:, :, None, None].to(xt) * ssm_state + contrib
    y = torch.einsum("bn,bhpn->bhp", Cv[:, 0].to(new_state.dtype), new_state)
    y = y + xh * p["D"].to(xt)[None, :, None]
    out = _out_proj(p, y.reshape(B, 1, cfg.d_inner), z, cfg)
    return out, (new_conv, new_state)
