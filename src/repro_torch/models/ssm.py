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

Under a tp context whose rules split ``ssm_heads`` (and so ``ssm_inner``)
over a ``model`` axis above one rank, each rank holds its block of whole
heads, read in place (:func:`head_block`): ``w_z``, ``w_x``, ``w_dt``,
``dt_bias``, ``A_log``, ``D``, ``norm_w`` and ``w_out``'s rows.  The
input enters through ``to_model``; ``w_B``, ``w_C`` and ``conv_w``, whole
on every rank but used for this rank's heads only, do too, so their
gradients sum over ``model``; the scan runs on this rank's heads; the
gated norm's mean square is summed over ``model`` both ways
(``split_rms_norm``); ``w_out``'s partial output leaves through
``from_model``.  The mixers take and return this rank's conv channels
(its x channels, then B and C); the cache holds every rank's
(:func:`own_conv`, :func:`whole_conv`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import P, causal_conv1d, silu, split_rms_norm


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


@dataclass(frozen=True)
class HeadBlock:
    """A tp rank's block of the SSD heads: the ``model`` group and heads
    [first, first + heads), with their ``d_inner`` channels."""
    group: object
    first: int
    heads: int


def check_tp(cfg, ctx) -> None:
    """Raises ``NotImplementedError`` where ``ctx`` splits ``ssm_inner``
    over a ``model`` axis above one rank but leaves ``ssm_heads`` whole: a
    rank's block of ``d_inner`` would cut through a head.  Reads the rules
    only (no ranks)."""
    if tp.over_model(ctx) and ctx.rules.get("ssm_inner") is not None \
            and ctx.rules.get("ssm_heads") is None:
        raise NotImplementedError(
            f"{cfg.name}: tp splits d_inner ({cfg.d_inner}) over "
            f"{ctx.axes['model']} 'model' ranks but not its "
            f"{cfg.ssm_heads} heads, so a rank's block cuts through a head")


def head_block(cfg, ctx) -> HeadBlock | None:
    """This rank's block of the heads under ``ctx``: ``None`` without a tp
    ``model`` group or where the rules leave the heads whole (then the
    mixer runs whole on every rank)."""
    check_tp(cfg, ctx)
    group = tp.model_group(ctx)
    if group is None or ctx.rules.get("ssm_heads") is None:
        return None
    heads = cfg.ssm_heads // dist.get_world_size(group)
    return HeadBlock(group, dist.get_rank(group) * heads, heads)


def _own_channels(t, dim: int, cfg, hb: HeadBlock):
    """``t``'s conv channels on ``dim`` (every head's x channels, then B
    and C) -> this rank's x channels, then B and C."""
    Pd, din = cfg.ssm_headdim, cfg.d_inner
    return torch.cat([t.narrow(dim, hb.first * Pd, hb.heads * Pd),
                      t.narrow(dim, din, t.shape[dim] - din)], dim=dim)


def own_conv(conv_state, cfg, ctx):
    """The cache's conv state (.., din + 2N) -> this rank's channels."""
    hb = head_block(cfg, ctx)
    return conv_state if hb is None else \
        _own_channels(conv_state, conv_state.dim() - 1, cfg, hb)


def whole_conv(conv, cfg, ctx):
    """:func:`own_conv`'s inverse for the no-grad serve paths: this rank's
    conv channels -> the cache's, every rank's x channels gathered over
    ``model`` in rank order."""
    hb = head_block(cfg, ctx)
    if hb is None:
        return conv
    dl = hb.heads * cfg.ssm_headdim
    return torch.cat([tp.gather_model(conv[..., :dl], conv.dim() - 1,
                                      hb.group), conv[..., dl:]], dim=-1)


def _own_params(p, cfg, hb: HeadBlock | None):
    """The leaves whole on every rank but used for this rank's heads only
    through ``to_model`` (``w_B``, ``w_C``; ``conv_w``, of which this rank
    reads its x rows and the B/C rows)."""
    if hb is None:
        return p
    return {**p, "w_B": tp.to_model(p["w_B"], hb.group),
            "w_C": tp.to_model(p["w_C"], hb.group),
            "conv_w": _own_channels(tp.to_model(p["conv_w"], hb.group), 0,
                                    cfg, hb)}


def _in_proj(p, x_res, cfg, conv_state, hb: HeadBlock | None):
    """The projections, the causal conv and the dt/A transforms shared by
    the forward pass and the decode step, on this rank's heads (``x_res``
    entering through ``to_model``)."""
    p = _own_params(p, cfg, hb)
    x_res = tp.to_model(x_res, None if hb is None else hb.group)
    din, N = p["w_x"].shape[-1], cfg.ssm_state
    z = x_res @ p["w_z"]
    conv_in = torch.cat([x_res @ p["w_x"], x_res @ p["w_B"], x_res @ p["w_C"]],
                        dim=-1)
    dt_raw = x_res @ p["w_dt"]
    conv_out, new_conv = causal_conv1d(conv_in, p["conv_w"], conv_state)
    xb, Bv, Cv = torch.split(conv_out, [din, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    return z, xb, Bv, Cv, dt, A, new_conv


def _out_proj(p, y, z, cfg, hb: HeadBlock | None):
    group = None if hb is None else hb.group
    y = split_rms_norm(y * silu(z), p["norm_w"], cfg.norm_eps, cfg.d_inner,
                       group)
    return tp.from_model(y @ p["w_out"], group)


def pad_to_chunk(x, dt, B_in, C_in, Q: int):
    """Pad S to a multiple of the chunk ``Q`` with dt = 0 (decay 1,
    contribution 0), as the reference's ``ssd_chunked`` pads: the scan of
    the padded inputs gives the same y[:, :S] and the same final state."""
    pad = -x.shape[1] % Q
    if not pad:
        return x, dt, B_in, C_in
    return (F.pad(x, (0, 0, 0, 0, 0, pad)),
            *(F.pad(t, (0, 0, 0, pad)) for t in (dt, B_in, C_in)))


def ssm_forward(p, x_res, cfg, ctx=None):
    """The mamba2 mixer over a whole prompt from zero state.
    x_res (B,S,d) -> (y (B,S,d), (conv_state, ssm_state in x's dtype)),
    under a tp context this rank's heads of the states (module
    docstring).

    The scan kernel takes whole chunks, so S is padded to a chunk multiple
    (:func:`pad_to_chunk`)."""
    B, S, _ = x_res.shape
    hb = head_block(cfg, ctx)
    H = cfg.ssm_heads if hb is None else hb.heads
    Pd = cfg.ssm_headdim
    z, xb, Bv, Cv, dt, A, new_conv = _in_proj(p, x_res, cfg, None, hb)
    xh = xb.reshape(B, S, H, Pd)
    Q = min(cfg.ssm_chunk, S)
    xs, dts, Bs, Cs = pad_to_chunk(xh, dt, Bv, Cv, Q)
    y, final_state = ssd_scan(xs, dts, A, Bs, Cs, chunk=Q)
    y = y[:, :S] + xh * p["D"].to(x_res.dtype)[None, None, :, None]
    out = _out_proj(p, y.reshape(B, S, H * Pd), z, cfg, hb)
    return out, (new_conv, final_state)


def ssm_decode_step(p, x_res, cfg, conv_state, ssm_state, ctx=None):
    """One-token decode.  x_res (B,1,d); conv_state (B,W-1,C); ssm_state
    (B,H,P,N), which stays in its own dtype (the cache's); under a tp
    context this rank's conv channels and heads (module docstring)."""
    B = x_res.shape[0]
    hb = head_block(cfg, ctx)
    H = cfg.ssm_heads if hb is None else hb.heads
    Pd = cfg.ssm_headdim
    xt = x_res.dtype
    z, xb, Bv, Cv, dt, A, new_conv = _in_proj(p, x_res, cfg, conv_state, hb)
    dA = torch.exp(dt[:, 0, :] * A)                          # (B,H)

    xh = xb[:, 0].reshape(B, H, Pd)
    contrib = (dt[:, 0, :].to(xt)[:, :, None, None] * xh[..., None]
               * Bv[:, 0].to(xt)[:, None, None, :])          # (B,H,P,N)
    new_state = dA[:, :, None, None].to(xt) * ssm_state + contrib
    y = torch.einsum("bn,bhpn->bhp", Cv[:, 0].to(new_state.dtype), new_state)
    y = y + xh * p["D"].to(xt)[None, :, None]
    out = _out_proj(p, y.reshape(B, 1, H * Pd), z, cfg, hb)
    return out, (new_conv, new_state)
