"""RecurrentGemma / Griffin recurrent block (port of
``repro/models/griffin.py``): RG-LRU [arXiv:2402.19427].

Temporal mixing: x -> linear -> causal conv1d (linear) -> RG-LRU, gated by a
GeLU branch (the tanh approximation, ``jax.nn.gelu``'s default; see
:func:`gelu_tanh`).  The reference's model runs the prefill recurrence as
an XLA ``associative_scan`` and keeps the Pallas kernel as the TPU's route;
the port's prefill goes through
:func:`repro_torch.kernels.rg_lru.ops.rglru_scan` (the CUDA kernel on the
card, its plain version on the CPU), from a zero state: no caller passes
an initial state on prefill.  Training goes through the same call: under
grad it runs the scan's ``autograd.Function``, whose backward is the
hand-written backward kernel on the card and the plain backward on the
CPU.  The one-token decode step is plain PyTorch,
as in the reference.  Gates and coefficients are f32.

Under a tp context whose rules split ``lru`` over a ``model`` axis above
one rank, each rank holds its block of the width, read in place
(:func:`width_block`): ``w_gate``, ``w_x``, ``conv_w``, ``gate_a_b``,
``gate_x_b``, ``lambda_p`` and ``w_out``'s rows, and the conv and lru
states; the input enters through ``to_model``, the block-diagonal gates
(whole on every rank) give this rank its ``NUM_BLOCKS / R`` blocks
through ``to_model``, the scan runs on this rank's width and ``w_out``'s
partial output leaves through ``from_model``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.rg_lru.ops import rglru_scan as _scan
from repro_torch.models.layers import P, causal_conv1d

LRU_C = 8.0          # RG-LRU exponent constant
NUM_BLOCKS = 8       # block-diagonal gate projections


def rglru_spec(cfg):
    d, w = cfg.d_model, cfg.lru_width
    k = w // NUM_BLOCKS
    return {
        "w_gate": P((d, w), ("embed", "lru")),
        "w_x": P((d, w), ("embed", "lru")),
        "conv_w": P((w, cfg.conv_width), ("lru", None)),
        "gate_a_w": P((NUM_BLOCKS, k, k), ("lru_block", None, None)),
        "gate_a_b": P((w,), ("lru",), init="zeros"),
        "gate_x_w": P((NUM_BLOCKS, k, k), ("lru_block", None, None)),
        "gate_x_b": P((w,), ("lru",), init="zeros"),
        "lambda_p": P((w,), ("lru",), init="lambda"),
        "w_out": P((w, d), ("lru", "embed")),
    }


def gelu_tanh(x):
    """``jax.nn.gelu(x)`` (the tanh approximation) op for op in x's dtype,
    with its constants rounded to that dtype as jax rounds weak-typed
    scalars: bit for bit the reference's in bf16.  ``F.gelu(x,
    approximate="tanh")`` computes in f32 with f32 constants and differs
    from it by one bf16 ulp in about four elements of ten."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))


def _block_diag(x, w, b):
    """x (B,S,w) through the block-diagonal projection w (nb,k,k)."""
    B, S, W = x.shape
    nb, k, _ = w.shape
    y = torch.einsum("bsnk,nkj->bsnj", x.reshape(B, S, nb, k), w)
    return y.reshape(B, S, W) + b.to(y.dtype)


def _rglru_coeffs(p, x):
    """Gates and coefficients: (a, gated input), both f32 (B,S,w)."""
    r = torch.sigmoid(_block_diag(x, p["gate_a_w"], p["gate_a_b"]).float())
    i = torch.sigmoid(_block_diag(x, p["gate_x_w"], p["gate_x_b"]).float())
    log_a = -LRU_C * F.softplus(p["lambda_p"].float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12))
    return a, beta * i * x.float()


def rglru_scan(p, x):
    """The recurrence over a whole prompt from a zero state.
    x (B,S,w) -> (y (B,S,w), final_state (B,w)), both in x's dtype."""
    a, bx = _rglru_coeffs(p, x)
    h, last = _scan(a, bx)
    return h.to(x.dtype), last.to(x.dtype)


def rglru_step(p, x, state):
    """One decode step.  x (B,1,w), state (B,w)."""
    a, bx = _rglru_coeffs(p, x)
    h = a[:, 0] * state.float() + bx[:, 0]
    return h[:, None, :].to(x.dtype), h.to(x.dtype)


@dataclass(frozen=True)
class WidthBlock:
    """A tp rank's block of the RG-LRU width: the ``model`` group and the
    gates' blocks [first, first + blocks), with their channels."""
    group: object
    first: int
    blocks: int


def check_tp(cfg, ctx) -> None:
    """Raises ``NotImplementedError`` where ``ctx`` splits ``lru`` over a
    ``model`` axis above one rank that does not divide ``NUM_BLOCKS``: a
    rank's width would cut through a block of the gates.  Reads the rules
    only (no ranks)."""
    if tp.over_model(ctx) and ctx.rules.get("lru") is not None and \
            NUM_BLOCKS % ctx.axes["model"]:
        raise NotImplementedError(
            f"{cfg.name}: tp splits the RG-LRU width ({cfg.lru_width}) over "
            f"{ctx.axes['model']} 'model' ranks, which do not divide its "
            f"{NUM_BLOCKS} gate blocks, so a rank's width cuts through a "
            f"block")


def width_block(cfg, ctx) -> WidthBlock | None:
    """This rank's block of the width under ``ctx``: ``None`` without a tp
    ``model`` group or where the rules leave ``lru`` whole (then the mixer
    runs whole on every rank)."""
    check_tp(cfg, ctx)
    group = tp.model_group(ctx)
    if group is None or ctx.rules.get("lru") is None:
        return None
    blocks = NUM_BLOCKS // dist.get_world_size(group)
    return WidthBlock(group, dist.get_rank(group) * blocks, blocks)


def recurrent_forward(p, x_res, cfg, conv_state=None, lru_state=None,
                      decode: bool = False, ctx=None):
    """The Griffin recurrent mixer.  x_res (B,S,d) -> (y (B,S,d),
    (conv_state, lru_state)).  Prefill (``decode=False``) starts from zero
    states; decode takes one token and the cached states; under a tp
    context, this rank's width (module docstring)."""
    wb = width_block(cfg, ctx)
    group = None if wb is None else wb.group
    if wb is not None:
        p = {**p, **{n: tp.to_model(p[n], group).narrow(0, wb.first,
                                                        wb.blocks)
                     for n in ("gate_a_w", "gate_x_w")}}
    x_res = tp.to_model(x_res, group)
    gate = gelu_tanh(x_res @ p["w_gate"])
    xl = x_res @ p["w_x"]
    xl, new_conv = causal_conv1d(xl, p["conv_w"], conv_state, activation=False)
    if decode:
        h, new_state = rglru_step(p, xl, lru_state)
    else:
        h, new_state = rglru_scan(p, xl)
    return tp.from_model((gate * h) @ p["w_out"], group), (new_conv,
                                                           new_state)
