"""Parameter specs and the shared layer primitives (port of
``repro/models/layers.py``).

A model is described once as a tree of :class:`P` leaves (shape, logical
axes, init rule), in the reference's layouts (``wq`` (d,H,hd), ``conv_w``
(C,W), layer stacks on a leading ``layers`` axis), so the reference's
parameter tree carries across leaf for leaf.  :func:`init_params`
materializes a spec from an explicit ``torch.Generator`` by the
reference's rules: truncated normal at +-2 sigma with sigma = 1/sqrt(fan_in)
(or the leaf's scale), and the ``zeros``, ``ones``, ``dt_bias``,
``a_log`` and ``lambda`` rules.  The two packages draw different numbers from one seed;
tests carry the reference's own weights across (:mod:`.convert`).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import tensor_parallel as tp


@dataclasses.dataclass(frozen=True)
class P:
    """Declarative parameter leaf."""
    shape: tuple
    axes: tuple                 # logical axis names, len == len(shape)
    init: str = "normal"        # normal | zeros | ones | dt_bias | a_log | lambda
    scale: float | None = None  # stddev override for normal init

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def map_spec(fn, spec):
    """Apply ``fn`` to every :class:`P` of a nested-dict spec (or to every
    leaf of a parameter tree of the same structure)."""
    if isinstance(spec, dict):
        return {k: map_spec(fn, v) for k, v in spec.items()}
    return fn(spec)


def spec_leaves(spec, path: str = "") -> list[tuple[str, P]]:
    """(path, leaf) pairs in jax's flatten order (dict keys sorted)."""
    if isinstance(spec, dict):
        return [pair for k in sorted(spec)
                for pair in spec_leaves(spec[k], f"{path}[{k!r}]")]
    return [(path, spec)]


def stack_spec(spec, n: int, axis_name: str = "layers"):
    """Prepend a stacking dim (the reference's scan-over-layers stacks)."""
    return map_spec(lambda p: P((n,) + p.shape, (axis_name,) + p.axes,
                                p.init, p.scale), spec)


def param_count(spec) -> int:
    return sum(math.prod(p.shape) for _, p in spec_leaves(spec))


_TRUNC = 2.0                                   # truncation at +-2 sigma
_CDF_LO = 0.5 * (1.0 + math.erf(-_TRUNC / math.sqrt(2.0)))
_CDF_HI = 0.5 * (1.0 + math.erf(_TRUNC / math.sqrt(2.0)))


def _uniform(shape, gen, device, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u * (hi - lo) + lo


def _truncated_normal(shape, gen, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], by the inverse CDF in f32."""
    u = _uniform(shape, gen, device, _CDF_LO, _CDF_HI)
    x = torch.erfinv(u * 2.0 - 1.0) * math.sqrt(2.0)
    return x.clamp_(-_TRUNC, _TRUNC)


def materialize(p: P, gen: torch.Generator, dtype, device) -> torch.Tensor:
    """One leaf by the reference's ``_materialize`` rules.  A stacked leaf
    is drawn one layer at a time, so the f32 scratch is one layer's."""
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "dt_bias":   # mamba2 dt bias: log-uniform dt in [1e-3, 1e-1]
        u = _uniform(p.shape, gen, device, 1e-3, 1e-1)
        return torch.log(torch.expm1(u)).to(dtype)        # inverse softplus
    if p.init == "a_log":     # mamba2 A in [1, 16]
        return torch.log(_uniform(p.shape, gen, device, 1.0, 16.0)).to(dtype)
    if p.init == "lambda":    # RG-LRU Lambda: a = sigmoid(L)^8 in [0.9, 0.999]
        r = _uniform(p.shape, gen, device, 0.9, 0.999) ** (1.0 / 8.0)
        return torch.log(r / (1 - r)).to(dtype)
    if p.init != "normal":
        raise ValueError(f"init rule {p.init!r} is not ported")
    fan_in = p.shape[0] if len(p.shape) == 1 else math.prod(p.shape[:-1])
    stacked = len(p.shape) >= 3 and p.axes[0] in ("layers", "groups", "experts")
    if stacked:
        fan_in = math.prod(p.shape[1:-1]) or 1
    std = p.scale if p.scale is not None else 1.0 / max(math.sqrt(fan_in), 1.0)
    if not stacked:
        return (_truncated_normal(p.shape, gen, device) * std).to(dtype)
    out = torch.empty(p.shape, dtype=dtype, device=device)
    for i in range(p.shape[0]):
        out[i] = _truncated_normal(p.shape[1:], gen, device) * std
    return out


def init_params(spec, gen: torch.Generator, dtype=torch.bfloat16,
                device="cpu"):
    """Materialize a spec tree, leaves drawn in jax's flatten order."""
    if isinstance(spec, dict):
        return {k: init_params(spec[k], gen, dtype, device)
                for k in sorted(spec)}
    return materialize(spec, gen, dtype, device)


# ======================================================================
# Numerics primitives
# ======================================================================

def rms_norm(x, weight, eps: float):
    """RMSNorm in f32 with the reference's ``1 + w`` scale."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(x.dtype)


def split_rms_norm(x, weight, eps: float, width: int, group):
    """:func:`rms_norm` of a last dimension split over the ``model`` ranks
    of ``group``: ``x`` and ``weight`` are this rank's block, and the mean
    square is every rank's sum of squares in f32, summed with
    ``sum_model`` (each rank's block reads it), over the whole ``width``.
    Without a group, :func:`rms_norm`."""
    if group is None:
        return rms_norm(x, weight, eps)
    xf = x.float()
    var = tp.sum_model(xf.square().sum(dim=-1, keepdim=True), group) / width
    out = xf * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(x.dtype)


def head_rms_norm(x, weight, eps: float):
    """Per-head q/k norm (qwen3): x (..., hd), weight (hd,)."""
    return rms_norm(x, weight, eps)


def silu(x):
    return x * torch.sigmoid(x)


def swiglu(x, w_gate, w_up, w_down, ctx=None):
    """The SwiGLU MLP; under a tp context with a ``model`` axis above one
    rank the weights are this rank's mlp block (w_gate, w_up columns,
    w_down rows): ``x`` enters through ``to_model`` and the partial
    output leaves through ``from_model``."""
    group = tp.model_group(ctx)
    x = tp.to_model(x, group)
    g = x @ w_gate
    u = x @ w_up
    return tp.from_model((silu(g) * u) @ w_down, group)


# ----------------------------------------------------------------------
# RoPE (supports partial rotary: stablelm rope_pct=0.25)
# ----------------------------------------------------------------------

def rope_freqs(head_dim: int, rope_pct: float, theta: float, device=None):
    rot = int(head_dim * rope_pct)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x, positions, *, rope_pct: float = 1.0,
               theta: float = 10_000.0):
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S).

    Rotates the pairs (0::2, 1::2) and interleaves them back, as the
    reference does (not the rotate-half layout)."""
    hd = x.shape[-1]
    inv, rot = rope_freqs(hd, rope_pct, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., None].float() * inv                # (..., S, rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == positions.dim() + 2:                      # head axis present
        cos, sin = cos[..., None, :], sin[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ----------------------------------------------------------------------
# Depthwise causal conv1d (mamba2 / RG-LRU frontends)
# ----------------------------------------------------------------------

def causal_conv1d(x, w, state=None, activation: bool = True):
    """x: (B, S, C); w: (C, W) depthwise causal filter, then SiLU when
    ``activation`` (the mamba2 convention; RG-LRU convs are linear).

    Returns (y, new_state); state (B, W-1, C) carries the last W-1 inputs
    for decode (zeros when None)."""
    B, S, C = x.shape
    W = w.shape[-1]
    if state is None:
        pad = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # (B, S+W-1, C)
    y = torch.zeros_like(x)
    for k in range(W):
        y = y + xp[:, k:k + S, :] * w[:, k].to(x.dtype)
    new_state = xp[:, S:, :]
    return (silu(y) if activation else y), new_state


# ----------------------------------------------------------------------
# Embedding / logits / loss (vocab padded to a multiple of 256)
# ----------------------------------------------------------------------

def embed_spec(cfg):
    return P((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), scale=0.02)


def embed_lookup(table, ids, ctx=None):
    """The embedding rows of ``ids``; under a tp context with a ``model``
    axis above one rank ``table`` is this rank's vocab block
    (``tensor_parallel.vocab_embed``)."""
    return tp.vocab_embed(table, ids, tp.model_group(ctx))


def logits_from_embed(x, table, ctx=None):
    """``x @ table.T``; under a tp context, this rank's vocab block of the
    logits (``x`` enters through ``to_model``)."""
    return tp.to_model(x, tp.model_group(ctx)) @ table.T


def softmax_xent(logits, labels, vocab_size: int, ctx=None):
    """Mean next-token cross entropy over tokens, in f32; the padded-vocab
    columns (``>= vocab_size``) are set to -1e30 (never -inf), so they add
    nothing to the log-sum-exp and get exactly 0 gradient.  Under a tp
    context ``logits`` is this rank's vocab block
    (``tensor_parallel.vocab_xent``)."""
    group = tp.model_group(ctx)
    if group is not None:
        return tp.vocab_xent(logits, labels, vocab_size, group)
    lf = logits.float()
    col = torch.arange(lf.shape[-1], device=lf.device)
    lf = torch.where(col < vocab_size, lf, lf.new_full((), -1e30))
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels[..., None].long())[..., 0]
    return (lse - gold).mean()
