"""Tensor-parallel compute over the mesh's ``model`` axis (Megatron's
operators), for the tp steps of the dense, vlm, ssm, hybrid, moe and
encdec families.

The reference has no module for this: its GSPMD steps split heads, kv
heads, mlp, the padded vocab and the experts (or each expert's ffn dim)
over ``model`` (``make_rules``,
``context.py:44-86``) and XLA places the collectives.  The port's steps
run each rank on local tensors, so each rank computes with its own block
of those leaves, read in place, while the residual stream stays whole on
every ``model`` rank, and the model moves the data itself with these
operators on the ``model`` group:

- :func:`to_model`: the identity forward, an all-reduce of the gradient
  backward: the input to a column-split product (wq, wk, wv; w_gate,
  w_up; the logits' vocab block; whisper's encoder output before the
  cross K/V);
- :func:`from_model`: an all-reduce forward, the identity backward: the
  output of a row-split product (wo, w_down, a mixer's w_out), the
  vocab-split embedding's rows, the cross entropy's sums;
- :func:`sum_model`: an all-reduce both ways: a statistic every rank's
  block feeds and every rank's block reads in its own way (mamba2's
  gated RMS norm over the split ``d_inner``);
- :func:`gather_model`: an all-gather along a dimension, for the no-grad
  serve paths (the k/v heads a replicated cache holds, the q heads
  ``sp_decode_attention`` reads); its backward raises;
- :func:`gather_model_grad`: the same all-gather handed out twice, for
  a use each rank makes of its own part of the work (its gradient
  summed over ``model``) and one every rank makes alike (its gradient
  counted once): the moe router's logits under EP, where each rank
  combines its own experts' slots and every rank holds the whole aux
  loss;
- :func:`vocab_embed`: the lookup in this rank's vocab block of the
  embedding, rows outside it 0, then an all-reduce;
- :func:`vocab_xent`: the cross entropy of vocab-split logits in f32.

Each takes the group from :func:`model_group` and is the identity (or
the plain function) when that is ``None``: no context, a mode other than
tp, or a ``model`` axis of one rank.  This module imports torch only, so
``models/layers.py`` can import it while the distributed package loads.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

NEG = -1e30


def over_model(ctx) -> bool:
    """Whether ``ctx`` is a tp context whose ``model`` axis has more than
    one rank (read from its axes: no ranks needed)."""
    return ctx is not None and ctx.mode == "tp" and \
        ctx.axes.get("model", 1) > 1


def model_group(ctx):
    """The ``model`` axis's process group of a tp context whose ``model``
    axis has more than one rank, else ``None``."""
    return ctx.group(("model",)) if over_model(ctx) else None


def _summed(x, group):
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # gloo's worker thread may still hold the all-reduced tensor for a
        # moment after the call returns: a copy, so that a leaf's gradient
        # (wk/wv, w_B, w_C, conv_w, the rec gates) is freed as soon as the
        # step's per-unit gather hands it on
        return _summed(g, ctx.group).clone(), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def _gathered(x, dim, group):
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((dist.get_world_size(group) * xt.shape[0],)
                       + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        return _gathered(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            "gather_model is for the no-grad serve paths: its gradient is "
            "this rank's block where every rank uses the gathered tensor "
            "alike, but their sum (a reduce-scatter) where each does its "
            "own part of the work, as sp_decode's slots do")


class _GatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n, ctx.group = dim, x.shape[dim], group
        whole = _gathered(x, dim, group)
        return whole, whole.clone()

    @staticmethod
    def backward(ctx, g_part, g_whole):
        g = _summed(g_part, ctx.group) + g_whole
        lo = block_start(ctx.n, ctx.group)
        return g.narrow(ctx.dim, lo, ctx.n).contiguous(), None, None


def to_model(x, group):
    """``x`` as the input of a column-split product: the identity, with
    the ``model`` ranks' gradients summed backward."""
    return x if group is None else _ToModel.apply(x, group)


def from_model(x, group):
    """The sum over the ``model`` ranks of their partial ``x`` (a
    row-split product's output); the gradient passes as it is."""
    return x if group is None else _FromModel.apply(x, group)


def sum_model(x, group):
    """The sum over the ``model`` ranks of their ``x``, where each rank
    uses the sum for its own block only: the gradient of each rank's ``x``
    is the sum of every rank's gradient of the sum (an all-reduce both
    ways).  ``from_model``'s identity backward is right only where what
    follows is the same on every rank."""
    return x if group is None else _SumModel.apply(x, group)


def gather_model(x, dim: int, group):
    """Every ``model`` rank's ``x`` concatenated along ``dim`` in rank
    order, for the serve paths, which run under ``no_grad``: its backward
    raises (the right gradient depends on how the ranks use the result)."""
    return x if group is None else _GatherModel.apply(x, dim, group)


def gather_model_grad(x, dim: int, group):
    """Every ``model`` rank's ``x`` concatenated along ``dim`` in rank
    order (an all-gather), as two tensors ``(part, whole)`` of the same
    values, differentiable: ``part`` for what each rank computes only its
    share of (its gradient summed over the ranks), ``whole`` for what every
    rank computes alike (its gradient the same on every rank, counted
    once).  The gradient of ``x`` is this rank's block of the sum of the
    two.  Without a group, ``(x, x)``."""
    return (x, x) if group is None else _GatherGrad.apply(x, dim, group)


def block_start(n_local: int, group) -> int:
    """The first global index of this rank's block of a dimension split
    evenly over ``group`` into blocks of ``n_local``."""
    return 0 if group is None else dist.get_rank(group) * n_local


def vocab_embed(table, ids, group):
    """``table[ids]`` with ``table`` this rank's vocab block: the rows of
    ids outside it are 0 here, and the all-reduce gives each id its row
    from the rank that owns it (exactly: one term is not 0).  The gradient
    reaches this block's rows only."""
    if group is None:
        return table[ids]
    n = table.shape[0]
    local = ids - block_start(n, group)
    inside = (local >= 0) & (local < n)
    rows = table[torch.where(inside, local, 0)]
    return from_model(torch.where(inside[..., None], rows,
                                  rows.new_zeros(())), group)


def vocab_xent(logits, labels, vocab_size: int, group):
    """Mean next-token cross entropy in f32 of ``logits`` (..., Vl), this
    rank's block of the padded vocab's columns: the columns whose global
    index is ``>= vocab_size`` are set to -1e30 (gradient exactly 0), then
    an all-reduce MAX of the row maxima, an all-reduce SUM of the sums of
    exps, and one of the gold logit, taken on the rank that owns the
    label.  Every rank gets the same value."""
    lf = logits.float()
    n = lf.shape[-1]
    lo = block_start(n, group)
    col = lo + torch.arange(n, device=lf.device)
    lf = torch.where(col < vocab_size, lf, lf.new_full((), NEG))
    m = lf.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    sumexp = from_model(torch.exp(lf - m[..., None]).sum(dim=-1), group)
    lse = m + torch.log(sumexp)
    local = labels.long() - lo
    inside = (local >= 0) & (local < n)
    gold = lf.gather(-1, torch.where(inside, local, 0)[..., None])[..., 0]
    gold = from_model(torch.where(inside, gold, gold.new_zeros(())), group)
    return (lse - gold).mean()
