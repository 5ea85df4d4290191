"""Tensor-parallel compute over the mesh's ``model`` axis (Megatron's
operators), for the tp steps of the dense and vlm families.

The reference has no module for this: its GSPMD steps split heads, kv
heads, mlp and the padded vocab over ``model`` (``make_rules``,
``context.py:44-86``) and XLA places the collectives.  The port's steps
run each rank on local tensors, so each rank computes with its own block
of those leaves, read in place, while the residual stream stays whole on
every ``model`` rank, and the model moves the data itself with these
operators on the ``model`` group:

- :func:`to_model`: the identity forward, an all-reduce of the gradient
  backward: the input to a column-split product (wq, wk, wv; w_gate,
  w_up; the logits' vocab block);
- :func:`from_model`: an all-reduce forward, the identity backward: the
  output of a row-split product (wo, w_down), the vocab-split
  embedding's rows, the cross entropy's sums;
- :func:`gather_model`: an all-gather along a dimension, for the no-grad
  serve paths (the k/v heads a replicated cache holds, the q heads
  ``sp_decode_attention`` reads); its backward raises;
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


def model_group(ctx):
    """The ``model`` axis's process group of a tp context whose ``model``
    axis has more than one rank, else ``None``."""
    if ctx is None or ctx.mode != "tp" or ctx.axes.get("model", 1) <= 1:
        return None
    return ctx.group(("model",))


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
        return _summed(g, ctx.group), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((dist.get_world_size(group) * xt.shape[0],)
                           + tuple(xt.shape[1:]))
        dist.all_gather_into_tensor(out, xt, group=group)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            "gather_model is for the no-grad serve paths: its gradient is "
            "this rank's block where every rank uses the gathered tensor "
            "alike, but their sum (a reduce-scatter) where each does its "
            "own part of the work, as sp_decode's slots do")


def to_model(x, group):
    """``x`` as the input of a column-split product: the identity, with
    the ``model`` ranks' gradients summed backward."""
    return x if group is None else _ToModel.apply(x, group)


def from_model(x, group):
    """The sum over the ``model`` ranks of their partial ``x`` (a
    row-split product's output); the gradient passes as it is."""
    return x if group is None else _FromModel.apply(x, group)


def gather_model(x, dim: int, group):
    """Every ``model`` rank's ``x`` concatenated along ``dim`` in rank
    order, for the serve paths, which run under ``no_grad``: its backward
    raises (the right gradient depends on how the ranks use the result)."""
    return x if group is None else _GatherModel.apply(x, dim, group)


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
