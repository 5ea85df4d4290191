"""Placement trees for parameters, optimizer state (ZeRO-1 or FSDP),
batches and caches (port of ``repro/distributed/sharding.py``).

Every function returns specs (see :mod:`.context`), in trees of the same
nested dicts as the trees they describe; ``ctx.placements(spec)`` gives a
leaf's DTensor placements.  The trees come from a model's ``P`` spec
(:func:`axes_tree`, :func:`shapes_tree`), so nothing is allocated and full
configs cost nothing.  The reference's ``shard_map`` version shim has no
counterpart here.
"""
from __future__ import annotations

import math

from repro_torch.distributed.context import DistContext
from repro_torch.models.layers import map_spec
from repro_torch.optim.optimizer import OptState


def axes_tree(spec):
    """The logical axes of every leaf of a ``P`` spec."""
    return map_spec(lambda p: p.axes, spec)


def shapes_tree(spec):
    """The shape of every leaf of a ``P`` spec."""
    return map_spec(lambda p: p.shape, spec)


def map_tree(fn, *trees):
    """``fn`` over the leaves of trees of the same nested dicts (a spec,
    a tuple, is a leaf)."""
    if isinstance(trees[0], dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def fsdp_sharding(ctx: DistContext, axes: tuple, shape: tuple) -> tuple:
    """Fully shard a parameter over every mesh axis (ZeRO-3/FSDP): the first
    dim divisible by the whole mesh gets all its axes; else the first dim
    divisible by the model axis gets it; tiny leaves stay replicated."""
    mesh_axes = tuple(ctx.axes)
    total = math.prod(ctx.axes.values())
    spec: list = [None] * len(shape)
    for i, dim in enumerate(shape):
        if dim % total == 0:
            spec[i] = mesh_axes if len(mesh_axes) > 1 else mesh_axes[0]
            return tuple(spec)
    msize = ctx.axes.get("model", 1)
    for i, dim in enumerate(shape):
        if msize > 1 and dim % msize == 0:
            spec[i] = "model"
            return tuple(spec)
    return tuple(spec)


def params_shardings(ctx: DistContext, axes, shapes=None):
    """A logical-axes tree (the params' structure) -> a spec tree; FSDP
    needs the shapes too."""
    if ctx.mode == "fsdp":
        if shapes is None:
            raise ValueError("fsdp placements need the parameters' shapes")
        return map_tree(lambda a, s: fsdp_sharding(ctx, a, s), axes, shapes)
    return map_tree(ctx.pspec, axes)


def data_axes(ctx: DistContext) -> tuple:
    """The mesh axes the batch is split over."""
    m = ctx.rules.get("batch")
    if m is None:
        return ()
    return (m,) if isinstance(m, str) else tuple(m)


def _size(ctx: DistContext, axes: tuple) -> int:
    return math.prod(ctx.axes[a] for a in axes)


def zero1_sharding(ctx: DistContext, axes: tuple, shape: tuple) -> tuple:
    """The parameter's spec, plus the data axes on its first unsharded dim
    they divide (ZeRO-1: optimizer state sharded over the data ranks)."""
    base = ctx.pspec(axes)
    data = data_axes(ctx)
    dsize = _size(ctx, data)
    used = set()
    for entry in base:
        if entry is not None:
            used.update((entry,) if isinstance(entry, str) else entry)
    if dsize <= 1 or used & set(data):
        return base      # already data-sharded (as EP's expert ffn is)
    spec = list(base) + [None] * (len(shape) - len(base))
    for i, dim in enumerate(shape):
        if spec[i] is None and dim % dsize == 0:
            spec[i] = data if len(data) > 1 else data[0]
            break
    return tuple(spec)


def opt_shardings(ctx: DistContext, axes, shapes) -> OptState:
    """Specs of ``OptState(step, m, v, master)``: the step replicated, the
    rest by FSDP or ZeRO-1."""
    one = fsdp_sharding if ctx.mode == "fsdp" else zero1_sharding
    tree = map_tree(lambda a, s: one(ctx, a, s), axes, shapes)
    return OptState((), tree, tree, tree)


def batch_pspec(ctx: DistContext, global_batch: int):
    """The batch dim's entry: the data axes when they divide it, else None
    (replicated)."""
    data = data_axes(ctx)
    dsize = _size(ctx, data)
    if dsize > 1 and global_batch % dsize == 0:
        return data if len(data) > 1 else data[0]
    return None


def batch_shardings(ctx: DistContext, batch_tree, global_batch: int):
    """Specs of a batch's leaves (anything with ``.shape``): the batch dim
    by :func:`batch_pspec`, the rest replicated."""
    b = batch_pspec(ctx, global_batch)
    return map_tree(lambda leaf: (b,) + (None,) * (len(leaf.shape) - 1),
                    batch_tree)


def cache_shardings(ctx: DistContext, cache_axes, global_batch: int):
    """A cache's logical-axes tree -> specs, the batch rule adjusted for a
    small batch (the reference's ``cache_shardings``, which reads its
    abstract cache only for the tree's structure)."""
    b = batch_pspec(ctx, global_batch)

    def one(axes):
        spec, used = [], set()
        for ax in axes:
            val = b if ax == "batch" else (
                ctx.rules.get(ax) if ax is not None else None)
            if isinstance(val, (tuple, list)):
                val = tuple(a for a in val if a not in used) or None
            if isinstance(val, str) and val in used:
                val = None
            if val is not None:
                used.update((val,) if isinstance(val, str) else val)
            spec.append(val)
        return tuple(spec)

    return map_tree(one, cache_axes)
