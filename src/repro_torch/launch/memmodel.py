"""Analytic per-rank memory model (port of ``repro/launch/memmodel.py``).

It sums what one rank of the sharded program holds, term for term as the
reference does:

    params (bf16, sharded) + optimizer (f32 m/v/master, ZeRO-1 or FSDP)
    + gradients (f32) + an activation working set          [train]
    + KV/state caches (their dtype, sharded) x 2
    + decode or prefill transients                         [serve]

The reference states this as what its compiled program needs on the
accelerator; the port keeps every term unchanged (the cache counted twice
for an input and an output buffer, the activations' fixed multipliers), so
the two packages give the same numbers.  How far the port's eager program
on a card lies from it is a measurement (``chip_smoke.py`` prints the
model beside every peak it measures), not a refit.

Nothing is allocated: the parameters come from the model's ``P`` spec,
the cache from :func:`repro_torch.distributed.steps.cache_specs` (shapes
on the ``meta`` device).  ``fits_hbm`` compares the total with the
``hbm_bytes`` the caller passes: the card's memory, or any other budget.
"""
from __future__ import annotations

import math

from repro_torch.distributed.sharding import (
    cache_shardings, fsdp_sharding, map_tree,
)
from repro_torch.distributed.steps import cache_specs
from repro_torch.models.layers import spec_leaves


def _shard_factor(pspec, mesh_shape: dict) -> int:
    """How many ways a spec splits its tensor over the mesh."""
    f = 1
    for entry in pspec:
        if entry is None:
            continue
        for ax in ((entry,) if isinstance(entry, str) else entry):
            f *= mesh_shape[ax]
    return f


def _tree_bytes(spec_tree, ctx, mesh_shape, bytes_per_el: float,
                zero1: bool = False) -> float:
    """Sharded bytes summed over a ``P`` spec, each leaf at
    ``ctx.pspec(axes)``; ``zero1`` also splits a leaf over the data axes
    on its first unsharded dim they divide."""
    total = 0.0
    data_axes = ctx.rules.get("batch") or ()
    if isinstance(data_axes, str):
        data_axes = (data_axes,)
    dsize = math.prod(mesh_shape[a] for a in data_axes) if data_axes else 1
    for _, p in spec_leaves(spec_tree):
        n = float(math.prod(p.shape))
        ps = list(ctx.pspec(p.axes))
        f = _shard_factor(ps, mesh_shape)
        if zero1 and dsize > 1:
            # extra data-axis sharding on the first divisible unsharded dim
            ps_padded = ps + [None] * (len(p.shape) - len(ps))
            for i, dim in enumerate(p.shape):
                if ps_padded[i] is None and dim % dsize == 0:
                    f *= dsize
                    break
        total += n / f * bytes_per_el
    return total


def _leaves(tree) -> list:
    """A cache-like tree's leaves in jax's flatten order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def model_memory(cfg, shape, ctx, tc, lm, *, hbm_bytes: float) -> dict:
    """Bytes a rank holds for one (config, shape) cell under ``ctx``'s
    mesh and mode: ``params``, then ``opt``, ``grads`` and ``activations``
    for a train shape, or ``cache`` and ``activations`` for a prefill or
    decode shape; ``total``, their sum, and ``fits_hbm``, whether it is at
    most ``hbm_bytes``.  ``lm`` is the port's ``LM`` (its spec is read,
    nothing is allocated); ``tc`` a ``TrainConfig`` (its microbatches)."""
    mesh_shape = dict(ctx.axes)
    n_data = int(math.prod(mesh_shape[a] for a in
                           (ctx.rules.get("batch") or ()))) or 1
    spec = lm.spec
    params = _tree_bytes(spec, ctx, mesh_shape, 2.0)          # bf16
    out = {"params": params}

    d, L, Vp = cfg.d_model, cfg.num_layers, cfg.padded_vocab
    vshard = mesh_shape.get("model", 1)

    if shape.kind == "train":
        if ctx.mode == "fsdp":
            # params/opt/grads all share the fully-sharded layout
            tot = 0.0
            for _, p in spec_leaves(spec):
                f = _shard_factor(fsdp_sharding(ctx, p.axes, p.shape),
                                  mesh_shape)
                tot += float(math.prod(p.shape)) / f
            out["params"] = tot * 2.0
            out["opt"] = tot * 12.0
            out["grads"] = tot * 4.0
        else:
            out["opt"] = _tree_bytes(spec, ctx, mesh_shape, 12.0, zero1=True)
            out["grads"] = out["params"] * 2.0  # f32, sharded like params
        mb_tokens = shape.tokens_per_step / max(tc.microbatches, 1) / n_data
        resid = L * mb_tokens * d * 2.0                        # layer carries
        logits = mb_tokens * Vp / vshard * 4.0                 # f32 xent
        layer_ws = mb_tokens * max(cfg.d_ff or d, 4 * d) * 4.0 * 4
        out["activations"] = resid + logits + layer_ws
    else:
        B = shape.global_batch
        cache = 0.0
        specs = cache_specs(lm, B, shape.seq_len)
        placed = cache_shardings(ctx, lm.cache_axes(ctx), B)
        pairs = _leaves(map_tree(lambda s, ps: (s, ps), specs, placed))
        for leaf, ps in pairs:
            f = _shard_factor(ps, mesh_shape)
            cache += (float(math.prod(leaf.shape)) * leaf.dtype.itemsize
                      / f)
        out["cache"] = cache * 2.0  # an input and an output buffer
        toks = (shape.seq_len if shape.kind == "prefill" else 1)
        out["activations"] = (B / n_data) * toks * max(d * 6, 1) * 2.0 + \
            (B / n_data) * Vp / vshard * 4.0

    out["total"] = float(sum(out.values()))
    out["fits_hbm"] = out["total"] <= hbm_bytes
    return out
