"""The data-parallel train step and the serve steps (port of
``repro/distributed/steps.py``: ``input_specs``, ``cache_specs``,
``build_train_step``, ``build_prefill_step`` and ``build_decode_step``) on
``torch.distributed``.

The reference jits its steps over sharded inputs and lets GSPMD place the
collectives.  Here every rank runs a step on local tensors and moves the
data itself:

- the parameters are DTensors at :func:`~.sharding.params_shardings`'
  placements (FSDP: sharded over every mesh axis; ``tp``: split over
  ``model`` by the rules, but for EP's expert ff dim over the data axes),
  m, v and master at :func:`~.sharding.opt_shardings`' (FSDP, or ZeRO-1:
  sharded over the data ranks), the step count a replicated tensor;
- one step runs ``LM.loss`` and its backward on this rank's rows of each
  microbatch through :class:`~.fsdp.UnitGather` (``distributed/fsdp.py``):
  ``LM`` reads a tree of refs to this rank's shards, and each unit (a
  layer of a stack, a group of a hybrid's pattern, a layer of its tail or
  of whisper's encoder and decoder, a leaf outside the stacks where ``LM``
  uses it) is gathered just before it runs and freed just after; the
  backward gathers it again before its own backward and hands each full
  gradient, as soon as the unit's backward has made it, to
  :class:`~.fsdp.GradShards`, which reduces it to this rank's shard at
  the leaf's optimizer placement (the mean over the batch group: a
  reduce-scatter, a reduce to the owning rank for a leaf split on its
  layers dimension, an all-reduce where the leaf is not split over the
  batch axes) and sums the microbatches in f32 (the reference's
  ``steps.py:62-82``); then the global gradient norm with every element
  counted once, ``adamw_update``'s arithmetic on the local shards, and the
  new parameters (the masters cast to the parameters' dtype) moved to
  their placements (FSDP: where they already are; ZeRO-1: gathered).

Between steps a rank holds its shard of every parameter and of m, v and
master; within a step, one unit's gathered parameters at a time and its
gradient shards (for ``fsdp``, ``launch/memmodel.py``'s accounting: params,
optimizer state and gradients at 1/world each), as the reference's GSPMD
step gathers inside its layer scan.  A unit's full gradients live until
its backward has reduced them; the tied embedding's two uses add theirs
first.  Leaves not split over a mesh axis of more than one rank are not
gathered but read in place, so at world size 1 nothing moves.

Microbatch i is the global batch's rows ``[i B/n, (i+1) B/n)``, as the
reference reshapes it; each rank takes its block of every microbatch, so a
moe layer routes the same tokens together as the reference does: the
microbatch's global tokens, or with ``ctx.extra["moe_impl"] ==
"shardmap"`` this rank's own rows of it (``models/moe.py``
``moe_ffn_shardmap``, local routing).  At world size 1 no leaf is
gathered, no gradient reduced and the new parameters stay where AdamW
made them, so the step is ``train_step``'s arithmetic op for op, each
gradient in the parameters' dtype (with ``shardmap``, the local routing's
op for op).  Each step function keeps the last call's
:class:`~.fsdp.UnitGather` ``stats`` in its ``gather_stats`` attribute.

The serve steps gather the parameters the same way, a unit at a time
under ``torch.no_grad()`` (a decode step gathers every unit for every
token: FSDP's price for serving), and run
``LM.prefill``/``LM.decode_step`` on this rank's rows of the global batch
(:func:`~.sharding.batch_pspec`) with the context, so a moe layer routes
the batch group's tokens (under ``shardmap``, this rank's).  The cache is
a tree of DTensors at
:func:`~.sharding.cache_shardings`' placements (each rank its rows) plus
the host-side ``filled`` count, which no placement describes; the decode
step updates the local caches in place.  The logits come out at
``(batch_pspec, rules["vocab"])``.  With ``ctx.sp_decode`` the full
attention layers decode through
:func:`~.decode_attn.sp_decode_attention`.

``mode="tp"`` with a ``model`` axis above 1 runs tensor-parallel compute
over that axis for every family (:mod:`~.tensor_parallel`): each rank
reads its block of every leaf the rules split over ``model`` (heads, kv
heads, mlp, ssm heads and ``d_inner``, the lru width, the padded vocab,
the experts under EP or each expert's ffn dim under expert-TP, the
router's columns under EP) in place, never gathered (``split_of``'s
``in_place``; an EP expert's ffn dim split over the data axes is gathered
over those), the context reaches the model, whose products meet the
whole residual stream through the ``model`` group's all-reduces (a leaf
replicated over ``model`` that each rank uses for its own heads or width
only has its gradient summed over ``model`` there:
``transformer._partly_used``, ``ssm._own_params``, the rec gates; so has
whisper's encoder output, which each rank's cross attention reads for
its own heads).  The logits leave as this rank's vocab block; a
prefill's cache holds this rank's block of the ssm heads and the lru
width as the model wrote it, and its attention slots (an encdec's self
and cross K/V too), written whole on every rank, leave as this rank's
block under ``sp_decode`` (the self slots only).  A moe layer routes the
same tokens on every ``model`` rank, as at one rank, under either
routing (``models/moe.py``).  Every step builder raises there for an ssm
config whose rules split ``d_inner`` but not its heads, and for a hybrid
one whose ``model`` axis does not divide the RG-LRU's gate blocks.
``build_decode_step`` in ``fsdp`` with ``ctx.sp_decode`` raises for a
config whose decode reaches ``sp_decode_attention``, where the
reference fails too.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor import zeros as dzeros

from repro_torch.core.reducer import tree_flatten_with_path, tree_map_with_path
from repro_torch.distributed.context import DistContext
from repro_torch.distributed import tensor_parallel
from repro_torch.distributed.fsdp import (
    GradShards, UnitGather, read_shapes, split_of,
)
from repro_torch.distributed.sharding import (
    map_tree, axes_tree, batch_pspec, batch_shardings, cache_shardings,
    data_axes, opt_shardings, params_shardings, shapes_tree,
)
from repro_torch.models import griffin, ssm
from repro_torch.models.layers import spec_leaves
from repro_torch.optim.optimizer import OptState, adamw_update


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype (the reference's ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg, shape, dtype=torch.bfloat16) -> dict:
    """The model inputs of one (arch x shape) cell, as :class:`TensorSpec`."""
    B, S = shape.global_batch, shape.seq_len
    n_text = S - (cfg.num_patches if cfg.family == "vlm" else 0)
    if shape.kind == "train":
        out = {"tokens": TensorSpec((B, n_text + 1), torch.int32)}
    elif shape.kind == "prefill":
        out = {"tokens": TensorSpec((B, n_text), torch.int32)}
    else:
        out = {"token": TensorSpec((B, 1), torch.int32)}
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            out["vision_embeds"] = TensorSpec((B, cfg.num_patches,
                                               cfg.d_model), dtype)
        if cfg.family == "encdec":
            out["encoder_frames"] = TensorSpec((B, cfg.encoder_seq,
                                                cfg.d_model), dtype)
    return out


def cache_specs(lm, B: int, cache_len: int, dtype=torch.bfloat16) -> dict:
    """The cache of ``B`` sequences of ``cache_len`` slots (``LM.init_cache``'s
    tree without its host-side ``filled`` count) as :class:`TensorSpec`;
    the shapes come from the ``meta`` device, so nothing is allocated."""
    from repro_torch.models import encdec, transformer
    init = encdec.init_cache if lm.cfg.family == "encdec" else \
        transformer.init_cache
    cache = init(lm.cfg, B, cache_len, dtype, torch.device("meta"))
    del cache["filled"]
    return map_tree(lambda t: TensorSpec(tuple(t.shape), t.dtype), cache)


def _check_mode(ctx: DistContext, cfg) -> None:
    """Raises before a step is built where tp over ``model`` cannot run
    ``cfg``: a split the ssm and rec mixers refuse (``ssm.check_tp``,
    ``griffin.check_tp``)."""
    if not tensor_parallel.over_model(ctx):
        return
    kinds = set(cfg.layer_kinds())
    if "ssm" in kinds:
        ssm.check_tp(cfg, ctx)
    if "rec" in kinds:
        griffin.check_tp(cfg, ctx)


# ----------------------------------------------------------------------
# moving whole trees in and out
# ----------------------------------------------------------------------

def _named_axes(spec) -> set:
    return {a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)}


def distribute_tree(tree, ctx: DistContext, specs):
    """Full tensors (the same on every rank) -> DTensors at ``specs``.  A
    leaf whose spec names no mesh axis of more than one rank is its own
    local tensor (aliased, not copied); each rank copies its block of the
    others out of its own full tensor (``distribute_tensor`` with
    ``src_data_rank=None``: nothing is sent)."""
    def one(t, s):
        pl = ctx.placements(s)
        if all(ctx.axes[a] == 1 for a in _named_axes(s)):
            return DTensor.from_local(t, ctx.mesh, pl, run_check=False,
                                      shape=t.shape, stride=t.stride())
        return distribute_tensor(t, ctx.mesh, pl, src_data_rank=None)
    return map_tree(one, tree, specs)


def gather_tree(tree):
    """DTensors -> full tensors on every rank (other leaves as they are)."""
    return tree_map_with_path(
        lambda _, t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def init_sharded_opt_state(ctx: DistContext, params,
                           opt_specs: OptState) -> OptState:
    """``optim.init_opt_state`` of DTensor parameters, each leaf of m, v and
    master made at its ``opt_specs`` placement (no full f32 copy on any
    rank)."""
    def master(p, s):
        return p.redistribute(ctx.mesh, ctx.placements(s)).to(
            torch.float32, copy=True)

    def zeros(p, s):
        return dzeros(p.shape, dtype=torch.float32, device_mesh=ctx.mesh,
                      placements=ctx.placements(s))
    device = next(iter(tree_flatten_with_path(params)))[1].device
    return OptState(torch.zeros((), dtype=torch.int32, device=device),
                    map_tree(zeros, params, opt_specs.m),
                    map_tree(zeros, params, opt_specs.v),
                    map_tree(master, params, opt_specs.master))


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------

def build_train_step(lm, tc, ctx: DistContext, shape):
    """Returns ``(step_fn, (param_specs, opt_specs, batch_specs))``.

    ``step_fn(params, opt, batch) -> (params, opt, {"loss", "lr",
    "grad_norm"})``: ``params`` DTensors at ``param_specs``, ``opt`` an
    ``OptState`` of DTensors at ``opt_specs`` (:func:`init_sharded_opt_state`),
    ``batch`` the global batch (the same arrays on every rank; each rank
    reads its rows).  m, v and master are updated in place, as
    ``adamw_update`` does.  ``step_fn.gather_stats``: the last step's
    gather statistics; ``step_fn.grad_sq``: {path: the last step's sum of
    squares of that leaf's gradient over every rank}, the terms of the
    grad norm (device scalars)."""
    cfg = lm.cfg
    _check_mode(ctx, cfg)
    n_micro = max(tc.microbatches, 1)
    B = shape.global_batch
    axes, shapes = axes_tree(lm.spec), shapes_tree(lm.spec)
    p_sh = params_shardings(ctx, axes, shapes)
    o_sh = opt_shardings(ctx, axes, shapes)
    b_sh = batch_shardings(ctx, input_specs(cfg, shape), B)

    mesh, names = ctx.mesh, tuple(ctx.axes)
    split = batch_pspec(ctx, B) is not None
    group = ctx.batch_group() if split else None
    batch_axes = tuple(a for a in data_axes(ctx) if ctx.axes[a] > 1) \
        if split else ()
    n_ranks = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    if B % n_micro or (B // n_micro) % n_ranks:
        raise ValueError(f"a batch of {B} rows in {n_micro} microbatches "
                         f"does not split over {n_ranks} ranks")
    rows = B // n_micro // n_ranks
    # the context reaches the moe layers where the batch is split, always
    # under local routing, whose capacity is its own, and the layers that
    # split their compute over a 'model' axis above one rank
    loss_ctx = (ctx if group is not None or ctx.axes.get("model", 1) > 1
                or ctx.extra.get("moe_impl") == "shardmap" else None)
    p_pl = {k: ctx.placements(s) for k, s in spec_leaves(p_sh)}
    o_pl = {k: ctx.placements(s) for k, s in spec_leaves(o_sh.m)}
    p_split = functools.cache(functools.partial(_splits, ctx, p_sh))
    o_split = functools.cache(functools.partial(_splits, ctx, o_sh.m))
    stats = {}
    norm_group = ctx.group(names)
    coord = mesh.get_coordinate() if norm_group is not None else None
    # a leaf's squares are added by the ranks at coordinate 0 of every mesh
    # axis it is replicated over, so each element counts once
    once = torch.tensor(
        [float(all(c == 0 for c, pl in zip(coord, o_pl[k])
                   if isinstance(pl, Replicate)))
         for k in o_pl] if coord is not None else [], dtype=torch.float32)

    grad_sq = {}

    def norm_reduce(sq):
        if norm_group is not None:
            sq = sq * once.to(sq.device)
            dist.all_reduce(sq, group=norm_group)
        grad_sq.update(zip(o_pl, sq))
        return sq

    def place(t, src, dst, like):
        """This rank's ``t`` at placements src -> a DTensor at dst."""
        return DTensor.from_local(t, mesh, src, run_check=False,
                                  shape=like.shape, stride=like.stride()
                                  ).redistribute(mesh, dst)

    def step_fn(params, opt: OptState, batch):
        sink = GradShards(params, read_shapes(params, p_split()), o_split(),
                          batch_axes, group, n_micro)
        stats.clear()
        loss = None
        for i in range(n_micro):
            lo = i * (B // n_micro) + rank * rows
            mb = {k: v[lo:lo + rows] for k, v in batch.items()}
            gather = UnitGather(params, p_split(), sink)
            value, _ = lm.loss(gather.refs, mb, loss_ctx, remat=tc.remat,
                               gather=gather)
            value.backward()
            gather.finish()
            sink.end_microbatch()
            for k, v in gather.stats.items():
                stats[k] = max(stats.get(k, 0), v)
            loss = value.detach() if loss is None else loss + value.detach()
            del value, gather
        if n_micro > 1:
            loss = loss / n_micro
        if group is not None:          # the mean of the ranks' row means
            dist.all_reduce(loss, group=group)
            loss = loss / n_ranks
        with torch.no_grad():
            g_local = sink.result()
            del sink

            def local(t):
                return tree_map_with_path(lambda _, x: x.to_local(), t)
            state, new_local, metrics = adamw_update(
                tc, OptState(opt.step, local(opt.m), local(opt.v),
                             local(opt.master)),
                tree_map_with_path(lambda k, _: g_local[k], params),
                local(params), norm_reduce=norm_reduce)
            del g_local
            params_by = dict(tree_flatten_with_path(params))
            new_params = tree_map_with_path(
                lambda k, w: place(w, o_pl[k], p_pl[k], params_by[k]),
                new_local)
        return (new_params, OptState(state.step, opt.m, opt.v, opt.master),
                {"loss": loss, **metrics})

    step_fn.gather_stats = stats
    step_fn.grad_sq = grad_sq
    return step_fn, (p_sh, o_sh, b_sh)



# ----------------------------------------------------------------------
# the serve steps
# ----------------------------------------------------------------------

def _serve_layout(lm, ctx: DistContext, shape):
    """The serve steps' specs (parameters, batch, cache, logits) and the
    (first row, rows) of the global batch this rank serves."""
    B = shape.global_batch
    specs = (params_shardings(ctx, axes_tree(lm.spec), shapes_tree(lm.spec)),
             batch_shardings(ctx, input_specs(lm.cfg, shape), B),
             cache_shardings(ctx, lm.cache_axes(ctx), B),
             (batch_pspec(ctx, B), ctx.rules.get("vocab")))
    if batch_pspec(ctx, B) is None:
        return specs, 0, B
    group = ctx.batch_group()
    rows = B // dist.get_world_size(group)
    return specs, dist.get_rank(group) * rows, rows


def _splits(ctx: DistContext, specs) -> dict:
    """Each parameter's :class:`~.fsdp.Split`, by path (read from the
    mesh at a step's first call: a step is built without ranks too).  A
    tp step reads its blocks over ``model`` in place (tensor-parallel
    compute, ``tensor_parallel.py``)."""
    in_place = ("model",) if ctx.mode == "tp" else ()
    return {k: split_of(ctx, ctx.placements(s), in_place)
            for k, s in spec_leaves(specs)}


def _place(ctx: DistContext, t, spec):
    """This rank's block of an evenly split tensor -> a DTensor at spec."""
    return DTensor.from_local(t, ctx.mesh, ctx.placements(spec),
                              run_check=False)


def _own_slots(ctx: DistContext, cache: dict, axes: dict) -> dict:
    """A prefill's cache (its rows this rank's; the leaves the layers split
    over ``model`` already this rank's block, ``transformer.init_cache``)
    -> this rank's block of the attention slots the model wrote whole on
    every rank, where ``axes`` (``LM.cache_axes``) puts them on
    ``cache_seq`` and the rules split that over ``model`` (``sp_decode``),
    copied out so the whole one is freed."""
    group = tensor_parallel.model_group(ctx)
    if group is None or ctx.rules.get("cache_seq") != "model":
        return cache

    def one(t, ax):
        if "cache_seq" not in ax:
            return t
        d = ax.index("cache_seq")
        n = t.shape[d] // dist.get_world_size(group)
        return t.narrow(d, dist.get_rank(group) * n, n).clone()
    return {**map_tree(one, {k: cache[k] for k in axes}, axes),
            "filled": cache["filled"]}


def _place_cache(ctx: DistContext, cache: dict, specs: dict) -> dict:
    """A local cache -> DTensors at ``specs``, ``filled`` kept as it is."""
    return {**map_tree(lambda t, s: _place(ctx, t, s),
                       {k: cache[k] for k in specs}, specs),
            "filled": cache["filled"]}


def _reaches_sp_decode(cfg) -> bool:
    """Whether a decode step runs ``sp_decode_attention`` under
    ``sp_decode``: any full attention cache (an encdec's self attention,
    an attention stack without a local window)."""
    window = cfg.local_window if cfg.block_pattern else 0
    return cfg.family == "encdec" or (
        "attn" in cfg.layer_kinds() and not window)


def build_prefill_step(lm, ctx: DistContext, shape,
                       cache_len: int | None = None):
    """Returns ``(prefill_fn, (param_specs, batch_specs, logits_spec,
    cache_specs))``.

    ``prefill_fn(params, batch) -> (logits, cache)``: ``params`` DTensors
    at ``param_specs``, ``batch`` the global prompt batch (``tokens``, a
    vlm's ``vision_embeds``, an encdec's ``encoder_frames``: the same
    arrays on every rank; each rank reads its rows); the last position's
    logits (B, V) a DTensor at ``logits_spec``, the cache of ``cache_len``
    slots (``shape.seq_len`` by default) DTensors at ``cache_specs`` and
    its ``filled`` count."""
    _check_mode(ctx, lm.cfg)
    cache_len = cache_len or shape.seq_len
    (p_sh, b_sh, c_sh, logits_sh), lo, rows = _serve_layout(lm, ctx, shape)
    splits = functools.cache(functools.partial(_splits, ctx, p_sh))

    @torch.no_grad()
    def prefill_fn(params, batch):
        local = {k: v[lo:lo + rows] for k, v in batch.items()}
        gather = UnitGather(params, splits())
        logits, cache = lm.prefill(local.pop("tokens"), cache_len,
                                   params=gather.refs, ctx=ctx,
                                   gather=gather, **local)
        prefill_fn.gather_stats = gather.stats
        return _place(ctx, logits, logits_sh), _place_cache(
            ctx, _own_slots(ctx, cache, lm.cache_axes(ctx)), c_sh)

    return prefill_fn, (p_sh, b_sh, logits_sh, c_sh)


def build_decode_step(lm, ctx: DistContext, shape):
    """Returns ``(decode_fn, (param_specs, cache_specs, batch_specs,
    logits_spec))``.

    ``decode_fn(params, cache, batch) -> (logits, cache)``: ``cache`` as
    :func:`build_prefill_step` returns it (updated in place and returned
    with its ``pos`` and ``filled`` advanced), ``batch["token"]`` the
    global (B, 1) tokens."""
    cfg = lm.cfg
    _check_mode(ctx, cfg)
    if ctx.mode == "fsdp" and ctx.sp_decode and _reaches_sp_decode(cfg):
        raise ValueError(
            f"{cfg.name}: a decode step in mode='fsdp' with sp_decode "
            f"splits the cache's slots over 'model', which fsdp's batch rule "
            f"already splits the rows over (the reference fails there too, "
            f"with DuplicateSpecError); create the context with "
            f"sp_decode=False")
    (p_sh, b_sh, c_sh, logits_sh), lo, rows = _serve_layout(lm, ctx, shape)
    splits = functools.cache(functools.partial(_splits, ctx, p_sh))

    @torch.no_grad()
    def decode_fn(params, cache, batch):
        local = tree_map_with_path(
            lambda _, t: t.to_local() if isinstance(t, DTensor) else t, cache)
        gather = UnitGather(params, splits())
        logits, local = lm.decode_step(local, batch["token"][lo:lo + rows],
                                       params=gather.refs, ctx=ctx,
                                       gather=gather)
        decode_fn.gather_stats = gather.stats
        return _place(ctx, logits, logits_sh), _place_cache(ctx, local, c_sh)

    return decode_fn, (p_sh, c_sh, b_sh, logits_sh)
