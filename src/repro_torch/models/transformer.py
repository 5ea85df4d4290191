"""Decoder LM stack (port of ``repro/models/transformer.py``) for the
``attn``, ``ssm`` and ``rec`` layer kinds: the forward over full sequences
(prefill with cache, or the training forward), one-token decode and
``init_cache``.  An attention layer's FFN is the SwiGLU MLP, or the routed
experts for the ``moe`` family (:mod:`.moe`), whose load-balance aux loss
the forward sums over the layers and returns, as the reference's
``decoder_forward`` does; decode drops it.

Parameters and caches keep the reference's layouts: one kind of layer is a
``stack`` with a leading ``layers`` axis; the hybrid family (recurrentgemma)
is ``groups`` of its block pattern, stacked on a leading ``groups`` axis,
then an unstacked ``tail`` of the layers past the last whole group.  A
Python loop over the layers takes the place of ``lax.scan``, over one
layer's views of each stacked leaf (:func:`unstack`); the training
forward's remat wraps each of the scan's bodies (a layer, or a group) in
``torch.utils.checkpoint``, as the reference wraps its scan body.  The
cache is written in place: prefill fills a zeroed cache layer by layer,
decode writes each new entry and state into it (the reference builds new
arrays).  The hybrid family's attention caches are rings of
``min(local_window, cache_len)`` slots.  Each unit runs through a gather
hook (:class:`WholeParams` by default; a sharded step's per-unit gather,
``distributed/fsdp.py``).

Under a tp context with a ``model`` axis above one rank (the dense,
vlm, ssm, hybrid and moe families; the encdec family's layers, in
:mod:`.encdec`, share :func:`self_attention` and
:func:`self_attention_step`) each rank holds its block of the heads (where ``make_rules``
splits them), of the kv heads (where it splits those) and of the mlp
width, read in place, and the residual stream stays whole on every rank:
an attention block's and a SwiGLU's input enters through ``to_model``,
their row-split products' outputs leave through ``from_model``
(``distributed/tensor_parallel.py``), at Megatron's four places.  Where
the heads are split and the kv heads are not, each rank reads the kv
heads its q heads map to; where the heads are not split, attention runs
whole on every rank.  The cache holds every kv head (the reference's
``cache_axes`` puts None on that dimension): prefill gathers k/v over
``model`` before it writes them, and so does decode before its write;
decode then attends with its own q heads, or under ``sp_decode`` gathers
q's heads too, runs ``sp_decode_attention`` over its block of the slots
and keeps its own heads of the output.  The ssm and rec mixers split
their own width (``ssm.py``, ``griffin.py``), a rec block's MLP its
``d_ff``; their caches hold this rank's block of the ssm heads and of
the lru width, and a mamba2 layer's conv state every rank's channels,
gathered before each write.  A moe layer's FFN holds this rank's
block of the routed experts (EP: E/m whole experts and the router's
columns of them; expert-TP: every expert's 1/m of the ffn dim, the
router whole) and of the shared expert's mlp, and routes the same tokens
on every rank (``moe.py``); its attention is the dense family's.  Decode
runs the same layer with T = B tokens.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.decode_attn import sp_decode_attention
from repro_torch.models import attention as attn
from repro_torch.models import griffin, moe, ssm
from repro_torch.models.layers import P, rms_norm, stack_spec, swiglu


def mlp_spec(cfg):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": P((d, ff), ("embed", "mlp")),
        "w_up": P((d, ff), ("embed", "mlp")),
        "w_down": P((ff, d), ("mlp", "embed")),
    }


def layer_spec(cfg, kind: str):
    d = cfg.d_model

    def ln():
        return P((d,), ("embed",), init="zeros")
    if kind == "ssm":
        return {"ln": ln(), "mixer": ssm.ssm_spec(cfg)}
    if kind == "rec":
        return {"ln1": ln(), "mixer": griffin.rglru_spec(cfg), "ln2": ln(),
                "mlp": mlp_spec(cfg)}
    return {"ln1": ln(), "attn": attn.attn_spec(cfg), "ln2": ln(),
            "ffn": moe.moe_spec(cfg) if cfg.family == "moe" else mlp_spec(cfg)}


def _groups(cfg):
    """A hybrid stack's (name, kind) pairs of one group, its number of
    groups G, and the (name, kind) pairs of its tail, named as the
    reference names them."""
    pat = cfg.block_pattern
    G = cfg.num_layers // len(pat)
    group = [(f"b{i}_{k}", k) for i, k in enumerate(pat)]
    tail = [(f"t{i}_{k}", k)
            for i, k in enumerate(cfg.layer_kinds()[G * len(pat):])]
    return group, G, tail


def decoder_spec(cfg):
    kinds = cfg.layer_kinds()
    if len(set(kinds)) == 1:
        return {"stack": stack_spec(layer_spec(cfg, kinds[0]), cfg.num_layers)}
    group, G, tail = _groups(cfg)
    spec = {"groups": stack_spec({n: layer_spec(cfg, k) for n, k in group},
                                 G, "groups")}
    if tail:
        spec["tail"] = {n: layer_spec(cfg, k) for n, k in tail}
    return spec


def layer_views(stack, i: int):
    """Layer ``i`` of a stacked tree: the same nested dicts of views."""
    if isinstance(stack, dict):
        return {k: layer_views(v, i) for k, v in stack.items()}
    return stack[i]


def unstack(stack) -> list:
    """Every layer of a stacked parameter tree, each the same nested dicts
    of views, from one ``unbind`` a leaf: under autograd, a leaf's layer
    gradients come back as one stack rather than one full-size scatter a
    layer."""
    if isinstance(stack, dict):
        per = {k: unstack(v) for k, v in stack.items()}
        n = len(next(iter(per.values())))
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(stack.unbind(0))


class WholeParams:
    """The gather hook of parameters that lie whole on this device (``LM``
    on one device, every model function's default): ``layers`` is
    :func:`unstack` and ``run(fn, params, *args)`` is ``fn(params,
    *args)``, so the model runs op for op as it would without a hook.
    The other hook is ``distributed/fsdp.py``'s ``UnitGather``, which
    gathers a unit's shards before ``fn`` and frees them after; the model
    calls the hook around each unit of :func:`_units`, each layer of an
    encdec stack and each use of a leaf outside the stacks."""

    @staticmethod
    def layers(stack) -> list:
        return unstack(stack)

    @staticmethod
    def run(fn, params, *args):
        return fn(params, *args)


WHOLE = WholeParams()


def _o_proj(o, wo, group=None):
    """The output projection; with a ``model`` group, this rank's heads'
    part summed over the group (``from_model``)."""
    return tp.from_model(torch.einsum("bshk,hkd->bsd", o, wo), group)


def _ffn(p, x, cfg, ctx=None):
    """An attention layer's FFN: the routed experts (moe), with their aux
    loss, or SwiGLU (aux None), tensor-parallel under a tp context."""
    if cfg.family == "moe":
        return moe.moe_ffn(p, x, cfg, ctx)
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"], ctx), None


@dataclass(frozen=True)
class HeadSplit:
    """A tp rank's block of an attention layer's heads: the ``model``
    group, this rank's q heads [first, first + heads), and whether the kv
    heads are split too (else every rank holds them all)."""
    group: object
    first: int
    heads: int
    kv_split: bool


def head_split(cfg, ctx) -> HeadSplit | None:
    """How ``ctx`` splits the attention heads over ``model``: ``None``
    without a tp ``model`` group, or where ``make_rules`` leaves the heads
    whole (``num_heads`` not a multiple of the axis)."""
    group = tp.model_group(ctx)
    if group is None or ctx.rules.get("heads") is None:
        return None
    heads = cfg.num_heads // dist.get_world_size(group)
    return HeadSplit(group, dist.get_rank(group) * heads, heads,
                     ctx.rules.get("kv_heads") is not None)


def _own_kv(hs: HeadSplit | None, cfg, k, v, dim: int):
    """The kv heads (on ``dim``) this rank's q heads read, of k/v holding
    every kv head."""
    if hs is None:
        return k, v
    return attn.kv_for_heads(k, v, dim, hs.first, hs.heads,
                             cfg.num_heads // cfg.num_kv_heads)


def _partly_used(pa, hs: HeadSplit | None):
    """An attention layer's leaves with those every ``model`` rank holds
    whole but uses for its own heads only passed through ``to_model``, so
    their gradients are summed over the group: ``wk`` and ``wv`` where
    the kv heads are not split, ``q_norm`` and ``k_norm`` whenever the
    heads are.  The norms of the residual stream, and attention whose
    heads are not split, are used whole on every rank: not summed."""
    if hs is None:
        return pa
    names = ("q_norm", "k_norm") + (() if hs.kv_split else ("wk", "wv"))
    return {n: tp.to_model(w, hs.group) if n in names else w
            for n, w in pa.items()}


# ======================================================================
# Single blocks
# ======================================================================

def _window(cfg) -> int:
    """The local-attention window of a hybrid stack's attention layers
    (0: full causal attention)."""
    return cfg.local_window if cfg.block_pattern else 0


def _read_kv(hs: HeadSplit | None, cfg, k, v, dim: int):
    """The kv heads (on ``dim``) this rank's q heads read, of k/v as its
    own kv projection made them: all of its block where the kv heads are
    split, else those of every kv head its q heads map to."""
    if hs is None or hs.kv_split:
        return k, v
    return _own_kv(hs, cfg, k, v, dim)


def self_attention(pa, x, ln, cfg, positions, hs: HeadSplit | None = None,
                   *, causal: bool = True, window: int = 0,
                   want_kv: bool = False):
    """The attention half of a block over full sequences, its residual
    not added: ``x`` normed by ``ln``, this rank's heads of ``pa`` (``hs``,
    the layer's :func:`head_split`) attending, their output summed over
    ``model`` -> (y (B,S,d), the cache's (k, v) or None).  Flash, causal
    or unmasked (the whisper encoder); with a local ``window``, the
    reference's dispatch: banded attention only when S > window and S %
    window == 0, full causal attention otherwise.  ``want_kv`` (the no-grad
    prefill): k/v (B,KV,S,hd) holding every kv head, a split block
    gathered over ``model``."""
    group = None if hs is None else hs.group
    h = tp.to_model(rms_norm(x, ln, cfg.norm_eps), group)
    q, k, v = attn.qkv_project(_partly_used(pa, hs), h, cfg, positions)
    S = x.shape[1]
    ka, va = _read_kv(hs, cfg, k, v, 2)
    kh, vh = ka.transpose(1, 2).contiguous(), va.transpose(1, 2).contiguous()
    if window and S > window and S % window == 0:
        o = attn.banded_local_attention(q, ka, va, window=window)
    else:
        o = attn.prefill_attention(q, kh, vh, causal=causal)
    y = _o_proj(o, pa["wo"], group)
    if not want_kv:
        return y, None
    if hs is not None and hs.kv_split:
        kh, vh = tp.gather_model(kh, 1, group), tp.gather_model(vh, 1, group)
    elif hs is not None:
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    return y, (kh, vh)


def attn_block_fwd(lp, x, cfg, positions, entry, ctx=None):
    """One attention block over full sequences -> (x, the FFN's aux or
    None); writes k/v into the layer's cache views ``entry`` (B,KV,Sc,hd)
    when given.  With a local window (:func:`self_attention`) the cache is
    a ring holding the last ``window`` keys, token p in slot p % window.
    Under a tp context, this rank's heads (module docstring)."""
    S, window = x.shape[1], _window(cfg)
    y, kv = self_attention(lp["attn"], x, lp["ln1"], cfg, positions,
                           head_split(cfg, ctx), window=window,
                           want_kv=entry is not None)
    x = x + y
    y, aux = _ffn(lp["ffn"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg, ctx)
    x = x + y
    if entry is not None:
        kh, vh = kv
        if window and S >= window:
            shift = (S - window) % window
            entry["k"].copy_(torch.roll(kh[:, :, -window:], shift, dims=2))
            entry["v"].copy_(torch.roll(vh[:, :, -window:], shift, dims=2))
        else:
            entry["k"][:, :, :S] = kh
            entry["v"][:, :, :S] = vh
    return x, aux


def ssm_block_fwd(lp, x, cfg, entry, ctx=None):
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    y, (conv_st, ssm_st) = ssm.ssm_forward(lp["mixer"], h, cfg, ctx)
    if entry is not None:
        entry["conv"].copy_(ssm.whole_conv(conv_st, cfg, ctx))
        entry["ssm"].copy_(ssm_st)
    return x + y


def rec_block_fwd(lp, x, cfg, entry, ctx=None):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, (conv_st, lru_st) = griffin.recurrent_forward(lp["mixer"], h, cfg,
                                                     ctx=ctx)
    x = x + y
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    x = x + swiglu(h2, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                   lp["mlp"]["w_down"], ctx)
    if entry is not None:
        entry["conv"].copy_(conv_st)
        entry["lru"].copy_(lru_st)
    return x


def block_fwd(kind, lp, x, cfg, positions, entry, ctx=None):
    """One block over full sequences -> (x, aux loss or None); ``ctx``
    reaches the moe FFN (:func:`repro_torch.models.moe.moe_ffn`) and the
    tensor-parallel layers."""
    if kind == "ssm":
        return ssm_block_fwd(lp, x, cfg, entry, ctx), None
    if kind == "rec":
        return rec_block_fwd(lp, x, cfg, entry, ctx), None
    return attn_block_fwd(lp, x, cfg, positions, entry, ctx)


def self_attention_step(pa, x, ln, cfg, pos, kc, vc,
                        hs: HeadSplit | None = None, ctx=None, *,
                        window: int = 0):
    """The attention half of a block for one token, its residual not
    added: the reference's branch order: a local ``window``'s ring, else
    ``sp_decode_attention`` when ``ctx`` asks for sequence-parallel
    decode, else the plain write into the caches ``kc``/``vc`` (B,KV,Sc,hd,
    every kv head: a split block's k/v gathered over ``model`` first) and
    attention at this rank's heads (``hs``, the layer's
    :func:`head_split`), summed over ``model``."""
    group = None if hs is None else hs.group
    h = tp.to_model(rms_norm(x, ln, cfg.norm_eps), group)
    q, k, v = attn.qkv_project(pa, h, cfg, pos[:, None])
    if hs is not None and hs.kv_split:           # every kv head in the cache
        k, v = tp.gather_model(k, 2, group), tp.gather_model(v, 2, group)
    if window:
        kc, vc = attn.cache_write_window(kc, vc, k, v, pos)
        o = attn.decode_attention_window(q, *_own_kv(hs, cfg, kc, vc, 1), pos,
                                         window=window)
    elif ctx is not None and ctx.sp_decode:
        qa = q if hs is None else tp.gather_model(q, 2, group)
        o, _, _ = sp_decode_attention(ctx, qa, kc, vc, k, v, pos)
        if hs is not None:
            o = o.narrow(2, hs.first, hs.heads)
    else:
        kc, vc = attn.cache_write_plain(kc, vc, k, v, pos)
        o = attn.decode_attention_plain(q, *_own_kv(hs, cfg, kc, vc, 1), pos)
    return _o_proj(o, pa["wo"], group)


def attn_block_dec(lp, x, cfg, pos, entry, ctx=None):
    """One attention block, one token (:func:`self_attention_step`);
    ``ctx`` also reaches the moe FFN; under a tp context, this rank's
    heads (module docstring)."""
    x = x + self_attention_step(lp["attn"], x, lp["ln1"], cfg, pos,
                                entry["k"], entry["v"],
                                head_split(cfg, ctx), ctx,
                                window=_window(cfg))
    return x + _ffn(lp["ffn"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg,
                    ctx)[0]


def ssm_block_dec(lp, x, cfg, entry, ctx=None):
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    y, (conv_st, ssm_st) = ssm.ssm_decode_step(
        lp["mixer"], h, cfg, ssm.own_conv(entry["conv"], cfg, ctx),
        entry["ssm"], ctx)
    entry["conv"].copy_(ssm.whole_conv(conv_st, cfg, ctx))
    entry["ssm"].copy_(ssm_st)
    return x + y


def rec_block_dec(lp, x, cfg, entry, ctx=None):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, (conv_st, lru_st) = griffin.recurrent_forward(
        lp["mixer"], h, cfg, conv_state=entry["conv"],
        lru_state=entry["lru"], decode=True, ctx=ctx)
    entry["conv"].copy_(conv_st)
    entry["lru"].copy_(lru_st)
    x = x + y
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(h2, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                      lp["mlp"]["w_down"], ctx)


def block_dec(kind, lp, x, cfg, pos, entry, ctx=None):
    if kind == "ssm":
        return ssm_block_dec(lp, x, cfg, entry, ctx)
    if kind == "rec":
        return rec_block_dec(lp, x, cfg, entry, ctx)
    return attn_block_dec(lp, x, cfg, pos, entry, ctx)


# ======================================================================
# The stack
# ======================================================================

def _units(params, cfg, cache, gather=WHOLE):
    """The stack's layers as the reference's ``decoder_forward`` runs them:
    each unit a list of (kind, layer params, layer cache entry or None)
    and whether it is a scan body (the unit remat wraps).  A ``stack``
    gives one unit a layer; a hybrid stack one unit a group of its
    pattern, then one a layer of its tail, which the reference runs
    outside its scan.  The layer params are ``gather.layers``' (the
    caller runs each unit through ``gather.run``)."""
    if "stack" in params:
        kind = cfg.layer_kinds()[0]
        for i, lp in enumerate(gather.layers(params["stack"])):
            yield [(kind, lp, None if cache is None else
                    layer_views(cache["stack"], i))], True
        return
    group, G, tail = _groups(cfg)
    groups = gather.layers(params["groups"])
    for g in range(G):
        yield [(kind, groups[g][n],
                None if cache is None else layer_views(cache["groups"][n], g))
               for n, kind in group], True
    for n, kind in tail:
        yield [(kind, params["tail"][n],
                None if cache is None else cache["tail"][n])], False


def _run_blocks(blocks, x, cfg, positions, ctx):
    """One unit of :func:`_units` -> (x, the blocks' aux losses)."""
    auxs = []
    for kind, lp, entry in blocks:
        x, a = block_fwd(kind, lp, x, cfg, positions, entry, ctx)
        if a is not None:
            auxs.append(a)
    return x, auxs


# the matmuls' outputs, which ``dots`` keeps (jax's ``dots_saveable``);
# einsum and ``@`` reach these.  No weight is such an output, so under a
# step's per-unit gather ``dots`` keeps no gathered weight: the weights
# the recompute reads are gathered again before the unit's backward
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, remat: str):
    """``fn`` under activation checkpointing, as the reference's
    ``_remat_wrap``: ``none`` as it is, ``full`` saving nothing (its
    forward runs again in the backward), ``dots`` saving the matmuls'
    outputs and recomputing the rest, the hand-written kernels'
    ``autograd.Function``s included."""
    if remat == "none":
        return fn
    if remat not in ("dots", "full"):
        raise ValueError(f"remat {remat!r}: expected none, dots or full")
    kw = ({"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)}
        if remat == "dots" else {})
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def decoder_forward(params, x, cfg, positions, cache=None, *, ctx=None,
                    remat: str = "none", gather=WHOLE):
    """Run every layer over full sequences; fills ``cache`` (from
    :func:`init_cache`, at least S slots) when given.  Returns (x, aux):
    the moe layers' aux losses summed in layer order from an f32 zero (a
    zero for the other families), as the reference's ``(x, aux_total,
    cache)``.  ``remat`` wraps each scan body of :func:`_units` (training
    only: a cache is filled without it); ``ctx`` reaches the moe FFN;
    ``gather`` runs each unit (:class:`WholeParams`)."""
    if remat != "none" and cache is not None:
        raise ValueError("remat is for training; prefill fills its cache "
                         "without it")
    body = _remat_wrap(_run_blocks, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blocks, scanned in _units(params, cfg, cache, gather):
        x, auxs = gather.run(body if scanned else _run_blocks, blocks, x,
                             cfg, positions, ctx)
        for a in auxs:
            aux = aux + a
    return x, aux


def _dec_blocks(blocks, x, cfg, pos, ctx):
    for kind, lp, entry in blocks:
        x = block_dec(kind, lp, x, cfg, pos, entry, ctx)
    return x


def decoder_decode(params, x, cfg, pos, cache, *, ctx=None, gather=WHOLE):
    """One-token decode through the stack, updating ``cache`` in place;
    ``ctx`` reaches the attention blocks (:func:`attn_block_dec`) and the
    moe FFN; ``gather`` runs each unit (:class:`WholeParams`)."""
    for blocks, _ in _units(params, cfg, cache, gather):
        x = gather.run(_dec_blocks, blocks, x, cfg, pos, ctx)
    return x


def init_cache(cfg, B: int, cache_len: int, dtype, device, ctx=None):
    """Zeros cache for the decoder stack, in the reference's layout, plus
    ``filled``: the host-side count of slots every sequence has filled
    (all sequences advance together), which bounds decode's writes into a
    full kv cache (a window cache is a ring and never runs out).  Under a
    tp context, this rank's block of the leaves its layers split over
    ``model`` (an ssm state's heads, a rec layer's conv and lru width;
    :func:`cache_axes`)."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    kinds = cfg.layer_kinds()
    hb = ssm.head_block(cfg, ctx) if "ssm" in kinds else None
    wb = griffin.width_block(cfg, ctx) if "rec" in kinds else None
    heads = cfg.ssm_heads if hb is None else hb.heads
    width = cfg.lru_width if wb is None else \
        cfg.lru_width // griffin.NUM_BLOCKS * wb.blocks

    def entry(kind, *lead, slots=cache_len):
        if kind == "ssm":
            C = cfg.d_inner + 2 * cfg.ssm_state
            return {"conv": zeros(*lead, B, cfg.conv_width - 1, C),
                    "ssm": zeros(*lead, B, heads, cfg.ssm_headdim,
                                 cfg.ssm_state)}
        if kind == "rec":
            return {"conv": zeros(*lead, B, cfg.conv_width - 1, width),
                    "lru": zeros(*lead, B, width)}
        KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        return {"k": zeros(*lead, B, KV, slots, hd),
                "v": zeros(*lead, B, KV, slots, hd)}

    pos = torch.zeros((B,), dtype=torch.int32, device=device)
    if len(set(kinds)) == 1:
        return {"stack": entry(kinds[0], cfg.num_layers), "pos": pos,
                "filled": 0}
    group, G, tail = _groups(cfg)
    slots = min(cfg.local_window, cache_len)
    return {"groups": {n: entry(k, G, slots=slots) for n, k in group},
            "tail": {n: entry(k, slots=slots) for n, k in tail},
            "pos": pos, "filled": 0}


def cache_axes(cfg, ctx=None):
    """The logical axes of every leaf of :func:`init_cache`'s cache (its
    host-side ``filled`` count aside), as the reference's ``cache_axes``;
    with ``ctx.sp_decode`` the full attention caches' slots are
    ``cache_seq``."""
    sp = ctx is not None and ctx.sp_decode
    full_attn = ("layers", "batch", None, "cache_seq" if sp else None, None)
    win_attn = ("layers", "batch", None, None, None)
    kinds = cfg.layer_kinds()
    if len(set(kinds)) == 1:
        if kinds[0] == "ssm":
            entry = {"conv": ("layers", "batch", None, None),
                     "ssm": ("layers", "batch", "ssm_heads", None, None)}
        else:
            entry = {"k": full_attn, "v": full_attn}
        return {"stack": entry, "pos": ("batch",)}

    def one(kind, stacked=True):
        if kind == "rec":
            c = {"conv": ("groups", "batch", None, "lru"),
                 "lru": ("groups", "batch", "lru")}
        else:
            c = {"k": win_attn, "v": win_attn}
        return c if stacked else {k: ax[1:] for k, ax in c.items()}

    group, _, tail = _groups(cfg)
    return {"groups": {n: one(k) for n, k in group},
            "tail": {n: one(k, stacked=False) for n, k in tail},
            "pos": ("batch",)}
