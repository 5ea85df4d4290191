"""Decoder LM stack (port of ``repro/models/transformer.py``) for the
``attn``, ``ssm`` and ``rec`` layer kinds: prefill with cache, one-token
decode and ``init_cache``.  An attention layer's FFN is the SwiGLU MLP, or
the routed experts for the ``moe`` family (:mod:`.moe`; its aux loss is
dropped here, as serving has no loss).

Parameters and caches keep the reference's layouts: one kind of layer is a
``stack`` with a leading ``layers`` axis; the hybrid family (recurrentgemma)
is ``groups`` of its block pattern, stacked on a leading ``groups`` axis,
then an unstacked ``tail`` of the layers past the last whole group.  A
Python loop over the layers takes the place of ``lax.scan``, indexing one
layer's views.  The cache is written in place: prefill fills a zeroed
cache layer by layer, decode writes each new entry and state into it (the
reference builds new arrays).  The hybrid family's attention caches are
rings of ``min(local_window, cache_len)`` slots.
"""
from __future__ import annotations

import torch

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


def _o_proj(o, wo):
    return torch.einsum("bshk,hkd->bsd", o, wo)


def _ffn(p, x, cfg):
    """An attention layer's FFN: the routed experts (moe) or SwiGLU."""
    if cfg.family == "moe":
        return moe.moe_ffn(p, x, cfg)[0]
    return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


# ======================================================================
# Single blocks
# ======================================================================

def _window(cfg) -> int:
    """The local-attention window of a hybrid stack's attention layers
    (0: full causal attention)."""
    return cfg.local_window if cfg.block_pattern else 0


def attn_block_fwd(lp, x, cfg, positions, entry):
    """Prefill one attention block; writes k/v into the layer's cache views
    ``entry`` (B,KV,Sc,hd) when given.

    With a local window, the reference's dispatch: banded attention only
    when S > window and S % window == 0, full causal attention otherwise
    (also for S > window not a multiple of it); the cache is a ring
    holding the last ``window`` keys, token p in slot p % window."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(lp["attn"], h, cfg, positions)
    S, window = x.shape[1], _window(cfg)
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    if window and S > window and S % window == 0:
        o = attn.banded_local_attention(q, k, v, window=window)
    else:
        o = attn.prefill_attention(q, kh, vh)
    x = x + _o_proj(o, lp["attn"]["wo"])
    x = x + _ffn(lp["ffn"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    if entry is not None:
        if window and S >= window:
            shift = (S - window) % window
            entry["k"].copy_(torch.roll(kh[:, :, -window:], shift, dims=2))
            entry["v"].copy_(torch.roll(vh[:, :, -window:], shift, dims=2))
        else:
            entry["k"][:, :, :S] = kh
            entry["v"][:, :, :S] = vh
    return x


def ssm_block_fwd(lp, x, cfg, entry):
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    y, (conv_st, ssm_st) = ssm.ssm_forward(lp["mixer"], h, cfg)
    if entry is not None:
        entry["conv"].copy_(conv_st)
        entry["ssm"].copy_(ssm_st)
    return x + y


def rec_block_fwd(lp, x, cfg, entry):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, (conv_st, lru_st) = griffin.recurrent_forward(lp["mixer"], h, cfg)
    x = x + y
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    x = x + swiglu(h2, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                   lp["mlp"]["w_down"])
    if entry is not None:
        entry["conv"].copy_(conv_st)
        entry["lru"].copy_(lru_st)
    return x


def block_fwd(kind, lp, x, cfg, positions, entry):
    if kind == "ssm":
        return ssm_block_fwd(lp, x, cfg, entry)
    if kind == "rec":
        return rec_block_fwd(lp, x, cfg, entry)
    return attn_block_fwd(lp, x, cfg, positions, entry)


def attn_block_dec(lp, x, cfg, pos, entry):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(lp["attn"], h, cfg, pos[:, None])
    window = _window(cfg)
    if window:
        kc, vc = attn.cache_write_window(entry["k"], entry["v"], k, v, pos)
        o = attn.decode_attention_window(q, kc, vc, pos, window=window)
    else:
        kc, vc = attn.cache_write_plain(entry["k"], entry["v"], k, v, pos)
        o = attn.decode_attention_plain(q, kc, vc, pos)
    x = x + _o_proj(o, lp["attn"]["wo"])
    return x + _ffn(lp["ffn"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)


def ssm_block_dec(lp, x, cfg, entry):
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    y, (conv_st, ssm_st) = ssm.ssm_decode_step(
        lp["mixer"], h, cfg, entry["conv"], entry["ssm"])
    entry["conv"].copy_(conv_st)
    entry["ssm"].copy_(ssm_st)
    return x + y


def rec_block_dec(lp, x, cfg, entry):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, (conv_st, lru_st) = griffin.recurrent_forward(
        lp["mixer"], h, cfg, conv_state=entry["conv"],
        lru_state=entry["lru"], decode=True)
    entry["conv"].copy_(conv_st)
    entry["lru"].copy_(lru_st)
    x = x + y
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(h2, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                      lp["mlp"]["w_down"])


def block_dec(kind, lp, x, cfg, pos, entry):
    if kind == "ssm":
        return ssm_block_dec(lp, x, cfg, entry)
    if kind == "rec":
        return rec_block_dec(lp, x, cfg, entry)
    return attn_block_dec(lp, x, cfg, pos, entry)


# ======================================================================
# The stack
# ======================================================================

def _layers(params, cfg, cache):
    """(kind, layer params, layer cache entry or None) in the stack's
    order: the layers of a ``stack``, or the groups' pattern then the tail."""
    if "stack" in params:
        kind = cfg.layer_kinds()[0]
        for i in range(cfg.num_layers):
            yield (kind, layer_views(params["stack"], i),
                   None if cache is None else layer_views(cache["stack"], i))
        return
    group, G, tail = _groups(cfg)
    for g in range(G):
        for n, kind in group:
            yield (kind, layer_views(params["groups"][n], g),
                   None if cache is None else
                   layer_views(cache["groups"][n], g))
    for n, kind in tail:
        yield (kind, params["tail"][n],
               None if cache is None else cache["tail"][n])


def decoder_forward(params, x, cfg, positions, cache=None):
    """Run every layer over full sequences; fills ``cache`` (from
    :func:`init_cache`, at least S slots) when given.  Returns x."""
    for kind, lp, entry in _layers(params, cfg, cache):
        x = block_fwd(kind, lp, x, cfg, positions, entry)
    return x


def decoder_decode(params, x, cfg, pos, cache):
    """One-token decode through the stack, updating ``cache`` in place."""
    for kind, lp, entry in _layers(params, cfg, cache):
        x = block_dec(kind, lp, x, cfg, pos, entry)
    return x


def init_cache(cfg, B: int, cache_len: int, dtype, device):
    """Zeros cache for the decoder stack, in the reference's layout, plus
    ``filled``: the host-side count of slots every sequence has filled
    (all sequences advance together), which bounds decode's writes into a
    full kv cache (a window cache is a ring and never runs out)."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def entry(kind, *lead, slots=cache_len):
        if kind == "ssm":
            C = cfg.d_inner + 2 * cfg.ssm_state
            return {"conv": zeros(*lead, B, cfg.conv_width - 1, C),
                    "ssm": zeros(*lead, B, cfg.ssm_heads, cfg.ssm_headdim,
                                 cfg.ssm_state)}
        if kind == "rec":
            return {"conv": zeros(*lead, B, cfg.conv_width - 1, cfg.lru_width),
                    "lru": zeros(*lead, B, cfg.lru_width)}
        KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        return {"k": zeros(*lead, B, KV, slots, hd),
                "v": zeros(*lead, B, KV, slots, hd)}

    pos = torch.zeros((B,), dtype=torch.int32, device=device)
    kinds = cfg.layer_kinds()
    if len(set(kinds)) == 1:
        return {"stack": entry(kinds[0], cfg.num_layers), "pos": pos,
                "filled": 0}
    group, G, tail = _groups(cfg)
    slots = min(cfg.local_window, cache_len)
    return {"groups": {n: entry(k, G, slots=slots) for n, k in group},
            "tail": {n: entry(k, slots=slots) for n, k in tail},
            "pos": pos, "filled": 0}
