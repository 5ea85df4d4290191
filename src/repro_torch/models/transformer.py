"""Decoder LM stack (port of the ``"stack"`` half of
``repro/models/transformer.py``) for the ``attn`` and ``ssm`` layer kinds:
prefill with cache, one-token decode and ``init_cache``.

Parameters and caches keep the reference's stacked layout (a leading
``layers`` axis); a Python loop over the layers takes the place of
``lax.scan``, indexing one layer's views.  The cache is written in place:
prefill fills a zeroed cache layer by layer, decode writes each new
entry and state into it (the reference builds new arrays).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm
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
    return {"ln1": ln(), "attn": attn.attn_spec(cfg), "ln2": ln(),
            "ffn": mlp_spec(cfg)}


def decoder_spec(cfg):
    (kind,) = set(cfg.layer_kinds())
    return {"stack": stack_spec(layer_spec(cfg, kind), cfg.num_layers)}


def layer_views(stack, i: int):
    """Layer ``i`` of a stacked tree: the same nested dicts of views."""
    if isinstance(stack, dict):
        return {k: layer_views(v, i) for k, v in stack.items()}
    return stack[i]


def _o_proj(o, wo):
    return torch.einsum("bshk,hkd->bsd", o, wo)


# ======================================================================
# Single blocks
# ======================================================================

def attn_block_fwd(lp, x, cfg, positions, entry):
    """Prefill one attention block; writes k/v into the layer's cache views
    ``entry`` (B,KV,Sc,hd) when given."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(lp["attn"], h, cfg, positions)
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    x = x + _o_proj(attn.prefill_attention(q, kh, vh), lp["attn"]["wo"])
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    x = x + swiglu(h2, lp["ffn"]["w_gate"], lp["ffn"]["w_up"],
                   lp["ffn"]["w_down"])
    if entry is not None:
        S = kh.shape[2]
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


def attn_block_dec(lp, x, cfg, pos, entry):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(lp["attn"], h, cfg, pos[:, None])
    kc, vc = attn.cache_write_plain(entry["k"], entry["v"], k, v, pos)
    x = x + _o_proj(attn.decode_attention_plain(q, kc, vc, pos),
                    lp["attn"]["wo"])
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(h2, lp["ffn"]["w_gate"], lp["ffn"]["w_up"],
                      lp["ffn"]["w_down"])


def ssm_block_dec(lp, x, cfg, entry):
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    y, (conv_st, ssm_st) = ssm.ssm_decode_step(
        lp["mixer"], h, cfg, entry["conv"], entry["ssm"])
    entry["conv"].copy_(conv_st)
    entry["ssm"].copy_(ssm_st)
    return x + y


# ======================================================================
# The stack
# ======================================================================

def decoder_forward(params, x, cfg, positions, cache=None):
    """Run every layer over full sequences; fills ``cache`` (from
    :func:`init_cache`, at least S slots) when given.  Returns x."""
    ssm_stack = cfg.layer_kinds()[0] == "ssm"
    for i in range(cfg.num_layers):
        lp = layer_views(params["stack"], i)
        entry = None if cache is None else layer_views(cache["stack"], i)
        if ssm_stack:
            x = ssm_block_fwd(lp, x, cfg, entry)
        else:
            x = attn_block_fwd(lp, x, cfg, positions, entry)
    return x


def decoder_decode(params, x, cfg, pos, cache):
    """One-token decode through the stack, updating ``cache`` in place."""
    ssm_stack = cfg.layer_kinds()[0] == "ssm"
    for i in range(cfg.num_layers):
        lp = layer_views(params["stack"], i)
        entry = layer_views(cache["stack"], i)
        if ssm_stack:
            x = ssm_block_dec(lp, x, cfg, entry)
        else:
            x = attn_block_dec(lp, x, cfg, pos, entry)
    return x


def init_cache(cfg, B: int, cache_len: int, dtype, device):
    """Zeros cache for the decoder stack, in the reference's layout, plus
    ``filled``: the host-side count of slots every sequence has filled
    (all sequences advance together), which bounds decode's writes."""
    L = cfg.num_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    if cfg.layer_kinds()[0] == "ssm":
        C = cfg.d_inner + 2 * cfg.ssm_state
        entry = {"conv": zeros(L, B, cfg.conv_width - 1, C),
                 "ssm": zeros(L, B, cfg.ssm_heads, cfg.ssm_headdim,
                              cfg.ssm_state)}
    else:
        KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        entry = {"k": zeros(L, B, KV, cache_len, hd),
                 "v": zeros(L, B, KV, cache_len, hd)}
    return {"stack": entry,
            "pos": torch.zeros((B,), dtype=torch.int32, device=device),
            "filled": 0}
