"""Whisper-style encoder-decoder backbone (port of ``repro/models/encdec.py``;
the audio frontend is a stub: the pipeline feeds precomputed frame
embeddings (B, enc_seq, d_model)).

Learned absolute positions (no rope), a bidirectional encoder, a causal
decoder with cross attention.  The encoder's unmasked self attention and
the decoder's causal self attention over the prompt go through the flash
kernel (``prefill_attention``); cross attention, whose q and kv lengths
differ, is plain PyTorch, as the reference computes it in XLA.  The cross
K/V are computed once at prefill and kept in the cache; decode writes its
self-attention entry in place and reads the cross K/V.  A Python loop over
the layers takes the place of ``lax.scan``, as in :mod:`.transformer`,
each layer (and each leaf outside the stacks) run through the gather hook
(``transformer.WholeParams``).

Under a tp context with a ``model`` axis above one rank, the dense
family's split (:mod:`.transformer`'s docstring): the encoder's self
attention, the decoder's self and cross attention and every mlp run at
this rank's block of the heads (where ``make_rules`` splits them), of the
kv heads (where it splits those) and of ``d_ff``, read in place, while
both residual streams stay whole on every rank.  The encoder's output
enters the cross K/V products through ``to_model`` once a forward, with
the heads' group: each rank's cross attention reads it for its own heads
only, so its gradient is summed over ``model``; where the heads are whole
every rank computes the same cross attention and nothing is summed.  The
cache holds every kv head, as the reference's: a prefill gathers a split
kv block before it writes the self and cross K/V; decode reads this
rank's heads out of the whole cross K/V.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import attention as attn
from repro_torch.models.layers import P, embed_spec, rms_norm, stack_spec, swiglu
from repro_torch.models.transformer import (
    WHOLE, _o_proj, _own_kv, _partly_used, _read_kv, head_split, layer_views,
    mlp_spec, self_attention, self_attention_step,
)


def enc_layer_spec(cfg):
    def ln():
        return P((cfg.d_model,), ("embed",), init="zeros")
    return {"ln1": ln(), "attn": attn.attn_spec(cfg), "ln2": ln(),
            "mlp": mlp_spec(cfg)}


def dec_layer_spec(cfg):
    def ln():
        return P((cfg.d_model,), ("embed",), init="zeros")
    return {"ln1": ln(), "attn": attn.attn_spec(cfg),
            "lnx": ln(), "xattn": attn.attn_spec(cfg),
            "ln2": ln(), "mlp": mlp_spec(cfg)}


def encdec_spec(cfg, max_seq: int):
    d = cfg.d_model
    return {
        "embed": embed_spec(cfg),
        "enc_pos": P((cfg.encoder_seq, d), ("enc_seq", "embed"), scale=0.02),
        "dec_pos": P((max_seq, d), ("pos", "embed"), scale=0.02),
        "encoder": stack_spec(enc_layer_spec(cfg), cfg.encoder_layers),
        "decoder": stack_spec(dec_layer_spec(cfg), cfg.num_layers),
        "ln_enc": P((d,), ("embed",), init="zeros"),
        "ln_f": P((d,), ("embed",), init="zeros"),
        "w_out": P((cfg.padded_vocab, d), ("vocab", "embed")),
    }


def _mlp(lp, x, cfg, ctx=None):
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(h, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                      lp["mlp"]["w_down"], ctx)


def _enc_layer(lp, x, cfg, hs, ctx):
    y, _ = self_attention(lp["attn"], x, lp["ln1"], cfg, None, hs,
                          causal=False)                 # bidirectional
    return _mlp(lp, x + y, cfg, ctx)


def encoder_forward(params, frames, cfg, gather=WHOLE, ctx=None):
    """frames (B, Senc, d) -> (B, Senc, d); ``gather`` runs each layer and
    each leaf outside the stack (``transformer.WholeParams``); ``ctx``: a
    tp context's split (module docstring)."""
    Senc = frames.shape[1]
    frames = frames.to(params["embed"].dtype)   # the stub frontend emits f32
    x = gather.run(lambda pos: frames + pos[:Senc].to(frames.dtype),
                   params["enc_pos"])
    hs = head_split(cfg, ctx)
    for lp in gather.layers(params["encoder"]):
        x = gather.run(_enc_layer, lp, x, cfg, hs, ctx)
    return gather.run(lambda w: rms_norm(x, w, cfg.norm_eps),
                      params["ln_enc"])


def _cross(pa, x, ln, enc_in, cfg, hs):
    """Cross attention, its residual not added: this rank's heads of the
    normed ``x`` over the encoder's output -> (y, the cross K/V
    (B,Senc,KV',hd) as this rank's projection made them: its block of the
    kv heads where they are split, else every one)."""
    group = None if hs is None else hs.group
    pa = _partly_used(pa, hs)
    hx = tp.to_model(rms_norm(x, ln, cfg.norm_eps), group)
    qx = torch.einsum("bsd,dhk->bshk", hx, pa["wq"])
    xk = torch.einsum("bsd,dhk->bshk", enc_in, pa["wk"])
    xv = torch.einsum("bsd,dhk->bshk", enc_in, pa["wv"])
    o = attn.cross_attention(qx, *_read_kv(hs, cfg, xk, xv, 2))
    return _o_proj(o, pa["wo"], group), (xk, xv)


def _dec_layer(lp, x, enc_in, cfg, positions, entry, hs, ctx):
    S = x.shape[1]
    y, kv = self_attention(lp["attn"], x, lp["ln1"], cfg, positions, hs,
                           want_kv=entry is not None)
    x = x + y
    y, (xk, xv) = _cross(lp["xattn"], x, lp["lnx"], enc_in, cfg, hs)
    x = _mlp(lp, x + y, cfg, ctx)
    if entry is not None:
        if hs is not None and hs.kv_split:       # every kv head in the cache
            xk = tp.gather_model(xk, 2, hs.group)
            xv = tp.gather_model(xv, 2, hs.group)
        entry["self_k"][:, :, :S] = kv[0]
        entry["self_v"][:, :, :S] = kv[1]
        entry["cross_k"].copy_(xk.transpose(1, 2))
        entry["cross_v"].copy_(xv.transpose(1, 2))
    return x


def decoder_forward(params, x, enc_out, cfg, positions, cache=None,
                    gather=WHOLE, ctx=None):
    """x (B,S,d) decoder stream; enc_out (B,Senc,d).  Fills ``cache`` (from
    :func:`init_cache`, at least S self slots, Senc cross slots) when
    given; ``gather`` runs each layer; ``ctx``: a tp context's split
    (module docstring).  Returns x."""
    hs = head_split(cfg, ctx)
    enc_in = tp.to_model(enc_out, None if hs is None else hs.group)
    for i, lp in enumerate(gather.layers(params["decoder"])):
        x = gather.run(_dec_layer, lp, x, enc_in, cfg, positions,
                       None if cache is None else
                       layer_views(cache["stack"], i), hs, ctx)
    return x


def _dec_step(lp, x, cfg, pos, c, hs, ctx):
    group = None if hs is None else hs.group
    x = x + self_attention_step(lp["attn"], x, lp["ln1"], cfg, pos,
                                c["self_k"], c["self_v"], hs, ctx)
    hx = tp.to_model(rms_norm(x, lp["lnx"], cfg.norm_eps), group)
    qx = torch.einsum("bsd,dhk->bshk", hx, lp["xattn"]["wq"])
    last = torch.full((x.shape[0],), c["cross_k"].shape[2] - 1,
                      dtype=torch.int32, device=x.device)
    ox = attn.decode_attention_plain(
        qx, *_own_kv(hs, cfg, c["cross_k"], c["cross_v"], 1), last)
    return _mlp(lp, x + _o_proj(ox, lp["xattn"]["wo"], group), cfg, ctx)


def decoder_decode(params, x, cfg, pos, cache, *, ctx=None, gather=WHOLE):
    """One-token decode; cache entries per layer: self_k/self_v
    (B,KV,S,hd), written in place, and cross_k/cross_v (B,KV,Senc,hd),
    each holding every kv head.  With ``ctx.sp_decode`` the self attention
    is ``sp_decode_attention``, as in the reference; ``gather`` runs each
    layer; under a tp context, this rank's heads (module docstring)."""
    hs = head_split(cfg, ctx)
    for i, lp in enumerate(gather.layers(params["decoder"])):
        x = gather.run(_dec_step, lp, x, cfg, pos,
                       layer_views(cache["stack"], i), hs, ctx)
    return x


def init_cache(cfg, B: int, cache_len: int, dtype, device, *,
               enc_len: int | None = None):
    """Zeros cache in the reference's layout (cross K/V of ``enc_len``
    frames, ``cfg.encoder_seq`` by default), plus the host-side ``filled``
    count of :func:`repro_torch.models.transformer.init_cache`."""
    KV, hd, L = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
    Senc = cfg.encoder_seq if enc_len is None else enc_len

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"stack": {
        "self_k": zeros(L, B, KV, cache_len, hd),
        "self_v": zeros(L, B, KV, cache_len, hd),
        "cross_k": zeros(L, B, KV, Senc, hd),
        "cross_v": zeros(L, B, KV, Senc, hd),
    }, "pos": torch.zeros((B,), dtype=torch.int32, device=device),
        "filled": 0}


def cache_axes(cfg, ctx=None):
    """The logical axes of every leaf of :func:`init_cache`'s cache (its
    host-side ``filled`` count aside), as the reference's ``cache_axes``."""
    sp = ctx is not None and ctx.sp_decode
    self_ax = ("layers", "batch", None, "cache_seq" if sp else None, None)
    cross_ax = ("layers", "batch", None, None, None)
    return {"stack": {"self_k": self_ax, "self_v": self_ax,
                      "cross_k": cross_ax, "cross_v": cross_ax},
            "pos": ("batch",)}
