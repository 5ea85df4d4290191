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
"""
from __future__ import annotations

import torch

from repro_torch.distributed.decode_attn import sp_decode_attention
from repro_torch.models import attention as attn
from repro_torch.models.layers import P, embed_spec, rms_norm, stack_spec, swiglu
from repro_torch.models.transformer import WHOLE, _o_proj, layer_views, mlp_spec


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


def _mlp(lp, x, cfg):
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + swiglu(h, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                      lp["mlp"]["w_down"])


def _enc_layer(lp, x, cfg):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(lp["attn"], h, cfg, None)
    o = attn.prefill_attention(q, k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous(),
                               causal=False)          # bidirectional
    return _mlp(lp, x + _o_proj(o, lp["attn"]["wo"]), cfg)


def encoder_forward(params, frames, cfg, gather=WHOLE):
    """frames (B, Senc, d) -> (B, Senc, d); ``gather`` runs each layer and
    each leaf outside the stack (``transformer.WholeParams``)."""
    Senc = frames.shape[1]
    frames = frames.to(params["embed"].dtype)   # the stub frontend emits f32
    x = gather.run(lambda pos: frames + pos[:Senc].to(frames.dtype),
                   params["enc_pos"])
    for lp in gather.layers(params["encoder"]):
        x = gather.run(_enc_layer, lp, x, cfg)
    return gather.run(lambda w: rms_norm(x, w, cfg.norm_eps),
                      params["ln_enc"])


def _cross_kv(lp, enc_out):
    k = torch.einsum("bsd,dhk->bshk", enc_out, lp["xattn"]["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, lp["xattn"]["wv"])
    return k, v


def _dec_layer(lp, x, enc_out, cfg, positions, entry):
    S = x.shape[1]
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(lp["attn"], h, cfg, positions)
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    x = x + _o_proj(attn.prefill_attention(q, kh, vh), lp["attn"]["wo"])

    hx = rms_norm(x, lp["lnx"], cfg.norm_eps)
    qx = torch.einsum("bsd,dhk->bshk", hx, lp["xattn"]["wq"])
    xk, xv = _cross_kv(lp, enc_out)
    x = x + _o_proj(attn.cross_attention(qx, xk, xv), lp["xattn"]["wo"])
    x = _mlp(lp, x, cfg)
    if entry is not None:
        entry["self_k"][:, :, :S] = kh
        entry["self_v"][:, :, :S] = vh
        entry["cross_k"].copy_(xk.transpose(1, 2))
        entry["cross_v"].copy_(xv.transpose(1, 2))
    return x


def decoder_forward(params, x, enc_out, cfg, positions, cache=None,
                    gather=WHOLE):
    """x (B,S,d) decoder stream; enc_out (B,Senc,d).  Fills ``cache`` (from
    :func:`init_cache`, at least S self slots, Senc cross slots) when
    given; ``gather`` runs each layer.  Returns x."""
    for i, lp in enumerate(gather.layers(params["decoder"])):
        x = gather.run(_dec_layer, lp, x, enc_out, cfg, positions,
                       None if cache is None else
                       layer_views(cache["stack"], i))
    return x


def _dec_step(lp, x, cfg, pos, c, ctx):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(lp["attn"], h, cfg, pos[:, None])
    if ctx is not None and ctx.sp_decode:
        o, _, _ = sp_decode_attention(ctx, q, c["self_k"], c["self_v"],
                                      k, v, pos)
    else:
        kc, vc = attn.cache_write_plain(c["self_k"], c["self_v"], k, v,
                                        pos)
        o = attn.decode_attention_plain(q, kc, vc, pos)
    x = x + _o_proj(o, lp["attn"]["wo"])

    hx = rms_norm(x, lp["lnx"], cfg.norm_eps)
    qx = torch.einsum("bsd,dhk->bshk", hx, lp["xattn"]["wq"])
    last = torch.full((x.shape[0],), c["cross_k"].shape[2] - 1,
                      dtype=torch.int32, device=x.device)
    ox = attn.decode_attention_plain(qx, c["cross_k"], c["cross_v"], last)
    return _mlp(lp, x + _o_proj(ox, lp["xattn"]["wo"]), cfg)


def decoder_decode(params, x, cfg, pos, cache, *, ctx=None, gather=WHOLE):
    """One-token decode; cache entries per layer: self_k/self_v
    (B,KV,S,hd), written in place, and cross_k/cross_v (B,KV,Senc,hd).
    With ``ctx.sp_decode`` the self attention is ``sp_decode_attention``,
    as in the reference; ``gather`` runs each layer."""
    for i, lp in enumerate(gather.layers(params["decoder"])):
        x = gather.run(_dec_step, lp, x, cfg, pos,
                       layer_views(cache["stack"], i), ctx)
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
