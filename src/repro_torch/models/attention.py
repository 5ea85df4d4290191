"""GQA attention (port of ``repro/models/attention.py``): the prefill path
through the flash-attention kernel, and the plain decode path.

The reference's model calls its XLA ``full_causal_attention`` for prefill
and keeps the Pallas flash kernel as the TPU's route; the port puts its
CUDA flash kernel in that place (:func:`prefill_attention`).  Decode
attention and the cache write stay plain PyTorch, as in the reference.
All softmax arithmetic is f32; masks use -1e30 (never -inf).  Banded and
window attention (the hybrid family), cross attention (encdec) and the
per-head q/k norm (qwen3, the moe family) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import P, apply_rope

NEG = -1e30


def attn_spec(cfg):
    d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {
        "wq": P((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((H, hd, d), ("heads", "head_dim", "embed")),
    }


def qkv_project(p, x, cfg, positions):
    """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,KV,hd) with rope."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, rope_pct=cfg.rope_pct, theta=cfg.rope_theta)
        k = apply_rope(k, positions, rope_pct=cfg.rope_pct, theta=cfg.rope_theta)
    return q, k, v


def prefill_attention(q, k_heads, v_heads):
    """Causal attention over a whole prompt.  q (B,S,H,hd); k/v already in
    the cache layout (B,KV,S,hd) -> (B,S,H,hd).

    The model transposes q into the kernel's (B,H,S,hd) layout (one copy
    of q; k and v are transposed once for the cache anyway)."""
    o = flash_attention(q.transpose(1, 2).contiguous(), k_heads, v_heads,
                        causal=True)
    return o.transpose(1, 2)


# ----------------------------------------------------------------------
# Decode (one token, cache): plain PyTorch
# ----------------------------------------------------------------------

def decode_attention_plain(q, k_cache, v_cache, pos):
    """q (B,1,H,hd); caches (B,KV,S,hd); pos (B,) index of the CURRENT
    token (the caches already hold it at ``pos``)."""
    B, _, H, hd = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgh,bksh->bkgs", qg, k_cache).float() * (hd ** -0.5)
    valid = torch.arange(S, device=q.device)[None, :] <= pos[:, None]   # (B,S)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
    w = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bksh->bkgh", w, v_cache)
    return out.reshape(B, 1, H, hd)


def cache_write_plain(k_cache, v_cache, new_k, new_v, pos):
    """Write (B,1,KV,hd) new entries at per-sequence position ``pos`` (B,)
    into the (B,KV,S,hd) caches, in place (the reference returns new
    arrays), and return the caches.

    The reference's ``dynamic_update_slice`` clamps an index past the end
    to the last slot and overwrites it; the port never writes past the
    end: ``LM.decode_step`` raises ``IndexError`` before the step, from a
    host-side count, so this write reads nothing back from the device."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    k_cache[rows, :, pos.long()] = new_k[:, 0]
    v_cache[rows, :, pos.long()] = new_v[:, 0]
    return k_cache, v_cache
