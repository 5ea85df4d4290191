"""GQA attention (port of ``repro/models/attention.py``): the prefill path
through the flash-attention kernel, and the plain decode path.

The reference's model calls its XLA ``full_causal_attention`` for prefill
and keeps the Pallas flash kernel as the TPU's route; the port puts its
CUDA flash kernel in that place (:func:`prefill_attention`).  Decode
attention and the cache write stay plain PyTorch, as in the reference.
All softmax arithmetic is f32; masks use -1e30 (never -inf).  The hybrid
family's banded local attention (prefill) and ring-buffer window decode
are plain PyTorch, as the reference computes them in XLA outside any
Pallas kernel.  The whisper encoder's unmasked self attention also goes
through flash (``causal=False``; its q and kv lengths are equal), where the
reference computes it with the XLA :func:`cross_attention`.  Cross
attention proper (the decoder's queries against the encoder's 1500
frames) stays plain PyTorch: its q and kv lengths differ, which neither
flash kernel takes, and the reference computes it in XLA outside any
Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import P, apply_rope, head_rms_norm

NEG = -1e30


def attn_spec(cfg):
    d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    spec = {
        "wq": P((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        spec["q_norm"] = P((hd,), ("head_dim",), init="zeros")
        spec["k_norm"] = P((hd,), ("head_dim",), init="zeros")
    return spec


def qkv_project(p, x, cfg, positions):
    """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,KV,hd) with rope + optional
    qk-norm (before rope, as the reference does)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, rope_pct=cfg.rope_pct, theta=cfg.rope_theta)
        k = apply_rope(k, positions, rope_pct=cfg.rope_pct, theta=cfg.rope_theta)
    return q, k, v


def prefill_attention(q, k_heads, v_heads, *, causal: bool = True):
    """Attention over a whole prompt through flash, causal (a decoder's
    prefill) or unmasked (the whisper encoder).  q (B,S,H,hd); k/v already
    in the cache layout (B,KV,S,hd) -> (B,S,H,hd).

    The model transposes q into the kernel's (B,H,S,hd) layout (one copy
    of q; k and v are transposed once for the cache anyway)."""
    o = flash_attention(q.transpose(1, 2).contiguous(), k_heads, v_heads,
                        causal=causal)
    return o.transpose(1, 2)


def banded_local_attention(q, k, v, *, window: int):
    """Sliding-window causal attention, O(S*W): block i of ``window``
    queries attends key blocks {i-1, i}, each query the last ``window``
    keys up to itself.  q (B,S,H,hd); k/v (B,S,KV,hd); S % window == 0
    -> (B,S,H,hd).  Plain PyTorch (recurrentgemma's local attention)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    W = window
    if S % W:
        raise ValueError(f"S={S} is not a multiple of the window {W}")
    nb = S // W
    qg = q.reshape(B, nb, W, KV, H // KV, hd)
    kb = k.reshape(B, nb, W, KV, hd)
    vb = v.reshape(B, nb, W, KV, hd)
    zpad = torch.zeros_like(kb[:, :1])
    # each block's keys after its previous block's: (B,nb,2W,KV,hd)
    kcat = torch.cat([torch.cat([zpad, kb[:, :-1]], 1), kb], dim=2)
    vcat = torch.cat([torch.cat([zpad, vb[:, :-1]], 1), vb], dim=2)
    s = torch.einsum("bnqkgh,bnskh->bnkgqs", qg, kcat).float() * (hd ** -0.5)
    iq = torch.arange(W, device=q.device)[:, None]
    j = torch.arange(2 * W, device=q.device)[None, :]
    diff = (W + iq) - j
    win = (diff >= 0) & (diff < W)                      # causal window
    blk = torch.arange(nb, device=q.device)[:, None, None]
    valid = win[None] & ((blk > 0) | (j[None] >= W))    # block 0 has no prev
    s = torch.where(valid[None, :, None, None], s, torch.full_like(s, NEG))
    w = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bnkgqs,bnskh->bnqkgh", w, vcat)
    return out.reshape(B, S, H, hd)


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


def decode_attention_window(q, k_cache, v_cache, pos, *, window: int):
    """Ring-buffer sliding-window decode (recurrentgemma's local attention).
    Caches (B,KV,Wc,hd); the slot of token p is p % Wc; valid keys are
    the last ``window`` positions <= pos."""
    B, _, H, hd = q.shape
    KV, Wc = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgh,bksh->bkgs", qg, k_cache).float() * (hd ** -0.5)
    slot = torch.arange(Wc, device=q.device)[None, :]
    p = pos[:, None].long()
    # global position stored in slot j: the largest q <= pos with q % Wc == j
    gpos = p - torch.remainder(p - slot, Wc)
    valid = (gpos >= 0) & (gpos >= p - (window - 1))
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
    w = torch.softmax(s, dim=-1).to(v_cache.dtype)
    return torch.einsum("bkgs,bksh->bkgh", w, v_cache).reshape(B, 1, H, hd)


def cache_write_window(k_cache, v_cache, new_k, new_v, pos):
    """Write the new entries into their ring slot ``pos % Wc``, in place."""
    return cache_write_plain(k_cache, v_cache, new_k, new_v,
                             torch.remainder(pos, k_cache.shape[2]))


# ----------------------------------------------------------------------
# Cross attention (whisper decoder): static memory, no cache writes.
# ----------------------------------------------------------------------

def cross_attention(q, k_mem, v_mem):
    """Unmasked GQA attention of q (B,S,H,hd) over a memory k/v
    (B,Senc,KV,hd) of any length -> (B,S,H,hd).  Plain PyTorch, f32
    softmax, the scores widened from the input dtype as the reference
    does."""
    B, S, H, hd = q.shape
    KV = k_mem.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k_mem).float() * (hd ** -0.5)
    w = torch.softmax(s, dim=-1).to(v_mem.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", w, v_mem).reshape(B, S, H, hd)
