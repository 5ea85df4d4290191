"""Sequence-parallel decode attention (port of
``repro/distributed/decode_attn.py``) on ``torch.distributed``.

A decode KV cache may be split along its *sequence* axis over the mesh's
``model`` ranks: each rank holds its batch rows and S/m of the cache slots
(m the ``model`` axis's size), computes a partial flash-style (m, l, o)
against its slots, and the partials merge by log-sum-exp over the
``model`` group: an all-reduce MAX of the row maxima, then all-reduce SUMs
of the rescaled sums and outputs.  A cache that would not fit one rank
whole then needs no replicated KV heads.

The new token's K/V is written only on the rank owning slot ``pos``.  The
function runs on each rank's local tensors (the reference's ``shard_map``
body); with a ``model`` axis of one rank there is nothing to merge.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

NEG = -1e30


def sp_decode_attention(ctx, q, k_cache, v_cache, new_k, new_v, pos):
    """This rank's rows and slots: q (Bl,1,H,hd); caches (Bl,KV,Sl,hd),
    holding global slots [i Sl, (i+1) Sl) on the ``model`` rank i; new_k,
    new_v (Bl,1,KV,hd); pos (Bl,), each row's global slot of the new
    token.  Writes the new entries in place on the owning rank and returns
    (out (Bl,1,H,hd), k_cache, v_cache)."""
    group = ctx.group(("model",))
    s_idx = 0 if group is None else dist.get_rank(group)
    Bl, _, H, hd = q.shape
    KV, Sl = k_cache.shape[1], k_cache.shape[2]
    G = H // KV

    # ---- write the new token on the owning rank ----
    p = pos.long()
    off = torch.remainder(p, Sl)
    write = (p // Sl == s_idx)[:, None, None]
    rows = torch.arange(Bl, device=q.device)
    for c, n in ((k_cache, new_k), (v_cache, new_v)):
        c[rows, :, off] = torch.where(write, n[:, 0], c[rows, :, off])

    # ---- partial attention on the local slots ----
    qg = q.reshape(Bl, KV, G, hd)
    s = torch.einsum("bkgh,bksh->bkgs", qg, k_cache).float() * (hd ** -0.5)
    kpos = s_idx * Sl + torch.arange(Sl, device=q.device)
    valid = kpos[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))

    m_l = s.amax(dim=-1)                                 # (Bl,KV,G)
    e = torch.exp(s - m_l[..., None])
    l_l = e.sum(dim=-1)
    o_l = torch.einsum("bkgs,bksh->bkgh", e.to(v_cache.dtype),
                       v_cache).float()

    # ---- merge the partials over the model ranks (log-sum-exp) ----
    m_g = m_l
    if group is not None:
        m_g = m_l.clone()
        dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    c = torch.exp(m_l - m_g)
    l_g = l_l * c
    o_g = o_l * c[..., None]
    if group is not None:
        dist.all_reduce(l_g, group=group)
        dist.all_reduce(o_g, group=group)
    out = (o_g / torch.clamp(l_g, min=1e-30)[..., None]).to(q.dtype)
    return out.reshape(Bl, 1, H, hd), k_cache, v_cache
