"""Mixture-of-Experts FFN with gather-based capacity dispatch (port of
``repro/models/moe.py``, the single-device ``moe_ffn``).

Design, as the reference's: sort token->expert assignments, scatter tokens
into an (E, C, d) buffer (no dispatch matmul), run the grouped expert
SwiGLU (the only real FLOPs) and combine with the router weights.  Tokens
beyond an expert's capacity are dropped; every dropped slot points at one
scratch row ``E*C``, so duplicate scatter indices land only there.

Ties in the router: ``jax.lax.top_k`` puts the lower expert index first
among equal probabilities and ``torch.topk`` promises no order, so the top
K come from a stable descending sort (lower index first among equals).
The expert products are plain ``torch.einsum`` (batched matmuls), as the
reference computes them in XLA: there is no Pallas kernel here.  Nothing
in the layer reads a value back to the host (no ``bincount``, whose output
size is the input's max, no ``one_hot``, which checks its range), so a
decode step queues its layers without waiting for the card.  The
reference's ``shard`` annotations have no counterpart on one device; the
sharded ``moe_ffn_shardmap`` belongs to the distributed layer.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import P, silu, swiglu


def moe_spec(cfg):
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.d_ff
    spec = {
        "router": P((d, E), ("embed", "experts"), scale=0.02),
        "w_gate": P((E, d, ff), ("experts", "embed", "expert_mlp")),
        "w_up": P((E, d, ff), ("experts", "embed", "expert_mlp")),
        "w_down": P((E, ff, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.shared_expert_d_ff:
        sf = cfg.shared_expert_d_ff
        spec["shared"] = {
            "w_gate": P((d, sf), ("embed", "mlp")),
            "w_up": P((d, sf), ("embed", "mlp")),
            "w_down": P((sf, d), ("mlp", "embed")),
            "gate": P((d, 1), ("embed", None), scale=0.02),
        }
    return spec


def _capacity(tokens: int, cfg) -> int:
    c = int(tokens * cfg.experts_per_tok * cfg.capacity_factor / cfg.num_experts)
    return max(8, (c + 7) // 8 * 8)


def top_k(probs, k: int):
    """(T, E) -> (values, indices) of the k largest per row, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_ffn(p, x, cfg):
    """x: (B, S, d) -> (out, aux_loss)."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.num_experts, cfg.experts_per_tok
    C = _capacity(T, cfg)
    xt = x.reshape(T, d)

    logits = (xt @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, K)                               # (T,K)
    if cfg.norm_topk_prob:
        gate = gate / gate.sum(dim=-1, keepdim=True)

    # Load-balance auxiliary loss (Switch-style).
    experts = torch.arange(E, device=x.device)
    me = probs.mean(dim=0)
    ce = (idx[:, :1] == experts).float().mean(dim=0)          # one-hot
    aux = cfg.router_aux_coef * E * (me * ce).sum()

    # ---- dispatch: rank each (token, slot) within its expert via sort ----
    e_flat = idx.reshape(-1)                                  # (T*K,)
    order = torch.argsort(e_flat, stable=True)                # group by expert
    # bincount(minlength=E) without its device->host read of the max
    counts = torch.zeros(E, dtype=e_flat.dtype, device=x.device) \
        .scatter_add_(0, e_flat, torch.ones_like(e_flat))      # (E,)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(T * K, device=x.device) - starts[e_flat[order]]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    keep = (rank < C).reshape(T, K)
    slot = torch.where(keep, idx * C + rank.reshape(T, K),
                       torch.full_like(idx, E * C))           # drop->scratch

    # K scatters of (T, d): never a (T*K, d) intermediate
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    for k in range(K):
        buf.index_copy_(0, slot[:, k], xt)
    buf = buf[: E * C].reshape(E, C, d)

    # ---- grouped expert SwiGLU (the real FLOPs) ----
    g = torch.einsum("ecd,edf->ecf", buf, p["w_gate"])
    u = torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    eo = torch.einsum("ecf,efd->ecd", silu(g) * u, p["w_down"])

    # ---- combine: K gathers of (T, d), weighted sum ----
    eo_flat = torch.cat([eo.reshape(E * C, d),
                         torch.zeros((1, d), dtype=eo.dtype, device=x.device)])
    w = (gate * keep).to(x.dtype)                             # (T,K)
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for k in range(K):
        out = out + eo_flat[slot[:, k]] * w[:, k:k + 1]

    if cfg.shared_expert_d_ff:
        sp = p["shared"]
        sgate = torch.sigmoid((xt @ sp["gate"]).float())
        out = out + (sgate.to(x.dtype) *
                     swiglu(xt, sp["w_gate"], sp["w_up"], sp["w_down"]))
    return out.reshape(B, S, d), aux
