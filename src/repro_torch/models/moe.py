"""Mixture-of-Experts FFN with gather-based capacity dispatch (port of
``repro/models/moe.py``: ``moe_ffn`` and ``moe_ffn_shardmap``).

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
decode step queues its layers without waiting for the card.

Two routings under a :class:`~repro_torch.distributed.DistContext`, as in
the reference:

- *Global* (``moe_ffn``, the reference's GSPMD program).  Under a
  data-parallel step (:mod:`repro_torch.distributed.steps`) whose batch
  rows are split over more than one rank, the capacity
  ``_capacity(T_global)``, the sort and the aux loss follow the global
  tokens of each microbatch.  The layer gathers its input from the batch
  group (its backward a reduce-scatter), routes and runs the experts on
  every token, and keeps this rank's rows: each rank spends the routed
  experts' FLOPs of the whole group's tokens, (ranks - 1) times its own
  share more than local routing.  The reference's ``shard`` annotations
  are identities in the port.
- *Local* (``moe_ffn_shardmap``, chosen by ``ctx.extra["moe_impl"] ==
  "shardmap"`` in tp mode, the reference's shard_map).  Each rank routes
  its own rows (capacity :func:`shardmap_capacity` of its tokens) and runs
  its block of the experts: EP (``expert_mode`` ``ep``) model rank j the
  experts ``[j E/m, (j+1) E/m)``, buffering only the slots routed to them;
  expert-TP (``tp``) the j-th 1/m of every expert's ffn dim.  The layer
  ends in one (T_local, d) sum over the ``model`` group; the aux loss
  comes from the batch group's summed ``me`` and ``ce``.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed.context import gather_rows
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


def shardmap_capacity(tokens: int, cfg) -> int:
    """The local routing's capacity (the reference's ``moe.py:82``): the
    ceiling, where ``_capacity`` truncates, so the two differ where
    tokens K cf / E is not whole and truncates to a multiple of 8."""
    c = math.ceil(tokens * cfg.experts_per_tok * cfg.capacity_factor
                  / cfg.num_experts / 8)
    return max(8, c * 8)


def top_k(probs, k: int):
    """(T, E) -> (values, indices) of the k largest per row, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_ffn(p, x, cfg, ctx=None):
    """x: (B, S, d) -> (out, aux_loss).  With a ``DistContext`` whose batch
    group has more than one rank (this rank's rows of a split batch),
    routing, capacity and aux follow the group's tokens; with
    ``ctx.extra["moe_impl"] == "shardmap"`` and an ``ep`` or ``tp``
    expert mode, :func:`moe_ffn_shardmap` routes this rank's own tokens
    (module docstring).  fsdp's expert mode (``fsdp``) keeps the global
    routing, as the reference's dispatch does (``moe.py:163-165``)."""
    if (ctx is not None and ctx.extra.get("moe_impl") == "shardmap"
            and ctx.rules.get("expert_mode") in ("ep", "tp")):
        return moe_ffn_shardmap(p, x, cfg, ctx)
    B, S, d = x.shape
    group = None if ctx is None else ctx.batch_group()
    if group is None:
        out, aux = _routed(p, x.reshape(B * S, d), cfg)
    else:
        r = dist.get_rank(group)
        xg = gather_rows(x, group)                      # (ranks * B, S, d)
        out, aux = _routed(p, xg.reshape(-1, d), cfg)
        out = out.reshape(-1, S, d)[r * B:(r + 1) * B].reshape(B * S, d)
    return _shared(p, x, cfg, out), aux


def _shared(p, x, cfg, out):
    """The routed output (T, d) plus the shared expert on x (B, S, d),
    reshaped to x's shape."""
    B, S, d = x.shape
    if cfg.shared_expert_d_ff:
        xt = x.reshape(B * S, d)
        sp = p["shared"]
        sgate = torch.sigmoid((xt @ sp["gate"]).float())
        out = out + (sgate.to(x.dtype) *
                     swiglu(xt, sp["w_gate"], sp["w_up"], sp["w_down"]))
    return out.reshape(B, S, d)


def _route(xt, router, cfg):
    """Tokens (T, d) -> (probs (T, E) f32, gate (T, K), idx (T, K))."""
    logits = (xt @ router).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, cfg.experts_per_tok)             # (T,K)
    if cfg.norm_topk_prob:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    return probs, gate, idx


def _routed(p, xt, cfg):
    """The routed experts over tokens xt (T, d) -> (out (T, d), aux)."""
    T = xt.shape[0]
    E = cfg.num_experts
    probs, gate, idx = _route(xt, p["router"], cfg)

    # Load-balance auxiliary loss (Switch-style).
    experts = torch.arange(E, device=xt.device)
    me = probs.mean(dim=0)
    ce = (idx[:, :1] == experts).float().mean(dim=0)          # one-hot
    aux = cfg.router_aux_coef * E * (me * ce).sum()

    out = _experts(xt, gate, idx, p["w_gate"], p["w_up"], p["w_down"],
                   _capacity(T, cfg), E)
    return out, aux


def _experts(xt, gate, idx, w_gate, w_up, w_down, C: int, E: int,
             e0: int = 0):
    """Dispatch, the grouped SwiGLU and the combine over the experts
    ``[e0, e0 + n)`` whose weights (n, d, f) / (n, f, d) are given; the
    other experts' slots go to the scratch row, their gates to 0.  Slots
    past capacity C (ranked among all E experts' assignments) drop."""
    T, d = xt.shape
    K = idx.shape[1]
    n = w_gate.shape[0]
    # ---- dispatch: rank each (token, slot) within its expert via sort ----
    e_flat = idx.reshape(-1)                                  # (T*K,)
    order = torch.argsort(e_flat, stable=True)                # group by expert
    # bincount(minlength=E) without its device->host read of the max
    counts = torch.zeros(E, dtype=e_flat.dtype, device=xt.device) \
        .scatter_add_(0, e_flat, torch.ones_like(e_flat))      # (E,)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(T * K, device=xt.device) - starts[e_flat[order]]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    mine = (rank < C).reshape(T, K)                           # keep
    local_e = idx
    if n < E:               # only the slots routed to these experts
        local_e = idx - e0
        mine = mine & (local_e >= 0) & (local_e < n)
    slot = torch.where(mine, local_e * C + rank.reshape(T, K),
                       torch.full_like(idx, n * C))           # drop->scratch

    # K scatters of (T, d): never a (T*K, d) intermediate
    buf = torch.zeros((n * C + 1, d), dtype=xt.dtype, device=xt.device)
    for k in range(K):
        buf.index_copy_(0, slot[:, k], xt)
    buf = buf[: n * C].reshape(n, C, d)

    # ---- grouped expert SwiGLU (the real FLOPs) ----
    g = torch.einsum("ecd,edf->ecf", buf, w_gate)
    u = torch.einsum("ecd,edf->ecf", buf, w_up)
    eo = torch.einsum("ecf,efd->ecd", silu(g) * u, w_down)

    # ---- combine: K gathers of (T, d), weighted sum ----
    eo_flat = torch.cat([eo.reshape(n * C, d), eo.new_zeros((1, d))])
    w = (gate * mine).to(xt.dtype)                            # (T,K)
    out = torch.zeros((T, d), dtype=xt.dtype, device=xt.device)
    for k in range(K):
        out = out + eo_flat[slot[:, k]] * w[:, k:k + 1]
    return out


# ----------------------------------------------------------------------
# local routing (the reference's shard_map)
# ----------------------------------------------------------------------

class _FromReplicated(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``: an
    input every rank of the group holds, read by each rank's share of a
    sum (shard_map's transpose of an input replicated over the axis)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumOver(torch.autograd.Function):
    """The sum over ``group`` of each rank's partial (the reference's
    ``psum``); the backward the identity: every rank holds the summed
    output and its whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _replicated(t, group):
    """``t`` through :class:`_FromReplicated` where a gradient will flow
    and the group has more than one rank, else ``t`` itself."""
    if group is None or not (torch.is_grad_enabled() and t.requires_grad):
        return t
    return _FromReplicated.apply(t, group)


def local_experts(p, cfg, expert_mode: str, j: int, m: int):
    """Model rank j of m's block of the routed experts' weights -> (w_gate,
    w_up, w_down, e0), e0 the first expert of the block: EP the experts
    ``[j E/m, (j+1) E/m)``, expert-TP every expert's j-th 1/m of the ffn
    dim (columns of w_gate and w_up, rows of w_down).

    The reference's layer holds the ff dim sharded over the data axes
    under EP and all-gathers it here (``moe.py:112-116``).  In the port's
    steps that gather is the per-unit gather of ``distributed/fsdp.py``
    (``UnitGather``), which hands the layer its weights full, each unit
    just before it runs; this slice is the one place that takes the
    rank's block of them."""
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if m == 1:
        return wg, wu, wd, 0
    if expert_mode == "ep":
        n = cfg.num_experts // m
        e0 = j * n
        return wg[e0:e0 + n], wu[e0:e0 + n], wd[e0:e0 + n], e0
    if cfg.d_ff % m:
        raise ValueError(f"expert-TP splits d_ff {cfg.d_ff} over a 'model' "
                         f"axis of {m}, which does not divide it")
    f = cfg.d_ff // m
    cols = slice(j * f, (j + 1) * f)
    return wg[:, :, cols], wu[:, :, cols], wd[:, cols], 0


def moe_ffn_shardmap(p, x, cfg, ctx):
    """MoE with *local* token routing (port of the reference's
    ``moe_ffn_shardmap``, ``moe.py:46-158``): x (B, S, d) is this rank's
    rows of the batch group, the weights full.  Returns (out, aux) as
    :func:`moe_ffn`.

    This rank routes its own B S tokens (capacity
    :func:`shardmap_capacity`) and runs its block of the experts
    (:func:`local_experts`); the partial outputs are summed over the
    ``model`` group (backward the identity).  x, the router and the
    expert weights, which the block reads replicated over ``model``, pass
    through an identity whose backward sums over ``model``, so every rank
    holds the reference's gradients.  The aux loss follows the batch
    group's tokens: the (E,) sums of the router's probabilities and of the
    top-1 one-hot are summed over the batch group, the first with a
    summing backward, so that after the step's mean over the batch group
    the router's gradient is the reference's.  The shared expert runs on
    the local rows.  A group of one rank issues no collective."""
    B, S, d = x.shape
    E = cfg.num_experts
    T = B * S
    mgroup, bgroup = ctx.group(("model",)), ctx.batch_group()
    m = 1 if mgroup is None else dist.get_world_size(mgroup)
    j = 0 if mgroup is None else dist.get_rank(mgroup)
    xt = x.reshape(T, d)

    xm = _replicated(xt, mgroup)
    probs, gate, idx = _route(xm, _replicated(p["router"], mgroup), cfg)
    wg, wu, wd, e0 = local_experts(
        {k: _replicated(p[k], mgroup) for k in ("w_gate", "w_up", "w_down")},
        cfg, ctx.rules["expert_mode"], j, m)
    out = _experts(xm, gate, idx, wg, wu, wd, shardmap_capacity(T, cfg), E,
                   e0)
    if mgroup is not None:
        out = _SumOver.apply(out, mgroup)
        # the aux loss's router product stays off the model sum
        probs = torch.softmax((xt @ p["router"]).float(), dim=-1)

    # aux load-balance loss on the batch group's tokens
    me = probs.sum(dim=0)
    top = probs.argmax(dim=-1)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add_(
        0, top, torch.ones_like(top, dtype=torch.float32))
    n_tokens = T
    if bgroup is not None:
        # summed, and so is its gradient: the all-reduce's own adjoint
        me = _SumOver.apply(_replicated(me, bgroup), bgroup)
        dist.all_reduce(ce, group=bgroup)
        n_tokens = T * dist.get_world_size(bgroup)
    aux = cfg.router_aux_coef * E * ((me / n_tokens) * (ce / n_tokens)).sum()
    return _shared(p, x, cfg, out), aux
