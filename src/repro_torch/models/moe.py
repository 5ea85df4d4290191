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
  its own rows (capacity :func:`shardmap_capacity` of its tokens); the
  aux loss comes from the batch group's summed ``me`` and ``ce``.

Under a tp context with a ``model`` axis above one rank, either routing
runs its block of the experts, as ``make_rules`` splits them
(``context.py:66-85``): EP (``expert_mode`` ``ep``, the model axis
divides ``num_experts``) model rank j the experts ``[j E/m, (j+1) E/m)``
and the router's columns of them, buffering only the slots routed to
them; expert-TP (``tp``) the j-th 1/m of every expert's ffn dim, the
router whole.  The shared expert is split as a SwiGLU mlp.  The tp steps
hand the layer these blocks, read in place (an EP expert's ffn dim split
over the data axes is gathered by the step's per-unit gather first);
every model rank routes the same tokens to the same experts, and the
layer ends in one (T, d) all-reduce over ``model`` of the routed and the
shared expert's partial outputs (:func:`_split_experts`).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed import tensor_parallel as tp
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
    routing, capacity and aux follow the group's tokens; under a tp
    context with a ``model`` axis above one rank the experts are split
    over it (:func:`_split_experts`); with ``ctx.extra["moe_impl"] ==
    "shardmap"`` and an ``ep`` or ``tp`` expert mode,
    :func:`moe_ffn_shardmap` routes this rank's own tokens (module
    docstring).  fsdp's expert mode (``fsdp``) keeps the global routing,
    as the reference's dispatch does (``moe.py:163-165``)."""
    if (ctx is not None and ctx.extra.get("moe_impl") == "shardmap"
            and ctx.rules.get("expert_mode") in ("ep", "tp")):
        return moe_ffn_shardmap(p, x, cfg, ctx)
    B, S, d = x.shape
    group = None if ctx is None else ctx.batch_group()
    mgroup = tp.model_group(ctx)
    if mgroup is not None:
        return _global_over_model(p, x, cfg, ctx.rules["expert_mode"],
                                  group, mgroup)
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
    return _choose((xt @ router).float(), cfg)


def _choose(logits, cfg):
    """The router's f32 logits (T, E) -> (probs, gate (T, K), idx (T, K))."""
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, cfg.experts_per_tok)             # (T,K)
    if cfg.norm_topk_prob:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    return probs, gate, idx


def _switch_aux(probs, idx, cfg):
    """The load-balance auxiliary loss (Switch-style) of the tokens'
    router probabilities (T, E) and top-K choices (T, K)."""
    E = cfg.num_experts
    experts = torch.arange(E, device=probs.device)
    me = probs.mean(dim=0)
    ce = (idx[:, :1] == experts).float().mean(dim=0)          # one-hot
    return cfg.router_aux_coef * E * (me * ce).sum()


def _routed(p, xt, cfg):
    """The routed experts over tokens xt (T, d) -> (out (T, d), aux)."""
    T = xt.shape[0]
    probs, gate, idx = _route(xt, p["router"], cfg)
    aux = _switch_aux(probs, idx, cfg)
    out = _experts(xt, gate, idx, p["w_gate"], p["w_up"], p["w_down"],
                   _capacity(T, cfg), cfg.num_experts)
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
# the experts split over 'model' (tp with a model axis above one rank)
# ----------------------------------------------------------------------

def _block_of(size: int, m: int, what: str) -> int:
    if size % m:
        raise ValueError(f"{what} of {size} does not split over a 'model' "
                         f"axis of {m}")
    return size // m


def _check_blocks(leaves, n: int) -> None:
    """Each (leaf, dim) of ``leaves`` is this rank's block: ``n`` along
    ``dim``, as the tp steps hand the layer its weights."""
    for w, dim in leaves:
        if w.shape[dim] != n:
            raise ValueError(f"moe over 'model': a leaf of shape "
                             f"{tuple(w.shape)}, not this rank's block of "
                             f"{n} along dim {dim}")


def _split_experts(p, xt, cfg, expert_mode: str, mgroup, C: int):
    """The routed experts of tokens ``xt`` (T, d), whole on every ``model``
    rank, over this rank's block of them -> (``xm``, the aux's logits,
    idx, this rank's partial output (T, d)).

    EP (``expert_mode`` ``ep``): rank j's experts ``[j E/m, (j+1) E/m)``
    and its column block (d, E/m) of the router; the logits' blocks are
    gathered (:func:`~repro_torch.distributed.tensor_parallel.
    gather_model_grad`) so that every rank routes the same (T, E)
    probabilities.  Expert-TP (``tp``): every expert's j-th 1/m of the ffn
    dim, the router whole.  Each rank combines only its own experts' (or
    ffn blocks') slots, so the combine's gradient into the router's logits
    is summed over ``model``; the aux loss, which every rank holds whole,
    reads the same logits through a path whose gradient is not summed, so
    it counts once.  ``xm`` is ``xt`` through ``to_model``, the input of
    every product with a block of weights."""
    m, j = dist.get_world_size(mgroup), dist.get_rank(mgroup)
    E = cfg.num_experts
    xm = tp.to_model(xt, mgroup)
    w = [p["w_gate"], p["w_up"], p["w_down"]]
    if expert_mode == "ep":
        n = _block_of(E, m, "num_experts")
        _check_blocks(zip(w + [p["router"]], (0, 0, 0, 1)), n)
        logits, aux_logits = tp.gather_model_grad(
            (xm @ p["router"]).float(), 1, mgroup)
        e0 = j * n
    else:
        _check_blocks(zip(w, (2, 2, 1)),
                      _block_of(cfg.d_ff, m, "expert-TP's d_ff"))
        aux_logits = (xt @ p["router"]).float()
        logits = tp.to_model(aux_logits, mgroup)
        e0 = 0
    _, gate, idx = _choose(logits, cfg)
    return xm, aux_logits, idx, _experts(xm, gate, idx, *w, C, E, e0)


def _shared_part(sp, xm, cfg, mgroup):
    """This rank's part of the shared expert on ``xm`` (T, d): its block
    of the mlp (columns of w_gate and w_up, rows of w_down) times the
    sigmoid gate, whose (d, 1) weight every rank holds whole and uses for
    its own part only (so its gradient is summed over ``model``)."""
    f = _block_of(cfg.shared_expert_d_ff, dist.get_world_size(mgroup),
                  "shared_expert_d_ff")
    _check_blocks(zip((sp["w_gate"], sp["w_up"], sp["w_down"]), (1, 1, 0)),
                  f)
    sgate = torch.sigmoid((xm @ tp.to_model(sp["gate"], mgroup)).float())
    return sgate.to(xm.dtype) * swiglu(xm, sp["w_gate"], sp["w_up"],
                                       sp["w_down"])


def _global_over_model(p, x, cfg, expert_mode: str, bgroup, mgroup):
    """:func:`moe_ffn`'s global routing with the experts split over
    ``model`` (the reference's GSPMD program at ``moe.py:161-220`` under
    tp): the batch group's tokens gathered as at one ``model`` rank,
    routed with ``_capacity(T_global)`` and run through this rank's block
    of the experts (:func:`_split_experts`); this rank's rows of that
    partial output plus its part of the shared expert leave in one
    all-reduce over ``model`` (``from_model``)."""
    B, S, d = x.shape
    xg = x if bgroup is None else gather_rows(x, bgroup)
    xt = xg.reshape(-1, d)
    xm, aux_logits, idx, out = _split_experts(
        p, xt, cfg, expert_mode, mgroup, _capacity(xt.shape[0], cfg))
    aux = _switch_aux(torch.softmax(aux_logits, dim=-1), idx, cfg)
    if bgroup is not None:
        rows = slice(dist.get_rank(bgroup) * B * S,
                     (dist.get_rank(bgroup) + 1) * B * S)
        out, xm = out[rows], xm[rows]
    if cfg.shared_expert_d_ff:
        out = out + _shared_part(p["shared"], xm, cfg, mgroup)
    return tp.from_model(out, mgroup).reshape(B, S, d), aux


# ----------------------------------------------------------------------
# local routing (the reference's shard_map)
# ----------------------------------------------------------------------

def moe_ffn_shardmap(p, x, cfg, ctx):
    """MoE with *local* token routing (port of the reference's
    ``moe_ffn_shardmap``, ``moe.py:46-158``): x (B, S, d) is this rank's
    rows of the batch group.  Returns (out, aux) as :func:`moe_ffn`.

    This rank routes its own B S tokens (capacity
    :func:`shardmap_capacity`).  With a ``model`` axis above one rank it
    runs its block of the experts (:func:`_split_experts`), and its
    partial output, with its part of the shared expert, is summed over
    the ``model`` group in one all-reduce (the reference's one ``psum``).
    The weights come as this rank's blocks (the tp steps hand them over,
    read in place).  The aux loss follows the batch group's tokens: the (E,)
    sums of the router's probabilities and of the top-1 one-hot are summed
    over the batch group, the first with a summing backward, so that after
    the step's mean over the batch group the router's gradient is the
    reference's.  A group of one rank issues no collective."""
    B, S, d = x.shape
    E = cfg.num_experts
    T = B * S
    mgroup, bgroup = tp.model_group(ctx), ctx.batch_group()
    xt = x.reshape(T, d)
    C = shardmap_capacity(T, cfg)
    if mgroup is None:
        probs, gate, idx = _route(xt, p["router"], cfg)
        out = _shared(p, x, cfg, _experts(xt, gate, idx, p["w_gate"],
                                          p["w_up"], p["w_down"], C, E))
    else:
        xm, aux_logits, _, out = _split_experts(
            p, xt, cfg, ctx.rules["expert_mode"], mgroup, C)
        if cfg.shared_expert_d_ff:
            out = out + _shared_part(p["shared"], xm, cfg, mgroup)
        out = tp.from_model(out, mgroup).reshape(B, S, d)
        probs = torch.softmax(aux_logits, dim=-1)

    # aux load-balance loss on the batch group's tokens
    me = probs.sum(dim=0)
    top = probs.argmax(dim=-1)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).scatter_add_(
        0, top, torch.ones_like(top, dtype=torch.float32))
    n_tokens = T
    if bgroup is not None:
        # summed over the batch group, and so is its gradient (the
        # all-reduce's own adjoint): sum_model's operator on that group
        me = tp.sum_model(me, bgroup)
        dist.all_reduce(ce, group=bgroup)
        n_tokens = T * dist.get_world_size(bgroup)
    aux = cfg.router_aux_coef * E * ((me / n_tokens) * (ce / n_tokens)).sum()
    return out, aux
