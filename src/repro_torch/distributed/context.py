"""Distribution context (port of ``repro/distributed/context.py``).

``DistContext`` carries the mesh and the logical -> mesh axis rules.  The
mesh is a ``torch.distributed`` ``DeviceMesh`` with the reference's axis
names (``("data", "model")`` or ``("pod", "data", "model")``), or, where
only the placement trees are wanted, a plain ``{axis: size}`` mapping: the
rules and specs read nothing but the axis sizes, so full-size configs on a
256-chip mesh are computed without a device.

A spec is a tuple with one entry per tensor dimension, as the reference's
``PartitionSpec``: ``None``, a mesh axis name, or a tuple of axis names
(the dimension split over those axes, the first the major one).
:meth:`DistContext.placements` maps a spec to DTensor placements, one per
mesh dimension.
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard


def _divisible(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size}, in the mesh's order, of a ``DeviceMesh`` or of a
    mapping that already is one."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_rules(cfg, mesh, *, sp_decode: bool = True,
               mode: str = "tp") -> dict[str, Any]:
    """Logical axis name -> mesh axis (or tuple of mesh axes, or None), as
    the reference's ``make_rules`` (``context.py:21``); ``mesh`` is a
    ``DeviceMesh`` or an {axis: size} mapping."""
    axes = mesh_axes(mesh)
    model = "model" if "model" in axes else None
    data_axes = tuple(a for a in ("pod", "data") if a in axes)
    msize = axes.get("model", 1)

    if mode == "fsdp":
        # data-parallel over every mesh axis, parameters fully sharded
        all_axes = data_axes + (("model",) if model else ())
        rules: dict[str, Any] = {k: None for k in (
            "seq", "embed", "head_dim", "heads", "kv_heads", "mlp", "vocab",
            "layers", "groups", "conv", "pos", "ssm_heads", "ssm_state",
            "ssm_inner", "lru", "lru_block", "enc_seq", "experts",
            "expert_mlp")}
        rules["batch"] = all_axes
        rules["cache_seq"] = model if sp_decode else None
        rules["expert_mode"] = "none" if not cfg.num_experts else "fsdp"
        rules["mode"] = "fsdp"
        return rules

    def by_model(n):
        return model if _divisible(n or 1, msize) else None

    rules = {
        "mode": "tp",
        "batch": data_axes if data_axes else None,
        "seq": None,
        "cache_seq": model if sp_decode else None,
        "embed": None,
        "head_dim": None,
        "heads": by_model(cfg.num_heads),
        "kv_heads": by_model(cfg.num_kv_heads),
        "mlp": model,
        "vocab": model,
        "layers": None,
        "groups": None,
        "conv": None,
        "pos": None,
        "ssm_heads": by_model(getattr(cfg, "ssm_heads", 0)),
        "ssm_state": None,
        "ssm_inner": by_model(cfg.d_inner),
        "lru": by_model(cfg.lru_width),
        "lru_block": None,
        "enc_seq": None,
    }
    # MoE: expert-parallel when divisible, else tensor-parallel in experts
    if cfg.num_experts and _divisible(cfg.num_experts, msize):
        rules["experts"] = model
        # the expert ffn dim also over the data axes (FSDP-style)
        dsize = 1
        for a in data_axes:
            dsize *= axes[a]
        rules["expert_mlp"] = (data_axes if len(data_axes) > 1
                               else data_axes[0]) if (
            data_axes and _divisible(cfg.d_ff, dsize)) else None
        rules["expert_mode"] = "ep"
    else:
        rules["experts"] = None
        rules["expert_mlp"] = model
        rules["expert_mode"] = "tp" if cfg.num_experts else "none"
    return rules


@dataclass
class DistContext:
    mesh: Any                       # DeviceMesh, or {axis: size} for specs
    rules: dict[str, Any]
    sp_decode: bool = True          # sequence-parallel decode attention
    # kept and never read, as in the reference: a tp step splits the vocab
    # over 'model' by its rules (distributed/tensor_parallel.py)
    vocab_parallel: bool = False
    extra: dict = field(default_factory=dict)   # "moe_impl" (models/moe.py)
    # process groups over several mesh axes, made once (:meth:`group`)
    _groups: dict = field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def create(cls, cfg, mesh, *, sp_decode: bool = True,
               vocab_parallel: bool = False,
               mode: str = "tp") -> "DistContext":
        return cls(mesh=mesh,
                   rules=make_rules(cfg, mesh, sp_decode=sp_decode, mode=mode),
                   sp_decode=sp_decode, vocab_parallel=vocab_parallel)

    @property
    def mode(self) -> str:
        return self.rules.get("mode", "tp")

    @property
    def axes(self) -> dict[str, int]:
        """{mesh axis: size}, in the mesh's order."""
        return mesh_axes(self.mesh)

    # ------------------------------------------------------------------
    def pspec(self, logical_axes: tuple) -> tuple:
        """The spec of a tensor with these logical axes: each mesh axis used
        once, by the first dimension that claims it."""
        spec, used = [], set()
        for ax in logical_axes:
            m = self.rules.get(ax) if ax is not None else None
            if m is None:
                spec.append(None)
                continue
            ms = (m,) if isinstance(m, str) else tuple(m)
            ms = tuple(a for a in ms if a not in used)
            used.update(ms)
            spec.append((ms[0] if len(ms) == 1 else ms) if ms else None)
        return tuple(spec)

    def placements(self, spec: tuple) -> tuple:
        """DTensor placements, one per mesh dimension, of a spec: ``Shard(d)``
        on each mesh axis that splits dimension d, ``Replicate()`` on the
        others.  A dimension split over several axes lists them in the
        mesh's order (major first), which is the order in which DTensor
        splits a dimension sharded on several mesh dimensions, so every
        rank holds the block jax gives the device at its coordinate."""
        names = list(self.axes)
        out: list = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            group = (entry,) if isinstance(entry, str) else tuple(entry)
            idx = [names.index(a) for a in group]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                                 f"axis order {tuple(names)}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def group(self, axes: tuple):
        """The process group over the mesh axes ``axes``, ranks in mesh
        order: ``None`` when every one of them has size 1, the axis's own
        group for one axis of size > 1, the whole mesh's group when the
        axes hold every mesh axis of size > 1 and the mesh is the world.
        Otherwise (the multipod mesh's ("pod", "data") batch group) a group
        a slice of the mesh, made with ``dist.new_group`` by every rank
        together at the first call for those axes and kept."""
        live = [a for a in self.axes if self.axes[a] > 1]
        mine = [a for a in live if a in axes]
        if not mine:
            return None
        if len(mine) == 1:
            return self.mesh.get_group(mine[0])
        ranks = self.mesh.mesh.flatten().tolist()
        if mine == live and ranks == list(range(dist.get_world_size())):
            return dist.group.WORLD
        key = tuple(mine)
        if key not in self._groups:
            names = list(self.axes)
            keep = [names.index(a) for a in mine]
            rest = [i for i in range(len(names)) if i not in keep]
            # one slice per coordinate of the other axes, ranks in mesh
            # order (the kept axes' major first)
            slices = self.mesh.mesh.permute(rest + keep).reshape(
                -1, math.prod(self.axes[a] for a in mine))
            me = dist.get_rank()
            for sl in slices.tolist():
                g = dist.new_group(sl)
                if me in sl:
                    self._groups[key] = g
        return self._groups[key]

    def batch_group(self):
        """The process group the batch rows are split over (the mesh axes
        of the ``batch`` rule), or ``None`` when that is one rank."""
        m = self.rules.get("batch")
        return self.group(() if m is None else
                          (m,) if isinstance(m, str) else tuple(m))

    def shard(self, x, *logical_axes):
        """The reference's ``with_sharding_constraint`` by logical axes.  The
        port's data-parallel steps run each rank on local tensors and place
        every parameter, gradient and optimizer leaf themselves, so inside
        the model this is the identity."""
        return x


def shard(ctx: DistContext | None, x, *logical_axes):
    """``ctx.shard`` (the identity: see :meth:`DistContext.shard`), and the
    identity without a context."""
    if ctx is None:
        return x
    return ctx.shard(x, *logical_axes)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 over a process group, ranks in group order;
    the backward sums each rank's gradient of every block back to the rank
    that owns it (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


def gather_rows(x, group):
    """``x`` (rows, ...) of every rank of ``group``, stacked in rank order,
    differentiable (:class:`_GatherRows`)."""
    return _GatherRows.apply(x, group)
