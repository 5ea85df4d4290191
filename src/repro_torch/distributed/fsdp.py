"""FSDP's per-unit gather (ZeRO-3) for the train and serve steps of
:mod:`.steps`.

The reference has no module for this: its ``fsdp`` mode shards every
parameter over every mesh axis (``sharding.fsdp_sharding``) and GSPMD
gathers each one where the jitted step reads it, inside the layer scan
(``context.py:29-31``), and reduce-scatters its gradient where the
transposed scan produces it.  The port's steps run each rank on local
tensors, so they move the data themselves: a step hands ``LM`` a tree of
:class:`Ref` (a leaf's path, its layer for a stacked leaf, its full shape
and dtype) and a :class:`UnitGather`, the model's gather hook, which the
model calls around each unit (``models/transformer.py`` ``WholeParams``
is the hook of a model whose parameters lie whole on one device):

- ``layers(stack)``: one tree of refs a layer of a stacked subtree;
- ``run(fn, params, *args)``: gathers every leaf that ``params`` refers to
  (a layer of a ``stack``, a group of a hybrid's ``groups``, a layer of its
  ``tail``, of whisper's ``encoder`` or ``decoder``, or one leaf outside
  the stacks: ``embed``, ``w_out``, ``ln_f``, the position tables), runs
  ``fn`` on the full tensors and frees them.

A leaf's placement splits at most one dimension, over one or more mesh
axes (:class:`Split`).  A stacked leaf split on its ``layers`` dimension
has each layer whole on the ranks of one chunk: the layer is broadcast
from there.  A leaf split on another dimension is all-gathered along it.
A leaf that is not split over a mesh axis of more than one rank
(replicated, or at world size 1) is not gathered: the "full" tensor is the
shard itself, and it is never freed.

Under grad every rank issues the same collectives in the same order:
``run`` gathers the unit's leaves through :class:`_Gathered`, whose
backward fires once the unit's full gradients are all in; after ``fn``
the gathered storages are resized to nothing (FSDP2's idiom, so the
tensors autograd saved for the backward hold no memory), and the unit's
outputs pass :class:`_BeforeBackward`, an identity whose backward, which
runs before any op of the unit's backward (a recompute under remat
included), gathers the leaves again into the same storages.  Each full
gradient goes to the ``sink`` (the step's :class:`GradShards`) once every
use of that leaf in the forward has given its part (the tied embedding is
used twice), and is then dropped.  Under ``torch.no_grad()`` (the serve
steps) ``run`` gathers, runs and frees.

:class:`GradShards` reduces each full gradient to this rank's shard at the
optimizer's placement, the mean over the batch group (a reduce-scatter;
a reduce to the owning rank for a layers-split leaf; an all-reduce where
the placement's axes are not the batch group's), and sums the
microbatches in f32, as the steps did on whole gradients.  No prefetch:
one unit is gathered at a time (two leaves' worth during a gather along an
inner dimension, which stages the chunks).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.core.reducer import tree_flatten_with_path, tree_map_with_path


@dataclass(frozen=True)
class Ref:
    """A parameter ``LM`` reads through a :class:`UnitGather`: the leaf's
    path, the layer of a stacked leaf (None for the whole leaf), and the
    shape and dtype of what ``run`` hands ``fn``."""
    path: str
    index: int | None
    shape: tuple
    dtype: torch.dtype


@dataclass(frozen=True)
class Split:
    """How a placement splits a tensor over the mesh axes of more than one
    rank: ``dim`` over ``n`` chunks (axes ``axes``, major first), this rank
    holding chunk ``chunk``; ``group`` the ranks of those axes (None:
    ``n`` is 1, nothing to move).  A ``Shard`` over an axis of one rank
    splits nothing."""
    dim: int | None
    n: int
    chunk: int
    axes: tuple
    group: object


def split_of(ctx, placements, in_place: tuple = ()) -> Split:
    """The :class:`Split` of DTensor ``placements`` on ``ctx``'s mesh; a
    split over an axis of ``in_place`` is left out: the model reads that
    block as it is (a tp step's ``model`` axis)."""
    live = [(name, p, c) for (name, size), p, c in
            zip(ctx.axes.items(), placements, ctx.mesh.get_coordinate())
            if size > 1 and isinstance(p, Shard) and name not in in_place]
    if not live:
        return Split(None, 1, 0, (), None)
    dims = {p.dim for _, p, _ in live}
    if len(dims) > 1:
        raise NotImplementedError(f"placements {placements} split several "
                                  f"dimensions")
    n, chunk = 1, 0
    for name, _, c in live:
        n, chunk = n * ctx.axes[name], chunk * ctx.axes[name] + c
    axes = tuple(name for name, _, _ in live)
    return Split(dims.pop(), n, chunk, axes, ctx.group(axes))


def _walk(x, fn):
    """``x`` with every :class:`Ref` in its dicts, lists and tuples
    replaced by ``fn(ref)``."""
    if isinstance(x, Ref):
        return fn(x)
    if isinstance(x, dict):
        return {k: _walk(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_walk(v, fn) for v in x)
    return x


def _refs(x) -> list:
    """The distinct refs in ``x``, in walk order."""
    seen: dict = {}
    _walk(x, lambda r: seen.setdefault(r, None))
    return list(seen)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def read_shapes(params, splits: dict) -> dict:
    """{path: the shape the model reads a leaf as}: this rank's local
    tensor with the dimension its :class:`Split` divides restored (the
    full shape, but for a dimension split over an axis read in place)."""
    out = {}
    for k, p in tree_flatten_with_path(params):
        shape, sp = list(p.to_local().shape), splits[k]
        if sp.dim is not None:
            shape[sp.dim] *= sp.n
        out[k] = tuple(shape)
    return out


class _Gathered(torch.autograd.Function):
    """A unit's gathered leaves; the backward hands their full gradients
    to the gather's sink and frees the leaves.  ``anchor`` (a scalar that
    requires grad) puts the node on the graph on every rank."""

    @staticmethod
    def forward(ctx, unit, anchor):
        ctx.unit = unit
        ctx.set_materialize_grads(False)
        return unit.gather()

    @staticmethod
    def backward(ctx, *grads):
        ctx.unit.reduce(grads)
        return None, None


class _BeforeBackward(torch.autograd.Function):
    """Identity on a unit's outputs; its backward gathers the unit's
    leaves again before the unit's own backward runs."""

    @staticmethod
    def forward(ctx, unit, *xs):
        ctx.unit = unit
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.unit.gather()
        return (None,) + grads


class _Unit:
    """One ``run``'s leaves: their refs, their full tensors and which of
    those are gathered (the others alias a shard)."""

    def __init__(self, owner: "UnitGather", refs: list):
        self.owner, self.refs = owner, refs
        self.fulls: list | None = None

    def gather(self) -> tuple:
        """Gathers each leaf (first into new tensors, then into their
        freed storages); aliased shards as they are."""
        first = self.fulls is None
        if first:
            self.fulls = []
        with torch.no_grad():
            for i, r in enumerate(self.refs):
                if first:
                    self.fulls.append(self.owner.collect(r))
                elif self.fulls[i] is not None:
                    out = self.fulls[i]
                    out.untyped_storage().resize_(_nbytes(out))
                    self.owner.grow(out)
                    with torch.autograd._unsafe_preserve_version_counter(out):
                        self.owner.collect(r, out)
        return tuple(self.owner.shard_view(r) if f is None else f
                     for r, f in zip(self.refs, self.fulls))

    def free(self) -> None:
        for f in self.fulls:
            if f is not None:
                self.owner.release(f)

    def reduce(self, grads) -> None:
        self.owner.count_stale()
        self.free()
        for r, g in zip(self.refs, grads):
            self.owner.contribute(r, g)


class UnitGather:
    """The gather hook of a sharded step (module docstring).

    ``params``: this rank's DTensors; ``splits``: each leaf's
    :class:`Split` of its placement, by path; ``sink``: under grad, what
    takes each leaf's full gradient (``sink(ref, grad)``), or None for a
    step without a backward.  ``refs`` is the tree ``LM`` reads.  ``stats``
    holds the high-water mark of gathered bytes (staging included) beside
    the largest unit's, and how many full gradients of stacked leaves were
    found alive after their unit's backward (0 expected)."""

    def __init__(self, params, splits: dict, sink=None):
        self.splits, self.sink = splits, sink
        self.local = {k: p.to_local() for k, p in tree_flatten_with_path(params)}
        shapes = read_shapes(params, splits)
        self.refs = tree_map_with_path(
            lambda k, p: Ref(k, None, shapes[k], p.dtype), params)
        self.anchor = None
        self.uses: dict = {}
        self.held: dict = {}
        self.seen: dict = {}
        self.live = 0
        self.grad_refs: list = []
        self.stats = {"gathered_bytes_peak": 0, "largest_unit_bytes": 0,
                      "stale_stacked_grads": 0}

    # ---- the hook ----
    @staticmethod
    def layers(stack) -> list:
        r = _refs(stack)[0]
        return [_walk(stack, lambda q, i=i: Ref(q.path, i, q.shape[1:],
                                                q.dtype))
                for i in range(r.shape[0])]

    def run(self, fn, params, *args):
        refs = _refs(params)
        if not refs:
            return fn(params, *args)
        unit = _Unit(self, refs)
        self.stats["largest_unit_bytes"] = max(
            self.stats["largest_unit_bytes"],
            sum(math.prod(r.shape) * r.dtype.itemsize for r in refs))
        grad = torch.is_grad_enabled() and self.sink is not None
        if grad:
            if self.anchor is None:
                self.anchor = torch.zeros(
                    (), device=self.local[refs[0].path].device,
                    requires_grad=True)
            for r in refs:
                self.uses[r] = self.uses.get(r, 0) + 1
            fulls = _Gathered.apply(unit, self.anchor)
        else:
            fulls = unit.gather()
        out = fn(_walk(params, dict(zip(refs, fulls)).__getitem__), *args)
        del fulls
        unit.free()
        if not grad:
            return out
        flat: list = []
        _walk_tensors(out, flat.append)
        wrapped = iter(_BeforeBackward.apply(unit, *flat) if flat else ())
        return _walk_tensors(out, lambda _: next(wrapped))

    def finish(self) -> None:
        """After the backward: hands on what a unit whose backward never
        ran left behind (in path order, the same on every rank)."""
        for r in sorted(self.held, key=lambda r: (r.path, r.index or 0)):
            self.sink(r, self.held.pop(r))
        self.count_stale()

    # ---- moving data ----
    def shard_view(self, r: Ref):
        """A new view of this rank's shard of ``r`` (autograd may give it
        a ``grad_fn``; the shard itself stays as it is)."""
        t = self.local[r.path]
        return t.view_as(t) if r.index is None else t[r.index]

    def collect(self, r: Ref, out=None):
        """The full tensor of ``r`` (into ``out`` when given), or None
        where it is this rank's shard itself."""
        sp, local = self.splits[r.path], self.local[r.path]
        dim = sp.dim
        if r.index is not None and sp.n > 1 and dim == 0:
            k = local.shape[0]
            owner = r.index // k
            if out is None:
                out = local.new_empty(r.shape)
                self.grow(out)
            if sp.chunk == owner:
                out.copy_(local[r.index - owner * k])
            dist.broadcast(out, src=dist.get_global_rank(sp.group, owner),
                           group=sp.group)
            return out
        if r.index is not None:
            local = local[r.index]
            dim = None if dim is None else dim - 1
        if dim is None:
            return None
        if out is None:
            out = local.new_empty(r.shape)
            self.grow(out)
        if dim == 0:
            dist.all_gather_into_tensor(out, local.contiguous(), group=sp.group)
            return out
        staged = local.new_empty((sp.n * local.shape[0],)
                                 + tuple(local.shape[1:]))
        self.grow(staged)
        dist.all_gather_into_tensor(staged, local.contiguous(), group=sp.group)
        out.view(r.shape[:dim] + (sp.n, local.shape[dim]) + r.shape[dim + 1:]
                 ).copy_(staged.view((sp.n,) + tuple(local.shape))
                         .movedim(0, dim))
        self.release(staged)
        return out

    def grow(self, t) -> None:
        self.live += _nbytes(t)
        self.stats["gathered_bytes_peak"] = max(
            self.stats["gathered_bytes_peak"], self.live)

    def release(self, t) -> None:
        if t.untyped_storage().nbytes():
            self.live -= _nbytes(t)
            t.untyped_storage().resize_(0)

    # ---- gradients ----
    def contribute(self, r: Ref, g) -> None:
        """One use's full gradient of ``r`` (None: no gradient); the sum
        over the uses goes to the sink with the last."""
        if g is not None:
            self.held[r] = g if r not in self.held else self.held[r] + g
        self.seen[r] = self.seen.get(r, 0) + 1
        if self.seen[r] == self.uses[r] and r in self.held:
            g = self.held.pop(r)
            self.sink(r, g)
            if r.index is not None:
                self.grad_refs.append(StorageWeakRef(g.untyped_storage()))

    def count_stale(self) -> None:
        self.grad_refs = [w for w in self.grad_refs if not w.expired()]
        self.stats["stale_stacked_grads"] = max(
            self.stats["stale_stacked_grads"], len(self.grad_refs))


def _walk_tensors(x, fn):
    """``x`` with every tensor that requires grad in its tuples and lists
    replaced by ``fn(tensor)``."""
    if isinstance(x, torch.Tensor):
        return fn(x) if x.requires_grad else x
    if isinstance(x, (list, tuple)):
        return type(x)(_walk_tensors(v, fn) for v in x)
    return x


class GradShards:
    """A step's gradients at the optimizer's placements, from the full
    gradients a :class:`UnitGather` hands it (module docstring).

    ``params``: the DTensor parameters (their dtypes and device);
    ``shapes``: the shape the model reads each leaf as (:func:`read_shapes`
    of the parameters' splits); ``splits``: each leaf's :class:`Split` of
    its optimizer placement; ``batch_axes``, ``group``: the live mesh axes
    and the process group the batch rows are split over (None: every rank
    holds the whole gradient); ``n_micro``: the microbatches, summed in f32
    when above 1 (each full gradient cast to f32 before its collective),
    else kept in the parameters' dtype."""

    def __init__(self, params, shapes: dict, splits: dict, batch_axes: tuple,
                 group, n_micro: int):
        self.splits, self.group, self.n_micro = splits, group, n_micro
        self.batch_axes = batch_axes
        self.n_ranks = 1 if group is None else dist.get_world_size(group)
        self.shapes = shapes
        self.dtype = {k: p.dtype for k, p in tree_flatten_with_path(params)}
        self.device = next(iter(tree_flatten_with_path(params)))[1].device
        self.acc: dict = {}
        self.written: set = set()
        self.micro = 0

    def local_shape(self, path: str) -> tuple:
        shape, sp = list(self.shapes[path]), self.splits[path]
        if sp.dim is not None:
            shape[sp.dim] //= sp.n
        return tuple(shape)

    def __call__(self, r: Ref, g) -> None:
        if self.n_micro > 1:
            g = g.float()
        sp = self.splits[r.path]
        if r.index is not None and sp.dim == 0 and sp.n > 1:
            k = self.shapes[r.path][0] // sp.n
            owner = r.index // k
            g = self._mean_to(g, owner, sp)
            if g is not None:
                self._store(r.path, r.index - owner * k, g)
            return
        dim = sp.dim
        if r.index is not None and dim is not None:
            dim -= 1
        self._store(r.path, r.index, self._mean_chunk(g, dim, sp))

    def _mean_to(self, g, owner: int, sp: Split):
        """The batch group's mean of a layer whose owners are the ranks of
        chunk ``owner``: this rank's copy if it is one, else None."""
        if self.group is None:
            return g if sp.chunk == owner else None
        buf = g.to(memory_format=torch.contiguous_format, copy=True)
        if sp.axes == self.batch_axes:
            dist.reduce(buf, dst=dist.get_global_rank(self.group, owner),
                        group=self.group)
        else:
            dist.all_reduce(buf, group=self.group)
        return buf.div_(self.n_ranks) if sp.chunk == owner else None

    def _mean_chunk(self, g, dim, sp: Split):
        """The batch group's mean of ``g``, this rank's chunk along
        ``dim``."""
        if self.group is not None and dim is not None and \
                sp.axes == self.batch_axes:
            k = g.shape[dim] // sp.n
            inp = g.reshape(g.shape[:dim] + (sp.n, k) + g.shape[dim + 1:]
                            ).movedim(dim, 0).clone(
                                memory_format=torch.contiguous_format)
            out = g.new_empty(g.shape[:dim] + (k,) + g.shape[dim + 1:])
            dist.reduce_scatter_tensor(out.view(-1), inp.view(-1),
                                       group=self.group)
            return out.div_(self.n_ranks)
        if self.group is not None:
            g = g.to(memory_format=torch.contiguous_format, copy=True)
            dist.all_reduce(g, group=self.group)
            g.div_(self.n_ranks)
        if dim is None:
            return g
        k = g.shape[dim] // sp.n
        return g.narrow(dim, sp.chunk * k, k).clone()

    def _store(self, path: str, index, g) -> None:
        """Adds this microbatch's part of a leaf (``index`` None) or of
        the local layer ``index`` of a stacked leaf."""
        self.written.add((path, index))
        if index is None:
            if self.micro == 0:
                self.acc[path] = g
            else:
                self.acc[path].add_(g)
            return
        if path not in self.acc:
            self.acc[path] = g.new_empty(self.local_shape(path))
        if self.micro == 0:
            self.acc[path][index].copy_(g)
        else:
            self.acc[path][index].add_(g)

    def end_microbatch(self) -> None:
        """After the first microbatch: zeros for each leaf, or layer of a
        stacked leaf, that no use reached (as autograd leaves a leaf
        without a gradient)."""
        if self.micro == 0:
            dtype = torch.float32 if self.n_micro > 1 else None
            for path in self.shapes:
                if path not in self.acc:
                    self.acc[path] = torch.zeros(
                        self.local_shape(path), device=self.device,
                        dtype=dtype or self.dtype[path])
                elif (path, None) not in self.written:
                    for i in range(self.acc[path].shape[0]):
                        if (path, i) not in self.written:
                            self.acc[path][i].zero_()
        self.micro += 1

    def result(self) -> dict:
        """{path: this rank's gradient at its optimizer placement}, the
        microbatches' mean."""
        if self.n_micro > 1:
            return {k: x / self.n_micro for k, x in self.acc.items()}
        return dict(self.acc)
