"""One rank of the gloo runs of ``tests/test_torch_moe_shardmap.py``.

Imports torch and the port only (it checks that jax never loads).  The
parent test writes the weights, inputs and batches of every case into an
``.npz`` and starts one process a rank:

    python tests/_torch_moe_worker.py --rank R --world N --store FILE \\
        --mesh D,M --jobs layer,steps --cases cases.npz --out DIR

``layer``: each case of :data:`LAYER_CASES` on this mesh (f32) drives
``moe_ffn`` with ``moe_impl="shardmap"`` directly: this rank's rows of x,
the full weights, ``sum(out * c) / T_local + aux`` and its backward.  The
weights' gradients are averaged over the batch group, as the train step
reduces them; every rank writes its output rows, aux, loss, gradients and
x's gradient (divided by the batch group's size) into
``DIR/layer-R.npz``.

``steps``: the moe case of ``tests/_torch_dist_worker.py`` (reduced
qwen2-moe-a2.7b at capacity factor 0.5) in tp mode with
``moe_impl="shardmap"``: two ``build_train_step`` steps (microbatches and
remat by mesh, :data:`STEP_MESHES`), one step with the global routing
(``gspmd``) from the same weights, and ``build_prefill_step`` then
``_torch_serve_worker.STEPS`` greedy ``build_decode_step`` steps (with
``sp_decode``).  Rank 0 writes the losses, grad norms, lrs, m after step
1, master and parameters after step 2, the gspmd loss, and the serve
steps' logits, ids and caches into ``DIR/steps.npz``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import _torch_dist_worker as dist_worker
import _torch_serve_worker as serve_worker

# name -> (arch, num_experts, (data, model)); EP where the model axis
# divides the experts, expert-TP where it does not; each at every factor
LAYERS = {"ep-2x2": ("qwen3-moe-235b-a22b", 8, (2, 2)),
          "ep-1x4": ("qwen3-moe-235b-a22b", 8, (1, 4)),
          "ep-4x1": ("qwen3-moe-235b-a22b", 8, (4, 1)),
          "tp-1x4": ("qwen2-moe-a2.7b", 6, (1, 4)),
          "tp-2x2": ("qwen2-moe-a2.7b", 5, (2, 2))}
CAPACITY_FACTORS = (0.5, 16.0)        # drops; none
LAYER_CASES = {f"{name}/cf{cf:g}": (arch, E, mesh, cf)
               for name, (arch, E, mesh) in LAYERS.items()
               for cf in CAPACITY_FACTORS}
LAYER_B, LAYER_S = 8, 16
STEP_ARCH = "qwen2-moe-a2.7b"
# (data, model) -> (microbatches, remat) of the shardmap train steps
STEP_MESHES = {(2, 1): (2, "dots"), (4, 1): (1, "full")}


def layer_config(key: str, get_config):
    """The reduced config of a layer case (``get_config`` from either
    package)."""
    arch, E, _, cf = LAYER_CASES[key]
    return dataclasses.replace(get_config(arch, reduced=True),
                               num_experts=E, capacity_factor=cf)


def mesh_name(mesh) -> str:
    return f"{mesh[0]}x{mesh[1]}"


def _leaves(tree, path: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def run_layers(mesh, data, rank: int, outdir: Path) -> None:
    from repro_torch.configs import get_config
    from repro_torch.distributed import DistContext
    from repro_torch.models.moe import moe_ffn

    shape = tuple(mesh.shape)
    i, _ = mesh.get_coordinate()
    n_data = shape[0]
    rows = slice(i * LAYER_B // n_data, (i + 1) * LAYER_B // n_data)
    res = {}
    for key, (_, _, at, _) in LAYER_CASES.items():
        if tuple(at) != shape:
            continue
        cfg = layer_config(key, get_config)
        ctx = DistContext.create(cfg, mesh)
        ctx.extra["moe_impl"] = "shardmap"
        prefix = f"{key}|p|"
        p = serve_worker._tree({
            n[len(prefix):]: torch.from_numpy(data[n].copy()).requires_grad_()
            for n in data.files if n.startswith(prefix)})
        x = torch.from_numpy(data[f"{key}|x"][rows].copy()).requires_grad_()
        c = torch.from_numpy(data[f"{key}|c"][rows].copy())
        y, aux = moe_ffn(p, x, cfg, ctx)
        loss = (y * c).sum() / (x.shape[0] * x.shape[1]) + aux
        loss.backward()
        group = ctx.batch_group()
        for path, t in _leaves(p):
            g = t.grad
            if group is not None:
                dist.all_reduce(g, group=group)
                g = g / n_data
            res[f"{key}|grad|{path}"] = g.numpy()
        res[f"{key}|out"] = y.detach().numpy()
        res[f"{key}|aux"] = aux.detach().numpy()
        res[f"{key}|loss"] = loss.detach().numpy()
        res[f"{key}|gx"] = (x.grad / n_data).numpy()
    np.savez(outdir / f"layer-{rank}.npz", coord=np.array(
        mesh.get_coordinate()), **res)


def run_steps(mesh, data, out: dict) -> None:
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.reducer import tree_flatten_with_path
    from repro_torch.distributed import (
        DistContext, build_decode_step, build_prefill_step, build_train_step,
        distribute_tree, gather_tree, init_sharded_opt_state,
    )
    from repro_torch.models import LM

    name = mesh_name(tuple(mesh.shape))
    mb, remat = STEP_MESHES[tuple(mesh.shape)]
    cfg = dist_worker.config(STEP_ARCH, get_config)
    prefix = "steps|params|"
    init = {n[len(prefix):]: data[n] for n in data.files
            if n.startswith(prefix)}
    batches = [data[f"steps|batch{s}|tokens"] for s in range(2)]

    def train(impl, tc, n_steps):
        lm = LM(cfg, max_seq=dist_worker.SEQ, device="cpu")
        ctx = DistContext.create(cfg, mesh)
        ctx.extra["moe_impl"] = impl
        step_fn, (p_sh, o_sh, _) = build_train_step(
            lm, tc, ctx, ShapeConfig("t", "train", dist_worker.SEQ,
                                     dist_worker.BATCH))
        params = distribute_tree(lm.load_reference(serve_worker._tree(init)),
                                 ctx, p_sh)
        opt = init_sharded_opt_state(ctx, params, o_sh)
        for s in range(n_steps):
            params, opt, metrics = step_fn(params, opt,
                                           {"tokens": batches[s]})
            yield s, params, opt, metrics

    tc = TrainConfig(microbatches=mb, remat=remat, **dist_worker.TRAIN)
    key = f"{name}|train"
    for s, params, opt, metrics in train("shardmap", tc, 2):
        for k in ("loss", "grad_norm", "lr"):
            out[f"{key}|{k}{s}"] = float(metrics[k])
        if s == 0:
            for p, t in tree_flatten_with_path(gather_tree(opt.m)):
                out[f"{key}|m1|{p}"] = t.numpy().copy()
    for tag, tree in (("master2", opt.master), ("params2", params)):
        for p, t in tree_flatten_with_path(gather_tree(tree)):
            out[f"{key}|{tag}|{p}"] = t.float().numpy()
    for _, _, _, metrics in train("gspmd", tc, 1):
        out[f"{name}|gspmd|loss0"] = float(metrics["loss"])

    # the serve steps
    lm = LM(cfg, max_seq=serve_worker.CACHE, device="cpu")
    ctx = DistContext.create(cfg, mesh, sp_decode=True)
    ctx.extra["moe_impl"] = "shardmap"
    tokens = data["steps|batch|tokens"]
    B, S = tokens.shape
    pf, (p_sh, _, _, _) = build_prefill_step(
        lm, ctx, ShapeConfig("p", "prefill", S, B),
        cache_len=serve_worker.CACHE)
    df, _ = build_decode_step(lm, ctx, ShapeConfig(
        "d", "decode", serve_worker.CACHE, B))
    params = distribute_tree(lm.load_reference(serve_worker._tree(init)),
                             ctx, p_sh)
    key = f"{name}|serve"
    logits, cache = pf(params, {"tokens": tokens})
    got = [serve_worker._full(logits)]
    for p, t in serve_worker._flat(
            {k: v for k, v in cache.items() if k != "filled"}).items():
        out[f"{key}|cache0|{p}"] = serve_worker._full(t)
    ids = []
    tok = torch.from_numpy(got[-1]).argmax(dim=-1)[:, None]
    for _ in range(serve_worker.STEPS):
        ids.append(tok[:, 0].numpy().copy())
        logits, cache = df(params, cache, {"token": tok})
        got.append(serve_worker._full(logits))
        tok = torch.from_numpy(got[-1]).argmax(dim=-1)[:, None]
    out[f"{key}|logits"] = np.stack(got)
    out[f"{key}|ids"] = np.stack(ids, axis=1)
    out[f"{key}|filled"] = np.array(cache["filled"])
    for p, t in serve_worker._flat(
            {k: v for k, v in cache.items() if k != "filled"}).items():
        out[f"{key}|cache1|{p}"] = serve_worker._full(t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for name in ("--rank", "--world"):
        ap.add_argument(name, type=int, required=True)
    for name in ("--store", "--mesh", "--jobs", "--cases", "--out"):
        ap.add_argument(name, required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")

    from repro_torch.launch.mesh import make_dev_mesh

    dist.init_process_group("gloo", store=dist.FileStore(args.store,
                                                          args.world),
                            rank=args.rank, world_size=args.world)
    n_data, n_model = (int(x) for x in args.mesh.split(","))
    mesh = make_dev_mesh(n_data, n_model, device="cpu")
    data = np.load(args.cases)
    outdir = Path(args.out)
    out: dict = {}
    for job in args.jobs.split(","):
        if job == "layer":
            run_layers(mesh, data, args.rank, outdir)
        elif job == "steps":
            run_steps(mesh, data, out)
        else:
            raise ValueError(f"job {job!r}")
    if args.rank == 0 and out:
        np.savez(outdir / "steps.npz", **out)
    dist.destroy_process_group()
    if "jax" in sys.modules:
        raise AssertionError("the worker loaded jax")
    return 0


if __name__ == "__main__":
    sys.exit(main())
