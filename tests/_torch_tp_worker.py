"""One rank of the gloo runs of ``tests/test_torch_tp.py``.

Imports torch and the port only (it checks that jax never loads).  The
parent test writes the weights and batches of every case into an ``.npz``
and the jobs into a JSON list, and starts one process a rank:

    python tests/_torch_tp_worker.py --rank R --world N --store FILE \\
        --mesh D,M --jobs jobs.json --cases cases.npz --out DIR

Each job of this mesh (``mesh`` == [D, M]) runs in ``tp`` mode on a gloo
mesh of D x M CPU ranks, from the case's f32 weights:

- ``train``: two ``build_train_step`` steps (``remat``,
  ``microbatches``).
  Rank 0 writes the losses, grad norms and lrs, the gathered m after
  step 1 and master and parameters after step 2 into ``DIR/result.npz``;
  every rank writes into ``DIR/bytes-R.json`` the elements of each
  parameter leaf and of each leaf of m, v and master it holds before the
  steps and after each (``[local, full]``), and the step's
  ``gather_stats``.
- ``serve``: ``build_prefill_step`` (a cache of ``CACHE`` slots past the
  prompt, a vlm's patches counted) and ``STEPS`` greedy
  ``build_decode_step`` steps on its own ids (``sp_decode``): rank 0
  writes each step's gathered logits, the ids and the gathered cache
  after prefill and after the last step; every rank its ``gather_stats``.

With ``--ops`` (no ``--jobs``) the ranks instead run each operator of
``repro_torch/distributed/tensor_parallel.py`` on their blocks of the
inputs in ``cases.npz`` (``ops_rank``), forward and backward, each rank
writing what it got into ``DIR/ops-R.npz``; on a ("pod", "data",
"model") mesh (``--mesh P,D,M``) they all-reduce their ranks over
``DistContext.batch_group()`` and write the sum and the group's ranks
into ``DIR/group-R.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import _torch_serve_worker as serve_worker

SEQ, BATCH = 16, 4
TRAIN = {"learning_rate": 1e-4, "warmup_steps": 1, "total_steps": 4}
PROMPT, STEPS = 12, 4


def config(arch: str, replace: dict, get_config):
    """The reduced config of ``arch`` with ``replace`` (``get_config``
    from either package)."""
    return dataclasses.replace(get_config(arch, reduced=True), **replace)


def cache_len(cfg) -> int:
    """The serve jobs' cache: the prompt, a vlm's patches, the steps."""
    return PROMPT + STEPS + (cfg.num_patches if cfg.family == "vlm" else 0)


def _inputs(data, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: data[k] for k in data.files if k.startswith(prefix)}


def run_train(job, mesh, data, out: dict, nbytes: dict) -> None:
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.reducer import tree_flatten_with_path
    from repro_torch.distributed import (
        DistContext, build_train_step, distribute_tree, gather_tree,
        init_sharded_opt_state,
    )
    from repro_torch.models import LM

    def held(params, opt):
        rec = {"params": {p: [t.to_local().numel(), t.numel()]
                          for p, t in tree_flatten_with_path(params)}}
        for name in ("m", "v", "master"):
            rec[name] = {p: [t.to_local().numel(), t.numel()] for p, t in
                         tree_flatten_with_path(getattr(opt, name))}
        return rec

    key, src = job["key"], job["inputs"]
    cfg = config(job["arch"], job["replace"], get_config)
    lm = LM(cfg, max_seq=SEQ, device="cpu")
    ctx = DistContext.create(cfg, mesh, mode="tp")
    tc = TrainConfig(microbatches=job["microbatches"], remat=job["remat"],
                     **TRAIN)
    step_fn, (p_sh, o_sh, _) = build_train_step(
        lm, tc, ctx, ShapeConfig("t", "train", SEQ, BATCH))
    params = distribute_tree(lm.load_reference(serve_worker._tree(
        _inputs(data, f"{src}|params|"))), ctx, p_sh)
    opt = init_sharded_opt_state(ctx, params, o_sh)
    record = {"held": [held(params, opt)]}
    for s in range(2):
        params, opt, metrics = step_fn(params, opt,
                                       _inputs(data, f"{src}|batch{s}|"))
        record["held"].append(held(params, opt))
        for k in ("loss", "grad_norm", "lr"):
            out[f"{key}|{k}{s}"] = float(metrics[k])
        if s == 0:
            for p, t in tree_flatten_with_path(gather_tree(opt.m)):
                out[f"{key}|m1|{p}"] = t.numpy().copy()
            for p, sq in step_fn.grad_sq.items():
                out[f"{key}|grad_sq1|{p}"] = float(sq)
    record["gather_stats"] = dict(step_fn.gather_stats)
    nbytes[key] = record
    for name, tree in (("master2", opt.master), ("params2", params)):
        for p, t in tree_flatten_with_path(gather_tree(tree)):
            out[f"{key}|{name}|{p}"] = t.float().numpy()


def run_serve(job, mesh, data, out: dict, nbytes: dict) -> None:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import (
        DistContext, build_decode_step, build_prefill_step, distribute_tree,
    )
    from repro_torch.models import LM

    key, src = job["key"], job["inputs"]
    cfg = config(job["arch"], job["replace"], get_config)
    total = cache_len(cfg)
    lm = LM(cfg, max_seq=total, device="cpu")
    ctx = DistContext.create(cfg, mesh, mode="tp",
                             sp_decode=job["sp_decode"])
    pf, (p_sh, _, _, _) = build_prefill_step(
        lm, ctx, ShapeConfig("p", "prefill", PROMPT, BATCH), cache_len=total)
    df, _ = build_decode_step(lm, ctx, ShapeConfig("d", "decode", total,
                                                   BATCH))
    params = distribute_tree(lm.load_reference(serve_worker._tree(
        _inputs(data, f"{src}|params|"))), ctx, p_sh)

    def full_cache(cache):
        return {p: serve_worker._full(t) for p, t in serve_worker._flat(
            {k: v for k, v in cache.items() if k != "filled"}).items()}
    logits, cache = pf(params, _inputs(data, f"{src}|batch|"))
    stats = [dict(pf.gather_stats)]
    got = [serve_worker._full(logits)]
    out[f"{key}|cache0"] = full_cache(cache)
    ids = []
    tok = torch.from_numpy(got[-1]).argmax(dim=-1)[:, None]
    for _ in range(STEPS):
        ids.append(tok[:, 0].numpy().copy())
        logits, cache = df(params, cache, {"token": tok})
        stats.append(dict(df.gather_stats))
        got.append(serve_worker._full(logits))
        tok = torch.from_numpy(got[-1]).argmax(dim=-1)[:, None]
    out[f"{key}|logits"] = np.stack(got)
    out[f"{key}|ids"] = np.stack(ids, axis=1)
    out[f"{key}|cache1"] = full_cache(cache)
    nbytes[key] = stats


def ops_rank(data, rank: int, n: int, group) -> dict:
    """Each operator on this rank's blocks of the inputs (``n`` ranks of
    ``group``; ``group`` None: the one-rank run, the plain functions),
    with gradients of ``sum(out * c)`` and of the cross entropy."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models.layers import softmax_xent

    def block(a, dim):
        t = torch.from_numpy(a)
        k = t.shape[dim] // n
        return t.narrow(dim, rank * k, k).clone()

    def leaf(t):
        return t.clone().requires_grad_(True)
    out = {}
    x = leaf(torch.from_numpy(data["x"]))               # (B, S, d), whole
    w_col = leaf(block(data["w_col"], 1))               # (d, F) columns
    w_row = leaf(block(data["w_row"], 0))               # (F, d) rows
    y = tp.from_model(torch.tanh(tp.to_model(x, group) @ w_col) @ w_row,
                      group)
    (y * torch.from_numpy(data["c"])).sum().backward()
    out.update(mlp=y.detach(), mlp_gx=x.grad, mlp_gw_col=w_col.grad,
               mlp_gw_row=w_row.grad)
    h = leaf(block(data["heads"], 2))                   # (B, S, H, hd)
    g = tp.gather_model(h, 2, group)
    out.update(gather=g.detach())
    if group is not None:           # the serve paths' gather takes no grad
        try:
            (g * torch.from_numpy(data["c_heads"])).sum().backward()
            refused = False
        except RuntimeError as e:
            refused = "no-grad" in str(e)
        out.update(gather_refused=torch.tensor(refused))
    table = leaf(block(data["table"], 0))               # (Vp, d) rows
    e = tp.vocab_embed(table, torch.from_numpy(data["ids"]), group)
    (e * torch.from_numpy(data["c"])).sum().backward()
    out.update(embed=e.detach(), embed_gtable=table.grad)
    logits = leaf(block(data["logits"], 2))             # (B, S, Vp)
    labels, vocab = torch.from_numpy(data["labels"]), int(data["vocab_size"])
    loss = softmax_xent(logits, labels, vocab) if group is None else \
        tp.vocab_xent(logits, labels, vocab, group)
    loss.backward()
    out.update(xent=loss.detach(), xent_glogits=logits.grad)
    return {k: v.numpy() for k, v in out.items()}


def run_group_check(shape, rank: int) -> dict:
    """The batch group of a ("pod", "data", "model") mesh: this rank's sum
    of every rank of its group, the group's ranks, and whether a second
    call gives the same group."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.distributed import DistContext

    mesh = init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=("pod", "data", "model"))
    ctx = DistContext.create(get_config("yi-6b", reduced=True), mesh)
    group = ctx.batch_group()
    t = torch.tensor([float(rank)])
    dist.all_reduce(t, group=group)
    return {"sum": float(t), "ranks": dist.get_process_group_ranks(group),
            "rank_in_group": dist.get_rank(group),
            "same": ctx.batch_group() is group}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for name in ("--rank", "--world"):
        ap.add_argument(name, type=int, required=True)
    for name in ("--store", "--mesh", "--cases", "--out"):
        ap.add_argument(name, required=True)
    ap.add_argument("--jobs")
    ap.add_argument("--ops", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")

    from repro_torch.launch.mesh import make_dev_mesh

    dist.init_process_group("gloo", store=dist.FileStore(args.store,
                                                          args.world),
                            rank=args.rank, world_size=args.world)
    shape = [int(x) for x in args.mesh.split(",")]
    outdir = Path(args.out)
    if args.ops:
        if len(shape) == 3:
            (outdir / f"group-{args.rank}.json").write_text(json.dumps(
                run_group_check(shape, args.rank)))
        else:
            np.savez(outdir / f"ops-{args.rank}.npz", **ops_rank(
                np.load(args.cases), args.rank, args.world,
                dist.group.WORLD))
        dist.destroy_process_group()
        return 0
    mesh = make_dev_mesh(*shape, device="cpu")
    data = np.load(args.cases)
    jobs = [j for j in json.loads(Path(args.jobs).read_text())
            if j["mesh"] == shape]
    out: dict = {}
    nbytes: dict = {}
    for job in jobs:
        (run_train if job["kind"] == "train" else run_serve)(
            job, mesh, data, out, nbytes)
    (outdir / f"bytes-{args.rank}.json").write_text(json.dumps(nbytes))
    if args.rank == 0:
        flat = {}
        for k, v in out.items():
            if isinstance(v, dict):
                flat.update({f"{k}|{p}": x for p, x in v.items()})
            else:
                flat[k] = v
        np.savez(outdir / "result.npz", **flat)
    dist.destroy_process_group()
    if "jax" in sys.modules:
        raise AssertionError("the worker loaded jax")
    return 0


if __name__ == "__main__":
    sys.exit(main())
