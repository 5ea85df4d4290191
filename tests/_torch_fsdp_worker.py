"""One rank of the gloo runs of ``tests/test_torch_fsdp.py``.

Imports torch and the port only (it checks that jax never loads).  The
parent test writes the weights and batches of every case into an ``.npz``
and starts one process a rank:

    python tests/_torch_fsdp_worker.py --rank R --world N --store FILE \\
        --mesh D,M --cases cases.npz --out DIR [--serve]

Each train case (a config of ``ARCHS``, a microbatch count) runs, under
each remat of ``REMATS``, two ``build_train_step`` steps in ``fsdp`` from
the case's weights on a gloo mesh of D x M CPU ranks.  Rank 0 writes the
losses, grad norms and lrs, the gathered m after step 1 and master and
parameters after step 2 into ``DIR/result.npz``.  Every rank writes into
``DIR/bytes-R.json``, for every case and remat: the elements of each
parameter leaf it holds before each step and after the last (its shard,
``[local, full]``), and the step function's ``gather_stats`` (the
gathered bytes' high-water mark, the largest unit's bytes, the full
gradients of stacked leaves found alive after their unit).  With
``--serve`` it also runs ``build_prefill_step`` and ``STEPS`` greedy
``build_decode_step`` steps in ``fsdp`` (``sp_decode=False``) for every
config of ``ARCHS``: rank 0 writes logits, ids and caches into
``DIR/serve.npz``, every rank its serve ``gather_stats`` into
``DIR/serve-bytes-R.json``.
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

# reduced configs cut so that each kind of placement shows: yi-6b's
# 4 layers split the layers axis at 2 and 4 ranks; recurrentgemma-9b's
# 5 layers are one group and a tail of two, width-split; whisper-tiny's
# encoder (2 layers) and decoder (3) stacks
ARCHS = {"yi-6b": {"num_layers": 4},
         "recurrentgemma-9b": {"num_layers": 5},
         "whisper-tiny": {}}
MICRO = (1, 2)
REMATS = ("none", "full")
SEQ, BATCH = 32, 8
TRAIN = {"learning_rate": 1e-4, "warmup_steps": 1, "total_steps": 4}
PROMPT, STEPS, SERVE_BATCH = serve_worker.PROMPT, serve_worker.STEPS, \
    serve_worker.BATCH
CACHE = PROMPT + STEPS


def config(arch: str, get_config):
    """The cut reduced config of ``arch`` (``get_config`` from either
    package)."""
    return dataclasses.replace(get_config(arch, reduced=True), **ARCHS[arch])


def case_key(arch: str, mb: int) -> str:
    return f"{arch}/mb{mb}"


def run_train(mesh, data, out: dict, nbytes: dict) -> None:
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.reducer import tree_flatten_with_path
    from repro_torch.distributed import (
        DistContext, build_train_step, distribute_tree, gather_tree,
        init_sharded_opt_state,
    )
    from repro_torch.models import LM

    fields = {n: n.split("|", 2) for n in data.files}

    def held(params):
        return {p: [t.to_local().numel(), t.numel()]
                for p, t in tree_flatten_with_path(params)}
    for arch in ARCHS:
        cfg = config(arch, get_config)
        lm = LM(cfg, max_seq=SEQ, device="cpu")
        ctx = DistContext.create(cfg, mesh, mode="fsdp")
        for mb in MICRO:
            case = case_key(arch, mb)
            init = {f[2]: data[n] for n, f in fields.items()
                    if f[:2] == [case, "params"]}
            batches = [{f[2]: data[n] for n, f in fields.items()
                        if f[:2] == [case, f"batch{s}"]} for s in range(2)]
            for remat in REMATS:
                key = f"{case}/{remat}"
                tc = TrainConfig(microbatches=mb, remat=remat, **TRAIN)
                step_fn, (p_sh, o_sh, _) = build_train_step(
                    lm, tc, ctx, ShapeConfig("t", "train", SEQ, BATCH))
                params = distribute_tree(
                    lm.load_reference(serve_worker._tree(init)), ctx, p_sh)
                opt = init_sharded_opt_state(ctx, params, o_sh)
                record = {"held": [held(params)]}
                for s in range(2):
                    params, opt, metrics = step_fn(params, opt, batches[s])
                    record["held"].append(held(params))
                    for k in ("loss", "grad_norm", "lr"):
                        out[f"{key}|{k}{s}"] = float(metrics[k])
                    if s == 0:
                        for p, t in tree_flatten_with_path(
                                gather_tree(opt.m)):
                            out[f"{key}|m1|{p}"] = t.numpy().copy()
                record["gather_stats"] = dict(step_fn.gather_stats)
                nbytes[key] = record
                for name, tree in (("master2", opt.master),
                                   ("params2", params)):
                    for p, t in tree_flatten_with_path(gather_tree(tree)):
                        out[f"{key}|{name}|{p}"] = t.float().numpy()


def run_serve(mesh, data, out: dict, nbytes: dict) -> None:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import (
        DistContext, build_decode_step, build_prefill_step, distribute_tree,
    )
    from repro_torch.models import LM

    fields = {n: n.split("|", 2) for n in data.files}
    for arch in ARCHS:
        cfg = config(arch, get_config)
        lm = LM(cfg, max_seq=CACHE, device="cpu")
        ctx = DistContext.create(cfg, mesh, mode="fsdp", sp_decode=False)
        pf, (p_sh, _, _, _) = build_prefill_step(
            lm, ctx, ShapeConfig("p", "prefill", PROMPT, SERVE_BATCH),
            cache_len=CACHE)
        df, _ = build_decode_step(
            lm, ctx, ShapeConfig("d", "decode", CACHE, SERVE_BATCH))
        weights = {f[2]: data[n] for n, f in fields.items()
                   if f[:2] == [f"serve/{arch}", "params"]}
        batch = {f[2]: data[n] for n, f in fields.items()
                 if f[:2] == [f"serve/{arch}", "batch"]}
        params = distribute_tree(lm.load_reference(serve_worker._tree(weights)),
                                 ctx, p_sh)
        logits, cache = pf(params, batch)
        stats = [dict(pf.gather_stats)]
        got = [serve_worker._full(logits)]
        out[f"{arch}|cache0"] = {p: serve_worker._full(t) for p, t in
                                 serve_worker._flat({k: v for k, v in
                                                     cache.items()
                                                     if k != "filled"}
                                                    ).items()}
        ids = []
        tok = torch.from_numpy(got[-1]).argmax(dim=-1)[:, None]
        for _ in range(STEPS):
            ids.append(tok[:, 0].numpy().copy())
            logits, cache = df(params, cache, {"token": tok})
            stats.append(dict(df.gather_stats))
            got.append(serve_worker._full(logits))
            tok = torch.from_numpy(got[-1]).argmax(dim=-1)[:, None]
        out[f"{arch}|logits"] = np.stack(got)
        out[f"{arch}|ids"] = np.stack(ids, axis=1)
        out[f"{arch}|cache1"] = {p: serve_worker._full(t) for p, t in
                                 serve_worker._flat({k: v for k, v in
                                                     cache.items()
                                                     if k != "filled"}
                                                    ).items()}
        nbytes[arch] = stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for name in ("--rank", "--world"):
        ap.add_argument(name, type=int, required=True)
    for name in ("--store", "--mesh", "--cases", "--out"):
        ap.add_argument(name, required=True)
    ap.add_argument("--serve", action="store_true")
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
    nbytes: dict = {}
    run_train(mesh, data, out, nbytes)
    (outdir / f"bytes-{args.rank}.json").write_text(json.dumps(nbytes))
    if args.rank == 0:
        np.savez(outdir / "result.npz", **out)
    if args.serve:
        out, nbytes = {}, {}
        run_serve(mesh, data, out, nbytes)
        (outdir / f"serve-bytes-{args.rank}.json").write_text(
            json.dumps(nbytes))
        if args.rank == 0:
            flat = {}
            for k, v in out.items():
                if isinstance(v, dict):
                    flat.update({f"{k}|{p}": x for p, x in v.items()})
                else:
                    flat[k] = v
            np.savez(outdir / "serve.npz", **flat)
    dist.destroy_process_group()
    if "jax" in sys.modules:
        raise AssertionError("the worker loaded jax")
    return 0


if __name__ == "__main__":
    sys.exit(main())
