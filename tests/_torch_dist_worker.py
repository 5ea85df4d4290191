"""One rank of the gloo runs of ``tests/test_torch_distributed.py``.

Imports torch and the port only (it checks that jax never loads).  The
parent test writes the weights and batches of every case into an ``.npz``
and starts one process a rank:

    python tests/_torch_dist_worker.py --rank R --world N --store FILE \\
        --mesh D,M --mode tp|fsdp --remat none|dots|full \\
        --cases cases.npz --out DIR

Each case (a reduced config, a microbatch count) runs two
``build_train_step`` steps from the case's weights on a gloo mesh of D x M
CPU ranks.  Rank 0 writes every case's losses, grad norms and lrs, the
gathered m after step 1 and master and parameters after step 2 into
``DIR/result.npz``; every rank writes the bytes of its m, v and master
shards, leaf by leaf, into ``DIR/bytes-R.json``.  On a 1 x 1 mesh the
worker also runs ``launch/train.py``'s ``train_step`` (which has no
microbatches) from the same weights and requires the same bits of the
one-microbatch cases.
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

# (arch, microbatches), reduced configs; the moe config's capacity is cut
# so that routing the global tokens and routing each rank's drop different
# tokens
CASES = [(a, mb) for a in ("yi-6b", "mamba2-370m", "recurrentgemma-9b",
                           "qwen2-moe-a2.7b", "internvl2-2b", "whisper-tiny")
         for mb in (1, 2)]
MOE_CAPACITY_FACTOR = 0.5
SEQ, BATCH = 32, 8
TRAIN = {"learning_rate": 1e-4, "warmup_steps": 1, "total_steps": 4}


def case_key(arch: str, mb: int) -> str:
    return f"{arch}/mb{mb}"


def config(arch: str, get_config):
    """The reduced config of a case (``get_config`` from either package)."""
    cfg = get_config(arch, reduced=True)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=MOE_CAPACITY_FACTOR)
    return cfg


def _tree(flat: dict) -> dict:
    """{"['a']['b']": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for path, x in flat.items():
        keys = [k.strip("'") for k in path[1:-1].split("][")]
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = x
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for name in ("--rank", "--world"):
        ap.add_argument(name, type=int, required=True)
    for name in ("--store", "--mesh", "--mode", "--remat", "--cases",
                 "--out"):
        ap.add_argument(name, required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.reducer import tree_flatten_with_path
    from repro_torch.distributed import (
        DistContext, build_train_step, distribute_tree, gather_tree,
        init_sharded_opt_state,
    )
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.train import train_step
    from repro_torch.models import LM
    from repro_torch.optim import init_opt_state

    dist.init_process_group("gloo", store=dist.FileStore(args.store,
                                                          args.world),
                            rank=args.rank, world_size=args.world)
    n_data, n_model = (int(x) for x in args.mesh.split(","))
    mesh = make_dev_mesh(n_data, n_model, device="cpu")
    data = np.load(args.cases)
    out: dict = {}
    nbytes: dict = {}
    for arch, mb in CASES:
        key = case_key(arch, mb)
        cfg = config(arch, get_config)
        tc = TrainConfig(microbatches=mb, remat=args.remat, **TRAIN)
        lm = LM(cfg, max_seq=SEQ, device="cpu")
        ctx = DistContext.create(cfg, mesh, mode=args.mode)
        step_fn, (p_sh, o_sh, _) = build_train_step(
            lm, tc, ctx, ShapeConfig("t", "train", SEQ, BATCH))
        fields = {n: n.split("|", 2) for n in data.files}
        init = {f[2]: data[n] for n, f in fields.items()
                if f[:2] == [key, "params"]}
        batches = [{f[2]: data[n] for n, f in fields.items()
                    if f[:2] == [key, f"batch{s}"]} for s in range(2)]
        full = lm.load_reference(_tree(init))
        params = distribute_tree(full, ctx, p_sh)
        opt = init_sharded_opt_state(ctx, params, o_sh)
        nbytes[key] = {
            name: {p: [t.to_local().numel(), t.numel()] for p, t in
                   tree_flatten_with_path(getattr(opt, name))}
            for name in ("m", "v", "master")}
        for s in range(2):
            params, opt, metrics = step_fn(params, opt, batches[s])
            for k in ("loss", "grad_norm", "lr"):
                out[f"{key}|{k}{s}"] = float(metrics[k])
            if s == 0:
                for p, t in tree_flatten_with_path(gather_tree(opt.m)):
                    out[f"{key}|m1|{p}"] = t.numpy().copy()
        for name, tree in (("master2", opt.master), ("params2", params)):
            for p, t in tree_flatten_with_path(gather_tree(tree)):
                out[f"{key}|{name}|{p}"] = t.float().numpy()
        if mesh.size() == 1 and mb == 1:
            # the same two steps through the single-device train_step
            ref = lm.load_reference(_tree(init))
            ref_opt = init_opt_state(ref)
            for s in range(2):
                ref, ref_opt, m = train_step(lm, tc, ref, ref_opt, batches[s])
                if not (float(m["loss"]) == out[f"{key}|loss{s}"] and
                        float(m["grad_norm"]) == out[f"{key}|grad_norm{s}"]):
                    raise AssertionError(f"{key} step {s}: {m} against the "
                                         f"DTensor step's")
            mine = dict(tree_flatten_with_path(gather_tree(params)))
            for p, t in tree_flatten_with_path(ref):
                if not torch.equal(t, mine[p]):
                    raise AssertionError(f"{key} {p}: not the train_step's")
            out[f"{key}|same_bits_as_train_step"] = 1.0
    outdir = Path(args.out)
    with open(outdir / f"bytes-{args.rank}.json", "w") as f:
        json.dump(nbytes, f)
    if args.rank == 0:
        np.savez(outdir / "result.npz", **out)
    dist.destroy_process_group()
    if "jax" in sys.modules:
        raise AssertionError("the worker loaded jax")
    return 0


if __name__ == "__main__":
    sys.exit(main())
