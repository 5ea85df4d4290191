"""End-to-end training CLI on the port (the counterpart of
``repro/launch/train.py``, with the same flags, plus ``--device``,
``--dtype`` and ``--ckpt-codec``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch demo-100m \\
        --steps 20 --batch 8 --seq 128 [--reduced] [--ckpt-dir ckpts] \\
        [--resume] [--device cuda|cpu] [--dtype bfloat16|float32] \\
        [--ckpt-codec zstd|zlib|none]

``--device cuda`` (the default) raises without a card.  On a card the
forward and backward attention run through the hand-written flash kernels
(forward with its row log-sum-exp, then the backward kernel), and the SSD
and RG-LRU scans through their forward kernels and hand-written backward
kernels, so every family trains there; ``--device cpu`` runs every
kernel's plain PyTorch version (the scans' backward as plain formulas).  The weights start from ``LM.init(TrainConfig.seed)`` in
``--dtype`` (bf16, as the reference's ``lm.init``); ``--seed`` seeds the
data.  Each step takes ``TokenPipeline.train_batch(step)``, one
``LM.loss`` with its backward and one ``adamw_update``, and prints the
reference's line.  With ``--ckpt-dir`` the parameters and the optimizer
state are saved every ``--ckpt-every`` steps by ``Checkpointer(device=
--device)`` (every digest through the hash kernels on a card) as
``{"params": ..., "opt": opt._asdict()}``, the reference's layout, so
either package resumes the other's checkpoints (``--resume``).
``--ckpt-codec`` picks the chunks' codec (zstd, the reference's fixed
choice, by default; without the ``zstandard`` package zstd falls back to
zlib on one host core).  ``none`` lets ``chip_smoke.py`` save and restore
full demo-100m's 1.5 GB training state inside the smoke's time limit.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.reducer import tree_map_with_path
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.optim import OptState, adamw_update, init_opt_state

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def train_step(lm: LM, tc: TrainConfig, params, opt: OptState, batch: dict):
    """One loss, its gradients (autograd) and one AdamW update.  Returns
    (new params, new opt state, {"loss", "lr", "grad_norm"} as tensors)."""
    tree_map_with_path(lambda _, p: p.requires_grad_(True), params)
    loss, _ = lm.loss(params, batch)
    loss.backward()
    grads = tree_map_with_path(
        lambda _, p: torch.zeros_like(p) if p.grad is None else p.grad, params)
    opt, params, om = adamw_update(tc, opt, grads, params)
    return params, opt, {"loss": loss.detach(), **om}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="demo-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda = the hand-written kernels (default), cpu = "
                         "their plain PyTorch versions")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                    help="the parameters' dtype (bf16, as the reference's "
                         "lm.init)")
    ap.add_argument("--ckpt-codec", choices=["zstd", "zlib", "none"],
                    default="zstd",
                    help="the checkpoint's chunk codec (zstd, the "
                         "reference's default, falls back to zlib without "
                         "the zstandard package)")
    return ap.parse_args(argv)


def main(argv=None, *, params=None) -> list[dict]:
    """Run the CLI; returns one dict a step taken (step, loss, lr,
    grad_norm, seconds).  ``params``: initial weights as a tree in the
    reference's layout of numpy arrays (see :meth:`LM.load_reference`)
    instead of ``LM.init``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     schedule=cfg.schedule, microbatches=args.microbatches)
    lm = LM(cfg, max_seq=args.seq, device=dev)
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    pipe = TokenPipeline(cfg, shape, seed=args.seed)

    if params is None:
        params = lm.init(tc.seed, DTYPES[args.dtype])
    else:
        params = lm.load_reference(params)
    opt = init_opt_state(params)
    start = 0

    ck = (Checkpointer(args.ckpt_dir, codec=args.ckpt_codec, device=dev)
          if args.ckpt_dir else None)
    if ck and args.resume and ck.latest_step() is not None:
        restored, start = ck.restore({"params": params,
                                      "opt": opt._asdict()})
        params = lm.params = restored["params"]
        opt = OptState(**restored["opt"])
        print(f"resumed from step {start}")

    history = []
    for step in range(start, args.steps):
        batch = pipe.train_batch(step)
        t0 = time.perf_counter()
        params, opt, metrics = train_step(lm, tc, params, opt, batch)
        lm.params = params
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        history.append({"step": step, "loss": loss,
                        "lr": float(metrics["lr"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "seconds": dt})
        print(f"step {step:4d} loss {loss:.4f} lr {history[-1]['lr']:.2e} "
              f"gnorm {history[-1]['grad_norm']:.3f} {dt:.2f}s")
        if ck and (step + 1) % args.ckpt_every == 0:
            info = ck.save(step + 1, {"params": params, "opt": opt._asdict()})
            print(f"  ckpt@{step+1}: {info.nbytes/1e6:.1f} MB "
                  f"({info.n_leaves_written}/{info.n_leaves_total} leaves, "
                  f"{info.seconds:.2f}s)")
    print("done")
    return history


if __name__ == "__main__":
    main()
