"""Batched LM serving on the port: prefill a prompt batch, decode N greedy
tokens (the LM half of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --reduced \\
        --batch 4 --prompt-len 48 --gen 16 [--device cuda|cpu]

``--device cuda`` (the default) runs prefill attention, the SSD scan and
the RG-LRU scan through the hand-written CUDA kernels and raises without a
card; ``--device cpu`` runs their plain PyTorch versions.  The dense, ssm
and hybrid families are ported (e.g. ``--arch recurrentgemma-9b``); the
others (moe, encdec, vlm), and the reference's notebook-fleet and gateway
modes, are rejected with an error that names them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import LM


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(cfg, *, batch: int = 4, prompt_len: int = 48, gen: int = 16,
             seed: int = 0, device="cuda", dtype=torch.bfloat16,
             params=None) -> dict:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens from the seeded
    pipeline (the reference's prompts for the same seed), then decode
    ``gen`` greedy tokens; the argmax runs over ``padded_vocab``, pad
    columns included, as the reference's does.

    Weights: random from a ``torch.Generator`` seeded with ``seed`` in
    ``dtype``, or ``params``, a tree in the reference's layout of numpy
    arrays or CPU tensors (see :meth:`LM.load_reference`).

    Returns ``ids`` (batch, gen), the prefill logits and the last decode
    step's logits (f32 numpy), the wall times of prefill and decode (each
    ends in a device synchronise) and, on a card, the peak device memory
    of prefill and decode (the weights, the cache and the activations; the
    weight init's scratch is not counted)."""
    dev = resolve_device(device)
    total = prompt_len + gen
    lm = LM(cfg, max_seq=total, device=dev)
    shape = ShapeConfig("cli", "prefill", prompt_len, batch)
    prompt = TokenPipeline(cfg, shape, seed=seed).prefill_batch(0)["tokens"]
    tokens = torch.from_numpy(prompt).to(dev)
    if params is None:
        lm.init(seed, dtype)
    else:
        lm.load_reference(params)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    logits, cache = lm.prefill(tokens, cache_len=total)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    toks = []
    t0 = time.perf_counter()
    tok = logits.argmax(dim=-1)[:, None]
    for _ in range(gen):
        toks.append(tok)
        logits, cache = lm.decode_step(cache, tok)
        tok = logits.argmax(dim=-1)[:, None]
    _sync(dev)
    t_decode = time.perf_counter() - t0

    return {"ids": torch.cat(toks, dim=1).cpu().numpy(),
            "prompt": prompt,
            "prefill_logits": prefill_logits.float().cpu().numpy(),
            "last_logits": logits.float().cpu().numpy(),
            "prefill_seconds": t_prefill, "decode_seconds": t_decode,
            "decode_tokens_per_s": gen * batch / t_decode if gen else 0.0,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
            "device": str(dev)}


# options of the reference server that need modules not ported yet
_FLEET = "ROADMAP A7: the fleet and gateway layer"
_NOT_PORTED = ("--notebook-fleet", "--fleet-gpu-capacity",
               "--fleet-tpu-capacity", "--gateway", "--tenants", "--quota",
               "--warm-pool", "--max-sessions", "--stress", "--rate",
               "--replicas", "--race")


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported to repro_torch yet "
                     f"({_FLEET}); use python -m repro.launch.serve for it")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="demo-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda = the hand-written kernels (default), cpu = "
                         "their plain PyTorch versions")
    for flag in _NOT_PORTED:
        ap.add_argument(flag, nargs="?", action=_NotPorted,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    try:
        cfg = get_config(args.arch, reduced=args.reduced)
        LM(cfg, device="cpu")              # rejects an unported family
    except (KeyError, NotImplementedError) as e:
        ap.error(str(e))

    out = serve_lm(cfg, batch=args.batch, prompt_len=args.prompt_len,
                   gen=args.gen, seed=args.seed, device=args.device)
    ids = out["ids"]
    print(f"prefill {args.batch}x{args.prompt_len}: "
          f"{out['prefill_seconds']:.2f}s; decode {args.gen} tokens: "
          f"{out['decode_seconds']:.2f}s "
          f"({out['decode_tokens_per_s']:.1f} tok/s)")
    print("sample generated ids:", ids[0, :12].tolist())
    assert bool(np.all(ids >= 0)) and bool(np.all(ids < cfg.padded_vocab))
    print("ok")


if __name__ == "__main__":
    main()
