#!/usr/bin/env python3
"""The bf16 floor of a moe model's routing on one NVIDIA card: how far
``LM``'s own top-K choices at bf16 lie from those of an f32 arm of the
same weights, in bf16 spacings of router logits.

    python3 tools/moe_route_floor.py [--arch qwen2-moe-a2.7b]

Full ``arch`` (weights from ``chip_smoke.SEED``), ``chip_smoke.py``'s
``dist_tp`` serve leg's batch, prompt and decode steps: a prefill and
greedy decode steps through ``LM`` at bf16, recording each moe layer's
top-K and f32 router logits; then the same weights widened to f32 in
place, leaf by leaf (TF32 off), driven by the bf16 run's ids, twice:

- ``free``: the f32 arm routes by its own top-K.  At each token routed
  differently, the gap is the largest over the K places of the bf16
  run's logits of its expert and of the f32 run's, in bf16 spacings at
  the larger magnitude of the two.
- ``forced``: the f32 arm takes the bf16 run's top-K wherever its own
  differs (``chip_smoke.FollowRoutes`` with no limit: what the
  ``dist_tp`` ranks do, so its residual stream stays on the bf16 run's
  routes), the gap measured as FollowRoutes measures it, in the
  follower's own logits.

Prints one JSON line: for each arm the number of token routings that
differ, their share of all routings, their gaps by count and the largest
gap of each call (24 a forward), beside the card's name and power limit.
``chip_smoke.ROUTE_TIE_ULPS`` and ``ROUTE_FLIP_SHARE`` are set from
both arms.  Needs a CUDA device and about 65 GB of its memory.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def gaps_in_spacings(logits, got, want):
    """The largest gap over the K places between the logits (T, E) of the
    experts ``got`` (T, K) and ``want`` (T, K), in bf16 spacings."""
    import torch
    lg, lw = logits.gather(1, got), logits.gather(1, want)
    exp = torch.frexp(torch.maximum(lg.abs(), lw.abs()))[1]
    return ((lg - lw).abs() / torch.ldexp(torch.ones_like(lg),
                                          exp - 8)).amax(dim=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("moe_route_floor: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.models import LM, moe

    cs.phase_build()
    leg = next(leg for leg in cs.TP_SERVE_LEGS if leg[0] == args.arch)
    _, batch, prompt, gen, _ = leg
    cfg = cs.serve_config(args.arch)
    total = prompt + gen
    tokens = torch.from_numpy(TokenPipeline(cfg, ShapeConfig(
        "floor", "prefill", prompt, batch), seed=cs.SEED).prefill_batch(0)[
            "tokens"]).cuda()
    lm = LM(cfg, max_seq=total, device="cuda")
    lm.init(cs.SEED, torch.bfloat16)
    real = moe._choose
    calls: list = []

    def recording(logits, cfg):
        probs, gate, idx = real(logits, cfg)
        calls.append((idx, logits))
        return probs, gate, idx

    def run(drive=None):
        logits, cache = lm.prefill(tokens, cache_len=total)
        ids = []
        for s in range(gen):
            ids.append(logits.argmax(dim=-1)[:, None] if drive is None
                       else drive[:, s:s + 1])
            logits, cache = lm.decode_step(cache, ids[-1])
        return torch.cat(ids, dim=1)

    def widen(tree):
        for k in list(tree):
            if isinstance(tree[k], dict):
                widen(tree[k])
            else:
                tree[k] = tree[k].float()

    moe._choose = recording
    try:
        with torch.no_grad():
            ids = run()
            bf16, calls = calls, []
            widen(lm.params)
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = False
            run(ids)
            free, calls = calls, []
    finally:
        moe._choose = real
    counts: dict = {}
    by_call: dict = {}
    differ = 0
    for c, ((got, logits), (want, _)) in enumerate(zip(bf16, free)):
        rows = (got != want).any(dim=1)
        if not bool(rows.any()):
            continue
        gaps = gaps_in_spacings(logits[rows], got[rows], want[rows])
        differ += int(rows.sum())
        by_call[c] = float(gaps.max())
        for u, n in zip(*(x.tolist() for x in torch.unique(
                gaps, return_counts=True))):
            counts[u] = counts.get(u, 0) + n
    routings = sum(int(idx.shape[0]) for idx, _ in bf16)
    del free
    with torch.no_grad(), cs.FollowRoutes(
            [idx.to(torch.uint8).cpu() for idx, _ in bf16],
            limit=math.inf) as follow:
        run(ids)
    taken = sum(follow.flips["ulps"].values())
    print(json.dumps({
        "arch": args.arch, "batch": batch, "prompt_len": prompt,
        "gen": gen, "card": cs.card_line(), "calls": len(bf16),
        "routings": routings,
        "free": {
            "routings_differing": differ, "share": differ / routings,
            "gap_spacings": {str(u): n for u, n in sorted(counts.items())},
            "max_gap_spacings": max(by_call.values(), default=0.0),
            "max_gap_by_call": by_call},
        "forced": {
            "routings_differing": taken, "share": taken / follow.routings,
            "gap_spacings": {str(u): n for u, n in sorted(
                follow.flips["ulps"].items())},
            "max_gap_spacings": max(follow.flips["max_by_call"].values(),
                                    default=0.0),
            "max_gap_by_call": follow.flips["max_by_call"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
