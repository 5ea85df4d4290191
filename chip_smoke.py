#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase; last line {"ok": true, ...}
    python3 chip_smoke.py --kernels-only  # card, build and kernel checks only

Phases, each printing one JSON line:

1. card:    the card's name and power limit as nvidia-smi reports them;
2. build:   ``nvcc`` builds every CUDA kernel from ``src/repro_torch/kernels/csrc``,
            one process per source, all at once;
3. kernels: the state-plane kernels against their plain PyTorch versions on
            the card, at the shapes the main path gives them plus ragged,
            u8/u32, f32/bf16 and NaN/inf cases; bit-identical results (scales
            within rtol 1e-6) and CUDA-event times beside the plain version
            and the card's bound.  The hash kernels (hash, compare and the
            fused per-leaf fold, both element types) also at their
            persistent grid's edges (1 row, just below, at and above the
            grid's warp count, ranges ragged against the four-row u8
            stages) and the fold on ragged manifests (an empty leaf between
            two others, one leaf of 32,768 rows, 2,000 one-row leaves);
            timed u8 at the chunk-key shape and u32 at the digest shape,
            with each launch's device time from torch.profiler;
4. lm_kernels: flash_attention, ssd_scan and rglru_scan against their plain
            versions (TF32 off for the f32 products), at the serve path's
            shapes (flash at yi-6b's hd 128 and recurrentgemma's hd 256), the
            CPU tests' shapes, ragged ones and the tensor-core routes' edges
            (S under one tile, full attention, H/KV 2 and 16; one chunk,
            Q = 100, H not a multiple of the 8-head block), f32 within 2e-5
            (flash), 5e-4 (SSD) and 1e-5 (RG-LRU), bf16 outputs within about
            two bf16 ulps
            (flash atol = rtol = 8e-3; SSD and RG-LRU atol 1e-3, rtol 1.6e-2;
            the plain versions computing in f32 from the bf16 values, as the
            kernels do; the SSD state is f32 and held at 5e-4; flash's error
            against the bf16 plain version, which rounds its scores, is
            reported beside it); the SSD kernel refuses tiles above a
            block's shared memory; times beside the plain version, the bound
            and, for flash, PyTorch's scaled_dot_product_attention as a
            yardstick the port never calls (in bf16, and in f32 with TF32
            off beside the f32 route); flash and SSD are timed on their
            bf16 (tensor-core) route and on the f32 (CUDA-core) route at the
            same shape, with each launch's device time from torch.profiler;
5. session: the state-migration path through
            ``repro_torch.launch.notebook.run_notebook`` on the card, two
            sessions under the paper's single-cell policy (the first runs
            locally and gives the analyzer its history): a
            Spacenet7-shaped notebook at the paper's 1024x1024x3 tile size (full state >= 1 GiB, most of it CUDA tensors from a seeded
            torch.Generator, the rest ragged numpy leaves), a forward migration of
            the reduced set, a re-migration after a one-element in-place change,
            the return trip, and one quant8+zstd migration of a 64 MiB f32 leaf.
            Every state-plane kernel's launch count must rise in this window
            (the hash kernels' counts are also split by element type), and
            every batched digest call must make exactly one device->host
            transfer; one batched digest call of the session's leaves, traced
            with torch.profiler, must launch exactly one hash kernel;
6. agree:   a small notebook through the same runtime on the card and on the CPU
            (the plain versions, which the CPU tests hold to the JAX reference):
            decisions, modeled seconds and bytes must be equal;
7. serve:   the LM serving path through ``repro_torch.launch.serve.serve_lm`` at
            full yi-6b (batch 4, prompt 2048), full mamba2-370m (batch 8,
            prompt 2000) and full recurrentgemma-9b (batch 4, prompt 2048,
            its local window), seeded bf16 weights, 32 greedy tokens each;
            one prefill must launch flash_attention 32 times (yi-6b),
            ssd_scan 48 times (mamba2), rglru_scan 26 and flash_attention 12
            times (recurrentgemma), once per layer; every id must lie in [0,
            padded_vocab); prints prefill seconds, decode tokens/s and the
            peak memory of prefill and decode;
8. serve_agree: the reduced yi-6b, mamba2-370m and recurrentgemma-9b
            (prompts 48, full causal attention through flash, and 64, banded
            attention) in f32 on the card and on the CPU with the same
            weights: logits within 1e-4 (dense, hybrid) and 1e-3 (mamba2),
            equal greedy ids.

Then the ``kernels`` line, and last ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense

SEED = 7
N_SCENES = 60                      # 1024x1024x3 uint8 mosaics on the card
N_KEEP = 32                        # filtered scenes whose edge maps migrate
TILE = 1024
FIELD_ELEMS = 16 << 20             # the quant8 leaf: 64 MiB of f32
CHUNK = 1 << 18
REPS = 20                          # timed launches per kernel (median)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ----------------------------------------------------------------------
# the main path's notebooks
# ----------------------------------------------------------------------

SETUP = f"""
import numpy as np
import torch
g = torch.Generator(device="cuda").manual_seed({SEED})
rng = np.random.default_rng({SEED})
# {N_SCENES} mosaics of {TILE}x{TILE}x3 uint8 ("images from 30 regions")
scenes = [torch.randint(0, 255, ({TILE}, {TILE}, 3), generator=g,
                        device="cuda", dtype=torch.uint8)
          for _ in range({N_SCENES})]
# normalized float copies (pipeline intermediates; never needed again)
normalized = [s.float() / 255.0 for s in scenes]
# ragged per-scene footprint rasters, kept on the host
footprints = [rng.random(int(n), dtype=np.float32)
              for n in rng.integers(1 << 20, 3 << 20, {N_SCENES})]
histograms = [torch.histc(s.float(), bins=64, min=0, max=255).cpu().numpy()
              for s in scenes]
dists = np.array([np.abs(np.cumsum(a) - np.cumsum(b)).sum()
                  for a, b in zip(histograms, histograms[1:])], np.float64)
keep_idx = sorted(int(i) for i in np.argsort(dists)[-{N_KEEP}:])
filtered = [normalized[i] for i in keep_idx]
def sobel(img):
    gray = img.mean(dim=-1)
    gx = torch.zeros_like(gray); gy = torch.zeros_like(gray)
    gx[1:-1] = gray[2:] - gray[:-2]
    gy[:, 1:-1] = gray[:, 2:] - gray[:, :-2]
    return torch.sqrt(gx ** 2 + gy ** 2)
edges = [sobel(f) for f in filtered]
k_clusters = 4
del g
"""

# the compute-intensive cell the analyzer sends remote (K-Means); migrated
# arrays arrive as host arrays, so the cell moves them onto the card itself
KMEANS = """
centroids_out = []
for img in edges:
    flat = torch.as_tensor(img, device="cuda").reshape(-1)
    cent = torch.linspace(float(flat.min()), float(flat.max()), k_clusters,
                          device="cuda")
    for _ in range(5):
        assign = (flat[None, :] - cent[:, None]).abs().argmin(dim=0)
        for c in range(k_clusters):
            sel = flat[assign == c]
            if sel.numel():
                cent[c] = sel.mean()
    centroids_out.append(cent.cpu().numpy())
"""

TWEAK = "edges[0][0, 0] += 1.0\n"
REPORT = "summary = float(np.mean([c.mean() for c in centroids_out]))\n"

QUANT_SETUP = f"""
import numpy as np
import torch
g = torch.Generator(device="cuda").manual_seed({SEED + 1})
field = torch.randn({FIELD_ELEMS}, generator=g, device="cuda")
del g
"""
QUANT_HEAVY = """
field_std = float(torch.as_tensor(field, device="cuda").std())
"""
QUANT_REPORT = "out = field_std * 2.0\n"


def ipynb(name: str, cells) -> dict:
    return {"nbformat": 4, "nbformat_minor": 5, "metadata": {"name": name},
            "cells": [{"id": f"c{i}", "cell_type": "code",
                       "metadata": {"repro": {"cost": cost}}, "source": src}
                      for i, (src, cost) in enumerate(cells)]}


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------

def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_kernels_ms(fn, reps: int = 10) -> dict:
    """Device time per call of each CUDA kernel that ``fn`` launches, from a
    ``torch.profiler`` trace of ``reps`` calls after one warm-up (empty if
    the profiler records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():   # the profiler's note on clearing events
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            name = ev.key.replace("(anonymous namespace)::", "").removeprefix(
                "void ").split("(")[0].split("<")[0].split("::")[-1]
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def bound(nbytes: int, ops: int,
          ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def phase_card() -> None:
    import torch
    line = card_line()
    print(line, flush=True)
    emit({"phase": "card", "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    seconds = time.perf_counter() - t0
    for name in _build.SIGNATURES:
        _build.load(name)
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "entry function" in ln]
             for n, log in reports.items()}
    emit({"phase": "build", "seconds": seconds, "built": sorted(reports),
          "ptxas": ptxas})


def phase_kernels() -> list[dict]:
    """Each kernel against its plain version on the card; returns the rows
    of the ``kernels`` line (launches filled in later)."""
    import torch
    t_phase = time.perf_counter()
    reps = REPS

    from repro_torch.kernels.hash_delta import kernel as hk
    from repro_torch.kernels.hash_delta import ops as hops
    from repro_torch.kernels.hash_delta.ref import (
        block_hash_compare_ref, block_hash_fold_ref, block_hash_ref,
    )
    from repro_torch.kernels.quant_blockwise import kernel as qk
    from repro_torch.kernels.quant_blockwise.ref import (
        dequantize_ref, quantize_ref,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    w = hops.weights(dev)

    def rand_rows(nb, dtype):
        if dtype == torch.uint8:
            return torch.randint(0, 256, (nb, 1024), generator=g, device=dev,
                                 dtype=torch.uint8)
        return torch.randint(-2**31, 2**31 - 1, (nb, 1024), generator=g,
                             device=dev, dtype=torch.int32)

    def same_int(a, b) -> int:
        if not torch.equal(a, b):
            diff = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
            raise AssertionError(f"kernel and plain version differ "
                                 f"(max abs {int(diff)})")
        return 0

    # main-path shapes: the reduced set's digest grid (N_KEEP edge maps of
    # 1024x1024 f32 = 1024 rows each), its chunk-key byte grid (4 MiB =
    # 4096 rows each) and the 64 MiB quant8 leaf; then ragged extras
    main_u32 = N_KEEP * TILE * TILE // 1024
    main_u8 = N_KEEP * TILE * TILE * 4 // 1024
    main_q = FIELD_ELEMS // 1024
    rows = []

    # -- the persistent grid's edges -----------------------------------------
    # each warp hashes one contiguous range of rows: nb below, at and above
    # the grid's warp count W, and ranges ragged against the u8 route's
    # four-row stages (4W + 3); both element types
    def edge_nbs(name, dtype):
        W = hk.grid_warps(name, dtype, dev)
        return W, (1, W - 1, W, W + 1, 2 * W + 1, 4 * W + 3)

    def route_of(dtype) -> str:
        return "u8" if dtype == torch.uint8 else "u32"

    def timed(fn, nbytes, ops, shape):
        """CUDA-event time, device time per kernel and bound of one launch."""
        ms = time_ms(fn, reps)
        b, by = bound(nbytes, ops)
        return {"ms": ms, "device_kernels_ms": device_kernels_ms(fn),
                "bound_ms": b, "bound_by": by, "timed_shape": shape}

    grids = {}

    # -- block_hash: u32 and u8 rows ------------------------------------
    errs, shapes = 0, []
    for dtype, main in ((torch.int32, main_u32), (torch.uint8, main_u8)):
        W, edges = edge_nbs("block_hash", dtype)
        grids[f"block_hash/{route_of(dtype)}"] = W
        for nb in (main, 9, 1025) + edges:
            x = rand_rows(nb, dtype)
            errs = max(errs, same_int(hk.block_hash_kernel(x, w),
                                      block_hash_ref(x, w)))
            shapes.append([nb, 1024, str(dtype).removeprefix("torch.")])
    x = rand_rows(main_u8, torch.uint8)     # timed at the chunk-key shape
    u8 = timed(lambda: hk.block_hash_kernel(x, w),
               x.numel() + w.numel() * 4 + main_u8 * 8, x.numel() * 9,
               [main_u8, 1024, "uint8"])
    plain_ms = time_ms(lambda: block_hash_ref(x, w), max(2, reps // 10))
    x = rand_rows(main_u32, torch.int32)    # and at the digest shape
    u32 = timed(lambda: hk.block_hash_kernel(x, w),
                x.numel() * 4 + w.numel() * 4 + main_u32 * 8, x.numel() * 9,
                [main_u32, 1024, "int32"])
    rows.append({"name": "block_hash", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/hash_delta.cu",
                 "replaces": "src/repro/kernels/hash_delta/kernel.py:42",
                 "launches": 0, "max_abs_err": errs, **u8,
                 "plain_ms": plain_ms, "library_ms": None, "u32": u32,
                 "checked_shapes": shapes})

    # -- block_hash_compare ----------------------------------------------
    errs, shapes = 0, []
    for dtype, main in ((torch.uint8, main_u8), (torch.int32, main_u32)):
        W, edges = edge_nbs("block_hash_compare", dtype)
        grids[f"block_hash_compare/{route_of(dtype)}"] = W
        for nb in (main, 9) + edges:
            x = rand_rows(nb, dtype)
            prior = block_hash_ref(x, w).clone()
            prior[nb // 2, 0] += 1                      # one block differs
            has = torch.ones((nb, 1), dtype=torch.int32, device=dev)
            has[-1, 0] = 0                              # one block is new
            hk_, ck = hk.block_hash_compare_kernel(x, w, prior, has)
            hr, cr = block_hash_compare_ref(x, w, prior, has)
            errs = max(errs, same_int(hk_, hr), same_int(ck, cr))
            if nb > 2 and int(ck.sum()) != 2:
                raise AssertionError("compare flagged the wrong rows")
            shapes.append([nb, 1024, str(dtype).removeprefix("torch.")])

    def compare_timed(nb, dtype):
        x = rand_rows(nb, dtype)
        prior = block_hash_ref(x, w)
        has = torch.ones((nb, 1), dtype=torch.int32, device=dev)
        t = timed(lambda: hk.block_hash_compare_kernel(x, w, prior, has),
                  x.numel() * x.element_size() + w.numel() * 4
                  + nb * (8 + 4 + 8 + 4), x.numel() * 9 + nb * 3,
                  [nb, 1024, str(dtype).removeprefix("torch.")])
        return t, x, prior, has

    u32, *_ = compare_timed(main_u32, torch.int32)
    u8, x, prior, has = compare_timed(main_u8, torch.uint8)
    plain_ms = time_ms(lambda: block_hash_compare_ref(x, w, prior, has),
                       max(2, reps // 10))
    rows.append({"name": "block_hash_compare", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/hash_delta.cu",
                 "replaces": "src/repro/kernels/hash_delta/kernel.py:69",
                 "launches": 0, "max_abs_err": errs, **u8,
                 "plain_ms": plain_ms, "library_ms": None, "u32": u32,
                 "checked_shapes": shapes})

    # -- block_hash_fold: the hash and the per-leaf fold in one launch ----
    def fold_inputs(nbs):
        fw = torch.from_numpy(hops._fold_weights(nbs)).to(dev)
        return fw[0, :sum(nbs)], fw[1, :sum(nbs)]

    def manifests(W):
        return {
            "digest": [main_u32 // N_KEEP] * N_KEEP,  # the edge maps
            "empty_between": [5, 0, 7],
            "one_leaf": [main_u32],             # one leaf over 32,768 rows
            "one_row_leaves": [1] * 2000,
            "ragged": [1, 0, W - 2, 3, 0, 0, W + 5, 4],
            "below_grid": [1] * (W - 1),
            "grid_plus_one": [W // 2, W // 2 + 1 + W % 2],
        }

    errs, shapes = 0, []
    for dtype in (torch.int32, torch.uint8):
        W, _ = edge_nbs("block_hash_fold", dtype)
        grids[f"block_hash_fold/{route_of(dtype)}"] = W
        for label, nbs in manifests(W).items():
            x = rand_rows(sum(nbs), dtype)
            idx, seg = fold_inputs(nbs)
            got = hk.block_hash_fold_kernel(x, w, idx, seg, len(nbs))
            errs = max(errs, same_int(
                got, block_hash_fold_ref(x, w, idx, seg, len(nbs))))
            shapes.append([label, len(nbs), sum(nbs),
                           str(dtype).removeprefix("torch.")])

    def fold_timed(nbs, dtype):
        x = rand_rows(sum(nbs), dtype)
        idx, seg = fold_inputs(nbs)
        nb = sum(nbs)
        t = timed(lambda: hk.block_hash_fold_kernel(x, w, idx, seg, len(nbs)),
                  x.numel() * x.element_size() + w.numel() * 4 + nb * 8
                  + len(nbs) * 8, x.numel() * 9 + nb * 4,
                  [nb, 1024, str(dtype).removeprefix("torch."), len(nbs)])
        return t, x, idx, seg

    # u32 at the digest shape (the reduced set's 32 leaves), u8 at the
    # chunk-key shape in 32 leaves; the plain hash on the same u32 grid
    u8, *_ = fold_timed([main_u8 // N_KEEP] * N_KEEP, torch.uint8)
    nbs = [main_u32 // N_KEEP] * N_KEEP
    u32, x, idx, seg = fold_timed(nbs, torch.int32)
    hash_same_grid_ms = time_ms(lambda: hk.block_hash_kernel(x, w), reps)
    plain_ms = time_ms(lambda: block_hash_fold_ref(x, w, idx, seg, len(nbs)),
                       max(2, reps // 10))
    rows.append({"name": "block_hash_fold", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/hash_delta.cu",
                 "replaces": "src/repro/kernels/hash_delta/kernel.py:42",
                 "also_replaces": "src/repro/kernels/hash_delta/ops.py:319 "
                                  "(_batched_lanes: segment_sum)",
                 "launches": 0, "max_abs_err": errs, **u32,
                 "plain_ms": plain_ms, "library_ms": None,
                 "block_hash_same_grid_ms": hash_same_grid_ms, "u8": u8,
                 "checked_shapes": shapes})

    # -- quantize / dequantize ---------------------------------------------
    qerr, derr, shapes = 0.0, 0.0, []

    def check_quant(x2d):
        nonlocal qerr, derr
        q, s = qk.quantize_kernel(x2d)
        qr, sr = quantize_ref(x2d)
        same_int(q, qr)
        torch.testing.assert_close(s, sr, rtol=1e-6, atol=0)
        qerr = max(qerr, float((s - sr).abs().max()))
        for dt in (torch.float32, torch.bfloat16):
            y = qk.dequantize_kernel(q, s, dt)
            yr = dequantize_ref(q, s, dt)
            # equal values; a NaN (0 * inf from an inf block) matches a NaN
            torch.testing.assert_close(y, yr, rtol=0, atol=0, equal_nan=True)
            finite = torch.isfinite(yr)
            derr = max(derr, float((y[finite].float()
                                    - yr[finite].float()).abs().max()))
        shapes.append([x2d.shape[0], 1024, str(x2d.dtype).removeprefix("torch.")])

    xq = torch.randn((main_q, 1024), generator=g, device=dev)
    check_quant(xq)
    special = torch.randn((9, 1024), generator=g, device=dev) * 3
    special[3] = special[3].round()                # exact ties at scale 1
    special[0, 5] = float("nan")
    special[1, 7] = float("inf")
    special[2, 9] = float("-inf")
    special[4] = 0.0                               # amax 0 -> scale 1
    for x2d in (special, special.to(torch.bfloat16),
                xq[:1025].to(torch.bfloat16)):
        check_quant(x2d.contiguous())
    ms = time_ms(lambda: qk.quantize_kernel(xq), reps)
    plain_ms = time_ms(lambda: quantize_ref(xq), max(2, reps // 10))
    b, by = bound(xq.numel() * (4 + 1) + main_q * 4, xq.numel() * 6)
    rows.append({"name": "quantize", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/quant_blockwise.cu",
                 "replaces": "src/repro/kernels/quant_blockwise/kernel.py:27",
                 "launches": 0, "max_abs_err": qerr, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                 "library_ms": None, "timed_shape": [main_q, 1024, "float32"],
                 "checked_shapes": shapes})
    q, s = qk.quantize_kernel(xq)
    ms = time_ms(lambda: qk.dequantize_kernel(q, s, torch.float32), reps)
    plain_ms = time_ms(lambda: dequantize_ref(q, s, torch.float32),
                       max(2, reps // 10))
    b, by = bound(q.numel() * (1 + 4) + main_q * 4, q.numel())
    rows.append({"name": "dequantize", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/quant_blockwise.cu",
                 "replaces": "src/repro/kernels/quant_blockwise/kernel.py:42",
                 "launches": 0, "max_abs_err": derr, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                 "library_ms": None, "timed_shape": [main_q, 1024, "float32"],
                 "checked_shapes": shapes})
    torch.cuda.synchronize()
    emit({"phase": "kernels", "checked": [r["name"] for r in rows],
          "bit_identical": True, "scale_rtol": 1e-6, "hash_grid_warps": grids,
          "seconds": time.perf_counter() - t_phase})
    return rows


# the LM serving path: full configs at these batch and prompt sizes
YI_BATCH, YI_PROMPT = 4, 2048
MAMBA_BATCH, MAMBA_PROMPT = 8, 2000    # pads to 8 chunks of 256
GEN = 32
REDUCED_BATCH, REDUCED_PROMPT = 4, 48  # the CPU tests' serve size
# (atol, rtol).  bf16: about two bf16 ulps (2**-7 relative) around the
# measured one-ulp rounding differences; SSD's atol covers f32 summation
# order where y cancels to near zero.
TOL = {("flash_attention", "float32"): (2e-5, 2e-5),
       ("flash_attention", "bfloat16"): (8e-3, 8e-3),
       ("ssd_scan", "float32"): (5e-4, 5e-4),
       ("ssd_scan", "bfloat16"): (1e-3, 1.6e-2),
       ("rglru_scan", "float32"): (1e-5, 1e-5),
       ("rglru_scan", "bfloat16"): (1e-3, 1.6e-2)}
RG_BATCH, RG_PROMPT = 4, 2048          # recurrentgemma-9b: the local window


def phase_lm_kernels() -> list[dict]:
    """flash_attention, ssd_scan and rglru_scan against their plain versions
    on the card, at the serve path's shapes, the CPU tests' shapes and ragged
    ones; returns their rows of the ``kernels`` line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rg_lru import kernel as rk
    from repro_torch.kernels.rg_lru.ref import rglru_scan_ref
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ops import arrange
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    t_phase = time.perf_counter()
    # f32 products in full f32 in the plain versions (matmul and cuDNN)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {k: 0.0 for k in TOL}

    def check(name, got, want, dtype):
        key = (name, str(dtype).removeprefix("torch."))
        atol, rtol = TOL[key]
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        err = float((got.float() - want.float()).abs().max())
        errs[key] = max(errs[key], err)
        return err

    def randn(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # -- flash attention -------------------------------------------------
    yi, yr = get_config("yi-6b"), get_config("yi-6b", reduced=True)
    rg, rgr = (get_config("recurrentgemma-9b"),
               get_config("recurrentgemma-9b", reduced=True))
    main_fa = (YI_BATCH, yi.num_heads, yi.num_kv_heads, YI_PROMPT,
               yi.resolved_head_dim)
    red_fa = (REDUCED_BATCH, yr.num_heads, yr.num_kv_heads, REDUCED_PROMPT,
              yr.resolved_head_dim)
    # recurrentgemma's local attention: MQA, hd 256
    rg_fa = (RG_BATCH, rg.num_heads, rg.num_kv_heads, RG_PROMPT,
             rg.resolved_head_dim)
    rg_red_fa = (REDUCED_BATCH, rgr.num_heads, rgr.num_kv_heads,
                 REDUCED_PROMPT, rgr.resolved_head_dim)
    fa_cases = [(main_fa, bf16, True), (main_fa, f32, True),
                ((1, 4, 4, 128, 64), f32, True), ((2, 8, 2, 256, 64), f32, True),
                ((1, 8, 1, 128, 128), f32, True), ((1, 6, 6, 192, 32), f32, True),
                ((1, 4, 4, 128, 64), bf16, True), ((2, 8, 2, 256, 64), bf16, True),
                ((1, 8, 1, 128, 128), bf16, True), ((1, 6, 6, 192, 32), bf16, True),
                ((1, 2, 2, 128, 32), f32, False), (red_fa, f32, True),
                (red_fa, bf16, True), ((1, 8, 2, 1000, 128), bf16, True),
                ((2, 4, 2, 77, 64), f32, True), ((2, 4, 2, 77, 64), f32, False),
                (rg_fa, bf16, True), ((2, 16, 1, 1000, 256), f32, True),
                ((1, 4, 1, 77, 256), f32, True), ((1, 4, 1, 77, 256), f32, False),
                ((1, 16, 1, 1000, 256), bf16, True), (rg_red_fa, f32, True),
                (rg_red_fa, bf16, True),
                # the tensor-core route's edges: S under one tile (1, 17), S
                # ragged against the 64-row q and 64/32-row kv tiles, full
                # (non-causal) attention, H/KV = 2 and 16, at hd 128 and 256
                ((1, 4, 2, 1, 128), bf16, True), ((2, 4, 2, 17, 128), bf16, True),
                ((1, 16, 1, 1, 256), bf16, True), ((2, 16, 1, 17, 256), bf16, True),
                ((1, 4, 2, 200, 128), bf16, False), ((1, 4, 1, 200, 256), bf16, False),
                ((1, 32, 2, 333, 128), bf16, True), ((1, 4, 2, 97, 256), bf16, True),
                ((2, 4, 2, 77, 64), bf16, False), ((1, 2, 1, 130, 16), bf16, True)]
    def plain_f32(q, k, v, causal=True):
        """The plain version on the same values widened to f32 (exactly),
        rounded to the input dtype at the end: the kernel's arithmetic.
        The plain version in bf16 also rounds the scores and weights to
        bf16, which the kernel (like the Pallas kernel) does not."""
        return attention_ref(q.float(), k.float(), v.float(),
                             causal=causal).to(q.dtype)

    checked = []
    for (B, H, KV, S, hd), dtype, causal in fa_cases:
        q = randn((B, H, S, hd), dtype)
        k, v = randn((B, KV, S, hd), dtype), randn((B, KV, S, hd), dtype)
        err = check("flash_attention",
                    fk.flash_attention_kernel(q, k, v, causal=causal),
                    plain_f32(q, k, v, causal), dtype)
        checked.append([B, H, KV, S, hd, str(dtype).removeprefix("torch."),
                        "causal" if causal else "full", err])

    def time_flash(B, H, KV, S, hd):
        """Kernel (bf16 route, and the f32 route on the same values), plain
        version and SDPA at one causal shape."""
        q = randn((B, H, S, hd), bf16)
        k, v = randn((B, KV, S, hd), bf16), randn((B, KV, S, hd), bf16)
        vs_bf16_plain = float((fk.flash_attention_kernel(q, k, v).float()
                               - attention_ref(q, k, v).float()).abs().max())
        ms = time_ms(lambda: fk.flash_attention_kernel(q, k, v), REPS)
        per_kernel = device_kernels_ms(lambda: fk.flash_attention_kernel(q, k, v))
        q32, k32, v32 = q.float(), k.float(), v.float()
        ms_f32 = time_ms(lambda: fk.flash_attention_kernel(q32, k32, v32),
                         max(2, REPS // 4))
        # the f32 route's yardstick: SDPA on the same f32 values (TF32 off
        # for the phase), called with enable_gqa and with kv repeated
        f32_lib = {}
        try:
            f32_lib["scaled_dot_product_attention(is_causal, enable_gqa)"] = \
                time_ms(lambda: F.scaled_dot_product_attention(
                    q32, k32, v32, is_causal=True, enable_gqa=True),
                    max(2, REPS // 4))
        except TypeError:      # a torch without enable_gqa
            pass
        kr32 = k32.repeat_interleave(H // KV, dim=1)
        vr32 = v32.repeat_interleave(H // KV, dim=1)
        f32_lib["scaled_dot_product_attention(is_causal), kv repeated"] = \
            time_ms(lambda: F.scaled_dot_product_attention(
                q32, kr32, vr32, is_causal=True), max(2, REPS // 4))
        del q32, k32, v32, kr32, vr32
        plain_ms = time_ms(lambda: attention_ref(q, k, v), max(2, REPS // 10))
        try:
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), REPS)
            library_call = "scaled_dot_product_attention(is_causal, enable_gqa)"
        except TypeError:      # a torch without enable_gqa: repeat kv first
            kr = k.repeat_interleave(H // KV, dim=1)
            vr = v.repeat_interleave(H // KV, dim=1)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, kr, vr, is_causal=True), REPS)
            library_call = "scaled_dot_product_attention(is_causal), kv repeated"
        flops = 4 * B * H * (S * (S + 1) // 2) * hd
        b, by = bound(2 * (2 * B * H * S * hd + 2 * B * KV * S * hd), flops,
                      BF16_OPS_PER_S)
        return {"max_abs_err_vs_bf16_plain": vs_bf16_plain,
                "ms": ms, "ms_f32": ms_f32, "device_kernels_ms": per_kernel,
                "library_ms_f32": min(f32_lib.values()),
                "library_ms_f32_by_call": f32_lib,
                "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                "library_ms": library_ms, "library_call": library_call,
                "timed_shape": [B, H, KV, S, hd, "bfloat16", "causal"],
                "flops": flops}

    rows = [{"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:62",
             "launches": 0,
             "max_abs_err": max(errs["flash_attention", "float32"],
                                errs["flash_attention", "bfloat16"]),
             "max_abs_err_f32": errs["flash_attention", "float32"],
             "max_abs_err_bf16": errs["flash_attention", "bfloat16"],
             **time_flash(*main_fa),
             "hd256": time_flash(*rg_fa),   # recurrentgemma-9b's prefill
             "checked_shapes": checked}]

    # -- SSD scan --------------------------------------------------------
    mb, mr = get_config("mamba2-370m"), get_config("mamba2-370m", reduced=True)

    def ssd_shape(cfg, batch, prompt):
        Q = min(cfg.ssm_chunk, prompt)
        return (batch, -(-prompt // Q) * Q, cfg.ssm_heads, cfg.ssm_headdim,
                cfg.ssm_state, Q)

    def ssd_inputs(B, S, H, P, N, Q, dtype):
        x = randn((B, S, H, P), dtype)
        dt = F.softplus(randn((B, S, H), f32) - 1)
        A = -torch.exp(randn((H,), f32) * 0.3)
        return arrange(x, dt, A, randn((B, S, N), dtype),
                       randn((B, S, N), dtype), Q)

    main_ssd = ssd_shape(mb, MAMBA_BATCH, MAMBA_PROMPT)
    red_ssd = ssd_shape(mr, REDUCED_BATCH, REDUCED_PROMPT)
    ssd_cases = [(main_ssd, bf16), (main_ssd, f32), (red_ssd, f32),
                 (red_ssd, bf16)]
    for shape in ((2, 128, 4, 16, 32, 32), (1, 256, 2, 64, 128, 64),
                  (1, 64, 8, 32, 16, 64), (1, 300, 2, 32, 64, 100)):
        ssd_cases += [(shape, f32), (shape, bf16)]
    # the tensor-core route's edges: one chunk (nc = 1), Q = 100 (ragged
    # against the 64-row tiles), H not a multiple of its 8-head block, P 128
    ssd_cases += [((2, 256, 4, 64, 128, 256), bf16),
                  ((1, 500, 12, 64, 128, 100), bf16),
                  ((1, 512, 10, 128, 64, 256), bf16),
                  ((3, 200, 3, 16, 48, 100), bf16)]
    checked = []
    for (B, S, H, P, N, Q), dtype in ssd_cases:
        ins = ssd_inputs(B, S, H, P, N, Q, dtype)
        y, st = sk.ssd_scan_kernel(*ins)
        yr_, sr = ssd_scan_ref(*ins)
        err = max(check("ssd_scan", y, yr_, dtype),
                  check("ssd_scan", st, sr, f32))     # the state is f32
        checked.append([B, S, H, P, N, Q, str(dtype).removeprefix("torch."),
                        err])
    try:   # (P, N, Q) = (128, 512, 256) tiles need more than 227 KiB
        sk.ssd_scan_kernel(*ssd_inputs(1, 256, 1, 128, 512, 256, f32))
        raise AssertionError("ssd_scan launched tiles above its shared memory")
    except RuntimeError as e:
        if "does not take these sizes" not in str(e):
            raise
    B, S, H, P, N, Q = main_ssd
    ins = ssd_inputs(B, S, H, P, N, Q, bf16)
    ms = time_ms(lambda: sk.ssd_scan_kernel(*ins), REPS)
    ins32 = [t.float() for t in ins]      # the f32 route on the same values
    ms_f32 = time_ms(lambda: sk.ssd_scan_kernel(*ins32), max(2, REPS // 4))
    del ins32
    per_kernel = device_kernels_ms(lambda: sk.ssd_scan_kernel(*ins))
    plain_ms = time_ms(lambda: ssd_scan_ref(*ins), max(2, REPS // 10))
    # the function's work: C B^T once per (b, chunk) (the heads share one
    # B/C group), then per (b, h, chunk) the decay mask, (G o L) xdt, the
    # chunk state, the inter-chunk term and the state update
    nc, tri = S // Q, Q * (Q + 1) // 2
    flops = B * nc * tri * 2 * N + B * H * nc * (
        tri * (1 + 2 * P) + 4 * Q * N * P + Q * P + Q * N + P * N)
    nbytes = (2 * 2 * B * S * H * P + 2 * 2 * B * S * N + 4 * B * H * S
              + 4 * B * H * P * N)
    b, by = bound(nbytes, flops, BF16_OPS_PER_S)
    rows.append({"name": "ssd_scan", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "replaces": "src/repro/kernels/ssd_scan/kernel.py:71",
                 "launches": 0,
                 "max_abs_err": max(errs["ssd_scan", "float32"],
                                    errs["ssd_scan", "bfloat16"]),
                 "max_abs_err_f32": errs["ssd_scan", "float32"],
                 "max_abs_err_bf16": errs["ssd_scan", "bfloat16"],
                 "ms": ms, "ms_f32": ms_f32, "device_kernels_ms": per_kernel,
                 "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                 "library_ms": None,
                 "timed_shape": [B, S, H, P, N, Q, "bfloat16"],
                 "flops": flops, "checked_shapes": checked})

    # -- RG-LRU scan -----------------------------------------------------
    W_rg = rg.lru_width

    def rglru_inputs(B, S, W, dtype):
        """The CPU tests' distribution: a in (0, 0.98), b about 0.1."""
        a = torch.sigmoid(randn((B, S, W), f32)) * 0.98
        return a.to(dtype), (randn((B, S, W), f32) * 0.1).to(dtype)

    main_rg = (RG_BATCH, RG_PROMPT, W_rg)
    rg_cases = [(main_rg, f32), (main_rg, bf16),
                ((REDUCED_BATCH, REDUCED_PROMPT, rgr.lru_width), f32),
                ((REDUCED_BATCH, 64, rgr.lru_width), f32),
                ((2, 77, 100), f32), ((2, 77, 100), bf16),
                ((1, 2000, W_rg), f32), ((1, 2000, W_rg), bf16),
                ((3, 1, 33), f32)]
    for shape in ((2, 128, 64), (1, 256, 128), (3, 64, 32)):
        rg_cases += [(shape, f32), (shape, bf16)]
    checked = []
    for (B, S, W), dtype in rg_cases:
        a, b_ = rglru_inputs(B, S, W, dtype)
        h, last = rk.rglru_scan_kernel(a, b_)
        # the plain version on the same values widened to f32, rounded to
        # the input dtype at the end (for f32 inputs, the plain version)
        hr, lr = (t.to(dtype) for t in rglru_scan_ref(a.float(), b_.float()))
        err = max(check("rglru_scan", h, hr, dtype),
                  check("rglru_scan", last, lr, dtype))
        if not torch.equal(last, h[:, -1]):
            raise AssertionError("rglru_scan: the final state is not h[:, -1]")
        checked.append([B, S, W, str(dtype).removeprefix("torch."), err])
    B, S, W = main_rg
    a, b_ = rglru_inputs(B, S, W, f32)
    ms = time_ms(lambda: rk.rglru_scan_kernel(a, b_), REPS)
    plain_ms = time_ms(lambda: rglru_scan_ref(a, b_), 2)
    b, by = bound(4 * (3 * B * S * W + B * W), 2 * B * S * W)
    rows.append({"name": "rglru_scan", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/rg_lru.cu",
                 "replaces": "src/repro/kernels/rg_lru/kernel.py:40",
                 "launches": 0,
                 "max_abs_err": max(errs["rglru_scan", "float32"],
                                    errs["rglru_scan", "bfloat16"]),
                 "max_abs_err_f32": errs["rglru_scan", "float32"],
                 "max_abs_err_bf16": errs["rglru_scan", "bfloat16"],
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                 "bound_by": by, "library_ms": None,
                 "timed_shape": [B, S, W, "float32"],
                 "checked_shapes": checked})
    torch.cuda.synchronize()
    emit({"phase": "lm_kernels", "checked": [r["name"] for r in rows],
          "tf32": False, "tolerances": {f"{k[0]}/{k[1]}": v
                                        for k, v in TOL.items()},
          "max_abs_err": {f"{k[0]}/{k[1]}": v for k, v in errs.items()},
          "seconds": time.perf_counter() - t_phase})
    return rows


class SyncWatch:
    """Wraps the reducer's batched digest calls: counts calls, checks each
    adds exactly one to ``HOST_SYNCS`` when it has blocks to hash, and
    counts the synchronising CUDA calls torch reports inside it."""

    def __init__(self):
        self.calls = 0
        self.seconds = 0.0              # wall time inside the wrapped calls
        self.cuda_syncs: list[int] = []
        self.extra: list[str] = []      # what synchronised beyond one

    def wrap(self, fn, has_blocks):
        import torch

        from repro_torch.kernels.hash_delta import ops as hops

        def wrapped(*args, **kw):
            before = hops.HOST_SYNCS
            t0 = time.perf_counter()
            old = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = fn(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(old)
            self.seconds += time.perf_counter() - t0
            want = 1 if has_blocks(args[0]) else 0
            if hops.HOST_SYNCS - before != want:
                raise AssertionError(
                    f"{fn.__name__}: HOST_SYNCS grew by "
                    f"{hops.HOST_SYNCS - before}, expected {want}")
            self.calls += 1
            syncs = [str(c.message).splitlines()[0] for c in caught
                     if "called a synchronizing" in str(c.message)]
            self.cuda_syncs.append(len(syncs))
            if len(syncs) != 1:
                self.extra.append(f"{fn.__name__}: {syncs}")
            return out
        return wrapped


def has_blocks(items) -> bool:
    """Whether a batched digest call's leaves or payloads hold any data."""
    import numpy as np
    import torch
    return any(x.numel() if isinstance(x, torch.Tensor)
               else len(x) if isinstance(x, (bytes, bytearray, memoryview))
               else np.size(x) for x in items)


def state_bytes(ns: dict) -> tuple[int, int]:
    """(all array bytes, bytes of CUDA tensors) of a namespace's arrays and
    lists of arrays, each buffer counted once."""
    import numpy as np
    import torch
    seen: dict[int, tuple[int, bool]] = {}
    for v in ns.values():
        for x in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(x, torch.Tensor):
                seen[x.data_ptr()] = (x.numel() * x.element_size(), x.is_cuda)
            elif isinstance(x, np.ndarray):
                seen[x.ctypes.data] = (x.nbytes, False)
    return (sum(n for n, _ in seen.values()),
            sum(n for n, cuda in seen.values() if cuda))


def hash_launches_in(fn) -> tuple[int, list[str]]:
    """Launches of the hash kernel in one call of ``fn`` and the names of
    every device activity (kernels, copies, fills) it ran, from a
    ``torch.profiler`` trace of that call alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with warnings.catch_warnings():   # the profiler's note on clearing events
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if getattr(ev, "device_type", None) == DeviceType.CUDA]
    return sum("hash_rows_kernel" in n for n in names), names


def phase_session(tmp: Path) -> dict:
    import numpy as np
    import torch

    import repro_torch.core.reducer as red
    from repro_torch.kernels.hash_delta import kernel as hk
    from repro_torch.kernels.hash_delta import ops as hops
    from repro_torch.kernels.quant_blockwise import kernel as qk
    from repro_torch.launch.notebook import run_notebook

    main_nb = tmp / "spacenet7_tiles.ipynb"
    main_nb.write_text(json.dumps(ipynb("spacenet7-tiles", [
        (SETUP, 0.3), (KMEANS, 600.0), (TWEAK, 0.1), (KMEANS, 600.0),
        (REPORT, 0.2)])))
    quant_nb = tmp / "quant_field.ipynb"
    quant_nb.write_text(json.dumps(ipynb("quant-field", [
        (QUANT_SETUP, 1.0), (QUANT_HEAVY, 300.0), (QUANT_REPORT, 0.2)])))

    watch = SyncWatch()
    orig = {n: getattr(red, n) for n in
            ("digest_leaves", "digest_leaves_delta", "array_chunk_digests_many")}
    for n, fn in orig.items():
        setattr(red, n, watch.wrap(fn, has_blocks))

    # capture what the runtime holds, to check the migrated bytes, and the
    # wall time of each migration (it ends on the host, so it is complete)
    from repro_torch.core import migration as mig
    captured, migrate_seconds = {}, []
    orig_close = mig.HybridRuntime.close
    orig_migrate = mig.MigrationEngine.migrate

    def close(self):
        captured[self.nb.name] = {n: e.state.ns for n, e in
                                  self.envs.items()}
        return orig_close(self)

    def migrate(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return orig_migrate(self, *args, **kw)
        finally:
            migrate_seconds.append(time.perf_counter() - t0)
    mig.HybridRuntime.close = close
    mig.MigrationEngine.migrate = migrate

    torch.cuda.synchronize()
    hk.reset_launches()
    qk.reset_launches()
    try:
        t0 = time.perf_counter()
        main, _ = run_notebook(str(main_nb), sessions=2, codec="none",
                               policy="single", device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        quant, _ = run_notebook(str(quant_nb), sessions=2,
                                codec="quant8+zstd", policy="single",
                                device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        for n, fn in orig.items():
            setattr(red, n, fn)
        mig.HybridRuntime.close = orig_close
        mig.MigrationEngine.migrate = orig_migrate
    launches = {**hk.LAUNCHES, **qk.LAUNCHES}
    by_route = dict(hk.ROUTE_LAUNCHES)

    # -- what came out -----------------------------------------------------
    local, remote = (captured["spacenet7-tiles"][k] for k in ("local", "remote"))
    full, on_card = state_bytes(local)
    if full < (1 << 30) or 2 * on_card < full:
        raise AssertionError(f"state {full} B ({on_card} B on the card): "
                             f"expected >= 1 GiB, at least half on the card")
    log = main["migration_log"]
    fwd = [m for m in log if m["dst"] == "remote" and not m["noop"]]
    if len(fwd) != 2 or fwd[0]["nbytes"] < 100 << 20:
        raise AssertionError(f"expected two forward migrations, the first "
                             f">= 100 MiB: {log}")
    if not CHUNK <= fwd[1]["nbytes"] <= CHUNK + (64 << 10):
        raise AssertionError(f"re-migration after a one-element change "
                             f"shipped {fwd[1]['nbytes']} B, expected about "
                             f"one {CHUNK} B chunk")
    for a, b in zip(local["edges"], remote["edges"]):
        if not np.array_equal(a.cpu().numpy(), b):
            raise AssertionError("a migrated edge map differs from its source")
    cents = local["centroids_out"]
    if len(cents) != N_KEEP or not all(c.shape == (4,) and np.isfinite(c).all()
                                       for c in cents):
        raise AssertionError("K-Means centroids are not finite (4,) arrays")
    if not np.isfinite(local["summary"]):
        raise AssertionError("summary is not finite")

    # the field as the setup cell made it (the return trip replaced the local
    # copy with the decoded one, as the reference does)
    src_field = torch.randn(
        FIELD_ELEMS, generator=torch.Generator(device="cuda").manual_seed(
            SEED + 1), device="cuda").cpu().numpy()
    got = captured["quant-field"]["remote"]["field"]
    blocks = src_field.reshape(-1, 1024)
    # half a quantization step, plus the f32 rounding of x / s and q * s
    # (at most 254 ulp of amax relative to the half step)
    half_step = np.abs(blocks).max(1) / 127 / 2 * (1 + 1e-4)
    err = np.abs(got.reshape(-1, 1024) - blocks).max(1)
    if got.dtype != np.float32 or not (err <= half_step).all():
        raise AssertionError("quant8 round trip exceeds half a step")
    qfwd = [m for m in quant["migration_log"] if m["dst"] == "remote"]
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")

    # one batched digest call of the session's own leaves (the edge maps on
    # the card, the footprint rasters on the host) under the profiler: one
    # hash launch, which also folds the leaves, and no eager fold ops
    leaves = list(local["edges"]) + list(local["footprints"])
    digests = hops.digest_leaves(leaves, device="cuda")
    prior = list(digests)
    prior[0] ^= 1
    traced = {}
    for name, call in (
            ("digest_leaves", lambda: hops.digest_leaves(leaves, device="cuda")),
            ("digest_leaves_delta", lambda: hops.digest_leaves_delta(
                leaves, prior, device="cuda"))):
        n_hash, names = hash_launches_in(call)
        traced[name] = {"hash_launches": n_hash,
                        "device_activities": sorted(set(names))}
        if n_hash != 1:
            raise AssertionError(f"{name}: {n_hash} hash kernel launches in "
                                 f"one batched call, expected 1: {names}")
    if hops.digest_leaves_delta(leaves, prior, device="cuda") != (digests, [0]):
        raise AssertionError("digest_leaves_delta disagrees with digest_leaves")
    emit({"phase": "session", "device": main["device"],
          "full_state_bytes": full, "full_state_on_card_bytes": on_card,
          "wall_seconds": {"main_session": t1 - t0, "quant8_session": t2 - t1,
                           "migrations": migrate_seconds,
                           "batched_digest_calls": watch.seconds},
          "migrations": [{k: m[k] for k in ("src", "dst", "nbytes", "noop")}
                         | {"names": m["names"][:6]} for m in log],
          "bytes_shipped": main["migrated_bytes"],
          "chunks_held": main["chunks_held"],
          "decisions": main["decisions"],
          "quant8": {"shipped_bytes": [m["nbytes"] for m in qfwd],
                     "field_bytes": src_field.nbytes,
                     "max_err_over_half_step": float((err / half_step).max()),
                     "decisions": quant["decisions"]},
          "launches": launches, "launches_by_route": by_route,
          "one_batched_call_traced": traced,
          "batched_digest_calls": watch.calls,
          "cuda_syncs_per_batched_call": sorted(set(watch.cuda_syncs)),
          "extra_syncs": watch.extra})
    if not all(s == 1 for s in watch.cuda_syncs):
        raise AssertionError(f"synchronising CUDA calls per batched digest "
                             f"call: {watch.cuda_syncs}, expected 1 each")
    return launches


def phase_agree(tmp: Path) -> None:
    from repro_torch.launch.notebook import run_notebook
    t_phase = time.perf_counter()
    small = tmp / "small.ipynb"
    setup = SETUP.replace(f"({TILE}, {TILE}, 3)", "(32, 32, 3)").replace(
        f"range({N_SCENES})", "range(6)").replace(
        "1 << 20, 3 << 20", "100, 3000").replace(f"[-{N_KEEP}:]", "[-3:]")
    small.write_text(json.dumps(ipynb("small", [
        (setup, 0.3), (KMEANS, 600.0), (TWEAK, 0.1), (KMEANS, 600.0),
        (REPORT, 0.2)])))
    out = {}
    for codec in ("zlib", "quant8+zstd"):
        for device in ("cuda", "cpu"):
            rep, _ = run_notebook(str(small), sessions=2, codec=codec,
                                  policy="single", device=device)
            out[codec, device] = rep
        a, b = out[codec, "cuda"], out[codec, "cpu"]
        if (a["decisions"], a["migrated_bytes"], a["modeled_seconds"]) != \
                (b["decisions"], b["migrated_bytes"], b["modeled_seconds"]):
            raise AssertionError(f"{codec}: the card and the plain versions "
                                 f"disagree: {a} vs {b}")
    emit({"phase": "agree", "codecs": ["zlib", "quant8+zstd"],
          "migrated_bytes": {c: out[c, "cuda"]["migrated_bytes"]
                             for c in ("zlib", "quant8+zstd")},
          "equal": True, "seconds": time.perf_counter() - t_phase})


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def lm_kernels():
    """The LM kernels' wrapper modules: flash_attention, ssd_scan, rglru_scan."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rg_lru import kernel as rk
    from repro_torch.kernels.ssd_scan import kernel as sk
    return fk, sk, rk


def lm_launches() -> dict:
    return {k: v for m in lm_kernels() for k, v in m.LAUNCHES.items()}


def expected_launches(cfg, prompt: int) -> dict:
    """One prefill's launches: the SSD scan in every ssm layer, the RG-LRU
    scan in every rec layer, flash in every attention layer except where
    the reference's dispatch takes banded attention (a local window, and S
    a multiple of it above it)."""
    kinds = cfg.layer_kinds()
    w = cfg.local_window if cfg.block_pattern else 0
    banded = bool(w) and prompt > w and prompt % w == 0
    return {"flash_attention": 0 if banded else kinds.count("attn"),
            "ssd_scan": kinds.count("ssm"), "rglru_scan": kinds.count("rec")}


def phase_serve() -> dict:
    """The LM serving path on the card through ``serve_lm``: full yi-6b,
    full mamba2-370m and full recurrentgemma-9b with seeded bf16 weights.
    One prefill must launch each layer's kernel once (decode runs plain
    PyTorch): flash 32 (yi-6b); SSD 48 (mamba2); RG-LRU 26 and flash 12
    (recurrentgemma, whose prompt of 2048 equals its window, so its
    attention layers run full causal attention through flash).  Every id
    must lie in [0, padded_vocab).  Returns the launches of the kernels,
    summed over the three models."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import LM
    from repro_torch.models.layers import param_count

    launches = {}
    for arch, batch, prompt in (("yi-6b", YI_BATCH, YI_PROMPT),
                                ("mamba2-370m", MAMBA_BATCH, MAMBA_PROMPT),
                                ("recurrentgemma-9b", RG_BATCH, RG_PROMPT)):
        cfg = get_config(arch)
        want = expected_launches(cfg, prompt)
        if arch == "recurrentgemma-9b" and want != {
                "flash_attention": 12, "ssd_scan": 0, "rglru_scan": 26}:
            raise AssertionError(f"{arch}: expected launches {want}")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        for m in lm_kernels():
            m.reset_launches()
        t0 = time.perf_counter()
        out = serve_lm(cfg, batch=batch, prompt_len=prompt, gen=GEN,
                       seed=SEED, device="cuda", dtype=torch.bfloat16)
        wall = time.perf_counter() - t0
        got = lm_launches()
        if got != want:
            raise AssertionError(f"{arch}: launches {got}, expected {want} "
                                 f"(one per layer in one prefill)")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        ids = out["ids"]
        if ids.shape != (batch, GEN) or ids.min() < 0 or \
                ids.max() >= cfg.padded_vocab:
            raise AssertionError(f"{arch}: ids {ids.shape} outside "
                                 f"[0, {cfg.padded_vocab})")
        for key in ("prefill_logits", "last_logits"):
            if out[key].shape != (batch, cfg.padded_vocab) or \
                    not np.isfinite(out[key]).all():
                raise AssertionError(f"{arch}: {key} not finite of shape "
                                     f"({batch}, {cfg.padded_vocab})")
        emit({"phase": "serve", "arch": arch, "card": card_line(),
              "params": param_count(LM(cfg, device="cpu").spec),
              "dtype": "bfloat16", "batch": batch, "prompt_len": prompt,
              "gen": GEN, "prefill_seconds": out["prefill_seconds"],
              "decode_seconds": out["decode_seconds"],
              "decode_tokens_per_s": out["decode_tokens_per_s"],
              "peak_memory_bytes": out["peak_memory_bytes"],
              "wall_seconds_with_init": wall, "launches": got,
              "ids_sample": ids[0, :8].tolist()})
        del out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


SERVE_AGREE = (("yi-6b", REDUCED_PROMPT, 1e-4),
               ("mamba2-370m", REDUCED_PROMPT, 1e-3),
               # 48: S > window (32) but not a multiple: full causal, flash
               ("recurrentgemma-9b", REDUCED_PROMPT, 1e-4),
               # 64: a multiple of the window: plain banded attention
               ("recurrentgemma-9b", 64, 1e-4))


def phase_serve_agree() -> None:
    """The reduced yi-6b, mamba2-370m and recurrentgemma-9b (at prompts 48
    and 64) in f32 through ``serve_lm`` on the card (the kernels) and on the
    CPU (their plain versions, which the CPU tests hold to the JAX
    reference), with the same weights: logits within the model tolerances,
    equal greedy ids, and on the card exactly the expected launches (none
    on the CPU)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import LM

    t_phase = time.perf_counter()
    errs, ran = {}, {}
    for arch, prompt, tol in SERVE_AGREE:
        cfg = get_config(arch, reduced=True)
        params = LM(cfg, device="cpu").init(SEED, torch.float32)
        out = {}
        for dev in ("cuda", "cpu"):
            before = lm_launches()
            out[dev] = serve_lm(cfg, batch=REDUCED_BATCH, prompt_len=prompt,
                                gen=8, seed=SEED, device=dev, params=params)
            got = {k: n - before[k] for k, n in lm_launches().items()}
            want = expected_launches(cfg, prompt) if dev == "cuda" else \
                {k: 0 for k in got}
            if got != want:
                raise AssertionError(f"{arch} {prompt} on {dev}: launches "
                                     f"{got}, expected {want}")
        a, b = out["cuda"], out["cpu"]
        for key in ("prefill_logits", "last_logits"):
            np.testing.assert_allclose(a[key], b[key], atol=tol, rtol=tol,
                                       err_msg=f"{arch} {prompt} {key}")
        if not np.array_equal(a["ids"], b["ids"]):
            raise AssertionError(f"{arch} {prompt}: greedy ids differ between "
                                 f"the card and the CPU")
        errs[f"{arch}/{prompt}"] = max(float(np.abs(a[k] - b[k]).max())
                                       for k in ("prefill_logits", "last_logits"))
        ran[f"{arch}/{prompt}"] = {k: n for k, n in
                                   expected_launches(cfg, prompt).items() if n}
    emit({"phase": "serve_agree", "dtype": "float32",
          "tolerance": {f"{a}/{p}": t for a, p, t in SERVE_AGREE},
          "max_abs_logit_err": errs, "card_launches": ran, "ids_equal": True,
          "seconds": time.perf_counter() - t_phase})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (no result line)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    phase_card()
    phase_build()
    rows = phase_kernels() + phase_lm_kernels()
    if args.kernels_only:
        emit({"kernels": rows})
        return 0
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        launches = phase_session(Path(tmp))
        phase_agree(Path(tmp))
    launches.update(phase_serve())
    phase_serve_agree()
    for r in rows:
        r["launches"] = launches[r["name"]]
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
