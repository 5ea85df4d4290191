#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase; last line {"ok": true, ...}
    python3 chip_smoke.py --kernels-only  # card, build and kernel checks only

Phases, each printing one JSON line:

1. card:    the card's name and power limit as nvidia-smi reports them;
2. build:   ``nvcc`` builds every CUDA kernel from ``src/repro_torch/kernels/csrc``,
            one process per source, all at once; two more lines give
            ptxas's registers and spill bytes of the flash backward's and
            the SSD backward's tensor-core kernels, each of which must spill
            nothing;
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
            with each launch's device time from torch.profiler (quantize and
            dequantize too, and torch.mul(q, scale) as dequantize's
            yardstick);
4. lm_kernels: flash_attention, ssd_scan and rglru_scan against their plain
            versions (TF32 off for the f32 products), at the serve path's
            shapes (flash at yi-6b's hd 128, stablelm-12b's hd 160,
            recurrentgemma's hd 256, qwen3-moe's GQA 64:4, a dist_tp
            rank's qwen2-moe (8 of 16 heads), whisper-tiny's
            encoder, unmasked at S 1500, and decoder prompt, hd 64, at
            all 6 heads and at a dist_tp rank's 3), the
            CPU tests' shapes, ragged ones and the tensor-core routes' edges
            (S under one tile, full attention, H/KV 2 and 16; one chunk,
            Q = 100, H not a multiple of the 8-head block), f32 within 2e-5
            (flash) and 5e-4 (SSD), bf16 outputs within about two bf16 ulps
            (flash atol = rtol = 8e-3; SSD atol 1e-3, rtol 1.6e-2;
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
            rglru_scan bit for bit against its plain version in f32 and
            bf16, two calls the same bits, at recurrentgemma-9b's serving
            and training shapes at full width and a tp rank's, and at the
            edges of its tiles, bands and copy paths (``RG_EDGE_SHAPES``;
            the checks must take both bands and every copy path), timed at
            both serving widths with its device time, the event time's gap
            to it and where a host and device trace puts that gap, and the
            grid and shared memory a block of its launch in the trace;
   lm_kernels_bwd: flash_attention_bwd against the plain backward
            formulas (``attention_bwd_ref``) from the forward kernel's own
            output (held against the plain forward within flash's
            tolerance) and row log-sum-exp (held against
            torch.logsumexp of the plain scores: f32 1e-5, bf16 4e-3), at
            the training shapes (minicpm-2b's q (2,36,1024,64) and
            demo-100m's (4,12,256,64) causal, yi-6b's GQA 32:4 at hd 128,
            hd 160 and 256, whisper-tiny's unmasked S 1500, also at a
            dist_tp rank's 3 of 6 heads (timed beside SDPA's backward), S
            under one tile, ragged S), and bf16 at the tensor-core route's
            tile edges
            (hd 64 and 128, S 31-33, 63-65, 127-129, GQA 4:1 and 8:1, B 1
            and 2; the sweep route's at hd 160 and 256, S 1, 20, 31, 33,
            63, 65, 127, 129, GQA 16:1 and 4:1), f32 within 1e-4 and bf16
            within 8e-3 (about two bf16 ulps; the plain formulas in f32
            from the same bf16 values); each case records the route it took
            (tensor cores for bf16, CUDA cores for f32); two calls give the
            same bits; timed, with each kernel's device time, on both routes
            beside the plain formulas and the backward of
            scaled_dot_product_attention (torch.autograd.grad), which the
            port never calls, and the training forward (with the
            log-sum-exp) beside SDPA's forward; the sweep route checked and
            timed likewise at recurrentgemma-9b's training shape (2,16,1,
            1024,256), at each head slice count of 1-16, and stablelm-12b's
            heads (2,32,8,1024,160), with its launches' shared memory and
            blocks an SM;
            rglru_scan_bwd bit for bit against its plain backward
            (``rglru_scan_bwd_ref``) at recurrentgemma-9b's training and
            serving shapes, full width and a tp rank's, with and without the
            final state's gradient, and at S 1 and 17, W 100 and 130, B 1
            and the forward's edge shapes, timed at both training widths as
            the forward is;
            ssd_scan_bwd against ``ssd_scan_bwd_ref`` in f32 from the same
            values at mamba2-370m's training shape (4 x 2048, 32 heads, P
            64, N 128, 8 chunks of 256), f32 and bf16, and at one chunk, Q
            100, H 3, 10 and 12 (not multiples of the 8-head block), P 16
            and 128, N 16, 48 and 64, and in bf16 (the tensor-core route)
            at Q 32, 64, 128 and 192, H 1 and 17, S of one ragged chunk and
            N 112: f32 within 1e-4 of each output's max-abs, bf16 within
            2**-7 of it (about two bf16 ulps of the largest element; dcums,
            f32, within 1e-4); two calls give the same bits; both routes
            timed (CUDA events and each launch's device time) beside the
            plain version and the bound, with the bf16 route's shared
            memory a block and resident blocks an SM;
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
7. socket:  the session's two notebooks again with ``transport="socket"``: the
            remote env is a child ``repro_torch.core.remote_worker --device
            cuda`` on the same card and every migration streams wire frames
            over TCP (the reduced set, the one-chunk re-migration, the return
            trips, the quant8 leg); where each cell ran and the migrated
            names equal a loopback run's with knowledge probing off; what
            left comes home (or is read back from the child) bit-equal, the
            quant8 field equal to a local quantize/dequantize round trip; the
            parent's and the child's kernel counts rise; the child exits 0
            at BYE; prints each leg's wall time and bytes on the wire;
8. fleet:   the fleet scheduler through ``run_notebook(fleet=4)``: four
            spacenet7-tiles sessions (two passes each under the single-cell
            policy, Poisson arrivals at 0.2/s, think time 5 s, seed 0) over
            one fabric and one chunk store; every session completes with
            its reducer on the card, the dataset crosses to the remote env
            once and each other session ships under 1 % of what the first
            shipped; the quant8 field as a two-session fleet (quantize and
            dequantize must launch); bench_replica's four failover arms at
            5,000,000 elements (promotion must beat checkpoint-restore on
            recovery overhead by more than 10x), held against the same arms
            on the CPU; and the four sessions at 64x64 tiles with a replica
            each on the card and on the CPU (placements, bytes, chunk keys
            and counts equal, modeled seconds within rtol 1e-12), the
            card's hash launches traced with torch.profiler;
9. gateway: bench_gateway's 10,000-session attach storm through one
            ``GatewayService(device="cuda")`` (peak concurrency 10,000, no
            errors), the server's wire storm (``serve_gateway(0,
            stress=2000)``, in a process of this script started before
            the socket phase, its host work beside theirs) and notebook
            fleet (``serve_notebook_fleet(8)``),
            and a 300-session storm on the card and on the CPU with every
            sim-derived field of the report equal;
10. checkpoint: ``repro_torch.checkpoint`` on the card: the full
            internvl2-2b bf16 parameters (3.78 GB) and a 0-d data_step saved
            with codec ``none``, then a delta save (one element of one leaf
            changed, one other leaf replaced) that must write exactly those
            2 leaves within the replaced leaf's bytes plus 2 x 256 KiB, with
            the hash kernels traced on the card; both steps restored bit for
            bit in bf16 on the card; full whisper-tiny through
            ``AsyncCheckpointer`` (default codec) beside one whisper prefill,
            restored bit for bit; GC at keep=1 (three saves, 2 manifests,
            the chunk files exactly those they reference); prints save and
            restore seconds, bytes and leaves written;
11. serve:  the LM serving path through ``repro_torch.launch.serve.serve_lm`` at
            full yi-6b (batch 4, prompt 2048), full mamba2-370m (batch 8,
            prompt 2000), full recurrentgemma-9b (batch 4, prompt 2048, its
            local window), full stablelm-12b (batch 4, prompt 2048), full
            qwen2-moe-a2.7b (batch 4, prompt 2048), qwen3-moe-235b-a22b at
            full width and 8 of its 94 layers (batch 4, prompt 2048), full
            internvl2-2b (batch 4, 256 patches + 1792 text tokens) and full
            whisper-tiny (batch 4, decoder prompt 384 over 1500 encoder
            frames), seeded bf16 weights, 32 greedy tokens each; one prefill
            must launch flash_attention 32 times (yi-6b), ssd_scan 48 times
            (mamba2), rglru_scan 26 and flash_attention 12 times
            (recurrentgemma), flash_attention 40 times at hd 160
            (stablelm-12b), 24 (qwen2-moe), 8 (qwen3-moe), 24 (internvl2)
            and 8 (whisper: 4 unmasked, 4 causal), once per layer; every id
            must lie in [0, padded_vocab); prints prefill seconds, decode
            tokens/s and the peak memory of prefill and decode;
12. serve_agree: the reduced yi-6b, mamba2-370m, recurrentgemma-9b
            (prompts 48, full causal attention through flash, and 64, banded
            attention), stablelm-12b (hd 16, and hd 160), qwen2-moe-a2.7b,
            qwen3-moe-235b-a22b, internvl2-2b and whisper-tiny in f32 on the
            card and on the CPU with the same weights: logits within 1e-4
            (1e-3 for mamba2), equal greedy ids;
13. train:  the training path through ``repro_torch.launch.train.main``:
            full minicpm-2b (40 layers, d 2304, vocab 122,753), seeded bf16
            weights, batch 2 x seq 1024, 4 steps at lr 2e-5, each launching
            flash_attention and flash_attention_bwd 40 times (the backward's
            40 on its tensor-core route), finite and
            falling losses, seconds per step, tokens/s and peak device
            memory; full demo-100m checkpointed at step 2 (codec none) and
            resumed for steps 2-3 from the bits of the parameters and
            optimizer state saved, losses equal to the unbroken run's within
            1e-3, the hash kernels launched; full mamba2-370m through the
            CLI (batch 4 x seq 2048, 4 steps at lr 2e-5: 48 ssd_scan and 48
            ssd_scan_bwd launches a step) and recurrentgemma-9b at full
            width cut to 6 of its 38 layers through the CLI's step function
            (batch 2 x seq 1024, 4 steps: 4 rglru_scan, 4 rglru_scan_bwd, 2
            flash_attention and 2 flash_attention_bwd launches a step), each
            with finite and falling losses, seconds per step, tokens/s, peak
            device memory and one traced step;
14. train_agree: reduced yi-6b, minicpm-2b, qwen2-moe-a2.7b, internvl2-2b,
            whisper-tiny, mamba2-370m and recurrentgemma-9b (seq 48 and 64)
            in f32, one LM.loss and its backward on the card and on the CPU
            with the same weights: loss within 1e-5, every gradient leaf
            within 1e-4 of its max-abs (1e-3 for mamba2), one forward and
            one backward launch per attention, ssm and rec layer on the
            card, none on the CPU; two adamw_update steps on the CPU's
            gradients on each side, masters within 1e-6 of each max-abs;
15. dist_train: ``repro_torch.distributed.build_train_step`` at world
            size 1 (NCCL, a 1 x 1 ("data", "model") mesh): full minicpm-2b
            at the train phase's batch, 2 steps in fsdp and in tp (ZeRO-1)
            mode with the same losses, grad norms and parameter bits as
            ``launch/train.py``'s ``train_step``, seconds per step, peak
            memory, the memory held before the steps, the per-unit
            gather's high-water mark of gathered bytes and the extra
            parameter copies the DTensor path holds;
            recurrentgemma-9b at full width with remat full at 6 layers
            (against remat none within 1e-3), 9 and 12 layers (each peak,
            or the out-of-memory, recorded; no depth is tried after one
            that ran out);
16. dist_serve: ``repro_torch.distributed.build_prefill_step`` and
            ``build_decode_step`` at world size 1 (NCCL, a 1 x 1 mesh):
            full yi-6b (batch 4, prompt 2048) and full mamba2-370m (batch
            8, prompt 2000), seeded bf16 weights, a prefill and 32 greedy
            steps through ``LM``, through the steps in fsdp (the same
            logit and id bits as ``LM``'s) and in tp with sp_decode (yi-6b
            decodes through ``sp_decode_attention``; logits within 5e-2 of
            ``LM``'s, ids equal but at near ties), flash 32 and SSD 48
            launches a prefill; prefill seconds, decode tokens/s and peak
            memory of each path, the step paths' gathered bytes (each unit
            gathered and freed around its run); full qwen2-moe-a2.7b (batch 4, prompt
            2048) through ``LM`` and through the tp steps with the local
            routing (``moe_impl="shardmap"``, 24 moe layers a step each
            through ``moe_ffn_shardmap``): the same logit and id bits as
            ``LM``'s, flash 24 launches a prefill, the leg's seconds; and
            ``sp_decode_attention`` against the plain write and attention
            at yi-6b's decode shape in bf16;
17. dist_tp: tensor-parallel compute over ``model``: two ranks as
            two processes of this script on the one card, gloo over CUDA
            tensors on a (1, 2) mesh (``make_dev_mesh(..., backend=
            "gloo")``; NCCL refuses two ranks on one device): a probe of
            which gloo collectives take CUDA tensors; serving against
            ``LM`` in this process (logits within 5e-2, mamba2-370m's
            within 0.25 beside LM's own distance from an f32 arm; ids
            equal but at near ties): full yi-6b (batch 4, prompt 2048, 32
            steps) with sp_decode off and on (flash 32 launches a rank's
            prefill at 16 of 32 heads), full mamba2-370m (batch 8, prompt
            2000; the SSD scan 48 at 16 of 32 heads) and full
            recurrentgemma-9b (batch 4, prompt 2048; the RG-LRU scan 26
            at 2048 of 4096, flash 12 at 8 of 16 q heads) and full
            qwen2-moe-a2.7b (batch 4, prompt 2048; EP, 30 of the 60
            experts a rank, the global routing; flash 24 at 8 of 16 q
            heads over 8 of 16 kv heads; where a rank's top-K differs from
            ``LM``'s it takes ``LM``'s only at a near tie in its own
            router logits, within 36 bf16 spacings, on at most 0.227 of
            the routings, and the flips are counted by gap) with
            sp_decode on, 8 steps each; full whisper-tiny (batch 4, a
            decoder prompt of 384 over the pipeline's 1500 encoder frames,
            32 steps) with sp_decode off and on (flash 8 launches a rank's
            prefill at 3 of 6 heads: 4 unmasked in the encoder, 4 causal
            in the decoder); each rank's parameter bytes
            ``model_memory``'s tp count, the ranks making their seeded
            weights in turn; full-width training
            against ``build_train_step`` at world size 1 (loss within
            1e-3, grad norm within 1e-2, each leaf's gradient norm within
            2e-2): minicpm-2b (the most of 40, 20 and 10 layers at which
            both ranks fit), mamba2-370m (48, 24, 12),
            recurrentgemma-9b (6, 3) and whisper-tiny (all 4 decoder and 4
            encoder layers, batch 4, seq 384), each kernel and its backward
            once a layer of its kind at the rank's shape; seconds, each rank's
            peak memory beside ``model_memory`` for tp on (1, 2), and the
            collectives' bytes and share of the step (host-staged gloo,
            not NCCL's times).  The kernel checks hold the SSD scan, the
            RG-LRU scan, hd-256 flash and whisper-tiny's flash, forward and
            backward, at these rank shapes too.

Every peak of device memory (the serve cells, the train legs, dist_train,
dist_serve) is printed beside ``launch.memmodel.model_memory``'s terms and
total for the same cell on a 1 x 1 mesh (``hbm_bytes`` the card's memory)
and the ratio of the peak to the model.

Then the ``kernels`` line (each kernel's launches summed over the session,
socket, fleet, gateway, checkpoint, serve, train, dist_train, dist_serve
and dist_tp runs, and split by run in ``launches_by_path``), and last
``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import re
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


def kernel_name(name: str) -> str:
    """A kernel's name in a trace, without its namespace, template
    arguments and parameters."""
    return name.replace("(anonymous namespace)::", "").removeprefix(
        "void ").split("(")[0].split("<")[0].split("::")[-1]


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
            name = kernel_name(ev.key)
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def traced_launch(fn, kernel: str, reps: int = 5) -> dict:
    """One ``torch.profiler`` trace, host and device, of ``reps`` calls of
    ``fn`` after one warm-up, each made as ``time_ms`` makes it (an event
    recorded, the call, an event recorded and waited on).  From the trace:
    the launch of ``kernel`` as the card ran it (grid, block, shared memory
    a block, registers a thread), and per call the medians of where the
    CUDA-event time beyond the kernel's device time goes: the host from the
    first event's record to the launch call (``host_to_launch_us``), within
    it the aten ops (``aten_us``; ``aten_ops``: each op's time a call,
    summed over its calls), the launch call itself (``launch_call_us``),
    and the kernel's own time in such a lone call (``kernel_us``).  No host
    time is subtracted from a device time: the trace aligns the two clocks
    only roughly.  The profiler adds its own cost to each host op it
    records.  Empty if the trace holds no launch of ``kernel``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def call():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()

    call()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    events = [e for e in events if e.get("ph") == "X"]
    events.sort(key=lambda e: e["ts"])
    kernels = [e for e in events if e.get("cat") == "kernel"
               and kernel_name(e["name"]) == kernel]
    if not kernels:
        return {}
    api = ("cuda_runtime", "cuda_driver")
    by_corr = {e["args"].get("correlation"): e for e in events
               if e.get("cat") in api}
    calls = []
    for k in kernels:
        launch = by_corr.get(k["args"].get("correlation"))
        if launch is None:
            continue
        records = [e for e in events if e.get("cat") in api
                   and e["name"].startswith("cudaEventRecord")
                   and e["ts"] < launch["ts"]]
        if not records:
            continue
        t0 = records[-1]["ts"] + records[-1]["dur"]
        ops = [e for e in events if e.get("cat") == "cpu_op"
               and t0 <= e["ts"] < launch["ts"]]
        top = [e for e in ops if not any(
            o is not e and o["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= o["ts"] + o["dur"] for o in ops)]
        aten_ops = {}
        for e in top:
            aten_ops[e["name"]] = aten_ops.get(e["name"], 0.0) + e["dur"]
        calls.append({"host_to_launch_us": launch["ts"] - t0,
                      "aten_us": sum(aten_ops.values()),
                      "aten_ops": aten_ops,
                      "launch_call_us": launch["dur"],
                      "kernel_us": k["dur"]})
    args = kernels[-1]["args"]
    out = {"launch": {"grid": args.get("grid"), "block": args.get("block"),
                      "smem_bytes": args.get("shared memory"),
                      "registers": args.get("registers per thread")},
           "calls_traced": len(calls)}
    if calls:
        med = {key: statistics.median(c[key] for c in calls)
               for key in ("host_to_launch_us", "aten_us", "launch_call_us",
                           "kernel_us")}
        names = sorted({n for c in calls for n in c["aten_ops"]})
        med["aten_ops"] = {n: statistics.median(c["aten_ops"].get(n, 0.0)
                                                for c in calls)
                           for n in names}
        out["host_gap"] = med
    return out


def bound(nbytes: int, ops: int,
          ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_launch(fn, kernel: str, planned: dict) -> dict:
    """``fn``'s CUDA-event time (``ms``), its launches' device time from
    torch.profiler, the gap between the two (the host's time before the
    launch, which the event time counts) and a host and device trace of a
    few calls (``traced_launch``: the grid and shared memory a block of
    ``kernel``'s launch as the card ran it, and where the gap goes).
    Raises if the traced launch is not the ``planned`` one
    (``rk.launch_config``)."""
    ms = time_ms(fn, REPS)
    # a profiler session now and then records no device time: one more
    dev = device_kernels_ms(fn) or device_kernels_ms(fn)
    traced = traced_launch(fn, kernel)
    launch = traced.get("launch")
    if launch and (launch["grid"] != [*planned["grid"], 1]
                   or launch["block"] != [planned["threads"], 1, 1]
                   or launch["smem_bytes"] != planned["smem_bytes"]):
        raise AssertionError(f"{kernel}: launched {launch}, planned {planned}")
    return {"ms": ms, "device_kernels_ms": dev,
            "event_minus_device_ms": ms - sum(dev.values()) if dev else None,
            **traced}


# The RG-LRU scans' edge shapes, checked beside the model's: S of 1, below
# one 32-step tile and not a multiple of it; W not a multiple of the 16- or
# 32-channel band; rows whose pitch is not a multiple of 16 bytes, which
# take one-element copies (W 33, 130, 7 and 8451 in f32: 4-byte cp.async;
# W 33, 100, 130, 7 and 8451 in bf16: synchronous loads and stores); bands
# of 32 with a ragged tail (B 1, W 8500 and 8451).
RG_EDGE_SHAPES = ((3, 1, 33), (2, 17, 100), (2, 77, 100), (2, 77, 130),
                  (2, 77, 33), (1, 100, 8500), (1, 77, 8451), (5, 31, 7))


def check_rg_paths(name: str, paths: set, copy_bytes: set) -> None:
    """Raise unless the checked shapes took both bands and every copy
    path (``copy_bytes``) of the RG-LRU kernel."""
    bands = {b for b, _ in paths}
    copies = {c for _, c in paths}
    if bands != {16, 32} or copies != copy_bytes:
        raise AssertionError(f"{name}: the checks took bands {sorted(bands)} "
                             f"and copies {sorted(copies)}")


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
    from repro_torch.kernels.flash_attention.kernel import TC_BWD_HEAD_DIMS
    from repro_torch.kernels.ssd_scan.kernel import HEAD_DIMS as SSD_HEAD_DIMS
    t0 = time.perf_counter()
    reports = _build.build_all()
    seconds = time.perf_counter() - t0
    for name in _build.SIGNATURES:
        _build.load(name)
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "entry function" in ln]
             for n, log in reports.items()}
    # the tensor-core kernels' registers and spills, each of which must
    # spill nothing: flash backward (an instance per head dim and walk) and
    # SSD backward (products and tiles per head dim, the state pass)
    checks = {"flash_attention_bwd": 2 * len(TC_BWD_HEAD_DIMS),
              "ssd_scan_bwd": 2 * len(SSD_HEAD_DIMS) + 1}
    for lib, want in checks.items():
        if lib not in reports:
            continue
        tc = {}
        for name, use in ptxas_usage(reports[lib]).items():
            if "ssd_bwd_pass_tc" in name:
                tc["ssd_bwd_pass_tc"] = use
            elif "_tc<" in name:
                tc[name] = use
        spilled = {n: u for n, u in tc.items()
                   if u.get("spill_stores", 1) or u.get("spill_loads", 1)}
        emit({"phase": "build", f"{lib}_tensor_cores": tc,
              **({f"ptxas_{lib}": ptxas[lib]} if spilled else {})})
        if len(tc) != want or spilled:
            raise AssertionError(f"{lib} tensor-core kernels: {len(tc)} "
                                 f"instances, spilled {spilled}")
    if "rg_lru" in reports:
        # the RG-LRU kernels (the forward in f32 and bf16, the backward):
        # registers and spills, which must be none
        use = {re.search(r"rglru_scan\w*?_kernel", n).group(0)
               + ("<bf16>" if "bfloat16" in n else "<f32>"): u
               for n, u in ptxas_usage(reports["rg_lru"]).items()}
        spilled = {n: u for n, u in use.items()
                   if u.get("spill_stores", 1) or u.get("spill_loads", 1)}
        emit({"phase": "build", "rg_lru_kernels": use})
        if len(use) != 3 or spilled:
            raise AssertionError(f"rg_lru kernels: {len(use)} entry "
                                 f"functions, spilled {spilled}")
    emit({"phase": "build", "seconds": seconds, "built": sorted(reports),
          "ptxas": ptxas})


def ptxas_usage(log: str) -> dict:
    """``{kernel<hd>: {"registers", "spill_stores", "spill_loads"}}`` of the
    templated entry functions in an ``nvcc -Xptxas -v`` log (names
    demangled as far as ``name<hd>``)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", ln)
        if m:
            k = re.search(r"([a-z]+(?:_[a-z]+)*)ILi(\d+)E", m.group(1))
            cur = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if cur and m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if cur and m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


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
    per_kernel = device_kernels_ms(lambda: qk.quantize_kernel(xq))
    plain_ms = time_ms(lambda: quantize_ref(xq), max(2, reps // 10))
    b, by = bound(xq.numel() * (4 + 1) + main_q * 4, xq.numel() * 6)
    rows.append({"name": "quantize", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/quant_blockwise.cu",
                 "replaces": "src/repro/kernels/quant_blockwise/kernel.py:27",
                 "launches": 0, "max_abs_err": qerr, "ms": ms,
                 "device_kernels_ms": per_kernel,
                 "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                 "library_ms": None, "timed_shape": [main_q, 1024, "float32"],
                 "checked_shapes": shapes})
    q, s = qk.quantize_kernel(xq)
    ms = time_ms(lambda: qk.dequantize_kernel(q, s, torch.float32), reps)
    per_kernel = device_kernels_ms(
        lambda: qk.dequantize_kernel(q, s, torch.float32))
    plain_ms = time_ms(lambda: dequantize_ref(q, s, torch.float32),
                       max(2, reps // 10))
    # the yardstick: one PyTorch call for q * scale (int8 x f32 -> f32),
    # which the port never calls
    library_ms = time_ms(lambda: torch.mul(q, s[:, None]), reps)
    if not torch.equal(torch.mul(q, s[:, None]),
                       qk.dequantize_kernel(q, s, torch.float32)):
        raise AssertionError("torch.mul(q, scale) is not dequantize's function")
    b, by = bound(q.numel() * (1 + 4) + main_q * 4, q.numel())
    rows.append({"name": "dequantize", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/quant_blockwise.cu",
                 "replaces": "src/repro/kernels/quant_blockwise/kernel.py:42",
                 "launches": 0, "max_abs_err": derr, "ms": ms,
                 "device_kernels_ms": per_kernel,
                 "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                 "library_ms": library_ms,
                 "library_call": "torch.mul(q, scale[:, None])",
                 "timed_shape": [main_q, 1024, "float32"],
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
       ("ssd_scan", "bfloat16"): (1e-3, 1.6e-2)}
RG_BATCH, RG_PROMPT = 4, 2048          # recurrentgemma-9b: the local window
SL_BATCH, SL_PROMPT = 4, 2048          # stablelm-12b
MOE_BATCH, MOE_PROMPT = 4, 2048        # qwen2-moe-a2.7b, qwen3-moe-235b-a22b
QWEN3_LAYERS = 8                       # of 94: full qwen3 needs 470 GB
VLM_BATCH, VLM_PROMPT = 4, 2048        # internvl2-2b: 256 patches + 1792 text
WH_BATCH, WH_PROMPT = 4, 384           # whisper-tiny: + 32 stays within 448


def plain_f32(q, k, v, causal=True):
    """Flash attention's plain version on the same values widened to f32
    (exactly), rounded to the input dtype at the end: the kernel's
    arithmetic.  The plain version in bf16 also rounds the scores and
    weights to bf16, which the kernel (like the Pallas kernel) does not."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    return attention_ref(q.float(), k.float(), v.float(),
                         causal=causal).to(q.dtype)


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
    # a dist_tp rank's: 8 of the 16 q heads over the one kv head
    rg_tp_fa = (RG_BATCH, rg.num_heads // TP_WORLD, rg.num_kv_heads,
                RG_PROMPT, rg.resolved_head_dim)
    # stablelm-12b's prefill: GQA 32:8, hd 160
    sl = get_config("stablelm-12b")
    sl_fa = (SL_BATCH, sl.num_heads, sl.num_kv_heads, SL_PROMPT,
             sl.resolved_head_dim)
    # whisper-tiny: the encoder's unmasked attention over its 1500 frames
    # (ragged against the 64-row tiles) and the decoder's causal prompt,
    # hd 64; qwen3-moe's GQA 64:4 prefill, hd 128
    wh, q3 = get_config("whisper-tiny"), get_config("qwen3-moe-235b-a22b")
    wh_enc = (WH_BATCH, wh.num_heads, wh.num_kv_heads, wh.encoder_seq,
              wh.resolved_head_dim)
    wh_dec = (WH_BATCH, wh.num_heads, wh.num_kv_heads, WH_PROMPT,
              wh.resolved_head_dim)
    q3_fa = (MOE_BATCH, q3.num_heads, q3.num_kv_heads, MOE_PROMPT,
             q3.resolved_head_dim)
    # a dist_tp rank's qwen2-moe prefill: 8 of 16 q heads over 8 of 16 kv
    q2 = get_config("qwen2-moe-a2.7b")
    moe_tp_fa = (MOE_BATCH, q2.num_heads // TP_WORLD,
                 q2.num_kv_heads // TP_WORLD, MOE_PROMPT,
                 q2.resolved_head_dim)
    # a dist_tp rank's whisper-tiny prefill: 3 of 6 q and kv heads, the
    # encoder unmasked over its 1500 frames, the decoder's causal prompt
    wh_tp_enc = (WH_BATCH, wh.num_heads // TP_WORLD,
                 wh.num_kv_heads // TP_WORLD, wh.encoder_seq,
                 wh.resolved_head_dim)
    wh_tp_dec = (WH_BATCH, wh.num_heads // TP_WORLD,
                 wh.num_kv_heads // TP_WORLD, WH_PROMPT, wh.resolved_head_dim)
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
                ((2, 4, 2, 77, 64), bf16, False), ((1, 2, 1, 130, 16), bf16, True),
                # hd 160 (stablelm-12b): its serve shape on both routes, S
                # under one tile, ragged S, full attention, H/KV 2 and 4
                (sl_fa, bf16, True), (sl_fa, f32, True),
                ((1, 4, 2, 1, 160), bf16, True), ((2, 4, 2, 17, 160), bf16, True),
                ((2, 4, 2, 17, 160), f32, True), ((1, 8, 2, 333, 160), bf16, True),
                ((1, 8, 2, 333, 160), f32, True), ((1, 4, 2, 200, 160), bf16, False),
                ((1, 4, 2, 200, 160), f32, False), ((2, 32, 8, 130, 160), bf16, True),
                # the whisper encoder (full attention, S 1500), its decoder
                # and qwen3-moe's GQA 64:4 at their serve shapes
                (wh_enc, bf16, False), (wh_enc, f32, False),
                (wh_dec, bf16, True), (q3_fa, bf16, True),
                (rg_tp_fa, bf16, True), (rg_tp_fa, f32, True),
                (moe_tp_fa, bf16, True), (wh_tp_enc, bf16, False),
                (wh_tp_enc, f32, False), (wh_tp_dec, bf16, True),
                (wh_tp_dec, f32, True)]
    checked = []
    for (B, H, KV, S, hd), dtype, causal in fa_cases:
        q = randn((B, H, S, hd), dtype)
        k, v = randn((B, KV, S, hd), dtype), randn((B, KV, S, hd), dtype)
        err = check("flash_attention",
                    fk.flash_attention_kernel(q, k, v, causal=causal),
                    plain_f32(q, k, v, causal), dtype)
        checked.append([B, H, KV, S, hd, str(dtype).removeprefix("torch."),
                        "causal" if causal else "full", err])

    def time_flash(B, H, KV, S, hd, causal=True):
        """Kernel (bf16 route, and the f32 route on the same values), plain
        version and SDPA at one shape, causal or full."""
        q = randn((B, H, S, hd), bf16)
        k, v = randn((B, KV, S, hd), bf16), randn((B, KV, S, hd), bf16)

        def kern(*qkv):
            return fk.flash_attention_kernel(*qkv, causal=causal)

        vs_bf16_plain = float((kern(q, k, v).float() - attention_ref(
            q, k, v, causal=causal).float()).abs().max())
        ms = time_ms(lambda: kern(q, k, v), REPS)
        per_kernel = device_kernels_ms(lambda: kern(q, k, v))
        q32, k32, v32 = q.float(), k.float(), v.float()
        ms_f32 = time_ms(lambda: kern(q32, k32, v32), max(2, REPS // 4))
        # the f32 route's yardstick: SDPA on the same f32 values (TF32 off
        # for the phase), called with enable_gqa and with kv repeated
        f32_lib = {}
        try:
            f32_lib["scaled_dot_product_attention(is_causal, enable_gqa)"] = \
                time_ms(lambda: F.scaled_dot_product_attention(
                    q32, k32, v32, is_causal=causal, enable_gqa=True),
                    max(2, REPS // 4))
        except TypeError:      # a torch without enable_gqa
            pass
        kr32 = k32.repeat_interleave(H // KV, dim=1)
        vr32 = v32.repeat_interleave(H // KV, dim=1)
        f32_lib["scaled_dot_product_attention(is_causal), kv repeated"] = \
            time_ms(lambda: F.scaled_dot_product_attention(
                q32, kr32, vr32, is_causal=causal), max(2, REPS // 4))
        del q32, k32, v32, kr32, vr32
        plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=causal),
                           max(2, REPS // 10))
        try:
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), REPS)
            library_call = "scaled_dot_product_attention(is_causal, enable_gqa)"
        except TypeError:      # a torch without enable_gqa: repeat kv first
            kr = k.repeat_interleave(H // KV, dim=1)
            vr = v.repeat_interleave(H // KV, dim=1)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, kr, vr, is_causal=causal), REPS)
            library_call = "scaled_dot_product_attention(is_causal), kv repeated"
        pairs = S * (S + 1) // 2 if causal else S * S
        flops = 4 * B * H * pairs * hd
        b, by = bound(2 * (2 * B * H * S * hd + 2 * B * KV * S * hd), flops,
                      BF16_OPS_PER_S)
        return {"max_abs_err_vs_bf16_plain": vs_bf16_plain,
                "ms": ms, "ms_f32": ms_f32, "device_kernels_ms": per_kernel,
                "library_ms_f32": min(f32_lib.values()),
                "library_ms_f32_by_call": f32_lib,
                "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                "library_ms": library_ms, "library_call": library_call,
                "timed_shape": [B, H, KV, S, hd, "bfloat16",
                                "causal" if causal else "full"],
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
             # a dist_tp rank's prefill of it: 8 of 16 q heads
             "hd256_tp2": time_flash(*rg_tp_fa),
             "hd160": time_flash(*sl_fa),   # stablelm-12b's prefill
             # whisper-tiny's encoder (full) and decoder prompt, hd 64;
             # qwen3-moe's GQA 64:4
             "whisper_encoder": time_flash(*wh_enc, causal=False),
             "whisper_decoder": time_flash(*wh_dec),
             "qwen3_gqa": time_flash(*q3_fa),
             # a dist_tp rank's qwen2-moe prefill: 8 of 16 q and kv heads
             "moe_tp2": time_flash(*moe_tp_fa),
             # a dist_tp rank's whisper-tiny prefill: 3 of 6 q and kv heads
             "whisper_encoder_tp2": time_flash(*wh_tp_enc, causal=False),
             "whisper_decoder_tp2": time_flash(*wh_tp_dec),
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
    # a dist_tp rank's prefill: 16 of the 32 heads
    tp_ssd = main_ssd[:2] + (mb.ssm_heads // TP_WORLD,) + main_ssd[3:]
    ssd_cases = [(main_ssd, bf16), (main_ssd, f32), (red_ssd, f32),
                 (red_ssd, bf16), (tp_ssd, bf16), (tp_ssd, f32)]
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

    def ssd_work(B, S, H, P, N, Q):
        """(bytes, flops) of the function: C B^T once per (b, chunk) (the
        heads share one B/C group), then per (b, h, chunk) the decay mask,
        (G o L) xdt, the chunk state, the inter-chunk term and the state
        update."""
        nc, tri = S // Q, Q * (Q + 1) // 2
        flops = B * nc * tri * 2 * N + B * H * nc * (
            tri * (1 + 2 * P) + 4 * Q * N * P + Q * P + Q * N + P * N)
        nbytes = (2 * 2 * B * S * H * P + 2 * 2 * B * S * N + 4 * B * H * S
                  + 4 * B * H * P * N)
        return nbytes, flops

    def time_ssd(B, S, H, P, N, Q):
        """The bf16 kernel, its device time and the plain version at one
        shape, beside its bound."""
        ins = ssd_inputs(B, S, H, P, N, Q, bf16)
        b, by = bound(*ssd_work(B, S, H, P, N, Q), BF16_OPS_PER_S)
        return {"ms": time_ms(lambda: sk.ssd_scan_kernel(*ins), REPS),
                "device_kernels_ms": device_kernels_ms(
                    lambda: sk.ssd_scan_kernel(*ins)),
                "plain_ms": time_ms(lambda: ssd_scan_ref(*ins),
                                    max(2, REPS // 10)),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "timed_shape": [B, S, H, P, N, Q, "bfloat16"]}

    B, S, H, P, N, Q = main_ssd
    ins = ssd_inputs(B, S, H, P, N, Q, bf16)
    ms = time_ms(lambda: sk.ssd_scan_kernel(*ins), REPS)
    ins32 = [t.float() for t in ins]      # the f32 route on the same values
    ms_f32 = time_ms(lambda: sk.ssd_scan_kernel(*ins32), max(2, REPS // 4))
    del ins32
    per_kernel = device_kernels_ms(lambda: sk.ssd_scan_kernel(*ins))
    plain_ms = time_ms(lambda: ssd_scan_ref(*ins), max(2, REPS // 10))
    nbytes, flops = ssd_work(B, S, H, P, N, Q)
    b, by = bound(nbytes, flops, BF16_OPS_PER_S)
    del ins
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
                 "flops": flops, "checked_shapes": checked,
                 "tp2": time_ssd(*tp_ssd)})     # a dist_tp rank's

    # -- RG-LRU scan -----------------------------------------------------
    W_rg = rg.lru_width

    def rglru_inputs(B, S, W, dtype):
        """The CPU tests' distribution: a in (0, 0.98), b about 0.1."""
        a = torch.sigmoid(randn((B, S, W), f32)) * 0.98
        return a.to(dtype), (randn((B, S, W), f32) * 0.1).to(dtype)

    main_rg = (RG_BATCH, RG_PROMPT, W_rg)
    tp_rg = (RG_BATCH, RG_PROMPT, W_rg // TP_WORLD)    # a dist_tp rank's
    # serving and training, full width and a tp rank's; the CPU tests' and
    # the reduced config's; a prompt of 2000 (not a multiple of the tile)
    rg_shapes = [main_rg, tp_rg, (RG_TRAIN_BATCH, RG_TRAIN_SEQ, W_rg),
                 (RG_TRAIN_BATCH, RG_TRAIN_SEQ, W_rg // TP_WORLD),
                 (REDUCED_BATCH, REDUCED_PROMPT, rgr.lru_width),
                 (REDUCED_BATCH, 64, rgr.lru_width), (2, 128, 64),
                 (1, 256, 128), (3, 64, 32), (1, 2000, W_rg),
                 *RG_EDGE_SHAPES]
    # checked: [B, S, W, dtype, max abs err against the plain version];
    # planned: [B, S, W, dtype, band, bytes a copy] (``rk.launch_config``)
    rg_checked, rg_planned, rg_paths = [], [], set()
    for B, S, W in rg_shapes:
        for dtype in (f32, bf16):
            a, b_ = rglru_inputs(B, S, W, dtype)
            got = rk.rglru_scan_kernel(a, b_)
            again = rk.rglru_scan_kernel(a, b_)
            want = rglru_scan_ref(a, b_)
            err = max(float((x.float() - y.float()).abs().max())
                      for x, y in zip(got, want))
            if not all(torch.equal(x, y) and torch.equal(x, z)
                       for x, y, z in zip(got, want, again)):
                raise AssertionError(
                    f"rglru_scan {B, S, W} {dtype}: not bit-identical to the "
                    f"plain version, or across two calls (max abs err {err})")
            if not torch.equal(got[1], got[0][:, -1]):
                raise AssertionError("rglru_scan: the final state is not h[:, -1]")
            name = str(dtype).removeprefix("torch.")
            rg_checked.append([B, S, W, name, err])
            launch = rk.launch_config(B, S, W, dtype)
            rg_paths.add((launch["band"], launch["copy_bytes"]))
            rg_planned.append([B, S, W, name, launch["band"],
                               launch["copy_bytes"]])
    check_rg_paths("rglru_scan", rg_paths, {16, 4, 2})

    def time_rg(B, S, W):
        a, b_ = rglru_inputs(B, S, W, f32)
        b, by = bound(4 * (3 * B * S * W + B * W), 2 * B * S * W)
        return {**timed_launch(lambda: rk.rglru_scan_kernel(a, b_),
                               "rglru_scan_kernel", rk.launch_config(B, S, W)),
                "plain_ms": time_ms(lambda: rglru_scan_ref(a, b_), 2),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "timed_shape": [B, S, W, "float32"]}

    rows.append({"name": "rglru_scan", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/rg_lru.cu",
                 "replaces": "src/repro/kernels/rg_lru/kernel.py:40",
                 "launches": 0, "max_abs_err": max(r[4] for r in rg_checked),
                 **time_rg(*main_rg),
                 "checked_shapes": rg_checked,
                 "tp2": time_rg(*tp_rg)})       # a dist_tp rank's
    torch.cuda.synchronize()
    emit({"phase": "lm_kernels", "checked": [r["name"] for r in rows],
          "tf32": False, "tolerances": {**{f"{k[0]}/{k[1]}": v
                                           for k, v in TOL.items()},
                                        "rglru_scan": "bit-identical"},
          "card": card_line(), "rglru_scan_planned": rg_planned,
          "max_abs_err": {f"{k[0]}/{k[1]}": v for k, v in errs.items()},
          "seconds": time.perf_counter() - t_phase})
    return rows


TC_EDGES = (31, 32, 33, 63, 64, 65, 127, 128, 129)
# the sweep route's (bf16 at hd 160 and 256): 64-key dK/dV blocks walking
# 32-query tiles, 64-query dQ blocks walking 32-key tiles
SWEEP_EDGES = (1, 20, 31, 33, 63, 65, 127, 129)
# head slice counts timed at recurrentgemma-9b's training shape
SWEEP_SLICES = (1, 2, 4, 8, 16)
# the backward kernel's (atol, rtol): f32 against the plain formulas in f32;
# bf16 about two bf16 ulps (2**-7 relative) around the outputs' rounding,
# the plain formulas computing in f32 from the same bf16 values, output and
# row log-sum-exp.  The forward's row log-sum-exp: the f32 route against
# torch.logsumexp of the plain scores; the bf16 route sums l from P rounded
# to bf16, about 2**-9 relative, 2e-3 in the log.
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-3, 8e-3)}
LSE_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (4e-3, 0.0)}
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "minicpm-2b", 2, 1024, 4
# The CLI's default lr (3e-4) with its one-step warmup (steps // 10) makes
# full minicpm-2b's loss jump at the third step, with the plain attention
# path alike: the schedule's curve, not the kernels'; 2e-5 falls at every
# step (PERF.md §6).
TRAIN_LR = "2e-5"


def phase_flash_bwd() -> list[dict]:
    """flash_attention_bwd against the plain backward formulas
    (``attention_bwd_ref``) on the card, from the forward kernel's own
    output and row log-sum-exp, each held against the plain version first
    (the output against :func:`plain_f32` within flash's ``TOL``, the
    log-sum-exp against ``torch.logsumexp`` of the plain scores), at the
    training shapes (the train phase's: minicpm-2b's q (2,36,1024,64) and
    full demo-100m's (4,12,256,64), causal; yi-6b's GQA 32:4 at hd 128; hd
    160 and 256; whisper-tiny's unmasked S 1500; a tp rank's whisper-tiny
    encoder and decoder; S under one tile; ragged S), f32 and bf16; two
    calls must give the same bits.  At minicpm-2b's
    shape, times the kernel, its device time, the plain formulas and the
    backward of ``scaled_dot_product_attention`` (through
    ``torch.autograd.grad``; the port never calls it), and likewise the
    training forward (flash with its log-sum-exp) beside SDPA's forward.
    At hd 256 and 160 (recurrentgemma-9b's and stablelm-12b's training
    shapes, the sweep route) checks and times the kernel beside SDPA's
    backward, at recurrentgemma's at every count of ``SWEEP_SLICES`` too.
    Returns its row of the ``kernels`` line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_lse_ref,
    )

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    mc, yi = get_config(TRAIN_ARCH), get_config("yi-6b")
    wh, demo = get_config("whisper-tiny"), get_config("demo-100m")
    main_bwd = (TRAIN_BATCH, mc.num_heads, mc.num_kv_heads, TRAIN_SEQ,
                mc.resolved_head_dim)
    demo_bwd = (DEMO_BATCH, demo.num_heads, demo.num_kv_heads, DEMO_SEQ,
                demo.resolved_head_dim)
    yi_bwd = (1, yi.num_heads, yi.num_kv_heads, TRAIN_SEQ,
              yi.resolved_head_dim)
    wh_bwd = (2, wh.num_heads, wh.num_kv_heads, wh.encoder_seq,
              wh.resolved_head_dim)
    cases = [(main_bwd, bf16, True), (main_bwd, f32, True),
             (demo_bwd, bf16, True), (demo_bwd, f32, True),
             (yi_bwd, bf16, True), (yi_bwd, f32, True),
             ((1, 8, 2, 333, 160), bf16, True), ((1, 8, 2, 333, 160), f32, True),
             ((1, 4, 1, 200, 256), bf16, True), ((1, 4, 1, 200, 256), f32, True),
             ((1, 4, 1, 97, 256), f32, False), ((1, 4, 2, 130, 160), bf16, False),
             (wh_bwd, bf16, False), (wh_bwd, f32, False),
             ((2, 4, 2, 17, 128), bf16, True), ((1, 4, 2, 1, 64), f32, True),
             ((1, 2, 1, 5, 32), bf16, True),
             ((1, 4, 2, 1025, 64), bf16, True), ((1, 4, 2, 1025, 64), f32, True),
             ((2, 4, 2, 77, 32), f32, False), ((1, 2, 2, 130, 16), bf16, True),
             ((2, 8, 2, 40, 64), f32, True), ((1, 4, 4, 24, 16), f32, False)]
    # a dist_tp rank's recurrentgemma-9b training shape: 8 of 16 q heads
    rgt = get_config("recurrentgemma-9b")
    rg_tp_bwd = (RG_TRAIN_BATCH, rgt.num_heads // TP_WORLD, rgt.num_kv_heads,
                 RG_TRAIN_SEQ, rgt.resolved_head_dim)
    cases += [(rg_tp_bwd, bf16, True), (rg_tp_bwd, f32, True)]
    # a dist_tp rank's whisper-tiny training step at 3 of 6 q and kv heads:
    # the encoder's unmasked attention over its 1500 frames, the decoder's
    # causal attention over its prompt
    wh_tp_bwd = (WH_BATCH, wh.num_heads // TP_WORLD,
                 wh.num_kv_heads // TP_WORLD, wh.encoder_seq,
                 wh.resolved_head_dim)
    wh_tp_dec_bwd = (WH_BATCH, wh.num_heads // TP_WORLD,
                     wh.num_kv_heads // TP_WORLD, WH_PROMPT,
                     wh.resolved_head_dim)
    cases += [(wh_tp_bwd, bf16, False), (wh_tp_bwd, f32, False),
              (wh_tp_dec_bwd, bf16, True), (wh_tp_dec_bwd, f32, True)]
    # the tensor-core route's tile edges (64-row key tiles; query tiles of 64
    # rows, 32 at hd 128, in the dK/dV walk; key tiles of 64, 32 at hd 128,
    # in the dQ walk): one, two and three tiles, each ragged by one either
    # way; GQA 4:1 and 8:1; B 1 and 2; causal, and unmasked at 33 and 129
    cases += [((1 + S % 2, 8, 1 if S in (33, 64, 127) else 2, S, hd), bf16,
               S not in (33, 129))
              for hd in (64, 128) for S in TC_EDGES]
    # the sweep route's tile edges: S 1, under one tile, one and two tiles
    # each ragged by one either way; GQA 16:1 and 4:1 in turn; B 1 and 2;
    # causal, and unmasked at 33 and 127
    cases += [((1 + S % 2, 16, 1 if i % 2 == 0 else 4, S, hd), bf16,
               S not in (33, 127))
              for hd in fk.SWEEP_BWD_HEAD_DIMS
              for i, S in enumerate(SWEEP_EDGES)]
    errs = {"float32": 0.0, "bfloat16": 0.0}
    lse_errs = {"float32": 0.0, "bfloat16": 0.0}
    o_errs = {"float32": 0.0, "bfloat16": 0.0}
    checked = []
    for (B, H, KV, S, hd), dtype, causal in cases:
        name = str(dtype).removeprefix("torch.")
        routes = dict(fk.BWD_ROUTE_LAUNCHES)
        q = randn((B, H, S, hd), dtype)
        k, v = randn((B, KV, S, hd), dtype), randn((B, KV, S, hd), dtype)
        do = randn((B, H, S, hd), dtype)
        o, lse = fk.flash_attention_kernel(q, k, v, causal=causal,
                                           with_lse=True)
        want_o = plain_f32(q, k, v, causal)
        atol, rtol = TOL[("flash_attention", name)]
        torch.testing.assert_close(o.float(), want_o.float(), atol=atol,
                                   rtol=rtol, msg=lambda m: f"o: {m}")
        o_errs[name] = max(o_errs[name],
                           float((o.float() - want_o.float()).abs().max()))
        del want_o
        want_lse = attention_lse_ref(q.float(), k.float(), causal=causal)
        atol, rtol = LSE_TOL[name]
        torch.testing.assert_close(lse, want_lse, atol=atol, rtol=rtol)
        lse_errs[name] = max(lse_errs[name],
                             float((lse - want_lse).abs().max()))
        got = fk.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                            causal=causal)
        route = [r for r, n in fk.BWD_ROUTE_LAUNCHES.items()
                 if n != routes[r]]
        if route != [fk.bwd_route(dtype, hd)]:
            raise AssertionError(f"flash_attention_bwd {B, H, KV, S, hd} "
                                 f"{name}: routes {route}")
        want = attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        atol, rtol = BWD_TOL[name]
        err = 0.0
        for what, a, b in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                       rtol=rtol, msg=lambda m: f"{what}: {m}")
            err = max(err, float((a.float() - b.float()).abs().max()))
        again = fk.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                              causal=causal)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {B, H, KV, S, hd}: "
                                 f"two calls differ")
        errs[name] = max(errs[name], err)
        checked.append([B, H, KV, S, hd, name, "causal" if causal else "full",
                        route[0], err])

    # timed at minicpm-2b's training shape, bf16 (the train phase's route)
    B, H, KV, S, hd = main_bwd
    q = randn((B, H, S, hd), bf16)
    k, v = randn((B, KV, S, hd), bf16), randn((B, KV, S, hd), bf16)
    do = randn((B, H, S, hd), bf16)
    o, lse = fk.flash_attention_kernel(q, k, v, with_lse=True)

    # the training forward (flash with its log-sum-exp write) at this shape,
    # beside its plain version (output and log-sum-exp) and SDPA's forward
    def fwd():
        return fk.flash_attention_kernel(q, k, v, causal=True, with_lse=True)

    pairs = S * (S + 1) // 2
    fwd_flops = 4 * B * H * pairs * hd
    fb, fby = bound(2 * (2 * B * H * S * hd + 2 * B * KV * S * hd)
                    + 4 * B * H * S, fwd_flops, BF16_OPS_PER_S)
    try:
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), REPS)
    except TypeError:           # a torch without enable_gqa (here H == KV)
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), REPS)
    forward = {"ms": time_ms(fwd, REPS), "device_kernels_ms":
               device_kernels_ms(fwd), "plain_ms": time_ms(
                   lambda: (plain_f32(q, k, v),
                            attention_lse_ref(q.float(), k.float())),
                   max(2, REPS // 10)),
               "bound_ms": fb, "bound_by": fby, "library_ms": sdpa_fwd,
               "library_call": "scaled_dot_product_attention(is_causal, "
                               "enable_gqa), no log-sum-exp"}

    def kern(*t, slices=None, causal=True):
        return fk.flash_attention_bwd_kernel(*t, causal=causal, slices=slices)

    ms = time_ms(lambda: kern(q, k, v, o, lse, do), REPS)
    per_kernel = device_kernels_ms(lambda: kern(q, k, v, o, lse, do))
    f32_in = [t.float() for t in (q, k, v, o)] + [lse, do.float()]
    ms_f32 = time_ms(lambda: kern(*f32_in), max(2, REPS // 4))
    per_kernel_f32 = device_kernels_ms(lambda: kern(*f32_in), 4)
    del f32_in
    plain_ms = time_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do),
                       max(2, REPS // 10))
    def sdpa_bwd_call(causal=True):
        return ("autograd.grad of scaled_dot_product_attention("
                + ("is_causal, " if causal else "") + "enable_gqa)")

    library_call = sdpa_bwd_call()
    library_ms = sdpa_bwd_ms(q, k, v, do, REPS)
    library_ms_f32 = sdpa_bwd_ms(q.float(), k.float(), v.float(), do.float(),
                                 max(2, REPS // 4))
    flops = int(2.5 * fwd_flops)
    nbytes = 2 * (4 * B * H * S * hd + 4 * B * KV * S * hd) + 4 * B * H * S
    b, by = bound(nbytes, flops, BF16_OPS_PER_S)

    # the sweep route at recurrentgemma-9b's training shape (hd 256, MQA 16:1,
    # the train phase's launches of it) at each slice count, and at
    # stablelm-12b's heads (hd 160, GQA 32:8); the hd-64 tensor-core route at
    # a whisper-tiny tp rank's unmasked encoder and causal decoder: checked
    # against the plain formulas, timed beside them and SDPA's backward
    def sweep_row(B, H, KV, S, hd, slice_counts, causal=True):
        if fk.bwd_route(bf16, hd) != "tensor_cores":
            raise AssertionError(f"flash_attention_bwd at hd {hd}: route "
                                 f"{fk.bwd_route(bf16, hd)}")
        sq, sdo = randn((B, H, S, hd), bf16), randn((B, H, S, hd), bf16)
        sk, sv = randn((B, KV, S, hd), bf16), randn((B, KV, S, hd), bf16)
        so, slse = fk.flash_attention_kernel(sq, sk, sv, causal=causal,
                                             with_lse=True)
        args = (sq, sk, sv, so, slse, sdo)
        want = attention_bwd_ref(*args, causal=causal)
        auto = fk.bwd_slices(bf16, B, H, KV, S, hd, torch.cuda.
                             get_device_properties(dev).multi_processor_count)
        atol, rtol = BWD_TOL["bfloat16"]
        by_slices = {}
        for n in sorted({auto, *slice_counts}):
            got = fk.flash_attention_bwd_kernel(*args, causal=causal,
                                                slices=n)
            err = 0.0
            for what, a, w in zip(("dq", "dk", "dv"), got, want):
                torch.testing.assert_close(
                    a.float(), w.float(), atol=atol, rtol=rtol,
                    msg=lambda m: f"{what} at slices {n}: {m}")
                err = max(err, float((a.float() - w.float()).abs().max()))
            again = fk.flash_attention_bwd_kernel(*args, causal=causal,
                                                  slices=n)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash_attention_bwd {B, H, KV, S, hd} "
                                     f"slices {n}: two calls differ")
            del got, again
            errs["bfloat16"] = max(errs["bfloat16"], err)
            mask = "causal" if causal else "full"
            checked.append([B, H, KV, S, hd, "bfloat16", mask,
                            "tensor_cores", err, f"slices {n}"])
            by_slices[n] = {
                "max_abs_err": err,
                "ms": time_ms(lambda: kern(*args, slices=n, causal=causal),
                              REPS),
                "device_kernels_ms": device_kernels_ms(
                    lambda: kern(*args, slices=n, causal=causal))}
        del want
        pairs = S * (S + 1) // 2 if causal else S * S
        flops = int(2.5 * 4 * B * H * pairs * hd)
        nbytes = 2 * (4 * B * H * S * hd + 4 * B * KV * S * hd) + 4 * B * H * S
        bnd, bnd_by = bound(nbytes, flops, BF16_OPS_PER_S)
        out = {"timed_shape": [B, H, KV, S, hd, "bfloat16",
                               "causal" if causal else "full"],
               "route": "tensor_cores", "slices": auto,
               "ms": by_slices[auto]["ms"],
               "device_kernels_ms": by_slices[auto]["device_kernels_ms"],
               "plain_ms": time_ms(lambda: attention_bwd_ref(
                   *args, causal=causal), 2),
               "bound_ms": bnd, "bound_by": bnd_by, "flops": flops,
               "bytes": nbytes,
               "library_ms": sdpa_bwd_ms(sq, sk, sv, sdo, REPS, causal),
               "library_call": sdpa_bwd_call(causal),
               "occupancy": fk.flash_attention_bwd_occupancy(hd)}
        if len(by_slices) > 1:
            out["by_slices"] = by_slices
        return out

    rgc, slc = get_config("recurrentgemma-9b"), get_config("stablelm-12b")
    sweeps = {
        "hd256": sweep_row(RG_TRAIN_BATCH, rgc.num_heads, rgc.num_kv_heads,
                           RG_TRAIN_SEQ, rgc.resolved_head_dim, SWEEP_SLICES),
        "hd160": sweep_row(2, slc.num_heads, slc.num_kv_heads, TRAIN_SEQ,
                           slc.resolved_head_dim, ()),
        "hd256_tp2": sweep_row(*rg_tp_bwd, ()),
        "whisper_encoder_tp2": sweep_row(*wh_tp_bwd, (), causal=False),
        "whisper_decoder_tp2": sweep_row(*wh_tp_dec_bwd, ())}
    torch.cuda.synchronize()
    emit({"phase": "lm_kernels_bwd", "card": card_line(),
          "routes": dict(fk.BWD_ROUTE_LAUNCHES), "checked": checked,
          "tolerances": {"flash_attention_bwd": BWD_TOL, "lse": LSE_TOL,
                         "o": {n: TOL[("flash_attention", n)]
                               for n in ("float32", "bfloat16")}},
          "max_abs_err": errs, "lse_max_abs_err": lse_errs,
          "o_max_abs_err": o_errs,
          "bit_identical_reruns": True, "tf32": False,
          "seconds": time.perf_counter() - t_phase})
    return [{"name": "flash_attention_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             # no Pallas backward: the reference differentiates its XLA
             # attention (train.py:63, jax.value_and_grad)
             "replaces": "src/repro/models/attention.py:54",
             "launches": 0, "max_abs_err": max(errs.values()),
             "max_abs_err_f32": errs["float32"],
             "max_abs_err_bf16": errs["bfloat16"],
             "lse_max_abs_err": lse_errs, "o_max_abs_err": o_errs,
             "ms": ms, "ms_f32": ms_f32, "device_kernels_ms": per_kernel,
             "device_kernels_ms_f32": per_kernel_f32,
             # the CUDA-core route (f32 here; bf16 took it too before the
             # tensor-core route) -> the tensor-core route, this run's
             "cuda_cores_to_tensor_cores": {
                 "ms": f"{ms_f32} -> {ms}",
                 "device_ms": f"{sum(per_kernel_f32.values())} -> "
                              f"{sum(per_kernel.values())}"},
             "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
             "library_ms": library_ms, "library_call": library_call,
             # SDPA's backward on the f32 inputs (TF32 off), beside ms_f32
             "library_ms_f32": library_ms_f32,
             "timed_shape": [B, H, KV, S, hd, "bfloat16", "causal"],
             "forward_with_lse": forward, "flops": flops, "bytes": nbytes,
             "tensor_cores_hd256": sweeps["hd256"],
             "tensor_cores_hd160": sweeps["hd160"],
             # a dist_tp rank's recurrentgemma-9b step: 8 of 16 q heads
             "tensor_cores_hd256_tp2": sweeps["hd256_tp2"],
             # a dist_tp rank's whisper-tiny encoder (unmasked) and decoder
             # (causal): 3 of 6 heads
             "tensor_cores_whisper_encoder_tp2":
                 sweeps["whisper_encoder_tp2"],
             "tensor_cores_whisper_decoder_tp2":
                 sweeps["whisper_decoder_tp2"],
             "checked_shapes": checked}]


def sdpa_bwd_ms(q, k, v, do, reps: int, causal: bool = True) -> float:
    """CUDA-event time of ``autograd.grad`` of SDPA (causal, or unmasked)
    with ``enable_gqa`` at these inputs: the library yardstick of the flash
    backward, never called by the port."""
    import torch
    import torch.nn.functional as F
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                         enable_gqa=True)
    return time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                               retain_graph=True), reps)


# the scan backwards against their plain backward formulas in f32 from the
# same values: the RG-LRU bit for bit; the SSD in f32 within 1e-4 of each
# output's max-abs (sums in another order), and from bf16 inputs (dxdt, dBm
# and dCm rounded once to bf16) within 2**-7 of each output's max-abs, about
# two bf16 ulps of its largest element, dcums (f32) within 1e-4
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# the bf16 route's tile launch at mamba2-370m's training shape: at most 113
# KiB of shared memory a block, so that two blocks share an SM (228 KiB, 1
# KiB reserved a block)
SSD_BWD_TILE_SMEM = 113 * 1024


def ssd_bwd_work(B, S, H, P, N, Q, dtype_bytes, with_dstate):
    """(flops, bytes) of the SSD backward's formulas (ssd_scan_bwd_ref):
    C B^T's lower triangle once per (b, chunk) (the heads share one B/C
    group); per (b, h, chunk) the decay mask, (G o L)^T dY, tril(dY X^T),
    dG B, dG^T C and the row and column sums over the triangle, and the
    (Q, P, N) products dY s, X dS, (B o w) dS^T, dY^T (C o e) and the
    recomputed chunk state X^T (B o w) with their scalings; the heads'
    sums of dB and dC.  Bytes: each input read once, each output written
    once."""
    nc, tri = S // Q, Q * (Q + 1) // 2
    flops = B * nc * tri * 2 * N + B * H * nc * (
        tri * (4 * P + 4 * N + 7) + 10 * Q * P * N + 12 * Q * N + 6 * P * N
        + 6 * Q)
    nbytes = (2 * 2 * dtype_bytes * B * S * H * P + 2 * 2 * dtype_bytes * B * S * N
              + 2 * 4 * B * H * S + (4 * B * H * P * N if with_dstate else 0))
    return flops, nbytes


def phase_scan_bwd() -> list[dict]:
    """The scans' backward kernels against their plain backward formulas on
    the card.  rglru_scan_bwd (from the forward kernel's h) bit for bit at
    recurrentgemma-9b's training and serving shapes, full width and a tp
    rank's, with the final state's gradient given and None, and at S 1 and
    17, W 100 and 130, B 1 and ``RG_EDGE_SHAPES`` (both bands and both copy
    paths of its ring); timed at both training widths, with the grid and
    shared memory a block of its launch in a trace, the event time's gap to
    the device time and where the trace puts it.  ssd_scan_bwd in f32 and bf16 at
    mamba2-370m's training shape (4, 2048, 32 heads, P 64, N 128, Q 256: 8
    chunks), the final state's gradient None (the training path's) and
    given, and at one chunk, Q 100 (ragged against the 64-row tiles), H 3,
    10 and 12 (not multiples of the 8-head block), P 16 and 128, N 16, 48
    and 64, B 1, and in bf16 at the tensor-core route's edges (Q 32, 64,
    128 and 192, H 1 and 17, S of one ragged chunk, N 112), within
    ``SSD_BWD_TOL``.  Two calls give the same bits.  Each is timed at its
    training shape (CUDA events, and each launch's device time from
    torch.profiler) beside its plain version and its bound; the SSD
    backward on its bf16 inputs (the training path's) and on f32 inputs,
    with the bf16 route's shared memory a block and resident blocks an SM.
    Returns their rows of the ``kernels`` line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.rg_lru import kernel as rk
    from repro_torch.kernels.rg_lru.ref import rglru_scan_bwd_ref
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ops import arrange
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(shape, dtype=f32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # -- RG-LRU backward -------------------------------------------------
    rg = get_config("recurrentgemma-9b")
    main_rg = (RG_TRAIN_BATCH, RG_TRAIN_SEQ, rg.lru_width)
    tp_rg = (RG_TRAIN_BATCH, RG_TRAIN_SEQ, rg.lru_width // TP_WORLD)

    def rg_inputs(B, S, W, with_dlast):
        a = torch.sigmoid(randn((B, S, W))) * 0.98
        h, _ = rk.rglru_scan_kernel(a, randn((B, S, W)) * 0.1)
        return a, h, randn((B, S, W)), randn((B, W)) if with_dlast else None

    # training and serving, full width and a dist_tp rank's 2048 of 4096,
    # each with the final state's gradient given and None; S 1 and 17, W
    # 100 and 130, B 1; the forward's edge shapes
    serve_rg = (RG_BATCH, RG_PROMPT, rg.lru_width)
    serve_tp_rg = (RG_BATCH, RG_PROMPT, rg.lru_width // TP_WORLD)
    rg_cases = [(shape, with_dlast)
                for shape in (main_rg, tp_rg, serve_rg, serve_tp_rg)
                for with_dlast in (False, True)]
    rg_cases += [((1, 1, 4096), True), ((2, 17, 100), False),
                 ((1, 17, 130), True), ((3, 77, 33), False),
                 ((1, 2048, 128), True)]
    rg_cases += [(shape, i % 2 == 0) for i, shape in enumerate(RG_EDGE_SHAPES)]
    # checked: [B, S, W, dlast, max abs err against the plain backward];
    # planned: [B, S, W, dlast, band, bytes a copy] (``rk.launch_config``)
    rg_checked, rg_planned, rg_paths = [], [], set()
    for (B, S, W), with_dlast in rg_cases:
        ins = rg_inputs(B, S, W, with_dlast)
        got = rk.rglru_scan_bwd_kernel(*ins)
        want = rglru_scan_bwd_ref(*ins)
        again = rk.rglru_scan_bwd_kernel(*ins)
        if not all(torch.equal(x, y) and torch.equal(x, z)
                   for x, y, z in zip(got, want, again)):
            raise AssertionError(f"rglru_scan_bwd {B, S, W} dlast "
                                 f"{with_dlast}: not bit-identical to the "
                                 f"plain backward, or across two calls")
        launch = rk.launch_config(B, S, W, backward=True)
        rg_paths.add((launch["band"], launch["copy_bytes"]))
        rg_checked.append([B, S, W, with_dlast, max(
            float((x - y).abs().max()) for x, y in zip(got, want))])
        rg_planned.append([B, S, W, with_dlast, launch["band"],
                           launch["copy_bytes"]])
    check_rg_paths("rglru_scan_bwd", rg_paths, {16, 4})

    def time_rg(B, S, W):
        a, h, dh, _ = rg_inputs(B, S, W, False)
        # a, h, dh read, da and db written; two products and a sum an
        # element
        b, by = bound(5 * 4 * B * S * W, 3 * B * S * W)
        return {**timed_launch(lambda: rk.rglru_scan_bwd_kernel(a, h, dh),
                               "rglru_scan_bwd_kernel",
                               rk.launch_config(B, S, W, backward=True)),
                "plain_ms": time_ms(lambda: rglru_scan_bwd_ref(a, h, dh), 2),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "timed_shape": [B, S, W, "float32"]}

    rg_main = time_rg(*main_rg)
    rg_tp = time_rg(*tp_rg)

    # -- SSD backward ----------------------------------------------------
    mb = get_config(MAMBA_TRAIN_ARCH)
    main_ssd = (MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ, mb.ssm_heads,
                mb.ssm_headdim, mb.ssm_state, mb.ssm_chunk)

    def ssd_inputs(B, S, H, P, N, Q, dtype, with_dstate):
        dt = F.softplus(randn((B, S, H)) - 1)
        A = -torch.exp(randn((H,)) * 0.3)
        ins = arrange(randn((B, S, H, P), dtype), dt, A,
                      randn((B, S, N), dtype), randn((B, S, N), dtype), Q)
        return (*ins, randn(ins[0].shape, dtype),
                randn((B, H, P, N)) if with_dstate else None)

    cases = [(main_ssd, bf16, False), (main_ssd, f32, False),
             (main_ssd, bf16, True), ((2, 256, 4, 64, 128, 256), bf16, True),
             ((1, 256, 3, 64, 128, 256), f32, False),
             ((1, 500, 12, 64, 128, 100), bf16, False),
             ((1, 500, 12, 64, 128, 100), f32, True),
             ((1, 512, 10, 128, 64, 256), bf16, True),
             ((1, 512, 10, 128, 128, 256), f32, False),
             ((3, 200, 3, 16, 48, 100), f32, True),
             ((2, 128, 9, 16, 16, 64), bf16, False),
             ((2, 64, 8, 16, 16, 32), f32, True),
             ((1, 256, 2, 32, 64, 64), bf16, True)]
    # the tensor-core route's edges: Q against its 64-row tiles and 32-row
    # halves (32, 64, 128, 192), one head and a last head block of one (H 1,
    # 17), S of exactly one chunk (ragged against the tiles), N 112 (a state
    # step of 16 columns)
    cases += [((1, 256, 4, 64, 128, 32), bf16, True),
              ((1, 256, 3, 64, 128, 64), bf16, False),
              ((2, 512, 5, 64, 128, 128), bf16, True),
              ((1, 384, 1, 64, 128, 192), bf16, False),
              ((2, 512, 17, 64, 128, 256), bf16, True),
              ((1, 100, 6, 32, 112, 100), bf16, True)]
    # a dist_tp rank's mamba2-370m training shape: 16 of the 32 heads
    tp_ssd = main_ssd[:2] + (mb.ssm_heads // TP_WORLD,) + main_ssd[3:]
    cases += [(tp_ssd, bf16, False), (tp_ssd, f32, False)]
    errs = {"float32": 0.0, "bfloat16": 0.0}     # of each output's max-abs
    abs_errs = {"float32": 0.0, "bfloat16": 0.0}
    checked = []
    for (B, S, H, P, N, Q), dtype, with_dstate in cases:
        name = str(dtype).removeprefix("torch.")
        ins = ssd_inputs(B, S, H, P, N, Q, dtype, with_dstate)
        got = sk.ssd_scan_bwd_kernel(*ins)
        want = ssd_scan_bwd_ref(*ins)
        err = 0.0
        for what, x, y in zip(("dxdt", "dBm", "dCm", "dcums"), got, want):
            scale = max(float(y.float().abs().max()), 1e-30)
            e = float((x.float() - y.float()).abs().max()) / scale
            tol = SSD_BWD_TOL["float32" if x.dtype == f32 else name]
            if x.dtype != y.dtype or not e <= tol:
                raise AssertionError(f"ssd_scan_bwd {B, S, H, P, N, Q} "
                                     f"{name} {what}: {e} of max-abs {scale}")
            err = max(err, e)
            abs_errs[name] = max(abs_errs[name], e * scale)
        again = sk.ssd_scan_bwd_kernel(*ins)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"ssd_scan_bwd {B, S, H, P, N, Q} {name}: "
                                 f"two calls differ")
        errs[name] = max(errs[name], err)
        checked.append([B, S, H, P, N, Q, name, with_dstate, err])
        del ins, got, want, again
    def time_ssd_tp(B, S, H, P, N, Q):
        ins = ssd_inputs(B, S, H, P, N, Q, bf16, False)
        b, by = bound(*reversed(ssd_bwd_work(B, S, H, P, N, Q, 2, False)),
                      BF16_OPS_PER_S)
        return {"ms": time_ms(lambda: sk.ssd_scan_bwd_kernel(*ins), REPS),
                "device_kernels_ms": device_kernels_ms(
                    lambda: sk.ssd_scan_bwd_kernel(*ins)),
                "plain_ms": time_ms(lambda: ssd_scan_bwd_ref(*ins),
                                    max(2, REPS // 10)),
                "bound_ms": b, "bound_by": by, "library_ms": None,
                "timed_shape": [B, S, H, P, N, Q, "bfloat16"]}

    ssd_tp = time_ssd_tp(*tp_ssd)
    B, S, H, P, N, Q = main_ssd
    ins = ssd_inputs(B, S, H, P, N, Q, bf16, False)
    ssd_ms = time_ms(lambda: sk.ssd_scan_bwd_kernel(*ins), REPS)
    ssd_dev = device_kernels_ms(lambda: sk.ssd_scan_bwd_kernel(*ins))
    ssd_plain = time_ms(lambda: ssd_scan_bwd_ref(*ins), max(2, REPS // 10))
    ins32 = [t if t is None or t.dtype == f32 else t.float() for t in ins]
    ssd_ms_f32 = time_ms(lambda: sk.ssd_scan_bwd_kernel(*ins32),
                         max(2, REPS // 4))
    ssd_dev_f32 = device_kernels_ms(lambda: sk.ssd_scan_bwd_kernel(*ins32), 4)
    del ins, ins32
    occupancy = sk.ssd_scan_bwd_occupancy(P, N, Q)
    if occupancy["tiles"]["smem_bytes"] > SSD_BWD_TILE_SMEM:
        raise AssertionError(f"ssd_scan_bwd tile launch: {occupancy}")
    flops, nbytes = ssd_bwd_work(B, S, H, P, N, Q, 2, False)
    ssd_bound, ssd_by = bound(nbytes, flops, BF16_OPS_PER_S)
    torch.cuda.synchronize()
    emit({"phase": "lm_kernels_bwd", "kernels": ["rglru_scan_bwd",
                                                 "ssd_scan_bwd"],
          "card": card_line(), "rglru_scan_bwd_checked": rg_checked,
          "rglru_scan_bwd_planned": rg_planned,
          "ssd_scan_bwd_checked": checked,
          "tolerances": {"rglru_scan_bwd": "bit-identical",
                         "ssd_scan_bwd_of_max_abs": SSD_BWD_TOL},
          "ssd_scan_bwd_err_of_max_abs": errs,
          "ssd_scan_bwd_max_abs_err": abs_errs, "bit_identical_reruns": True,
          "seconds": time.perf_counter() - t_phase})
    return [{"name": "rglru_scan_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/rg_lru.cu",
             # no Pallas backward: the reference differentiates its
             # associative scan (train.py:63, jax.value_and_grad)
             "replaces": "src/repro/models/griffin.py:55",
             "launches": 0, "max_abs_err": max(r[4] for r in rg_checked),
             **rg_main,
             "tp2": rg_tp,          # a dist_tp rank's: 2048 of 4096
             "checked_shapes": rg_checked},
            {"name": "ssd_scan_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
             # no Pallas backward: the reference differentiates its XLA
             # ssd_chunked (train.py:63, jax.value_and_grad)
             "replaces": "src/repro/models/ssm.py:43",
             "launches": 0, "max_abs_err": max(abs_errs.values()),
             "max_abs_err_f32": abs_errs["float32"],
             "max_abs_err_bf16": abs_errs["bfloat16"],
             "err_of_max_abs": errs, "ms": ssd_ms,
             "ms_f32": ssd_ms_f32, "device_kernels_ms": ssd_dev,
             "device_kernels_ms_f32": ssd_dev_f32,
             # the bf16 route's launches: shared memory a block, resident
             # blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
             "occupancy": occupancy,
             "plain_ms": ssd_plain, "bound_ms": ssd_bound,
             "bound_by": ssd_by, "library_ms": None, "flops": flops,
             "bytes": nbytes, "timed_shape": [*main_ssd, "bfloat16"],
             "tp2": ssd_tp,         # a dist_tp rank's: 16 of 32 heads
             "checked_shapes": checked}]


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


def write_notebooks(tmp: Path) -> tuple[Path, Path]:
    """The main path's two notebooks as .ipynb files under ``tmp``."""
    main_nb = tmp / "spacenet7_tiles.ipynb"
    main_nb.write_text(json.dumps(ipynb("spacenet7-tiles", [
        (SETUP, 0.3), (KMEANS, 600.0), (TWEAK, 0.1), (KMEANS, 600.0),
        (REPORT, 0.2)])))
    quant_nb = tmp / "quant_field.ipynb"
    quant_nb.write_text(json.dumps(ipynb("quant-field", [
        (QUANT_SETUP, 1.0), (QUANT_HEAVY, 300.0), (QUANT_REPORT, 0.2)])))
    return main_nb, quant_nb


def source_field():
    """The quant8 leaf as the quant notebook's setup cell makes it."""
    import torch
    return torch.randn(FIELD_ELEMS, generator=torch.Generator(
        device="cuda").manual_seed(SEED + 1), device="cuda")


def phase_session(tmp: Path) -> dict:
    import numpy as np
    import torch

    import repro_torch.core.reducer as red
    from repro_torch.kernels.hash_delta import kernel as hk
    from repro_torch.kernels.hash_delta import ops as hops
    from repro_torch.kernels.quant_blockwise import kernel as qk
    from repro_torch.launch.notebook import run_notebook

    main_nb, quant_nb = write_notebooks(tmp)

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
    src_field = source_field().cpu().numpy()
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


# run in the socket child: its own kernels' launch counts, read home by FETCH
CHILD_COUNTS = """
import repro_torch.kernels.hash_delta.kernel as _hk
import repro_torch.kernels.quant_blockwise.kernel as _qk
child_launches = {**_hk.LAUNCHES, **_qk.LAUNCHES}
"""


def phase_socket(tmp: Path) -> dict:
    """The main path's notebooks with ``transport="socket"``: the remote env
    is a child ``repro_torch.core.remote_worker --device cuda`` on the same
    card, and every migration streams wire frames over TCP.  Checks: the
    decisions and the migrated names equal those of a loopback run with
    knowledge probing off (socket mode turns it off); the forward leg
    carries the reduced set (>= 100 MiB of CUDA tensors, codec ``none``),
    the re-migration after the one-element change only the changed leaf's
    dirty chunk, and a return trip follows; the edge maps read back from
    the child are bit-equal to what left, and the quant8 field that comes
    home equals a local quantize/dequantize round trip of the source; the
    parent's hash, compare and quantize counts and the child's hash and
    dequantize counts rise in the window (the child streams home with its
    own codec, zlib, as the reference's socket mode sets it, so the parent
    dequantizes nothing); the child exits 0 at BYE.  Returns the parent's
    launches."""
    import numpy as np
    import torch

    from repro_torch.core import migration as mig
    from repro_torch.core.transport import SubprocessEnv
    from repro_torch.kernels.hash_delta import kernel as hk
    from repro_torch.kernels.quant_blockwise import kernel as qk
    from repro_torch.launch.notebook import run_notebook

    t_phase = time.perf_counter()
    main_nb, quant_nb = write_notebooks(tmp)
    runs = ((main_nb, "none"), (quant_nb, "quant8+zstd"))
    nb_name = {main_nb: "spacenet7-tiles", quant_nb: "quant-field"}
    loopback, loop_walls = {}, {}
    for nb, codec in runs:
        t0 = time.perf_counter()
        loopback[nb], _ = run_notebook(str(nb), sessions=2, codec=codec,
                                       policy="single", use_knowledge=False,
                                       device="cuda")
        torch.cuda.synchronize()
        loop_walls[nb.stem] = time.perf_counter() - t0

    captured, legs, child_start = {}, [], []
    orig_close = mig.HybridRuntime.close
    orig_migrate = mig.MigrationEngine.migrate
    orig_spawn = SubprocessEnv.__init__

    def spawn(self, *args, **kw):
        """Time a child's start: spawn, imports, connect back, HELLO."""
        t0 = time.perf_counter()
        orig_spawn(self, *args, **kw)
        child_start.append(time.perf_counter() - t0)

    def fetch(env, reducer, names):
        ser, _, _, _ = env.peer.fetch_state(names=set(names), delta=False)
        return reducer.deserialize(ser)

    def close(self):
        remote = self.envs["remote"]
        if not isinstance(remote, SubprocessEnv):
            raise AssertionError("socket mode did not spawn a child env")
        reducer = self.engine.reducer
        remote.peer.execute(CHILD_COUNTS)
        got = {"child_launches":
               fetch(remote, reducer, ["child_launches"])["child_launches"],
               "local": self.envs["local"].state.ns, "env": remote}
        if self.nb.name == "spacenet7-tiles":
            got["edges_home"] = fetch(remote, reducer, ["edges"])["edges"]
        captured[self.nb.name] = got
        return orig_close(self)

    def wire_total(src, dst) -> int:
        """Bytes this process has sent and received on the child's socket."""
        peer = getattr(src, "peer", None) or getattr(dst, "peer", None)
        return peer.transport.bytes_sent + peer.transport.bytes_recv

    def migrate(self, src, dst, *args, **kw):
        before = wire_total(src, dst)
        t0 = time.perf_counter()
        res = orig_migrate(self, src, dst, *args, **kw)
        legs.append({"src": res.src, "dst": res.dst,
                     "names": list(res.names[:6]), "nbytes": res.nbytes,
                     "wire_bytes": wire_total(src, dst) - before,
                     "frames": res.wire_frames,
                     "stream_wall_seconds": res.wall_seconds,
                     "wall_seconds": time.perf_counter() - t0,
                     "noop": res.noop})
        return res
    mig.HybridRuntime.close = close
    mig.MigrationEngine.migrate = migrate
    SubprocessEnv.__init__ = spawn

    torch.cuda.synchronize()
    hk.reset_launches()
    qk.reset_launches()
    reports, walls, leg_ix = {}, {}, {}
    try:
        for nb, codec in runs:
            t0 = time.perf_counter()
            n0 = len(legs)
            reports[nb], _ = run_notebook(str(nb), sessions=2, codec=codec,
                                          policy="single", transport="socket",
                                          device="cuda")
            torch.cuda.synchronize()
            walls[nb] = time.perf_counter() - t0
            leg_ix[nb] = (n0, len(legs))
    finally:
        mig.HybridRuntime.close = orig_close
        mig.MigrationEngine.migrate = orig_migrate
        SubprocessEnv.__init__ = orig_spawn
    launches = {**hk.LAUNCHES, **qk.LAUNCHES}
    by_route = dict(hk.ROUTE_LAUNCHES)

    # -- what came out -----------------------------------------------------
    def placements(report) -> dict:
        """Where each cell ran, from its decision note ("performance/single:
        local ..." or "...: remote ..."); the note's modeled migration
        seconds follow the bytes, which differ on the way home (the child
        ships with its own codec)."""
        return {cid: note.split(": ", 1)[1].split()[0]
                for cid, note in report["decisions"].items()}

    for nb, _ in runs:
        a, b = reports[nb], loopback[nb]
        if a["transport"] != "socket" or placements(a) != placements(b):
            raise AssertionError(f"{nb.name}: socket decisions differ from "
                                 f"the loopback run's: {a['decisions']} vs "
                                 f"{b['decisions']}")
        names = [[m["src"], m["dst"], m["names"]] for m in a["migration_log"]]
        want = [[m["src"], m["dst"], m["names"]] for m in b["migration_log"]]
        if names != want:
            raise AssertionError(f"{nb.name}: socket migrations {names}, "
                                 f"loopback {want}")
    exit_codes = {nb.stem: captured[nb_name[nb]]["env"].proc.returncode
                  for nb, _ in runs}
    if any(code != 0 for code in exit_codes.values()):
        raise AssertionError(f"a child did not exit 0 at BYE: {exit_codes}")
    log = reports[main_nb]["migration_log"]
    fwd = [m for m in log if m["dst"] == "remote" and not m["noop"]]
    home = [m for m in log if m["dst"] == "local" and not m["noop"]]
    if len(fwd) != 2 or fwd[0]["nbytes"] < 100 << 20 or not home:
        raise AssertionError(f"expected two forward migrations, the first "
                             f">= 100 MiB, and a return trip: {log}")
    if "edges" not in fwd[0]["names"] or fwd[1]["names"] != ["edges"] or \
            not CHUNK <= fwd[1]["nbytes"] <= CHUNK + (64 << 10):
        raise AssertionError(f"re-migration after a one-element change "
                             f"shipped {fwd[1]}, expected the edge maps' "
                             f"one dirty {CHUNK} B chunk")
    main = captured["spacenet7-tiles"]
    if len(main["edges_home"]) != N_KEEP:
        raise AssertionError("the child does not hold the 32 edge maps")
    for a, b in zip(main["local"]["edges"], main["edges_home"]):
        if not np.array_equal(a.cpu().numpy(), np.asarray(b)):
            raise AssertionError("an edge map read back from the child "
                                 "differs from what left")
    if not np.isfinite(main["local"]["summary"]):
        raise AssertionError("summary is not finite")
    quant = captured["quant-field"]
    qlog = reports[quant_nb]["migration_log"]
    if not any("field" in m["names"] for m in qlog if m["dst"] == "local"):
        raise AssertionError(f"the quant8 field did not come home: {qlog}")
    q, sc = qk.quantize_kernel(source_field().reshape(-1, 1024))
    want = qk.dequantize_kernel(q, sc, torch.float32).reshape(-1).cpu().numpy()
    got = np.asarray(quant["local"]["field"])
    if got.dtype != np.float32 or not np.array_equal(got, want):
        raise AssertionError("the quant8 field that came home differs from "
                             "a local quantize/dequantize round trip")
    child = {k: main["child_launches"].get(k, 0)
             + quant["child_launches"].get(k, 0) for k in launches}
    for name in ("block_hash_fold", "block_hash", "block_hash_compare",
                 "quantize"):
        if launches[name] <= 0:
            raise AssertionError(f"the parent never launched {name} in the "
                                 f"socket runs: {launches}")
    for name in ("block_hash_fold", "dequantize"):
        if child[name] <= 0:
            raise AssertionError(f"the child never launched {name}: {child}")

    def leg_rows(nb):
        i, j = leg_ix[nb]
        return [leg for leg in legs[i:j] if not leg["noop"]]
    emit({"phase": "socket", "device": reports[main_nb]["device"],
          "card": card_line(),
          "wall_seconds": {nb.stem: walls[nb] for nb, _ in runs},
          "loopback_wall_seconds": loop_walls,
          "child_start_seconds": child_start,
          "legs": {nb.stem: leg_rows(nb) for nb, _ in runs},
          "wire_bytes": {nb.stem: sum(leg["wire_bytes"] for leg in legs[
              leg_ix[nb][0]:leg_ix[nb][1]]) for nb, _ in runs},
          "migrated_bytes": {nb.stem: reports[nb]["migrated_bytes"]
                             for nb, _ in runs},
          "wire_frames": {nb.stem: reports[nb]["wire_frames"]
                          for nb, _ in runs},
          "placements": {nb.stem: placements(reports[nb]) for nb, _ in runs},
          "decision_notes_differing_from_loopback": {
              nb.stem: {c: [reports[nb]["decisions"][c],
                            loopback[nb]["decisions"][c]]
                        for c in reports[nb]["decisions"]
                        if reports[nb]["decisions"][c]
                        != loopback[nb]["decisions"][c]} for nb, _ in runs},
          "placements_equal_loopback": True, "names_bit_equal": True,
          "child_exit_codes": exit_codes,
          "launches_parent": launches, "launches_parent_by_route": by_route,
          "launches_child": child,
          "seconds": time.perf_counter() - t_phase})
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


# ----------------------------------------------------------------------
# the fleet and gateway layer
# ----------------------------------------------------------------------

FLEET_SESSIONS = 4
FLEET_KW = {"arrivals": 0.2, "think_time": 5.0, "seed": 0}
SMALL_TILE = 64

# benchmarks/bench_replica.py:34-75: the failover arms (FAIL_AT 29.9,
# CKPT_INTERVAL 15.0, BEAT_INTERVAL 0.2, five cells, three envs)
REPLICA_ELEMS = 5_000_000
FAIL_AT = 29.9
CKPT_INTERVAL = 15.0
BEAT_INTERVAL = 0.2
REPLICA_CELLS = 5

# benchmarks/bench_gateway.py:49-72, 75-91: the attach storm (COLD_START,
# THINK_MEAN, GPU_CAPACITY, make_registry(n + 64), warm pool 64, two
# tenants weighted 2:1, seed 11, rate n / 5)
STORM_SESSIONS = 10_000
STORM_SMALL = 300
COLD_START = 5.0
THINK_MEAN = 120.0
GPU_CAPACITY = 256
WIRE_STORM = 2000
# seconds the wire storm's process may run, from its start before the
# socket phase to the end of the gateway phase's wait for it
WIRE_STORM_TIMEOUT = 600
NOTEBOOK_FLEET = 8
GATEWAY_WALL_FIELDS = ("decision_ms_p50", "decision_ms_p99")


def same(a, b, path: str = "$") -> None:
    """Equal, floats within rtol 1e-12; dataclasses by field."""
    import dataclasses
    import math
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            raise AssertionError(f"{path}: keys {a!r} vs {b!r}")
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            raise AssertionError(f"{path}: {a!r} vs {b!r}")
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        if not (a == b or math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)):
            raise AssertionError(f"{path}: {a!r} vs {b!r}")
    elif a != b:
        raise AssertionError(f"{path}: {a!r} vs {b!r}")


def state_kernel_counts() -> dict:
    from repro_torch.kernels.hash_delta import kernel as hk
    from repro_torch.kernels.quant_blockwise import kernel as qk
    return {**hk.LAUNCHES, **qk.LAUNCHES}


def reset_state_kernels() -> None:
    import torch

    from repro_torch.kernels.hash_delta import kernel as hk
    from repro_torch.kernels.hash_delta import ops as hops
    from repro_torch.kernels.quant_blockwise import kernel as qk
    torch.cuda.synchronize()
    hk.reset_launches()
    qk.reset_launches()
    hops.reset_host_syncs()


def add_counts(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0) for k in {*total, *more}}


def forward_bytes(rep: dict) -> dict:
    """Per session: the bytes its migrations to the remote env shipped plus
    what its replica plane shipped there."""
    return {sid: sum(m["nbytes"] for m in log
                     if m["dst"] == "remote" and not m["noop"])
            + s["replicated_bytes"]
            for (sid, log), s in zip(rep["migration_logs"].items(),
                                     rep["per_session"])}


def fleet_placements(rep: dict) -> dict:
    return {sid: [(m["src"], m["dst"], sorted(m["names"]), m["nbytes"])
                  for m in log] for sid, log in rep["migration_logs"].items()}


def replica_arm(mode, device, n_elems=REPLICA_ELEMS):
    """One failover arm of bench_replica: ``mode`` None (no failure),
    rerun, checkpoint or replica; every session's reducer on ``device``."""
    from repro_torch.core import (EnvironmentRegistry, ExecutionEnvironment,
                                  Notebook, SessionScheduler)
    reg = EnvironmentRegistry(default_bandwidth=2e8, default_latency=0.3)
    reg.register(ExecutionEnvironment("local"), home=True, capacity=8)
    reg.register(ExecutionEnvironment("gpu-cloud", speedup=10.0), capacity=1)
    reg.register(ExecutionEnvironment("gpu-standby", speedup=10.0),
                 capacity=1)
    sched = SessionScheduler(reg, beat_interval=BEAT_INTERVAL, device=device)
    if mode == "replica":
        sched.enable_replicas(2)
        sched.enable_recovery("rerun")
    elif mode is not None:
        sched.enable_recovery(mode, interval=CKPT_INTERVAL)
    if mode is not None:
        sched.inject_failure("gpu-cloud", at=FAIL_AT, recover_after=10.0)
    nb = Notebook(f"replica-session-{n_elems}-{mode}")
    nb.add_cell("import numpy as np\n"
                f"data = np.arange({n_elems}, dtype=np.float64)", cost=4.0)
    nb.add_cell("model = float((data ** 2).sum())", cost=80.0)
    nb.add_cell("model2 = model + float(data.sum())", cost=80.0)
    nb.add_cell("model3 = model2 * 0.5 + float(data[-1])", cost=80.0)
    nb.add_cell("out = model3 / 2", cost=5.0)
    sched.add_notebook(nb, policy="cost", use_knowledge=False,
                       think=[1.0] * REPLICA_CELLS)
    rep = sched.run()
    if any(s.runtime.reducer.device.type != device for s in sched._sessions):
        raise AssertionError(f"a failover session's reducer left {device}")
    return rep


def small_tiles_notebook(tmp: Path) -> Path:
    """The spacenet7-tiles notebook at 64x64 tiles (cells still on the
    card): the card-against-CPU run of the fleet."""
    setup = SETUP.replace(f"({TILE}, {TILE}, 3)",
                          f"({SMALL_TILE}, {SMALL_TILE}, 3)").replace(
        "1 << 20, 3 << 20", "1000, 3000")
    path = tmp / "spacenet7_small.ipynb"
    path.write_text(json.dumps(ipynb("spacenet7-small", [
        (setup, 0.3), (KMEANS, 600.0), (TWEAK, 0.1), (KMEANS, 600.0),
        (REPORT, 0.2)])))
    return path


def phase_fleet(tmp: Path) -> dict:
    """The fleet scheduler on the card through ``run_notebook(fleet=...)``:
    four spacenet7-tiles sessions sharing one fabric and one chunk store,
    the quant8 field as a two-session fleet, bench_replica's four failover
    arms at 5,000,000 elements, and the card against the CPU.  Returns the
    state-plane kernels' launches on the fleet path."""
    import torch

    from repro_torch.kernels.hash_delta import ops as hops
    from repro_torch.launch.notebook import run_notebook

    t_phase = time.perf_counter()
    main_nb, quant_nb = write_notebooks(tmp)
    launches: dict = {}

    # 1. four sessions of the shared dataset (two passes each under the
    # single-cell policy, as the session phase: the first pass gives the
    # analyzer its history, the second sends K-Means to the remote env)
    reset_state_kernels()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    shared, _ = run_notebook(str(main_nb), fleet=FLEET_SESSIONS, sessions=2,
                             policy="single", codec="none", device="cuda",
                             **FLEET_KW)
    torch.cuda.synchronize()
    shared_wall = time.perf_counter() - t0
    shared_launches = state_kernel_counts()
    shared_syncs = hops.HOST_SYNCS
    peak = torch.cuda.max_memory_allocated()
    launches = add_counts(launches, shared_launches)
    per = shared["per_session"]
    cells = 2 * 5
    if [s["cells_run"] for s in per] != [cells] * FLEET_SESSIONS:
        raise AssertionError(f"sessions did not complete: {per}")
    if any(not s["device"].startswith("cuda") for s in per):
        raise AssertionError(f"a session's reducer is not on the card: {per}")
    crossed = forward_bytes(shared)
    first = max(crossed, key=crossed.get)
    if crossed[first] < 100 << 20:
        raise AssertionError(f"the dataset never crossed: {crossed}")
    for sid, n in crossed.items():
        if sid != first and n >= crossed[first] / 100:
            raise AssertionError(f"{sid} shipped {n} B, not under 1 % of "
                                 f"{first}'s {crossed[first]} B: {crossed}")

    # 2. the quant8 field as a two-session fleet (quantize on the way out,
    # dequantize where it lands)
    reset_state_kernels()
    t0 = time.perf_counter()
    quant, _ = run_notebook(str(quant_nb), fleet=2, sessions=2,
                            policy="single", codec="quant8+zstd",
                            device="cuda", **FLEET_KW)
    torch.cuda.synchronize()
    quant_wall = time.perf_counter() - t0
    quant_launches = state_kernel_counts()
    launches = add_counts(launches, quant_launches)
    if [s["cells_run"] for s in quant["per_session"]] != [6, 6]:
        raise AssertionError(f"quant sessions incomplete: {quant}")
    for k in ("quantize", "dequantize"):
        if quant_launches[k] <= 0:
            raise AssertionError(f"{k} never launched in the quant8 fleet")

    # 3. bench_replica's failover arms at 5,000,000 elements on the card
    reset_state_kernels()
    arms, arm_walls = {}, {}
    for mode in (None, "rerun", "checkpoint", "replica"):
        t0 = time.perf_counter()
        arms[mode] = replica_arm(mode, "cuda")
        arm_walls[str(mode)] = time.perf_counter() - t0
    torch.cuda.synchronize()
    arm_launches = state_kernel_counts()
    launches = add_counts(launches, arm_launches)
    base = arms[None].makespan
    overhead = {str(m): arms[m].makespan - base for m in arms if m}
    for m in ("rerun", "checkpoint", "replica"):
        r = arms[m]
        if r.recoveries < 1 or r.sessions[0].cells_run != REPLICA_CELLS:
            raise AssertionError(f"arm {m}: {r}")
    if arms["replica"].promotions != 1:
        raise AssertionError("the replica arm did not recover by promotion")
    gain = overhead["checkpoint"] / max(overhead["replica"], 1e-9)
    if gain <= 10.0:
        raise AssertionError(f"promotion beats checkpoint-restore only "
                             f"{gain:.2f}x (> 10x expected): {overhead}")
    t0 = time.perf_counter()
    for mode in arms:
        same(replica_arm(mode, "cpu"), arms[mode], f"arm {mode}")
    arms_cpu_wall = time.perf_counter() - t0

    # 4. the card against the CPU: the fleet at 64x64 tiles with a replica
    # per session, and every kernel launch of the card's run traced
    small = small_tiles_notebook(tmp)
    runs = {}
    before = state_kernel_counts()
    n_traced, _ = hash_launches_in(lambda: runs.__setitem__(
        "cuda", run_notebook(str(small), fleet=FLEET_SESSIONS, sessions=2,
                             policy="single", codec="none", replicas=1,
                             device="cuda", **FLEET_KW)[0]))
    counted = {k: n - before[k] for k, n in state_kernel_counts().items()}
    hashed = sum(n for k, n in counted.items() if k.startswith("block_hash"))
    if n_traced != hashed or hashed <= 0:
        raise AssertionError(f"profiler saw {n_traced} hash launches, the "
                             f"wrappers counted {counted}")
    runs["cpu"], _ = run_notebook(str(small), fleet=FLEET_SESSIONS,
                                  sessions=2, policy="single", codec="none",
                                  replicas=1, device="cpu", **FLEET_KW)
    a, b = runs["cuda"], runs["cpu"]
    same(fleet_placements(a), fleet_placements(b), "placements")
    same(a["chunk_keys"], b["chunk_keys"], "chunk_keys")
    same(a["chunks_held"], b["chunks_held"], "chunks_held")
    same([{k: v for k, v in s.items() if k not in ("device", "wall_seconds")}
          for s in a["per_session"]],
         [{k: v for k, v in s.items() if k not in ("device", "wall_seconds")}
          for s in b["per_session"]], "per_session")
    same(a["makespan"], b["makespan"], "makespan")

    emit({"phase": "fleet", "card": card_line(),
          "shared_dataset": {
              "sessions": FLEET_SESSIONS, "passes": 2, **FLEET_KW,
              "wall_seconds": shared_wall,
              "peak_memory_bytes": peak,
              "per_session": [{k: s[k] for k in (
                  "session", "arrival", "makespan", "cells_run",
                  "migrated_bytes", "replicated_bytes", "wall_seconds",
                  "device")} for s in per],
              "bytes_to_remote": crossed, "first_to_ship": first,
              "others_over_first": {sid: n / crossed[first]
                                    for sid, n in crossed.items()
                                    if sid != first},
              "chunks_held": shared["chunks_held"],
              "launches": shared_launches, "host_syncs": shared_syncs},
          "quant8": {"wall_seconds": quant_wall,
                     "migrated_bytes": [s["migrated_bytes"]
                                        for s in quant["per_session"]],
                     "launches": quant_launches},
          "failover": {"n_elems": REPLICA_ELEMS, "wall_seconds": arm_walls,
                       "makespan": {str(m): r.makespan
                                    for m, r in arms.items()},
                       "recovery_overhead": overhead,
                       "promote_vs_checkpoint": gain,
                       "replicated_bytes": arms["replica"].replicated_bytes,
                       "restored_bytes": arms["checkpoint"].restored_bytes,
                       "launches": arm_launches,
                       "cpu_arms_equal": True,
                       "cpu_arms_wall_seconds": arms_cpu_wall},
          "card_vs_cpu": {"tile": SMALL_TILE, "replicas": 1, "equal": True,
                          "hash_launches_traced": n_traced,
                          "launches": counted},
          "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


def storm_registry(local_capacity: int):
    from repro_torch.core import EnvironmentRegistry, ExecutionEnvironment
    reg = EnvironmentRegistry(default_bandwidth=1e9, default_latency=0.05)
    reg.register(ExecutionEnvironment("local"), home=True,
                 capacity=local_capacity)
    reg.register(ExecutionEnvironment("gpu-cloud", speedup=8.0),
                 capacity=GPU_CAPACITY)
    reg.connect("local", "gpu-cloud", bandwidth=5e8, latency=0.3)
    return reg


def storm_notebook(i: int):
    from repro_torch.core import Notebook
    nb = Notebook(f"user-{i % 16}")
    nb.add_cell("x = 2.0", cost=0.5)
    nb.add_cell("y = x * 3.0", cost=30.0)
    nb.add_cell("z = y + 1.0", cost=1.0)
    return nb


def attach_storm(n: int, device: str):
    """bench_gateway's storm: ``n`` sessions through one GatewayService."""
    from repro_torch.core import GatewayService, poisson_attach_storm
    gw = GatewayService(storm_registry(n + 64), warm_pool=64,
                        cold_start=COLD_START, policy="cost",
                        use_knowledge=False, device=device)
    gw.add_tenant("research", weight=2.0)
    gw.add_tenant("teaching", weight=1.0)
    poisson_attach_storm(gw, n_sessions=n, rate=n / 5.0,
                         think_mean=THINK_MEAN, make_notebook=storm_notebook,
                         tenants=("research", "teaching"), seed=11)
    t0 = time.perf_counter()
    rep = gw.run()
    return rep, time.perf_counter() - t0, gw


def gateway_sim(rep) -> dict:
    import dataclasses
    out = {k: v for k, v in dataclasses.asdict(rep).items()
           if k not in GATEWAY_WALL_FIELDS}
    out["session_reports"] = sorted(out["session_reports"],
                                    key=lambda r: r["session"])
    return out


class WireStorm:
    """The gateway phase's wire storm (``serve_gateway(0,
    stress=WIRE_STORM)``: ATTACH frames through a WireFrontend, each
    session 200,000 float64 elements, its chunks hashed on the card and
    compressed on the host) in a process of this script (``--wire-storm
    DIR``), started before the socket and fleet phases so that its host
    work runs beside theirs; ``result`` waits for it (at most
    WIRE_STORM_TIMEOUT seconds from its start) and ``stop`` ends it if it
    still runs.  The process writes ``DIR/wire.json``: the server's
    result, its wall seconds and the state-plane kernels' launches and
    host syncs of the storm alone."""

    def __init__(self, out: Path):
        self.out = out
        self.log = open(out / "wire.log", "w")
        self.started = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--wire-storm",
             str(out)], stdout=self.log, stderr=subprocess.STDOUT, cwd=ROOT)

    def result(self) -> dict:
        left = self.started + WIRE_STORM_TIMEOUT - time.monotonic()
        try:
            code = self.proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            code = None
        self.stop()
        if code != 0:
            raise AssertionError(
                f"wire storm: exit {code} after "
                f"{time.monotonic() - self.started:.1f} s:\n"
                + (self.out / "wire.log").read_text()[-3000:])
        return json.loads((self.out / "wire.json").read_text())

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self.log.close()


def wire_storm_main(out: Path) -> int:
    """The process ``WireStorm`` starts."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.hash_delta import ops as hops
    from repro_torch.launch.serve import serve_gateway

    reset_state_kernels()
    t0 = time.perf_counter()
    wire = serve_gateway(0, stress=WIRE_STORM, device="cuda")
    torch.cuda.synchronize()
    (out / "wire.json").write_text(json.dumps({
        "wire": wire, "wall_seconds": time.perf_counter() - t0,
        "launches": state_kernel_counts(), "host_syncs": hops.HOST_SYNCS},
        default=str))
    return 0


def phase_gateway(wire_storm: WireStorm) -> dict:
    """The gateway on the card: bench_gateway's 10,000-session attach storm
    through one ``GatewayService(device="cuda")``, the server's wire storm
    (``wire_storm``'s result) and its notebook fleet
    (``serve_notebook_fleet(8)``), then the 300-session storm on the card
    against the CPU.  Returns the state-plane kernels' launches on the
    gateway path, the wire storm's process's included."""
    import torch

    from repro_torch.kernels.hash_delta import ops as hops
    from repro_torch.launch.serve import serve_notebook_fleet

    t_phase = time.perf_counter()
    reset_state_kernels()
    rep, storm_wall, gw = attach_storm(STORM_SESSIONS, "cuda")
    torch.cuda.synchronize()
    storm_launches = state_kernel_counts()
    storm_syncs = hops.HOST_SYNCS
    if (rep.sessions, rep.completed, rep.errors, rep.peak_concurrent) != \
            (STORM_SESSIONS, STORM_SESSIONS, 0, STORM_SESSIONS):
        raise AssertionError(f"storm: {rep.sessions} sessions, "
                             f"{rep.completed} completed, {rep.errors} "
                             f"errors, peak {rep.peak_concurrent}")
    if gw.device.type != "cuda":
        raise AssertionError(f"the gateway's device is {gw.device}")

    t0 = time.perf_counter()
    fleet = serve_notebook_fleet(NOTEBOOK_FLEET, device="cuda")
    torch.cuda.synchronize()
    fleet_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    storm_out = wire_storm.result()
    wire_waited = time.perf_counter() - t0
    wire, wire_wall = storm_out["wire"], storm_out["wall_seconds"]
    launches = {k: n + storm_out["launches"].get(k, 0)
                for k, n in state_kernel_counts().items()}
    syncs = hops.HOST_SYNCS + storm_out["host_syncs"]
    if (wire["completed"], wire["errors"], wire["wire_sessions"]) != \
            (WIRE_STORM, 0, WIRE_STORM) or wire["device"] != "cuda":
        raise AssertionError(f"wire storm: {wire}")
    if fleet["sessions"] != NOTEBOOK_FLEET or fleet["makespan"] <= 0 \
            or fleet["device"] != "cuda":
        raise AssertionError(f"notebook fleet: {fleet}")
    if launches["block_hash"] + launches["block_hash_fold"] <= 0:
        raise AssertionError(f"no hash launched on the gateway path: "
                             f"{launches}")

    small = {dev: gateway_sim(attach_storm(STORM_SMALL, dev)[0])
             for dev in ("cuda", "cpu")}
    same(small["cuda"], small["cpu"], "storm 300")

    emit({"phase": "gateway", "card": card_line(),
          "storm": {"sessions": rep.sessions, "completed": rep.completed,
                    "errors": rep.errors,
                    "peak_concurrent": rep.peak_concurrent,
                    "makespan": rep.makespan,
                    "queue_wait_p50": rep.queue_wait_p50,
                    "queue_wait_p99": rep.queue_wait_p99,
                    "attach_wait_p50": rep.attach_wait_p50,
                    "attach_wait_p99": rep.attach_wait_p99,
                    "decision_ms_p50": rep.decision_ms_p50,
                    "decision_ms_p99": rep.decision_ms_p99,
                    "wall_seconds": storm_wall,
                    "events_per_sec": rep.sessions * 4 / storm_wall,
                    "launches": storm_launches, "host_syncs": storm_syncs},
          "wire": {**{k: wire[k] for k in (
              "sessions", "completed", "errors", "peak_concurrent",
              "makespan", "attach_wait_p99", "queue_wait_p99",
              "decision_ms_p99", "pool")}, "wall_seconds": wire_wall,
              "run_beside": ["socket", "fleet", "gateway"],
              "waited_seconds": wire_waited,
              "launches": storm_out["launches"]},
          "notebook_fleet": {**{k: fleet[k] for k in (
              "sessions", "makespan", "queue_events", "total_queue_wait")},
              "wall_seconds": fleet_wall},
          "launches": launches, "host_syncs": syncs,
          "card_vs_cpu": {"sessions": STORM_SMALL, "equal": True},
          "seconds": time.perf_counter() - t_phase})
    return launches


CKPT_ARCH = "internvl2-2b"              # the full model the checkpoint saves
CKPT_SLACK = 2 * CHUNK                  # the changed element's chunk + metadata


def bits_equal(a, b) -> bool:
    """Equal shape, dtype and bits (a bf16 -0.0 is not a 0.0)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        return False
    if a.dtype.is_floating_point and a.element_size() == 2:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def tree_bits_equal(got, want, path="$") -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"{path}: keys differ")
        for k in want:
            tree_bits_equal(got[k], want[k], f"{path}[{k!r}]")
    elif not bits_equal(got, want):
        raise AssertionError(f"{path}: restored leaf differs from the saved "
                             f"one ({got.dtype} {tuple(got.shape)} on "
                             f"{got.device})")


def phase_checkpoint(tmp: Path) -> dict:
    """Checkpointing as migration to a storage env on the card:
    1. the full internvl2-2b bf16 parameters (3.78 GB on the card) plus a
       0-d ``data_step`` through ``Checkpointer(codec="none",
       device="cuda")`` (codec ``none``: this machine lacks ``zstandard``,
       and zlib of 3.8 GB of random bf16 takes about a minute); then one
       element of one leaf changed and one other leaf replaced whole: the
       second save writes exactly those 2 leaves, at most the replaced
       leaf's bytes plus 2 x 256 KiB (the changed chunk and the metadata),
       with the hash kernels traced on the card; both steps restore bit for
       bit, in bf16, on the card;
    2. full whisper-tiny through ``AsyncCheckpointer`` (default codec) while
       one whisper-tiny prefill runs; restored bit for bit;
    3. GC at ``keep=1``: three saves leave 2 manifests, and the chunk files
       are exactly those the two reference.
    Returns the kernels' launches on the checkpoint path."""
    import gc
    import os

    import torch

    from repro_torch.checkpoint import AsyncCheckpointer, Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.models import LM
    from repro_torch.models.layers import spec_leaves

    t_phase = time.perf_counter()
    reset_state_kernels()
    for m in lm_kernels():
        m.reset_launches()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def hash_count(counts):
        return sum(counts.get(k, 0) for k in
                   ("block_hash", "block_hash_compare", "block_hash_fold"))

    # -- 1: the full internvl2-2b, a delta save, both steps restored -----
    cfg = get_config(CKPT_ARCH)
    params = LM(cfg, device="cuda").init(SEED, torch.bfloat16)
    leaves = spec_leaves(params)
    param_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    trees = {"params": params,
             "data_step": torch.tensor(1000, dtype=torch.int64, device="cuda")}
    ck = Checkpointer(str(tmp / CKPT_ARCH), codec="none", device="cuda")
    info1, save1_s = timed(lambda: ck.save(1, trees))
    after_first = state_kernel_counts()
    if hash_count(after_first) <= 0:
        raise AssertionError(f"the first save launched no hash kernel: "
                             f"{after_first}")
    if info1.n_leaves_written != info1.n_leaves_total or \
            info1.n_leaves_total != len(leaves) + 1:
        raise AssertionError(f"first save: {info1}")

    stack = params["decoder"]["stack"]
    old_wq, old_ln1 = stack["attn"]["wq"].clone(), stack["ln1"]
    stack["attn"]["wq"].view(-1)[123_457] += 1.0      # one element
    stack["ln1"] = torch.randn(old_ln1.shape, device="cuda",
                               generator=torch.Generator(device="cuda")
                               .manual_seed(SEED)).to(old_ln1.dtype)
    replaced_bytes = old_ln1.numel() * old_ln1.element_size()
    infos = []
    traced_hash, traced = hash_launches_in(
        lambda: infos.append(ck.save(2, trees)))
    torch.cuda.synchronize()
    info2 = infos[0]
    delta_bound = replaced_bytes + CKPT_SLACK
    if info2.n_leaves_written != 2 or info2.nbytes > delta_bound:
        raise AssertionError(f"delta save: {info2.n_leaves_written} leaves, "
                             f"{info2.nbytes} B (bound {delta_bound} B)")
    after_delta = state_kernel_counts()
    # the wrappers' counts decide, and the trace must agree wherever the
    # profiler records device activity at all.  Late in a full run it has
    # recorded none, or once only the digests' copy to the host (PERF.md
    # section 7): where it records no kernel, the same save of step 2 is
    # traced once more (it digests every leaf again and writes nothing)
    retraced = traced_hash <= 0 and all(
        n.startswith(("Memcpy", "Memset")) for n in traced)
    if retraced:
        again = []
        traced_hash, traced = hash_launches_in(
            lambda: again.append(ck.save(2, trees)))
        torch.cuda.synchronize()
        if again[0].n_leaves_written != 0:
            raise AssertionError(f"the second save of step 2: {again[0]}")
    if hash_count(after_delta) <= hash_count(after_first) or \
            (traced and traced_hash <= 0):
        raise AssertionError(
            f"the delta save ran no hash kernel on the card: {traced_hash} "
            f"traced of {len(traced)} device activities "
            f"{sorted(set(traced))[:12]}; counts {after_first} -> "
            f"{after_delta}")

    templates = {"params": params, "data_step": trees["data_step"]}
    (out2, step2), restore2_s = timed(lambda: ck.restore(templates))
    if step2 != 2:
        raise AssertionError(f"restored step {step2}, expected 2")
    tree_bits_equal(out2, templates)
    del out2
    gc.collect()
    (out1, step1), restore1_s = timed(lambda: ck.restore(templates, step=1))
    want1 = dict(templates, params=dict(params, decoder={"stack": dict(
        stack, ln1=old_ln1, attn=dict(stack["attn"], wq=old_wq))}))
    if step1 != 1:
        raise AssertionError(f"restored step {step1}, expected 1")
    tree_bits_equal(out1, want1)
    del out1, want1, old_wq, old_ln1, params, trees, templates, stack, leaves
    gc.collect()
    torch.cuda.empty_cache()
    big = {"arch": CKPT_ARCH, "param_bytes": param_bytes,
           "leaves": info1.n_leaves_total,
           "save_seconds": [save1_s, info2.seconds],
           "restore_seconds": {"step2": restore2_s, "step1": restore1_s},
           "nbytes": [info1.nbytes, info2.nbytes],
           "leaves_written": [info1.n_leaves_written,
                              info2.n_leaves_written],
           "delta_bound_bytes": delta_bound,
           "delta_hash_launches": hash_count(after_delta)
           - hash_count(after_first),
           "delta_traced_hash_launches": traced_hash,
           "delta_traced_device_activities": len(traced),
           "delta_retraced": retraced,
           "save_gb_per_s": param_bytes / save1_s / 1e9}

    # -- 2: whisper-tiny through the async writer, beside a prefill ------
    wcfg = get_config("whisper-tiny")
    wlm = LM(wcfg, max_seq=WH_PROMPT + GEN, device="cuda")
    wparams = wlm.init(SEED, torch.bfloat16)
    batch = TokenPipeline(wcfg, ShapeConfig("ckpt", "prefill", WH_PROMPT,
                                            WH_BATCH), seed=SEED).prefill_batch(0)
    tokens = torch.from_numpy(batch["tokens"]).cuda()
    flash_before = lm_launches()["flash_attention"]
    ack = AsyncCheckpointer(Checkpointer(str(tmp / "whisper-tiny"),
                                         device="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ack.save(1, {"params": wparams})
    t_snapshot = time.perf_counter() - t0
    logits, _ = wlm.prefill(tokens, cache_len=WH_PROMPT + GEN,
                            encoder_frames=batch["encoder_frames"])
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    writer_alive = ack._thread is not None and ack._thread.is_alive()
    ack.wait()
    t_async = time.perf_counter() - t0
    winfo = ack.last_info
    if winfo is None or winfo.n_leaves_written != winfo.n_leaves_total:
        raise AssertionError(f"async save: {winfo}")
    if lm_launches()["flash_attention"] - flash_before != \
            expected_launches(wcfg, WH_PROMPT)["flash_attention"] or \
            not torch.isfinite(logits).all():
        raise AssertionError("the prefill beside the async save")
    (wout, _), wrestore_s = timed(lambda: ack.inner.restore(
        {"params": wparams}))
    tree_bits_equal(wout, {"params": wparams})
    del wout, logits

    # -- 3: GC at keep=1 ---------------------------------------------------
    gck = Checkpointer(str(tmp / "gc"), codec="none", keep=1, device="cuda")
    chunk_sets = []
    for s in (1, 2, 3):
        wparams["ln_f"] += 1.0
        gck.save(s, {"params": wparams})
        chunk_sets.append({int(f[len("chunk-"):-len(".bin")], 16)
                           for f in os.listdir(gck.dir)
                           if f.startswith("chunk-") and f.endswith(".bin")})
    referenced = {d for st in gck._steps()
                  for rec in gck._manifest(st)["names"].values()
                  for a in rec["arrays"] for d in a["chunks"]}
    if gck._steps() != [2, 3] or chunk_sets[-1] != referenced or \
            not chunk_sets[1] - chunk_sets[-1]:
        raise AssertionError(f"gc: steps {gck._steps()}, "
                             f"{len(chunk_sets[-1])} chunk files, "
                             f"{len(referenced)} referenced")
    del wparams, wlm
    gc.collect()
    torch.cuda.empty_cache()

    launches = {**state_kernel_counts(), **lm_launches()}
    emit({"phase": "checkpoint", "card": card_line(), "internvl2": big,
          "whisper_async": {"nbytes": winfo.nbytes,
                            "leaves": winfo.n_leaves_total,
                            "codec": ack.inner.codec,
                            "snapshot_seconds": t_snapshot,
                            "prefill_seconds_beside": t_prefill,
                            "writer_running_after_prefill": writer_alive,
                            "save_seconds": winfo.seconds,
                            "wall_seconds": t_async,
                            "restore_seconds": wrestore_s},
          "gc": {"keep": 1, "saves": 3, "manifests": gck._steps(),
                 "chunk_files": len(chunk_sets[-1]),
                 "removed": len(chunk_sets[1] - chunk_sets[-1])},
          "bit_equal": True, "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def lm_kernels():
    """The LM kernels' wrapper modules: flash_attention, ssd_scan and
    rglru_scan, each forward and backward."""
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
    a multiple of it above it), and in every encoder layer of an encdec
    (unmasked); no backward."""
    kinds = cfg.layer_kinds()
    w = cfg.local_window if cfg.block_pattern else 0
    banded = bool(w) and prompt > w and prompt % w == 0
    encoder = cfg.encoder_layers if cfg.family == "encdec" else 0
    return {"flash_attention": (0 if banded else kinds.count("attn")) + encoder,
            "flash_attention_bwd": 0,
            "ssd_scan": kinds.count("ssm"), "ssd_scan_bwd": 0,
            "rglru_scan": kinds.count("rec"), "rglru_scan_bwd": 0}


def train_launches(cfg, seq: int) -> dict:
    """One training step's launches: each kernel of :func:`expected_launches`
    once in the forward, and its backward once."""
    fwd = expected_launches(cfg, seq)
    return {**fwd, "flash_attention_bwd": fwd["flash_attention"],
            "ssd_scan_bwd": fwd["ssd_scan"], "rglru_scan_bwd": fwd["rglru_scan"]}


def flash_only(n: int) -> dict:
    return {"flash_attention": n, "flash_attention_bwd": 0, "ssd_scan": 0,
            "ssd_scan_bwd": 0, "rglru_scan": 0, "rglru_scan_bwd": 0}


# one prefill's launches, stated where the config alone decides them
SERVE_LAUNCHES = {
    "recurrentgemma-9b": {"flash_attention": 12, "flash_attention_bwd": 0,
                          "ssd_scan": 0, "ssd_scan_bwd": 0, "rglru_scan": 26,
                          "rglru_scan_bwd": 0},
    "stablelm-12b": flash_only(40),
    "qwen2-moe-a2.7b": flash_only(24),
    "qwen3-moe-235b-a22b": flash_only(QWEN3_LAYERS),
    "internvl2-2b": flash_only(24),
    "whisper-tiny": flash_only(8),        # 4 encoder (full), 4 decoder
}


def serve_config(arch: str):
    """The full config of a serve cell; qwen3-moe-235b-a22b at
    ``QWEN3_LAYERS`` of its 94 layers, at full width."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch == "qwen3-moe-235b-a22b":
        cfg = dataclasses.replace(cfg, num_layers=QWEN3_LAYERS)
    return cfg


SERVE_CELLS = (("yi-6b", YI_BATCH, YI_PROMPT),
               ("mamba2-370m", MAMBA_BATCH, MAMBA_PROMPT),
               ("recurrentgemma-9b", RG_BATCH, RG_PROMPT),
               ("stablelm-12b", SL_BATCH, SL_PROMPT),
               ("qwen2-moe-a2.7b", MOE_BATCH, MOE_PROMPT),
               ("qwen3-moe-235b-a22b", MOE_BATCH, MOE_PROMPT),
               ("internvl2-2b", VLM_BATCH, VLM_PROMPT),
               ("whisper-tiny", WH_BATCH, WH_PROMPT))


def phase_serve() -> dict:
    """The LM serving path on the card through ``serve_lm``: full yi-6b,
    full mamba2-370m, full recurrentgemma-9b, full stablelm-12b, full
    qwen2-moe-a2.7b, qwen3-moe-235b-a22b at full width and 8 of its 94
    layers, full internvl2-2b and full whisper-tiny with seeded bf16
    weights.  One prefill must launch each layer's kernel once (decode runs
    plain PyTorch): flash 32 (yi-6b); SSD 48 (mamba2); RG-LRU 26 and flash
    12 (recurrentgemma, whose prompt of 2048 equals its window, so its
    attention layers run full causal attention through flash); flash 40 at
    head dim 160 (stablelm-12b); flash 24 (qwen2-moe), 8 (qwen3-moe, GQA
    64:4), 24 (internvl2, over 256 patches and 1792 text tokens) and 8
    (whisper: 4 unmasked over the encoder's 1500 frames, 4 causal over the
    decoder's prompt).  Every id must lie in [0, padded_vocab).  Returns
    the launches of the kernels, summed over the models."""
    import gc

    import numpy as np
    import torch

    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import LM
    from repro_torch.models.layers import param_count

    launches = {}
    for arch, batch, prompt in SERVE_CELLS:
        cfg = serve_config(arch)
        want = expected_launches(cfg, prompt)
        if arch in SERVE_LAUNCHES and want != SERVE_LAUNCHES[arch]:
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
              "params": param_count(LM(cfg, max_seq=prompt + GEN,
                                       device="cpu").spec),
              "layers": cfg.num_layers,
              "reduced": (f"{QWEN3_LAYERS} of 94 layers (full width)"
                          if arch == "qwen3-moe-235b-a22b" else None),
              "dtype": "bfloat16", "batch": batch, "prompt_len": prompt,
              "gen": GEN, "prefill_seconds": out["prefill_seconds"],
              "decode_seconds": out["decode_seconds"],
              "decode_tokens_per_s": out["decode_tokens_per_s"],
              "peak_memory_bytes": out["peak_memory_bytes"],
              "model_memory": beside_peak(
                  memory_model(cfg, "prefill", prompt, batch,
                               max_seq=prompt + GEN),
                  out["peak_memory_bytes"]),
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
               ("recurrentgemma-9b", 64, 1e-4),
               ("stablelm-12b", REDUCED_PROMPT, 1e-4),
               # stablelm-12b at its own head dim, 160: flash's f32 route
               ("stablelm-12b-hd160", REDUCED_PROMPT, 1e-4),
               ("qwen2-moe-a2.7b", REDUCED_PROMPT, 1e-4),
               ("qwen3-moe-235b-a22b", REDUCED_PROMPT, 1e-4),
               # 8 patches + 40 text tokens
               ("internvl2-2b", REDUCED_PROMPT, 1e-4),
               # 48 decoder tokens over 24 encoder frames
               ("whisper-tiny", REDUCED_PROMPT, 1e-4))
# reduced configs beyond ``get_config(arch, reduced=True)``: the tests'
# stablelm-12b at head dim 160 (tests/test_torch_model.py, STABLELM_HD160)
REDUCED_VARIANTS = {"stablelm-12b-hd160": ("stablelm-12b", {
    "d_model": 320, "num_heads": 2, "num_kv_heads": 2, "num_layers": 2})}


def reduced_config(name: str):
    import dataclasses

    from repro_torch.configs import get_config
    arch, overrides = REDUCED_VARIANTS.get(name, (name, {}))
    return dataclasses.replace(get_config(arch, reduced=True), **overrides)


def phase_serve_agree() -> None:
    """The reduced yi-6b, mamba2-370m, recurrentgemma-9b (at prompts 48
    and 64), stablelm-12b (at head dim 16, and at its own 160),
    qwen2-moe-a2.7b, qwen3-moe-235b-a22b, internvl2-2b and whisper-tiny in
    f32 through ``serve_lm`` on the card (the kernels) and on the CPU (their
    plain versions, which the CPU tests hold to the JAX reference), with
    the same weights: logits within the model tolerances,
    equal greedy ids, and on the card exactly the expected launches (none
    on the CPU)."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import LM

    t_phase = time.perf_counter()
    errs, ran = {}, {}
    for arch, prompt, tol in SERVE_AGREE:
        cfg = reduced_config(arch)
        # an encdec's decoder positions are sized by max_seq: serve_lm's
        params = LM(cfg, max_seq=prompt + 8, device="cpu").init(
            SEED, torch.float32)
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


DEMO_BATCH, DEMO_SEQ = 4, 256          # the checkpoint leg: full demo-100m
# full mamba2-370m: 4 x 2048 tokens, 8 chunks of 256 (the carry runs both
# ways); recurrentgemma-9b at full width cut to 6 of its 38 layers (two
# rec, rec, attn groups, 3.29 B parameters with the untied 256,000 x 4096
# embedding and head: 12 and 9 layers, 4.49 B and 3.89 B, ran out of the
# card's 80 GB, PERF.md §4), 2 x 1024 (under the 2048 window: attention
# through flash)
MAMBA_TRAIN_ARCH, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ = "mamba2-370m", 4, 2048
RG_TRAIN_LAYERS, RG_TRAIN_BATCH, RG_TRAIN_SEQ = 6, 2, 1024
# (arch, seq, each gradient leaf's tolerance of its max-abs): PERF.md §2;
# mamba2's SSD sums run in another order on the card, as in serving
TRAIN_AGREE = (("yi-6b", 48, 1e-4), ("minicpm-2b", 48, 1e-4),
               ("qwen2-moe-a2.7b", 48, 1e-4), ("internvl2-2b", 48, 1e-4),
               ("whisper-tiny", 48, 1e-4), ("mamba2-370m", 48, 1e-3),
               ("recurrentgemma-9b", 48, 1e-4),
               ("recurrentgemma-9b", 64, 1e-4))
# a resumed run's losses against the unbroken run's, on one card: they
# agreed bit for bit in every run so far (PERF.md §6); the margin leaves
# room only for a reduction order that changes between two runs
RESUME_LOSS_TOL = 1e-3


def finite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


def phase_train(tmp: Path) -> dict:
    """The training path through ``repro_torch.launch.train.main`` on the
    card:
    1. full minicpm-2b (40 layers, d 2304, vocab 122,753 padded to 122,880,
       tied embeddings, the WSD schedule), seeded bf16 weights, batch 2 x
       seq 1024, 4 steps at lr 2e-5: every step launches flash_attention 40
       times (forward with the row log-sum-exp) and flash_attention_bwd 40
       times, all 40 on its tensor-core route;
       every loss and grad norm finite, the last loss below the first;
       prints seconds per step (and its split: the forward and the AdamW
       update each timed between two synchronises, the backward the rest),
       tokens per second and the peak device memory; then, from the last
       step's output, two more steps (a warm-up and one under
       torch.profiler) give the device time of a step by kernel, the flash
       kernels' share and the device's idle share of a steady step (empty
       if the profiler records no device time, as some whole runs did
       after the gateway phase: then call the phase alone);
    2. full demo-100m, 4 steps with a checkpoint every 2 (codec ``none``);
       the checkpoint of step 2 (the later manifest removed, as if the run
       had stopped there) resumes for steps 2 and 3: the parameters and
       optimizer state (master, m, v, step) the resumed run starts from
       have the bits the unbroken run held after step 2, and both steps'
       losses equal the unbroken run's within 1e-3; the hash kernels
       launch;
    3. full mamba2-370m (48 layers, d 1024, 32 SSD heads of 64, N 128),
       seeded bf16 weights, batch 4 x seq 2048 (8 chunks of 256), 4 steps
       at lr 2e-5 through the CLI: every step launches ssd_scan and
       ssd_scan_bwd 48 times and nothing else;
    4. recurrentgemma-9b at full width cut to 6 of its 38 layers (two
       rec, rec, attn groups; ``dataclasses.replace``, which the CLI
       cannot name, so the CLI's loop runs here on ``train_step``), seeded
       bf16 weights, batch 2 x seq 1024 (under the 2048 window: causal
       attention through flash at hd 256), 4 steps at lr 2e-5: every step
       launches rglru_scan and rglru_scan_bwd 4 times, flash_attention and
       flash_attention_bwd twice, both backwards on the tensor cores;
    legs 3 and 4 check finite and falling losses, print seconds per step,
    tokens per second, the peak device memory, and the device time by
    kernel (the flash backward's summed) and idle share of one more
    (traced) step.
    Returns the kernels' launches on the training path."""
    import contextlib
    import dataclasses
    import gc
    import io
    import os
    import shutil

    import torch

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.reducer import tree_flatten_with_path
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train as tr
    from repro_torch.models import LM
    from repro_torch.models.layers import param_count
    from repro_torch.optim import init_opt_state

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    reset_state_kernels()
    for m in lm_kernels():
        m.reset_launches()

    # per-step launches (and the backward's by route), and the host time of
    # each step's forward (the loss) and AdamW update, each between two
    # synchronises: the smoke wraps the CLI's step function, LM.loss and
    # adamw_update
    fk = lm_kernels()[0]
    per_step, per_step_routes, split = [], [], []
    step_fn, loss_fn, update_fn = tr.train_step, LM.loss, tr.adamw_update
    # the (params, opt) trees handed to the steps whose index (counted from
    # the last ``per_step.clear()``) is a key, copied before the step
    # updates them in place
    states: dict[int, list] = {}
    # the step count whose (lm, tc, params, opt, batch) are kept to trace
    # steps after the run
    trace_after, last = [None], []

    def counted(lm, tc, params, opt, batch):
        if len(per_step) in states:
            states[len(per_step)] = [
                (p, x.detach().clone()) for p, x in
                tree_flatten_with_path({"params": params,
                                        "opt": opt._asdict()})]
        before, routes = lm_launches(), dict(fk.BWD_ROUTE_LAUNCHES)
        out = step_fn(lm, tc, params, opt, batch)
        per_step.append({k: n - before[k] for k, n in lm_launches().items()})
        per_step_routes.append({k: n - routes[k]
                                for k, n in fk.BWD_ROUTE_LAUNCHES.items()})
        if len(per_step) == trace_after[0]:
            last[:] = [lm, tc, out[0], out[1], batch]
        return out

    def timed(fn, what):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            split.append((what, time.perf_counter() - t0))
            return out
        return run

    def cli(argv) -> tuple[list[dict], str]:
        out = io.StringIO()
        tr.train_step, tr.adamw_update = counted, timed(update_fn, "optimizer")
        LM.loss = timed(loss_fn, "forward")
        try:
            with contextlib.redirect_stdout(out):
                hist = tr.main([*argv, "--device", "cuda"])
        finally:
            tr.train_step, tr.adamw_update, LM.loss = \
                step_fn, update_fn, loss_fn
        gc.collect()
        torch.cuda.empty_cache()
        return hist, out.getvalue()

    # 1. full minicpm-2b
    cfg = get_config(TRAIN_ARCH)
    n_layers = cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trace_after[0] = TRAIN_STEPS
    hist, text = cli(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                      "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                      "--lr", TRAIN_LR])
    trace_after[0] = None
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    traced = device_kernels_ms(lambda: step_fn(*last), reps=1)
    last.clear()
    gc.collect()
    torch.cuda.empty_cache()
    want = train_launches(cfg, TRAIN_SEQ)
    if want["flash_attention"] != n_layers or \
            len(hist) != TRAIN_STEPS or per_step != [want] * TRAIN_STEPS:
        raise AssertionError(f"{TRAIN_ARCH}: launches per step {per_step}, "
                             f"expected {want} x {TRAIN_STEPS}")
    want_routes = {"tensor_cores": n_layers, "cuda_cores": 0}
    if per_step_routes != [want_routes] * TRAIN_STEPS:
        raise AssertionError(f"{TRAIN_ARCH}: backward routes per step "
                             f"{per_step_routes}, expected {want_routes}")
    losses = [h["loss"] for h in hist]
    if not all(finite(h["loss"]) and finite(h["grad_norm"]) for h in hist) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"{TRAIN_ARCH}: losses {losses}, grad norms "
                             f"{[h['grad_norm'] for h in hist]}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    secs = [h["seconds"] for h in hist]
    steady = statistics.median(secs[1:])
    fwd = [t for w, t in split if w == "forward"]
    opt = [t for w, t in split if w == "optimizer"]
    steps_split = [{"forward": f, "optimizer": o,
                    "backward_and_rest": t - f - o}
                   for f, o, t in zip(fwd, opt, secs)]
    busy = sum(traced.values())
    step_device = {
        "ms": busy,
        "idle_share_of_steady_step": 1 - busy / 1e3 / steady if busy else None,
        "flash_attention_bwd_ms": sum(t for k, t in traced.items()
                                      if k.startswith("attn_bwd_")),
        "flash_attention_ms": sum(t for k, t in traced.items()
                                  if k.startswith("flash_fwd_")),
        "top_kernels_ms": dict(sorted(traced.items(),
                                      key=lambda kv: -kv[1])[:12])}
    emit({"phase": "train", "arch": TRAIN_ARCH, "card": card_line(),
          "params": param_count(LM(cfg, max_seq=TRAIN_SEQ,
                                   device="cpu").spec),
          "layers": n_layers, "d_model": cfg.d_model,
          "vocab": [cfg.vocab_size, cfg.padded_vocab], "dtype": "bfloat16",
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
          "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
          "lrs": [h["lr"] for h in hist], "seconds_per_step": secs,
          "steady_seconds_per_step": steady,
          "tokens_per_s": [tokens / t for t in secs],
          "steady_tokens_per_s": tokens / steady,
          "split_seconds": steps_split, "traced_step_device": step_device,
          "lr": float(TRAIN_LR),
          "peak_memory_bytes": peak,
          "model_memory": beside_peak(
              memory_model(cfg, "train", TRAIN_SEQ, TRAIN_BATCH), peak),
          "wall_seconds_with_init": wall,
          "launches_per_step": want, "bwd_routes_per_step": want_routes,
          "cli": text.splitlines()})

    # 2. the checkpoint leg, full demo-100m
    t_leg = time.perf_counter()
    per_step.clear()
    per_step_routes.clear()
    split.clear()
    states.update({2: [], 4: []})   # the unbroken run's step 2, the resumed
    hash_before = state_kernel_counts()
    ckdir = tmp / "train-ckpt"
    argv = ["--arch", "demo-100m", "--steps", "4", "--batch", str(DEMO_BATCH),
            "--seq", str(DEMO_SEQ), "--ckpt-codec", "none"]
    full, text = cli([*argv, "--ckpt-dir", str(ckdir), "--ckpt-every", "2"])
    cut = tmp / "train-ckpt-at2"
    shutil.copytree(ckdir, cut)
    os.remove(cut / "manifest-00000004.json")
    t_resume = time.perf_counter()
    resumed, text2 = cli([*argv, "--ckpt-dir", str(cut), "--resume",
                          "--ckpt-every", "100"])
    t_resume = time.perf_counter() - t_resume
    hashes = {k: n - hash_before.get(k, 0)
              for k, n in state_kernel_counts().items()}
    if "resumed from step 2" not in text2 or \
            [h["step"] for h in resumed] != [2, 3]:
        raise AssertionError(f"demo-100m resume: {text2}")
    saved, restored = states.pop(2), states.pop(4)
    if [p for p, _ in saved] != [p for p, _ in restored] or not all(
            a.dtype == b.dtype and torch.equal(a, b)
            for (_, a), (_, b) in zip(saved, restored)):
        raise AssertionError("demo-100m resume: the restored parameters or "
                             "optimizer state differ from those saved")
    n_state = len(saved)
    del saved, restored
    diffs = [abs(r["loss"] - f["loss"]) for r, f in zip(resumed, full[2:])]
    if max(diffs) > RESUME_LOSS_TOL:
        raise AssertionError(f"demo-100m: resumed losses "
                             f"{[h['loss'] for h in resumed]}, unbroken "
                             f"{[h['loss'] for h in full[2:]]}")
    if not hashes.get("block_hash_fold", 0) + hashes.get("block_hash", 0):
        raise AssertionError(f"demo-100m checkpoints: no hash launch {hashes}")
    emit({"phase": "train", "arch": "demo-100m", "leg": "checkpoint",
          "card": card_line(), "batch": DEMO_BATCH, "seq": DEMO_SEQ,
          "losses": [h["loss"] for h in full],
          "resumed_losses": [h["loss"] for h in resumed],
          "resumed_max_abs_diff": max(diffs), "tolerance": RESUME_LOSS_TOL,
          "restored_leaves_bit_equal": n_state,
          "hash_launches": hashes, "resume_wall_seconds": t_resume,
          "cli": text.splitlines() + text2.splitlines(),
          "seconds": time.perf_counter() - t_leg})

    # 3. full mamba2-370m through the CLI, and 4. recurrentgemma-9b at full
    # width cut to RG_TRAIN_LAYERS layers through the CLI's step function
    def scan_leg(arch, cfg, batch, seq, run):
        """Runs ``run()`` (-> per-step history) with the counts per step,
        the peak memory and one traced step after it; checks the launches
        per step (every flash backward on the tensor cores), finite and
        falling losses; emits the leg's line."""
        per_step.clear()
        per_step_routes.clear()
        split.clear()
        torch.cuda.synchronize()
        at_start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trace_after[0] = TRAIN_STEPS
        hist, text = run()
        trace_after[0] = None
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        traced = device_kernels_ms(lambda: step_fn(*last), reps=1)
        last.clear()
        gc.collect()
        torch.cuda.empty_cache()
        want = train_launches(cfg, seq)
        if len(hist) != TRAIN_STEPS or per_step != [want] * TRAIN_STEPS:
            raise AssertionError(f"{arch}: launches per step {per_step}, "
                                 f"expected {want} x {TRAIN_STEPS}")
        want_routes = {"tensor_cores": want["flash_attention_bwd"],
                       "cuda_cores": 0}
        if per_step_routes != [want_routes] * TRAIN_STEPS:
            raise AssertionError(f"{arch}: backward routes per step "
                                 f"{per_step_routes}, expected {want_routes}")
        losses = [h["loss"] for h in hist]
        if not all(finite(h["loss"]) and finite(h["grad_norm"])
                   for h in hist) or not losses[-1] < losses[0]:
            raise AssertionError(f"{arch}: losses {losses}, grad norms "
                                 f"{[h['grad_norm'] for h in hist]}")
        secs = [h["seconds"] for h in hist]
        steady = statistics.median(secs[1:])
        busy = sum(traced.values())
        scan_bwd = sum(t for k, t in traced.items() if k.startswith("ssd_bwd_")
                       or k == "rglru_scan_bwd_kernel")
        emit({"phase": "train", "arch": arch, "card": card_line(),
              "params": param_count(LM(cfg, max_seq=seq, device="cpu").spec),
              "layers": cfg.num_layers, "layer_kinds": cfg.layer_kinds(),
              "d_model": cfg.d_model, "dtype": "bfloat16", "batch": batch,
              "seq": seq, "steps": TRAIN_STEPS, "lr": float(TRAIN_LR),
              "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
              "seconds_per_step": secs, "steady_seconds_per_step": steady,
              "tokens_per_s": [batch * seq / t for t in secs],
              "steady_tokens_per_s": batch * seq / steady,
              "peak_memory_bytes": peak, "allocated_at_start": at_start,
              "model_memory": beside_peak(
                  memory_model(cfg, "train", seq, batch), peak),
              "wall_seconds_with_init": wall, "launches_per_step": want,
              "bwd_routes_per_step": want_routes,
              "traced_step_device": {
                  "ms": busy,
                  "idle_share_of_steady_step":
                      1 - busy / 1e3 / steady if busy else None,
                  "scan_bwd_ms": scan_bwd,
                  "flash_attention_bwd_ms": sum(
                      t for k, t in traced.items()
                      if k.startswith("attn_bwd_")),
                  "top_kernels_ms": dict(sorted(traced.items(),
                                                key=lambda kv: -kv[1])[:12])},
              "cli": text.splitlines()})

    mcfg = get_config(MAMBA_TRAIN_ARCH)
    scan_leg(MAMBA_TRAIN_ARCH, mcfg, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ,
             lambda: cli(["--arch", MAMBA_TRAIN_ARCH, "--steps",
                          str(TRAIN_STEPS), "--batch", str(MAMBA_TRAIN_BATCH),
                          "--seq", str(MAMBA_TRAIN_SEQ), "--lr", TRAIN_LR]))

    rcfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                               num_layers=RG_TRAIN_LAYERS)

    def rg_run():
        """The CLI's loop (``train.main``) for a config the CLI cannot name:
        seeded bf16 weights from ``LM.init``, ``TokenPipeline`` batches, one
        ``train_step`` a step."""
        tc = TrainConfig(learning_rate=float(TRAIN_LR),
                         total_steps=TRAIN_STEPS,
                         warmup_steps=max(TRAIN_STEPS // 10, 1),
                         schedule=rcfg.schedule)
        lm = LM(rcfg, max_seq=RG_TRAIN_SEQ, device="cuda")
        pipe = TokenPipeline(rcfg, ShapeConfig("smoke", "train", RG_TRAIN_SEQ,
                                               RG_TRAIN_BATCH), seed=0)
        params = lm.init(tc.seed, torch.bfloat16)
        opt = init_opt_state(params)
        hist, lines = [], []
        tr.train_step, tr.adamw_update = counted, timed(update_fn,
                                                        "optimizer")
        LM.loss = timed(loss_fn, "forward")
        try:
            for step in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                params, opt, m = tr.train_step(lm, tc, params, opt,
                                               pipe.train_batch(step))
                lm.params = params
                loss = float(m["loss"])
                hist.append({"step": step, "loss": loss,
                             "lr": float(m["lr"]),
                             "grad_norm": float(m["grad_norm"]),
                             "seconds": time.perf_counter() - t0})
                lines.append(f"step {step} loss {loss:.4f} "
                             f"{hist[-1]['seconds']:.2f}s")
        finally:
            tr.train_step, tr.adamw_update, LM.loss = \
                step_fn, update_fn, loss_fn
        del lm, params, opt
        gc.collect()
        torch.cuda.empty_cache()
        return hist, "\n".join(lines)

    scan_leg("recurrentgemma-9b", rcfg, RG_TRAIN_BATCH, RG_TRAIN_SEQ, rg_run)
    launches = {**state_kernel_counts(), **lm_launches()}
    emit({"phase": "train", "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    return launches


def phase_train_agree() -> None:
    """Reduced yi-6b, minicpm-2b, qwen2-moe-a2.7b, internvl2-2b,
    whisper-tiny, mamba2-370m and recurrentgemma-9b (seq 48: full causal
    attention through flash, and 64: banded) in f32 with the same weights
    and batch: one ``LM.loss`` and its backward on the card (the flash,
    SSD and RG-LRU forward and backward kernels) and on the CPU (the plain
    versions and backward formulas, which the CPU tests hold to the JAX
    reference): the loss within 1e-5, every gradient leaf within 1e-4 of
    its max-abs (1e-3 for mamba2), exactly one forward and one backward
    launch per attention layer (the flash backward on its CUDA-core route,
    f32), ssm layer and rec layer on the card and none on the CPU; then two
    ``adamw_update`` steps on each side fed the CPU's gradients: every
    master weight within 1e-6 of its leaf's max-abs."""
    import torch

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.reducer import tree_flatten_with_path, \
        tree_map_with_path
    from repro_torch.data import TokenPipeline
    from repro_torch.models import LM
    from repro_torch.optim import adamw_update, init_opt_state

    fk = lm_kernels()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    loss_errs, grad_errs, master_errs, ran = {}, {}, {}, {}
    for arch, S, grad_tol in TRAIN_AGREE:
        name = f"{arch}/{S}"
        cfg = get_config(arch, reduced=True)
        params = LM(cfg, max_seq=S, device="cpu").init(SEED, torch.float32)
        batch = TokenPipeline(cfg, ShapeConfig("t", "train", S, 2),
                              seed=SEED).train_batch(0)
        step_launches = train_launches(cfg, S)
        fwd = step_launches["flash_attention"]
        loss, grads, trees = {}, {}, {}
        for dev in ("cuda", "cpu"):
            lm = LM(cfg, max_seq=S, device=dev)
            p = lm.load_reference(params)
            tree_map_with_path(lambda _, t: t.requires_grad_(True), p)
            before, routes = lm_launches(), dict(fk.BWD_ROUTE_LAUNCHES)
            value, _ = lm.loss(p, batch)
            value.backward()
            got = {k: n - before[k] for k, n in lm_launches().items()}
            got.update({k: n - routes[k]
                        for k, n in fk.BWD_ROUTE_LAUNCHES.items()})
            want = ({**step_launches, "cuda_cores": fwd, "tensor_cores": 0}
                    if dev == "cuda" else {k: 0 for k in got})
            if got != want:
                raise AssertionError(f"{name} on {dev}: launches {got}, "
                                     f"expected {want}")
            loss[dev] = float(value.detach())
            grads[dev] = {k: t.grad.detach().cpu()
                          for k, t in tree_flatten_with_path(p)}
            trees[dev] = p
        if abs(loss["cuda"] - loss["cpu"]) > 1e-5:
            raise AssertionError(f"{name}: loss {loss}")
        worst = 0.0
        for k, want in grads["cpu"].items():
            err = float((grads["cuda"][k] - want).abs().max())
            scale = max(float(want.abs().max()), 1e-30)
            if err > grad_tol * scale:
                raise AssertionError(f"{name} grad {k}: {err} of {scale}")
            worst = max(worst, err / scale)
        tc = TrainConfig(warmup_steps=1, total_steps=4, schedule=cfg.schedule)
        masters = {}
        for dev, p in trees.items():
            g = tree_map_with_path(
                lambda path, t: grads["cpu"][path].to(t.device), p)
            opt = init_opt_state(p)
            for _ in range(2):
                opt, p, _ = adamw_update(tc, opt, g, p)
            masters[dev] = dict(tree_flatten_with_path(opt.master))
        mworst = 0.0
        for k, want in masters["cpu"].items():
            err = float((masters["cuda"][k].cpu() - want).abs().max())
            scale = max(float(want.abs().max()), 1e-30)
            if err > 1e-6 * scale:
                raise AssertionError(f"{name} master {k}: {err} of {scale}")
            mworst = max(mworst, err / scale)
        loss_errs[name] = abs(loss["cuda"] - loss["cpu"])
        grad_errs[name], master_errs[name] = worst, mworst
        ran[name] = {k: n for k, n in step_launches.items() if n}
    emit({"phase": "train_agree", "dtype": "float32",
          "tolerance": {"loss": 1e-5, "master_of_max_abs": 1e-6,
                        "grad_of_max_abs": {f"{a}/{n}": t
                                            for a, n, t in TRAIN_AGREE}},
          "loss_abs_err": loss_errs, "grad_err_of_max_abs": grad_errs,
          "master_err_of_max_abs": master_errs, "card_launches": ran,
          "seconds": time.perf_counter() - t_phase})


# the distributed step's legs (one card: a 1 x 1 ("data", "model") mesh
# over NCCL): full minicpm-2b through build_train_step in both modes
# against train_step, DIST_STEPS steps each; recurrentgemma-9b at full width
# with remat, at each depth of DIST_RG_LAYERS (the first against remat none)
DIST_STEPS = 2
DIST_RG_LAYERS = (6, 9, 12)
# remat's loss and grad norm against no remat, bf16 on the card: the
# train phase's margin for a rerun of the same steps
REMAT_TOL = RESUME_LOSS_TOL


def phase_dist_train(tmp: Path) -> dict:
    """The distributed layer's data-parallel train step
    (``repro_torch.distributed.build_train_step``) at world size 1 on the
    card: NCCL with a ``FileStore`` rendezvous made here, a 1 x 1 ("data",
    "model") mesh from ``launch.mesh.make_dev_mesh``.
    1. full minicpm-2b, seeded bf16 weights, batch 2 x seq 1024 at lr 2e-5
       (the train phase's), DIST_STEPS steps of ``launch/train.py``'s
       ``train_step``, then DIST_STEPS steps of ``build_train_step`` in
       ``fsdp`` and in ``tp`` (ZeRO-1) mode from the same weights and
       batches (remat none, as ``train_step`` has), then ``train_step``
       again: every loss and grad norm and every parameter leaf the same
       bits as ``train_step``'s; seconds per step and peak device memory
       of each, the memory held before the steps (``distribute_tree``
       aliases the weights at world size 1), the per-unit gather's
       ``gather_stats`` (its high-water mark of gathered bytes: 0, since
       nothing is gathered at world size 1) and the extra memory the
       DTensor step works in beyond ``train_step``'s, in copies of the
       parameters;
    2. recurrentgemma-9b at full width cut to 6 layers, one step with
       remat full against one with remat none from the same weights and
       batch: loss and grad norm within REMAT_TOL; then remat full at 9
       and 12 layers, each peak recorded, or the out-of-memory recorded as
       the finding it is (a depth after one that ran out is not tried).
       Each arm is one cold step, so only peaks and values are reported,
       no step times.  Every step's launches checked (remat full runs
       each forward kernel twice).
    Returns the kernels' launches in the DTensor steps."""
    import dataclasses
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.reducer import (
        tree_flatten_with_path, tree_map_with_path,
    )
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import (
        DistContext, build_train_step, distribute_tree, gather_tree,
        init_sharded_opt_state,
    )
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.train import train_step
    from repro_torch.models import LM
    from repro_torch.models.layers import param_count
    from repro_torch.optim import init_opt_state

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    for m in lm_kernels():
        m.reset_launches()
    path_launches: dict = {}

    def counted(fn, *args):
        """fn(*args) with the kernels' launches added to the path's."""
        before = lm_launches()
        out = fn(*args)
        got = {k: n - before[k] for k, n in lm_launches().items()}
        for k, n in got.items():
            path_launches[k] = path_launches.get(k, 0) + n
        return out, got

    def timed_steps(step, params, opt, batches, on_path):
        """Each step between two synchronises -> (params, opt, history,
        the memory held before the first step)."""
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        hist = []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if on_path:
                (params, opt, m), got = counted(step, params, opt, b)
            else:
                params, opt, m = step(params, opt, b)
                got = None
            torch.cuda.synchronize()
            hist.append({"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "seconds": time.perf_counter() - t0,
                         "launches": got})
        return params, opt, hist, held

    def fresh_peak():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp / "dist-store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    try:
        mesh = make_dev_mesh(1, 1, device="cuda")
        # 1. full minicpm-2b: train_step, then both modes
        cfg = get_config(TRAIN_ARCH)
        shape = ShapeConfig("smoke", "train", TRAIN_SEQ, TRAIN_BATCH)
        tc = TrainConfig(learning_rate=float(TRAIN_LR), total_steps=DIST_STEPS,
                         warmup_steps=max(DIST_STEPS // 10, 1),
                         schedule=cfg.schedule, remat="none")
        lm = LM(cfg, max_seq=TRAIN_SEQ, device="cuda")
        pipe = TokenPipeline(cfg, shape, seed=0)
        batches = [pipe.train_batch(s) for s in range(DIST_STEPS)]
        p0 = lm.init(tc.seed, torch.bfloat16)
        p_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_flatten_with_path(p0))
        at_start = fresh_peak()

        def plain_leg():
            """DIST_STEPS of train_step from a clone of the weights ->
            (history, peak, memory held before the steps, parameters)."""
            fresh_peak()
            params = tree_map_with_path(lambda _, t: t.clone(), p0)
            params, opt, hist, held = timed_steps(
                lambda p, o, b: train_step(lm, tc, p, o, b), params,
                init_opt_state(params), batches, on_path=False)
            peak = torch.cuda.max_memory_allocated()
            return hist, peak, held, {k: t.cpu() for k, t in
                                      tree_flatten_with_path(params)}

        # train_step before and after the two modes (its time and memory
        # in this process, in turns)
        ref_hist, ref_peak, ref_held, want = plain_leg()
        # the step's own memory above what it was handed (the train_step
        # leg also holds a clone of the weights it starts from)
        ref_work = ref_peak - ref_held
        want_step = train_launches(cfg, TRAIN_SEQ)
        modes = {}
        for mode in ("fsdp", "tp"):
            fresh_peak()
            ctx = DistContext.create(cfg, mesh, mode=mode)
            step, (p_sh, o_sh, _) = build_train_step(lm, tc, ctx, shape)
            params = distribute_tree(p0, ctx, p_sh)
            aliased = all(
                t.to_local().data_ptr() == w.data_ptr() for (_, t), (_, w) in
                zip(tree_flatten_with_path(params),
                    tree_flatten_with_path(p0)))
            params, opt, hist, held = timed_steps(
                step, params, init_sharded_opt_state(ctx, params, o_sh),
                batches, on_path=True)
            peak = torch.cuda.max_memory_allocated()
            for h, r in zip(hist, ref_hist):
                if (h["loss"], h["grad_norm"]) != (r["loss"], r["grad_norm"]):
                    raise AssertionError(f"dist_train {mode}: loss and grad "
                                         f"norm {h} against train_step's {r}")
                if h["launches"] != want_step:
                    raise AssertionError(f"dist_train {mode}: launches "
                                         f"{h['launches']}, expected "
                                         f"{want_step}")
            got = dict(tree_flatten_with_path(gather_tree(params)))
            unequal = [k for k, t in want.items()
                       if not torch.equal(got[k].cpu(), t)]
            if unequal or sorted(got) != sorted(want):
                raise AssertionError(f"dist_train {mode}: parameters unlike "
                                     f"train_step's: {unequal[:5]}")
            modes[mode] = {
                "seconds_per_step": [h["seconds"] for h in hist],
                "peak_memory_bytes": peak, "held_before_steps": held,
                "model_memory": beside_peak(
                    memory_model(cfg, "train", TRAIN_SEQ, TRAIN_BATCH,
                                 mode=mode), peak),
                "params_alias_the_weights": aliased,
                "extra_parameter_copies": (peak - held - ref_work) / p_bytes,
                "gather_stats": dict(step.gather_stats),
                "param_leaves_bit_equal": len(want),
                "losses": [h["loss"] for h in hist],
                "grad_norms": [h["grad_norm"] for h in hist]}
            del params, opt, got, step
        again, again_peak, again_held, again_p = plain_leg()
        if [(h["loss"], h["grad_norm"]) for h in again] != \
                [(h["loss"], h["grad_norm"]) for h in ref_hist] or not all(
                    torch.equal(again_p[k], t) for k, t in want.items()):
            raise AssertionError("dist_train: train_step's rerun differs")
        del p0, want, again_p
        emit({"phase": "dist_train", "arch": TRAIN_ARCH, "card": card_line(),
              "world_size": dist.get_world_size(), "backend": dist.get_backend(),
              "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
              "params": param_count(lm.spec), "param_bytes": p_bytes,
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "dtype": "bfloat16",
              "steps": DIST_STEPS, "remat": "none",
              "train_step": {"seconds_per_step": [h["seconds"]
                                                  for h in ref_hist],
                             "peak_memory_bytes": ref_peak,
                             "model_memory": beside_peak(
                                 memory_model(cfg, "train", TRAIN_SEQ,
                                              TRAIN_BATCH), ref_peak),
                             "held_before_steps": ref_held,
                             "again_seconds_per_step": [h["seconds"]
                                                        for h in again],
                             "again_peak_memory_bytes": again_peak,
                             "again_held_before_steps": again_held,
                             "losses": [h["loss"] for h in ref_hist],
                             "grad_norms": [h["grad_norm"]
                                            for h in ref_hist]},
              "allocated_at_start": at_start, "modes": modes,
              "launches_per_step": want_step,
              "train_phase_in_perf_md": "0.379 s a step, 53.7 GB peak "
                                        "(PERF.md section 5)"})

        # 2. recurrentgemma-9b with remat
        legs = []
        rg = get_config("recurrentgemma-9b")
        rshape = ShapeConfig("smoke", "train", RG_TRAIN_SEQ, RG_TRAIN_BATCH)
        for layers in DIST_RG_LAYERS:
            if legs and not legs[-1]["fits"]:
                legs.append({"layers": layers, "fits": False,
                             "not_tried": f"{legs[-1]['layers']} layers "
                                          f"ran out of memory"})
                continue
            rcfg = dataclasses.replace(rg, num_layers=layers)
            rlm = LM(rcfg, max_seq=RG_TRAIN_SEQ, device="cuda")
            batch = TokenPipeline(rcfg, rshape, seed=0).train_batch(0)
            ctx = DistContext.create(rcfg, mesh, mode="tp")
            want_fwd = train_launches(rcfg, RG_TRAIN_SEQ)
            runs = ("none", "full") if layers == DIST_RG_LAYERS[0] else \
                ("full",)
            leg = {"layers": layers, "params": param_count(rlm.spec)}
            try:
                p0 = rlm.init(0, torch.bfloat16)
                for remat in runs:
                    fresh_peak()
                    rtc = TrainConfig(learning_rate=float(TRAIN_LR),
                                      total_steps=1, warmup_steps=1,
                                      schedule=rcfg.schedule, remat=remat)
                    step, (p_sh, o_sh, _) = build_train_step(rlm, rtc, ctx,
                                                             rshape)
                    params = distribute_tree(p0, ctx, p_sh)
                    params, opt, hist, _ = timed_steps(
                        step, params, init_sharded_opt_state(ctx, params,
                                                             o_sh),
                        [batch], on_path=True)
                    twice = 2 if remat != "none" else 1
                    expect = {k: n * (twice if k in ("flash_attention",
                                                     "rglru_scan") else 1)
                              for k, n in want_fwd.items()}
                    if hist[0]["launches"] != expect:
                        raise AssertionError(
                            f"dist_train remat {remat} at {layers} layers: "
                            f"launches {hist[0]['launches']}, expected "
                            f"{expect}")
                    rpeak = torch.cuda.max_memory_allocated()
                    leg[remat] = {"loss": hist[0]["loss"],
                                  "grad_norm": hist[0]["grad_norm"],
                                  "peak_memory_bytes": rpeak,
                                  "model_memory": beside_peak(
                                      memory_model(rcfg, "train",
                                                   RG_TRAIN_SEQ,
                                                   RG_TRAIN_BATCH, tc=rtc),
                                      rpeak),
                                  "launches": hist[0]["launches"]}
                    del params, opt, step
                leg["fits"] = True
            except torch.cuda.OutOfMemoryError as e:
                leg["fits"] = False
                leg["out_of_memory"] = str(e).splitlines()[0]
            finally:
                p0 = params = opt = step = None
                gc.collect()
                torch.cuda.empty_cache()
            if layers == DIST_RG_LAYERS[0]:
                if not leg["fits"]:
                    raise AssertionError(f"dist_train: recurrentgemma-9b at "
                                         f"{layers} layers: {leg}")
                a, b = leg["none"], leg["full"]
                for k in ("loss", "grad_norm"):
                    if abs(a[k] - b[k]) > REMAT_TOL * max(1.0, abs(a[k])):
                        raise AssertionError(f"dist_train remat full {k} "
                                             f"{b[k]} against none {a[k]}")
                leg["same_bits"] = (a["loss"], a["grad_norm"]) == \
                    (b["loss"], b["grad_norm"])
            legs.append(leg)
        emit({"phase": "dist_train", "arch": "recurrentgemma-9b",
              "card": card_line(), "batch": RG_TRAIN_BATCH,
              "seq": RG_TRAIN_SEQ, "dtype": "bfloat16", "mode": "tp",
              "tolerance": REMAT_TOL, "legs": legs,
              "train_phase_in_perf_md": "6 layers, remat none: 76.7 GB "
                                        "peak; 9 and 12 layers ran out of "
                                        "memory (PERF.md section 5)",
              "seconds": time.perf_counter() - t_phase})
    finally:
        dist.destroy_process_group()
    return path_launches


# the distributed serve steps' legs (one card: a 1 x 1 ("data", "model")
# mesh over NCCL): two serve cells at full width, each through LM, the
# fsdp steps and the tp steps with sp_decode
DIST_SERVE_CELLS = (("yi-6b", YI_BATCH, YI_PROMPT),
                    ("mamba2-370m", MAMBA_BATCH, MAMBA_PROMPT))
# the tp leg's bf16 logits against LM's: the bf16 serving tolerance of the
# CPU tests (tests/test_torch_model.py BF16_TOL); phase_serve_agree holds
# f32 only
DIST_SERVE_TOL = 5e-2
# the local-routing moe leg: LM, then the tp steps with moe_impl="shardmap"
DIST_SERVE_MOE = ("qwen2-moe-a2.7b", MOE_BATCH, MOE_PROMPT)


def card_memory() -> int:
    import torch
    return torch.cuda.get_device_properties(0).total_memory


def memory_model(cfg, kind: str, seq: int, batch: int, *, mode: str = "tp",
                 tc=None, max_seq: int | None = None) -> dict:
    """``launch.memmodel.model_memory`` of one cell on a 1 x 1 ("data",
    "model") mesh (host arithmetic over the config's spec, nothing
    allocated), against the card's memory."""
    from repro_torch.configs import TrainConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import DistContext
    from repro_torch.launch.memmodel import model_memory
    from repro_torch.models import LM

    ctx = DistContext.create(cfg, {"data": 1, "model": 1}, mode=mode)
    lm = LM(cfg, max_seq=max_seq or seq, device="cpu")
    return model_memory(cfg, ShapeConfig("smoke", kind, seq, batch), ctx,
                        tc or TrainConfig(), lm, hbm_bytes=card_memory())


def beside_peak(mm: dict, peak: int) -> dict:
    """The model's terms and total beside a measured peak."""
    return {**mm, "peak_bytes": peak, "peak_over_model": peak / mm["total"]}


def phase_dist_serve(tmp: Path) -> dict:
    """The distributed layer's serve steps
    (``repro_torch.distributed.build_prefill_step`` and
    ``build_decode_step``) at world size 1 on the card: NCCL with a
    ``FileStore`` rendezvous made here, a 1 x 1 ("data", "model") mesh from
    ``launch.mesh.make_dev_mesh``, as ``dist_train``.  For full yi-6b
    (batch 4 x prompt 2048) and full mamba2-370m (batch 8 x prompt 2000),
    seeded bf16 weights (the serve phase's), a prefill and GEN greedy
    decode steps through three paths:
    1. ``LM.prefill``/``LM.decode_step``;
    2. the steps in ``fsdp`` with ``sp_decode=False``: every logit and id
       the same bits as path 1's;
    3. the steps in ``tp`` with ``sp_decode`` (yi-6b's decode runs
       ``sp_decode_attention`` over a ``model`` group of one rank), fed
       path 1's ids: logits within DIST_SERVE_TOL of path 1's, its own
       greedy ids equal to path 1's except at near ties of path 1's
       logits.
    Each path's prefill must launch each layer's kernel once (flash 32
    times for yi-6b, SSD 48 times for mamba2-370m), its decode none.
    Prints each path's prefill seconds, decode tokens/s and peak device
    memory beside ``model_memory``'s prediction for the prefill and the
    decode shape (1 x 1 mesh, the path's mode), and the step legs'
    per-unit ``gather_stats`` (no bytes gathered at world size 1, where
    ``distribute_tree`` aliases the weights).  Then full qwen2-moe-a2.7b
    (``DIST_SERVE_MOE``) through ``LM`` and through the steps in ``tp``
    without ``sp_decode`` and with ``ctx.extra["moe_impl"] = "shardmap"``
    (``models/moe.py`` ``moe_ffn_shardmap``, local routing): at world size
    1 the layout is EP with every expert on the rank and both capacity
    formulas give 688 (prefill) and 8 (decode), so every logit and id must
    be ``LM``'s bits; every moe layer of the step leg's prefill and decode
    steps must go through ``moe_ffn_shardmap`` (24 a step) and ``LM``'s
    none; flash 24 launches a prefill, none a decode.  Also holds
    ``sp_decode_attention`` once against the plain cache write and decode
    attention at yi-6b's decode shape in bf16: caches bit-equal, output
    within flash's bf16 tolerance.  Returns the kernels' launches of
    paths 2 and 3."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import (
        DistContext, build_decode_step, build_prefill_step, distribute_tree,
        sp_decode_attention,
    )
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import LM
    from repro_torch.models.attention import (
        cache_write_plain, decode_attention_plain,
    )

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    for m in lm_kernels():
        m.reset_launches()
    path_launches: dict = {}

    def local(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def serve(prefill, decode, drive=None):
        """prefill() -> (logits, cache); GEN steps of decode(cache, tok) on
        the greedy ids (or on ``drive``'s) -> each step's logits (kept on
        the card), the greedy ids, seconds, peak memory and launches of
        prefill and decode."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = lm_launches()
        t0 = time.perf_counter()
        logits, cache = prefill()
        logits = local(logits)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        mid = lm_launches()
        out, ids = [logits.clone()], []
        t0 = time.perf_counter()
        tok = logits.argmax(dim=-1)[:, None]
        for s in range(GEN):
            ids.append(tok)
            logits, cache = decode(cache, tok if drive is None
                                   else drive[:, s:s + 1])
            logits = local(logits)
            out.append(logits.clone())
            tok = logits.argmax(dim=-1)[:, None]
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        after = lm_launches()
        del cache
        return {"logits": out, "ids": torch.cat(ids, dim=1),
                "prefill_seconds": t_prefill, "decode_seconds": t_decode,
                "peak_memory_bytes": peak, "held_before": held,
                "prefill_launches": {k: mid[k] - before[k] for k in mid},
                "decode_launches": {k: after[k] - mid[k] for k in mid}}

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp / "dist-serve-store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    try:
        mesh = make_dev_mesh(1, 1, device="cuda")
        cells = []
        for arch, batch, prompt in DIST_SERVE_CELLS:
            cfg = serve_config(arch)
            total = prompt + GEN
            pshape = ShapeConfig("smoke", "prefill", prompt, batch)
            dshape = ShapeConfig("smoke", "decode", total, batch)
            inputs = TokenPipeline(cfg, pshape, seed=SEED).prefill_batch(0)
            tokens = torch.from_numpy(inputs["tokens"]).cuda()
            lm = LM(cfg, max_seq=total, device="cuda")
            weights = lm.init(SEED, torch.bfloat16)
            want = expected_launches(cfg, prompt)
            none = {k: 0 for k in want}
            legs = {"lm": serve(
                lambda: lm.prefill(tokens, cache_len=total),
                lm.decode_step)}
            for mode, sp in (("fsdp", False), ("tp", True)):
                ctx = DistContext.create(cfg, mesh, mode=mode, sp_decode=sp)
                pf, (p_sh, _, _, _) = build_prefill_step(lm, ctx, pshape,
                                                         cache_len=total)
                df, _ = build_decode_step(lm, ctx, dshape)
                params = distribute_tree(weights, ctx, p_sh)
                leg = serve(lambda: pf(params, {"tokens": tokens}),
                            lambda c, t: df(params, c, {"token": t}),
                            drive=None if mode == "fsdp"
                            else legs["lm"]["ids"])
                leg["mode"], leg["sp_decode"] = mode, sp
                leg["gather_stats"] = {"prefill": dict(pf.gather_stats),
                                       "decode": dict(df.gather_stats)}
                legs[mode] = leg
                for k, n in leg["prefill_launches"].items():
                    path_launches[k] = path_launches.get(k, 0) + n
                del params, pf, df
            for name, leg in legs.items():
                if leg["prefill_launches"] != want or \
                        leg["decode_launches"] != none:
                    raise AssertionError(
                        f"dist_serve {arch} {name}: prefill launches "
                        f"{leg['prefill_launches']}, decode "
                        f"{leg['decode_launches']}; expected {want} and none")
            ref = legs["lm"]
            fsdp = legs["fsdp"]
            if not torch.equal(fsdp["ids"], ref["ids"]) or not all(
                    a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(fsdp["logits"], ref["logits"])):
                raise AssertionError(f"dist_serve {arch}: the fsdp steps' "
                                     f"logits or ids are not LM's bits")
            tp = legs["tp"]
            errs, flips = [], []
            for s, (a, b) in enumerate(zip(tp["logits"], ref["logits"])):
                a, b = a.float(), b.float()
                err = (a - b).abs()
                errs.append(float(err.max()))
                if bool((err > DIST_SERVE_TOL * (1 + b.abs())).any()):
                    raise AssertionError(
                        f"dist_serve {arch} tp: step {s} logits off by "
                        f"{errs[-1]} (tolerance {DIST_SERVE_TOL})")
                if s == GEN:
                    break
                mine, theirs = a.argmax(dim=-1), b.argmax(dim=-1)
                for r in torch.nonzero(mine != theirs).ravel().tolist():
                    gap = float(b[r, theirs[r]] - b[r, mine[r]])
                    if gap > 2 * DIST_SERVE_TOL * (1 + float(b[r].abs().max())):
                        raise AssertionError(
                            f"dist_serve {arch} tp: step {s} row {r} takes "
                            f"id {int(mine[r])}, LM's {int(theirs[r])}, "
                            f"{gap} apart in LM's logits")
                    flips.append({"step": s, "row": r, "gap": gap})
            ids = ref["ids"]
            if ids.min() < 0 or ids.max() >= cfg.padded_vocab:
                raise AssertionError(f"dist_serve {arch}: ids outside "
                                     f"[0, {cfg.padded_vocab})")
            mm = {m: {"prefill": memory_model(cfg, "prefill", prompt, batch,
                                              mode=m, max_seq=total),
                      "decode": memory_model(cfg, "decode", total, batch,
                                             mode=m, max_seq=total)}
                  for m in ("fsdp", "tp")}
            report = {}
            for name, leg in legs.items():
                m = mm["fsdp" if name == "lm" else name]
                report[name] = {
                    "prefill_seconds": leg["prefill_seconds"],
                    "decode_seconds": leg["decode_seconds"],
                    "decode_tokens_per_s": GEN * batch / leg["decode_seconds"],
                    "peak_memory_bytes": leg["peak_memory_bytes"],
                    "held_before": leg["held_before"],
                    "model_memory": {
                        k: beside_peak(v, leg["peak_memory_bytes"])
                        for k, v in m.items()},
                    "prefill_launches": {k: n for k, n in
                                         leg["prefill_launches"].items() if n}}
                if "gather_stats" in leg:
                    report[name]["gather_stats"] = leg["gather_stats"]
            report["tp"]["max_abs_logit_err_vs_lm"] = max(errs)
            report["tp"]["near_tie_id_flips"] = flips
            report["fsdp"]["same_bits_as_lm"] = True
            cells.append({"arch": arch, "batch": batch, "prompt_len": prompt,
                          "gen": GEN, "legs": report,
                          "ids_sample": ids[0, :8].tolist()})
            del legs, ref, fsdp, tp, weights, lm
            gc.collect()
            torch.cuda.empty_cache()

        moe_cell = dist_serve_shardmap(mesh, serve, path_launches)

        # sp_decode_attention against the plain write and attention at
        # yi-6b's decode shape, bf16, a model group of one rank
        yi = serve_config("yi-6b")
        hd, total = yi.resolved_head_dim, YI_PROMPT + GEN
        g = torch.Generator(device="cuda").manual_seed(SEED)

        def rand(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(
                torch.bfloat16)
        q = rand(YI_BATCH, 1, yi.num_heads, hd)
        kc, vc = (rand(YI_BATCH, yi.num_kv_heads, total, hd)
                  for _ in range(2))
        nk, nv = (rand(YI_BATCH, 1, yi.num_kv_heads, hd) for _ in range(2))
        pos = torch.tensor([YI_PROMPT, YI_PROMPT + 7, total - 1, 0],
                           dtype=torch.int32, device="cuda")[:YI_BATCH]
        k1, v1 = cache_write_plain(kc.clone(), vc.clone(), nk, nv, pos)
        want_o = decode_attention_plain(q, k1, v1, pos)
        ctx = DistContext.create(yi, mesh, mode="tp", sp_decode=True)
        got_o, k2, v2 = sp_decode_attention(ctx, q, kc.clone(), vc.clone(),
                                            nk, nv, pos)
        atol, rtol = TOL[("flash_attention", "bfloat16")]
        if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
            raise AssertionError("sp_decode_attention: caches differ from "
                                 "the plain write's")
        torch.testing.assert_close(got_o.float(), want_o.float(), atol=atol,
                                   rtol=rtol)
        sp_check = {"q": list(q.shape), "cache": list(kc.shape),
                    "dtype": "bfloat16", "tolerance": [atol, rtol],
                    "max_abs_err": float((got_o.float() - want_o.float())
                                         .abs().max()),
                    "caches_bit_equal": True}
        emit({"phase": "dist_serve", "card": card_line(),
              "world_size": dist.get_world_size(),
              "backend": dist.get_backend(),
              "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
              "dtype": "bfloat16", "tolerance": DIST_SERVE_TOL,
              "card_memory_bytes": card_memory(), "cells": cells,
              "shardmap_cell": moe_cell,
              "sp_decode_attention": sp_check, "launches": path_launches,
              "seconds": time.perf_counter() - t_phase})
    finally:
        dist.destroy_process_group()
    return path_launches


def dist_serve_shardmap(mesh, serve, path_launches: dict) -> dict:
    """``phase_dist_serve``'s local-routing leg (its docstring): full
    ``DIST_SERVE_MOE`` through ``LM`` and the tp steps with
    ``moe_impl="shardmap"`` on ``mesh``; ``serve`` is the phase's helper
    that runs a prefill and the greedy decode steps.
    Adds the step leg's prefill launches to ``path_launches``; returns the
    leg's report."""
    import gc

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import (
        DistContext, build_decode_step, build_prefill_step, distribute_tree,
    )
    from repro_torch.models import LM
    from repro_torch.models import moe

    t_leg = time.perf_counter()
    arch, batch, prompt = DIST_SERVE_MOE
    cfg = serve_config(arch)
    total = prompt + GEN
    capacities = {}
    for kind, tokens in (("prefill", batch * prompt), ("decode", batch)):
        local, glob = moe.shardmap_capacity(tokens, cfg), \
            moe._capacity(tokens, cfg)
        if local != glob:
            raise AssertionError(f"dist_serve {arch}: {kind} capacities "
                                 f"{local} (shardmap) and {glob} differ")
        capacities[kind] = local
    pshape = ShapeConfig("smoke", "prefill", prompt, batch)
    dshape = ShapeConfig("smoke", "decode", total, batch)
    tokens = torch.from_numpy(TokenPipeline(cfg, pshape, seed=SEED)
                              .prefill_batch(0)["tokens"]).cuda()
    lm = LM(cfg, max_seq=total, device="cuda")
    weights = lm.init(SEED, torch.bfloat16)
    want = expected_launches(cfg, prompt)
    if want != SERVE_LAUNCHES[arch]:
        raise AssertionError(f"dist_serve {arch}: expected launches {want}")
    none = {k: 0 for k in want}
    calls = [0]
    real = moe.moe_ffn_shardmap

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    moe.moe_ffn_shardmap = counted
    try:
        legs = {"lm": serve(lambda: lm.prefill(tokens, cache_len=total),
                            lm.decode_step)}
        legs["lm"]["shardmap_calls"], calls[0] = calls[0], 0
        ctx = DistContext.create(cfg, mesh, mode="tp", sp_decode=False)
        ctx.extra["moe_impl"] = "shardmap"
        if ctx.rules["expert_mode"] != "ep":
            raise AssertionError(f"dist_serve {arch}: expert mode "
                                 f"{ctx.rules['expert_mode']}, expected ep")
        pf, (p_sh, _, _, _) = build_prefill_step(lm, ctx, pshape,
                                                 cache_len=total)
        df, _ = build_decode_step(lm, ctx, dshape)
        params = distribute_tree(weights, ctx, p_sh)
        legs["shardmap"] = serve(lambda: pf(params, {"tokens": tokens}),
                                 lambda c, t: df(params, c, {"token": t}))
        legs["shardmap"]["shardmap_calls"] = calls[0]
        legs["shardmap"]["gather_stats"] = {"prefill": dict(pf.gather_stats),
                                            "decode": dict(df.gather_stats)}
        del params, pf, df
    finally:
        moe.moe_ffn_shardmap = real
    layers = cfg.layer_kinds().count("attn")
    for name, n in (("lm", 0), ("shardmap", layers * (1 + GEN))):
        leg = legs[name]
        if leg["shardmap_calls"] != n:
            raise AssertionError(f"dist_serve {arch} {name}: "
                                 f"{leg['shardmap_calls']} moe_ffn_shardmap "
                                 f"calls, expected {n}")
        if leg["prefill_launches"] != want or leg["decode_launches"] != none:
            raise AssertionError(
                f"dist_serve {arch} {name}: prefill launches "
                f"{leg['prefill_launches']}, decode {leg['decode_launches']};"
                f" expected {want} and none")
    for k, n in legs["shardmap"]["prefill_launches"].items():
        path_launches[k] = path_launches.get(k, 0) + n
    ref, got = legs["lm"], legs["shardmap"]
    if not torch.equal(got["ids"], ref["ids"]) or not all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(got["logits"], ref["logits"])):
        raise AssertionError(f"dist_serve {arch}: the shardmap steps' logits "
                             f"or ids are not LM's bits")
    ids = ref["ids"]
    if ids.min() < 0 or ids.max() >= cfg.padded_vocab:
        raise AssertionError(f"dist_serve {arch}: ids outside "
                             f"[0, {cfg.padded_vocab})")
    mm = {"prefill": memory_model(cfg, "prefill", prompt, batch,
                                  max_seq=total),
          "decode": memory_model(cfg, "decode", total, batch,
                                 max_seq=total)}
    report = {name: {
        "prefill_seconds": leg["prefill_seconds"],
        "decode_seconds": leg["decode_seconds"],
        "decode_tokens_per_s": GEN * batch / leg["decode_seconds"],
        "peak_memory_bytes": leg["peak_memory_bytes"],
        "held_before": leg["held_before"],
        "model_memory": {k: beside_peak(v, leg["peak_memory_bytes"])
                         for k, v in mm.items()},
        "moe_ffn_shardmap_calls": leg["shardmap_calls"],
        **({"gather_stats": leg["gather_stats"]} if "gather_stats" in leg
           else {}),
        "prefill_launches": {k: n for k, n in leg["prefill_launches"].items()
                             if n}} for name, leg in legs.items()}
    report["shardmap"]["same_bits_as_lm"] = True
    del legs, ref, got, weights, lm
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "batch": batch, "prompt_len": prompt, "gen": GEN,
            "mode": "tp", "moe_impl": "shardmap", "sp_decode": False,
            "expert_mode": "ep", "capacity": capacities, "legs": report,
            "ids_sample": ids[0, :8].tolist(),
            "seconds": time.perf_counter() - t_leg}


# ----------------------------------------------------------------------
# dist_tp: two ranks as two processes on the one card, gloo over CUDA
# tensors (NCCL refuses two ranks on one device)
# ----------------------------------------------------------------------

TP_WORLD = 2
TP_RANK_TIMEOUT = 600              # seconds a rank process may take
TP_COLLECTIVE_TIMEOUT = 120        # seconds a gloo collective may wait
# the serve legs: (arch, batch, prompt, decode steps, the sp_decode
# settings run); the ssm and hybrid legs with sp_decode on only
# (mamba2-370m has no attention, and the hybrid's window ring comes before
# sp_decode in the branch order; the CPU tests run both settings), and
# cut to TP_REC_GEN steps: a tp decode step of either took 0.28-0.49 s
# on two ranks over gloo on an H100's host (the host sets it), GEN of
# them 9-16 s a leg of the smoke's time limit
TP_REC_GEN = 8
# qwen2-moe-a2.7b's 60 experts split over the 2 ranks (EP, the global
# routing), with sp_decode on; its train leg waits for the smoke's time
# (ROADMAP: the gateway's host time first).  whisper-tiny's 6 heads split
# 3 a rank in its encoder, decoder and cross attention, its prompt over
# the pipeline's 1500 encoder frames, sp_decode off and on
TP_SERVE_LEGS = (("yi-6b", YI_BATCH, YI_PROMPT, GEN, (False, True)),
                 ("mamba2-370m", MAMBA_BATCH, MAMBA_PROMPT, TP_REC_GEN,
                  (True,)),
                 ("recurrentgemma-9b", RG_BATCH, RG_PROMPT, TP_REC_GEN,
                  (True,)),
                 ("qwen2-moe-a2.7b", MOE_BATCH, MOE_PROMPT, TP_REC_GEN,
                  (True,)),
                 ("whisper-tiny", WH_BATCH, WH_PROMPT, GEN, (False, True)))
# a moe rank's top-K may take LM's choice only where its own router logits
# of the two choices lie at most this many bf16 spacings apart: a near tie
# at bf16.  The tp residual stream differs from LM's in the last bits
# (row-split partial sums round to bf16 before the all-reduce adds them),
# and a flipped expert moves a token's output far past any tolerance on
# the logits.  LM's own bf16 floor, qwen2-moe-a2.7b at this leg's batch
# and prompt on an H100 (tools/moe_route_floor.py, PERF.md section 6): LM's
# routes lie up to 18 spacings from those of an f32 arm of the same
# weights that routes freely, and up to 22.4 in the logits of an f32 arm
# held to LM's routes as the ranks are; tp against LM holds two bf16
# runs, so the limit is twice the smaller reading.  The CPU tests'
# relative 2**-6 (tests/test_torch_model.py ROUTE_TIE_RTOL: reduced
# configs, 3 layers, logits below 1) is one spacing at logits in [2, 4),
# where full width puts the top logits
ROUTE_TIE_ULPS = 36
# the share of a moe leg's token routings a rank may take from LM's: 1.25
# times LM's own bf16 floor, 35,904 of the leg's 197,376 routings
# (0.1819) against an f32 arm held to LM's routes (35,905 against one
# routing freely; the same run of tools/moe_route_floor.py)
ROUTE_FLIP_SHARE = 0.227
# a family's serving limit where its bf16 floor passes DIST_SERVE_TOL:
# mamba2-370m's LM in bf16 lay 0.141 from an f32 arm of the same
# weights, relative to 1 + |logit| (the floor, which the phase measures
# and prints), and its tp logits 0.150 from LM's (H100, PERF.md §6)
TP_SERVE_TOL = {"mamba2-370m": 0.25}
# the train legs, full width: (arch, depths tried, most first: the first at
# which world size 1 and both ranks fit, batch, seq); minicpm-2b the
# train phase's cell, mamba2-370m and recurrentgemma-9b the train phase's
# scan cells; whisper-tiny whole (4 decoder layers, and its 4 encoder
# layers always) at the serve cell's batch, its decoder over a prompt's
# length of tokens and the 1500 frames
TP_TRAIN_LEGS = ((TRAIN_ARCH, (40, 20, 10), TRAIN_BATCH, TRAIN_SEQ),
                 (MAMBA_TRAIN_ARCH, (48, 24, 12), MAMBA_TRAIN_BATCH,
                  MAMBA_TRAIN_SEQ),
                 ("recurrentgemma-9b", (RG_TRAIN_LAYERS, 3), RG_TRAIN_BATCH,
                  RG_TRAIN_SEQ),
                 ("whisper-tiny", (4,), WH_BATCH, WH_PROMPT))
# the tp step's grad norm, and each leaf's gradient norm, against world
# size 1's, both bf16 (the row-split products' partial sums round to bf16
# before the all-reduce adds them), about 4 times the largest gaps read on
# an H100: 2.0e-3 and 5.1e-3 (step 2; world size 1 with each batch's rows
# reversed, the same sums in another order: 8.2e-4 and 1.7e-3).  A
# to_model all-reduce dropped from the first or the middle of 40 layers
# moves them past these limits, from the last not: the CPU tests, which
# hold every element of the gradients, catch that
TP_GRAD_NORM_RTOL = 1e-2
TP_LEAF_NORM_RTOL = 2e-2
TP_PROBE_ELEMS = 1024
TP_PROBE_TIMED_BYTES = 32 << 20    # the all_reduce timed in the probe
TP_PROBE_OPS = ("all_reduce_sum", "all_reduce_max", "broadcast",
                "all_gather_into_tensor", "all_gather",
                "reduce_scatter_tensor")


def tp_probe(rank: int, world: int) -> dict:
    """Which gloo collectives take CUDA tensors here, in bf16 and f32:
    each op's outcome ("ok", "wrong" or the error it raised) on this rank,
    and the median time of an all_reduce of TP_PROBE_TIMED_BYTES."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    out: dict = {}
    for dt in (torch.bfloat16, torch.float32):
        n = TP_PROBE_ELEMS
        x = torch.full((n,), float(rank + 1), dtype=dt, device=dev)
        total, top = world * (world + 1) / 2, float(world)

        def ar(op):
            y = x.clone()
            dist.all_reduce(y, op=op)
            return y

        def bc():
            y = x.clone()
            dist.broadcast(y, src=world - 1)
            return y

        def agt():
            y = x.new_empty(world * n)
            dist.all_gather_into_tensor(y, x)
            return y

        def agl():
            ys = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(ys, x)
            return torch.cat(ys)

        def rs():
            y = x.new_empty(n // world)
            dist.reduce_scatter_tensor(y, x)
            return y
        ramp = torch.arange(1, world + 1, device=dev, dtype=dt
                            ).repeat_interleave(n)
        ops = {"all_reduce_sum": (lambda: ar(dist.ReduceOp.SUM),
                                  lambda y: bool((y == total).all())),
               "all_reduce_max": (lambda: ar(dist.ReduceOp.MAX),
                                  lambda y: bool((y == top).all())),
               "broadcast": (bc, lambda y: bool((y == top).all())),
               "all_gather_into_tensor": (agt, lambda y: torch.equal(y, ramp)),
               "all_gather": (agl, lambda y: torch.equal(y, ramp)),
               "reduce_scatter_tensor": (rs, lambda y: bool(
                   (y == total).all()))}
        got = {}
        for name in TP_PROBE_OPS:
            fn, check = ops[name]
            try:
                y = fn()
                torch.cuda.synchronize()
                got[name] = "ok" if check(y) else "wrong"
            # the probe's finding is each collective's own error
            except (RuntimeError, ValueError, NotImplementedError) as e:
                got[name] = f"{type(e).__name__}: " + \
                    (str(e).splitlines() or [""])[0][:200]
            dist.barrier()
        big = torch.ones(TP_PROBE_TIMED_BYTES // x.element_size(), dtype=dt,
                         device=dev)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            dist.all_reduce(big)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        got["all_reduce_ms"] = 1e3 * statistics.median(times[1:])
        got["all_reduce_bytes"] = TP_PROBE_TIMED_BYTES
        out[str(dt).replace("torch.", "")] = got
    return out


def tp_probe_mesh(world: int) -> dict:
    """A (1, world) ("data", "model") ``DeviceMesh`` on the card over the
    gloo world, and an all_reduce over its ``model`` group."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cuda", (1, world),
                            mesh_dim_names=("data", "model"))
    y = torch.ones(8, device="cuda")
    dist.all_reduce(y, group=mesh.get_group("model"))
    return {"mesh": str(mesh), "model_group_sum": float(y[0])}


class CollectiveMeter:
    """Counts the ``torch.distributed`` collectives a rank issues (calls,
    payload bytes, seconds between two synchronises of the card) while
    installed: the dist_tp legs' TP traffic and its share of a step."""

    OPS = ("all_reduce", "all_gather_into_tensor", "all_gather", "broadcast",
           "reduce_scatter_tensor", "reduce")

    def __init__(self):
        self.counts: dict = {}
        self.real: dict = {}

    def __enter__(self):
        import torch
        import torch.distributed as dist
        for name in self.OPS:
            real = self.real[name] = getattr(dist, name)

            def wrapped(t, *a, _real=real, _name=name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _real(t, *a, **kw)
                torch.cuda.synchronize()
                arg = t[0] if isinstance(t, list) else t
                rec = self.counts.setdefault(_name, [0, 0, 0.0])
                rec[0] += 1
                rec[1] += arg.numel() * arg.element_size()
                rec[2] += time.perf_counter() - t0
                return out
            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, real in self.real.items():
            setattr(dist, name, real)

    def take(self) -> dict:
        """{op: {"calls", "bytes", "seconds"}} since the last take."""
        out = {k: {"calls": c, "bytes": b, "seconds": t}
               for k, (c, b, t) in self.counts.items()}
        self.counts = {}
        return out


def collective_totals(by_op: dict) -> tuple[int, float]:
    return (sum(v["bytes"] for v in by_op.values()),
            sum(v["seconds"] for v in by_op.values()))


class RecordRoutes:
    """While installed, each moe layer's top-K experts (``models/moe.py``
    ``_choose``, in call order) appended to ``routes`` as uint8 on the
    host: ``LM``'s choices for the tp ranks to follow at near ties."""

    def __init__(self, routes: list):
        self.routes = routes

    def __enter__(self):
        import torch

        from repro_torch.models import moe
        self.real = real = moe._choose

        def recording(logits, cfg):
            probs, gate, idx = real(logits, cfg)
            self.routes.append(idx.to(torch.uint8).cpu())
            return probs, gate, idx
        moe._choose = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._choose = self.real


class FollowRoutes:
    """While installed, each moe layer's top-K is ``routes``' next entry
    (``RecordRoutes``' from ``LM``'s run of the same tokens) where the
    rank's own top-K differs from it, and only where that is a near tie in
    the rank's own router logits: at each of the K places the rank's
    logits of its expert and of LM's at most ``limit`` (ROUTE_TIE_ULPS)
    bf16 spacings (at the larger magnitude of the two) apart; a wider gap
    raises.  ``flips`` counts the tokens taken over by their gap in
    spacings (``ulps``), keeps each call's largest gap (``max_by_call``)
    and the first few (``sample``); ``routings`` counts every token
    routed; on leaving, every entry of ``routes`` must have been read."""

    def __init__(self, routes: list, limit: float = ROUTE_TIE_ULPS):
        self.routes, self.calls, self.limit = routes, 0, limit
        self.routings = 0
        self.flips = {"ulps": {}, "max_by_call": {}, "sample": []}

    def __enter__(self):
        import torch

        from repro_torch.models import moe
        self.real = real = moe._choose

        def following(logits, cfg):
            call = self.calls
            self.calls += 1
            probs, gate, got = real(logits, cfg)
            self.routings += got.shape[0]
            want = self.routes[call].to(logits.device).long()
            rows = (got != want).any(dim=1)
            if not bool(rows.any()):
                return probs, gate, got
            lg, lw = logits.gather(1, got)[rows], logits.gather(1, want)[rows]
            exp = torch.frexp(torch.maximum(lg.abs(), lw.abs()))[1]
            gaps = ((lg - lw).abs() / torch.ldexp(torch.ones_like(lg),
                                                  exp - 8)).amax(dim=1)
            worst = float(gaps.max())
            if worst > self.limit:
                t = int(torch.nonzero(rows).ravel()[gaps.argmax()])
                raise AssertionError(
                    f"dist_tp: moe call {call} token {t}: the rank's "
                    f"experts {got[t].tolist()} at logits "
                    f"{logits[t, got[t]].tolist()}, LM's "
                    f"{want[t].tolist()} at {logits[t, want[t]].tolist()}: "
                    f"{worst} bf16 spacings apart, beyond a near tie "
                    f"({self.limit})")
            for u, n in zip(*(x.tolist() for x in torch.unique(
                    gaps, return_counts=True))):
                self.flips["ulps"][u] = self.flips["ulps"].get(u, 0) + n
            self.flips["max_by_call"][call] = worst
            if len(self.flips["sample"]) < 8:
                self.flips["sample"] += [
                    {"call": call, "token": t} for t in
                    torch.nonzero(rows).ravel()[:8].tolist()]
            gate = torch.gather(probs, 1, want)
            if cfg.norm_topk_prob:
                gate = gate / gate.sum(dim=-1, keepdim=True)
            return probs, gate, want
        moe._choose = following
        return self

    def __exit__(self, exc_type, *exc):
        from repro_torch.models import moe
        moe._choose = self.real
        if exc_type is None and self.calls != len(self.routes):
            raise AssertionError(f"dist_tp: {self.calls} moe calls on the "
                                 f"rank, {len(self.routes)} in LM's run")


def tp_mesh_memory(cfg, kind: str, seq: int, batch: int, *, tc=None,
                   max_seq: int | None = None) -> dict:
    """``model_memory`` of one cell in tp on the (1, TP_WORLD) mesh."""
    from repro_torch.configs import TrainConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import DistContext
    from repro_torch.launch.memmodel import model_memory
    from repro_torch.models import LM

    ctx = DistContext.create(cfg, {"data": 1, "model": TP_WORLD}, mode="tp")
    lm = LM(cfg, max_seq=max_seq or seq, device="cpu")
    return model_memory(cfg, ShapeConfig("smoke", kind, seq, batch), ctx,
                        tc or TrainConfig(), lm, hbm_bytes=card_memory())


def tp_rank_serve(rank: int, tmp: Path, arch: str, batch: int, prompt: int,
                  gen: int, sps: tuple) -> dict:
    """A serve leg on this rank: full ``arch`` in tp on the (1, 2) gloo
    mesh, its weights made from SEED as the parent's ``LM`` made them (the
    ranks in turn, each freeing its full weights once it holds its blocks,
    so that two full copies never share the card), then, with each
    ``sp_decode`` setting of ``sps``, a prefill and ``gen`` decode steps
    driven by ``LM``'s greedy ids; a moe config's layers follow ``LM``'s
    routes at near ties (``FollowRoutes``).  Rank 0 saves each step's full
    logits; every rank returns its times, launches, peak memory,
    collectives, route flips and ``gather_stats``, and the leg's seconds;
    the weights are freed."""
    import contextlib
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.reducer import tree_flatten_with_path
    from repro_torch.distributed import (
        DistContext, build_decode_step, build_prefill_step, distribute_tree,
    )
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import LM

    t_leg = time.perf_counter()
    cfg = serve_config(arch)
    total = prompt + gen
    inputs = torch.load(tmp / f"serve-inputs-{arch}.pt")
    gc.collect()
    torch.cuda.empty_cache()
    tokens, drive = inputs["tokens"].cuda(), inputs["ids"].cuda()
    # an encdec's prompt: its encoder frames beside the tokens
    prompt_batch = {"tokens": tokens, **(
        {"encoder_frames": inputs["encoder_frames"].cuda()}
        if "encoder_frames" in inputs else {})}
    mesh = make_dev_mesh(1, TP_WORLD, device="cuda", backend="gloo")
    lm = LM(cfg, max_seq=total, device="cuda")
    pshape = ShapeConfig("smoke", "prefill", prompt, batch)
    dshape = ShapeConfig("smoke", "decode", total, batch)
    params = None
    for turn in range(TP_WORLD):
        if turn == rank:
            ctx = DistContext.create(cfg, mesh, mode="tp", sp_decode=sps[0])
            _, (p_sh, _, _, _) = build_prefill_step(lm, ctx, pshape,
                                                    cache_len=total)
            params = distribute_tree(lm.init(SEED, torch.bfloat16), ctx,
                                     p_sh)
            lm.params = None
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    t_weights = time.perf_counter() - t_leg
    legs = {}
    with CollectiveMeter() as meter:
        for sp in sps:
            ctx = DistContext.create(cfg, mesh, mode="tp", sp_decode=sp)
            pf, _ = build_prefill_step(lm, ctx, pshape, cache_len=total)
            df, _ = build_decode_step(lm, ctx, dshape)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            meter.take()
            follow = (FollowRoutes(inputs["routes"])
                      if "routes" in inputs else contextlib.nullcontext())
            with follow:
                before = lm_launches()
                t0 = time.perf_counter()
                logits, cache = pf(params, prompt_batch)
                torch.cuda.synchronize()
                t_prefill = time.perf_counter() - t0
                coll_prefill = meter.take()
                mid = lm_launches()
                out = [full_logits(logits, ctx)]
                t_decode, coll_decode = 0.0, {}
                for s in range(gen):
                    meter.take()    # the comparison's gather, not the step's
                    t0 = time.perf_counter()
                    logits, cache = df(params, cache,
                                       {"token": drive[:, s:s + 1]})
                    torch.cuda.synchronize()
                    t_decode += time.perf_counter() - t0
                    for op, rec in meter.take().items():
                        acc = coll_decode.setdefault(
                            op, {"calls": 0, "bytes": 0, "seconds": 0.0})
                        for k in acc:
                            acc[k] += rec[k]
                    out.append(full_logits(logits, ctx))
                after = lm_launches()
            peak = torch.cuda.max_memory_allocated()
            if rank == 0:
                torch.save(out, tmp / f"serve-logits-{arch}-{int(sp)}.pt")
            legs["sp" if sp else "nosp"] = {
                "sp_decode": sp, "prefill_seconds": t_prefill,
                "decode_seconds": t_decode,
                "decode_tokens_per_s": gen * batch / t_decode,
                "peak_memory_bytes": peak, "held_before": held,
                "model_memory": {
                    "prefill": beside_peak(tp_mesh_memory(
                        cfg, "prefill", prompt, batch, max_seq=total), peak),
                    "decode": beside_peak(tp_mesh_memory(
                        cfg, "decode", total, batch, max_seq=total), peak)},
                "prefill_launches": {k: mid[k] - before[k] for k in mid},
                "decode_launches": {k: after[k] - mid[k] for k in mid},
                "collectives": {"prefill": coll_prefill,
                                "decode_all_steps": coll_decode},
                "gather_stats": {"prefill": dict(pf.gather_stats),
                                 "decode": dict(df.gather_stats)},
                **({"route_flips": sum(follow.flips["ulps"].values()),
                    "routings": follow.routings,
                    "route_flip_ulps": {str(u): n for u, n in sorted(
                        follow.flips["ulps"].items())},
                    "route_flip_max_ulps_by_call":
                        follow.flips["max_by_call"],
                    "route_flips_sample": follow.flips["sample"][:8]}
                   if "routes" in inputs else {})}
            del cache, logits, pf, df
    held = sum(t.to_local().numel() * t.element_size()
               for _, t in tree_flatten_with_path(params))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"legs": legs, "local_param_bytes": held,
            "weights_seconds": t_weights,
            "seconds": time.perf_counter() - t_leg}


def full_logits(logits, ctx):
    """A serve step's logits DTensor (this rank's vocab block) -> the
    whole logits on the host, gathered with ``all_gather_into_tensor``:
    ``full_tensor``'s functional collective ends in a segmentation fault
    on gloo over CUDA tensors (torch 2.11 on the card's machine)."""
    from repro_torch.distributed import tensor_parallel as tp
    local = logits.to_local()
    return tp.gather_model(local, local.dim() - 1,
                           tp.model_group(ctx)).float().cpu()


def tp_train_setup(arch: str, layers: int):
    """(config at ``layers`` of ``arch``'s, shape, TrainConfig, batches):
    the train leg's cell (TP_TRAIN_LEGS), cut in depth only."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenPipeline

    batch, seq = {a: (b, s) for a, _, b, s in TP_TRAIN_LEGS}[arch]
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    shape = ShapeConfig("smoke", "train", seq, batch)
    tc = TrainConfig(learning_rate=float(TRAIN_LR), total_steps=DIST_STEPS,
                     warmup_steps=max(DIST_STEPS // 10, 1),
                     schedule=cfg.schedule, remat="none")
    pipe = TokenPipeline(cfg, shape, seed=0)
    return cfg, shape, tc, [pipe.train_batch(s) for s in range(DIST_STEPS)]


def tp_train_steps(mesh, arch: str, layers: int, meter=None,
                   reverse=False) -> dict:
    """DIST_STEPS of ``build_train_step`` in tp on ``mesh`` from weights
    made from the TrainConfig's seed -> losses, grad norms, each leaf's
    squared gradient norm, each step's seconds, launches and (with
    ``meter``) collectives, the peak memory, the memory held before the
    steps and ``gather_stats``.  ``reverse``: each batch's rows in reverse
    order (the same mean loss, its sums in another order)."""
    import gc

    import torch

    from repro_torch.distributed import (
        DistContext, build_train_step, distribute_tree,
        init_sharded_opt_state,
    )
    from repro_torch.models import LM

    cfg, shape, tc, batches = tp_train_setup(arch, layers)
    if reverse:
        batches = [{k: v[::-1].copy() for k, v in b.items()}
                   for b in batches]
    lm = LM(cfg, max_seq=shape.seq_len, device="cuda")
    ctx = DistContext.create(cfg, mesh, mode="tp")
    step, (p_sh, o_sh, _) = build_train_step(lm, tc, ctx, shape)
    params = distribute_tree(lm.init(tc.seed, torch.bfloat16), ctx, p_sh)
    lm.params = None
    opt = init_sharded_opt_state(ctx, params, o_sh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hist = []
    for b in batches:
        if meter is not None:
            meter.take()
        before = lm_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        hist.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "seconds": time.perf_counter() - t0,
                     "grad_sq": {k: float(v)
                                 for k, v in step.grad_sq.items()},
                     "launches": {k: n - before[k]
                                  for k, n in lm_launches().items()},
                     **({"collectives": meter.take()} if meter else {})})
    return {"steps": hist,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "held_before_steps": held, "gather_stats": dict(step.gather_stats)}


def tp_rank_train(arch: str, layers: int) -> dict:
    """A train leg on this rank at ``layers`` layers (the (1, 2) gloo
    mesh); an out-of-memory is recorded (its caller ends the process)."""
    import gc

    import torch

    from repro_torch.launch.mesh import make_dev_mesh

    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_dev_mesh(1, TP_WORLD, device="cuda", backend="gloo")
    try:
        with CollectiveMeter() as meter:
            out = tp_train_steps(mesh, arch, layers, meter)
    except torch.cuda.OutOfMemoryError as e:
        return {"oom": str(e).splitlines()[0]}
    finally:
        gc.collect()
        torch.cuda.empty_cache()
    cfg, shape, tc, _ = tp_train_setup(arch, layers)
    out["model_memory"] = beside_peak(
        tp_mesh_memory(cfg, "train", shape.seq_len, shape.global_batch,
                       tc=tc), out["peak_memory_bytes"])
    return out


def tp_world_size_1(tmp: Path, arch: str, layers: int) -> dict:
    """``build_train_step`` at world size 1 (NCCL, in this process) at a
    train leg's depth, then again with each batch's rows reversed ->
    {"ref", "rev"}, or {"oom"} where it does not fit; freed after."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_dev_mesh

    gc.collect()
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp / f"tp-ref-store-{arch}-{layers}"), 1), rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        ref = tp_train_steps(make_dev_mesh(1, 1, device="cuda"), arch, layers)
        gc.collect()
        torch.cuda.empty_cache()
        rev = tp_train_steps(make_dev_mesh(1, 1, device="cuda"), arch, layers,
                             reverse=True)
    except torch.cuda.OutOfMemoryError as e:
        return {"oom": str(e).splitlines()[0]}
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    return {"ref": ref, "rev": rev}


# the collectives the tp path issues, which the probe must find working
TP_NEEDS = ("all_reduce_sum", "all_reduce_max", "all_gather_into_tensor")


def tp_rank_main(rank: int, world: int, tmp: Path, job: str) -> int:
    """One rank of ``dist_tp``: gloo over a ``FileStore`` in ``tmp``, the
    card as cuda:0; runs the job ``tmp/<job>.json`` describes and writes
    ``tmp/<job>-<rank>.json`` after each leg: where it has ``serve`` legs
    (TP_SERVE_LEGS' entries), the probe (raising unless every collective
    of TP_NEEDS works) and each serve leg; then each train leg of
    ``train`` ([arch, layers] pairs), in order.  A rank whose train leg ran out of memory
    exits with code 3 after writing its result (its partner may wait in
    a collective: the parent ends it)."""
    import datetime
    import faulthandler
    import os

    import torch
    import torch.distributed as dist

    faulthandler.enable()            # a crash in native code names its line
    sys.path.insert(0, str(ROOT / "src"))
    spec = json.loads((tmp / f"{job}.json").read_text())
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / f"{job}-store"), world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TP_COLLECTIVE_TIMEOUT))
    out = tmp / f"{job}-{rank}.json"
    try:
        result: dict = {"train": {}}
        if spec["serve"]:
            result["probe"] = {"collectives": tp_probe(rank, world),
                               "device_mesh": tp_probe_mesh(world)}
            for dt, ops in result["probe"]["collectives"].items():
                for op in TP_NEEDS:
                    if ops[op] != "ok":
                        raise AssertionError(f"dist_tp probe: {op} {dt}: "
                                             f"{ops[op]}")
            result["serve"] = {}
            for arch, batch, prompt, gen, sps in spec["serve"]:
                result["serve"][arch] = tp_rank_serve(rank, tmp, arch, batch,
                                                      prompt, gen, tuple(sps))
            # kept if a train leg's out-of-memory ends the partner
            out.write_text(json.dumps(result))
        for arch, layers in spec["train"]:
            result["train"][arch] = tp_rank_train(arch, layers)
            out.write_text(json.dumps(result))
            if "oom" in result["train"][arch]:
                sys.stdout.flush()
                os._exit(3)
    finally:
        dist.destroy_process_group()
    return 0


def run_tp_ranks(tmp: Path, job: str, spec: dict) -> list:
    """The job ``spec`` (``tp_rank_main``) on TP_WORLD rank processes of
    this script -> each rank's result (what it wrote before it was ended,
    or None, for a rank ended because its partner ran out of memory);
    every rank bounded by TP_RANK_TIMEOUT, and all ended once one has
    failed."""
    (tmp / f"{job}.json").write_text(json.dumps(spec))
    procs = []
    for r in range(TP_WORLD):
        log = open(tmp / f"{job}-{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank", str(r),
             "--tp-world", str(TP_WORLD), "--tp-dir", str(tmp), "--tp-job",
             job], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT), log))
    deadline = time.monotonic() + TP_RANK_TIMEOUT
    try:
        while any(p.poll() is None for p, _ in procs) and \
                not any(p.poll() for p, _ in procs) and \
                time.monotonic() < deadline:
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            log.close()
    codes = [p.returncode for p, _ in procs]
    out = [json.loads((tmp / f"{job}-{r}.json").read_text())
           if (tmp / f"{job}-{r}.json").exists() else None
           for r in range(TP_WORLD)]
    if 3 in codes and all(c in (0, 3, -9) for c in codes) and \
            any(o and any("oom" in t for t in o["train"].values())
                for o in out):
        return out
    if any(c != 0 for c in codes):
        text = "\n".join(f"rank {r} (exit {c}):\n" +
                         (tmp / f"{job}-{r}.log").read_text()[-3000:]
                         for r, c in enumerate(codes))
        raise AssertionError(f"dist_tp {job}: ranks failed:\n{text}")
    return out


def logits_against(name: str, got: list, want: list, cfg,
                   tol: float = DIST_SERVE_TOL) -> dict:
    """Each step's logits within ``tol`` of ``want``'s (the one-process
    ``LM``'s), relative to 1 + |logit|, and their argmax ``want``'s but at
    near ties (as dist_serve's tp leg) -> the largest error and the
    flips."""
    import torch

    errs, rels, flips = [], [], []
    for s, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        if a.shape != b.shape:
            raise AssertionError(f"dist_tp {name}: step {s} logits "
                                 f"{tuple(a.shape)}, LM's {tuple(b.shape)}")
        err = (a - b).abs()
        errs.append(float(err.max()))
        rels.append(float((err / (1 + b.abs())).max()))
        if bool((err > tol * (1 + b.abs())).any()):
            raise AssertionError(f"dist_tp {name}: step {s} logits off by "
                                 f"{errs[-1]} (tolerance {tol})")
        mine, theirs = a.argmax(dim=-1), b.argmax(dim=-1)
        for r in torch.nonzero(mine != theirs).ravel().tolist():
            gap = float(b[r, theirs[r]] - b[r, mine[r]])
            if gap > 2 * tol * (1 + float(b[r].abs().max())):
                raise AssertionError(
                    f"dist_tp {name}: step {s} row {r} takes id "
                    f"{int(mine[r])}, LM's {int(theirs[r])}, {gap} apart")
            flips.append({"step": s, "row": r, "gap": gap})
    if len(got) != len(want):
        raise AssertionError(f"dist_tp {name}: {len(got)} steps of logits, "
                             f"LM's {len(want)}")
    return {"max_abs_logit_err_vs_lm": max(errs),
            "max_rel_logit_err_vs_lm": max(rels), "near_tie_id_flips": flips}


def tp_serve_report(tmp: Path, arch: str, prompt: int, gen: int,
                    legs_by_rank: list, want: list, cfg,
                    add_launches) -> dict:
    """Checks the ranks' serve legs of ``arch`` (launches, no gathered
    bytes, each rank's parameter bytes ``model_memory``'s tp count, logits
    against ``want``, ``LM``'s, within the family's TP_SERVE_TOL or
    DIST_SERVE_TOL, the same route flips on every rank of a moe config)
    and adds their prefill launches -> the serve line's legs."""
    import torch

    want_prefill = expected_launches(cfg, prompt)
    none = {k: 0 for k in want_prefill}
    out = {}
    for r, rec in enumerate(legs_by_rank):
        counted = next(iter(rec["legs"].values()))["model_memory"][
            "prefill"]["params"]
        if rec["local_param_bytes"] != counted:
            raise AssertionError(
                f"dist_tp serve {arch} rank {r}: holds "
                f"{rec['local_param_bytes']} parameter bytes, model_memory "
                f"counts {counted} for tp on (1, {TP_WORLD})")
    for name in legs_by_rank[0]["legs"]:
        legs = [rec["legs"][name] for rec in legs_by_rank]
        if any(leg.get("route_flips") != legs[0].get("route_flips")
               for leg in legs):
            raise AssertionError(f"dist_tp serve {arch} {name}: the ranks "
                                 f"took different route flips: "
                                 f"{[leg.get('route_flips') for leg in legs]}")
        if "route_flips" in legs[0]:
            share = legs[0]["route_flips"] / legs[0]["routings"]
            legs[0]["route_flip_share"] = share
            if share > ROUTE_FLIP_SHARE:
                raise AssertionError(
                    f"dist_tp serve {arch} {name}: {legs[0]['route_flips']} "
                    f"of {legs[0]['routings']} token routings taken from "
                    f"LM's ({share:.4f}), above {ROUTE_FLIP_SHARE}")
        for r, leg in enumerate(legs):
            if leg["prefill_launches"] != want_prefill or \
                    leg["decode_launches"] != none:
                raise AssertionError(
                    f"dist_tp serve {arch} {name} rank {r}: prefill "
                    f"launches {leg['prefill_launches']}, decode "
                    f"{leg['decode_launches']}; expected {want_prefill} "
                    f"and none")
            if leg["gather_stats"]["prefill"]["gathered_bytes_peak"] or \
                    leg["gather_stats"]["decode"]["gathered_bytes_peak"]:
                raise AssertionError(f"dist_tp serve {arch} {name} rank {r} "
                                     f"gathered parameters: "
                                     f"{leg['gather_stats']}")
            add_launches(leg["prefill_launches"])
        got = torch.load(tmp / f"serve-logits-{arch}-{int(name == 'sp')}.pt")
        check = logits_against(f"serve {arch} {name}", got, want, cfg,
                               TP_SERVE_TOL.get(arch, DIST_SERVE_TOL))
        pre_b, pre_s = collective_totals(legs[0]["collectives"]["prefill"])
        dec_b, dec_s = collective_totals(
            legs[0]["collectives"]["decode_all_steps"])
        out[name] = {
            **check, "ranks": legs,
            "prefill_collective_bytes": pre_b,
            "prefill_collective_share": pre_s / legs[0]["prefill_seconds"],
            "decode_collective_bytes_per_step": dec_b / gen,
            "decode_collective_share": dec_s / legs[0]["decode_seconds"]}
    return out


def norm_gaps(h: dict, w: dict) -> dict:
    """One train step's ``h`` against ``w``: the loss's gap relative to
    max(1, |loss|), the grad norm's relative gap, and the largest relative
    gap of one leaf's gradient norm, with its leaf."""
    def rel(a, b):
        return abs(a - b) / b if b else (0.0 if a == b else math.inf)
    leaves = {k: rel(math.sqrt(h["grad_sq"][k]), math.sqrt(b))
              for k, b in w["grad_sq"].items()}
    worst = max(leaves, key=leaves.get)
    return {"loss": abs(h["loss"] - w["loss"]) / max(1.0, abs(w["loss"])),
            "grad_norm": rel(h["grad_norm"], w["grad_norm"]),
            "leaf_norm": leaves[worst], "leaf": worst}


def tp_train_report(arch: str, layers: int, ranks: list, ref: dict,
                    rev: dict, add_launches) -> dict:
    """Checks the ranks' train legs of ``arch`` at ``layers`` against world
    size 1's ``ref`` (launches, no gathered bytes, loss within REMAT_TOL,
    grad norm within TP_GRAD_NORM_RTOL, each leaf's gradient norm within
    TP_LEAF_NORM_RTOL), beside world size 1's with reversed rows ``rev``,
    and adds their launches -> the depth's record."""
    cfg, shape, _, _ = tp_train_setup(arch, layers)
    want_step = train_launches(cfg, shape.seq_len)
    for r, rec in enumerate(ranks):
        if rec["gather_stats"]["gathered_bytes_peak"]:
            raise AssertionError(f"dist_tp train {arch} rank {r} gathered "
                                 f"parameters: {rec['gather_stats']}")
        for s, (h, w) in enumerate(zip(rec["steps"], ref["steps"])):
            if h["launches"] != want_step:
                raise AssertionError(f"dist_tp train {arch} rank {r} step "
                                     f"{s}: launches {h['launches']}, "
                                     f"expected {want_step}")
            add_launches(h["launches"])
            gap = norm_gaps(h, w)
            if gap["loss"] > REMAT_TOL or \
                    gap["grad_norm"] > TP_GRAD_NORM_RTOL or \
                    gap["leaf_norm"] > TP_LEAF_NORM_RTOL:
                raise AssertionError(
                    f"dist_tp train {arch} rank {r} step {s}: loss "
                    f"{h['loss']}, "
                    f"grad norm {h['grad_norm']}; world size 1: "
                    f"{w['loss']}, {w['grad_norm']}; gaps {gap}")
    steps = ranks[0]["steps"]
    return {
        "layers": layers, "fits": True,
        "losses": [h["loss"] for h in steps],
        "grad_norms": [h["grad_norm"] for h in steps],
        "world_size_1": {"losses": [h["loss"] for h in ref["steps"]],
                         "grad_norms": [h["grad_norm"] for h in ref["steps"]],
                         "seconds_per_step": [h["seconds"]
                                              for h in ref["steps"]],
                         "peak_memory_bytes": ref["peak_memory_bytes"]},
        "gaps": [norm_gaps(h, w) for h, w in zip(steps, ref["steps"])],
        "reversed_rows_gaps": [norm_gaps(h, w) for h, w in
                               zip(rev["steps"], ref["steps"])],
        "seconds_per_step": [h["seconds"] for h in steps],
        "collective_bytes_per_step": [collective_totals(h["collectives"])[0]
                                      for h in steps],
        "collective_share": [collective_totals(h["collectives"])[1]
                             / h["seconds"] for h in steps],
        "ranks": [{**r, "steps": [{k: v for k, v in h.items()
                                   if k != "grad_sq"} for h in r["steps"]]}
                  for r in ranks]}


def tp_lm_serve(tmp: Path, arch: str, batch: int, prompt: int,
                gen: int) -> dict:
    """A serve leg's one-process arm: full ``arch`` through ``LM.prefill``
    and ``gen`` greedy ``decode_step``s in this process from weights made
    from SEED -> each step's logits on the host, LM's ids, its prefill
    seconds and the arm's; the prompt and ids saved for the ranks
    (``serve-inputs-<arch>.pt``), with a moe config's routes (each moe
    layer's top-K of the greedy run, ``RecordRoutes``); the model freed.
    For a family with its own limit (TP_SERVE_TOL) also its bf16 floor:
    the same steps on the same weights widened to f32 (TF32 off), driven
    by LM's ids, and LM's largest error against them, relative to
    1 + |logit| and absolute."""
    import contextlib
    import gc

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.reducer import tree_map_with_path
    from repro_torch.data import TokenPipeline
    from repro_torch.models import LM

    t_arm = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = serve_config(arch)
    total = prompt + gen
    pshape = ShapeConfig("smoke", "prefill", prompt, batch)
    pbatch = {k: torch.from_numpy(v).cuda() for k, v in TokenPipeline(
        cfg, pshape, seed=SEED).prefill_batch(0).items()}
    tokens = pbatch.pop("tokens")
    frames = pbatch.get("encoder_frames")     # an encdec's, else None
    lm = LM(cfg, max_seq=total, device="cuda")
    lm.init(SEED, torch.bfloat16)

    def run(drive=None):
        """The prefill's logits and each decode step's (on the host) and
        the ids fed: ``drive``'s, else the greedy ones."""
        logits, cache = lm.prefill(tokens, cache_len=total,
                                   encoder_frames=frames)
        out, ids = [logits.float().cpu()], []
        for s in range(gen):
            ids.append(logits.argmax(dim=-1)[:, None] if drive is None
                       else drive[:, s:s + 1])
            logits, cache = lm.decode_step(cache, ids[-1])
            out.append(logits.float().cpu())
        return out, torch.cat(ids, dim=1)

    t0 = time.perf_counter()
    logits, cache = lm.prefill(tokens, cache_len=total, encoder_frames=frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del logits, cache
    routes: list = []
    with (RecordRoutes(routes) if cfg.family == "moe"
          else contextlib.nullcontext()):
        want, ids = run()
    out = {"want": want, "ids": ids.cpu(), "prefill_seconds": seconds}
    if arch in TP_SERVE_TOL:
        lm.params = tree_map_with_path(lambda _, t: t.float(), lm.params)
        gc.collect()
        torch.cuda.empty_cache()
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            f32, _ = run(ids)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        out["lm_vs_f32_max_rel_err"] = max(
            float(((b - a).abs() / (1 + a.abs())).max())
            for a, b in zip(f32, want))
        out["lm_vs_f32_max_abs_err"] = max(
            float((b - a).abs().max()) for a, b in zip(f32, want))
    torch.save({"tokens": tokens.cpu(), "ids": ids.cpu(),
                **({"routes": routes} if routes else {}),
                **({"encoder_frames": frames.cpu()}
                   if frames is not None else {})},
               tmp / f"serve-inputs-{arch}.pt")
    del lm, tokens, frames, pbatch
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_arm
    return out


def phase_dist_tp(tmp: Path) -> dict:
    """Tensor-parallel compute over ``model`` (``repro_torch.distributed.
    tensor_parallel``) on the card: TP_WORLD ranks as processes of this
    script on the one card, gloo over CUDA tensors (NCCL refuses two ranks
    on one device) with a ``FileStore`` rendezvous, a (1, 2) ("data",
    "model") mesh from ``make_dev_mesh(..., backend="gloo")``.
    1. probe: which gloo collectives take CUDA tensors here, bf16 and f32;
       the phase needs all_reduce (sum, max) and all_gather_into_tensor;
    2. serve (TP_SERVE_LEGS), seeded bf16 weights:
       ``LM.prefill``/``decode_step`` in this process first (its logits
       kept on the host, the model freed), then the tp steps on the ranks
       driven by ``LM``'s ids: logits within DIST_SERVE_TOL of ``LM``'s
       (a family's TP_SERVE_TOL, printed beside its bf16 floor), greedy
       ids ``LM``'s but at near ties, no decode launch; full yi-6b
       (batch 4, prompt 2048, GEN steps) with ``sp_decode`` off and on,
       flash once a layer a rank's prefill at its 16 of 32 q heads over
       2 of 4 kv heads; full mamba2-370m (batch 8, prompt 2000) and full
       recurrentgemma-9b (batch 4, prompt 2048), TP_REC_GEN steps, with
       ``sp_decode`` on, the SSD scan 48 times a rank's prefill at 16 of
       32 heads, the RG-LRU scan 26 times at 2048 of the 4096 width and
       flash 12 times at 8 of 16 q heads over the one kv head; full
       qwen2-moe-a2.7b (batch 4, prompt 2048), TP_REC_GEN steps,
       ``sp_decode`` on, EP with 30 of the 60 experts a rank under the
       global routing, flash 24 times a rank's prefill at 8 of 16 q heads
       over 8 of 16 kv heads, each moe layer taking ``LM``'s top-K only at
       a near tie in its own router logits (``FollowRoutes``, within
       ROUTE_TIE_ULPS bf16 spacings, on at most ROUTE_FLIP_SHARE of the
       routings; the flips counted by gap); full whisper-tiny (batch 4, a
       decoder prompt of 384 over 1500 encoder frames, GEN steps) with
       ``sp_decode`` off and on, flash 8 times a rank's prefill at 3 of 6
       q and kv heads (its 4 encoder layers unmasked); each
       rank's parameter bytes
       ``model_memory``'s tp count; the ranks make their weights in turn;
    3. train (TP_TRAIN_LEGS), full width, DIST_STEPS steps of the tp step
       on the ranks against ``build_train_step`` at world size 1 (NCCL,
       in this process, run first and freed, then again with each batch's
       rows reversed) on the same weights and batches, each leg at the
       first of its depths at which world size 1 and both ranks fit the
       card (each out-of-memory recorded): minicpm-2b (2 x 1024; 40, 20,
       10 layers), mamba2-370m (4 x 2048; 48, 24, 12),
       recurrentgemma-9b (2 x 1024; 6, 3) and whisper-tiny (4 x 384 over
       1500 frames; all 4 layers): loss within REMAT_TOL, grad
       norm within TP_GRAD_NORM_RTOL and each leaf's gradient norm within
       TP_LEAF_NORM_RTOL; each kernel and its backward once a layer of
       its kind a step on each rank (flash at 18 of 36 heads, 8 of 16, or
       3 of 6, whisper's encoder unmasked; SSD at 16 of 32 heads; RG-LRU
       at 2048 of 4096).
    All legs of a depth run in the same two rank processes.  Prints each
    leg's seconds, each rank's peak memory beside ``model_memory`` for tp
    on (1, 2), and the bytes the collectives moved and their share of the
    step (timed between synchronises of the card).  gloo's CUDA
    collectives go through host memory: these are not NCCL's times.
    Returns the kernels' launches of both ranks' steps."""
    t_phase = time.perf_counter()
    path_launches: dict = {}

    def add_launches(got: dict) -> None:
        for k, n in got.items():
            path_launches[k] = path_launches.get(k, 0) + n

    # the one-process arms run first, each freed before the ranks start:
    # LM serving, then build_train_step at world size 1
    lm_serve = {arch: tp_lm_serve(tmp, arch, batch, prompt, gen)
                for arch, batch, prompt, gen, _ in TP_SERVE_LEGS}
    legs = {arch: depths for arch, depths, _, _ in TP_TRAIN_LEGS}
    at = {arch: 0 for arch in legs}
    tried: dict = {arch: [] for arch in legs}
    ws1: dict = {}
    done: set = set()
    probe, job = None, 0
    while len(done) < len(legs):
        todo = []
        for arch, depths in legs.items():
            while arch not in done:
                if at[arch] == len(depths):
                    raise AssertionError(f"dist_tp train {arch}: no depth of "
                                         f"{depths} fits: {tried[arch]}")
                layers = depths[at[arch]]
                if (arch, layers) not in ws1:
                    ws1[arch, layers] = tp_world_size_1(tmp, arch, layers)
                if "oom" not in ws1[arch, layers]:
                    todo.append([arch, layers])
                    break
                tried[arch].append({"layers": layers, "fits": False,
                                    "world_size_1_out_of_memory":
                                        ws1[arch, layers]["oom"]})
                at[arch] += 1
        ranks = run_tp_ranks(tmp, f"job{job}", {
            "serve": TP_SERVE_LEGS if probe is None else [], "train": todo})
        job += 1
        if probe is None:
            if any(r is None for r in ranks):
                raise AssertionError("dist_tp: a rank was ended before its "
                                     "serve legs were written")
            probe = ranks[0]["probe"]
            for arch, batch, prompt, gen, _ in TP_SERVE_LEGS:
                cfg = serve_config(arch)
                ref = lm_serve[arch]
                serve_legs = tp_serve_report(
                    tmp, arch, prompt, gen, [r["serve"][arch] for r in ranks],
                    ref["want"], cfg, add_launches)
                emit({"phase": "dist_tp", "leg": "serve", "card": card_line(),
                      **({"probe": probe} if arch == TP_SERVE_LEGS[0][0]
                         else {}),
                      "arch": arch, "batch": batch, "prompt_len": prompt,
                      "gen": gen, "dtype": "bfloat16",
                      "mesh": {"data": 1, "model": TP_WORLD},
                      "backend": "gloo",
                      "tolerance": TP_SERVE_TOL.get(arch, DIST_SERVE_TOL),
                      **{k: ref[k] for k in ("lm_vs_f32_max_rel_err",
                                             "lm_vs_f32_max_abs_err")
                         if k in ref},
                      "lm_prefill_seconds": ref["prefill_seconds"],
                      "lm_seconds": ref["seconds"],
                      "rank_seconds": [r["serve"][arch]["seconds"]
                                       for r in ranks],
                      "weights_seconds": [r["serve"][arch][
                          "weights_seconds"] for r in ranks],
                      **({"route_tie_ulps": ROUTE_TIE_ULPS,
                          "route_flip_share_limit": ROUTE_FLIP_SHARE,
                          "route_flips": {k: v["ranks"][0]["route_flips"]
                                          for k, v in serve_legs.items()},
                          "route_flip_share": {
                              k: v["ranks"][0]["route_flip_share"]
                              for k, v in serve_legs.items()}}
                         if cfg.family == "moe" else {}),
                      "local_param_bytes": [r["serve"][arch][
                          "local_param_bytes"] for r in ranks],
                      "legs": serve_legs,
                      "ids_sample": ref["ids"][0, :8].tolist(),
                      "note": "gloo's CUDA collectives go through host "
                              "memory: not NCCL's times"})
            del lm_serve
        for arch, layers in todo:
            trains = [None if r is None else r["train"].get(arch)
                      for r in ranks]
            if any(t is not None and "oom" in t for t in trains):
                tried[arch].append({"layers": layers, "fits": False,
                                    "out_of_memory": [t and t.get("oom")
                                                      for t in trains]})
                at[arch] += 1
                break            # the later legs did not run: the next job
            tried[arch].append(tp_train_report(
                arch, layers, trains, ws1[arch, layers]["ref"],
                ws1[arch, layers]["rev"], add_launches))
            done.add(arch)
    for arch, _, batch, seq in TP_TRAIN_LEGS:
        emit({"phase": "dist_tp", "leg": "train", "card": card_line(),
              "arch": arch, "batch": batch, "seq": seq, "lr": TRAIN_LR,
              "steps": DIST_STEPS, "dtype": "bfloat16",
              "mesh": {"data": 1, "model": TP_WORLD}, "backend": "gloo",
              "layers": tried[arch][-1]["layers"],
              "tolerance": {"loss": REMAT_TOL, "grad_norm_rtol":
                            TP_GRAD_NORM_RTOL, "leaf_norm_rtol":
                            TP_LEAF_NORM_RTOL},
              "depths": tried[arch],
              "note": "gloo's CUDA collectives go through host memory: not "
                      "NCCL's times"})
    emit({"phase": "dist_tp", "rank_jobs": job,
          "seconds": time.perf_counter() - t_phase})
    return path_launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (no result line)")
    ap.add_argument("--tp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tp-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tp-dir", help=argparse.SUPPRESS)
    ap.add_argument("--tp-job", help=argparse.SUPPRESS)
    ap.add_argument("--wire-storm", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if args.tp_rank is not None:
        return tp_rank_main(args.tp_rank, args.tp_world, Path(args.tp_dir),
                            args.tp_job)
    if args.wire_storm is not None:
        return wire_storm_main(Path(args.wire_storm))
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
    rows = (phase_kernels() + phase_lm_kernels() + phase_flash_bwd()
            + phase_scan_bwd())
    if args.kernels_only:
        emit({"kernels": rows})
        return 0
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        by_path = {"session": phase_session(Path(tmp))}
        phase_agree(Path(tmp))
        wire_storm = WireStorm(Path(tmp))
        try:
            by_path["socket"] = phase_socket(Path(tmp))
            by_path["fleet"] = phase_fleet(Path(tmp))
            by_path["gateway"] = phase_gateway(wire_storm)
        finally:
            wire_storm.stop()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        by_path["checkpoint"] = phase_checkpoint(Path(tmp))
    by_path["serve"] = phase_serve()
    phase_serve_agree()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        by_path["train"] = phase_train(Path(tmp))
    phase_train_agree()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        by_path["dist_train"] = phase_dist_train(Path(tmp))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        by_path["dist_serve"] = phase_dist_serve(Path(tmp))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        by_path["dist_tp"] = phase_dist_tp(Path(tmp))
    for r in rows:
        r["launches_by_path"] = {p: n[r["name"]] for p, n in by_path.items()
                                 if r["name"] in n}
        r["launches"] = sum(r["launches_by_path"].values())
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
