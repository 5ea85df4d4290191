"""CUDA flash attention, forward (``csrc/flash_attention.cu``) and backward
(``csrc/flash_attention_bwd.cu``): the wrappers that launch them.

Each checks device, dtype, shapes, head dim and contiguity and raises on
anything its kernel does not take, allocates the outputs (and the
backward's f32 scratch for rowsum(dO o O)), launches on PyTorch's current
stream and raises if the launch returned an error.  ``LAUNCHES`` counts
one per wrapper call that launched (the backward's call runs three
kernels).

The backward has two routes (``bwd_route``, mirroring the C entry
points): bf16 runs on the tensor cores (``mma.sync``, P and dS split into
bf16 hi + lo) at every head dim, f32 on the CUDA cores.  At hd 160 and 256
the bf16 route forms dV and dK in separate sweeps and splits each kv
head's query heads into ``bwd_slices`` slices, whose f32 partials go
through a workspace the wrapper allocates and a fixed-order sum.
``BWD_ROUTE_LAUNCHES`` counts the backward's calls by route, so a run can
show which kernels it went through.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
BWD_ROUTE_LAUNCHES = {"tensor_cores": 0, "cuda_cores": 0}

HEAD_DIMS = (16, 32, 64, 128, 160, 256)
# the backward's tensor-core route (bf16 only): csrc/flash_attention_bwd.cu's
# flash_attention_bwd_bf16 switch
TC_BWD_HEAD_DIMS = (16, 32, 64, 128, 160, 256)
# of those, the head dims whose dK and dV go in separate sweeps over head
# slices (launch_tc_sweep): their two f32 accumulators would not fit a
# warp's registers together
SWEEP_BWD_HEAD_DIMS = (160, 256)
BWD_KEY_TILE = 64          # keys a dK/dV block (TcCfg::BKEY)
_ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for counts in (LAUNCHES, BWD_ROUTE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The backward kernels a (dtype, head dim) runs: ``"tensor_cores"``
    or ``"cuda_cores"``."""
    if dtype == torch.bfloat16 and hd in TC_BWD_HEAD_DIMS:
        return "tensor_cores"
    return "cuda_cores"


def bwd_slices(dtype: torch.dtype, B: int, H: int, KV: int, S: int,
               hd: int, n_sm: int) -> int:
    """Head slices of the bf16 dK/dV sweeps at hd 160 and 256: the fewest
    that divide the group (H / KV) and give a sweep at least ``n_sm``
    blocks (one per (key tile, kv head, slice, batch)), else the whole
    group; 1 on every other route."""
    if dtype != torch.bfloat16 or hd not in SWEEP_BWD_HEAD_DIMS:
        return 1
    group = H // KV
    blocks = -(-S // BWD_KEY_TILE) * KV * B
    return next((n for n in range(1, group + 1)
                 if group % n == 0 and blocks * n >= n_sm), group)


def _check_qkv(q, k, v) -> tuple[int, int, int, int, int]:
    """(B, H, KV, S, hd) of a q/k/v triple the kernels take; raises on
    anything else."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k: expected 4-D, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    _build.check_tensor(q, "q", tuple(_ENTRY), (B, H, S, hd))
    for name, t in (("k", k), ("v", v)):
        _build.check_tensor(t, name, (q.dtype,), (B, KV, S, hd))
        if t.device != q.device:
            raise ValueError(f"q and {name} lie on different devices")
    return B, H, KV, S, hd


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, with_lse: bool = False):
    """q (B,H,S,hd); k/v (B,KV,S,hd), contiguous, one dtype (f32 or bf16)
    -> o (B,H,S,hd) in q's dtype.  Any S >= 1; hd in ``HEAD_DIMS``.

    With ``with_lse`` it returns (o, lse): lse (B,H,S) f32, each row's
    natural-log log-sum-exp of its scaled, masked scores (the backward's
    input); without it the kernel writes no lse."""
    B, H, KV, S, hd = _check_qkv(q, k, v)
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.numel() == 0:
        return (o, lse) if with_lse else o
    lib = _build.load("flash_attention")
    fn = getattr(lib, f"flash_attention_{_ENTRY[q.dtype]}")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr() if with_lse else None,
                 B, H, KV, S, hd, int(causal), _build.stream_handle(q.device))
    _build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (o, lse) if with_lse else o


def flash_attention_bwd_kernel(q, k, v, o, lse, do, *, causal: bool = True,
                               slices: int | None = None):
    """The gradient of :func:`flash_attention_kernel`: q, o and do
    (B,H,S,hd), k/v (B,KV,S,hd), one dtype (f32 or bf16), lse (B,H,S) f32
    from the forward, all contiguous -> (dq, dk, dv) in the input dtype.
    The route follows :func:`bwd_route`; both are deterministic (no
    atomics: two calls give the same bits).  ``slices`` overrides
    :func:`bwd_slices` (the card's SM count) on the bf16 route at hd 160
    and 256; it must divide H / KV, and is 1 on every other route."""
    B, H, KV, S, hd = _check_qkv(q, k, v)
    for name, t in (("o", o), ("do", do)):
        _build.check_tensor(t, name, (q.dtype,), (B, H, S, hd))
    _build.check_tensor(lse, "lse", (torch.float32,), (B, H, S))
    for name, t in (("o", o), ("do", do), ("lse", lse)):
        if t.device != q.device:
            raise ValueError(f"q and {name} lie on different devices")
    sweep = q.dtype == torch.bfloat16 and hd in SWEEP_BWD_HEAD_DIMS
    if slices is None:
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        slices = bwd_slices(q.dtype, B, H, KV, S, hd, n_sm)
    elif slices < 1 or (H // KV) % slices or (slices > 1 and not sweep):
        raise ValueError(f"slices {slices}: the route takes a divisor of "
                         f"{H // KV} at bf16 hd {SWEEP_BWD_HEAD_DIMS}, else 1")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    dvec = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    work = (torch.empty((slices, 2, B, KV, S, hd), dtype=torch.float32,
                        device=q.device) if slices > 1 else None)
    lib = _build.load("flash_attention_bwd")
    fn = getattr(lib, f"flash_attention_bwd_{_ENTRY[q.dtype]}")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), dvec.data_ptr(),
                 None if work is None else work.data_ptr(), B, H, KV, S, hd,
                 slices, int(causal), _build.stream_handle(q.device))
    _build.check(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    BWD_ROUTE_LAUNCHES[bwd_route(q.dtype, hd)] += 1
    return dq, dk, dv


def flash_attention_bwd_occupancy(hd: int) -> dict:
    """The bf16 backward's dK/dV and dQ launches at head dim ``hd`` on the
    current device: ``{launch: {"smem_bytes", "blocks_per_sm"}}``, the
    dynamic shared memory a block and the resident blocks an SM."""
    out = (ctypes.c_int * 4)()
    lib = _build.load("flash_attention_bwd")
    err = lib.flash_attention_bwd_bf16_occupancy(hd, ctypes.addressof(out))
    _build.check(err, f"flash_attention_bwd occupancy (hd {hd})")
    return {name: {"smem_bytes": out[2 * i], "blocks_per_sm": out[2 * i + 1]}
            for i, name in enumerate(("dkdv", "dq"))}
