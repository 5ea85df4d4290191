"""CUDA flash attention, forward (``csrc/flash_attention.cu``) and backward
(``csrc/flash_attention_bwd.cu``): the wrappers that launch them.

Each checks device, dtype, shapes, head dim and contiguity and raises on
anything its kernel does not take, allocates the outputs (and the
backward's f32 scratch for rowsum(dO o O)), launches on PyTorch's current
stream and raises if the launch returned an error.  ``LAUNCHES`` counts
one per wrapper call that launched (the backward's call runs three
kernels).

The backward has two routes (``bwd_route``, mirroring the C entry
points): bf16 at a head dim in ``TC_BWD_HEAD_DIMS`` runs on the tensor
cores (``mma.sync``, P and dS split into bf16 hi + lo), everything else
(f32, and bf16 at hd 160 and 256) on the CUDA cores in f32.
``BWD_ROUTE_LAUNCHES`` counts the backward's calls by route, so a run can
show which kernels it went through.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
BWD_ROUTE_LAUNCHES = {"tensor_cores": 0, "cuda_cores": 0}

HEAD_DIMS = (16, 32, 64, 128, 160, 256)
# the backward's tensor-core route (bf16 only): csrc/flash_attention_bwd.cu's
# flash_attention_bwd_bf16 switch; at hd 160 and 256 its f32 dK/dV
# accumulators would not fit a warp's registers
TC_BWD_HEAD_DIMS = (16, 32, 64, 128)
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


def flash_attention_bwd_kernel(q, k, v, o, lse, do, *, causal: bool = True):
    """The gradient of :func:`flash_attention_kernel`: q, o and do
    (B,H,S,hd), k/v (B,KV,S,hd), one dtype (f32 or bf16), lse (B,H,S) f32
    from the forward, all contiguous -> (dq, dk, dv) in the input dtype.
    The route follows :func:`bwd_route`; both are deterministic (no
    atomics: two calls give the same bits)."""
    B, H, KV, S, hd = _check_qkv(q, k, v)
    for name, t in (("o", o), ("do", do)):
        _build.check_tensor(t, name, (q.dtype,), (B, H, S, hd))
    _build.check_tensor(lse, "lse", (torch.float32,), (B, H, S))
    for name, t in (("o", o), ("do", do), ("lse", lse)):
        if t.device != q.device:
            raise ValueError(f"q and {name} lie on different devices")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    dvec = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_bwd")
    fn = getattr(lib, f"flash_attention_bwd_{_ENTRY[q.dtype]}")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), dvec.data_ptr(), B, H, KV, S, hd, int(causal),
                 _build.stream_handle(q.device))
    _build.check(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    BWD_ROUTE_LAUNCHES[bwd_route(q.dtype, hd)] += 1
    return dq, dk, dv
