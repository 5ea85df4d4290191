"""CUDA flash attention (``csrc/flash_attention.cu``): the wrapper that
launches it.

It checks device, dtype, shapes, head dim and contiguity and raises on
anything the kernel does not take, allocates the output, launches on
PyTorch's current stream and raises if the launch returned an error.
``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (16, 32, 64, 128, 160, 256)
_ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True) -> torch.Tensor:
    """q (B,H,S,hd); k/v (B,KV,S,hd), contiguous, one dtype (f32 or bf16)
    -> (B,H,S,hd) in q's dtype.  Any S >= 1; hd in ``HEAD_DIMS``."""
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
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    lib = _build.load("flash_attention")
    fn = getattr(lib, f"flash_attention_{_ENTRY[q.dtype]}")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, KV, S, hd, int(causal), _build.stream_handle(q.device))
    _build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
