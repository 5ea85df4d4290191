"""Quantize/dequantize arbitrary-shape tensors blockwise.

A tensor on the CPU goes to the plain PyTorch version (:mod:`.ref`); a
tensor on a CUDA device goes to the CUDA kernel (:mod:`.kernel`), which
launches or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.quant_blockwise.kernel import (
    dequantize_kernel, quantize_kernel,
)
from repro_torch.kernels.quant_blockwise.ref import dequantize_ref, quantize_ref

BLOCK = 1024


def quantize(x: torch.Tensor):
    """Any-shape float tensor -> (q int8 (nb, BLOCK), scales f32 (nb,)).

    Pads the flattened tensor with zeros to a BLOCK multiple.  Floats
    other than f32 and bf16 are cast to f32 first (exact for f16)."""
    flat = x.detach().reshape(-1)
    if flat.dtype not in (torch.float32, torch.bfloat16):
        flat = flat.to(torch.float32)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    x2d = flat.reshape(-1, BLOCK)
    if x2d.device.type == "cpu":
        return quantize_ref(x2d)
    return quantize_kernel(x2d.contiguous())


def dequantize(q: torch.Tensor, scales: torch.Tensor, shape: tuple,
               dtype=torch.bfloat16) -> torch.Tensor:
    if q.device.type == "cpu":
        x2d = dequantize_ref(q, scales, dtype)
    else:
        x2d = dequantize_kernel(q, scales, dtype)
    n = math.prod(shape)
    return x2d.reshape(-1)[:n].reshape(shape)
