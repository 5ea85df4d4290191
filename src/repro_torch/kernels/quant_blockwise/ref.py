"""Plain PyTorch block-wise int8 quantization: the version each CUDA quant
kernel is held against."""
from __future__ import annotations

import numpy as np
import torch

# The reference's scale is amax * f32(1/127), not amax / 127: XLA rewrites
# a division by a constant into a multiplication by its reciprocal, which
# differs from IEEE division in the last bit for some amax.
INV127 = float(np.float32(1 / 127))


def quantize_ref(x2d: torch.Tensor):
    """x2d (nb, block) float -> (q int8 (nb, block), scales f32 (nb,)).

    The quotient ``x / scale`` is an IEEE division, as in the reference.
    amax propagates NaN (as jnp.max does), so a block holding NaN gets
    scale 1.0; a NaN quotient becomes 0, as XLA's float->int8 conversion
    gives."""
    xf = x2d.to(torch.float32)
    amax = xf.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax * INV127, torch.ones_like(amax))
    r = torch.round(xf / scale[:, None]).clamp(-127, 127)
    q = torch.where(torch.isnan(r), torch.zeros_like(r), r).to(torch.int8)
    return q, scale


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale[:, None]).to(dtype)
