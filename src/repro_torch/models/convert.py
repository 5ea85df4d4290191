"""Carry the reference's weights across.

``LM.init`` in the JAX package returns a nested dict of arrays; handed over
as numpy arrays (``np.asarray`` of each leaf), the tree fills the port's
parameters leaf for leaf, because the port keeps the reference's layouts,
its stacked ``layers`` axis and the hybrid family's ``groups`` (stacked)
and ``tail`` (unstacked) subtrees: nothing is transposed or unstacked,
only dtypes are mapped.  A jax bf16 leaf arrives as an ``ml_dtypes.bfloat16``
numpy array; its bits are taken through a 16-bit integer view, so this
module needs no ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import P


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy array (bf16 from ml_dtypes included) as a tensor on
    ``device``, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_reference(spec, tree, device, path: str = ""):
    """The port's parameter tree for ``spec`` from the reference's tree of
    numpy arrays; raises on a missing or extra key or a shape mismatch."""
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path or 'params'}: expected keys "
                             f"{sorted(spec)}, got {got}")
        return {k: params_from_reference(spec[k], tree[k], device,
                                         f"{path}[{k!r}]")
                for k in sorted(spec)}
    assert isinstance(spec, P)
    t = tensor_from_numpy(tree, device)
    if tuple(t.shape) != tuple(spec.shape):
        raise ValueError(f"{path}: shape {tuple(t.shape)}, expected "
                         f"{spec.shape}")
    return t
