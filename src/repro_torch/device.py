"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default.  Asking for CUDA on a
machine without a card raises: the port never carries on quietly on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} "
                         f"(expected 'cuda' or 'cpu')")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch.cuda.is_available() "
            f"is false; pass device='cpu' to run the plain PyTorch versions")
    return dev


def h2d(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device``.  A CUDA copy goes through
    pinned memory with ``non_blocking``, so it never waits on the stream."""
    t = torch.from_numpy(np.require(a, requirements=["C", "W"]))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)
