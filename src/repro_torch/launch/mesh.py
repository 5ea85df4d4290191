"""Mesh builders (port of ``repro/launch/mesh.py``) on ``torch.distributed``.

Both build a ``DeviceMesh`` over the default process group, which the
caller starts (``torch.distributed.init_process_group``, with its own
address, world size and rank): NCCL for ``device="cuda"`` (the default,
which raises without a card), gloo for ``device="cpu"``, unless the
caller names the backend (``backend="gloo"`` over CUDA tensors: several
ranks on one card, which NCCL refuses).  The ranks lie on the mesh in
row-major order, rank ``i * n_model + j`` at (i, j).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _mesh(shape: tuple, names: tuple, device,
          backend: str | None = None) -> DeviceMesh:
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("start the process group first "
                           "(torch.distributed.init_process_group)")
    want = backend or BACKENDS[dev.type]
    if dist.get_backend() != want:
        raise RuntimeError(f"a {dev.type} mesh runs on {want}, but the "
                           f"process group's backend is {dist.get_backend()}")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model"): a world of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device)


def make_dev_mesh(n_data: int = 2, n_model: int = 4, device="cuda",
                  backend: str | None = None):
    """A small ("data", "model") mesh (the tests' CPU ranks, one card, or
    several ranks on one card with ``backend="gloo"``)."""
    return _mesh((n_data, n_model), ("data", "model"), device, backend)
