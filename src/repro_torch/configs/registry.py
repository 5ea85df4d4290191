"""Architecture registry: ``--arch <id>`` -> ModelConfig."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

# arch id (as assigned) -> module name
_ARCH_MODULES: dict[str, str] = {
    "mamba2-370m": "mamba2_370m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "yi-6b": "yi_6b",
    "phi3-medium-14b": "phi3_medium_14b",
    "minicpm-2b": "minicpm_2b",
    "stablelm-12b": "stablelm_12b",
    "internvl2-2b": "internvl2_2b",
    "whisper-tiny": "whisper_tiny",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "demo-100m": "demo_100m",
}

ASSIGNED_ARCHS: tuple[str, ...] = tuple(k for k in _ARCH_MODULES if k != "demo-100m")


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    mod = _module(arch)
    return mod.REDUCED if reduced else mod.CONFIG


def all_configs(reduced: bool = False) -> dict[str, ModelConfig]:
    return {a: get_config(a, reduced) for a in ASSIGNED_ARCHS}
