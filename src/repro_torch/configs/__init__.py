from repro_torch.configs.base import (
    ModelConfig,
    RuntimeConfig,
    ShapeConfig,
    TrainConfig,
)
from repro_torch.configs.registry import ASSIGNED_ARCHS, all_configs, get_config
from repro_torch.configs.shapes import SHAPES, shape_applicable

__all__ = [
    "ModelConfig",
    "RuntimeConfig",
    "ShapeConfig",
    "TrainConfig",
    "ASSIGNED_ARCHS",
    "all_configs",
    "get_config",
    "SHAPES",
    "shape_applicable",
]
