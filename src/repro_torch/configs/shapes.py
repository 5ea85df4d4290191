"""The four assigned input-shape suites and (arch x shape) applicability."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", kind="train", seq_len=4_096, global_batch=256),
    "prefill_32k": ShapeConfig("prefill_32k", kind="prefill", seq_len=32_768, global_batch=32),
    "decode_32k": ShapeConfig("decode_32k", kind="decode", seq_len=32_768, global_batch=128),
    "long_500k": ShapeConfig("long_500k", kind="decode", seq_len=524_288, global_batch=1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether this (arch x shape) cell runs, and if not, why (DESIGN.md rule)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention; %s is full-attention" % cfg.family
    return True, ""
