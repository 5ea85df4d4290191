"""stablelm-12b — GQA with partial rotary [hf:stabilityai/stablelm-2-12b family].

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352, rotary on 25% of the
head dim (stablelm-2 convention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13_824,
    vocab_size=100_352,
    rope_pct=0.25,
)

REDUCED = CONFIG.reduced()
