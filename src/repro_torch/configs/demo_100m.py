"""demo-100m — ~100M-parameter llama-like LM for the end-to-end examples.

Not an assigned architecture; used by examples/train_e2e.py and the hybrid
migration examples (the paper's own workloads are notebook pipelines, so this
plays the role of its "model fitting" cell at a size that trains on CPU).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="demo-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=2048,
    vocab_size=32_768,
    tie_embeddings=True,
)

REDUCED = CONFIG.reduced()
