"""internvl2-2b — InternViT + InternLM2 [arXiv:2404.16821].

LM backbone only (24L d_model=2048 16H GQA kv=8 d_ff=8192 vocab=92553); the
vision frontend is a STUB: ``input_specs()`` supplies precomputed patch
embeddings of shape (batch, num_patches=256, d_model) which the model splices
in front of the text-token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    head_dim=128,
    num_patches=256,
)

REDUCED = CONFIG.reduced()
