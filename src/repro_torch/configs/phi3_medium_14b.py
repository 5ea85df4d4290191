"""phi3-medium-14b — RoPE SwiGLU GQA [arXiv:2404.14219].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
kv=10 is not divisible by the 16-way model axis -> KV replicated under TP
(DESIGN.md §3), decode cache sequence-sharded instead.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17_920,
    vocab_size=100_352,
    head_dim=128,
)

REDUCED = CONFIG.reduced(num_kv_heads=2)
