"""recurrentgemma-9b — RG-LRU + local attention, (R,R,A) pattern [arXiv:2402.19427].

38L d_model=4096; attention blocks are MQA (kv=1, 16 heads, head_dim=256) with
a 2048-token sliding window; recurrent blocks use RG-LRU with lru_width=4096.
Pattern (rec, rec, attn) repeating: 38 = 12x3 + (rec, rec).
Sub-quadratic -> the long_500k decode cell runs (O(1) LRU state + window cache).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12_288,
    vocab_size=256_000,
    head_dim=256,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    local_window=2048,
)

REDUCED = CONFIG.reduced(num_layers=3)
