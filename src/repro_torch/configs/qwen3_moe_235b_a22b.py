"""qwen3-moe-235b-a22b — 128 routed experts, top-8, q/k-norm [hf:Qwen/Qwen3 family].

94L d_model=4096 64H (GQA kv=4, head_dim=128) expert d_ff=1536, vocab=151936.
128 % 16 == 0 -> expert-parallel sharding over the model axis.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151_936,
    head_dim=128,
    rope_theta=1_000_000.0,
    qk_norm=True,
    num_experts=128,
    experts_per_tok=8,
    norm_topk_prob=True,
)

REDUCED = CONFIG.reduced(qk_norm=True)
