"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) routed-expert d_ff=1408, shared expert 5632,
vocab=151936.  60 % 16 != 0 -> expert-TP sharding mode (DESIGN.md §3).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    head_dim=128,
    rope_theta=1_000_000.0,
    num_experts=60,
    experts_per_tok=4,
    shared_expert_d_ff=5632,
    norm_topk_prob=False,
)

REDUCED = CONFIG.reduced()
