"""mamba2-370m — SSD (state-space duality), attention-free [arXiv:2405.21060].

48L d_model=1024, d_ff=0 (no MLP: Mamba-2 blocks only), vocab=50280,
ssm_state=128, expand=2 -> d_inner=2048, headdim=64 -> 32 SSD heads.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=32,          # SSD heads (= d_inner / ssm_headdim)
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
)

REDUCED = CONFIG.reduced(num_layers=2)
