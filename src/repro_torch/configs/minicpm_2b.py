"""minicpm-2b — llama-like, trained with the WSD schedule [arXiv:2404.06395].

40L d_model=2304 36H (kv=36: MHA) d_ff=5760 vocab=122753 (odd -> exercises
vocab padding).  The WSD (warmup-stable-decay) schedule is wired into
repro.optim and selected by ``schedule="wsd"``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    head_dim=64,
    tie_embeddings=True,
    schedule="wsd",
)

REDUCED = CONFIG.reduced(schedule="wsd")
