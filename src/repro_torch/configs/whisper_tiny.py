"""whisper-tiny — encoder-decoder with conv audio frontend (STUB) [arXiv:2212.04356].

Backbone only: 4 decoder layers + 4 encoder layers, d_model=384 6H (kv=6)
d_ff=1536 vocab=51865.  The conv frontend is a STUB: ``input_specs()``
supplies precomputed frame embeddings (batch, 1500, d_model).  Learned
absolute positions (whisper convention), no RoPE.  Decoder sequence lengths
beyond whisper's native 448 are a stress configuration mandated by the
assigned shape suites (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    pos_embed="learned",
    encoder_layers=4,
    encoder_seq=1500,
)

REDUCED = CONFIG.reduced()
