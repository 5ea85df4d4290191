"""Configuration dataclasses for models, shapes, training and runtime.

Every assigned architecture is expressed as a :class:`ModelConfig`; the four
assigned input-shape suites are :class:`ShapeConfig`.  Pure data, kept equal
to ``repro.configs`` field for field (the port never imports the reference),
so one config means the same model in both packages.  CPU tests use the
``reduced()`` variants; the full configs run on the card.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Any

VOCAB_PAD_MULTIPLE = 256  # keeps every padded vocab divisible by the model axis


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None

    # --- positional / norm ---
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0            # stablelm uses partial rotary
    pos_embed: str = "rope"          # rope | learned
    norm_eps: float = 1e-5
    qk_norm: bool = False            # qwen3 style RMSNorm on q,k heads
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    experts_per_tok: int = 0
    shared_expert_d_ff: int = 0      # qwen2-moe shared expert
    norm_topk_prob: bool = False
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001   # load-balance auxiliary loss

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # --- hybrid (recurrentgemma) ---
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    lru_width: int = 0
    local_window: int = 0                 # sliding-window size for local attn

    # --- encoder/decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0                  # stub frontend output length

    # --- vlm stub frontend ---
    num_patches: int = 0

    # --- training defaults ---
    schedule: str = "cosine"              # cosine | wsd (minicpm)

    dtype: str = "bfloat16"

    # Dry-run cost mode: unroll layer loops + un-chunk attention so XLA's
    # HloCostAnalysis (which counts while-loop bodies ONCE) reports exact
    # FLOPs/bytes/collectives.  Never used for real execution.
    exact_costs: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        v = self.vocab_size
        m = VOCAB_PAD_MULTIPLE
        return ((v + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode (500k) is supported."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.local_window > 0:
            return True
        return False

    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer block kind for the decoder stack."""
        if self.family == "ssm":
            return tuple("ssm" for _ in range(self.num_layers))
        if self.block_pattern:
            pat = self.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        return tuple("attn" for _ in range(self.num_layers))

    # ------------------------------------------------------------------
    # Analytic parameter counts (used by roofline MODEL_FLOPS).
    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        d = self.d_model
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        return q + kv + o

    def _ffn_params_dense(self, d_ff: int) -> int:
        return 3 * self.d_model * d_ff  # SwiGLU: gate, up, down

    def _layer_params(self, kind: str) -> int:
        d = self.d_model
        norms = 2 * d
        if kind == "ssm":
            din, ns = self.d_inner, self.ssm_state
            in_proj = d * (2 * din + 2 * ns + self.ssm_heads)
            conv = (din + 2 * ns) * self.conv_width
            extra = 3 * self.ssm_heads  # A_log, D, dt_bias
            out = din * d + din  # out_proj + gated norm
            return in_proj + conv + extra + out + d  # single pre-norm
        if kind == "rec":
            w = self.lru_width
            in_proj = 2 * d * w            # x and gate branches
            conv = w * self.conv_width
            lru = 3 * w                    # Lambda, input gate, rec gate (diag approx)
            lru_gates = 2 * w * (w // 8 if w >= 8 else w)  # block-diag gate proj (8 blocks)
            out = w * d
            ffn = self._ffn_params_dense(self.d_ff)
            return in_proj + conv + lru + lru_gates + out + ffn + norms
        # attention-bearing layer
        attn = self._attn_params()
        if kind == "attn" and self.family == "moe":
            ffn = self.num_experts * self._ffn_params_dense(self.d_ff)
            ffn += self.d_model * self.num_experts  # router
            if self.shared_expert_d_ff:
                ffn += self._ffn_params_dense(self.shared_expert_d_ff) + self.d_model
            return attn + ffn + norms
        return attn + self._ffn_params_dense(self.d_ff) + norms

    def _active_layer_params(self, kind: str) -> int:
        if kind == "attn" and self.family == "moe":
            attn = self._attn_params()
            ffn = self.experts_per_tok * self._ffn_params_dense(self.d_ff)
            ffn += self.d_model * self.num_experts
            if self.shared_expert_d_ff:
                ffn += self._ffn_params_dense(self.shared_expert_d_ff) + self.d_model
            return attn + ffn + 2 * self.d_model
        return self._layer_params(kind)

    def count_params(self, active_only: bool = False) -> int:
        """Analytic parameter count (embeddings use the *unpadded* vocab)."""
        emb = self.vocab_size * self.d_model
        total = emb if self.tie_embeddings else 2 * emb
        f = self._active_layer_params if active_only else self._layer_params
        for kind in self.layer_kinds():
            total += f(kind)
        for _ in range(self.encoder_layers):
            total += self._attn_params() * 2 + self._ffn_params_dense(self.d_ff) + 3 * self.d_model
        total += self.d_model  # final norm
        if self.encoder_seq:
            total += self.encoder_seq * self.d_model  # learned positions (stub frontend side)
        return total

    # ------------------------------------------------------------------
    def reduced(self, **overrides: Any) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        kw: dict[str, Any] = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 3 if not self.block_pattern else len(self.block_pattern)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads else 0,
            d_ff=96 if self.d_ff else 0,
            head_dim=16 if self.head_dim else None,
            vocab_size=503,  # deliberately odd: exercises vocab padding
        )
        if self.num_experts:
            kw.update(num_experts=8, experts_per_tok=min(self.experts_per_tok, 2))
            if self.shared_expert_d_ff:
                kw.update(shared_expert_d_ff=96)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32)
        if self.lru_width:
            kw.update(lru_width=64, local_window=32)
        if self.encoder_layers:
            kw.update(encoder_layers=2, encoder_seq=24)
        if self.num_patches:
            kw.update(num_patches=8)
        kw.update(overrides)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int       # sequence length (train/prefill) or KV-cache length (decode)
    global_batch: int

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.global_batch * self.seq_len


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"         # cosine | wsd
    wsd_decay_frac: float = 0.1
    grad_clip: float = 1.0
    zero1: bool = True               # shard optimizer state over data axis
    remat: str = "dots"              # none | dots | full
    microbatches: int = 1            # gradient accumulation
    vocab_parallel: bool = False     # Megatron-style shard_map embed/loss
    seed: int = 0


@dataclass(frozen=True)
class RuntimeConfig:
    """Migration-runtime knobs (the paper's tool)."""
    compression: str = "zlib"        # none | zlib | zstd | quant8+zstd
    delta_migration: bool = True
    reduce_state: bool = True
    block_policy: bool = True        # block-cell (vs single-cell) migration
    knowledge_policy: bool = True
    migration_bandwidth: float = 1e9   # bytes/s (local<->remote link)
    migration_latency: float = 0.5     # seconds fixed per migration


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)
