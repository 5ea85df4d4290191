"""Deterministic synthetic data pipeline (shardable, restart-reproducible).

Tokens are generated per (seed, step, shard) on the host with a Zipf-flavored
marginal so compression/entropy behave more like text than uniform noise.
The same step always yields the same batch — checkpoint/restart resumes the
stream exactly (fault-tolerance tests rely on this).
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


class TokenPipeline:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        # Zipf-ish marginal over the real vocab
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._p = p / p.sum()

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed * 1_000_003 + step) & 0xFFFFFFFF)

    # ------------------------------------------------------------------
    def train_batch(self, step: int, batch: int | None = None,
                    seq: int | None = None) -> dict:
        B = batch or self.shape.global_batch
        S = seq or self.shape.seq_len
        rng = self._rng(step)
        toks = rng.choice(self.cfg.vocab_size, size=(B, S + 1), p=self._p)
        out = {"tokens": toks.astype(np.int32)}
        self._add_frontend(out, rng, B)
        return out

    def prefill_batch(self, step: int, batch: int | None = None,
                      seq: int | None = None) -> dict:
        B = batch or self.shape.global_batch
        S = seq or self.shape.seq_len
        rng = self._rng(step)
        n_text = S - (self.cfg.num_patches if self.cfg.family == "vlm" else 0)
        toks = rng.choice(self.cfg.vocab_size, size=(B, n_text), p=self._p)
        out = {"tokens": toks.astype(np.int32)}
        self._add_frontend(out, rng, B)
        return out

    def decode_batch(self, step: int, batch: int | None = None) -> dict:
        B = batch or self.shape.global_batch
        rng = self._rng(step)
        return {"token": rng.choice(self.cfg.vocab_size, size=(B, 1),
                                    p=self._p).astype(np.int32)}

    # ------------------------------------------------------------------
    def _add_frontend(self, out: dict, rng, B: int) -> None:
        cfg = self.cfg
        if cfg.family == "vlm":
            out["vision_embeds"] = (rng.standard_normal(
                (B, cfg.num_patches, cfg.d_model)) * 0.02).astype(np.float32)
        if cfg.family == "encdec":
            out["encoder_frames"] = (rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)
