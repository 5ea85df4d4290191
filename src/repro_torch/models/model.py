"""Model facade (port of ``repro/models/model.py``) for the families this
slice carries: ``dense`` (attention + SwiGLU), ``ssm`` (mamba2) and
``hybrid`` (recurrentgemma: RG-LRU and local attention).

    lm = LM(cfg, max_seq=4096, device="cuda")
    lm.init(seed)                        # or lm.load_reference(numpy tree)
    logits, cache = lm.prefill(tokens, cache_len=S + gen)
    logits, cache = lm.decode_step(cache, token)

The parameters live on the LM (``lm.params``, the reference's tree of
stacked leaves) and are inference-only: no autograd, no loss yet (LM
training is a later slice).  Prefill attention, the forward SSD scan and
the RG-LRU scan go through the hand-written CUDA kernels on a card, their
plain versions on the CPU.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_reference
from repro_torch.models.layers import (
    P, embed_lookup, embed_spec, init_params, logits_from_embed, rms_norm,
)

# families whose modules are not ported yet, and the ROADMAP item for each
NOT_PORTED = {
    "moe": "ROADMAP A9: models/moe.py",
    "encdec": "ROADMAP A9: models/encdec.py",
    "vlm": "ROADMAP A9: the vlm frontend",
}


class LM:
    def __init__(self, cfg, max_seq: int = 4096, device="cuda"):
        if cfg.family in NOT_PORTED:
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported to "
                f"repro_torch yet ({NOT_PORTED[cfg.family]})")
        self.cfg = cfg
        self.max_seq = max_seq
        self.device = resolve_device(device)
        spec: dict[str, Any] = {
            "embed": embed_spec(cfg),
            "decoder": transformer.decoder_spec(cfg),
            "ln_f": P((cfg.d_model,), ("embed",), init="zeros"),
        }
        if not cfg.tie_embeddings:
            spec["w_out"] = P((cfg.padded_vocab, cfg.d_model),
                              ("vocab", "embed"))
        self.spec = spec
        self.params: dict | None = None

    # ------------------------------------------------------------------
    def init(self, seed=0, dtype=torch.bfloat16) -> dict:
        """Random weights from a ``torch.Generator`` (or an int seed for
        one on this LM's device), by the reference's init rules."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(self.spec, gen, dtype, self.device)
        return self.params

    def load_reference(self, tree) -> dict:
        """Weights from the reference's ``LM.init`` tree, as numpy arrays."""
        self.params = params_from_reference(self.spec, tree, self.device)
        return self.params

    @property
    def dtype(self) -> torch.dtype:
        return self.params["embed"].dtype

    # ------------------------------------------------------------------
    def _hidden(self, tokens, cache):
        tokens = torch.as_tensor(tokens, device=self.device).long()
        B, S = tokens.shape
        x = embed_lookup(self.params["embed"], tokens)
        positions = torch.arange(S, device=self.device).expand(B, S)
        x = transformer.decoder_forward(self.params["decoder"], x, self.cfg,
                                        positions, cache)
        if cache is not None:
            cache["pos"].fill_(S)
            cache["filled"] = S
        return rms_norm(x, self.params["ln_f"], self.cfg.norm_eps)

    def _logits(self, x):
        p = self.params
        return logits_from_embed(
            x, p["embed"] if self.cfg.tie_embeddings else p["w_out"])

    def _prompt_cache(self, tokens, cache_len):
        B, S = tokens.shape
        return self.init_cache(B, max(cache_len or S, S))

    def forward(self, tokens, *, want_cache: bool = False,
                cache_len: int | None = None):
        """Teacher-forced forward over (B, S) tokens.  Returns (logits
        (B,S,V), cache or None)."""
        cache = self._prompt_cache(tokens, cache_len) if want_cache else None
        return self._logits(self._hidden(tokens, cache)), cache

    def prefill(self, tokens, cache_len: int | None = None):
        """Process a prompt; returns (last-position logits (B,V), cache).
        Only the last position goes through the logits product."""
        cache = self._prompt_cache(tokens, cache_len)
        x = self._hidden(tokens, cache)
        return self._logits(x[:, -1]), cache

    def decode_step(self, cache, token):
        """One new token (B,1); returns (logits (B,V), cache), the cache
        updated in place.  Raises ``IndexError`` when a full kv cache has
        no slot left (the reference clamps and overwrites the last slot);
        the check reads the cache's host-side count, not the device's
        ``pos``.  A window cache (the hybrid family's) is a ring and never
        runs out."""
        filled = cache["filled"]
        kv = cache.get("stack", {}).get("k")
        if kv is not None and filled >= kv.shape[3]:
            raise IndexError(f"decode step writes slot {filled}, outside a "
                             f"cache of {kv.shape[3]} slots")
        token = torch.as_tensor(token, device=self.device).long()
        pos = cache["pos"]
        x = embed_lookup(self.params["embed"], token)
        x = transformer.decoder_decode(self.params["decoder"], x, self.cfg,
                                       pos, cache)
        x = rms_norm(x, self.params["ln_f"], self.cfg.norm_eps)
        cache["pos"] = pos + 1
        cache["filled"] = filled + 1
        return self._logits(x)[:, 0], cache

    def init_cache(self, B: int, cache_len: int, dtype=None) -> dict:
        """Zeros cache; ``dtype`` defaults to the parameters' (a prefill
        cache holds activations, which are in that dtype)."""
        return transformer.init_cache(self.cfg, B, cache_len,
                                      dtype or self.dtype, self.device)
