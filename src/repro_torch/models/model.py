"""Model facade (port of ``repro/models/model.py``): one API over every
assigned architecture family: ``dense`` (attention + SwiGLU), ``moe``
(routed experts), ``ssm`` (mamba2), ``hybrid`` (recurrentgemma: RG-LRU
and local attention), ``vlm`` (patch embeddings spliced in front of the
text) and ``encdec`` (whisper: an encoder over frame embeddings, a decoder
with cross attention).

    lm = LM(cfg, max_seq=4096, device="cuda")
    lm.init(seed)                        # or lm.load_reference(numpy tree)
    logits, cache = lm.prefill(tokens, cache_len=S + gen,
                               vision_embeds=..., encoder_frames=...)
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
from repro_torch.models import encdec, transformer
from repro_torch.models.convert import params_from_reference, tensor_from_numpy
from repro_torch.models.layers import (
    P, embed_lookup, embed_spec, init_params, logits_from_embed, rms_norm,
)


class LM:
    def __init__(self, cfg, max_seq: int = 4096, device="cuda"):
        self.cfg = cfg
        self.max_seq = max_seq
        self.device = resolve_device(device)
        if cfg.family == "encdec":
            self.spec = encdec.encdec_spec(cfg, max_seq)
        else:
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
    def _input(self, a, name: str) -> torch.Tensor:
        """A modality input (numpy or a tensor) on this LM's device."""
        if a is None:
            raise ValueError(f"the {self.cfg.family} family "
                             f"({self.cfg.name}) needs {name}=")
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return tensor_from_numpy(a, self.device)

    def _hidden(self, tokens, cache, vision_embeds=None, encoder_frames=None):
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = embed_lookup(self.params["embed"], tokens)
        if cfg.family == "encdec":
            enc = encdec.encoder_forward(
                self.params, self._input(encoder_frames, "encoder_frames"),
                cfg)
            x = x + self.params["dec_pos"][:x.shape[1]][None].to(x.dtype)
        elif cfg.family == "vlm":
            ve = self._input(vision_embeds, "vision_embeds").to(x.dtype)
            x = torch.cat([ve, x], dim=1)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device).expand(B, S)
        if cfg.family == "encdec":
            x = encdec.decoder_forward(self.params, x, enc, cfg, positions,
                                       cache)
        else:
            x = transformer.decoder_forward(self.params["decoder"], x, cfg,
                                            positions, cache)
        if cache is not None:
            cache["pos"].fill_(S)
            cache["filled"] = S
        return rms_norm(x, self.params["ln_f"], cfg.norm_eps)

    def _logits(self, x):
        p = self.params
        return logits_from_embed(
            x, p["embed"] if self.cfg.tie_embeddings else p["w_out"])

    def _prompt_cache(self, tokens, cache_len, vision_embeds, encoder_frames):
        """A cache for the whole prompt: a vlm's counts its patches as well
        as its text, an encdec's cross K/V hold the frames given."""
        B, S = tokens.shape
        if self.cfg.family == "vlm" and vision_embeds is not None:
            S += vision_embeds.shape[1]
        slots = max(cache_len or S, S)
        if self.cfg.family == "encdec" and encoder_frames is not None:
            return encdec.init_cache(self.cfg, B, slots, self.dtype,
                                     self.device,
                                     enc_len=encoder_frames.shape[1])
        return self.init_cache(B, slots)

    def forward(self, tokens, *, want_cache: bool = False,
                cache_len: int | None = None, vision_embeds=None,
                encoder_frames=None):
        """Teacher-forced forward over (B, S) tokens (a vlm's patch
        embeddings (B, P, d) in front of them; an encdec's frames (B, Senc,
        d) through its encoder).  Returns (logits (B,S_total,V), cache or
        None)."""
        cache = (self._prompt_cache(tokens, cache_len, vision_embeds,
                                    encoder_frames) if want_cache else None)
        x = self._hidden(tokens, cache, vision_embeds, encoder_frames)
        return self._logits(x), cache

    def prefill(self, tokens, cache_len: int | None = None, *,
                vision_embeds=None, encoder_frames=None):
        """Process a prompt; returns (last-position logits (B,V), cache).
        Only the last position goes through the logits product."""
        cache = self._prompt_cache(tokens, cache_len, vision_embeds,
                                   encoder_frames)
        x = self._hidden(tokens, cache, vision_embeds, encoder_frames)
        return self._logits(x[:, -1]), cache

    def decode_step(self, cache, token):
        """One new token (B,1); returns (logits (B,V), cache), the cache
        updated in place.  Raises ``IndexError`` when a full kv cache has
        no slot left (the reference clamps and overwrites the last slot);
        the check reads the cache's host-side count, not the device's
        ``pos``.  A window cache (the hybrid family's) is a ring and never
        runs out."""
        filled = cache["filled"]
        stack = cache.get("stack", {})
        kv = stack.get("k", stack.get("self_k"))
        if kv is not None and filled >= kv.shape[3]:
            raise IndexError(f"decode step writes slot {filled}, outside a "
                             f"cache of {kv.shape[3]} slots")
        token = torch.as_tensor(token, device=self.device).long()
        pos = cache["pos"]
        x = embed_lookup(self.params["embed"], token)
        if self.cfg.family == "encdec":
            at = pos.clamp(0, self.max_seq - 1).long()
            x = x + self.params["dec_pos"][at][:, None, :].to(x.dtype)
            x = encdec.decoder_decode(self.params, x, self.cfg, pos, cache)
        else:
            x = transformer.decoder_decode(self.params["decoder"], x,
                                           self.cfg, pos, cache)
        x = rms_norm(x, self.params["ln_f"], self.cfg.norm_eps)
        cache["pos"] = pos + 1
        cache["filled"] = filled + 1
        return self._logits(x)[:, 0], cache

    def init_cache(self, B: int, cache_len: int, dtype=None) -> dict:
        """Zeros cache; ``dtype`` defaults to the parameters' (a prefill
        cache holds activations, which are in that dtype)."""
        if self.cfg.family == "encdec":
            return encdec.init_cache(self.cfg, B, cache_len,
                                     dtype or self.dtype, self.device)
        return transformer.init_cache(self.cfg, B, cache_len,
                                      dtype or self.dtype, self.device)
