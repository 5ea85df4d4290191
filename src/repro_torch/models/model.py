"""Model facade (port of ``repro/models/model.py``): one API over every
assigned architecture family: ``dense`` (attention + SwiGLU), ``moe``
(routed experts), ``ssm`` (mamba2), ``hybrid`` (recurrentgemma: RG-LRU
and local attention), ``vlm`` (patch embeddings spliced in front of the
text) and ``encdec`` (whisper: an encoder over frame embeddings, a decoder
with cross attention).

    lm = LM(cfg, max_seq=4096, device="cuda")
    lm.init(seed)                        # or lm.load_reference(numpy tree)
    loss, metrics = lm.loss(params, {"tokens": tokens})   # (B, S+1) tokens
    loss, metrics = lm.loss(params, batch, ctx, remat="dots")  # a DP step's
    logits, cache = lm.prefill(tokens, cache_len=S + gen,
                               vision_embeds=..., encoder_frames=...)
    logits, cache = lm.decode_step(cache, token)
    logits, cache = lm.prefill(tokens, params=params, ctx=ctx)  # serve steps
    logits, cache = lm.decode_step(cache, token, params=params, ctx=ctx)

The parameters live on the LM (``lm.params``, the reference's tree of
stacked leaves).  ``loss`` and ``forward`` take an explicit parameter tree
(``lm.params`` by default), so that autograd sees the leaves an optimizer
owns (:mod:`repro_torch.launch.train`); ``prefill`` and ``decode_step``
take one too, and a ``DistContext`` (:mod:`repro_torch.distributed.steps`'
serve steps pass this rank's gathered parameters and its rows), and serve
without building an autograd graph.  Prefill attention, the forward SSD
scan and the RG-LRU scan go through the hand-written CUDA kernels on a
card, their plain versions on the CPU.  Under grad on a card, attention
and both scans run their forward kernels and their hand-written backward
kernels.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.transformer import WHOLE
from repro_torch.models.convert import params_from_reference, tensor_from_numpy
from repro_torch.models.layers import (
    P, embed_lookup, embed_spec, init_params, logits_from_embed, rms_norm,
    softmax_xent,
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

    def _hidden(self, params, tokens, cache, vision_embeds=None,
                encoder_frames=None, ctx=None, remat: str = "none",
                gather=WHOLE):
        """The final-normed hidden states (B, S_total, d) and the moe aux
        loss (an f32 zero for the other families); ``ctx``, ``remat`` and
        ``gather`` as :meth:`loss` takes them."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = gather.run(embed_lookup, params["embed"], tokens, ctx)
        if cfg.family == "encdec":
            enc = encdec.encoder_forward(
                params, self._input(encoder_frames, "encoder_frames"), cfg,
                gather, ctx)
            x = gather.run(
                lambda pos: x + pos[:x.shape[1]][None].to(x.dtype),
                params["dec_pos"])
        elif cfg.family == "vlm":
            ve = self._input(vision_embeds, "vision_embeds").to(x.dtype)
            x = torch.cat([ve, x], dim=1)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device).expand(B, S)
        if cfg.family == "encdec":
            x = encdec.decoder_forward(params, x, enc, cfg, positions, cache,
                                       gather, ctx)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            x, aux = transformer.decoder_forward(params["decoder"], x, cfg,
                                                 positions, cache, ctx=ctx,
                                                 remat=remat, gather=gather)
        if cache is not None:
            cache["pos"].fill_(S)
            cache["filled"] = S
        return self._final_norm(params, x, gather), aux

    def _final_norm(self, params, x, gather=WHOLE):
        return gather.run(lambda w: rms_norm(x, w, self.cfg.norm_eps),
                          params["ln_f"])

    def _logits(self, params, x, gather=WHOLE, ctx=None):
        """The logits of ``x``; under a tp context with a ``model`` axis
        above one rank, this rank's block of the padded vocab."""
        return gather.run(
            lambda w: logits_from_embed(x, w, ctx),
            params["embed"] if self.cfg.tie_embeddings else params["w_out"])

    def _prompt_cache(self, tokens, cache_len, vision_embeds, encoder_frames,
                      dtype, ctx=None):
        """A cache for the whole prompt, in ``dtype``: a vlm's counts its
        patches as well as its text, an encdec's cross K/V hold the frames
        given; under a tp context, :meth:`init_cache`'s blocks."""
        B, S = tokens.shape
        if self.cfg.family == "vlm" and vision_embeds is not None:
            S += vision_embeds.shape[1]
        slots = max(cache_len or S, S)
        if self.cfg.family == "encdec" and encoder_frames is not None:
            return encdec.init_cache(self.cfg, B, slots, dtype, self.device,
                                     enc_len=encoder_frames.shape[1])
        return self.init_cache(B, slots, dtype, ctx)

    def forward(self, tokens, *, params=None, want_cache: bool = False,
                cache_len: int | None = None, vision_embeds=None,
                encoder_frames=None):
        """Teacher-forced forward over (B, S) tokens (a vlm's patch
        embeddings (B, P, d) in front of them; an encdec's frames (B, Senc,
        d) through its encoder) with ``params`` (``self.params`` by
        default).  Returns (logits (B,S_total,V), cache or None)."""
        params = self.params if params is None else params
        cache = (self._prompt_cache(tokens, cache_len, vision_embeds,
                                    encoder_frames, params["embed"].dtype)
                 if want_cache else None)
        x, _ = self._hidden(params, tokens, cache, vision_embeds,
                            encoder_frames)
        return self._logits(params, x), cache

    def loss(self, params, batch: dict, ctx=None, *, remat: str = "none",
             gather=WHOLE):
        """Next-token cross entropy (+ the moe aux loss), as the
        reference's ``LM.loss``: ``batch["tokens"]`` (B, S+1) splits into
        inputs and labels; a vlm's logits past its ``num_patches`` patch
        positions are scored, an encdec's decoder runs over
        ``batch["encoder_frames"]``.  Returns (ce + aux, {"ce": ce, "aux":
        aux}), f32 0-d tensors, differentiable in ``params``.

        ``ctx``: the ``DistContext`` of a data-parallel step whose batch
        rows are split over its batch group, ``batch`` this rank's rows:
        the moe layers then route the group's tokens, as the reference's
        step does (:mod:`repro_torch.models.moe`); under tp with a
        ``model`` axis above one rank, ``params`` this rank's blocks of
        the heads, mlp, ssm heads, lru width and vocab (an encdec's
        encoder, decoder and cross attention at this rank's heads,
        ``models/encdec.py``), the embedding, the logits and the cross
        entropy vocab-split (``distributed/tensor_parallel.py``), the
        tied embedding's two gradients on its local vocab block.
        ``remat``: none, dots
        or full, the reference's activation checkpointing of each decoder
        scan body (:func:`repro_torch.models.transformer.decoder_forward`;
        the encdec family's decoder has none, as in the reference).
        ``gather``: the hook each unit and each leaf outside the stacks
        runs through (``transformer.WholeParams`` by default; a sharded
        step passes its ``distributed.fsdp.UnitGather`` and ``params`` as
        its tree of refs)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        x, aux = self._hidden(params, inp, None, batch.get("vision_embeds"),
                              batch.get("encoder_frames"), ctx, remat, gather)
        logits = self._logits(params, x, gather, ctx)
        if cfg.family == "vlm":
            logits = logits[:, cfg.num_patches:]
        ce = softmax_xent(logits, labels, cfg.vocab_size, ctx)
        return ce + aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def prefill(self, tokens, cache_len: int | None = None, *,
                vision_embeds=None, encoder_frames=None, params=None,
                ctx=None, gather=WHOLE):
        """Process a prompt; returns (last-position logits (B,V), cache).
        Only the last position goes through the logits product.  ``params``
        (``self.params`` by default) and ``ctx`` as the reference's
        ``LM.prefill(params, batch, ctx)`` takes them: with a
        ``DistContext`` whose batch group has several ranks (this rank's
        rows of a split batch), the moe layers route the group's tokens;
        under tp with a ``model`` axis above one rank every family's
        layers run at this rank's blocks (:meth:`loss`; an encdec's cache
        still holds every kv head of its self and cross K/V) and the
        logits are this rank's vocab block.  ``gather`` as :meth:`loss`."""
        params = self.params if params is None else params
        cache = self._prompt_cache(tokens, cache_len, vision_embeds,
                                   encoder_frames, params["embed"].dtype, ctx)
        x, _ = self._hidden(params, tokens, cache, vision_embeds,
                            encoder_frames, ctx, gather=gather)
        return self._logits(params, x[:, -1], gather, ctx), cache

    @torch.no_grad()
    def decode_step(self, cache, token, *, params=None, ctx=None,
                    gather=WHOLE):
        """One new token (B,1); returns (logits (B,V), cache), the cache
        updated in place.  Raises ``IndexError`` when a full kv cache has
        no slot left (the reference clamps and overwrites the last slot);
        the check reads the cache's host-side count, not the device's
        ``pos``.  A window cache (the hybrid family's) is a ring and never
        runs out.  ``params`` and ``ctx`` as :meth:`prefill`; with
        ``ctx.sp_decode`` the full attention layers run
        ``sp_decode_attention`` over the cache's slots on the ``model``
        ranks, as the reference's decode does; ``gather`` as
        :meth:`loss`."""
        params = self.params if params is None else params
        filled = cache["filled"]
        stack = cache.get("stack", {})
        kv = stack.get("k", stack.get("self_k"))
        # a cache split over its slots holds this rank's block of them
        ways = 1 if ctx is None else ctx.axes.get(ctx.rules.get("cache_seq"),
                                                  1)
        if kv is not None and filled >= kv.shape[3] * ways:
            raise IndexError(f"decode step writes slot {filled}, outside a "
                             f"cache of {kv.shape[3] * ways} slots")
        token = torch.as_tensor(token, device=self.device).long()
        pos = cache["pos"]
        x = gather.run(embed_lookup, params["embed"], token, ctx)
        if self.cfg.family == "encdec":
            at = pos.clamp(0, self.max_seq - 1).long()
            x = gather.run(lambda t: x + t[at][:, None, :].to(x.dtype),
                           params["dec_pos"])
            x = encdec.decoder_decode(params, x, self.cfg, pos, cache,
                                      ctx=ctx, gather=gather)
        else:
            x = transformer.decoder_decode(params["decoder"], x, self.cfg,
                                           pos, cache, ctx=ctx, gather=gather)
        x = self._final_norm(params, x, gather)
        cache["pos"] = pos + 1
        cache["filled"] = filled + 1
        return self._logits(params, x, gather, ctx)[:, 0], cache

    def init_cache(self, B: int, cache_len: int, dtype=None,
                   ctx=None) -> dict:
        """Zeros cache; ``dtype`` defaults to the parameters' (a prefill
        cache holds activations, which are in that dtype); under a tp
        context, this rank's block of the leaves the layers split over
        ``model`` (``transformer.init_cache``)."""
        if self.cfg.family == "encdec":
            return encdec.init_cache(self.cfg, B, cache_len,
                                     dtype or self.dtype, self.device)
        return transformer.init_cache(self.cfg, B, cache_len,
                                      dtype or self.dtype, self.device, ctx)

    def cache_axes(self, ctx=None) -> dict:
        """The logical axes of the cache's leaves (its ``filled`` count
        aside), for ``repro_torch.distributed.sharding.cache_shardings``."""
        if self.cfg.family == "encdec":
            return encdec.cache_axes(self.cfg, ctx)
        return transformer.cache_axes(self.cfg, ctx)
