"""Stub modality frontends (port of ``repro/models/frontends.py``).

Per the assignment, [audio]/[vlm] architectures specify the transformer
backbone only; the modality frontend is a STUB: the data pipeline supplies
precomputed frame/patch embeddings.  These helpers draw deterministic
synthetic embeddings from a ``torch.Generator`` for smoke runs and
examples (the two packages draw different numbers from one seed).
"""
from __future__ import annotations

import torch


def _normal_embeds(gen: torch.Generator, shape, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * 0.02).to(dtype)


def synthetic_patch_embeds(gen: torch.Generator, batch: int,
                           num_patches: int, d_model: int,
                           dtype=torch.bfloat16):
    """Stand-in for an InternViT patch encoder output, on ``gen``'s device."""
    return _normal_embeds(gen, (batch, num_patches, d_model), dtype)


def synthetic_frame_embeds(gen: torch.Generator, batch: int,
                           num_frames: int, d_model: int,
                           dtype=torch.bfloat16):
    """Stand-in for whisper's conv mel-spectrogram frontend output, on
    ``gen``'s device."""
    return _normal_embeds(gen, (batch, num_frames, d_model), dtype)
