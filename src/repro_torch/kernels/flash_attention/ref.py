"""Plain PyTorch causal GQA attention: the version the CUDA flash kernel is
held against, and what a CPU tensor takes."""
from __future__ import annotations

import torch

NEG = -1e30


def attention_ref(q, k, v, *, causal: bool = True):
    """q (B,H,S,hd); k/v (B,KV,S,hd) -> (B,H,S,hd).  f32 softmax.

    As the reference's oracle: scores come out of the product in the input
    dtype and are then widened to f32, and the weights are cast back to
    v's dtype before the second product."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    qg = q.reshape(B, KV, H // KV, S, hd)
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k).float() * (hd ** -0.5)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG))
    w = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bksh->bkgqh", w, v)
    return o.reshape(B, H, S, hd)
