"""Plain PyTorch causal GQA attention, forward and backward: the versions
the CUDA flash kernels are held against, and what a CPU tensor takes."""
from __future__ import annotations

import torch

NEG = -1e30


def _scores(q, k, causal: bool):
    """Scaled, masked f32 scores (B,KV,G,S,S) of q (B,H,S,hd) against k
    (B,KV,S,hd): out of the product in the input dtype, then widened."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    qg = q.reshape(B, KV, H // KV, S, hd)
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k).float() * (hd ** -0.5)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG))
    return s


def attention_ref(q, k, v, *, causal: bool = True):
    """q (B,H,S,hd); k/v (B,KV,S,hd) -> (B,H,S,hd).  f32 softmax.

    As the reference's oracle: scores come out of the product in the input
    dtype and are then widened to f32, and the weights are cast back to
    v's dtype before the second product."""
    B, H, S, hd = q.shape
    w = torch.softmax(_scores(q, k, causal), dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bksh->bkgqh", w, v)
    return o.reshape(B, H, S, hd)


def attention_lse_ref(q, k, *, causal: bool = True):
    """Each row's natural-log log-sum-exp of its scaled, masked scores,
    (B,H,S) f32: what the forward kernel writes for the backward."""
    B, H, S, _ = q.shape
    return torch.logsumexp(_scores(q, k, causal), dim=-1).reshape(B, H, S)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True):
    """The backward kernel's formulas, written out in f32 on the inputs
    widened to f32: P = exp(S*scale - LSE), D = rowsum(dO o O),
    dV = P^T dO, dS = P o (dO V^T - D), dQ = dS K * scale and
    dK = dS^T Q * scale, dK and dV summed over each kv head's query group.
    q/o/do (B,H,S,hd), k/v (B,KV,S,hd), lse (B,H,S) -> (dq, dk, dv) in the
    inputs' dtype."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = hd ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    # masked scores are -1e30, so P is exactly 0 there
    p = torch.exp(_scores(qf, kf, causal)
                  - lse.float().reshape(B, KV, G, S, 1))
    dog = do.float().reshape(B, KV, G, S, hd)
    dvec = (dog * o.float().reshape(B, KV, G, S, hd)).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqh->bksh", p, dog)
    ds = p * (torch.einsum("bkgqh,bksh->bkgqs", dog, vf) - dvec)
    dq = torch.einsum("bkgqs,bksh->bkgqh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqh->bksh", ds,
                      qf.reshape(B, KV, G, S, hd)) * scale
    return (dq.reshape(B, H, S, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
