"""AdamW with cosine / WSD schedules, f32 master weights and a global-norm
clip (port of the reference's ``repro.optim.optimizer``).

Trees are nested dicts of tensors, walked in jax's flatten order with the
port's own tree helpers (:mod:`repro_torch.core.reducer`).  Everything is
computed in f32 as the reference computes it: the learning rate,
``b1 ** step``, the clip factor, and the master weights and moments.  The
update is written out, as the reference's is (no ``torch.optim``).

One difference from the reference, for memory: ``adamw_update`` updates
the state's m, v and master tensors in place and returns them in the new
state (the reference returns new arrays).  At minicpm-2b's size a second
copy of the f32 state would be another 32.7 GB on an 80 GB card.  The new
parameters are new tensors, the masters cast to the parameters' dtype
(round to nearest even for bf16, as XLA casts).

The trees may be one rank's shards: :mod:`repro_torch.distributed.steps`
runs ``adamw_update`` on the local shards of ZeRO-1 or FSDP state, with a
``norm_reduce`` that sums each leaf's squares over the ranks so that the
clip sees the global norm.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.reducer import tree_flatten_with_path, tree_map_with_path


class OptState(NamedTuple):
    step: torch.Tensor       # 0-d int32
    m: dict
    v: dict
    master: dict


def make_schedule(tc: TrainConfig):
    """cosine: warmup -> cosine to 10%.  wsd (minicpm): warmup -> stable ->
    linear decay over the last ``wsd_decay_frac`` of training.  The
    schedule maps a step (an int or an integer tensor) to an f32 tensor."""
    base = tc.learning_rate

    def sched(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(s / max(tc.warmup_steps, 1), max=1.0)
        if tc.schedule == "wsd":
            decay_steps = max(int(tc.total_steps * tc.wsd_decay_frac), 1)
            start = tc.total_steps - decay_steps
            frac = torch.clamp((s - start) / decay_steps, 0.0, 1.0)
            return base * warm * (1.0 - 0.9 * frac)
        prog = torch.clamp(s / max(tc.total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return base * warm * (0.1 + 0.9 * cos)

    return sched


def _leaves(tree) -> list:
    return [x for _, x in tree_flatten_with_path(tree)]


def init_opt_state(params) -> OptState:
    """Zero f32 moments and f32 master copies of ``params``; step 0 on the
    parameters' device."""
    zeros = tree_map_with_path(
        lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device), params)
    master = tree_map_with_path(
        lambda _, p: p.detach().to(torch.float32, copy=True), params)
    device = _leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=device), zeros,
                    tree_map_with_path(lambda _, z: z.clone(), zeros), master)


def global_norm(tree, reduce=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of each leaf's sum of
    squares, in f32.  ``reduce`` maps the vector of the leaves' sums to the
    sums to add (a sharded tree's: each summed over the ranks)."""
    sq = [torch.sum(torch.square(x.float())) for x in _leaves(tree)]
    if reduce is not None:
        sq = list(reduce(torch.stack(sq)))
    return torch.sqrt(sum(sq))


@torch.no_grad()
def adamw_update(tc: TrainConfig, state: OptState, grads, params, *,
                 norm_reduce=None):
    """Returns (new_state, new_params (cast to the parameters' dtype),
    metrics).  m, v and master are updated in place (see the module
    docstring); ``norm_reduce`` goes to :func:`global_norm`."""
    sched = make_schedule(tc)
    step = state.step + 1
    lr = sched(step)

    gnorm = global_norm(grads, norm_reduce)
    clip = torch.clamp(torch.full_like(gnorm, tc.grad_clip)
                       / torch.clamp(gnorm, min=1e-12), max=1.0)

    b1, b2, eps, wd = tc.beta1, tc.beta2, tc.eps, tc.weight_decay
    c1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    c2 = 1.0 - torch.pow(b2, step.to(torch.float32))

    m_of = dict(tree_flatten_with_path(state.m))
    v_of = dict(tree_flatten_with_path(state.v))
    w_of = dict(tree_flatten_with_path(state.master))
    for path, g in tree_flatten_with_path(grads):
        m, v, w = m_of[path], v_of[path], w_of[path]
        # the reference's arithmetic, op for op, with at most three f32
        # temporaries of the leaf alive at once
        g32 = g.to(torch.float32, copy=True).mul_(clip)
        m.mul_(b1).add_(g32 * (1 - b1))                 # b1 m + (1-b1) g
        v.mul_(b2).add_(g32.square_().mul_(1 - b2))     # b2 v + (1-b2) g^2
        denom = torch.div(v, c2, out=g32).sqrt_().add_(eps)
        update = torch.div(m, c1).div_(denom)
        del g32, denom
        update.add_(w * wd)
        w.sub_(update.mul_(lr))                          # w - lr * update

    pdtype = _leaves(params)[0].dtype
    new_params = tree_map_with_path(
        lambda _, w: w.to(pdtype, copy=True), state.master)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return (OptState(step, state.m, state.v, state.master), new_params,
            metrics)
