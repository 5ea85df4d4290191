"""Trace-driven policy simulator (paper §III-B/C, Figs. 4-10).

The paper evaluates its four policies by replaying recorded user-interaction
traces under forced migration times and remote speedups.  This module
generates the two trace families of Fig. 4 (synthetic loops; adapted
TensorFlow guide) and replays them under {local, single-cell, block-cell,
remote} with the *real* ContextDetector running online.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.context import ContextDetector


@dataclass(frozen=True)
class Trace:
    name: str
    order: tuple[int, ...]        # executed cell order ids (Fig. 4 y-axis)
    costs: dict[int, float]       # base local seconds per cell (Fig. 7)


# ----------------------------------------------------------------------
# Fig. 4 trace generators (deterministic)
# ----------------------------------------------------------------------

def synthetic_loops_trace(seed: int = 0) -> Trace:
    """~600 interactions over 15 cells with large execution cycles
    (e.g. cells 1-7 executed repeatedly) and scattered cell times."""
    rng = np.random.default_rng(seed)
    order: list[int] = []
    order += list(range(15))                       # first full pass
    for _ in range(10):                            # big cycle over 0..7
        order += list(range(0, 8))
    order += list(range(8, 15))
    for _ in range(8):                             # cycle over 3..9
        order += list(range(3, 10))
    for _ in range(8):                             # cycle over 0..7 again
        order += list(range(0, 8))
    order += list(range(15))                       # final pass
    # scattered execution times (paper: "more scattered" than the TF guide)
    costs = {i: float(np.round(rng.lognormal(mean=0.0, sigma=1.6) * 2.0, 3))
             for i in range(15)}
    return Trace("synthetic-loops", tuple(order), costs)


def tf_guide_trace(seed: int = 1) -> Trace:
    """Adapted TensorFlow beginner's guide: 12 cells, shorter blocks, two
    clear time groups (many cheap cells + a few heavy train cells)."""
    rng = np.random.default_rng(seed)
    order: list[int] = []
    order += list(range(12))
    for _ in range(6):                             # tweak-and-retrain loops
        order += [6, 7, 8]
    for _ in range(5):
        order += [4, 5, 6, 7]
    for _ in range(6):
        order += [8, 9, 10]
    order += list(range(12))
    costs = {}
    for i in range(12):
        if i in (6, 9):                            # model.fit-style cells
            costs[i] = float(np.round(30.0 + 10.0 * rng.random(), 3))
        else:
            costs[i] = float(np.round(0.1 + 0.4 * rng.random(), 3))
    return Trace("tf-guide", tuple(order), costs)


TRACES = {"synthetic-loops": synthetic_loops_trace, "tf-guide": tf_guide_trace}


# ----------------------------------------------------------------------
# policy replay
# ----------------------------------------------------------------------

@dataclass
class SimResult:
    policy: str
    total_seconds: float
    migrations: int

    def speedup_vs(self, local_seconds: float) -> float:
        return local_seconds / self.total_seconds


def simulate(trace: Trace, policy: str, *, migration_time: float | None = None,
             remote_speedup: float | None = None, registry=None,
             state_nbytes: float = 0.0) -> SimResult:
    """Replay a trace under a policy.  Costs come either from the paper's
    forced scalars (``migration_time``/``remote_speedup``) or from an
    :class:`~repro_torch.core.fabric.EnvironmentRegistry`: the offload env is the
    fastest placement candidate and the migration time is the home<->offload
    link cost for ``state_nbytes`` of state."""
    if registry is not None:
        cand = max(registry.candidates(), key=lambda n: registry[n].speedup)
        if remote_speedup is None:
            remote_speedup = registry[cand].speedup
        if migration_time is None:
            migration_time = registry.transfer_seconds(
                registry.home, cand, state_nbytes)
    assert migration_time is not None and remote_speedup is not None, \
        "pass migration_time/remote_speedup or a registry"
    c = trace.costs
    s = remote_speedup
    m = migration_time

    if policy == "local":
        return SimResult("local", sum(c[o] for o in trace.order), 0)

    if policy == "remote":
        total = m + sum(c[o] / s for o in trace.order)  # one initial migration
        return SimResult("remote", total, 1)

    if policy == "single":
        total, migs = 0.0, 0
        for o in trace.order:
            if c[o] / s + 2 * m < c[o]:
                total += c[o] / s + 2 * m
                migs += 2                  # two data migrations per cell (§II-C)
            else:
                total += c[o]
        return SimResult("single", total, migs)

    if policy == "block":
        det = ContextDetector()
        total, migs = 0.0, 0
        remote = False
        plan: list[int] = []
        hist: list[int] = []
        for o in trace.order:
            if remote:
                if o in plan:
                    total += c[o] / s
                    plan.remove(o)
                    if not plan:           # block complete -> return (Fig. 3)
                        total += m
                        migs += 1
                        remote = False
                    hist.append(o)
                    det.record(trace.name, o)
                    continue
                # deviation -> return to local first (Fig. 3)
                total += m
                migs += 1
                remote = False
            block, score, ncand = det.predict_block_scored(trace.name, o)
            known = [b for b in block if b in c]
            loc_sum = sum(c[b] for b in known)
            rem_sum = sum(c[b] / s for b in known)
            # beyond-paper guard against deviation cost: an unproven
            # prediction (single candidate sequence) must be justified by the
            # current cell ALONE (pessimistic single-cell value); the block
            # plan is kept as upside if the prediction does hold.
            conf = 1.0 if len(known) <= 1 else min(score / 100.0 + 0.5, 1.0)
            if len(known) > 1 and ncand < 2:
                commit = c[o] / s + 2 * m < c[o]
            else:
                commit = bool(known) and rem_sum + 2 * m < conf * loc_sum
            if commit:
                total += m
                migs += 1
                remote = True
                plan = [b for b in known if b != o]
                total += c[o] / s
                if not plan:
                    total += m
                    migs += 1
                    remote = False
            else:
                total += c[o]
            hist.append(o)
            det.record(trace.name, o)
        if remote:
            total += m
            migs += 1
        return SimResult("block", total, migs)

    raise ValueError(policy)


def policy_grid(trace: Trace, migration_times, remote_speedups,
                policies=("single", "block"), use_registry: bool = False) -> dict:
    """Speedup (vs local) grids — the data behind Figs. 5/6/8/9/10.

    With ``use_registry`` each grid point is evaluated through a two-env
    :class:`~repro_torch.core.fabric.EnvironmentRegistry` (the fabric API); the
    derived scalars are identical, so decisions match the paper runs."""
    from repro_torch.core.fabric import EnvironmentRegistry
    local = simulate(trace, "local", migration_time=0, remote_speedup=1)
    out = {
        "trace": trace.name,
        "local_seconds": local.total_seconds,
        "migration_times": list(migration_times),
        "remote_speedups": list(remote_speedups),
        "speedup": {p: [] for p in policies},
        "migrations": {p: [] for p in policies},
    }
    for p in policies:
        for mt in migration_times:
            row_s, row_m = [], []
            for rs in remote_speedups:
                if use_registry:
                    reg = EnvironmentRegistry.two_env(
                        remote_speedup=rs, bandwidth=float("inf"), latency=mt)
                    r = simulate(trace, p, registry=reg)
                else:
                    r = simulate(trace, p, migration_time=mt, remote_speedup=rs)
                row_s.append(local.total_seconds / r.total_seconds)
                row_m.append(r.migrations)
            out["speedup"][p].append(row_s)
            out["migrations"][p].append(row_m)
    return out


def cell_frequency(trace: Trace) -> dict[int, dict]:
    """Fig. 7: execution count and relative frequency per cell."""
    counts: dict[int, int] = {}
    for o in trace.order:
        counts[o] = counts.get(o, 0) + 1
    n = len(trace.order)
    return {o: {"count": k, "freq": k / n, "cost": trace.costs[o]}
            for o, k in sorted(counts.items())}
