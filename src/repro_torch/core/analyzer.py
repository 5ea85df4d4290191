"""Context-aware migration analyzer (paper §II-C) over the environment fabric.

Placement is a pluggable :class:`PlacementPolicy`:

* **Performance-aware** — :class:`SingleCellPolicy` (migrate iff the best
  candidate env's time + round-trip migration beats home) and
  :class:`BlockPolicy` (use the context detector's predicted block; migrate
  once per block, return on completion or deviation — Fig. 3).
* **Knowledge-aware** — :class:`KnowledgePolicy`: a KB of cell parameters
  (epochs, num_steps, ...) with thresholds; Algorithm 2 probes small
  parameter values in both environments in the background, fits two linear
  regressors, and updates the threshold to their intersection (Fig. 11).
* **Cost-matrix** — :class:`CostMatrixPolicy` (beyond the paper): scores
  *every* environment in the registry per cell/block using the per-pair
  link costs — inbound state transfer + modeled execution + return-home —
  and places the cell on the argmin.  This is what lets a third env (e.g. a
  TPU mesh) win the heavy cells while a GPU node keeps the medium ones.

With no registry attached the analyzer degrades to the paper's local/remote
dyad and reproduces its decisions exactly.  Every decision carries a
human-readable reason that is attached to the cell as an annotation
(explainability, Fig. 1).
"""
from __future__ import annotations

import ast
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from repro_torch.core.astdeps import analyze_cell
from repro_torch.core.context import ContextDetector
from repro_torch.core.kb import KnowledgeBase, ProvRecord
from repro_torch.core.notebook import Cell, Notebook


@dataclass
class Decision:
    env: str
    migrate: bool
    reason: str
    block: tuple[int, ...] = ()
    policy: str = "performance"


class PerfModel:
    """Observed cell durations per (cell, env) — the 'performance logs of
    previous executions in multiple computing environments' (Fig. 1)."""

    def __init__(self):
        self._obs: dict[tuple[str, str], list[float]] = defaultdict(list)

    def observe(self, cell_id: str, env: str, seconds: float) -> None:
        self._obs[(cell_id, env)].append(float(seconds))

    def estimate(self, cell_id: str, env: str) -> float | None:
        xs = self._obs.get((cell_id, env))
        return float(np.median(xs)) if xs else None


# ----------------------------------------------------------------------
# Algorithm 2 helpers
# ----------------------------------------------------------------------

class _KwargSub(ast.NodeTransformer):
    def __init__(self, param: str, value):
        self.param, self.value = param, value

    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        for kw in node.keywords:
            if kw.arg == self.param and isinstance(kw.value, ast.Constant):
                kw.value = ast.Constant(self.value)
        return node


def substitute_kwarg(source: str, param: str, value) -> str:
    tree = _KwargSub(param, value).visit(ast.parse(source))
    ast.fix_missing_locations(tree)
    return ast.unparse(tree)


def fit_linear(xs, ys) -> tuple[float, float]:
    """least-squares slope/intercept (the paper's 'simple and unexpensive'
    linear regressors)."""
    a, b = np.polyfit(np.asarray(xs, float), np.asarray(ys, float), 1)
    return float(a), float(b)


def intersection(m_local: tuple[float, float], m_remote: tuple[float, float],
                 migration_time: float = 0.0) -> float:
    """Parameter value where remote (incl. migration offset) beats local."""
    a_l, b_l = m_local
    a_r, b_r = m_remote
    if a_l <= a_r:
        return float("inf")  # remote never catches up
    return (b_r + migration_time - b_l) / (a_l - a_r)


# ----------------------------------------------------------------------
# placement policies
# ----------------------------------------------------------------------

class PlacementPolicy:
    """One placement strategy.  ``decide`` returns a Decision, or None to
    pass the cell on to the next policy in the analyzer's chain."""

    name = "policy"

    def decide(self, an: "MigrationAnalyzer", nb: Notebook, cell: Cell,
               current_env: str) -> Decision | None:
        raise NotImplementedError


class KnowledgePolicy(PlacementPolicy):
    """KB parameter thresholds (the paper's knowledge-aware policy)."""

    name = "knowledge"

    def decide(self, an, nb, cell, current_env):
        info = analyze_cell(cell.source)
        target = an.offload_target()
        for fn, kwargs in info.call_kwargs.items():
            for p, v in kwargs.items():
                est = an.kb.get(p)
                if est is None or not isinstance(v, (int, float)):
                    continue
                if v > est.threshold:
                    return Decision(
                        target, True,
                        f"knowledge: {fn}({p}={v}) > threshold {est.threshold:.2f} "
                        f"({est.source})", policy="knowledge")
                return Decision(
                    an.home, False,
                    f"knowledge: {fn}({p}={v}) <= threshold {est.threshold:.2f} "
                    f"({est.source})", policy="knowledge")
        return None


class SingleCellPolicy(PlacementPolicy):
    """Migrate iff the best candidate env's time + 2 migrations beats home."""

    name = "single"

    def decide(self, an, nb, cell, current_env):
        state = an.state_size_estimate[nb.name]
        t_loc = an.perf.estimate(cell.cell_id, an.home)
        best = None
        for cand in an.candidates():
            t_env = an.perf.estimate(cell.cell_id, cand)
            if t_env is None:
                continue
            t_mig = (an.pair_migration_time(state, an.home, cand)
                     + an.pair_migration_time(state, cand, an.home)) / 2.0
            if best is None or t_env + 2 * t_mig < best[1] + 2 * best[2]:
                best = (cand, t_env, t_mig)
        if t_loc is None or best is None:
            return Decision(an.home, False,
                            "performance: no history for this cell yet")
        cand, t_rem, t_mig = best
        if t_rem + 2 * t_mig < t_loc:
            return Decision(cand, True,
                            f"performance/single: {cand} {t_rem:.2f}s + "
                            f"2x{t_mig:.2f}s migration < local {t_loc:.2f}s")
        return Decision(an.home, False,
                        f"performance/single: local {t_loc:.2f}s <= {cand} "
                        f"{t_rem:.2f}s + 2x{t_mig:.2f}s migration")


class BlockPolicy(PlacementPolicy):
    """Sum predicted block costs; migrate once per block (Fig. 3)."""

    name = "block"

    def decide(self, an, nb, cell, current_env):
        order = nb.order(cell.cell_id)
        state = an.state_size_estimate[nb.name]
        t_loc = an.perf.estimate(cell.cell_id, an.home)
        block, score, ncand = an.context.predict_block_scored(nb.name, order)

        block_cells = [nb.cells[o] for o in block if o < len(nb.cells)]
        home_est = {c.cell_id: an.perf.estimate(c.cell_id, an.home)
                    for c in block_cells}
        best = None
        for cand in an.candidates():
            t_rem = an.perf.estimate(cell.cell_id, cand)
            if t_rem is None:
                continue
            loc_sum = rem_sum = 0.0
            for c in block_cells:
                tl = home_est[c.cell_id]
                tr = an.perf.estimate(c.cell_id, cand)
                if tl is None or tr is None:
                    # a cell unmeasured on either side contributes to neither
                    # sum, keeping the home/candidate comparison paired
                    tl = tr = 0.0
                loc_sum += tl
                rem_sum += tr
            t_mig = (an.pair_migration_time(state, an.home, cand)
                     + an.pair_migration_time(state, cand, an.home)) / 2.0
            if best is None or rem_sum + 2 * t_mig < best[3] + 2 * best[4]:
                best = (cand, t_rem, loc_sum, rem_sum, t_mig)
        if t_loc is None or best is None:
            return Decision(an.home, False,
                            "performance: no history for this cell yet")
        cand, t_rem, loc_sum, rem_sum, t_mig = best

        conf = 1.0 if len(block) <= 1 else min(score / 100.0 + 0.5, 1.0)
        if len(block) > 1 and ncand < 2:
            # unproven prediction: commit only on the current cell's own value
            if t_rem + 2 * t_mig < t_loc:
                return Decision(cand, True,
                                f"performance/block: unproven block {block}; "
                                f"cell alone justifies migration "
                                f"({t_rem:.2f}s + 2x{t_mig:.2f}s < {t_loc:.2f}s)",
                                block=block)
            return Decision(an.home, False,
                            f"performance/block: insufficient context evidence "
                            f"for block {block} ({ncand} candidate sequences)",
                            block=block)
        if rem_sum + 2 * t_mig < conf * loc_sum:
            return Decision(cand, True,
                            f"performance/block: block {block} {cand} "
                            f"{rem_sum:.2f}s + 2x{t_mig:.2f}s < local {loc_sum:.2f}s",
                            block=block)
        return Decision(an.home, False,
                        f"performance/block: block {block} local {loc_sum:.2f}s "
                        f"<= {cand} {rem_sum:.2f}s + 2x{t_mig:.2f}s", block=block)


def _modeled_exec_seconds(an, c: Cell, env_name: str) -> float | None:
    """Estimated execution time of a cell on an env: measured history first,
    else home history (or the declared cost) divided by the env speedup."""
    t = an.perf.estimate(c.cell_id, env_name)
    if t is not None:
        return t
    base = an.perf.estimate(c.cell_id, an.home)
    if base is None:
        base = c.cost
    if base is None:
        return None
    return base / an.registry[env_name].speedup


class CostMatrixPolicy(PlacementPolicy):
    """Score all N environments per cell/block with per-pair link costs.

    cost(e) = transfer(current -> e, state) + exec(block | e)
              + transfer(e -> home, state)      [amortized return]

    Requires a registry (per-pair links + env speedups)."""

    name = "cost"

    def decide(self, an, nb, cell, current_env):
        assert an.registry is not None, "cost-matrix policy needs a registry"
        order = nb.order(cell.cell_id)
        state = an.state_size_estimate[nb.name]
        block, score, ncand = an.context.predict_block_scored(nb.name, order)
        if len(block) > 1 and ncand < 2:
            block = (order,)         # unproven prediction: score the cell alone

        def exec_time(c: Cell, env_name: str) -> float | None:
            return _modeled_exec_seconds(an, c, env_name)

        costs: dict[str, float] = {}
        known_any = False
        for env_name in [an.home] + an.candidates():
            total = an.pair_migration_time(state, current_env, env_name)
            # fleet overhead: a still-provisioning env pays its remaining
            # cold start, a saturated one its expected queue wait — so a
            # cold env is not chosen for a short cell (0 without a fleet)
            total += an.env_overhead(env_name)
            if env_name != an.home:
                total += an.pair_migration_time(state, env_name, an.home)
            for o in block:
                if o >= len(nb.cells):
                    continue
                t = exec_time(nb.cells[o], env_name)
                if t is not None:
                    total += t
                    known_any = True
            costs[env_name] = total
        if not known_any:
            return Decision(an.home, False,
                            "cost-matrix: no history or declared costs yet",
                            policy="cost")
        best = min(costs, key=lambda e: (costs[e], e != an.home))
        matrix = ", ".join(f"{e}={t:.2f}s" for e, t in costs.items())
        if best == current_env:
            return Decision(best, False,
                            f"cost-matrix: stay on {best} [{matrix}]",
                            block=block if best != an.home else (),
                            policy="cost")
        return Decision(best, True,
                        f"cost-matrix: {best} wins [{matrix}]",
                        block=block if best != an.home else (),
                        policy="cost")


class HorizonPolicy(PlacementPolicy):
    """Expected-cost placement over the next H cells (beyond the paper).

    Generalizes :class:`BlockPolicy`/:class:`CostMatrixPolicy`: instead of
    committing to the single most probable block, it chains the interaction
    model's next-cell distribution into per-step cell distributions
    ``d_t`` and runs a dynamic program over (step, env) against the
    fabric's cost matrix::

        V[H][e]  = transfer(e -> home, state)          # amortized return
        V[t][e]  = E_{c ~ d_t}[exec(c | e)]
                   + min_e' ( transfer(e -> e', state) + V[t+1][e'] )

    The decision is the env minimizing ``transfer(current -> e) + V[0][e]``
    — i.e. the placement with minimum *expected* cost over the horizon,
    not just the best response to one predicted path.  Requires a registry
    (per-pair links + env speedups).

    Cost plane (``analyzer.objective == "dollars"``): the same DP runs over
    lexicographic ``(expected dollars, expected seconds)`` step costs.
    Execution on env *e* is priced at ``price_per_hour(e)``; migration legs
    additionally pay the link's per-GB egress; a spot env's step cost is
    surcharged by its hazard-weighted expected recovery cost (``hazard *
    exec_seconds`` expected preemptions, each priced from the fleet's
    recovery ladder — replica promotion, checkpoint restore, or rerun).
    A per-cell latency SLO filters the envs the DP may route through:
    an env whose expected per-cell seconds (incl. hazard recovery) exceed
    the SLO is penalized out unless *no* env attains it.  With all prices
    zero and no hazards the dollar component is uniformly 0.0 and the
    lexicographic comparison degrades to the seconds DP — decisions are
    bit-identical to the seconds-only objective."""

    name = "horizon"

    def __init__(self, horizon: int = 4, *, memoize: bool = True):
        assert horizon >= 1
        self.horizon = int(horizon)
        # one decision queries the model's next-cell distribution for the
        # same cell once per chain step AND again in the block-plan walk;
        # a per-decision memo collapses those to one model call per
        # distinct cell.  Read-only sharing (every consumer iterates the
        # dict), so decisions stay bit-identical — memoize=False keeps the
        # recompute path alive for the equivalence test.
        self.memoize = bool(memoize)
        self.model_calls = 0           # distribution() calls actually made

    # -- helpers ---------------------------------------------------------
    def _dist(self, an, nb, c: int, cache: dict | None) -> dict:
        if cache is None:
            self.model_calls += 1
            return an.context.model.distribution(nb.name, c)
        hit = cache.get(c)
        if hit is None:
            self.model_calls += 1
            hit = cache[c] = an.context.model.distribution(nb.name, c)
        return hit

    def _step_distributions(self, an, nb, order: int,
                            cache: dict | None = None
                            ) -> list[dict[int, float]]:
        """d_0 = {current: 1}; d_{t+1} = d_t chained through the model's
        next-cell distribution, truncated to in-notebook cells."""
        dists: list[dict[int, float]] = [{order: 1.0}]
        d = dists[0]
        for _ in range(1, self.horizon):
            nd: dict[int, float] = defaultdict(float)
            for c, p in d.items():
                for c2, p2 in self._dist(an, nb, c, cache).items():
                    if 0 <= c2 < len(nb.cells):
                        nd[c2] += p * p2
            mass = sum(nd.values())
            if mass <= 1e-9:
                break
            d = {c: p / mass for c, p in sorted(nd.items())}
            dists.append(d)
        return dists

    def decide(self, an, nb, cell, current_env):
        assert an.registry is not None, "horizon policy needs a registry"
        order = nb.order(cell.cell_id)
        state = an.state_size_estimate[nb.name]
        cache: dict | None = {} if self.memoize else None
        dists = self._step_distributions(an, nb, order, cache)
        envs = [an.home] + an.candidates()

        # expected exec cost per (step, env); a cell missing an estimate on
        # ANY env contributes to none, keeping the comparison paired like
        # BlockPolicy (else the only env with evidence would be penalized)
        known_any = False
        expected: list[dict[str, float]] = []
        for d in dists:
            row: dict[str, float] = {e: 0.0 for e in envs}
            for c_order, p in d.items():
                ts = {e: _modeled_exec_seconds(an, nb.cells[c_order], e)
                      for e in envs}
                if any(t is None for t in ts.values()):
                    continue
                for e, t in ts.items():
                    row[e] += p * t
                known_any = True
            expected.append(row)
        if not known_any:
            return Decision(an.home, False,
                            "horizon: no history or declared costs yet",
                            policy="horizon")

        if an.objective == "dollars":
            # the price-aware DP lives on its own path so the seconds-only
            # code below stays float-for-float identical to the seed
            return self._decide_dollars(an, nb, current_env, order, state,
                                        dists, envs, cache)

        # backward DP + argmin successor per (step, env); the terminal V is
        # the amortized return-home transfer
        V = {e: an.pair_migration_time(state, e, an.home) for e in envs}
        succ: list[dict[str, str]] = []
        for t in range(len(dists) - 1, -1, -1):
            nv: dict[str, float] = {}
            ns: dict[str, str] = {}
            for e in envs:
                best_e, best_c = None, None
                for e2 in envs:
                    c = an.pair_migration_time(state, e, e2) + V[e2]
                    if best_c is None or c < best_c - 1e-12:
                        best_e, best_c = e2, c
                nv[e] = expected[t][e] + best_c
                ns[e] = best_e
            succ.append(ns)
            V = nv
        succ.reverse()

        costs = {e: an.pair_migration_time(state, current_env, e) + V[e]
                 + an.env_overhead(e)
                 for e in envs}
        best = min(costs, key=lambda e: (costs[e], e != an.home))
        matrix = ", ".join(f"{e}={t:.2f}s" for e, t in costs.items())

        # block plan: the greedy most-likely cell path for as long as the
        # DP keeps the placement on the chosen env
        block = [order]
        if best != an.home:
            e, c = best, order
            for t in range(1, len(dists)):
                e = succ[t - 1][e]
                if e != best:
                    break
                step = {c2: p for c2, p in self._dist(an, nb, c, cache).items()
                        if 0 <= c2 < len(nb.cells)}
                if not step:
                    break
                c = max(step.items(), key=lambda kv: (kv[1], -kv[0]))[0]
                # blocks are non-decreasing runs: a wrap ends the plan
                if c in block or c < block[-1]:
                    break
                block.append(c)

        if best == current_env:
            return Decision(best, False,
                            f"horizon(H={len(dists)}): stay on {best} "
                            f"[{matrix}]",
                            block=tuple(block) if best != an.home else (),
                            policy="horizon")
        return Decision(best, True,
                        f"horizon(H={len(dists)}): {best} minimizes expected "
                        f"cost [{matrix}]",
                        block=tuple(block) if best != an.home else (),
                        policy="horizon")

    # -- price-aware DP (cost plane) -------------------------------------
    # an env whose expected per-cell latency blows the SLO gets this added
    # to its step dollars: any SLO-feasible route beats it, but if *every*
    # env is infeasible the DP still produces a well-defined argmin
    SLO_PENALTY = 1e15

    @staticmethod
    def _lex_better(cand: tuple[float, float],
                    best: tuple[float, float]) -> bool:
        """Lexicographic (dollars, seconds) with the same 1e-12 epsilon the
        seconds DP uses — so an all-prices-zero fleet reproduces the
        seconds DP's successor choices exactly."""
        if cand[0] < best[0] - 1e-12:
            return True
        if cand[0] > best[0] + 1e-12:
            return False
        return cand[1] < best[1] - 1e-12

    def _decide_dollars(self, an, nb, current_env, order, state, dists,
                        envs, cache):
        """Backward DP over (step, env) minimizing lexicographic
        (expected dollars, expected seconds) subject to the per-cell SLO."""
        # per-(step, env) expected dollars + hazard-adjusted seconds; the
        # pairing rule matches the seconds path: a cell missing an estimate
        # on any env contributes to none
        dol: list[dict[str, float]] = []
        sec: list[dict[str, float]] = []
        for d in dists:
            drow = {e: 0.0 for e in envs}
            srow = {e: 0.0 for e in envs}
            for c_order, p in d.items():
                ts = {e: _modeled_exec_seconds(an, nb.cells[c_order], e)
                      for e in envs}
                if any(t is None for t in ts.values()):
                    continue
                for e, t in ts.items():
                    hs, hd = an.hazard_surcharge(e, t, state)
                    drow[e] += p * (an.exec_dollars(t, e) + hd)
                    srow[e] += p * (t + hs)
            dol.append(drow)
            sec.append(srow)

        # SLO feasibility: worst expected per-cell latency over the horizon
        # (exec + hazard-weighted recovery).  Entry migration and fleet
        # overhead are priced in the objective, not the feasibility test —
        # they hit only the first cell of a block.
        feasible = {e: True for e in envs}
        if an.slo is not None:
            for e in envs:
                lat = max((s[e] for s in sec), default=0.0)
                feasible[e] = lat <= an.slo + 1e-12

        V = {e: (an.transfer_dollars(state, e, an.home),
                 an.pair_migration_time(state, e, an.home)) for e in envs}
        succ: list[dict[str, str]] = []
        for t in range(len(dists) - 1, -1, -1):
            nv: dict[str, tuple[float, float]] = {}
            ns: dict[str, str] = {}
            for e in envs:
                best_e, best_c = None, None
                for e2 in envs:
                    c = (an.transfer_dollars(state, e, e2) + V[e2][0],
                         an.pair_migration_time(state, e, e2) + V[e2][1])
                    if best_c is None or self._lex_better(c, best_c):
                        best_e, best_c = e2, c
                pen = 0.0 if feasible[e] else self.SLO_PENALTY
                nv[e] = (dol[t][e] + pen + best_c[0], sec[t][e] + best_c[1])
                ns[e] = best_e
            succ.append(ns)
            V = nv
        succ.reverse()

        costs = {}
        for e in envs:
            over = an.env_overhead(e)
            pen = 0.0 if feasible[e] else self.SLO_PENALTY
            costs[e] = (an.transfer_dollars(state, current_env, e) + V[e][0]
                        + an.exec_dollars(over, e) + pen,
                        an.pair_migration_time(state, current_env, e)
                        + V[e][1] + over)
        best = min(costs, key=lambda e: (costs[e][0], costs[e][1],
                                         e != an.home))
        slo_note = ""
        if costs[best][0] >= self.SLO_PENALTY:
            # every env blows the SLO: fall back to fastest-expected-seconds
            best = min(costs, key=lambda e: (costs[e][1], e != an.home))
            slo_note = f"; SLO {an.slo:.1f}s unattainable, fastest env chosen"
        matrix = ", ".join(
            f"{e}=${costs[e][0] % self.SLO_PENALTY:.4f}/{costs[e][1]:.2f}s"
            + ("" if feasible[e] else "!slo") for e in envs)

        block = [order]
        if best != an.home:
            e, c = best, order
            for t in range(1, len(dists)):
                e = succ[t - 1][e]
                if e != best:
                    break
                step = {c2: p for c2, p in self._dist(an, nb, c, cache).items()
                        if 0 <= c2 < len(nb.cells)}
                if not step:
                    break
                c = max(step.items(), key=lambda kv: (kv[1], -kv[0]))[0]
                if c in block or c < block[-1]:
                    break
                block.append(c)

        if best == current_env:
            return Decision(best, False,
                            f"horizon-$(H={len(dists)}): stay on {best} "
                            f"[{matrix}]{slo_note}",
                            block=tuple(block) if best != an.home else (),
                            policy="horizon")
        return Decision(best, True,
                        f"horizon-$(H={len(dists)}): {best} minimizes "
                        f"expected dollars [{matrix}]{slo_note}",
                        block=tuple(block) if best != an.home else (),
                        policy="horizon")


POLICIES = {"single": SingleCellPolicy, "block": BlockPolicy,
            "cost": CostMatrixPolicy, "horizon": HorizonPolicy}


# ----------------------------------------------------------------------
# the analyzer
# ----------------------------------------------------------------------

class MigrationAnalyzer:
    def __init__(self, kb: KnowledgeBase, context: ContextDetector,
                 perf: PerfModel | None = None, *,
                 policy: str = "block",    # single | block | cost | horizon
                 use_knowledge: bool = True,
                 migration_latency: float = 0.5,
                 migration_bandwidth: float = 1e9,
                 registry=None,
                 horizon: int = 4,
                 objective: str = "seconds",   # seconds | dollars
                 slo: float | None = None):
        assert policy in POLICIES, policy
        if policy in ("cost", "horizon") and registry is None:
            raise ValueError(f"{policy} policy requires a registry")
        if objective not in ("seconds", "dollars"):
            raise ValueError(f"unknown objective {objective!r} "
                             "(expected 'seconds' or 'dollars')")
        if objective == "dollars" and registry is None:
            raise ValueError("objective='dollars' requires a registry "
                             "(prices live on envs and links)")
        if slo is not None and slo <= 0:
            raise ValueError(f"slo must be > 0 seconds, got {slo}")
        self.kb = kb
        self.context = context
        self.perf = perf or PerfModel()
        self.policy = policy
        self.use_knowledge = use_knowledge
        self.migration_latency = migration_latency
        self.migration_bandwidth = migration_bandwidth
        self.registry = registry
        self.horizon = int(horizon)
        # fleet plane attaches an object with overhead_seconds(env) here so
        # cost/horizon placement prices provisioning delay + queue depth;
        # None (the default) keeps the paper's decisions bit-identical
        self.fleet_view = None
        # live replication attaches an object with residual_bytes(nbytes,
        # src, dst) here so placement prices only the bytes NOT already
        # trickled to the target; None (the default) keeps decisions
        # bit-identical to the unreplicated run
        self.replication_view = None
        # cost plane: "seconds" (the paper's objective) or "dollars"
        # (expected dollars subject to the per-cell latency SLO below)
        self.objective = objective
        self.slo = slo
        # the fleet scheduler attaches an object with
        # expected_recovery(env) -> (seconds, dollars) here, pricing one
        # preemption from its configured recovery ladder (replica
        # promotion / checkpoint restore / rerun); None falls back to a
        # conservative re-ship-and-rerun model
        self.recovery_view = None
        self.state_size_estimate: dict[str, float] = defaultdict(lambda: 1e6)
        self._chain: list[PlacementPolicy] = []
        if use_knowledge:
            self._chain.append(KnowledgePolicy())
        if policy == "horizon":
            self._chain.append(HorizonPolicy(self.horizon))
        else:
            self._chain.append(POLICIES[policy]())

    # -- fabric views ----------------------------------------------------
    @property
    def home(self) -> str:
        return self.registry.home if self.registry is not None else "local"

    def candidates(self) -> list[str]:
        """Placement candidates other than home."""
        if self.registry is not None:
            return self.registry.candidates()
        return ["remote"]

    def offload_target(self) -> str:
        """Default offload env (fastest candidate): the paper's 'remote'."""
        cands = self.candidates()
        if not cands:
            return self.home    # every candidate is down: stay put
        if self.registry is not None and len(cands) > 1:
            return max(cands, key=lambda n: self.registry[n].speedup)
        return cands[0]

    # -- migration cost --------------------------------------------------
    def migration_time(self, nbytes: float) -> float:
        """Home <-> default offload target cost (the paper's scalar model)."""
        if self.registry is not None:
            return self.registry.transfer_seconds(
                self.home, self.offload_target(), nbytes)
        return self.migration_latency + nbytes / self.migration_bandwidth

    def pair_migration_time(self, nbytes: float, src: str, dst: str) -> float:
        if src == dst:
            return 0.0
        if self.replication_view is not None:
            nbytes = self.replication_view.residual_bytes(nbytes, src, dst)
        if self.registry is not None:
            return self.registry.transfer_seconds(src, dst, nbytes)
        return self.migration_latency + nbytes / self.migration_bandwidth

    def observe_state_size(self, notebook: str, nbytes: float) -> None:
        self.state_size_estimate[notebook] = float(nbytes)

    def env_overhead(self, env_name: str) -> float:
        """Fleet-plane surcharge for targeting ``env_name`` right now:
        remaining provisioning cold-start + expected queue wait.  Zero
        without an attached fleet view (the paper's always-on dyad)."""
        if self.fleet_view is None:
            return 0.0
        return float(self.fleet_view.overhead_seconds(env_name))

    # -- cost plane ------------------------------------------------------
    def env_price(self, env_name: str) -> float:
        """Dollars per hour of occupying ``env_name`` (0 without a registry
        — the paper's dyad is free)."""
        if self.registry is None or env_name not in self.registry:
            return 0.0
        return self.registry[env_name].price_per_hour

    def exec_dollars(self, seconds: float, env_name: str) -> float:
        return self.env_price(env_name) * seconds / 3600.0

    def env_hazard(self, env_name: str) -> float:
        """Preemption hazard (events/second) of ``env_name``; 0 = on-demand."""
        if self.registry is None or env_name not in self.registry:
            return 0.0
        return self.registry[env_name].hazard_rate

    def transfer_dollars(self, nbytes: float, src: str, dst: str) -> float:
        """Egress dollars src→dst for the *residual* bytes — the same
        replication discount :meth:`pair_migration_time` applies."""
        if src == dst or self.registry is None:
            return 0.0
        if self.replication_view is not None:
            nbytes = self.replication_view.residual_bytes(nbytes, src, dst)
        return self.registry.transfer_dollars(src, dst, nbytes)

    def hazard_surcharge(self, env_name: str, exec_seconds: float,
                         state_bytes: float) -> tuple[float, float]:
        """Expected (seconds, dollars) a preemption hazard adds to running
        one cell of ``exec_seconds`` on ``env_name``: ``hazard *
        exec_seconds`` expected preemptions, each costing one recovery.
        The recovery is priced from the fleet's ladder when a
        ``recovery_view`` is attached; the fallback models the worst rung —
        re-ship the state from home and rerun the cell."""
        h = self.env_hazard(env_name)
        if h <= 0.0 or exec_seconds <= 0.0:
            return 0.0, 0.0
        if self.recovery_view is not None:
            r_sec, r_dol = self.recovery_view.expected_recovery(env_name)
            r_sec += exec_seconds / 2.0        # expected lost partial work
            r_dol += self.exec_dollars(exec_seconds / 2.0, env_name)
        else:
            r_sec = (self.pair_migration_time(state_bytes, self.home, env_name)
                     + exec_seconds)
            r_dol = (self.transfer_dollars(state_bytes, self.home, env_name)
                     + self.exec_dollars(exec_seconds, env_name))
        n = h * exec_seconds                   # expected preemptions mid-cell
        return n * r_sec, n * r_dol

    # ------------------------------------------------------------------
    def decide(self, nb: Notebook, cell: Cell, *,
               current_env: str | None = None, peek: bool = False) -> Decision:
        """Run the policy chain.  ``peek=True`` skips annotations (used by
        the pipelined engine to predict the next hop without side effects)."""
        current_env = current_env or self.home
        for pol in self._chain:
            d = pol.decide(self, nb, cell, current_env)
            if d is not None:
                if not peek:
                    cell.annotate(d.reason)
                return d
        return Decision(self.home, False, "no policy fired")  # pragma: no cover

    # ------------------------------------------------------------------
    # Algorithm 2: dynamic migration parameter update
    # ------------------------------------------------------------------
    def update_parameters(self, cell: Cell, runtime, *, probe_values=(1, 2, 3),
                          max_wait: float | None = None) -> dict[str, float]:
        """Probe small parameter values in both environments, fit the two
        regressors, store the intersection in the KB.  ``runtime`` must expose
        ``probe(cell_source, env_name) -> seconds`` (background execution)."""
        info = analyze_cell(cell.source)
        updated: dict[str, float] = {}
        known = set(self.kb.get_known_parameters())
        probe_env = self.offload_target()
        for fn, kwargs in info.call_kwargs.items():
            for p in (set(kwargs) & known):
                t_loc, t_rem, used = [], [], []
                budget = max_wait
                for v in probe_values:
                    src = substitute_kwarg(cell.source, p, v)
                    tl = runtime.probe(src, self.home)
                    tr = runtime.probe(src, probe_env)
                    used.append(v)
                    t_loc.append(tl)
                    t_rem.append(tr)
                    if budget is not None:
                        budget -= max(tl, tr)  # probes run in parallel (§II-C)
                        if budget <= 0:
                            break
                if len(used) < 2:
                    continue
                ml = fit_linear(used, t_loc)
                mr = fit_linear(used, t_rem)
                t_mig = self.migration_time(self.state_size_estimate.get(
                    "default", 1e6))
                opt = intersection(ml, mr, t_mig)
                self.kb.update(p, opt)
                self.kb.record(ProvRecord(
                    "kb-update", cell.cell_id, None, 0.0, 0.0,
                    params={"param": p, "local": ml, "remote": mr,
                            "migration_time": t_mig, "threshold": opt}))
                updated[p] = opt
        return updated
