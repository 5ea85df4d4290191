"""Predictive interaction models (the decision plane's prediction subsystem).

The paper's context detector (§II-B, Algorithm 1) mines the history of
cell-order interactions for non-decreasing sequences and predicts the block
the user is about to execute.  This module extracts that prediction into a
pluggable :class:`InteractionModel` interface so the placement policies, the
pipelined engine's speculative prefetch, and the scheduler's telemetry all
consume one abstraction:

* :class:`FrequencyModel` — Algorithm 1, made *incremental*: per-event O(1)
  amortized suffix-count updates instead of the O(n²) per-query history
  rescans of the original detector.  Scores (and tie-breaks) are
  bit-identical to :func:`repro_torch.core.context.sequence_stats`.
* :class:`MarkovModel` — k-th-order transition counts with Laplace
  smoothing; yields a *full* next-cell probability distribution and backs
  off to shorter contexts when the current one is unseen.
* :class:`RecencyModel` — exponentially decayed first-order transitions, so
  drifting interactivity (the user moves to a new part of the notebook)
  doesn't fossilize the predictor.
* :class:`EnsembleModel` — a multiplicative-weights mixture of the above:
  each realized next cell reweights the members by the probability they
  assigned to it.

:class:`ConfidenceGate` gates speculative prefetch on predicted probability
mass and self-calibrates its threshold online from realized hit/miss
outcomes (fed from KB prediction provenance by the runtime).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


def _argmax(dist: dict[int, float]) -> tuple[int, float] | None:
    """Deterministic argmax: highest probability, smallest cell id on ties."""
    if not dist:
        return None
    best = max(dist.items(), key=lambda kv: (kv[1], -kv[0]))
    return best


def top_candidates(dist: dict[int, float], k: int) -> list[tuple[int, float]]:
    """The ``k`` most likely next cells, deterministically ordered (highest
    probability first, smallest cell id on ties) — the shared target-
    selection rule for speculative prefetch and background trickling."""
    if k <= 0:
        return []
    return sorted(dist.items(), key=lambda kv: (-kv[1], kv[0]))[:k]


# ----------------------------------------------------------------------
# interface
# ----------------------------------------------------------------------

class InteractionModel:
    """One next-cell predictor.  ``observe`` feeds realized executions;
    ``distribution`` returns P(next cell | history, current); block
    prediction drives the block policies and the prefetch planner."""

    name = "model"

    def observe(self, notebook: str, order: int) -> None:
        raise NotImplementedError

    def distribution(self, notebook: str, current: int) -> dict[int, float]:
        """P(next | current). May be empty when there is no evidence."""
        raise NotImplementedError

    def predict_block_scored(
            self, notebook: str, current: int,
    ) -> tuple[tuple[int, ...], float, int]:
        """(block, score%, n_candidates): the cells expected to run from the
        current one onward, the confidence score of that block (percent),
        and how many distinct candidates the evidence offered."""
        raise NotImplementedError

    def predict_block(self, notebook: str, current: int) -> tuple[int, ...]:
        return self.predict_block_scored(notebook, current)[0]

    def predict_next(self, notebook: str, current: int) -> int | None:
        """The most likely cell after ``current`` (None without evidence)."""
        best = _argmax(self.distribution(notebook, current))
        return best[0] if best is not None else None

    def reset(self, notebook: str | None = None) -> None:
        raise NotImplementedError


# ----------------------------------------------------------------------
# Algorithm 1, incremental
# ----------------------------------------------------------------------

def _contiguous_subseq(a: tuple, b: tuple) -> bool:
    """a is a contiguous subsequence of b (shared with context.py's
    reference implementation — one definition, one semantics)."""
    n, m = len(a), len(b)
    if n > m:
        return False
    return any(b[i:i + n] == a for i in range(m - n + 1))


class _FreqState:
    """Per-notebook incremental Algorithm-1 bookkeeping.

    The key identity: after filtering to sequences containing the current
    cell, a sequence's Algorithm-1 subtotal equals the number of run
    *occurrences* that contain it as a contiguous subsequence (each run
    containing s also contains the current cell, because s does).  So we
    maintain, per distinct contiguous subsequence ever produced by a closed
    run, the count of closed-run occurrences containing it — updated once
    when a run closes (O(L³) in the run length L, which is bounded by the
    notebook's cell count: O(1) amortized in the history length)."""

    __slots__ = ("counts", "sub_occ", "containing", "first_seen", "seq_no",
                 "open_run", "last")

    def __init__(self):
        self.counts: dict[tuple[int, ...], int] = {}
        self.sub_occ: dict[tuple[int, ...], int] = defaultdict(int)
        self.containing: dict[int, set[tuple[int, ...]]] = defaultdict(set)
        self.first_seen: dict[tuple[int, ...], int] = {}
        self.seq_no = 0
        self.open_run: list[int] = []
        self.last: int | None = None

    def push(self, order: int) -> None:
        if self.open_run and order < self.open_run[-1]:
            self._close()
        self.open_run.append(order)

    def _close(self) -> None:
        run = tuple(self.open_run)
        self.open_run = []
        if run not in self.counts:
            self.counts[run] = 0
            self.first_seen[run] = self.seq_no
            for o in set(run):
                self.containing[o].add(run)
        self.counts[run] += 1
        self.seq_no += 1
        # every distinct contiguous subsequence of this occurrence is
        # contained one more time
        n = len(run)
        subs = {run[i:j] for i in range(n) for j in range(i + 1, n + 1)}
        for s in subs:
            self.sub_occ[s] += 1


class FrequencyModel(InteractionModel):
    """Algorithm 1 (paper §II-B) with incremental per-event updates.

    ``stats``/``predict_block_scored`` are bit-identical to the original
    per-query :func:`repro_torch.core.context.sequence_stats` rescan, including
    dict ordering (increasing length, then first appearance) — which the
    legacy ``max`` tie-breaking depends on."""

    name = "frequency"

    def __init__(self):
        self._nb: dict[str, _FreqState] = defaultdict(_FreqState)

    def observe(self, notebook: str, order: int) -> None:
        self._nb[notebook].push(int(order))

    def reset(self, notebook: str | None = None) -> None:
        if notebook is None:
            self._nb.clear()
        else:
            self._nb.pop(notebook, None)

    # -- Algorithm 1 ----------------------------------------------------
    def stats(self, notebook: str,
              current: int | None = None) -> dict[tuple[int, ...], float]:
        st = self._nb[notebook]
        cur = tuple(st.open_run)
        if current is None:
            cands = set(st.counts)
            if cur:
                cands.add(cur)
        else:
            cands = set(st.containing.get(current, ()))
            if cur and current in cur:
                cands.add(cur)
        if not cands:
            return {}
        raw: dict[tuple[int, ...], int] = {}
        for s in cands:
            v = st.sub_occ.get(s, 0)
            if cur and _contiguous_subseq(s, cur):
                v += 1
            raw[s] = v
        total = sum(raw.values())
        # legacy ordering: increasing length, ties by first appearance (the
        # open run, when unseen as a closed run, appears last)
        nxt = st.seq_no
        ordered = sorted(raw, key=lambda s: (len(s),
                                             st.first_seen.get(s, nxt)))
        return {s: raw[s] / total * 100.0 for s in ordered}

    def distribution(self, notebook: str, current: int) -> dict[int, float]:
        """Next-hop distribution implied by Algorithm 1: each candidate
        sequence votes its score for its successor of the current cell."""
        stats = self.stats(notebook, current)
        votes: dict[int, float] = defaultdict(float)
        for s, score in stats.items():
            i = s.index(current)
            if i + 1 < len(s):
                votes[s[i + 1]] += score
        total = sum(votes.values())
        if total <= 0:
            return {}
        return {c: v / total for c, v in sorted(votes.items())}

    def predict_block_scored(
            self, notebook: str, current: int,
    ) -> tuple[tuple[int, ...], float, int]:
        stats = self.stats(notebook, current)
        if not stats:
            return (current,), 0.0, 0
        best, score = max(stats.items(), key=lambda kv: (kv[1], len(kv[0])))
        i = best.index(current)
        return best[i:], score, len(stats)

    def predict_next(self, notebook: str, current: int) -> int | None:
        # legacy rule: the element following the current cell in the most
        # probable sequence (not the vote-pooled argmax)
        block = self.predict_block(notebook, current)
        if len(block) > 1:
            return block[1]
        return None


# ----------------------------------------------------------------------
# Markov / recency / ensemble
# ----------------------------------------------------------------------

class MarkovModel(InteractionModel):
    """k-th-order transition counts with Laplace smoothing and backoff.

    Maintains counts for every context length 1..k so an unseen long
    context backs off to shorter ones; the distribution is smoothed over
    the notebook's observed vocabulary (plus the queried cell), so it
    always sums to 1 whenever there is any evidence."""

    name = "markov"

    def __init__(self, order: int = 2, alpha: float = 0.5,
                 horizon: int = 8, block_threshold: float = 0.4):
        assert order >= 1
        self.order = order
        self.alpha = float(alpha)
        self.horizon = int(horizon)
        self.block_threshold = float(block_threshold)
        self._trans: dict[str, dict[tuple[int, ...], dict[int, int]]] = \
            defaultdict(dict)
        self._tail: dict[str, list[int]] = defaultdict(list)
        self._vocab: dict[str, set[int]] = defaultdict(set)

    def observe(self, notebook: str, order: int) -> None:
        order = int(order)
        tail = self._tail[notebook]
        table = self._trans[notebook]
        for k in range(1, self.order + 1):
            if len(tail) >= k:
                ctx = tuple(tail[-k:])
                nxt = table.setdefault(ctx, {})
                nxt[order] = nxt.get(order, 0) + 1
        tail.append(order)
        del tail[:-self.order]
        self._vocab[notebook].add(order)

    def reset(self, notebook: str | None = None) -> None:
        for d in (self._trans, self._tail, self._vocab):
            if notebook is None:
                d.clear()
            else:
                d.pop(notebook, None)

    # ------------------------------------------------------------------
    def _context_for(self, notebook: str, current: int) -> list[int]:
        tail = self._tail[notebook]
        if tail and tail[-1] == current:
            return list(tail)
        return (list(tail) + [current])[-self.order:]

    def _dist_from_context(self, notebook: str,
                           ctx: list[int]) -> dict[int, float]:
        seen = self._vocab[notebook]
        if not seen:
            return {}          # no evidence at all: no distribution
        vocab = sorted(seen | set(ctx))
        table = self._trans[notebook]
        for k in range(min(self.order, len(ctx)), 0, -1):
            counts = table.get(tuple(ctx[-k:]))
            if counts:
                total = sum(counts.values())
                denom = total + self.alpha * len(vocab)
                return {v: (counts.get(v, 0) + self.alpha) / denom
                        for v in vocab}
        return {v: 1.0 / len(vocab) for v in vocab}

    def _raw_candidates(self, notebook: str, ctx: list[int]) -> int:
        table = self._trans[notebook]
        for k in range(min(self.order, len(ctx)), 0, -1):
            counts = table.get(tuple(ctx[-k:]))
            if counts:
                return len(counts)
        return 0

    def distribution(self, notebook: str, current: int) -> dict[int, float]:
        return self._dist_from_context(
            notebook, self._context_for(notebook, current))

    def predict_block_scored(
            self, notebook: str, current: int,
    ) -> tuple[tuple[int, ...], float, int]:
        ctx = self._context_for(notebook, current)
        ncand = self._raw_candidates(notebook, ctx)
        if ncand == 0:
            return (current,), 0.0, 0
        block = [current]
        score = 0.0
        roll = list(ctx)
        for step in range(self.horizon):
            best = _argmax(self._dist_from_context(notebook, roll))
            if best is None:
                break
            nxt, p = best
            if step == 0:
                score = p * 100.0
            # a block is a non-decreasing run (paper §II-B): a predicted
            # wrap-around (loop restart) ends the block rather than
            # promising cells the runtime's plan bookkeeping would drop
            if p < self.block_threshold or nxt in block or nxt < block[-1]:
                break
            block.append(nxt)
            roll = (roll + [nxt])[-self.order:]
        return tuple(block), score, ncand


class RecencyModel(InteractionModel):
    """Exponentially decayed first-order transitions.

    Each observed transition adds weight 1; every prior weight decays by
    ``decay`` per event, applied lazily (stored as (weight, stamp) pairs),
    so observe is O(1) and queries touch only the current cell's
    successors.  Drift therefore overtakes fossils in O(log) events."""

    name = "recency"

    def __init__(self, decay: float = 0.9, horizon: int = 8,
                 block_threshold: float = 0.4):
        assert 0.0 < decay <= 1.0
        self.decay = float(decay)
        self.horizon = int(horizon)
        self.block_threshold = float(block_threshold)
        # nb -> prev -> {next: (weight, stamp)}
        self._w: dict[str, dict[int, dict[int, tuple[float, int]]]] = \
            defaultdict(dict)
        self._t: dict[str, int] = defaultdict(int)
        self._last: dict[str, int] = {}

    def observe(self, notebook: str, order: int) -> None:
        order = int(order)
        t = self._t[notebook]
        last = self._last.get(notebook)
        if last is not None:
            succ = self._w[notebook].setdefault(last, {})
            w, stamp = succ.get(order, (0.0, t))
            succ[order] = (w * self.decay ** (t - stamp) + 1.0, t)
        self._t[notebook] = t + 1
        self._last[notebook] = order

    def reset(self, notebook: str | None = None) -> None:
        for d in (self._w, self._t, self._last):
            if notebook is None:
                d.clear()
            else:
                d.pop(notebook, None)

    def _weights(self, notebook: str, current: int) -> dict[int, float]:
        t = self._t[notebook]
        succ = self._w[notebook].get(current)
        if not succ:
            return {}
        return {v: w * self.decay ** (t - stamp)
                for v, (w, stamp) in sorted(succ.items())}

    def distribution(self, notebook: str, current: int) -> dict[int, float]:
        w = self._weights(notebook, current)
        total = sum(w.values())
        if total <= 0:
            return {}
        return {v: x / total for v, x in w.items()}

    def predict_block_scored(
            self, notebook: str, current: int,
    ) -> tuple[tuple[int, ...], float, int]:
        dist = self.distribution(notebook, current)
        if not dist:
            return (current,), 0.0, 0
        block = [current]
        score = 0.0
        cur = current
        for step in range(self.horizon):
            best = _argmax(self.distribution(notebook, cur))
            if best is None:
                break
            nxt, p = best
            if step == 0:
                score = p * 100.0
            # blocks are non-decreasing runs: a wrap-around ends the block
            if p < self.block_threshold or nxt in block or nxt < block[-1]:
                break
            block.append(nxt)
            cur = nxt
        return tuple(block), score, len(dist)


class EnsembleModel(InteractionModel):
    """Multiplicative-weights mixture of interaction models.

    Before each observation reaches the members, every member is scored by
    the probability it assigned to the realized next cell; weights multiply
    by ``floor + p`` and renormalize, so persistently wrong members decay
    and the mixture tracks whichever member fits the current interactivity
    regime (frequency for stable loops, recency under drift)."""

    name = "ensemble"

    def __init__(self, models: list[InteractionModel] | None = None,
                 floor: float = 0.1, min_weight: float = 0.02):
        self.models = models if models is not None else [
            FrequencyModel(), MarkovModel(), RecencyModel()]
        assert self.models
        self.floor = float(floor)
        self.min_weight = float(min_weight)
        self.weights = [1.0 / len(self.models)] * len(self.models)
        self._last: dict[str, int] = {}

    def observe(self, notebook: str, order: int) -> None:
        order = int(order)
        last = self._last.get(notebook)
        if last is not None:
            scores = []
            for m in self.models:
                p = m.distribution(notebook, last).get(order, 0.0)
                scores.append(self.floor + p)
            new = [w * s for w, s in zip(self.weights, scores)]
            total = sum(new)
            if total > 0:
                new = [max(w / total, self.min_weight) for w in new]
                norm = sum(new)
                self.weights = [w / norm for w in new]
        for m in self.models:
            m.observe(notebook, order)
        self._last[notebook] = order

    def reset(self, notebook: str | None = None) -> None:
        for m in self.models:
            m.reset(notebook)
        if notebook is None:
            self._last.clear()
            self.weights = [1.0 / len(self.models)] * len(self.models)
        else:
            self._last.pop(notebook, None)

    def distribution(self, notebook: str, current: int) -> dict[int, float]:
        mix: dict[int, float] = defaultdict(float)
        for w, m in zip(self.weights, self.models):
            for c, p in m.distribution(notebook, current).items():
                mix[c] += w * p
        total = sum(mix.values())
        if total <= 0:
            return {}
        return {c: p / total for c, p in sorted(mix.items())}

    def predict_block_scored(
            self, notebook: str, current: int,
    ) -> tuple[tuple[int, ...], float, int]:
        i = max(range(len(self.models)), key=lambda j: self.weights[j])
        block, score, ncand = self.models[i].predict_block_scored(
            notebook, current)
        mix = self.distribution(notebook, current)
        if len(block) > 1 and mix:
            score = mix.get(block[1], 0.0) * 100.0
        return block, score, max(ncand, len(mix))


# ----------------------------------------------------------------------
# confidence gate (speculative-prefetch admission)
# ----------------------------------------------------------------------

@dataclass
class ConfidenceGate:
    """Admits a speculative prefetch only when the predicted next hop's
    probability mass clears ``threshold`` — and moves the threshold online:
    each realized outcome of an *issued* prefetch updates an EWMA hit-rate
    estimate, and the threshold steps toward keeping that estimate at
    ``target_hit_rate`` (more misses -> stricter gate, clamped to bounds).
    The runtime feeds outcomes from KB prediction-provenance records, so
    the gate self-calibrates to the user's actual interactivity."""

    threshold: float = 0.35
    target_hit_rate: float = 0.6
    lr: float = 0.1
    relax: float = 0.05
    bounds: tuple[float, float] = (0.05, 0.95)
    hit_rate: float = field(default=0.5, init=False)
    issued: int = field(default=0, init=False)
    hits: int = field(default=0, init=False)
    rejections: int = field(default=0, init=False)
    _initial: float = field(default=0.0, init=False, repr=False)

    def __post_init__(self):
        self._initial = self.threshold

    def allow(self, prob: float) -> bool:
        return prob >= self.threshold

    def observe(self, hit: bool) -> None:
        """Record the realized outcome of one issued prefetch."""
        self.issued += 1
        self.hits += int(hit)
        self.hit_rate = (1 - self.lr) * self.hit_rate + self.lr * float(hit)
        lo, hi = self.bounds
        self.threshold = min(hi, max(
            lo, self.threshold + self.lr * (self.target_hit_rate
                                            - self.hit_rate)))

    def rejected(self) -> None:
        """A candidate was gated out.  The threshold only *rises* on issued
        outcomes, so without this it could latch above the model's maximum
        attainable probability and kill speculation forever; each rejection
        decays a latched-high threshold back toward its initial value, so
        the gate re-opens once the miss storm that raised it has passed."""
        self.rejections += 1
        if self.threshold > self._initial:
            self.threshold = self._initial + (
                self.threshold - self._initial) * (1.0 - self.relax)


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------

MODELS = {"frequency": FrequencyModel, "markov": MarkovModel,
          "recency": RecencyModel, "ensemble": EnsembleModel}


def make_model(spec: "InteractionModel | str | None") -> InteractionModel:
    """Resolve a model spec: an instance passes through, a name constructs
    the registered class, None means the paper's default (FrequencyModel)."""
    if spec is None:
        return FrequencyModel()
    if isinstance(spec, InteractionModel):
        return spec
    if isinstance(spec, str):
        if spec not in MODELS:
            raise ValueError(f"unknown interaction model {spec!r}; "
                             f"choose from {sorted(MODELS)}")
        return MODELS[spec]()
    raise TypeError(f"model spec must be InteractionModel | str | None, "
                    f"got {type(spec).__name__}")
