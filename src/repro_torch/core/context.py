"""Context detector (paper §II-B, Algorithm 1).

The detector is now a thin telemetry-bus adapter over a pluggable
:class:`~repro_torch.core.interaction.InteractionModel` (default:
:class:`~repro_torch.core.interaction.FrequencyModel`, the incremental Algorithm 1
— bit-identical decisions to the original per-query rescan).  The module
keeps the reference implementation of Algorithm 1 (:func:`get_sequences` /
:func:`sequence_stats`) as pure functions over a history list: they are the
specification the incremental model is property-tested against.
"""
from __future__ import annotations

from collections import defaultdict

from repro_torch.core import telemetry as T
from repro_torch.core.interaction import (
    FrequencyModel, InteractionModel, _contiguous_subseq, make_model,
)


def get_sequences(history_order: list[int]) -> list[tuple[int, ...]]:
    """Split a cell-order interaction history into non-decreasing runs.

    Paper example: 1,2,3,2,3 -> (1,2,3), (2,3): a new sequence starts
    whenever the ongoing one is broken (next order < current)."""
    seqs: list[tuple[int, ...]] = []
    cur: list[int] = []
    for o in history_order:
        if cur and o < cur[-1]:
            seqs.append(tuple(cur))
            cur = []
        cur.append(o)
    if cur:
        seqs.append(tuple(cur))
    return seqs


def sequence_stats(history_order: list[int],
                   current_order: int | None = None) -> dict[tuple[int, ...], float]:
    """Algorithm 1: score sequences by frequency (%), optionally restricted to
    sequences containing the current active cell."""
    sequences = get_sequences(history_order)
    if current_order is not None:
        sequences = [s for s in sequences if current_order in s]
    if not sequences:
        return {}

    counts: dict[tuple[int, ...], int] = defaultdict(int)
    for s in sequences:
        counts[s] += 1  # duplicates removed but counted (lines 7-11)

    stats: dict[tuple[int, ...], float] = {}
    total = 0
    for s in sorted(counts, key=len):  # increasing length (line 4)
        subtotal = counts[s]
        for o in counts:
            if o != s and _contiguous_subseq(s, o):
                subtotal += counts[o]
        stats[s] = subtotal
        total += subtotal

    return {s: v / total * 100.0 for s, v in stats.items()}  # lines 14-15


class ContextDetector:
    """Subscribes to the MQ bus; feeds per-notebook interaction history into
    the pluggable interaction model and answers prediction queries from it.

    ``model`` accepts an :class:`InteractionModel` instance, a registered
    model name (``frequency`` | ``markov`` | ``recency`` | ``ensemble``) or
    None for the paper's default."""

    def __init__(self, model: InteractionModel | str | None = None):
        self.model = make_model(model)
        self.history: dict[str, list[int]] = defaultdict(list)
        self._attached: list[tuple[T.MQBus, str]] = []

    def attach(self, bus: T.MQBus, topic: str = "telemetry") -> None:
        bus.subscribe(topic, self.on_message)
        self._attached.append((bus, topic))

    def detach(self) -> None:
        """Unsubscribe from every bus this detector attached to (sessions
        must not leak their subscribers into later sessions)."""
        for bus, topic in self._attached:
            bus.unsubscribe(topic, self.on_message)
        self._attached.clear()

    def on_message(self, msg: T.TelemetryMessage) -> None:
        if msg.type != T.CELL_EXECUTION_COMPLETED or msg.cell_id is None:
            return
        order = msg.payload.get("order")
        if order is None:
            try:
                order = list(msg.cell_ids).index(msg.cell_id)
            except ValueError:
                # the cell was deleted/renamed mid-session: the event no
                # longer maps onto an order — drop it rather than crash the
                # whole bus dispatch
                return
        self.record(msg.notebook, int(order))

    # ------------------------------------------------------------------
    def record(self, notebook: str, order: int) -> None:
        self.history[notebook].append(int(order))
        self.model.observe(notebook, int(order))

    def stats(self, notebook: str, current_order: int | None = None):
        """Algorithm-1 sequence scores.  Served incrementally by the
        frequency model; other models fall back to the reference rescan
        over the recorded history."""
        if isinstance(self.model, FrequencyModel):
            return self.model.stats(notebook, current_order)
        return sequence_stats(self.history[notebook], current_order)

    def distribution(self, notebook: str, current_order: int) -> dict[int, float]:
        """P(next cell | history, current) from the interaction model."""
        return self.model.distribution(notebook, current_order)

    def predict_block(self, notebook: str, current_order: int) -> tuple[int, ...]:
        """Most probable upcoming block from the current cell onward."""
        return self.model.predict_block(notebook, current_order)

    def predict_block_scored(
            self, notebook: str, current_order: int,
    ) -> tuple[tuple[int, ...], float, int]:
        """(block, score%, n_candidates) — score is the model's confidence
        in the chosen block; n_candidates gauges how much evidence the
        prediction rests on."""
        return self.model.predict_block_scored(notebook, current_order)

    def predict_next(self, notebook: str, current_order: int) -> int | None:
        """The cell most likely to run *after* the current one — used by the
        pipelined engine to prefetch the next hop's state during execution."""
        return self.model.predict_next(notebook, current_order)
