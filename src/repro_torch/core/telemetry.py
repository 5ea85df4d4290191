"""Telemetry message types and MQ bus (paper §II-A, Table I).

The JupyterLab front-end extension of the paper emits telemetry for every
relevant user action through an authenticated endpoint onto a message-queue
bus (Redis in the paper).  Here the bus is an in-process synchronous pub/sub
with the same message schema; the interface mirrors a Redis channel so a
networked broker can be dropped in.
"""
from __future__ import annotations

import uuid
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable

# Table I — telemetry message types
SESSION_STARTED = "session-started"
SESSION_DISPOSED = "session-disposed"
CELL_EXECUTION_REQUESTED = "cell-execution-requested"
CELL_EXECUTION_STARTED = "cell-execution-started"
CELL_EXECUTION_COMPLETED = "cell-execution-completed"
CELL_MODIFIED = "cell-modified"
# fabric extensions (beyond Table I): multi-session queueing + pipelining
CELL_EXECUTION_QUEUED = "cell-execution-queued"
STATE_PREFETCHED = "state-prefetched"
STATE_PREFETCH_CANCELLED = "state-prefetch-cancelled"
# live replication: think-time delta trickling to likely targets
STATE_TRICKLED = "state-trickled"
STATE_TRICKLE_CANCELLED = "state-trickle-cancelled"
STATE_TRICKLE_CLAIMED = "state-trickle-claimed"
# fleet-plane extensions: env lifecycle, failures, checkpoint recovery
ENV_LIFECYCLE = "env-lifecycle"
ENV_FAILED = "env-failed"
SESSION_CHECKPOINTED = "session-checkpointed"
SESSION_RECOVERED = "session-recovered"
# replica plane: converged followers, zero-replay promotion, cell racing
STATE_REPLICATED = "state-replicated"
SESSION_PROMOTED = "session-promoted"
CELL_RACED = "cell-raced"
CELL_RACE_CANCELLED = "cell-race-cancelled"

ALL_TYPES = (SESSION_STARTED, SESSION_DISPOSED, CELL_EXECUTION_REQUESTED,
             CELL_EXECUTION_STARTED, CELL_EXECUTION_COMPLETED, CELL_MODIFIED,
             CELL_EXECUTION_QUEUED, STATE_PREFETCHED,
             STATE_PREFETCH_CANCELLED, STATE_TRICKLED,
             STATE_TRICKLE_CANCELLED, STATE_TRICKLE_CLAIMED,
             ENV_LIFECYCLE, ENV_FAILED,
             SESSION_CHECKPOINTED, SESSION_RECOVERED,
             STATE_REPLICATED, SESSION_PROMOTED,
             CELL_RACED, CELL_RACE_CANCELLED)


@dataclass(frozen=True)
class TelemetryMessage:
    """Schema per §II-A: datetime, cell id, notebook, current cell ids,
    session UUID, notebook path, and message type (+ free-form payload)."""
    datetime: float
    type: str
    cell_id: str | None
    notebook: str
    cell_ids: tuple[str, ...]
    session: str
    path: str
    payload: dict = field(default_factory=dict)

    def __post_init__(self):
        assert self.type in ALL_TYPES, self.type


class MQBus:
    """Synchronous in-process pub/sub with bounded history (deterministic).

    ``history`` is a ring buffer (``history_limit`` most recent messages) so
    long-lived buses don't pin every message ever published; subscribers can
    ``unsubscribe`` so sessions don't leak their handlers into later ones."""

    def __init__(self, history_limit: int = 10_000):
        self._subs: dict[str, list[Callable[[TelemetryMessage], None]]] = defaultdict(list)
        self.history: deque[tuple[str, TelemetryMessage]] = deque(
            maxlen=int(history_limit))

    def subscribe(self, topic: str, fn: Callable[[TelemetryMessage], None]) -> None:
        self._subs[topic].append(fn)

    def unsubscribe(self, topic: str,
                    fn: Callable[[TelemetryMessage], None]) -> bool:
        """Remove one subscription; returns False if it wasn't registered
        (idempotent: detaching twice is not an error)."""
        subs = self._subs.get(topic, [])
        if fn in subs:
            subs.remove(fn)
            return True
        return False

    def subscriber_count(self, topic: str | None = None) -> int:
        if topic is not None:
            return len(self._subs.get(topic, []))
        return sum(len(v) for v in self._subs.values())

    def publish(self, topic: str, msg: TelemetryMessage) -> None:
        self.history.append((topic, msg))
        for fn in list(self._subs.get(topic, [])):
            fn(msg)

    def messages(self, topic: str = "telemetry") -> list[TelemetryMessage]:
        return [m for t, m in self.history if t == topic]


def new_session_id() -> str:
    return str(uuid.uuid4())
