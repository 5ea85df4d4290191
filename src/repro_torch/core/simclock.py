"""Deterministic simulated clock.

The paper's §III policy experiments "forced a fixed migration time and remote
speedups" — i.e. timing is controlled, not measured.  SimClock reproduces
that protocol: real computations run on CPU, but *reported* durations are
base_time / env.speedup and migrations advance the clock by the modeled
transfer time.  A real deployment swaps in WallClock.

Both clocks are time sources for the event loop of the reference's
``repro.core.events`` (not ported yet): the loop *advances* a SimClock to each event's
due time and *sleeps* a WallClock (whose ``advance`` is a no-op — that
no-op is the protocol signal that real time cannot be skipped).  The
shared contract — ``now()`` monotone non-decreasing, ``advance(dt)``
returning a time ``>= now()`` before the call — is pinned by the clock
conformance suite in ``tests/test_events.py``.
"""
from __future__ import annotations

import time


class SimClock:
    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        assert dt >= 0, dt
        self._t += float(dt)
        return self._t

    def advance_to(self, t: float) -> float:
        """Jump forward to ``t`` (no-op when already past it): how a session
        clock absorbs arrival offsets and think-time gaps."""
        if t > self._t:
            self._t = float(t)
        return self._t


class WallClock:
    def now(self) -> float:
        return time.monotonic()

    def advance(self, dt: float) -> float:  # real time cannot be advanced
        return self.now()

    def advance_to(self, t: float) -> float:  # (the event loop sleeps instead)
        return self.now()
