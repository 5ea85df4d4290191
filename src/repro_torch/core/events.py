"""Discrete-event simulation core: heap-ordered event loop, timers, processes.

The fleet plane (scheduler, env lifecycle, failure injection, autoscaling,
background checkpoints) all run as events on one :class:`EventLoop`.  Time
comes from a pluggable clock — :class:`repro_torch.core.simclock.SimClock` for
deterministic simulation (the loop *advances* it to each event's due time)
or :class:`repro_torch.core.simclock.WallClock` for real deployments (the loop
*sleeps* until each event is due; ``advance`` on a real clock is a no-op,
which is how the loop tells the two apart).

Ordering is total and deterministic: events fire in ``(time, priority,
seq)`` order, where ``seq`` is the scheduling sequence number — so two
events due at the same instant with the same priority fire in the order
they were scheduled, and a lower ``priority`` wins ties at one instant
(the session scheduler uses the session index as priority to reproduce
its historical lowest-session-first tie-break exactly).

Processes are plain generators: ``yield <seconds>`` suspends the process
for that long, ``yield None`` (or ``yield 0``) reschedules it at the same
instant behind already-queued same-time events.  A process that returns
(or raises StopIteration) simply ends.
"""
from __future__ import annotations

import heapq
import itertools
import time as _time
from typing import Callable, Generator, Iterator


class Event:
    """A scheduled callback; ``cancel()`` makes the loop skip it."""

    __slots__ = ("time", "priority", "seq", "fn", "args", "cancelled")

    def __init__(self, time: float, priority: int, seq: int,
                 fn: Callable, args: tuple):
        self.time = float(time)
        self.priority = int(priority)
        self.seq = int(seq)
        self.fn = fn
        self.args = args
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def __lt__(self, other: "Event") -> bool:
        return ((self.time, self.priority, self.seq)
                < (other.time, other.priority, other.seq))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = " cancelled" if self.cancelled else ""
        return f"Event(t={self.time:.3f}, prio={self.priority}{state})"


class EventLoop:
    """Heap-ordered event loop over a SimClock or WallClock time source."""

    def __init__(self, clock=None):
        if clock is None:
            from repro_torch.core.simclock import SimClock
            clock = SimClock()
        self.clock = clock
        self._heap: list[Event] = []
        self._seq = itertools.count()
        self.events_fired = 0

    # -- time ------------------------------------------------------------
    def now(self) -> float:
        return self.clock.now()

    def _wait_until(self, t: float) -> None:
        """Advance a simulated clock to ``t``; sleep a real one."""
        now = self.clock.now()
        if t <= now:
            return
        moved = self.clock.advance(t - now)
        if moved < t:                      # real clock: advance is a no-op
            remaining = t - self.clock.now()
            if remaining > 0:
                _time.sleep(remaining)

    # -- scheduling ------------------------------------------------------
    def call_at(self, t: float, fn: Callable, *args,
                priority: int = 0) -> Event:
        """Schedule ``fn(*args)`` at absolute time ``t`` (clamped to now)."""
        ev = Event(max(t, self.clock.now()), priority, next(self._seq),
                   fn, args)
        heapq.heappush(self._heap, ev)
        return ev

    def call_later(self, delay: float, fn: Callable, *args,
                   priority: int = 0) -> Event:
        assert delay >= 0, delay
        return self.call_at(self.clock.now() + delay, fn, *args,
                            priority=priority)

    def every(self, interval: float, fn: Callable, *args,
              priority: int = 0, start_after: float | None = None) -> Event:
        """Recurring timer: ``fn(*args)`` every ``interval`` seconds until
        ``fn`` returns False or the returned (first) event is cancelled.
        Cancellation is checked at each tick, so cancelling the handle stops
        the whole series."""
        assert interval > 0, interval
        handle = Event(0.0, priority, -1, fn, args)  # series handle only

        def tick():
            if handle.cancelled:
                return
            if fn(*args) is False:
                handle.cancel()
                return
            self.call_later(interval, tick, priority=priority)

        self.call_later(interval if start_after is None else start_after,
                        tick, priority=priority)
        return handle

    def process(self, gen: Generator | Iterator, *,
                priority: int = 0, delay: float = 0.0) -> Event:
        """Drive a generator as a process: each ``yield dt`` suspends it for
        ``dt`` seconds (``None``/0 = same instant, behind queued peers).
        The returned handle covers the process's whole lifetime: cancelling
        it stops the process at its next wakeup (and closes the generator),
        not just the first step — same contract as :meth:`every`."""
        handle = Event(self.clock.now() + delay, priority, -1, None, ())

        def step():
            if handle.cancelled:
                if hasattr(gen, "close"):
                    gen.close()
                return
            try:
                dt = next(gen)
            except StopIteration:
                handle.cancelled = True     # finished: mark for observers
                return
            self.call_later(float(dt or 0.0), step, priority=priority)

        self.call_later(delay, step, priority=priority)
        return handle

    # -- running ---------------------------------------------------------
    def run(self, until: float | None = None) -> float:
        """Fire events in order until the heap drains (or past ``until``);
        returns the final clock time."""
        while self._heap:
            ev = self._heap[0]
            if ev.cancelled:
                heapq.heappop(self._heap)
                continue
            if until is not None and ev.time > until:
                break
            heapq.heappop(self._heap)
            self._wait_until(ev.time)
            self.events_fired += 1
            ev.fn(*ev.args)
        if until is not None:
            self._wait_until(until)
        return self.clock.now()

    def pending(self) -> int:
        return sum(1 for ev in self._heap if not ev.cancelled)
