"""The port's event loop against the JAX reference's, on the CPU.

Each case of ``tests/test_events.py`` (clock conformance, timer order,
zero-delay FIFO, priorities, cancellation, events scheduled while running,
``run(until=)``, ``every``, generator processes, determinism) runs as one
schedule through both packages; the recorded firing orders and times must
be equal, and equal to what the reference's own tests expect.  Wall-clock
cases compare orders only (their times are real).
"""
import pytest

import repro.core as ref_core
import repro_torch.core as port_core

PACKAGES = {"reference": ref_core, "port": port_core}
WALL_SCALE = 0.005      # real sleeps stay tiny


def _clock(pkg, kind):
    return pkg.SimClock() if kind == "sim" else pkg.WallClock()


def monotone(pkg, kind):
    scale = 1.0 if kind == "sim" else WALL_SCALE
    loop = pkg.EventLoop(_clock(pkg, kind))
    seen = []
    for d in (3, 1, 2, 0):
        loop.call_later(d * scale, lambda d=d: seen.append((d, loop.now())))
    loop.run()
    assert [t for _, t in seen] == sorted(t for _, t in seen)
    return seen if kind == "sim" else [d for d, _ in seen]


def timer_order(pkg, kind):
    scale = 1.0 if kind == "sim" else WALL_SCALE
    loop = pkg.EventLoop(_clock(pkg, kind))
    fired = []
    for tag, d in (("c", 3), ("a", 1), ("b", 2)):
        loop.call_later(d * scale, lambda tag=tag: fired.append(tag))
    loop.run()
    return fired


def zero_delay_fifo(pkg, kind):
    loop = pkg.EventLoop(_clock(pkg, kind))
    fired = []
    for i in range(5):
        loop.call_later(0.0, lambda i=i: fired.append(i))
    t0 = loop.now()
    loop.run()
    return fired, (loop.now() - t0 if kind == "sim" else None)


def advance(pkg, kind):
    clock = _clock(pkg, kind)
    before = clock.now()
    after = clock.advance(0.01 if kind == "wall" else 5.0)
    if kind == "sim":
        return after - before
    return after >= before, after < before + 0.01


def priorities(pkg):
    loop = pkg.EventLoop()
    fired = []
    for tag, p in (("low", 5), ("high", -5), ("mid", 0)):
        loop.call_at(1.0, lambda tag=tag: fired.append(tag), priority=p)
    loop.run()
    return fired


def cancellation(pkg):
    loop = pkg.EventLoop()
    fired = []
    ev = loop.call_later(1.0, lambda: fired.append("cancelled"))
    loop.call_later(2.0, lambda: fired.append(("kept", loop.now())))
    ev.cancel()
    loop.run()
    return fired, loop.pending()


def nested(pkg):
    loop = pkg.EventLoop()
    fired = []

    def first():
        fired.append(("first", loop.now()))
        loop.call_later(1.0, lambda: fired.append(("nested", loop.now())))

    loop.call_later(1.0, first)
    return fired, loop.run()


def run_until(pkg):
    loop = pkg.EventLoop()
    fired = []
    loop.call_at(1.0, lambda: fired.append(1))
    loop.call_at(10.0, lambda: fired.append(10))
    t = loop.run(until=5.0)
    mid = list(fired)
    return mid, t, loop.run(), fired


def every(pkg):
    loop = pkg.EventLoop()
    ticks = []
    loop.every(1.0, lambda: ticks.append(loop.now()) or
               (None if len(ticks) < 3 else False))
    loop.run()
    loop2 = pkg.EventLoop()
    ticks2 = []
    handle = loop2.every(1.0, lambda: ticks2.append(loop2.now()))
    loop2.call_at(2.5, handle.cancel)
    loop2.run()
    return ticks, ticks2


def processes(pkg):
    loop = pkg.EventLoop()
    trace = []

    def proc(tag, pause):
        trace.append((tag, loop.now()))
        yield pause
        trace.append((tag, loop.now()))
        yield pause
        trace.append((tag, loop.now()))

    loop.process(proc("a", 2.0))
    loop.process(proc("b", 3.0), delay=1.0)
    loop.run()
    return trace


def mixed_schedule(pkg):
    """Priorities, equal times and a process interleaved in one loop."""
    loop = pkg.EventLoop()
    fired = []
    for i, (t, p) in enumerate([(2.0, 0), (1.0, 3), (1.0, -1), (2.0, 0),
                                (0.5, 9)]):
        loop.call_at(t, lambda i=i: fired.append((i, loop.now())),
                     priority=p)

    def proc():
        for pause in (0.5, 0.5, 1.0):
            fired.append(("p", loop.now()))
            yield pause

    loop.process(proc(), delay=0.25)
    loop.run()
    return fired


# what the reference's own tests expect of each deterministic schedule
EXPECTED = {
    "priorities": ["high", "mid", "low"],
    "cancellation": ([("kept", 2.0)], 0),
    "nested": ([("first", 1.0), ("nested", 2.0)], 2.0),
    "run_until": ([1], 5.0, 10.0, [1, 10]),
    "every": ([1.0, 2.0, 3.0], [1.0, 2.0]),
    "processes": [("a", 0.0), ("b", 1.0), ("a", 2.0), ("b", 4.0),
                  ("a", 4.0), ("b", 7.0)],
}
CLOCKED = {"monotone": monotone, "timer_order": timer_order,
           "zero_delay_fifo": zero_delay_fifo, "advance": advance}
SIM_ONLY = {"priorities": priorities, "cancellation": cancellation,
            "nested": nested, "run_until": run_until, "every": every,
            "processes": processes, "mixed_schedule": mixed_schedule}


@pytest.mark.parametrize("kind", ["sim", "wall"])
@pytest.mark.parametrize("case", sorted(CLOCKED))
def test_clock_conformance_matches_the_reference(case, kind):
    got = CLOCKED[case](port_core, kind)
    assert got == CLOCKED[case](ref_core, kind)
    if case == "timer_order":
        assert got == ["a", "b", "c"]
    if case == "zero_delay_fifo":
        assert got == ([0, 1, 2, 3, 4], 0.0 if kind == "sim" else None)
    if case == "advance":
        assert got == (5.0 if kind == "sim" else (True, True))


@pytest.mark.parametrize("case", sorted(SIM_ONLY))
def test_event_orders_and_times_match_the_reference(case):
    got = SIM_ONLY[case](port_core)
    assert got == SIM_ONLY[case](ref_core)
    assert got == SIM_ONLY[case](port_core)           # deterministic
    if case in EXPECTED:
        assert got == EXPECTED[case]


def test_the_port_loop_defaults_to_its_own_sim_clock():
    loop = port_core.EventLoop()
    assert type(loop.clock) is port_core.SimClock
    assert type(loop.clock).__module__ == "repro_torch.core.simclock"
