"""The program's round phases, read from a traced window.

The program names the parts of a round with ``runtime.tracing.phase``
(``fed.forward``, ``fed.backward``, ``fed.aggregate``, ``server.update``,
...). Under the profiler each phase is a ``record_function`` range in the
trace; inside a replayed CUDA graph it is a pair of timing events, whose
milliseconds the program keeps for each replay and hands out through
``tracing.PHASES.drain()``.

A kernel belongs to a phase when the host call that launched it lies
inside one of the phase's ranges, on any thread of the process: autograd
launches the backward's kernels from a thread of its own, not from the
thread that opened ``fed.backward`` (``Trace.under_range`` matches by
thread, so it would count none of them). The host runs a round's phases
one after another, so a launch lies inside at most one phase.

Every function returns None where there is nothing to read, such as a
program that opens no such range or keeps no replay times.
"""
from __future__ import annotations

import bisect

_NOT_READ = object()
# what ``replays`` keeps on ``ctx`` when the program missed a replay
MISSED = object()


def _merged(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def ranges(trace, name: str) -> list[tuple[float, float]]:
    """The (start, end) in us of each ``name`` range inside the window."""
    lo, hi = trace.window
    return [(s, s + d) for r_name, s, d, _ in trace.ranges
            if r_name == name and lo <= s and s + d <= hi]


def device_seconds(trace, name: str) -> float | None:
    """Seconds of device activity launched inside ``name`` ranges, from
    any thread; None when the window holds no such range or nothing was
    launched inside one."""
    spans = _merged(ranges(trace, name))
    if not spans:
        return None
    starts = [s for s, _ in spans]
    total, found = 0.0, False
    for _, _, dur, corr in trace.device:
        launch = trace.launches.get(corr)
        if launch is None:
            continue
        ts = launch[0]
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= spans[i][1]:
            total += dur
            found = True
    return total * 1e-6 if found else None


def host_seconds(trace, name: str) -> float | None:
    """Seconds the host spent inside ``name`` ranges (nested ones of the
    same name counted once); None when the window holds none, or when the
    card ran nothing in it (no dispatch to a card to read)."""
    spans = _merged(ranges(trace, name))
    if not spans or not trace.device:
        return None
    return sum(e - s for s, e in spans) * 1e-6


def replays(ctx) -> list[dict[str, float]] | None:
    """The program's replayed rounds' phase milliseconds (one dict a
    replay), drained once a traced run and kept on ``ctx``; None when
    the program keeps none, or when it missed one of the traced replays
    (read it too late, ``PHASES.missed``): then the times kept stand for
    only some of the window's rounds, and no phase is read from them."""
    got = getattr(ctx, "_phase_replays", _NOT_READ)
    if got is _NOT_READ:
        got = ctx._phase_replays = _drained()
    return None if got is MISSED else got


def _drained():
    """``PHASES.drain()`` of the program; ``MISSED`` where it missed a
    traced replay; None where it keeps none."""
    got = None
    try:
        from vantage6_tpu_torch.runtime import tracing
    except ImportError:
        tracing = None
    phases = getattr(tracing, "PHASES", None)
    drain = getattr(phases, "drain", None)
    if drain is not None:
        missed = getattr(phases, "missed", 0)
        got = drain() or None
        if missed:
            got = MISSED
    return got


def per_round_ms(ctx, name: str) -> float | None:
    """Milliseconds a round of the phase ``name``: the mean over the
    replays the program kept, where it kept the phase, else the device
    time launched inside its ranges over the traced rounds. None where
    the program missed a traced replay: a replayed round's phases are
    not ranges in the trace, so the trace cannot stand in."""
    kept = replays(ctx)
    if ctx._phase_replays is MISSED:
        return None
    kept = [r[name] for r in kept or () if name in r]
    if kept:
        return sum(kept) / len(kept)
    seconds = device_seconds(ctx.trace, name)
    if seconds is None or ctx.trace.rounds <= 0:
        return None
    return 1e3 * seconds / ctx.trace.rounds
