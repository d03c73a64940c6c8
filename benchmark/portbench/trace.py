"""A traced window: rounds under ``torch.profiler``, read from its trace.

The profiler writes a Chrome trace into a temporary directory (under the
run's ``TMPDIR``), which is read and deleted. What the readers get:

- every device activity (kernels, copies, fills) as an interval;
- the host's launches, by correlation id, with their thread;
- the ranges the program opens with ``record_function`` (such as
  ``attention_fwd``), with their thread;
- the host's operations, to name what the host was doing in an idle gap;
- the window itself: the ``benchmark.window`` range around the rounds.

A kernel belongs to a range when the host call that launched it lies in
that range on the same thread.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable

WINDOW_RANGE = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NAME_CHARS = 160  # breakdown names are cut to this length
# a traced window: at least this many rounds and this many seconds
MIN_ROUNDS, MIN_SECONDS = 2, 0.5


@dataclasses.dataclass
class Trace:
    window: tuple[float, float]            # (start, end) us
    device: list[tuple[str, float, float, int]]  # (name, start, dur, corr)
    launches: dict[int, tuple[float, int]]  # corr -> (ts, tid)
    ranges: list[tuple[str, float, float, int]]  # (name, start, dur, tid)
    host: list[tuple[str, float, float, int]]  # (name, start, dur, tid)
    rounds: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device's activity, clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(s + d, hi))
                       for _, s, d, _ in self.device if s < hi and s + d > lo)
        merged: list[list[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def under_range(self, name: str) -> tuple[int, float]:
        """(how many ``name`` ranges the window holds, the seconds of the
        device activity launched inside them)."""
        lo, hi = self.window
        by_tid: dict[int, list[tuple[float, float]]] = collections.defaultdict(
            list)
        count = 0
        for r_name, s, d, tid in self.ranges:
            if r_name == name and lo <= s and s + d <= hi:
                by_tid[tid].append((s, s + d))
                count += 1
        for spans in by_tid.values():
            spans.sort()
        total = 0.0
        for _, _, dur, corr in self.device:
            launch = self.launches.get(corr)
            if launch is None:
                continue
            ts, tid = launch
            spans = by_tid.get(tid)
            if not spans:
                continue
            i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
                total += dur
        return count, total * 1e-6

    def top_device_ops(self, n: int = 10) -> list[list]:
        by_name: dict[str, float] = collections.Counter()
        lo, hi = self.window
        for name, s, d, _ in self.device:
            if lo <= s < hi:
                by_name[name[:NAME_CHARS]] += d * 1e-6
        return [[k, v] for k, v in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The device's idle time in the window, summed by the host
        operation that was running at the middle of each gap (the
        innermost one), the longest first."""
        lo, hi = self.window
        busy = self.busy_intervals()
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by_name: dict[str, float] = collections.Counter()
        for s, e in gaps:
            mid = 0.5 * (s + e)
            name, best = "host: no traced operation", None
            i = bisect.bisect_right(starts, mid)
            # the innermost op covering mid starts last among those that do
            for h_name, h_s, h_d, _ in reversed(host[max(0, i - 4000):i]):
                if h_s + h_d >= mid and h_name != WINDOW_RANGE:
                    best = h_name
                    break
            if best is not None:
                name = best[:NAME_CHARS]
            by_name[name] += (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:n]]


def parse(events: list[dict], rounds: int) -> Trace:
    window = None
    device, ranges, host = [], [], []
    launches: dict[int, tuple[float, int]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        name = ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        tid = ev.get("tid")
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((name, ts, dur, args.get("correlation", -1)))
            continue
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (ts, tid)
        if cat == "user_annotation":
            if name == WINDOW_RANGE:
                window = (ts, ts + dur)
            else:
                ranges.append((name, ts, dur, tid))
        if cat in HOST_CATS:
            host.append((name, ts, dur, tid))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE} range")
    return Trace(window=window, device=device, launches=launches,
                 ranges=ranges, host=host, rounds=rounds)


def traced_rounds(round_fn: Callable[[], float], sync: Callable[[], None]
                  ) -> tuple[Trace, list[float]]:
    """Rounds of ``round_fn`` under the profiler, at least ``MIN_ROUNDS``
    and until ``MIN_SECONDS`` have passed, the device synchronised by
    ``sync`` before the window closes; returns the parsed trace and the
    rounds' losses."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    losses = []
    with profile(activities=activities) as prof:
        with record_function(WINDOW_RANGE):
            t0 = time.perf_counter()
            while (len(losses) < MIN_ROUNDS
                   or time.perf_counter() - t0 < MIN_SECONDS):
                losses.append(round_fn())
            sync()
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    return parse(events, len(losses)), losses
