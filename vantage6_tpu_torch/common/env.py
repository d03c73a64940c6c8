"""Fail-soft environment-variable parsing.

One home for the stance the observability plane takes on tuning knobs
(V6T_TRACE_SAMPLE, V6T_WATCHDOG_INTERVAL, V6T_FLIGHT_BUFFER, ...): a
typo'd value falls back to the documented default instead of killing
every process that imports the module — same contract as a malformed
traceparent being ignored, not fatal. Keeping the helpers here stops the
tracer/watchdog/flight copies drifting apart.

The port's copy of ``vantage6_tpu/common/env.py`` (framework-free).
"""
from __future__ import annotations

import os


def env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        return default
