"""Live health watchdog: declarative alert rules over telemetry + run state.

Tracing and the unified telemetry registry are the *attribution*
substrate; this module is the *detection* layer on top of it — the ops
plane that tells an operator something is wrong while it is still wrong,
instead of leaving a stuck round to be discovered in `trace_view` after
the fact.

Design:

- **Rules** (:class:`AlertRule`) are declarative: a snake_case name, a
  severity, a human summary + runbook line, the telemetry series they
  read (audited against ``KNOWN_METRICS`` by ``tools/check_collect.py``
  — a rule referencing an undeclared metric fails CI), and a pure
  ``check(ctx)`` returning findings.
- **Context** (:class:`RuleContext`) is everything a rule may look at:
  the current unified-telemetry snapshot, a bounded per-metric history
  (for trend rules: queue buildup, EF mass growth, eviction deltas), and
  the run/node/round **feeds** registered by live components — the
  server registers its DB view (ACTIVE runs, node ping freshness), an
  in-process Federation registers its executor/round view. Feeds are
  keyed (replacement semantics, like telemetry collectors) and fail-soft.
- **Alerts** are stateful raise/clear transitions, deduplicated on
  ``(rule, labels)``. A raise emits: a WARNING log line (trace-correlated
  when the subject has a trace), telemetry counters/gauges
  (``v6t_alerts_*``), a flight-recorder note, and a trace span — parented
  on the affected task's own trace when the feed supplies its
  ``traceparent``, so the alert lands **inside the stuck round's
  timeline** for `tools/doctor.py` to merge.
- **Health** — components (event hub, tracer sink, the watchdog's own
  evaluation loop) register self-checks; :meth:`Watchdog.health` folds
  them with active critical alerts into the ``ok``/``degraded`` verdict
  behind the server's upgraded ``GET /api/health``.

The process-wide singleton is :data:`WATCHDOG` (same stance as
``TRACER``/``REGISTRY``): the server starts its evaluation thread and
serves its state at ``GET /api/alerts``; simulators and tests register
feeds and call :meth:`Watchdog.evaluate` directly for determinism.

Env knobs (read at construction; ``configure()`` overrides live):
``V6T_WATCHDOG_INTERVAL`` (seconds between evaluations, default 5),
``V6T_RUN_DEADLINE_S`` (stuck-run threshold, default 300),
``V6T_PING_WINDOW_S`` (daemon lapse threshold, default 60).

The port's copy of ``vantage6_tpu/runtime/watchdog.py``: the same rules
(``DEFAULT_RULES``/``RULE_CATALOG``, 15), messages, config, series, span
names and flight notes, so the same feed dicts give the same findings in
both packages. The port registers the ``learning`` (runtime/learning.py),
``device_plane`` (runtime/profiling.py) and per-``Federation`` feeds; the
server's DB feed and the daemon's feed come with the server and the node.
"""
from __future__ import annotations

import dataclasses
import os
import re
import threading
import time
from collections import deque
from typing import Any, Callable

from vantage6_tpu_torch.common.env import env_float
from vantage6_tpu_torch.common.log import setup_logging
from vantage6_tpu_torch.common.telemetry import REGISTRY, metric_kind as _metric_kind
from vantage6_tpu_torch.runtime.tracing import TRACER

log = setup_logging("vantage6_tpu_torch/watchdog")

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

SEVERITIES = ("info", "warning", "critical")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative detection: name, severity, what it means, what to
    do, which telemetry series it reads, and the check itself.

    ``metrics`` is the audited contract: every name listed here must be
    declared in ``common.telemetry.KNOWN_METRICS`` (check_collect gate) —
    a rule silently reading a renamed/undeclared series is exactly the
    drift the audit exists to catch. Feed-only rules declare ``()``.
    """

    name: str
    severity: str
    summary: str
    runbook: str
    metrics: tuple[str, ...]
    check: Callable[["RuleContext"], list[dict[str, Any]]]

    def validate(self) -> None:
        if not _NAME_RE.match(self.name):
            raise ValueError(
                f"alert rule name {self.name!r} must be snake_case"
            )
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"alert rule {self.name}: severity {self.severity!r} not in "
                f"{SEVERITIES}"
            )
        if not self.summary or not self.runbook:
            raise ValueError(
                f"alert rule {self.name}: summary and runbook are required"
            )


class RuleContext:
    """What one evaluation pass shows a rule: current metric values, short
    per-metric history, and every registered feed's state."""

    def __init__(
        self,
        snapshot: dict[str, Any],
        history: dict[str, deque],
        feeds: dict[str, Any],
        config: dict[str, Any],
        now: float,
    ):
        self.snapshot = snapshot
        self._history = history
        self.feeds = feeds
        self.config = config
        self.now = now

    def metric(self, name: str, default: float | None = None) -> float | None:
        v = self.snapshot.get(name, default)
        return v if isinstance(v, (int, float)) else default

    def history(self, name: str) -> list[tuple[float, float]]:
        """Oldest-first (ts, value) samples, one per evaluation."""
        return list(self._history.get(name, ()))

    def feed_items(self, key: str) -> list[dict[str, Any]]:
        """Concatenate list-valued entries named ``key`` across every
        feed — rules stay topology-agnostic (a server feed and a
        simulator Federation feed both publish "runs")."""
        out: list[dict[str, Any]] = []
        for state in self.feeds.values():
            if isinstance(state, dict):
                items = state.get(key)
                if isinstance(items, (list, tuple)):
                    out.extend(i for i in items if isinstance(i, dict))
        return out


# ------------------------------------------------------------ default rules


def _check_stuck_run(ctx: RuleContext) -> list[dict[str, Any]]:
    deadline = float(ctx.config["run_deadline_s"])
    findings = []
    for run in ctx.feed_items("runs"):
        if run.get("status") != "active":
            continue
        base = run.get("started_at") or run.get("assigned_at")
        if base is None:
            continue
        # a run whose status events are still flowing is slow, not stuck —
        # feeds that track event freshness override the start timestamp
        last_event = run.get("last_event_ts")
        if last_event is not None:
            base = max(base, last_event)
        age = ctx.now - float(base)
        if age > deadline:
            findings.append({
                "message": (
                    f"run {run.get('run_id')} of task {run.get('task_id')} "
                    f"ACTIVE for {age:.1f}s with no status events "
                    f"(deadline {deadline:g}s)"
                ),
                "labels": {
                    "run_id": run.get("run_id"),
                    "task_id": run.get("task_id"),
                },
                "traceparent": run.get("traceparent"),
            })
    return findings


def _check_daemon_lapsed(ctx: RuleContext) -> list[dict[str, Any]]:
    window = float(ctx.config["ping_window_s"])
    findings = []
    for node in ctx.feed_items("nodes"):
        if node.get("status") != "online":
            continue
        last = node.get("last_seen_at")
        if last is None:
            continue
        age = ctx.now - float(last)
        if age > window:
            findings.append({
                "message": (
                    f"node {node.get('node_id')} "
                    f"({node.get('name') or 'unnamed'}) claims online but "
                    f"last ping was {age:.1f}s ago (window {window:g}s)"
                ),
                "labels": {"node_id": node.get("node_id")},
            })
    return findings


def _check_replica_lapsed(ctx: RuleContext) -> list[dict[str, Any]]:
    findings = []
    for rep in ctx.feed_items("replicas"):
        if rep.get("alive"):
            continue
        last = rep.get("last_seen_at")
        age = (ctx.now - float(last)) if last is not None else None
        findings.append({
            "message": (
                f"server replica {rep.get('replica_id')} "
                f"(pid {rep.get('pid')}) stopped heartbeating"
                + (f" {age:.1f}s ago" if age is not None else "")
                + " — crashed or partitioned from the shared store"
            ),
            "labels": {"replica_id": rep.get("replica_id")},
        })
    return findings


def station_window_flags(
    rounds: list[dict[str, Any]],
    window: int,
    flag_fn: Callable[[dict[str, Any]], Any],
) -> tuple[dict[Any, int], dict[Any, tuple[float, str]], int]:
    """The ONE per-station rolling-window census the station-shaped rules
    (``straggler_station``, ``anomalous_station``) share: scan the last
    ``window`` round dicts, let ``flag_fn(round)`` yield zero or more
    ``(key, score, detail)`` flags (a round may flag several stations),
    and return ``(flag counts per key, worst (score, detail) per key,
    rounds considered)``. "Worst" keeps the highest-score flag's
    preformatted detail so each rule's message can name the offending
    stat without re-deriving it."""
    recent = rounds[-window:]
    counts: dict[Any, int] = {}
    worst: dict[Any, tuple[float, str]] = {}
    for r in recent:
        for key, score, detail in flag_fn(r) or ():
            counts[key] = counts.get(key, 0) + 1
            if key not in worst or score > worst[key][0]:
                worst[key] = (float(score), str(detail))
    return counts, worst, len(recent)


def _check_straggler_station(ctx: RuleContext) -> list[dict[str, Any]]:
    need = int(ctx.config["straggler_rounds"])
    ratio = float(ctx.config["straggler_ratio"])
    window = int(ctx.config["straggler_window"])

    def flag(r: dict[str, Any]):
        station = r.get("straggler_station")
        mx = r.get("max_exec_s")
        mean = r.get("mean_exec_s")
        if station is None or not mx or not mean or r.get("n", 0) < 2:
            return ()
        if mx / mean >= ratio:
            return ((station, mx / mean, f"{mx / mean:.1f}x the round mean"),)
        return ()

    counts, worst, n_rounds = station_window_flags(
        ctx.feed_items("rounds"), window, flag
    )
    return [
        {
            "message": (
                f"station {station} was the straggler in {n} of the last "
                f"{n_rounds} rounds (worst {worst[station][1]})"
            ),
            "labels": {"station": station},
        }
        for station, n in counts.items()
        if n >= need
    ]


def _check_anomalous_station(ctx: RuleContext) -> list[dict[str, Any]]:
    cos_thr = float(ctx.config["anomaly_cos_threshold"])
    factor = float(ctx.config["anomaly_norm_factor"])
    need = int(ctx.config["anomaly_rounds"])
    window = int(ctx.config["anomaly_window"])

    def flag(r: dict[str, Any]):
        # keys are per-(task, station) already; the WINDOW below is
        # applied per task too (see the grouping loop) — slicing the
        # merged cross-task feed would let concurrent tasks dilute each
        # other's evidence and a poisoned station would never reach the
        # repeat threshold on a busy server
        median = r.get("median_norm") or 0.0
        pooled = r.get("update_norm") or 0.0
        flags = []
        for st in r.get("stations") or ():
            station = st.get("station")
            if station is None:
                continue
            # a masked-out station's stats are fictional (SPMD computes
            # them, the pooled update excludes them) AND the documented
            # remediation for this very alert is "mask the station" —
            # flagging non-participants would make the alert impossible
            # to clear by its own runbook
            if st.get("participating") is False:
                continue
            key = (r.get("task"), station)
            cos = st.get("cos")
            norm = st.get("norm")
            # cosine is only evidence when there is an update on BOTH
            # sides: a zero-norm station (sent nothing this round) and a
            # zero pooled update both degenerate to cos == 0, which is
            # absence of signal, not a contrarian update
            if (
                isinstance(cos, (int, float))
                and cos < cos_thr
                and isinstance(norm, (int, float)) and norm > 0
                and pooled > 0
            ):
                # score by how far below the threshold: the most
                # contrarian round's cosine names the stat
                flags.append((
                    key, cos_thr - cos,
                    f"cosine to the pooled update {cos:.3f} "
                    f"(threshold {cos_thr:g})",
                ))
            elif (
                isinstance(norm, (int, float))
                and median > 0
                and norm >= factor * median
            ):
                flags.append((
                    key, norm / median,
                    f"update norm {norm / median:.1f}x the station median "
                    f"(threshold {factor:g}x)",
                ))
        return flags

    by_task: dict[Any, list[dict[str, Any]]] = {}
    for r in ctx.feed_items("learning_rounds"):
        by_task.setdefault(r.get("task"), []).append(r)
    findings = []
    for rounds in by_task.values():
        counts, worst, n_rounds = station_window_flags(rounds, window, flag)
        for key, n in counts.items():
            if n < need:
                continue
            task, station = key
            findings.append({
                "message": (
                    f"station {station} (task {task}) sent anomalous "
                    f"updates in {n} of the last {n_rounds} recorded "
                    f"rounds — worst: {worst[key][1]}"
                ),
                "labels": {"task": task, "station": station},
            })
    return findings


def _check_model_divergence(ctx: RuleContext) -> list[dict[str, Any]]:
    need = int(ctx.config["divergence_rounds"])
    min_growth = float(ctx.config["divergence_min_growth_pct"])
    findings = []
    for item in ctx.feed_items("learning_tasks"):
        norms = [
            v for v in (item.get("recent_norms") or ())
            if isinstance(v, (int, float))
        ][-(need + 1):]
        if len(norms) < need + 1 or norms[0] <= 0:
            continue
        # strictly increasing over the window AND real growth overall —
        # round-to-round wobble is normal, a monotone climb is not
        if not all(b > a for a, b in zip(norms, norms[1:])):
            continue
        growth_pct = 100.0 * (norms[-1] - norms[0]) / norms[0]
        if growth_pct < min_growth:
            continue
        findings.append({
            "message": (
                f"task {item.get('task')}: global update norm grew "
                f"monotonically over the last {need} recorded rounds "
                f"({norms[0]:.3g} -> {norms[-1]:.3g}, "
                f"+{growth_pct:.1f}%) — the model is diverging"
            ),
            "labels": {"task": item.get("task")},
        })
    return findings


def _check_non_convergence(ctx: RuleContext) -> list[dict[str, Any]]:
    budget = int(ctx.config["non_convergence_rounds"])
    window = int(ctx.config["non_convergence_window"])
    min_decay = float(ctx.config["non_convergence_decay_pct"])
    converged = float(ctx.config["non_convergence_converged_ratio"])
    findings = []
    for item in ctx.feed_items("learning_tasks"):
        rounds = item.get("rounds") or 0
        if rounds < budget:
            continue
        norms = [
            v for v in (item.get("recent_norms") or ())
            if isinstance(v, (int, float))
        ][-window:]
        if len(norms) < 2 or norms[0] <= 0:
            continue
        peak = item.get("peak_norm") or 0.0
        # a CONVERGED run plateaus near zero relative to its peak —
        # plateau-at-the-bottom is success, not a stall
        if peak > 0 and norms[-1] <= converged * peak:
            continue
        decay_pct = 100.0 * (norms[0] - norms[-1]) / norms[0]
        if decay_pct >= min_decay:
            continue
        # a NEGATIVE decay is the norm growing non-monotonically —
        # model_divergence's strictly-monotone check stays quiet, but
        # telling the operator "decay stalled, fell only -80%" would
        # misdiagnose a blow-up as a stall and point at the wrong runbook
        if decay_pct < 0:
            trend = (
                f"the global update norm ROSE {-decay_pct:.1f}% (non-"
                "monotonically — check model_divergence and the lr)"
            )
        else:
            trend = (
                "norm decay stalled — the global update norm fell only "
                f"{decay_pct:.1f}%"
            )
        findings.append({
            "message": (
                f"task {item.get('task')}: {trend} over the "
                f"last {len(norms)} recorded rounds "
                f"({norms[0]:.3g} -> {norms[-1]:.3g}) after {rounds} "
                f"rounds (budget {budget})"
            ),
            "labels": {"task": item.get("task")},
        })
    return findings


def _check_queue_buildup(ctx: RuleContext) -> list[dict[str, Any]]:
    factor = float(ctx.config["queue_factor"])
    sustain = int(ctx.config["queue_sustain_evals"])
    hist = ctx.history("v6t_executor_inflight_items")[-sustain:]
    if len(hist) < sustain:
        return []
    # "sustained" means sustained in WALL CLOCK, not in sample count:
    # ad-hoc evaluate() calls (close()'s reconcile pass, tests) can land
    # samples milliseconds apart and would promote a momentary spike to a
    # sustained backlog. Half the nominal spacing tolerates loop jitter.
    min_span = 0.5 * (sustain - 1) * float(
        ctx.config.get("eval_interval_s", 0.0)
    )
    if hist[-1][0] - hist[0][0] < min_span:
        return []
    capacity = max(1.0, ctx.metric("v6t_executor_capacity", 0.0) or 0.0)
    threshold = factor * capacity
    if all(v > threshold for _, v in hist):
        inflight = hist[-1][1]
        return [{
            "message": (
                f"executor backlog: {inflight:g} items in flight vs "
                f"{capacity:g} worker slots ({factor:g}x threshold) for "
                f"{sustain} consecutive evaluations"
            ),
            "labels": {},
        }]
    return []


def _check_event_cursor_lag(ctx: RuleContext) -> list[dict[str, Any]]:
    # key on ACTUAL truncated fetches (a consumer asked for history the
    # ring already evicted), not on eviction itself — a busy server's full
    # ring evicts on every emit as steady state, which proves nothing
    # strictly consecutive samples: the engine zero-fills this counter's
    # history while it is still absent from the snapshot, so the first
    # truncation of a process lifetime shows as a 0 -> 1 step — and a
    # count predating THIS watchdog's start never reads as a fresh jump
    hist = ctx.history("v6t_event_truncated_total")
    if len(hist) < 2:
        return []
    prev, cur = hist[-2][1], hist[-1][1]
    if cur > prev:
        evicted = ctx.metric("v6t_event_hub_evicted_through", 0.0)
        cursor = ctx.metric("v6t_event_hub_cursor", 0.0)
        return [{
            "message": (
                f"{cur - prev:g} event fetch(es) answered truncated since "
                f"the last evaluation (evicted_through {evicted:g}, cursor "
                f"{cursor:g}): lagging consumers are missing events and "
                "paying full resyncs"
            ),
            "labels": {},
        }]
    return []


def _check_ef_mass_growth(ctx: RuleContext) -> list[dict[str, Any]]:
    need = int(ctx.config["ef_growth_evals"])
    hist = ctx.history("v6t_compress_ef_norm")[-(need + 1):]
    if len(hist) < need + 1:
        return []
    values = [v for _, v in hist]
    if values[-1] > 0 and all(b > a for a, b in zip(values, values[1:])):
        return [{
            "message": (
                "compression error-feedback mass grew for "
                f"{need} consecutive evaluations "
                f"(ef_norm {values[0]:.3g} -> {values[-1]:.3g}): residual "
                "error is accumulating instead of shipping"
            ),
            "labels": {},
        }]
    return []


def _check_recompile_storm(ctx: RuleContext) -> list[dict[str, Any]]:
    # a retrace or two is normal warm-up (new batch shape, first donated
    # round); a STORM is the counter stepping every evaluation — the
    # signature key is unstable and every dispatch recompiles
    need = int(ctx.config["recompile_storm_retraces"])
    window = int(ctx.config["recompile_storm_window"])
    hist = ctx.history("v6t_jit_retraces_total")[-(window + 1):]
    if len(hist) < 2:
        return []
    delta = hist[-1][1] - hist[0][1]
    if delta < need:
        return []
    # name the culprit: the device-plane feed carries recent retrace
    # events with the function and the leaf that changed. Scope to THIS
    # window (the first in-window snapshot's timestamp) — the feed deque
    # is all-time, and a warm-up burst hours ago must not out-vote the
    # function actually storming now.
    window_start = hist[0][0]
    retraces = [
        r for r in ctx.feed_items("retraces")
        if not isinstance(r.get("ts"), (int, float))
        or r["ts"] >= window_start
    ]
    by_fn: dict[str, int] = {}
    last_changed: dict[str, str] = {}
    for r in retraces:
        fn = str(r.get("function") or "?")
        by_fn[fn] = by_fn.get(fn, 0) + 1
        if r.get("changed"):
            last_changed[fn] = str(r["changed"])
    if by_fn:
        worst = max(by_fn, key=by_fn.get)
        culprit = (
            f"; worst offender {worst} ({by_fn[worst]} recent retraces"
            + (f", last change {last_changed[worst]}" if worst in
               last_changed else "")
            + ")"
        )
        labels = {"function": worst}
    else:
        culprit = ""
        labels = {}
    return [{
        "message": (
            f"{delta:g} retrace(s) across the last {len(hist) - 1} "
            f"evaluation(s) (threshold {need}): same function, new "
            f"abstract signature — every one pays a full XLA "
            f"compile{culprit}"
        ),
        "labels": labels,
    }]


def _check_device_mem_growth(ctx: RuleContext) -> list[dict[str, Any]]:
    need = int(ctx.config["device_mem_growth_evals"])
    min_pct = float(ctx.config["device_mem_growth_pct"])
    hist = ctx.history("v6t_device_mem_bytes_in_use")[-(need + 1):]
    if len(hist) < need + 1:
        return []
    values = [v for _, v in hist]
    if values[0] <= 0:
        return []
    if not all(b > a for a, b in zip(values, values[1:])):
        return []
    growth_pct = 100.0 * (values[-1] - values[0]) / values[0]
    if growth_pct < min_pct:
        return []
    return [{
        "message": (
            f"device memory in use grew {growth_pct:.1f}% over "
            f"{need} consecutive evaluations "
            f"({values[0]:.3g} -> {values[-1]:.3g} bytes): buffers are "
            "accumulating instead of being freed (leaked executable "
            "cache entry, un-donated carry, or host references pinning "
            "device arrays)"
        ),
        "labels": {},
    }]


# --------------------------------------------------------------- SLO engine
# Declarative service-level objectives over the STORE-BACKED fleet
# history (server/fleet.py): the server's watchdog feed publishes each
# objective's sample stream ("slo_dispatch", "slo_rounds") and the
# per-source freshness census ("fleet_sources") read straight off the
# shared fleet_metric table, so burn rates aggregate every daemon and
# every replica — not one process's memory — and survive restarts.
# Multi-window burn-rate alerting (SRE-workbook shape): an SLO alerts
# only when the error budget is burning past threshold in BOTH the fast
# window (catches an acute burn within one evaluation) and the slow
# window (keeps sporadic noise quiet: a blip inflates the fast burn but
# never the slow one). A process with no fleet feed (a daemon-side
# watchdog) proposes nothing — the SLO rules are server-evaluated by
# construction.


@dataclasses.dataclass(frozen=True)
class SloRule:
    """One declarative objective: a human-readable goal, the fleet-feed
    sample stream it reads, and the evaluation mode. Targets, windows
    and burn thresholds live in ``Watchdog.config`` (``slo_*`` keys) so
    operators — and tests — tune them live via ``configure()``.

    Modes:

    - ``threshold`` — event samples vs a latency/size target; the bad
      fraction over each window, divided by ``slo_error_budget``, is
      the burn rate.
    - ``throughput`` — cumulative counter samples; the fast-window rate
      must hold ``slo_throughput_floor_pct`` of the trailing
      slow-window baseline rate.
    - ``liveness`` — the per-source freshness census; the stale
      fraction of daemon sources, divided by the liveness budget
      (1 - ``slo_liveness_ratio``), is the burn rate.
    """

    name: str
    objective: str
    feed_key: str
    mode: str
    severity: str = "warning"
    metrics: tuple[str, ...] = ()
    runbook: str = ""

    def to_alert_rule(self) -> AlertRule:
        check = {
            "threshold": _slo_threshold_check,
            "throughput": _slo_throughput_check,
            "liveness": _slo_liveness_check,
        }[self.mode](self)
        return AlertRule(
            name=self.name,
            severity=self.severity,
            summary=(
                f"SLO burn: {self.objective} — the error budget is "
                "burning past threshold in both the fast and the slow "
                "window (store-backed fleet history, not one process's "
                "view)."
            ),
            runbook=self.runbook or (
                "GET /api/fleet for per-source freshness and the counter "
                "deltas; doctor --live names the burning SLO and the "
                "lagging source — docs/observability.md 'SLO burn-rate "
                "alerting'."
            ),
            metrics=self.metrics,
            check=check,
        )


def _slo_samples(
    ctx: RuleContext, key: str
) -> list[tuple[float, float, str]]:
    """(ts, value, source) samples from the fleet feed, deduplicated —
    two in-process replicas both feed the same shared store, and a
    double-counted sample would double the burn rate."""
    seen: set[tuple[Any, float, float]] = set()
    out: list[tuple[float, float, str]] = []
    for s in ctx.feed_items(key):
        ts, v = s.get("ts"), s.get("value")
        if not isinstance(ts, (int, float)) or not isinstance(v, (int, float)):
            continue
        k = (s.get("source"), round(float(ts), 6), float(v))
        if k in seen:
            continue
        seen.add(k)
        out.append((float(ts), float(v), str(s.get("source") or "?")))
    out.sort(key=lambda t: t[0])
    return out


def _slo_windows(ctx: RuleContext) -> tuple[float, float]:
    return (
        float(ctx.config["slo_fast_window_s"]),
        float(ctx.config["slo_slow_window_s"]),
    )


def _slo_threshold_check(slo: SloRule):
    def check(ctx: RuleContext) -> list[dict[str, Any]]:
        REGISTRY.counter("v6t_slo_evaluations_total").inc()
        samples = _slo_samples(ctx, slo.feed_key)
        if not samples:
            return []
        target = float(ctx.config["slo_dispatch_target_s"])
        budget = max(1e-9, float(ctx.config["slo_error_budget"]))
        thr = float(ctx.config["slo_burn_threshold"])
        min_n = int(ctx.config["slo_min_samples"])
        fast, slow = _slo_windows(ctx)

        def burn(window: float) -> tuple[float | None, int]:
            w = [v for ts, v, _ in samples if ctx.now - ts <= window]
            if len(w) < min_n:
                return None, len(w)
            return (sum(1 for v in w if v > target) / len(w)) / budget, len(w)

        burn_fast, n_fast = burn(fast)
        burn_slow, _ = burn(slow)
        if (
            burn_fast is None or burn_slow is None
            or burn_fast < thr or burn_slow < thr
        ):
            return []
        # name the worst offender: most over-target samples in the fast
        # window — "the lagging source" doctor --live calls out
        by_src: dict[str, int] = {}
        for ts, v, src in samples:
            if ctx.now - ts <= fast and v > target:
                by_src[src] = by_src.get(src, 0) + 1
        worst = max(by_src, key=by_src.get) if by_src else None
        return [{
            "message": (
                f"SLO '{slo.objective}' (target {target:g}s): error "
                f"budget burning at {burn_fast:.1f}x over the fast "
                f"{fast:g}s window ({n_fast} samples) and "
                f"{burn_slow:.1f}x over the slow {slow:g}s window "
                f"(threshold {thr:g}x)"
                + (f"; worst source {worst} "
                   f"({by_src[worst]} over-target)" if worst else "")
            ),
            "labels": {"slo": slo.name},
        }]

    return check


def _slo_throughput_check(slo: SloRule):
    def check(ctx: RuleContext) -> list[dict[str, Any]]:
        REGISTRY.counter("v6t_slo_evaluations_total").inc()
        samples = _slo_samples(ctx, slo.feed_key)
        if not samples:
            return []
        floor_pct = float(ctx.config["slo_throughput_floor_pct"])
        min_n = int(ctx.config["slo_min_samples"])
        fast, slow = _slo_windows(ctx)

        def rate(window: float) -> tuple[float, int]:
            # counters are per-source cumulative: delta per source, then
            # sum — one source restarting must not read as negative fleet
            # throughput
            first: dict[str, float] = {}
            last: dict[str, float] = {}
            n = 0
            for ts, v, src in samples:
                if ctx.now - ts > window:
                    continue
                n += 1
                first.setdefault(src, v)
                last[src] = v
            total = sum(
                max(0.0, last[s] - first[s]) for s in last
            )
            return total / max(window, 1e-9), n

        slow_rate, n_slow = rate(slow)
        fast_rate, n_fast = rate(fast)
        if n_slow < min_n or n_fast < 2 or slow_rate <= 0:
            return []  # no established baseline -> nothing to burn
        floor_rate = (floor_pct / 100.0) * slow_rate
        if fast_rate >= floor_rate:
            return []
        return [{
            "message": (
                f"SLO '{slo.objective}': round throughput "
                f"{fast_rate:.4g}/s over the fast {fast:g}s window is "
                f"below {floor_pct:g}% of the trailing {slow:g}s-window "
                f"baseline ({slow_rate:.4g}/s)"
            ),
            "labels": {"slo": slo.name},
        }]

    return check


def _slo_liveness_check(slo: SloRule):
    def check(ctx: RuleContext) -> list[dict[str, Any]]:
        REGISTRY.counter("v6t_slo_evaluations_total").inc()
        daemons: dict[str, dict[str, Any]] = {}
        for s in ctx.feed_items(slo.feed_key):
            name = s.get("source")
            if name and str(s.get("service") or "").startswith("daemon"):
                daemons[str(name)] = s
        if not daemons:
            return []
        budget = max(1e-9, 1.0 - float(ctx.config["slo_liveness_ratio"]))
        thr = float(ctx.config["slo_burn_threshold"])
        grace = float(ctx.config["slo_liveness_slow_grace_s"])
        fast, slow = _slo_windows(ctx)
        ages = {
            src: float(s.get("age_s") or 0.0) for src, s in daemons.items()
        }
        # fast window: the freshness census's own stale verdict; slow
        # window: stale PAST the grace — a daemon mid-restart inflates
        # the fast burn only, and the AND keeps the alert quiet
        stale_fast = [s for s, d in daemons.items() if d.get("stale")]
        stale_slow = [s for s in stale_fast if ages[s] > grace]
        burn_fast = (len(stale_fast) / len(daemons)) / budget
        burn_slow = (len(stale_slow) / len(daemons)) / budget
        if burn_fast < thr or burn_slow < thr:
            return []
        worst = max(ages, key=ages.get)
        return [{
            "message": (
                f"SLO '{slo.objective}': {len(stale_fast)} of "
                f"{len(daemons)} daemon sources are stale (burn "
                f"{burn_fast:.1f}x fast {fast:g}s window / "
                f"{burn_slow:.1f}x slow {slow:g}s window, threshold "
                f"{thr:g}x); most lagging: {worst} "
                f"({ages[worst]:.1f}s since last push)"
            ),
            "labels": {"slo": slo.name},
        }]

    return check


def default_slos() -> list[SloRule]:
    return [
        SloRule(
            name="slo_dispatch_latency",
            objective=(
                "99% of run dispatches start within the target latency"
            ),
            feed_key="slo_dispatch",
            mode="threshold",
            severity="critical",
            metrics=("v6t_run_dispatch_seconds",),
            runbook=(
                "GET /api/fleet: check per-source freshness (a lagging "
                "daemon claims late) and v6t_rest_* deltas (a slow "
                "transport dispatches late); doctor --live names the "
                "worst source. Tune slo_dispatch_target_s / "
                "slo_error_budget via Watchdog.configure."
            ),
        ),
        SloRule(
            name="slo_round_throughput",
            objective=(
                "round throughput holds the floor fraction of its "
                "trailing baseline"
            ),
            feed_key="slo_rounds",
            mode="throughput",
            severity="warning",
            metrics=("v6t_round_updates_total",),
            runbook=(
                "compare straggler_station / queue_buildup alerts and "
                "/api/fleet top_deltas: a collapsed round rate with busy "
                "REST counters is a wedged aggregation, with quiet "
                "counters a stalled submitter. Floor: "
                "slo_throughput_floor_pct of the slow-window rate."
            ),
        ),
        SloRule(
            name="slo_daemon_liveness",
            objective=(
                "the fleet's daemon sources keep pushing fresh telemetry"
            ),
            feed_key="fleet_sources",
            mode="liveness",
            severity="warning",
            metrics=(),
            runbook=(
                "GET /api/fleet liveness block for who went quiet; a "
                "single daemon also raises daemon_lapsed (per-node, "
                "critical) — this SLO is the aggregate budget. Restart "
                "the lagging daemons; pushes resume on their next sync "
                "tick."
            ),
        ),
    ]


def default_rules() -> list[AlertRule]:
    return [
        AlertRule(
            name="stuck_run",
            severity="critical",
            summary=(
                "A run has been ACTIVE past the deadline with no status "
                "events — its daemon crashed mid-execution, the terminal "
                "status patch was lost, or the algorithm is wedged."
            ),
            runbook=(
                "doctor the flight dump for the run's trace_id, check the "
                "owning node's daemon log, then kill_task to release the "
                "round (the anti-entropy sweep re-claims orphans)."
            ),
            metrics=(),
            check=_check_stuck_run,
        ),
        AlertRule(
            name="daemon_lapsed",
            severity="critical",
            summary=(
                "A node is marked online but missed its ping window — the "
                "daemon process died or lost its network path without an "
                "offline handshake."
            ),
            runbook=(
                "restart the node daemon; its startup resync re-claims "
                "pending runs. Runs it held past the deadline raise "
                "stuck_run separately. Automated: the autopilot requeues "
                "the node's ACTIVE runs (CAS-guarded, one-shot) — see "
                "docs/OPERATOR_GUIDE.md 'autopilot'."
            ),
            metrics=(),
            check=_check_daemon_lapsed,
        ),
        AlertRule(
            name="replica_lapsed",
            severity="warning",
            summary=(
                "A server replica sharing this store stopped heartbeating "
                "— its process died or lost the store without a clean "
                "shutdown. The surviving replicas keep serving; runs the "
                "dead replica had in flight re-queue via the orphan sweep."
            ),
            runbook=(
                "check /api/health `replicas` on a survivor; restart or "
                "remove the dead replica. Attribute its in-flight work "
                "with trace_view (spans carry replica_id). Warning, not "
                "critical: N-1 replicas is degraded capacity, not an "
                "outage (see docs/control_plane.md). Automated: the "
                "autopilot requeues runs the dead replica's lost reports "
                "stranded ACTIVE (CAS-guarded, one-shot) — see "
                "docs/OPERATOR_GUIDE.md 'autopilot'."
            ),
            metrics=(),
            check=_check_replica_lapsed,
        ),
        AlertRule(
            name="straggler_station",
            severity="warning",
            summary=(
                "The same station dominated round wall-clock in several "
                "recent rounds — persistent slow hardware/data-size skew, "
                "not a one-off."
            ),
            runbook=(
                "compare the station's exec spans (trace_view straggler "
                "call-out) against its wire bytes; consider async "
                "aggregation (run_buffered) or re-balancing its shard. "
                "Automated: the autopilot shrinks the station's selection "
                "weight while this alert is active and restores it on "
                "clear — see docs/OPERATOR_GUIDE.md 'autopilot'."
            ),
            metrics=(),
            check=_check_straggler_station,
        ),
        AlertRule(
            name="anomalous_station",
            severity="warning",
            summary=(
                "A station's updates are statistical outliers in several "
                "recent rounds — cosine to the pooled update below "
                "threshold (label flip / poisoning / diverging local "
                "training) or update norm a multiple of the station "
                "median (scaling / exploding gradients)."
            ),
            runbook=(
                "GET /api/rounds/<task_id> for the per-station "
                "trajectory (doctor's learning digest renders the same "
                "table from a dump); inspect the station's data/labels, "
                "then drop it from the next task's organizations or mask "
                "it — the pooled update already nan-isolates zero-weight "
                "stations. Automated: the autopilot masks the station out "
                "of the aggregate while this alert is active and unmasks "
                "it on clear — see docs/OPERATOR_GUIDE.md 'autopilot'."
            ),
            metrics=(),
            check=_check_anomalous_station,
        ),
        AlertRule(
            name="model_divergence",
            severity="critical",
            summary=(
                "The global update norm is growing monotonically across "
                "recorded rounds — the model is diverging (learning rate "
                "too high, poisoned aggregate, or numerical blow-up), "
                "and every further round makes it worse."
            ),
            runbook=(
                "stop the run (kill_task), check /api/rounds for which "
                "round the norm took off and whether anomalous_station "
                "names a culprit; resume from the last good checkpoint "
                "with a lower local_lr/server lr."
            ),
            metrics=(),
            check=_check_model_divergence,
        ),
        AlertRule(
            name="non_convergence",
            severity="warning",
            summary=(
                "The global update norm stopped decaying past the round "
                "budget — training is burning rounds without progress "
                "(lr too low/high, compression too aggressive, or the "
                "task is mis-specified)."
            ),
            runbook=(
                "read the trajectory at /api/rounds/<task_id> (trend "
                "first: is it flat or oscillating?), check ef_mass_growth "
                "and anomalous_station beside it, then adjust lr / "
                "topk_ratio or re-examine the data split — "
                "docs/OPERATOR_GUIDE.md 'the model isn't converging'."
            ),
            metrics=(),
            check=_check_non_convergence,
        ),
        AlertRule(
            name="queue_buildup",
            severity="warning",
            summary=(
                "Executor backlog is sustained at a multiple of worker "
                "capacity — submission outpaces execution and task latency "
                "is compounding."
            ),
            runbook=(
                "raise executor_workers, throttle task creation, or check "
                "for a station whose FIFO is blocked by a long run "
                "(queue_wait_s in run_lifecycle). Automated: the autopilot "
                "applies admission control (new host runs queue instead of "
                "dispatching) while this alert is active and drains on "
                "clear — see docs/OPERATOR_GUIDE.md 'autopilot'."
            ),
            metrics=(
                "v6t_executor_inflight_items",
                "v6t_executor_capacity",
            ),
            check=_check_queue_buildup,
        ),
        AlertRule(
            name="event_cursor_lag",
            severity="warning",
            summary=(
                "Consumers are fetching event history the bounded hub "
                "buffer already evicted (truncated responses) — lagging "
                "daemons are missing events and paying full resyncs."
            ),
            runbook=(
                "check daemon backoff counters (a flapping network keeps "
                "pollers behind) and raise the hub buffer_size if "
                "truncations persist."
            ),
            metrics=(
                "v6t_event_truncated_total",
                "v6t_event_hub_cursor",
                "v6t_event_hub_evicted_through",
            ),
            check=_check_event_cursor_lag,
        ),
        AlertRule(
            name="ef_mass_growth",
            severity="warning",
            summary=(
                "The compression error-feedback accumulator is growing "
                "monotonically — compression is too aggressive for this "
                "workload and residual error is piling up instead of "
                "shipping."
            ),
            runbook=(
                "raise topk_ratio (ship more coordinates) or disable int8 "
                "for this workload; compression_stats() shows the per-round "
                "trajectory."
            ),
            metrics=("v6t_compress_ef_norm",),
            check=_check_ef_mass_growth,
        ),
        AlertRule(
            name="recompile_storm",
            severity="warning",
            summary=(
                "Observed jit functions are retracing every evaluation — "
                "an unstable abstract signature (wobbling batch shape, "
                "fresh weak-typed scalar, new dtype) is paying a full "
                "XLA compile per dispatch instead of reusing the cache."
            ),
            runbook=(
                "the alert and the doctor perf digest name the function "
                "and the leaf that changed; pad/bucket that input to a "
                "static shape (or mark the wobbling scalar static). "
                "trace_view's device call-out shows the compile cost."
            ),
            metrics=("v6t_jit_retraces_total",),
            check=_check_recompile_storm,
        ),
        AlertRule(
            name="device_mem_growth",
            severity="warning",
            summary=(
                "Device memory in use is growing monotonically across "
                "evaluations — buffers are accumulating instead of being "
                "freed (leaked executable-cache entry, un-donated scan "
                "carry, host references pinning device arrays)."
            ),
            runbook=(
                "open a profile window (POST /api/debug/profile) around "
                "a round and compare v6t_jit_signatures / "
                "v6t_engine_cache_entries growth; clear or bound the "
                "offending cache, or donate the round's carry buffers."
            ),
            metrics=("v6t_device_mem_bytes_in_use",),
            check=_check_device_mem_growth,
        ),
    ] + [slo.to_alert_rule() for slo in default_slos()]


DEFAULT_RULES = default_rules()

# name -> catalog row: what tools/doctor.py explains alerts against and
# docs/observability.md documents
RULE_CATALOG: dict[str, dict[str, str]] = {
    r.name: {
        "severity": r.severity,
        "summary": r.summary,
        "runbook": r.runbook,
    }
    for r in DEFAULT_RULES
}


@dataclasses.dataclass
class Alert:
    rule: str
    severity: str
    message: str
    labels: dict[str, Any]
    traceparent: str | None
    raised_at: float
    last_seen_at: float
    count: int = 1
    resolved_at: float | None = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "message": self.message,
            "labels": self.labels,
            "traceparent": self.traceparent,
            "raised_at": self.raised_at,
            "last_seen_at": self.last_seen_at,
            "count": self.count,
            "resolved_at": self.resolved_at,
        }


class Watchdog:
    """Rule engine + evaluation loop + health verdict (module docstring)."""

    def __init__(
        self,
        rules: list[AlertRule] | None = None,
        interval: float | None = None,
        history: int = 128,
    ):
        self._lock = threading.Lock()
        self.rules: list[AlertRule] = []
        for rule in rules if rules is not None else default_rules():
            self.add_rule(rule)
        self.interval = (
            interval
            if interval is not None
            else max(0.1, env_float("V6T_WATCHDOG_INTERVAL", 5.0))
        )
        self.config: dict[str, Any] = {
            "run_deadline_s": env_float("V6T_RUN_DEADLINE_S", 300.0),
            "ping_window_s": env_float("V6T_PING_WINDOW_S", 60.0),
            "queue_factor": 4.0,
            "queue_sustain_evals": 2,
            "straggler_rounds": 3,
            "straggler_ratio": 3.0,
            "straggler_window": 8,
            # learning plane (runtime.learning feed)
            "anomaly_cos_threshold": 0.2,
            "anomaly_norm_factor": 4.0,
            "anomaly_rounds": 3,
            "anomaly_window": 8,
            "divergence_rounds": 4,
            "divergence_min_growth_pct": 10.0,
            "non_convergence_rounds": 30,
            "non_convergence_window": 16,
            "non_convergence_decay_pct": 5.0,
            "non_convergence_converged_ratio": 0.05,
            "ef_growth_evals": 4,
            "recompile_storm_retraces": 3,
            "recompile_storm_window": 4,
            "device_mem_growth_evals": 4,
            "device_mem_growth_pct": 10.0,
            # SLO engine (store-backed fleet history; see default_slos)
            "slo_dispatch_target_s": 2.0,
            "slo_error_budget": 0.01,
            "slo_burn_threshold": 6.0,
            "slo_fast_window_s": 300.0,
            "slo_slow_window_s": 3600.0,
            "slo_min_samples": 4,
            "slo_throughput_floor_pct": 50.0,
            "slo_liveness_ratio": 0.9,
            "slo_liveness_slow_grace_s": 120.0,
        }
        self._history_len = max(8, history)
        self._feeds: dict[str, Callable[[], Any]] = {}  # guarded-by: _lock
        self._components: dict[str, Callable[[], Any]] = {}  # guarded-by: _lock
        self._metric_history: dict[str, deque] = {}  # guarded-by: _lock
        self._active: dict[Any, Alert] = {}  # guarded-by: _lock
        self._recent: deque[Alert] = deque(maxlen=256)  # guarded-by: _lock
        self._feed_error_keys: set[str] = set()  # guarded-by: _lock
        self._listeners: dict[str, Callable[[str, Alert], Any]] = {}  # guarded-by: _lock
        self.last_eval_at: float | None = None
        self._users = 0  # guarded-by: _lock (refcounted start/stop)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # own freshness as a first-class component: a wedged evaluation
        # loop must itself flip health to degraded
        self.register_component("watchdog", self.self_check)

    # ------------------------------------------------------------- registry
    def add_rule(self, rule: AlertRule) -> None:
        rule.validate()
        with self._lock:
            if any(r.name == rule.name for r in self.rules):
                raise ValueError(f"duplicate alert rule {rule.name!r}")
            self.rules.append(rule)

    def configure(self, interval: float | None = None, **config: Any) -> "Watchdog":
        if interval is not None:
            self.interval = max(0.05, float(interval))
        for key, value in config.items():
            if key not in self.config:
                raise ValueError(f"unknown watchdog config key {key!r}")
            self.config[key] = value
        return self

    def register_feed(self, key: str, fn: Callable[[], Any]) -> None:
        """Register (or replace — same key) a state source: ``fn()``
        returns a dict of list-valued entries ("runs", "nodes", "rounds")
        or None. Same keyed-replacement story as telemetry collectors."""
        with self._lock:
            self._feeds[key] = fn

    def unregister_feed(
        self, key: str, fn: Callable[[], Any] | None = None
    ) -> None:
        """Remove a feed; with ``fn``, only if it is still the registered
        one (a replaced source must not evict its replacement — same
        contract as telemetry's unregister_collector)."""
        with self._lock:
            if fn is None or self._feeds.get(key) == fn:
                self._feeds.pop(key, None)
                self._feed_error_keys.discard(key)

    def has_feed(self, key: str) -> bool:
        with self._lock:
            return key in self._feeds

    def add_listener(self, key: str, fn: Callable[[str, Alert], Any]) -> None:
        """Register (or replace — same key) a transition listener:
        ``fn(event, alert)`` with event ``"raised"`` or ``"cleared"``,
        called synchronously after the transition's own emits (span, log,
        flight note) so anything the listener does — the autopilot's
        remediation spans in particular — nests correctly after the
        alert's. Listeners are fail-soft: one raising never blocks the
        others or the evaluation."""
        with self._lock:
            self._listeners[key] = fn

    def remove_listener(
        self, key: str, fn: Callable[[str, Alert], Any] | None = None
    ) -> None:
        """Remove a listener; with ``fn``, only if it is still the
        registered one (same contract as unregister_feed)."""
        with self._lock:
            if fn is None or self._listeners.get(key) == fn:
                self._listeners.pop(key, None)

    def register_component(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a health self-check: ``fn()`` returns ``(ok, detail)``
        or a bare bool. A raising check counts as failed (the component
        cannot even answer)."""
        with self._lock:
            self._components[name] = fn

    def unregister_component(self, name: str) -> None:
        with self._lock:
            self._components.pop(name, None)

    # ------------------------------------------------------------ evaluation
    def _rule_metric_names(self) -> set[str]:
        return {name for rule in self.rules for name in rule.metrics}

    def evaluate(self) -> list[dict[str, Any]]:
        """One full pass: snapshot telemetry, pull feeds, run every rule,
        transition alert state, emit. Returns the active alerts."""
        now = time.time()
        snapshot = REGISTRY.snapshot()
        with self._lock:
            feeds_fns = dict(self._feeds)
            tracked = self._rule_metric_names()
            for name in tracked:
                value = snapshot.get(name)
                if value is None and _metric_kind(name) == "counter":
                    # counters materialize in the snapshot on first inc();
                    # an absent counter IS 0, and recording that baseline
                    # is what lets a trend rule see the first increment of
                    # a process lifetime as growth — without ever
                    # mistaking a pre-existing count at watchdog start for
                    # a fresh jump
                    value = 0.0
                if isinstance(value, (int, float)):
                    hist = self._metric_history.get(name)
                    if hist is None:
                        hist = self._metric_history[name] = deque(
                            maxlen=self._history_len
                        )
                    hist.append((now, float(value)))
            history = {
                k: deque(v) for k, v in self._metric_history.items()
            }
        feeds: dict[str, Any] = {}
        any_feed_failed = False
        for key, fn in feeds_fns.items():
            try:
                state = fn()
            except Exception as e:
                REGISTRY.counter("v6t_watchdog_feed_errors_total").inc()
                any_feed_failed = True
                with self._lock:
                    fresh = key not in self._feed_error_keys
                    self._feed_error_keys.add(key)
                if fresh:  # once per failure streak, not per eval
                    log.warning("watchdog feed %s failed: %s", key, e)
                continue
            with self._lock:
                self._feed_error_keys.discard(key)
            if state is not None:
                feeds[key] = state
        # eval_interval_s rides along (NOT a configure() key): trend rules
        # need the nominal sample spacing to turn "N consecutive samples"
        # into a wall-clock claim
        ctx = RuleContext(
            snapshot, history, feeds,
            {**self.config, "eval_interval_s": self.interval}, now,
        )

        proposed: dict[Any, tuple[AlertRule, dict[str, Any]]] = {}
        crashed_rules: set[str] = set()
        for rule in list(self.rules):
            try:
                findings = rule.check(ctx) or []
            except Exception as e:
                REGISTRY.counter("v6t_watchdog_feed_errors_total").inc()
                crashed_rules.add(rule.name)
                log.warning("alert rule %s crashed: %s", rule.name, e)
                continue
            for finding in findings:
                labels = finding.get("labels") or {}
                key = (
                    rule.name,
                    tuple(sorted((k, str(v)) for k, v in labels.items())),
                )
                proposed[key] = (rule, finding)

        raised: list[Alert] = []
        cleared: list[Alert] = []
        with self._lock:
            for key, (rule, finding) in proposed.items():
                alert = self._active.get(key)
                if alert is None:
                    alert = Alert(
                        rule=rule.name,
                        severity=rule.severity,
                        message=finding["message"],
                        labels=finding.get("labels") or {},
                        traceparent=finding.get("traceparent"),
                        raised_at=now,
                        last_seen_at=now,
                    )
                    self._active[key] = alert
                    raised.append(alert)
                else:
                    alert.message = finding["message"]
                    alert.last_seen_at = now
                    alert.count += 1
            for key in [k for k in self._active if k not in proposed]:
                # Fail-soft HOLDS, never clears: when a feed raised or the
                # alert's own rule crashed, the finding's absence is loss
                # of evidence, not recovery — resolving would flap
                # /api/health and reset raised_at/count on the next clean
                # pass. Hold the alert until a clean evaluation stops
                # proposing it.
                if any_feed_failed or key[0] in crashed_rules:
                    continue
                alert = self._active.pop(key)
                alert.resolved_at = now
                self._recent.append(alert)
                cleared.append(alert)
            n_active = len(self._active)
            n_slo = sum(
                1 for a in self._active.values()
                if a.rule.startswith("slo_")
            )
            active = [a.to_dict() for a in self._active.values()]
            self.last_eval_at = now

        for alert in raised:
            self._emit_raise(alert)
            self._notify_listeners("raised", alert)
        for alert in cleared:
            self._emit_clear(alert)
            self._notify_listeners("cleared", alert)

        REGISTRY.counter("v6t_watchdog_evaluations_total").inc()
        if raised:
            REGISTRY.counter("v6t_alerts_raised_total").inc(len(raised))
        if cleared:
            REGISTRY.counter("v6t_alerts_cleared_total").inc(len(cleared))
        REGISTRY.gauge("v6t_alerts_active").set(n_active)
        REGISTRY.gauge("v6t_slo_burning").set(n_slo)
        REGISTRY.gauge("v6t_watchdog_last_eval_unixtime").set(now)
        # fold the verdict into telemetry + the flight recorder's metric
        # history every pass — a dump carries the health trajectory
        verdict = self.health()
        REGISTRY.gauge("v6t_health_degraded").set(
            1.0 if verdict["status"] == "degraded" else 0.0
        )
        try:
            from vantage6_tpu_torch.common.flight import FLIGHT

            # reuse THIS evaluation's snapshot — taking another would run
            # every collector (hub/executor/cache stats, each under its
            # component's lock) twice per tick
            FLIGHT.snapshot_metrics(snapshot)
        except Exception:  # pragma: no cover
            pass
        return active

    def _emit_raise(self, alert: Alert) -> None:
        attrs = {
            "severity": alert.severity,
            "message": alert.message,
            "transition": "raised",
            **{f"label_{k}": v for k, v in alert.labels.items()},
        }
        # the span is ACTIVE around the warning log so the log record is
        # stamped with the trace ids (TraceContextFilter): when the alert
        # carries the affected task's traceparent, both the span AND the
        # log line land inside the stuck round's own trace — the
        # correlation tools/doctor.py merges on
        with TRACER.span(
            f"alert.{alert.rule}", kind="alert", service="watchdog",
            parent=alert.traceparent,  # None -> fresh root trace
            attrs=attrs,
        ) as sp:
            sp.add_event("alert_raised", rule=alert.rule,
                         severity=alert.severity)
            log.warning(
                "ALERT raised [%s/%s]: %s", alert.severity, alert.rule,
                alert.message,
            )
        try:
            from vantage6_tpu_torch.common.flight import FLIGHT

            FLIGHT.note(
                "alert_raised", rule=alert.rule, severity=alert.severity,
                message=alert.message, labels=alert.labels,
                traceparent=alert.traceparent,
            )
        except Exception:  # pragma: no cover
            pass

    def _emit_clear(self, alert: Alert) -> None:
        # symmetric with _emit_raise: the clear gets its own span on the
        # SAME trace (alert.traceparent), so a remediation revert — which
        # the autopilot hangs off this transition — is as visible in
        # doctor timelines as the raise that triggered the action
        duration_s = (alert.resolved_at or 0) - alert.raised_at
        attrs = {
            "severity": alert.severity,
            "message": alert.message,
            "transition": "cleared",
            "duration_s": duration_s,
            **{f"label_{k}": v for k, v in alert.labels.items()},
        }
        with TRACER.span(
            f"alert.{alert.rule}", kind="alert", service="watchdog",
            parent=alert.traceparent,  # None -> fresh root trace
            attrs=attrs,
        ) as sp:
            sp.add_event("alert_cleared", rule=alert.rule,
                         severity=alert.severity)
            log.info(
                "alert cleared [%s/%s] after %.1fs: %s", alert.severity,
                alert.rule, duration_s, alert.message,
            )
        try:
            from vantage6_tpu_torch.common.flight import FLIGHT

            FLIGHT.note(
                "alert_cleared", rule=alert.rule, severity=alert.severity,
                message=alert.message, labels=alert.labels,
                traceparent=alert.traceparent, duration_s=duration_s,
            )
        except Exception:  # pragma: no cover
            pass

    def _notify_listeners(self, event: str, alert: Alert) -> None:
        with self._lock:
            listeners = list(self._listeners.items())
        for key, fn in listeners:
            try:
                fn(event, alert)
            except Exception as e:
                REGISTRY.counter("v6t_watchdog_feed_errors_total").inc()
                log.warning(
                    "watchdog listener %s failed on %s %s: %s",
                    key, alert.rule, event, e,
                )

    # -------------------------------------------------------------- queries
    def active_alerts(self) -> list[dict[str, Any]]:
        with self._lock:
            return [a.to_dict() for a in self._active.values()]

    def recent_alerts(self, limit: int = 50) -> list[dict[str, Any]]:
        with self._lock:
            recent = list(self._recent)[-limit:]
        return [a.to_dict() for a in reversed(recent)]

    def health(self) -> dict[str, Any]:
        """ok/degraded verdict: every registered component's self-check
        plus the active alert census. Degraded = any component failing OR
        any critical alert active."""
        with self._lock:
            components = dict(self._components)
            active = list(self._active.values())
        comp_out: dict[str, dict[str, Any]] = {}
        degraded = False
        for name, fn in components.items():
            try:
                result = fn()
            except Exception as e:
                result = (False, f"self-check raised: {e}")
            if isinstance(result, tuple):
                ok, detail = bool(result[0]), str(result[1])
            else:
                ok, detail = bool(result), ""
            comp_out[name] = {"ok": ok, "detail": detail}
            degraded |= not ok
        n_critical = sum(1 for a in active if a.severity == "critical")
        degraded |= n_critical > 0
        return {
            "status": "degraded" if degraded else "ok",
            "components": comp_out,
            "alerts": {
                "active": len(active),
                "critical": n_critical,
            },
        }

    def self_check(self) -> tuple[bool, str]:
        """The watchdog's own freshness, registered as component
        "watchdog": started-but-stale (or started-but-dead-thread) fails."""
        with self._lock:
            users = self._users
            thread = self._thread
            last = self.last_eval_at
        if users <= 0:
            return True, "not running (on-demand evaluation)"
        if thread is None or not thread.is_alive():
            return False, "evaluation thread is not alive"
        if last is None:
            return True, "starting"
        lag = time.time() - last
        if lag > max(3.0 * self.interval, 1.0):
            return False, f"last evaluation {lag:.1f}s ago (interval {self.interval:g}s)"
        return True, f"last evaluation {lag:.1f}s ago"

    # ------------------------------------------------------------- lifecycle
    def start(self, interval: float | None = None) -> "Watchdog":
        """Refcounted: each server/daemon embedding calls start() once and
        stop() on close; the loop runs while any user remains."""
        if interval is not None:
            self.configure(interval=interval)
        with self._lock:
            self._users += 1
            if self._thread is not None and self._thread.is_alive():
                return self
            # a FRESH loop: the previous loop's timestamp must not count
            # against the new one's freshness check (a server starting
            # minutes after the last one stopped would otherwise report
            # a degraded watchdog until the first tick)
            self.last_eval_at = None
            self._stop = threading.Event()
            # the loop gets ITS OWN stop event as an argument: reading
            # self._stop lazily inside _loop races a stop()+start() pair
            # swapping the attribute before the old thread's first read —
            # the old loop would bind the NEW (unset) event and run
            # forever beside its replacement
            self._thread = threading.Thread(
                target=self._loop, args=(self._stop,),
                daemon=True, name="v6t-watchdog",
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            self._users = max(0, self._users - 1)
            if self._users > 0:
                return
            thread, self._thread = self._thread, None
            self._stop.set()
        if thread is not None:
            thread.join(timeout=5)

    def _loop(self, stop: threading.Event) -> None:
        # evaluate IMMEDIATELY, then on the interval: a freshly started
        # server gets a real health verdict (and stale alerts from feeds
        # that died with a previous embedder get cleared) on its first
        # request, not after one full interval
        while True:
            try:
                self.evaluate()
            except Exception:
                # the loop must survive anything an eval throws; the next
                # tick tries again and self_check reports staleness if it
                # keeps failing
                log.exception("watchdog evaluation crashed")
            if stop.wait(self.interval):
                return


WATCHDOG = Watchdog()
