"""Unified telemetry registry: one named counter/gauge/histogram API.

The port's copy of ``vantage6_tpu/common/telemetry.py``: framework-free,
the same names and render, with the ``wire``, ``rest`` and ``executor``
collectors reading the port's ``common/serialization.py``,
``common/rest.py`` and ``runtime/executor.py``.

Before this module, every perf PR grew its own island of counters —
`serialization.WIRE_STATS`, `rest.REST_STATS`, executor inflight counts,
EventHub eviction tracking, AuthCache hit rates — each with its own
snapshot shape and no single place to read them. The registry absorbs
them all behind one API and renders the whole set as Prometheus text
(`GET /api/metrics` on the server serves exactly `render_prometheus()`).

Two ways in:

- **Owned instruments** — `REGISTRY.counter/gauge/histogram(name)` for
  code that wants to increment/observe directly (the WSGI layer's request
  counter + latency histogram live here). Get-or-create and thread-safe;
  re-requesting a name returns the same instrument, requesting it as a
  different kind raises.
- **Collectors** — `REGISTRY.register_collector(key, fn)` for the
  existing stat islands: `fn()` returns `{metric_name: value}` and is
  called at render/snapshot time. Keyed registration means a rebindable
  source (a new ServerApp in the same process) REPLACES its predecessor
  instead of double-reporting; a collector that raises is skipped for
  that render, never fatal.

Every name any of this may emit is declared in `KNOWN_METRICS` — the one
table `tools/check_collect.py` audits for uniqueness and snake_case, and
the HELP/TYPE source for the Prometheus render. Emitting an undeclared
name is allowed at runtime (rendered untyped) but the audit exists so the
declared surface stays the documented one.
"""
from __future__ import annotations

import re
import threading
from typing import Any, Callable

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# the one exposition content-type, shared by every /api/metrics handler
# (server AND node proxy) so a format change can't drift between them
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# name -> (kind, help). THE declarative metric surface: check_collect
# audits this table (unique, snake_case), /metrics renders HELP/TYPE from
# it. Add new metrics HERE first.
KNOWN_METRICS: list[tuple[str, str, str]] = [
    # wire (common.serialization.WIRE_STATS)
    ("v6t_wire_encode_calls_total", "counter", "serialize() calls"),
    ("v6t_wire_encode_bytes_total", "counter", "bytes produced by serialize()"),
    ("v6t_wire_encode_seconds_total", "counter", "seconds spent in serialize()"),
    ("v6t_wire_decode_calls_total", "counter", "deserialize() calls"),
    ("v6t_wire_decode_bytes_total", "counter", "bytes consumed by deserialize()"),
    ("v6t_wire_decode_seconds_total", "counter", "seconds spent in deserialize()"),
    ("v6t_wire_broadcasts_total", "counter", "broadcast encrypt calls"),
    ("v6t_wire_broadcast_recipients_total", "counter",
     "recipients across broadcast encrypts"),
    ("v6t_wire_broadcast_dedup_hits_total", "counter",
     "full AES passes avoided by single-pass broadcast"),
    # REST transport (common.rest.REST_STATS)
    ("v6t_rest_calls_total", "counter", "HTTP requests over the pooled transport"),
    ("v6t_rest_errors_total", "counter", "HTTP requests that errored (>=400 or raised)"),
    ("v6t_rest_stale_retries_total", "counter",
     "requests retried once on a stale keep-alive socket"),
    ("v6t_rest_bytes_sent_total", "counter", "request body bytes sent"),
    ("v6t_rest_bytes_received_total", "counter", "response body bytes received"),
    ("v6t_rest_seconds_total", "counter", "seconds spent in HTTP requests"),
    # HTTP server (server.web.App — also counts the node proxy's relay)
    ("v6t_http_requests_total", "counter", "WSGI requests handled"),
    ("v6t_http_errors_total", "counter", "WSGI responses with status >= 500"),
    ("v6t_http_request_seconds", "histogram", "WSGI request handling latency"),
    # event hub (server.events.EventHub via the ServerApp collector)
    ("v6t_event_hub_buffer_len", "gauge", "events currently buffered for replay"),
    ("v6t_event_hub_cursor", "gauge", "sequence number of the newest event"),
    ("v6t_event_hub_evicted_through", "gauge",
     "newest event sequence the bounded buffer has dropped"),
    ("v6t_event_hub_subscribers", "gauge", "in-process push subscribers"),
    ("v6t_event_truncated_total", "counter",
     "event fetches answered truncated: the consumer's cursor was behind "
     "the ring's eviction horizon"),
    # server hot-path caches (server.cache)
    ("v6t_auth_cache_hits_total", "counter", "token->principal cache hits"),
    ("v6t_auth_cache_misses_total", "counter", "token->principal cache misses"),
    ("v6t_auth_cache_entries", "gauge", "cached token->principal entries"),
    ("v6t_visibility_cache_hits_total", "counter",
     "org->collaborations visibility cache hits"),
    ("v6t_visibility_cache_misses_total", "counter",
     "org->collaborations visibility cache misses"),
    ("v6t_visibility_cache_entries", "gauge", "cached org->collaborations entries"),
    # server app
    ("v6t_server_uptime_seconds", "gauge", "seconds since ServerApp start"),
    # host-path executor pool (runtime.executor)
    ("v6t_executor_pools", "gauge", "live StationExecutor pools in this process"),
    ("v6t_executor_inflight_items", "gauge",
     "run items queued or executing across live pools"),
    ("v6t_executor_capacity", "gauge",
     "total worker slots across live pools (queue_buildup denominator)"),
    # gradient compression (fed.compression — docs/compression.md)
    ("v6t_compress_calls_total", "counter",
     "delta compress operations (one per station uplink)"),
    ("v6t_compress_raw_bytes_total", "counter",
     "dense f32 bytes entering the compressor"),
    ("v6t_compress_wire_bytes_total", "counter",
     "bytes actually shipped after quantization/sparsification"),
    ("v6t_decompress_calls_total", "counter",
     "delta decompress operations (server-side reconstructions)"),
    ("v6t_compress_ratio", "gauge",
     "raw/wire on-wire reduction of the latest compress"),
    ("v6t_compress_ef_norm", "gauge",
     "L2 norm of the most recent error-feedback accumulator"),
    # learning plane (runtime.learning — docs/observability.md "learning
    # plane"): convergence + per-station update-quality gauges; the
    # station gauges summarize the LATEST recorded round (the full
    # per-station table lives at GET /api/rounds/<task_id>)
    ("v6t_round_updates_total", "counter",
     "federated rounds recorded by the learning-plane observatory"),
    ("v6t_round_update_norm", "gauge",
     "L2 norm of the latest recorded pooled (global) update"),
    ("v6t_round_loss", "gauge",
     "mean training loss of the latest recorded round"),
    ("v6t_round_norm_decay", "gauge",
     "latest pooled update norm / peak norm so far (1.0 = not decaying)"),
    ("v6t_station_update_norm_max", "gauge",
     "largest per-station update L2 norm in the latest recorded round"),
    ("v6t_station_cos_min", "gauge",
     "smallest station cosine-to-pooled-update in the latest recorded "
     "round"),
    ("v6t_station_ef_norm_max", "gauge",
     "largest per-station error-feedback mass in the latest recorded "
     "round (compression armed)"),
    # tracing health (runtime.tracing)
    ("v6t_trace_spans_recorded_total", "counter", "spans recorded to the ring buffer"),
    ("v6t_trace_spans_dropped_total", "counter",
     "spans evicted from the full ring buffer"),
    ("v6t_trace_sink_errors_total", "counter",
     "JSONL sink write failures (sink disabled after the first)"),
    ("v6t_trace_buffer_len", "gauge", "spans currently buffered"),
    ("v6t_trace_enabled", "gauge", "1 when tracing collection is enabled"),
    # watchdog / alerting (runtime.watchdog — docs/observability.md)
    ("v6t_alerts_active", "gauge", "watchdog alerts currently active"),
    ("v6t_alerts_raised_total", "counter",
     "alert raise transitions (inactive -> active)"),
    ("v6t_alerts_cleared_total", "counter",
     "alert clear transitions (active -> resolved)"),
    ("v6t_watchdog_evaluations_total", "counter",
     "watchdog rule-evaluation passes"),
    ("v6t_watchdog_last_eval_unixtime", "gauge",
     "wall-clock of the last watchdog evaluation"),
    ("v6t_watchdog_feed_errors_total", "counter",
     "watchdog feed/rule callbacks that raised (skipped, never fatal)"),
    ("v6t_health_degraded", "gauge",
     "1 when the health verdict is degraded (component self-check failure "
     "or critical alert active)"),
    # node daemon resilience (node.daemon)
    ("v6t_daemon_backoff_total", "counter",
     "event-poll failures that entered the capped exponential backoff"),
    ("v6t_daemon_rotation_total", "counter",
     "full replica-URL rotations that found no reachable server (each "
     "enters the capped jittered backoff)"),
    # async buffered aggregation (runtime.federation.run_buffered)
    ("v6t_async_rounds_total", "counter",
     "buffered-async federated rounds orchestrated"),
    ("v6t_async_stragglers_killed_total", "counter",
     "straggler runs killed at quorum/deadline by buffered-async rounds"),
    # autopilot remediation engine (runtime.autopilot —
    # docs/OPERATOR_GUIDE.md "autopilot")
    ("v6t_autopilot_actions_total", "counter",
     "remediation actions applied by the autopilot"),
    ("v6t_autopilot_reverts_total", "counter",
     "autopilot actions reverted on alert clear"),
    ("v6t_autopilot_suppressed_total", "counter",
     "autopilot actions suppressed by dry-run mode or a missing actuator "
     "capability"),
    ("v6t_autopilot_engaged", "gauge",
     "autopilot actions currently applied and not yet reverted"),
    # flight recorder (common.flight)
    ("v6t_flight_records", "gauge",
     "entries currently buffered across the flight-recorder rings"),
    ("v6t_flight_dumps_total", "counter", "flight-recorder bundles written"),
    # device observatory (runtime.profiling — docs/observability.md
    # "device plane"): every jit entry point's compile/retrace economics
    ("v6t_jit_dispatches_total", "counter",
     "calls dispatched through observed jit functions"),
    ("v6t_jit_compiles_total", "counter",
     "XLA lower+compile events recorded by the device observatory"),
    ("v6t_jit_lower_seconds_total", "counter",
     "seconds spent in jax lowering across observed compiles"),
    ("v6t_jit_compile_seconds_total", "counter",
     "seconds spent in XLA compilation across observed compiles"),
    ("v6t_jit_retraces_total", "counter",
     "retraces: an observed function compiled against a NEW abstract "
     "signature (recompile_storm's series)"),
    ("v6t_jit_static_sweeps_total", "counter",
     "compiles differing from a seen signature only in declared sweep "
     "statics (the fused program's n_rounds) — planned executables, "
     "excluded from the retrace series"),
    ("v6t_jit_fallbacks_total", "counter",
     "observed dispatches that fell back to plain jax.jit (tracer args, "
     "sharding mismatch, AOT-unloweable call)"),
    ("v6t_jit_cache_evictions_total", "counter",
     "compiled executables evicted from observed functions' bounded "
     "signature caches"),
    ("v6t_jit_functions", "gauge",
     "functions registered with the device observatory"),
    ("v6t_jit_signatures", "gauge",
     "live compiled signatures across observed functions"),
    ("v6t_jit_compile_temp_bytes", "gauge",
     "temp bytes of the most recent observed compile (memory_analysis)"),
    ("v6t_jit_compile_flops", "gauge",
     "flops estimate of the most recent observed compile (cost_analysis)"),
    # fingerprint-keyed runner caches (glm/quantile/device_engine via
    # runtime.profiling.engine_cache_event)
    ("v6t_engine_cache_hits_total", "counter",
     "mesh.fingerprint()-keyed runner cache hits"),
    ("v6t_engine_cache_misses_total", "counter",
     "mesh.fingerprint()-keyed runner cache misses (fresh compiles)"),
    ("v6t_engine_cache_entries", "gauge",
     "live entries across the fingerprint-keyed runner caches"),
    # fused multi-round device program (fed.fedavg.run_rounds /
    # run_rounds_async — docs/device_speed.md): how many logical rounds
    # each host dispatch amortizes
    ("v6t_fused_dispatches_total", "counter",
     "fused K-round program dispatches (one per run_rounds call)"),
    ("v6t_fused_rounds_total", "counter",
     "logical federated rounds executed inside fused dispatches"),
    ("v6t_fused_rounds_per_dispatch", "gauge",
     "K of the most recent fused dispatch (rounds amortized per host "
     "round-trip)"),
    # per-device memory (runtime.profiling device_mem collector; absent
    # on backends reporting no memory stats, e.g. CPU)
    ("v6t_device_count", "gauge",
     "local devices visible to this process"),
    ("v6t_device_mem_bytes_in_use", "gauge",
     "device memory in use, summed over local devices"),
    ("v6t_device_mem_peak_bytes", "gauge",
     "worst-device peak bytes in use across local devices"),
    # fleet telemetry fabric (common.fleet push path + server.fleet store
    # — docs/observability.md "fleet fabric")
    ("v6t_fleet_pushes_total", "counter",
     "telemetry snapshots shipped to POST /api/telemetry"),
    ("v6t_fleet_push_errors_total", "counter",
     "fleet pushes that failed (server unreachable or rejected)"),
    ("v6t_fleet_push_unsupported_total", "counter",
     "fleet pushes pinned off against a pre-fleet server (404/405)"),
    ("v6t_fleet_ingests_total", "counter",
     "fleet snapshots accepted by POST /api/telemetry on this replica"),
    ("v6t_fleet_ingest_rejects_total", "counter",
     "telemetry push bodies rejected as undecodable"),
    ("v6t_fleet_ingest_rows_total", "counter",
     "metric sample rows appended to the fleet store by ingests"),
    ("v6t_fleet_pruned_rows_total", "counter",
     "fleet store rows deleted by the retention pruner"),
    ("v6t_fleet_sources", "gauge",
     "distinct telemetry sources in the fleet store's retention window"),
    ("v6t_fleet_stale_sources", "gauge",
     "fleet sources whose newest snapshot is past the staleness window"),
    # the dispatch-latency SLO's series: observed server-side at the
    # run start transition, and mirrored as per-event samples into the
    # fleet store so burn rates survive replica restarts
    ("v6t_run_dispatch_seconds", "histogram",
     "assigned->started dispatch latency of runs (the dispatch SLO's "
     "subject series)"),
    # SLO engine (runtime.watchdog SloRule — docs/observability.md "SLO
    # burn-rate alerting")
    ("v6t_slo_evaluations_total", "counter",
     "SLO burn-rate rule evaluations"),
    ("v6t_slo_burning", "gauge",
     "SLO rules currently alerting (burn over threshold in both windows)"),
]

_KNOWN: dict[str, tuple[str, str]] = {
    name: (kind, help_) for name, kind, help_ in KNOWN_METRICS
}


def metric_kind(name: str) -> str | None:
    """Declared kind ("counter"/"gauge"/"histogram") of a KNOWN_METRICS
    name, None for undeclared series."""
    entry = _KNOWN.get(name)
    return entry[0] if entry else None


def validate_metric_name(name: str) -> None:
    if not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} must be snake_case "
            "([a-z][a-z0-9_]*)"
        )


class Counter:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


# latency-shaped defaults: 1ms .. ~30s
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0,
)


class Histogram:
    __slots__ = ("name", "buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, name: str, buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "buckets": dict(zip(self.buckets, self._counts)),
                "sum": self._sum,
                "count": self._count,
            }


class TelemetryRegistry:
    """Named instruments + keyed collectors, rendered as Prometheus text."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Any] = {}
        self._collectors: dict[str, Callable[[], dict[str, float]]] = {}

    # --------------------------------------------------------- instruments
    def _get_or_create(self, name: str, kind: type, **kw: Any) -> Any:
        validate_metric_name(name)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, kind):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}, not {kind.__name__}"
                    )
                return existing
            metric = kind(name, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(
        self, name: str, buckets: tuple[float, ...] = DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get_or_create(name, Histogram, buckets=buckets)

    # ---------------------------------------------------------- collectors
    def register_collector(
        self, key: str, fn: Callable[[], dict[str, float]]
    ) -> None:
        """Register (or REPLACE — same key) a snapshot source. Keyed
        replacement is the rebinding story: a fresh ServerApp re-registers
        "server" and the closure over the closed one is gone."""
        with self._lock:
            self._collectors[key] = fn

    def unregister_collector(
        self, key: str, fn: Callable[[], dict[str, float]] | None = None
    ) -> None:
        """Remove a collector; with `fn`, only if it is still the one
        registered (a replaced source must not evict its replacement)."""
        with self._lock:
            if fn is None or self._collectors.get(key) == fn:
                self._collectors.pop(key, None)

    # -------------------------------------------------------------- output
    def snapshot(self) -> dict[str, Any]:
        """Every current value as one flat dict (histograms nested)."""
        with self._lock:
            metrics = dict(self._metrics)
            collectors = dict(self._collectors)
        out: dict[str, Any] = {}
        for name, metric in metrics.items():
            out[name] = (
                metric.snapshot()
                if isinstance(metric, Histogram)
                else metric.value
            )
        for key, fn in collectors.items():
            try:
                vals = fn()
            except Exception:
                continue  # a dead source must not break the scrape
            for name, value in (vals or {}).items():
                out[name] = value
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (v0.0.4): HELP/TYPE from
        KNOWN_METRICS, untyped for anything undeclared."""
        lines: list[str] = []
        snap = self.snapshot()
        for name in sorted(snap):
            value = snap[name]
            kind, help_ = _KNOWN.get(name, ("untyped", ""))
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            if isinstance(value, dict) and "buckets" in value:
                # bucket counts are already cumulative (observe()
                # increments every bucket whose bound >= value)
                for bound, count in sorted(value["buckets"].items()):
                    lines.append(f'{name}_bucket{{le="{bound}"}} {count}')
                lines.append(
                    f'{name}_bucket{{le="+Inf"}} {value["count"]}'
                )
                lines.append(f"{name}_sum {_fmt(value['sum'])}")
                lines.append(f"{name}_count {value['count']}")
            else:
                lines.append(f"{name} {_fmt(value)}")
        return "\n".join(lines) + "\n"


def _fmt(v: Any) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


REGISTRY = TelemetryRegistry()


# ------------------------------------------------- process-wide collectors
# The pre-existing stat islands, absorbed. Imports are lazy inside each
# collector so importing telemetry stays dependency-free; a collector for
# a module never imported reports its zeros by importing it then.


def _wire_collector() -> dict[str, float]:
    from vantage6_tpu_torch.common.serialization import WIRE_STATS

    s = WIRE_STATS.snapshot()
    return {
        "v6t_wire_encode_calls_total": s["encode_calls"],
        "v6t_wire_encode_bytes_total": s["encode_bytes"],
        "v6t_wire_encode_seconds_total": s["encode_s"],
        "v6t_wire_decode_calls_total": s["decode_calls"],
        "v6t_wire_decode_bytes_total": s["decode_bytes"],
        "v6t_wire_decode_seconds_total": s["decode_s"],
        "v6t_wire_broadcasts_total": s["broadcasts"],
        "v6t_wire_broadcast_recipients_total": s["broadcast_recipients"],
        "v6t_wire_broadcast_dedup_hits_total": s["broadcast_dedup_hits"],
    }


def _rest_collector() -> dict[str, float]:
    from vantage6_tpu_torch.common.rest import REST_STATS

    s = REST_STATS.snapshot()
    return {
        "v6t_rest_calls_total": s["calls"],
        "v6t_rest_errors_total": s["errors"],
        "v6t_rest_stale_retries_total": s["stale_retries"],
        "v6t_rest_bytes_sent_total": s["bytes_sent"],
        "v6t_rest_bytes_received_total": s["bytes_received"],
        "v6t_rest_seconds_total": s["seconds"],
    }


def _executor_collector() -> dict[str, float]:
    from vantage6_tpu_torch.runtime.executor import _LIVE_POOLS

    pools = list(_LIVE_POOLS)
    return {
        "v6t_executor_pools": len(pools),
        "v6t_executor_inflight_items": sum(p.inflight for p in pools),
        "v6t_executor_capacity": sum(p.workers for p in pools),
    }


REGISTRY.register_collector("wire", _wire_collector)
REGISTRY.register_collector("rest", _rest_collector)
REGISTRY.register_collector("executor", _executor_collector)
