"""Span-based distributed tracing: client → server → daemon → device.

Four perf PRs each shipped an island of counters (`WIRE_STATS`,
`REST_STATS`, `run_lifecycle`, EventHub eviction tracking) — none of them
can follow ONE task across its process boundaries and say where the
latency went. This module is that attribution layer:

- **Spans**: `(trace_id, span_id, parent_id)` records with wall-clock
  start, monotonic-measured duration, a low-cardinality `name`, a `kind`
  (client/server/claim/exec/report/rest/...), a `service` (which
  component emitted it — client, server, daemon:<name>) and small attrs.
- **Propagation**: W3C-style `traceparent` (`00-<trace32>-<span16>-<fl>`)
  rides REST headers (`common.rest.pooled_request` injects the current
  context; `server.web.App` joins it) and task metadata (the server
  persists the creating request's context on the Task row; daemons parent
  their claim/exec/report spans on it — that is how one federated task
  becomes ONE trace across client, server and N daemons).
- **Collection**: cheap and always-on — a bounded ring buffer per process
  plus an optional JSONL sink, with head sampling at trace roots
  (`V6T_TRACE_SAMPLE`). Disabled entirely via `V6T_TRACE=0`.
- **Export**: `to_trace_events` renders spans as Chrome/Perfetto
  `trace_event` JSON (one pid lane per service) so a whole federated
  round — dispatch, long-poll wake, claim, exec, upload, aggregation —
  reads as one timeline; `summarize` is the per-hop p50/p95 table behind
  `tools/trace_view.py`.

Device work links in through `runtime.profiling.profile_window`, which
records a `device.profile` span carrying the torch.profiler log dir, so a
Chrome trace of the card's kernels is joinable to its federated trace by
trace_id. Inside that trace, `phase` names the parts of a training round
(a station's forward and backward, compression, aggregation, the server
step, the fused runner's dispatch, a mixture of experts' routing and
experts) on the profiler's own clock; it costs nothing while no profiler
is active (`RoundPhases`). `COUNTERS` keeps counts on the card under the
same switch, such as the token-slots routed to each expert
(`DeviceCounters`).

The port's copy of ``vantage6_tpu/runtime/tracing.py``: the same span
names, propagation and export; the round phases are the port's own.
"""
from __future__ import annotations

import contextlib
import json
import os
import random
import re
import secrets
import threading
import time
import weakref
from collections import deque
from typing import Any, Iterator

import torch

from vantage6_tpu_torch.common.env import env_float, env_int

TRACEPARENT_HEADER = "traceparent"

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


class SpanContext:
    """Immutable propagation context: the (trace, span) a child attaches
    to, plus the root's sampling decision (sampled=False still propagates
    ids so an unsampled trace stays consistent end to end)."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def to_traceparent(self) -> str:
        return (
            f"00-{self.trace_id}-{self.span_id}-"
            f"{'01' if self.sampled else '00'}"
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<SpanContext {self.to_traceparent()}>"


def parse_traceparent(header: str | None) -> SpanContext | None:
    """`00-<trace32>-<span16>-<flags>` -> SpanContext; None on anything
    malformed (a bad header must never break the request carrying it)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    trace_id, span_id, flags = m.groups()
    # all-zero ids are invalid per W3C
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return SpanContext(trace_id, span_id, sampled=flags != "00")


class Span:
    """One recorded operation. `ts` is wall-clock (aligns spans across
    processes), `dur` is measured monotonically (immune to clock steps)."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "kind", "service",
        "ts", "dur", "status", "attrs", "thread", "events",
    )

    def __init__(
        self,
        trace_id: str,
        span_id: str,
        parent_id: str | None,
        name: str,
        kind: str,
        service: str,
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.service = service
        self.ts = time.time()
        self.dur = 0.0
        self.status = "ok"
        self.attrs: dict[str, Any] = {}
        self.thread = threading.get_ident()
        self.events: list[dict[str, Any]] = []

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, sampled=True)

    def set_attr(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def set_status(self, status: str) -> None:
        self.status = status

    def add_event(self, name: str, **attrs: Any) -> None:
        """Attach a point-in-time event to this span (OTel span events):
        a timestamped marker inside an operation — a watchdog alert firing
        mid-round, a retry, a cache refusal — that deserves a place on the
        trace timeline without being an operation of its own."""
        self.events.append({"name": name, "ts": time.time(), "attrs": attrs})

    def to_dict(self) -> dict[str, Any]:
        d = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "kind": self.kind,
            "service": self.service,
            "ts": self.ts,
            "dur": self.dur,
            "status": self.status,
            "attrs": self.attrs,
            "thread": self.thread,
        }
        if self.events:
            d["events"] = self.events
        return d


class _NullSpan:
    """What an unsampled/disabled `span()` yields: absorbs the Span API at
    zero cost. Its `context` is None so callers storing a parent for later
    naturally store nothing."""

    __slots__ = ()
    context = None

    def set_attr(self, **attrs: Any) -> None:
        pass

    def set_status(self, status: str) -> None:
        pass

    def add_event(self, name: str, **attrs: Any) -> None:
        pass


NULL_SPAN = _NullSpan()
_UNSET = object()


class Tracer:
    """Process-wide span collector: ring buffer + optional JSONL sink.

    Env knobs (read once at construction; `configure()` overrides live):
      V6T_TRACE=0          disable entirely (span() is a no-op)
      V6T_TRACE_SAMPLE=x   head-sampling probability at trace roots [0,1]
      V6T_TRACE_FILE=path  append every finished span as a JSONL line
      V6T_TRACE_BUFFER=n   ring size (default 8192; eviction is counted,
                           never an error — tracing must not backpressure
                           the system it measures)
      V6T_TRACE_SERVICE=s  default service label for spans that don't
                           name their component
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._sink_lock = threading.Lock()  # file I/O only, never nested
        self._tls = threading.local()
        self._sink_fh = None
        self.spans_recorded = 0
        self.spans_dropped = 0
        self.sink_errors = 0
        # keyed span taps (flight recorder, tests): called with every
        # finished span dict, outside the buffer lock; a raising tap is
        # dropped silently — observers must never take the data plane down
        self._taps: dict[str, Any] = {}
        # fail-soft env parsing, same stance as malformed traceparents: a
        # typo'd tuning knob falls back to its default instead of killing
        # every process that imports this module (client, server, daemons)
        self.configure(
            enabled=os.environ.get("V6T_TRACE", "1") != "0",
            sample=env_float("V6T_TRACE_SAMPLE", 1.0),
            sink=os.environ.get("V6T_TRACE_FILE") or None,
            buffer_size=env_int("V6T_TRACE_BUFFER", 8192),
            service=os.environ.get("V6T_TRACE_SERVICE", "v6t"),
        )

    def configure(
        self,
        enabled: bool | None = None,
        sample: float | None = None,
        sink: str | None = _UNSET,  # type: ignore[assignment]
        buffer_size: int | None = None,
        service: str | None = None,
    ) -> "Tracer":
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if sample is not None:
                self.sample = min(1.0, max(0.0, float(sample)))
            if service is not None:
                self.service = service
            if buffer_size is not None:
                self._buf: deque[dict[str, Any]] = deque(
                    maxlen=max(1, int(buffer_size))
                )
            if sink is not _UNSET:
                with self._sink_lock:
                    if self._sink_fh is not None:
                        try:
                            self._sink_fh.close()
                        except Exception:
                            pass
                        self._sink_fh = None
                    self.sink = sink
                    # re-pointing (or clearing) the sink is the operator's
                    # heal action: the failure streak it resets is what the
                    # tracer_sink health check keys on — without this, one
                    # transient write error pins /api/health degraded for
                    # the process lifetime
                    self.sink_errors = 0
        return self

    # -------------------------------------------------------------- context
    def _stack(self) -> list[SpanContext]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_context(self) -> SpanContext | None:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def current_traceparent(self) -> str | None:
        ctx = self.current_context()
        return ctx.to_traceparent() if ctx is not None else None

    def inject(self, headers: dict[str, str]) -> dict[str, str]:
        """Add the current context's `traceparent` header (no-op outside a
        trace); returns `headers` for chaining."""
        tp = self.current_traceparent()
        if tp is not None:
            headers.setdefault(TRACEPARENT_HEADER, tp)
        return headers

    # ------------------------------------------------------------------ taps
    def add_tap(self, key: str, fn: Any) -> None:
        """Register (or replace — same key) a span observer: `fn(span_dict)`
        on every finished sampled span. The flight recorder's in-memory
        span ring is one of these."""
        with self._lock:
            self._taps[key] = fn

    def remove_tap(self, key: str) -> None:
        with self._lock:
            self._taps.pop(key, None)

    @staticmethod
    def _resolve(parent: Any) -> SpanContext | None:
        if parent is None:
            return None
        if isinstance(parent, SpanContext):
            return parent
        if isinstance(parent, str):
            return parse_traceparent(parent)
        return getattr(parent, "context", None)

    # ---------------------------------------------------------------- spans
    @contextlib.contextmanager
    def span(
        self,
        name: str,
        kind: str = "internal",
        parent: Any = _UNSET,
        attrs: dict[str, Any] | None = None,
        service: str | None = None,
        require_parent: bool = False,
    ) -> Iterator[Span | _NullSpan]:
        """Record one span around the `with` body.

        `parent` accepts a SpanContext, a traceparent string, a Span, or
        None; left unset, the thread's current span is the parent.
        `require_parent=True` makes the span a no-op when no parent
        resolves — the knob every join-only site (server handler, daemon
        exec, REST hop) uses so background polling never mints root
        traces of its own.
        """
        if not self.enabled:
            yield NULL_SPAN
            return
        ctx = self._resolve(
            self.current_context() if parent is _UNSET else parent
        )
        if ctx is None:
            if require_parent:
                yield NULL_SPAN
                return
            sampled = random.random() < self.sample
            trace_id = secrets.token_hex(16)
            parent_id = None
        else:
            sampled = ctx.sampled
            trace_id = ctx.trace_id
            parent_id = ctx.span_id
        span_id = secrets.token_hex(8)
        stack = self._stack()
        stack.append(SpanContext(trace_id, span_id, sampled))
        if not sampled:
            try:
                yield NULL_SPAN
            finally:
                stack.pop()
            return
        sp = Span(
            trace_id, span_id, parent_id, name, kind,
            service or self.service,
        )
        if attrs:
            sp.attrs.update(attrs)
        t0 = time.perf_counter()
        try:
            yield sp
        except BaseException:
            sp.status = "error"
            raise
        finally:
            sp.dur = time.perf_counter() - t0
            stack.pop()
            self._record(sp)

    def record_span(
        self,
        name: str,
        start_ts: float,
        dur: float,
        parent: Any = None,
        kind: str = "internal",
        attrs: dict[str, Any] | None = None,
        service: str | None = None,
    ) -> SpanContext | None:
        """Retroactively record an already-measured operation (e.g. the
        daemon learns a run's trace context only AFTER the claim fetch that
        must itself be attributed). Returns the new span's context, or None
        when nothing was recorded (disabled / unsampled / no parent)."""
        if not self.enabled:
            return None
        ctx = self._resolve(parent)
        if ctx is None or not ctx.sampled:
            return None
        sp = Span(
            ctx.trace_id, secrets.token_hex(8), ctx.span_id, name, kind,
            service or self.service,
        )
        sp.ts = float(start_ts)
        sp.dur = max(0.0, float(dur))
        if attrs:
            sp.attrs.update(attrs)
        self._record(sp)
        return SpanContext(sp.trace_id, sp.span_id, sampled=True)

    def _record(self, sp: Span) -> None:
        rec = sp.to_dict()
        # serialize OUTSIDE the buffer lock: json.dumps + file I/O under
        # the one process-wide lock would make span completion a global
        # choke point on a slow disk — the backpressure tracing promises
        # never to add. The buffer lock covers only the deque + counters.
        line = json.dumps(rec, default=str) + "\n" if self.sink else None
        with self._lock:
            if (
                self._buf.maxlen is not None
                and len(self._buf) == self._buf.maxlen
            ):
                self.spans_dropped += 1
            self._buf.append(rec)
            self.spans_recorded += 1
            taps = list(self._taps.values()) if self._taps else None
        if taps:
            for tap in taps:
                try:
                    tap(rec)
                except Exception:
                    pass
        if line is not None:
            try:
                with self._sink_lock:
                    if self._sink_fh is None:
                        if not self.sink:  # configure() closed it mid-race
                            return
                        self._sink_fh = open(self.sink, "a", buffering=1)
                    self._sink_fh.write(line)
            except OSError as e:
                # a full/unwritable disk must not take the data plane down
                # with it; the ring buffer still holds the spans. But the
                # loss must be VISIBLE: log once, count it (stats() + the
                # v6t_trace_sink_errors_total series), close the handle.
                with self._sink_lock:
                    self.sink_errors += 1
                    dead, self.sink = self.sink, None
                    if self._sink_fh is not None:
                        try:
                            self._sink_fh.close()
                        except Exception:
                            pass
                        self._sink_fh = None
                import logging

                logging.getLogger("vantage6_tpu/tracing").warning(
                    "trace sink %s disabled after write failure: %s "
                    "(spans continue in the ring buffer)", dead, e,
                )

    # ------------------------------------------------------------ consumers
    def drain(self, trace_id: str | None = None) -> list[dict[str, Any]]:
        """Snapshot (not clear) of buffered spans, optionally one trace."""
        with self._lock:
            spans = list(self._buf)
        if trace_id is not None:
            spans = [s for s in spans if s["trace_id"] == trace_id]
        return spans

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "spans_recorded": self.spans_recorded,
                "spans_dropped": self.spans_dropped,
                "sink_errors": self.sink_errors,
                "buffer_len": len(self._buf),
                "enabled": self.enabled,
                "sample": self.sample,
            }


TRACER = Tracer()


def current_trace_ids() -> tuple[str, str] | None:
    """(trace_id, span_id) of the calling thread's active span, or None.

    The accessor `common.log.TraceContextFilter` binds: every log record
    emitted inside a span carries the ids that correlate it with the trace
    — the join key the flight recorder and `tools/doctor.py` merge on."""
    ctx = TRACER.current_context()
    if ctx is None:
        return None
    return ctx.trace_id, ctx.span_id


# ------------------------------------------------------------- round phases

_profiler_enabled = torch._C._autograd._profiler_enabled
_NO_PHASE = contextlib.nullcontext()
# replays whose phase times the store keeps, the oldest dropped first
PHASE_REPLAYS_KEPT = 4096


class RoundPhases:
    """The parts of a training round, named on the profiler's clock.

    ``phase(name)`` marks one part of a round: a station's forward or
    backward, compression, aggregation, the server step, the fused
    runner's host work. What it does depends on who watches:

    - no ``torch.profiler`` session active and no capture recording
      phases on this thread: nothing (a guard call and an empty
      ``with``, under a microsecond of host time);
    - a profiler session active (``profiling.profile_window``, a traced
      benchmark window): a ``record_function(name)`` range, in the same
      Chrome trace and on the same clock as the kernels it launches;
    - inside ``capturing()`` on the capturing thread (a fused round's CUDA
      graph): a pair of timing events recorded into the graph around the
      phase, once, into the ``CapturedPhases`` the capture yields. Every
      replay runs them as graph nodes; the round reads them after the
      replays made under a profiler (``CapturedPhases``) and keeps each
      phase's milliseconds here, and ``drain`` hands them out.

    The profiler's own state is the switch: no option or environment
    variable turns any of this on or off.
    """

    def __init__(self):
        self._capture = threading.local()  # .phases: this thread's capture
        self._lock = threading.Lock()
        # captured rounds whose last replay ran under a profiler, unread
        self._unread: weakref.WeakSet[CapturedPhases] = weakref.WeakSet()
        self._replays: deque[dict[str, float]] = deque(
            maxlen=PHASE_REPLAYS_KEPT)
        # traced replays not read since the last ``drain``: the next
        # replay of their graph came before they had completed, so the
        # times kept stand for only some of the traced replays
        self.missed = 0

    def phase(self, name: str):
        """A context manager marking the phase ``name`` (see the class)."""
        captured = getattr(self._capture, "phases", None)
        if captured is None and not _profiler_enabled():
            return _NO_PHASE
        return _marked(name, captured)

    @contextlib.contextmanager
    def capturing(self) -> Iterator[CapturedPhases]:
        """Record the phases entered on this thread, until the block ends,
        as event pairs in the stream being captured; yields them."""
        captured = CapturedPhases(self)
        outer = getattr(self._capture, "phases", None)
        self._capture.phases = captured
        try:
            yield captured
        finally:
            self._capture.phases = outer

    def drain(self) -> list[dict[str, float]]:
        """Each read replay's milliseconds by phase, oldest first, every
        round's last traced replay included (waiting for it to complete);
        empties the store and resets ``missed``."""
        with self._lock:
            unread = list(self._unread)
            self._unread.clear()
        for captured in unread:
            captured.collect(wait=True)
        with self._lock:
            out = list(self._replays)
            self._replays.clear()
            self.missed = 0
        return out


class CapturedPhases:
    """One captured round's phases: the ``(name, start, end)`` timing
    event pairs recorded into its graph. The round calls ``collect``
    before each replay and ``replayed`` after it. A replay made under a
    profiler is read at the next ``collect`` if its events have completed
    (a dispatch never waits for them; else the store counts it
    ``missed``), or by ``RoundPhases.drain``, which waits."""

    def __init__(self, store: RoundPhases):
        self.marks: list[tuple[str, Any, Any]] = []
        self._store = store
        self._unread = False

    def replayed(self) -> None:
        """The graph was just replayed: kept to be read if a profiler is
        active."""
        if self.marks and _profiler_enabled():
            store = self._store
            with store._lock:
                self._unread = True
                store._unread.add(self)

    def collect(self, wait: bool = False) -> None:
        """Keep the last traced replay's milliseconds by phase, if it has
        completed on the device (``wait``: once it has); else count it
        missed."""
        store = self._store
        with store._lock:
            unread, self._unread = self._unread, False
        if not unread:
            return
        if wait:
            for _, _, end in self.marks:
                end.synchronize()
        elif not all(end.query() for _, _, end in self.marks):
            with store._lock:
                store.missed += 1
            return
        times: dict[str, float] = {}
        for name, start, end in self.marks:
            times[name] = times.get(name, 0.0) + start.elapsed_time(end)
        with store._lock:
            store._replays.append(times)


@contextlib.contextmanager
def _marked(name: str, captured: CapturedPhases | None) -> Iterator[None]:
    ranged = (torch.profiler.record_function(name) if _profiler_enabled()
              else _NO_PHASE)
    with ranged:
        if captured is None:
            yield
            return
        start = torch.cuda.Event(enable_timing=True, external=True)
        start.record()
        yield
        end = torch.cuda.Event(enable_timing=True, external=True)
        end.record()
        captured.marks.append((name, start, end))


PHASES = RoundPhases()
phase = PHASES.phase


class DeviceCounters:
    """Counts a round keeps on the card while a profiler watches.

    ``add(name, values)`` adds a tensor of counts into ``name``'s running
    total, on the tensor's device: one kernel and no read on the host, so
    a round runs on as it would. With no ``torch.profiler`` session active
    it does nothing, as ``phase`` does. ``drain`` hands out the totals,
    still on the card, and empties the store: a reader copies them to the
    host after its traced window."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals: dict[str, torch.Tensor] = {}

    def add(self, name: str, values: torch.Tensor) -> None:
        if not _profiler_enabled():
            return
        with self._lock:
            total = self._totals.get(name)
            if total is None:
                self._totals[name] = values.detach().to(torch.int64,
                                                        copy=True)
            else:
                total.add_(values)

    def drain(self) -> dict[str, torch.Tensor]:
        with self._lock:
            out, self._totals = self._totals, {}
        return out


COUNTERS = DeviceCounters()


# ------------------------------------------------------------------- export


def to_trace_events(spans: list[dict[str, Any]]) -> dict[str, Any]:
    """Chrome/Perfetto `trace_event` JSON: one pid lane per service, one
    tid lane per emitting thread, complete ("X") events in microseconds.
    Load the result in ui.perfetto.dev / chrome://tracing and a federated
    round reads as one timeline."""
    pids: dict[str, int] = {}
    tids: dict[tuple[int, Any], int] = {}
    events: list[dict[str, Any]] = []
    for sp in sorted(spans, key=lambda s: s["ts"]):
        service = sp.get("service") or "v6t"
        if service not in pids:
            pids[service] = len(pids) + 1
            events.append({
                "name": "process_name", "ph": "M", "pid": pids[service],
                "tid": 0, "args": {"name": service},
            })
        pid = pids[service]
        tkey = (pid, sp.get("thread"))
        if tkey not in tids:
            tids[tkey] = sum(1 for k in tids if k[0] == pid) + 1
        events.append({
            "name": sp["name"],
            "cat": sp.get("kind", "internal"),
            "ph": "X",
            "ts": sp["ts"] * 1e6,
            "dur": max(0.0, sp.get("dur", 0.0)) * 1e6,
            "pid": pid,
            "tid": tids[tkey],
            "args": {
                "trace_id": sp["trace_id"],
                "span_id": sp["span_id"],
                "parent_id": sp.get("parent_id"),
                "status": sp.get("status", "ok"),
                **(sp.get("attrs") or {}),
            },
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _pct(sorted_vals: list[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(p / 100 * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def summarize(spans: list[dict[str, Any]]) -> dict[str, Any]:
    """Per-hop latency table: for each span name, count/p50/p95/max/total
    (ms), plus a straggler call-out — the station (organization/node/
    station attr) whose exec spans cost the most total time."""
    by_name: dict[str, list[float]] = {}
    exec_by_station: dict[str, float] = {}
    traces: set[str] = set()
    errors = 0
    exec_total = 0.0
    by_id = {
        (sp["trace_id"], sp.get("span_id")): sp
        for sp in spans
        if sp.get("span_id")
    }

    def has_exec_ancestor(sp: dict[str, Any]) -> bool:
        # nested exec spans (a central's runner.exec stays open while its
        # partials record their own) must not double-count wall-clock in
        # exec_total — only TOP-LEVEL exec spans contribute
        cur, hops = sp, 0
        while hops < 1000:  # malformed-parent-chain guard
            pid = cur.get("parent_id")
            if not pid:
                return False
            parent = by_id.get((cur["trace_id"], pid))
            if parent is None:
                return False
            if parent.get("kind") == "exec":
                return True
            cur, hops = parent, hops + 1
        return False

    for sp in spans:
        traces.add(sp["trace_id"])
        by_name.setdefault(sp["name"], []).append(sp.get("dur", 0.0))
        if sp.get("status") == "error":
            errors += 1
        if sp.get("kind") == "exec":
            if not has_exec_ancestor(sp):
                exec_total += sp.get("dur", 0.0)
            attrs = sp.get("attrs") or {}
            station = attrs.get("organization_id")
            if station is None:
                station = attrs.get("station", attrs.get("node_id"))
            if station is not None:
                exec_by_station[str(station)] = (
                    exec_by_station.get(str(station), 0.0)
                    + sp.get("dur", 0.0)
                )
    table = {}
    for name, durs in sorted(by_name.items()):
        durs = sorted(durs)
        table[name] = {
            "count": len(durs),
            "p50_ms": round(_pct(durs, 50) * 1e3, 3),
            "p95_ms": round(_pct(durs, 95) * 1e3, 3),
            "max_ms": round(durs[-1] * 1e3, 3),
            "total_ms": round(sum(durs) * 1e3, 3),
        }
    straggler = None
    if exec_by_station:
        worst = max(exec_by_station, key=exec_by_station.get)
        straggler = {
            "station": worst,
            "exec_total_ms": round(exec_by_station[worst] * 1e3, 3),
            "per_station_exec_ms": {
                k: round(v * 1e3, 3)
                for k, v in sorted(exec_by_station.items())
            },
        }
    # gradient-compression call-out (docs/compression.md): how much of the
    # round the device.compress/decompress ops cost, against the exec
    # total — the "<10% of round time" acceptance number, read directly
    # off a trace instead of re-derived per bench
    compression = None
    c = table.get("device.compress")
    d = table.get("device.decompress")
    if c or d:
        total_ms = (c or {}).get("total_ms", 0.0) + (d or {}).get(
            "total_ms", 0.0
        )
        compression = {
            "compress_total_ms": (c or {}).get("total_ms", 0.0),
            "decompress_total_ms": (d or {}).get("total_ms", 0.0),
            "pct_of_exec": (
                round(100.0 * total_ms / (exec_total * 1e3), 2)
                if exec_total > 0
                else None
            ),
        }
    # device-plane call-out (docs/observability.md "device plane"): what
    # the round paid BELOW jit — compiles (with the XLA memory/cost
    # introspection the observatory stamps on each span), named retraces,
    # and any profiler windows — read directly off the trace
    device_plane = None
    compile_spans = [s for s in spans if s.get("name") == "device.compile"]
    profile_spans = [s for s in spans if s.get("name") == "device.profile"]
    if compile_spans or profile_spans:
        retraces = []
        by_fn: dict[str, dict[str, Any]] = {}
        peak_temp = 0
        total_flops = 0.0
        for sp in compile_spans:
            attrs = sp.get("attrs") or {}
            fn = str(attrs.get("function") or "?")
            row = by_fn.setdefault(
                fn, {"compiles": 0, "retraces": 0, "total_ms": 0.0}
            )
            row["compiles"] += 1
            row["total_ms"] = round(
                row["total_ms"] + sp.get("dur", 0.0) * 1e3, 3
            )
            if attrs.get("retrace"):
                row["retraces"] += 1
                retraces.append({
                    "function": fn,
                    "changed": attrs.get("changed"),
                })
            tb = attrs.get("temp_bytes")
            if isinstance(tb, (int, float)):
                peak_temp = max(peak_temp, int(tb))
            fl = attrs.get("flops")
            if isinstance(fl, (int, float)):
                total_flops += float(fl)
        device_plane = {
            "n_compiles": len(compile_spans),
            "n_retraces": len(retraces),
            "compile_total_ms": round(
                sum(s.get("dur", 0.0) for s in compile_spans) * 1e3, 3
            ),
            "peak_temp_bytes": peak_temp,
            "total_flops": total_flops,
            "by_function": by_fn,
            "retraces": retraces,
            "profile_windows": [
                (s.get("attrs") or {}).get("log_dir")
                for s in profile_spans
            ],
        }
    # learning-plane call-out (docs/observability.md "learning plane"):
    # the convergence trajectory and worst-station signal read straight
    # off the learning.round spans the RoundHistory emits per round
    learning_plane = None
    learning_spans = [s for s in spans if s.get("name") == "learning.round"]
    if learning_spans:
        # trajectories are PER TASK: summarize() accepts multi-trace
        # input, and a first->last norm computed across interleaved
        # tasks' rounds would fabricate a convergence number from
        # unrelated runs (same cross-task stance as anomalous_station)
        by_task: dict[str, list[dict[str, Any]]] = {}
        for s in learning_spans:
            by_task.setdefault(
                str((s.get("attrs") or {}).get("task")), []
            ).append(s)

        def _key(s: dict[str, Any]):
            a = s.get("attrs") or {}
            r = a.get("round")
            return (0, r) if isinstance(r, (int, float)) else (1, s.get("ts") or 0)

        tasks = []
        for task, t_spans in by_task.items():
            t_spans.sort(key=_key)
            norms = [
                (s.get("attrs") or {}).get("update_norm")
                for s in t_spans
            ]
            norms = [n for n in norms if isinstance(n, (int, float))]
            worst_cos = None
            worst_station = None
            for s in t_spans:
                a = s.get("attrs") or {}
                c = a.get("min_cos")
                if isinstance(c, (int, float)) and (
                    worst_cos is None or c < worst_cos
                ):
                    worst_cos = c
                    worst_station = a.get("min_cos_station")
            losses = [
                (s.get("attrs") or {}).get("loss") for s in t_spans
            ]
            losses = [v for v in losses if isinstance(v, (int, float))]
            tasks.append({
                "task": task,
                "n_rounds": len(t_spans),
                "first_update_norm": norms[0] if norms else None,
                "last_update_norm": norms[-1] if norms else None,
                "norm_decay_pct": (
                    round(100.0 * (1.0 - norms[-1] / norms[0]), 2)
                    if len(norms) > 1 and norms[0] else None
                ),
                "min_station_cos": worst_cos,
                "min_cos_station": worst_station,
                "last_loss": losses[-1] if losses else None,
            })
        tasks.sort(key=lambda t: -t["n_rounds"])
        learning_plane = {
            "n_rounds": len(learning_spans),
            "tasks": tasks,
        }
    # per-replica call-out (docs/control_plane.md "running N replicas"):
    # every server span carries the replica that served it, so a merged
    # multi-replica trace file attributes request latency per replica —
    # the load-balance / hot-replica readout for horizontal scale-out
    replicas = None
    by_replica: dict[str, dict[str, Any]] = {}
    for sp in spans:
        if sp.get("kind") != "server":
            continue
        rid = (sp.get("attrs") or {}).get("replica")
        if rid is None:
            continue
        row = by_replica.setdefault(
            str(rid), {"count": 0, "errors": 0, "total_ms": 0.0}
        )
        row["count"] += 1
        if sp.get("status") == "error":
            row["errors"] += 1
        row["total_ms"] = round(
            row["total_ms"] + sp.get("dur", 0.0) * 1e3, 3
        )
    if by_replica:
        total = sum(r["count"] for r in by_replica.values())
        for row in by_replica.values():
            row["share_pct"] = round(100.0 * row["count"] / total, 2)
        replicas = {
            "n_replicas": len(by_replica),
            "by_replica": dict(sorted(by_replica.items())),
        }
    return {
        "n_spans": len(spans),
        "n_traces": len(traces),
        "n_errors": errors,
        "spans": table,
        "straggler": straggler,
        "compression": compression,
        "device_plane": device_plane,
        "learning_plane": learning_plane,
        "replicas": replicas,
    }


def read_spans(path: str) -> list[dict[str, Any]]:
    """Read a JSONL span sink, skipping blank and partial lines (a process
    killed mid-write leaves a torn tail; the trace that DID land must stay
    readable)."""
    out: list[dict[str, Any]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and "trace_id" in rec:
                out.append(rec)
    return out


# telemetry: the tracer reports its own health (recorded/dropped/buffer)
# through the unified registry so /metrics shows whether tracing is lossy
def _tracer_collector() -> dict[str, float]:
    s = TRACER.stats()
    return {
        "v6t_trace_spans_recorded_total": s["spans_recorded"],
        "v6t_trace_spans_dropped_total": s["spans_dropped"],
        "v6t_trace_sink_errors_total": s["sink_errors"],
        "v6t_trace_buffer_len": s["buffer_len"],
        "v6t_trace_enabled": 1.0 if s["enabled"] else 0.0,
    }


from vantage6_tpu_torch.common.telemetry import REGISTRY as _REGISTRY  # noqa: E402

_REGISTRY.register_collector("tracing", _tracer_collector)
