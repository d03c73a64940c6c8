"""Flight recorder: bounded in-process rings of recent activity + crash dump.

A failed federated round used to be diagnosable only by re-running it
under `V6T_TRACE` with a JSONL sink configured — the evidence of the
FIRST failure was gone. This module keeps the evidence, always:

- **Rings** — every process holds bounded deques of its recent activity:
  log records (tapped by `common.log`'s `_FlightTapHandler`), finished
  spans (a `runtime.tracing` tap, registered on import), free-form
  ops notes (REST failures, event-poll errors, watchdog alerts — see
  :meth:`FlightRecorder.note`), and telemetry snapshots (the watchdog
  appends one per evaluation). Appends are O(1) deque pushes; the rings
  cost memory, never latency.
- **Dump** — :meth:`FlightRecorder.dump` serializes everything into ONE
  JSONL bundle (`{"type": "log"|"span"|"note"|"metrics"|...}` per line)
  plus a fresh telemetry snapshot and, when a watchdog is live, its
  active alerts. Triggered by: a fatal error (sys/threading excepthook,
  via :func:`install`), `kill -USR2` (same), `POST /api/debug/dump` on
  the server, or an explicit call.
- **Doctor** — `tools/doctor.py` merges a bundle into one correlated
  timeline: logs interleaved with spans by trace_id/wall-clock, alerts
  explained against the watchdog rule catalog.

Env knobs: `V6T_FLIGHT_DIR` (bundle directory, default the system temp
dir), `V6T_FLIGHT_BUFFER` (per-ring capacity, default 2048).

The port's copy of ``vantage6_tpu/common/flight.py``: framework-free, the
same rings, record types and bundle layout, so ``tools/doctor.py`` reads
the port's bundles too. One difference: the port has no watchdog yet, so
a dump carries no ``alert`` records (the JAX module appends the
watchdog's active alerts when one is live).
"""
from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
from collections import deque
from typing import Any

from vantage6_tpu_torch.common.env import env_int


class FlightRecorder:
    """Per-process bounded recording of logs, spans, notes and metrics."""

    def __init__(self, capacity: int | None = None):
        cap = max(64, capacity if capacity is not None
                  else env_int("V6T_FLIGHT_BUFFER", 2048))
        self.capacity = cap
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._logs: deque[dict[str, Any]] = deque(maxlen=cap)
        self._spans: deque[dict[str, Any]] = deque(maxlen=cap)
        self._notes: deque[dict[str, Any]] = deque(maxlen=cap)
        # metric snapshots are heavyweight relative to the others: a much
        # smaller ring still gives the dump a before/after trajectory
        self._metrics: deque[dict[str, Any]] = deque(maxlen=max(8, cap // 64))
        self.service = os.environ.get("V6T_TRACE_SERVICE", "v6t")
        self.dumps_written = 0
        self.dump_errors = 0

    # -------------------------------------------------------------- feeders
    def record_log(self, rec: dict[str, Any]) -> None:
        with self._lock:
            self._logs.append(rec)

    def record_span(self, rec: dict[str, Any]) -> None:
        with self._lock:
            self._spans.append(rec)

    def note(self, kind: str, **fields: Any) -> None:
        """Record one ops event (REST failure, event-poll error, alert
        transition, request anomaly). `kind` is a short snake_case tag the
        doctor groups by."""
        rec = {"ts": time.time(), "kind": kind, **fields}
        with self._lock:
            self._notes.append(rec)

    def snapshot_metrics(self, snap: dict | None = None) -> None:
        """Append a unified-telemetry snapshot to the metrics ring (the
        watchdog calls this once per evaluation, giving dumps a short
        metric history, not just the final state). Pass ``snap`` to reuse
        an already-taken snapshot — every collector callback runs under
        its component's lock, so a caller that just snapshotted should
        not pay (or inflict) that twice per tick."""
        if snap is None:
            try:
                from vantage6_tpu_torch.common.telemetry import REGISTRY

                snap = REGISTRY.snapshot()
            except Exception:  # pragma: no cover - must not break taps
                return
        with self._lock:
            self._metrics.append({"ts": time.time(), "values": snap})

    # ------------------------------------------------------------- consumers
    def recent_notes(
        self, since: float = 0.0, limit: int = 256
    ) -> list[dict[str, Any]]:
        """Notes strictly newer than ``since`` (oldest-first, bounded) —
        the fleet push path's delta read. The rings stay private; this is
        the one sanctioned incremental reader beside dump()."""
        with self._lock:
            out = [r for r in self._notes if r.get("ts", 0.0) > since]
        return out[-limit:]

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "logs": len(self._logs),
                "spans": len(self._spans),
                "notes": len(self._notes),
                "metrics": len(self._metrics),
                "dumps_written": self.dumps_written,
                "dump_errors": self.dump_errors,
            }

    def clear(self) -> None:
        with self._lock:
            for ring in (self._logs, self._spans, self._notes, self._metrics):
                ring.clear()

    def dump(
        self,
        path: str | None = None,
        reason: str = "manual",
        detail: str = "",
    ) -> str | None:
        """Write the bundle; returns its path, or None when even the dump
        failed (counted — a recorder that cannot write must not crash the
        crashing process it is documenting)."""
        if path is None:
            base = os.environ.get("V6T_FLIGHT_DIR") or None
            if base is None:
                import tempfile

                base = tempfile.gettempdir()
            os.makedirs(base, exist_ok=True)
            safe_service = re.sub(r"[^A-Za-z0-9._-]+", "_", self.service)
            path = os.path.join(
                base,
                f"v6t-flight-{safe_service}-{os.getpid()}-"
                f"{int(time.time() * 1000)}-{reason}.jsonl",
            )
        with self._lock:
            logs = list(self._logs)
            spans = list(self._spans)
            notes = list(self._notes)
            metrics = list(self._metrics)
        records: list[dict[str, Any]] = [{
            "type": "flight_header",
            "ts": time.time(),
            "service": self.service,
            "pid": os.getpid(),
            "reason": reason,
            "detail": detail,
            "counts": {
                "log": len(logs), "span": len(spans), "note": len(notes),
                "metrics": len(metrics),
            },
        }]
        records += [{"type": "log", **r} for r in logs]
        records += [{"type": "span", **r} for r in spans]
        records += [{"type": "note", **r} for r in notes]
        records += [{"type": "metrics", **r} for r in metrics]
        # final-state extra, best-effort: a fresh telemetry snapshot (the
        # recorder itself does not depend on telemetry)
        try:
            from vantage6_tpu_torch.common.telemetry import REGISTRY

            records.append({
                "type": "metrics", "ts": time.time(), "final": True,
                "values": REGISTRY.snapshot(),
            })
        except Exception:
            pass
        # learning-plane final state: each tracked task's convergence
        # summary (the per-round evidence rides the notes ring; this
        # survives even when the ring evicted the early rounds) — what
        # the doctor's learning digest anchors its trajectory on
        try:
            from vantage6_tpu_torch.runtime.learning import LEARNING

            for summary in LEARNING.summaries():
                if summary.get("rounds"):
                    records.append({
                        "type": "learning", "ts": time.time(), **summary,
                    })
        except Exception:
            pass
        try:
            with open(path, "w") as fh:
                for rec in records:
                    fh.write(json.dumps(rec, default=str) + "\n")
        except OSError:
            with self._lock:
                self.dump_errors += 1
            return None
        with self._lock:
            self.dumps_written += 1
        return path


FLIGHT = FlightRecorder()


def read_bundle(path: str) -> list[dict[str, Any]]:
    """Read a dump bundle, skipping blank/torn lines (same stance as
    `tracing.read_spans`: a dump interrupted mid-write must still yield
    the records that DID land)."""
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
            if isinstance(rec, dict) and "type" in rec:
                out.append(rec)
    return out


# ------------------------------------------------------- process-level hooks

_INSTALL_LOCK = threading.Lock()
_installed = False
_service_named = False
_usr2_armed = False


def install(service: str | None = None) -> FlightRecorder:
    """Arm the process-level dump triggers (idempotent). The FIRST caller
    to pass a service names the process-wide recorder; later installers
    (e.g. daemons started inside a server process in tests/benches) keep
    the original label instead of last-writer-wins mislabeling bundles.

    - `sys.excepthook` / `threading.excepthook`: dump on any uncaught
      exception, then chain to the previous hook — the bundle exists
      BEFORE the traceback scrolls away.
    - `SIGUSR2`: dump on demand from outside (`kill -USR2 <pid>`), the
      classic "what is this process doing right now" probe. Skipped
      quietly off the main thread or on platforms without the signal —
      and retried on the next install() call, so a background-thread
      first installer (a daemon starting inside an embedder) doesn't
      permanently disarm the probe for a later main-thread one.

    Servers arm this in `run_server`, daemons in `NodeDaemon.start`; bare
    library use stays un-hooked unless the embedder opts in.
    """
    global _installed, _service_named, _usr2_armed
    if service:
        with _INSTALL_LOCK:
            if not _service_named:
                FLIGHT.service = service
                _service_named = True
    with _INSTALL_LOCK:
        if not _usr2_armed:
            try:
                import signal

                def _usr2(_signum, _frame):
                    # dump from a WORKER thread: the handler interrupts
                    # the main thread between bytecodes, possibly inside
                    # record_log/note with the non-reentrant FLIGHT._lock
                    # held — dumping inline would deadlock the very
                    # process the probe is meant to diagnose
                    threading.Thread(
                        target=lambda: FLIGHT.dump(reason="sigusr2"),
                        daemon=True, name="v6t-flight-usr2",
                    ).start()

                signal.signal(signal.SIGUSR2, _usr2)
                _usr2_armed = True
            except (ValueError, AttributeError, OSError):
                # not the main thread, or no SIGUSR2 on this platform
                pass
        if _installed:
            return FLIGHT
        _installed = True

        prev_excepthook = sys.excepthook

        def _fatal_hook(exc_type, exc, tb):
            try:
                FLIGHT.dump(
                    reason="fatal",
                    detail=f"{exc_type.__name__}: {exc}",
                )
            except Exception:
                pass
            prev_excepthook(exc_type, exc, tb)

        sys.excepthook = _fatal_hook

        prev_thread_hook = threading.excepthook

        def _thread_hook(args):
            # SystemExit from a worker is shutdown, not a crash
            if args.exc_type is not SystemExit:
                try:
                    FLIGHT.dump(
                        reason="thread-fatal",
                        detail=(
                            f"{args.exc_type.__name__}: {args.exc_value} "
                            f"in {getattr(args.thread, 'name', '?')}"
                        ),
                    )
                except Exception:
                    pass
            prev_thread_hook(args)

        threading.excepthook = _thread_hook
    return FLIGHT


# ------------------------------------------------------------------ wiring
# span tap: every finished span joins the ring (keyed — a reload replaces
# itself instead of double-recording)
try:
    from vantage6_tpu_torch.runtime.tracing import TRACER as _TRACER

    _TRACER.add_tap("flight", FLIGHT.record_span)
except Exception:  # pragma: no cover - tracing must stay optional here
    pass


def _flight_collector() -> dict[str, float]:
    s = FLIGHT.stats()
    return {
        "v6t_flight_records": float(
            s["logs"] + s["spans"] + s["notes"] + s["metrics"]
        ),
        "v6t_flight_dumps_total": float(s["dumps_written"]),
    }


try:
    from vantage6_tpu_torch.common.telemetry import REGISTRY as _REGISTRY

    _REGISTRY.register_collector("flight", _flight_collector)
except Exception:  # pragma: no cover
    pass
