"""Fleet telemetry push path: compact snapshots shipped to the server.

Every observability plane so far (tracing, watchdog/flight, device
observatory, learning plane) is process-local: each daemon and each
Federation process serves its own `/api/metrics` and keeps its own
flight rings, and `tools/doctor.py` only unifies the fleet *after the
fact* by merging dumped bundles. This module is the live half: any
process with a REST path to the server periodically ships a **compact
telemetry snapshot + flight-note deltas** to `POST /api/telemetry`,
where `server/fleet.py` lands them in the shared `fleet_metric` /
`fleet_event` tables — so N replicas over one store serve ONE coherent
fleet view at `GET /api/fleet`, and the watchdog's SLO engine evaluates
burn rates over cross-host history instead of one process's memory.

Pieces:

- :func:`build_snapshot` — source-stamped compact form of
  ``REGISTRY.snapshot()`` (scalars kept, histograms folded to their
  cumulative ``_sum``/``_count``) plus the flight notes newer than the
  previous push (the delta contract: notes ship once, not per push).
- :func:`encode_push` / :func:`decode_push` — the wire envelope. The
  snapshot is wire-v2 encoded (``serialization.serialize``) and rides
  base64 inside a JSON body: the pooled REST transport is JSON-only by
  design, and a base64 detour keeps the push on the same audited
  transport (auth, retries, fault injection) as every other call.
- :class:`FleetPusher` — the periodic client embedded in the daemon's
  ping/sync worker and the Federation round loop. Capability-pinned:
  the first 404/405 from an old server pins pushing off for the
  process lifetime (same idiom as the daemon's batch-claim pin), so a
  new daemon against a pre-fleet server degrades to a no-op instead of
  spamming errors.

Env knob: ``V6T_FLEET_PUSH_INTERVAL`` (seconds between pushes,
default 15; also the staleness unit the server-side freshness view is
calibrated against).

The port's copy of ``vantage6_tpu/common/fleet.py``: the same payload and
envelope over the port's wire v2 (a push one package encodes, the other
decodes), wired into the port's ``Federation`` at its round boundaries.
The server half (``server/fleet.py``) and the daemon's pusher come with
the server and the node.
"""
from __future__ import annotations

import base64
import threading
import time
from typing import Any, Callable

from vantage6_tpu_torch.common.env import env_float
from vantage6_tpu_torch.common.telemetry import REGISTRY, metric_kind

DEFAULT_PUSH_INTERVAL = 15.0


def push_interval(default: float | None = None) -> float:
    """The configured push cadence (floor 0.05 s so tests can go fast
    without a zero-interval busy loop)."""
    base = default if default is not None else DEFAULT_PUSH_INTERVAL
    return max(0.05, env_float("V6T_FLEET_PUSH_INTERVAL", base))


def compact_metrics(snap: dict[str, Any] | None = None) -> dict[str, float]:
    """Flatten a registry snapshot to shippable scalars: counters and
    gauges as-is, histograms folded to cumulative ``_sum``/``_count``
    (the census and rate math downstream need totals, not buckets)."""
    if snap is None:
        snap = REGISTRY.snapshot()
    out: dict[str, float] = {}
    for name, value in snap.items():
        if isinstance(value, bool):
            continue
        if isinstance(value, (int, float)):
            out[name] = float(value)
        elif isinstance(value, dict) and "count" in value:
            out[name + "_sum"] = float(value.get("sum") or 0.0)
            out[name + "_count"] = float(value.get("count") or 0)
    return out


def sample_kind(name: str) -> str:
    """Declared kind of a compacted series; histogram-derived ``_sum``/
    ``_count`` series are cumulative, i.e. counters. Undeclared names
    default to gauge (the conservative merge: no cross-source summing)."""
    kind = metric_kind(name)
    if kind in ("counter", "gauge"):
        return kind
    if name.endswith(("_sum", "_count")) and metric_kind(
        name.rsplit("_", 1)[0]
    ) == "histogram":
        return "counter"
    return "gauge"


def build_snapshot(
    source: str,
    service: str,
    seq: int,
    notes_since: float = 0.0,
    snap: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """One push payload: who, how fresh, the compact metric census, and
    the flight-note delta since the previous push."""
    notes: list[dict[str, Any]] = []
    try:
        from vantage6_tpu_torch.common.flight import FLIGHT

        notes = FLIGHT.recent_notes(since=notes_since)
    except Exception:  # the push must not depend on the recorder
        pass
    return {
        "source": source,
        "service": service,
        "seq": int(seq),
        "ts": time.time(),
        "metrics": compact_metrics(snap),
        "notes": notes,
    }


def encode_push(payload: dict[str, Any]) -> dict[str, Any]:
    """Wire-v2 encode the payload and wrap it for the JSON transport."""
    from vantage6_tpu_torch.common.serialization import serialize

    return {
        "blob": base64.b64encode(serialize(payload)).decode("ascii"),
        "encoding": "wire+b64",
    }


def decode_push(body: dict[str, Any]) -> dict[str, Any]:
    """Inverse of :func:`encode_push`; raises ValueError on anything
    that does not decode to a source-stamped snapshot dict."""
    from vantage6_tpu_torch.common.serialization import deserialize

    blob = body.get("blob") if isinstance(body, dict) else None
    if not isinstance(blob, str):
        raise ValueError("telemetry push body must carry a base64 'blob'")
    try:
        payload = deserialize(base64.b64decode(blob.encode("ascii")))
    except Exception as e:
        raise ValueError(f"undecodable telemetry blob: {e}") from None
    if not isinstance(payload, dict) or not payload.get("source"):
        raise ValueError("telemetry payload must be a dict with a 'source'")
    return payload


class FleetPusher:
    """Periodic snapshot shipper riding an existing request path.

    ``request`` is the embedder's REST callable — the daemon's
    replica-rotating :meth:`NodeDaemon.request`, or a bound
    ``RestSession.request`` — invoked as
    ``request("post", "telemetry", json_body=envelope)``. Everything
    here is fail-soft: a push failure is a counter + flight note, never
    an exception into the ping/sync loop that hosts us.
    """

    def __init__(
        self,
        source: str,
        service: str,
        request: Callable[..., Any],
        interval: float | None = None,
    ):
        self.source = source
        self.service = service
        self.interval = push_interval(interval)
        self._request = request
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: _lock
        self._notes_since = 0.0  # guarded-by: _lock
        self._next_at = 0.0  # guarded-by: _lock (monotonic)
        # None = unknown, False = pinned off (pre-fleet server), True = ok
        self.supported: bool | None = None  # guarded-by: _lock
        self.last_error: str | None = None  # guarded-by: _lock

    def due(self, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            return self.supported is not False and now >= self._next_at

    def maybe_push(self) -> bool:
        """Push iff the interval elapsed and the server supports it."""
        if not self.due():
            return False
        return self.push()

    def push(self) -> bool:
        """One push now. Returns True on an accepted snapshot."""
        from vantage6_tpu_torch.common.rest import RestError

        with self._lock:
            if self.supported is False:
                return False
            seq = self._seq
            notes_since = self._notes_since
            # schedule the next attempt up front: a crashing/slow server
            # must not turn every sync tick into a push retry
            self._next_at = time.monotonic() + self.interval
        payload = build_snapshot(
            self.source, self.service, seq, notes_since=notes_since
        )
        try:
            self._request("post", "telemetry", json_body=encode_push(payload))
        except RestError as e:
            if e.status in (404, 405):
                # pre-fleet server: pin off for the process lifetime
                # (same capability idiom as the daemon's batch-claim pin)
                with self._lock:
                    self.supported = False
                    self.last_error = f"pinned off: HTTP {e.status}"
                REGISTRY.counter("v6t_fleet_push_unsupported_total").inc()
                self._note("fleet_push_unsupported", status=e.status)
                return False
            self._record_error(f"HTTP {e.status}: {e.msg}")
            return False
        except Exception as e:
            self._record_error(f"{type(e).__name__}: {e}")
            return False
        newest = max(
            (n.get("ts", 0.0) for n in payload["notes"]), default=notes_since
        )
        with self._lock:
            self.supported = True
            self.last_error = None
            self._seq = seq + 1
            self._notes_since = max(self._notes_since, newest)
        REGISTRY.counter("v6t_fleet_pushes_total").inc()
        return True

    def _record_error(self, detail: str) -> None:
        with self._lock:
            self.last_error = detail
        REGISTRY.counter("v6t_fleet_push_errors_total").inc()
        self._note("fleet_push_failed", error=detail)

    def _note(self, kind: str, **fields: Any) -> None:
        try:
            from vantage6_tpu_torch.common.flight import FLIGHT

            FLIGHT.note(kind, source=self.source, **fields)
        except Exception:  # pragma: no cover
            pass
