"""Structured per-round metrics and device memory.

The reference's observability is logs only (SURVEY.md §5); this adds the
structured layer the BASELINE methodology needs: JSONL round metrics
(rounds/sec, per-round step time, loss). Profiler traces of chosen rounds
are ``runtime.profiling.profile_window``'s.

Counterpart of ``vantage6_tpu/runtime/metrics.py``: device memory comes
from ``torch.cuda`` per visible card.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path
from typing import Any, Iterator

import torch


class MetricsLogger:
    """Append-only JSONL metrics, one object per event.

    Resource handling: usable as a context manager, `close()` is
    idempotent, and `log()` after close is a counted no-op instead of a
    ValueError on the closed handle — a late-finishing worker thread
    logging into a torn-down logger must not crash the run it outlives
    (the dropped-event count is inspectable: `dropped_after_close`).
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)
        self._round_t0: float | None = None
        self._closed = False
        # the closed-check and the write must be one atomic step: the
        # tolerated caller is a WORKER THREAD racing the owning thread's
        # close() — an unlocked check-then-act would still crash on the
        # just-closed handle
        self._close_lock = threading.Lock()
        self.dropped_after_close = 0

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def log(self, event: str, **fields: Any) -> None:
        rec = {"ts": time.time(), "event": event, **fields}
        line = json.dumps(rec, default=_tolerant) + "\n"
        with self._close_lock:
            if self._closed:
                self.dropped_after_close += 1
                return
            self._fh.write(line)

    @contextlib.contextmanager
    def round_timer(
        self, round_index: int, rounds_per_dispatch: int = 1
    ) -> Iterator[None]:
        """Time one host dispatch. ``rounds_per_dispatch`` is the number
        of LOGICAL federated rounds the dispatch amortizes (the fused
        program's K): throughput is attributed per logical round, so a
        fused K-round program and K sequential dispatches report
        comparable ``rounds_per_sec``."""
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        fields: dict[str, Any] = dict(
            round=round_index, seconds=dt,
            rounds_per_sec=rounds_per_dispatch / dt if dt > 0 else None,
            rounds_per_dispatch=rounds_per_dispatch,
        )
        per = device_memory_all()
        peaks = [d["peak_bytes"] for d in per if d.get("peak_bytes")]
        if peaks:
            # worst device first (the one that OOMs), the full census
            # beside it — a skewed shard shows up as one hot device
            fields["device_peak_bytes"] = max(peaks)
            if len(per) > 1:
                fields["per_device_peak_bytes"] = {
                    str(d["id"]): d["peak_bytes"] for d in per
                    if d.get("peak_bytes")
                }
        self.log("round", **fields)

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return  # double-close is a no-op, not an error
            self._closed = True
            self._fh.close()


def run_lifecycle(run: Any) -> dict[str, Any]:
    """queued→started→finished decomposition of one host-path Run.

    ``queue_wait_s`` is the time the run sat on the station executor before
    a worker started it; ``exec_s`` the time inside the algorithm. Both are
    what the straggler view (``round_decomposition``) aggregates.
    """
    out: dict[str, Any] = {
        "run_id": run.id,
        "station": run.station_index,
        "status": getattr(run.status, "value", str(run.status)),
        "queued_at": run.queued_at,
        "started_at": run.started_at,
        "finished_at": run.finished_at,
    }
    queued = run.queued_at if run.queued_at is not None else run.assigned_at
    if run.started_at is not None:
        # a run can start with NO queue timestamp at all (synchronous
        # dispatch predating mark_queued, or a record missing assigned_at):
        # report what is known instead of raising on the None arithmetic
        if queued is not None:
            out["queue_wait_s"] = max(0.0, run.started_at - queued)
        if run.finished_at is not None:
            out["exec_s"] = run.finished_at - run.started_at
    # control-plane dispatch latency: assignment (task creation fanned the
    # run out) → execution start. On the host path this equals
    # queue_wait_s; on the daemon path it additionally contains event
    # propagation + claim round-trips — the quantity the control_plane
    # bench leg drives down
    assigned = getattr(run, "assigned_at", None)
    if assigned is not None and run.started_at is not None:
        out["dispatch_latency_s"] = max(0.0, run.started_at - assigned)
    # on-wire payload sizes (estimated v2 frame bytes, see
    # serialization.wire_nbytes) — present when the federation measured
    # them; the straggler view uses these to tell a station that computes
    # slowly from one that moves big payloads
    if getattr(run, "input_wire_bytes", None) is not None:
        out["input_wire_bytes"] = run.input_wire_bytes
    if getattr(run, "result_wire_bytes", None) is not None:
        out["result_wire_bytes"] = run.result_wire_bytes
    return out


def round_decomposition(runs: list[Any]) -> dict[str, Any]:
    """Max-vs-sum round-time decomposition over a task's runs.

    A sequential host path pays ``sum_exec_s`` of wall-clock per round; a
    parallel one pays ``span_s`` (bounded below by ``max_exec_s``, the
    straggler — per-round wall-clock is max-over-stations, not
    sum-over-stations). ``parallel_speedup_bound`` = sum/max is the best
    speedup any scheduler could extract from these runs.
    """
    spans = [
        (r.station_index, r.started_at, r.finished_at)
        for r in runs
        if r.started_at is not None and r.finished_at is not None
    ]
    # runs that never produced a start/finish pair — killed while queued,
    # stuck PENDING on an offline station — were previously dropped
    # SILENTLY, making a round with missing stations look fast. Name them.
    untimed = [
        r.station_index
        for r in runs
        if r.started_at is None or r.finished_at is None
    ]
    if not spans:
        return {
            "n_runs_timed": 0,
            "n_runs_untimed": len(untimed),
            "untimed_stations": sorted(untimed),
        }
    execs = [(s, t1 - t0) for s, t0, t1 in spans]
    sum_s = sum(dt for _, dt in execs)
    straggler, max_s = max(execs, key=lambda e: e[1])
    span = max(t1 for _, _, t1 in spans) - min(t0 for _, t0, _ in spans)
    return {
        "n_runs_timed": len(spans),
        "n_runs_untimed": len(untimed),
        "untimed_stations": sorted(untimed),
        "sum_exec_s": sum_s,
        "max_exec_s": max_s,
        "span_s": span,
        "straggler_station": straggler,
        "parallel_speedup_bound": sum_s / max_s if max_s > 0 else None,
    }


def wire_totals(runs: list[Any]) -> dict[str, Any]:
    """Per-round wire accounting over a task's runs: bytes broadcast out
    (input, counted once per station — every station receives the payload
    even though a v2 broadcast encrypts it once) and bytes collected in
    (results), plus the process-wide encode/decode-seconds and
    broadcast-dedup counters from `serialization.WIRE_STATS` (snapshot —
    diff two snapshots to scope them to one round)."""
    ins = [r.input_wire_bytes for r in runs
           if getattr(r, "input_wire_bytes", None) is not None]
    outs = [r.result_wire_bytes for r in runs
            if getattr(r, "result_wire_bytes", None) is not None]
    return {
        "wire_bytes_out": sum(ins) if ins else None,
        "wire_bytes_in": sum(outs) if outs else None,
        "n_runs_sized": len(outs),
        "wire_stats": wire_stats_snapshot(),
    }


def wire_stats_snapshot() -> dict[str, Any]:
    """Process-wide serialize/deserialize/broadcast counters (bytes,
    seconds, dedup hits) — one import point for observability consumers."""
    from vantage6_tpu_torch.common.serialization import WIRE_STATS

    return WIRE_STATS.snapshot()


def rest_stats_snapshot() -> dict[str, Any]:
    """Process-wide REST transport counters (calls, request/response
    bytes, seconds, stale-socket retries) from `common.rest.REST_STATS`.
    Diff two snapshots to scope to one round/bench arm — the control_plane
    leg reports calls-per-task from exactly this."""
    from vantage6_tpu_torch.common.rest import REST_STATS

    return REST_STATS.snapshot()


def learning_snapshot() -> list[dict[str, Any]]:
    """Process-wide learning-plane summaries (`runtime.learning.LEARNING`):
    one convergence view per tracked task — rounds, first/last/peak pooled
    update norm, decay, per-station contribution table. The one import
    point for observability consumers, like `wire_stats_snapshot`."""
    from vantage6_tpu_torch.runtime.learning import LEARNING

    return LEARNING.summaries()


def device_memory_all() -> list[dict[str, Any]]:
    """Memory census of EVERY visible CUDA card: ``{id, platform,
    bytes_in_use, peak_bytes}`` per card (``torch.cuda.memory_allocated``
    and ``max_memory_allocated``: the caching allocator's tensors), empty
    without CUDA. The one per-device hook `round_timer` and the bench
    legs share — a skewed card or a single leaking one is visible, not
    averaged away."""
    if not torch.cuda.is_available():
        return []
    out: list[dict[str, Any]] = []
    for i in range(torch.cuda.device_count()):
        out.append({
            "id": i,
            "platform": "gpu",
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
            "peak_bytes": int(torch.cuda.max_memory_allocated(i)),
        })
    return out


def device_peak_bytes(device: Any = None) -> int | None:
    """Peak allocated bytes of ``device`` (a CUDA ``torch.device`` or
    index), or None for a CPU device or without CUDA. With no ``device``,
    the WORST visible card's peak (the one that OOMs first);
    `device_memory_all` is the full census."""
    if device is not None:
        device = torch.device(device) if not isinstance(device, int) \
            else torch.device("cuda", device)
        if device.type != "cuda" or not torch.cuda.is_available():
            return None
        return int(torch.cuda.max_memory_allocated(device))
    peaks = [d["peak_bytes"] for d in device_memory_all()
             if d.get("peak_bytes")]
    return max(peaks) if peaks else None


def _tolerant(obj: Any) -> Any:
    try:
        import numpy as np

        if isinstance(obj, (np.generic, np.ndarray)):
            return obj.tolist()
    except ImportError:  # pragma: no cover
        pass
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    return str(obj)


def read_jsonl(path: str | Path) -> list[dict[str, Any]]:
    """Read a JSONL metrics file, skipping blank and undecodable lines.

    A process killed mid-write leaves a torn final line; every bench
    consumer of this file wants the records that DID land, not a
    JSONDecodeError at offset N."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out
