"""Fleet store: cross-host telemetry aggregation over the storage backend.

The ingest half of the fleet fabric (`common/fleet.py` is the push
half): snapshots POSTed to `/api/telemetry` — and the server's own
self-ingested snapshots — land here as CAS-free appends in the
`fleet_metric` / `fleet_event` tables (migration v8), so N replicas
over one `sqlite+wal` store serve ONE coherent fleet view. All helpers
are module-level functions taking the `db` handle (the `pubsub.py`
idiom): no per-replica state beyond what the store itself holds.

Reads:

- :func:`fleet_view` — `GET /api/fleet`'s body: per-source freshness,
  the merged counter/gauge census (latest row per source+series;
  counters sum across sources, gauges too — capacity-shaped gauges add,
  and per-source values stay inspectable under ``sources``), and the
  top-k counter deltas over the fast window ("what is the fleet doing
  right now").
- :func:`metric_series` — the SLO engine's windowed sample scan.
- :func:`liveness` — fresh/total daemon sources, the daemon-liveness
  SLO's subject ratio.

Retention: :func:`prune` deletes samples older than the retention
floor (``V6T_FLEET_RETENTION_S``, default 2 h) but always keeps the
newest row per (source, series) — a quiet source ages toward *stale*,
it never silently vanishes from the census. Called on an ingest
cadence (every ``PRUNE_EVERY`` ingests), the `DbPubSub._prune` stance:
pruning must never fail a push.
"""
from __future__ import annotations

import json
import time
from typing import Any

from vantage6_tpu_torch.common.env import env_float
from vantage6_tpu_torch.common.telemetry import REGISTRY

# retention floor for samples/events; the newest row per series survives
RETENTION_S = env_float("V6T_FLEET_RETENTION_S", 7200.0)
# a source whose newest snapshot is older than this is stale (3x the
# default push interval: one missed push is jitter, three is a lapse)
STALE_AFTER_S = env_float("V6T_FLEET_STALE_S", 45.0)
PRUNE_EVERY = 32
TOP_K_DELTAS = 8

# replica-local: ingest cadence counter for the pruner (approximate by
# design — each replica prunes on its own 1/PRUNE_EVERY of ingests)
_INGESTS = 0

# sqlite's default variable cap is 999; 6 columns/row -> stay well under
_ROWS_PER_INSERT = 120


def _insert_chunks(
    table: str, columns: str, rows: list[tuple]
) -> list[tuple[str, list[Any]]]:
    """Multi-row ``INSERT``s of at most ``_ROWS_PER_INSERT`` rows each."""
    width = len(rows[0]) if rows else 0
    values = "(" + ", ".join(["?"] * width) + ")"
    return [
        (f"INSERT INTO {table} ({columns}) VALUES "
         + ", ".join([values] * len(chunk)),
         [v for row in chunk for v in row])
        for chunk in (rows[i:i + _ROWS_PER_INSERT]
                      for i in range(0, len(rows), _ROWS_PER_INSERT))
    ]


def ingest(db: Any, payload: dict[str, Any]) -> dict[str, int]:
    """Append one decoded push payload (see `common.fleet.build_snapshot`)
    to the store. CAS-free: rows are only ever inserted, never updated —
    two replicas ingesting concurrently cannot conflict. Returns the
    appended row counts."""
    global _INGESTS
    from vantage6_tpu_torch.common.fleet import sample_kind

    now = time.time()
    source = str(payload["source"])
    service = str(payload.get("service") or "")
    seq = int(payload.get("seq") or 0)
    # clamp the sample timestamp into sane wall-clock: a pusher with a
    # skewed clock must not land samples in the far future (they would
    # pin the census) or before the retention floor (instantly pruned)
    ts = float(payload.get("ts") or now)
    ts = min(max(ts, now - RETENTION_S), now + 60.0)

    metrics = payload.get("metrics") or {}
    rows = [
        (source, service, seq, str(name), sample_kind(str(name)),
         float(value), ts)
        for name, value in metrics.items()
        if isinstance(value, (int, float)) and not isinstance(value, bool)
    ]
    notes = [
        (source, service, str(note["kind"]), float(note.get("ts") or ts),
         json.dumps({k: v for k, v in note.items()
                     if k not in ("kind", "ts")}, default=str))
        for note in payload.get("notes") or []
        if isinstance(note, dict) and note.get("kind")
    ]
    # the whole push is one transaction: one commit, and in memory mode
    # one hold of the store's lock, however many chunks and notes it has
    # (multi-row inserts number their rows in order, as single ones do)
    db.execute_batch(
        _insert_chunks("fleet_metric",
                       "source, service, seq, name, kind, value, ts", rows)
        + _insert_chunks("fleet_event", "source, service, kind, ts, data",
                         notes)
    )
    events = len(notes)

    REGISTRY.counter("v6t_fleet_ingests_total").inc()
    REGISTRY.counter("v6t_fleet_ingest_rows_total").inc(len(rows))
    _INGESTS += 1
    if _INGESTS % PRUNE_EVERY == 0:
        try:
            prune(db, now)
        except Exception:  # pruning must never fail a push
            pass
    return {"metrics": len(rows), "events": events}


def record_sample(
    db: Any,
    source: str,
    service: str,
    name: str,
    value: float,
    ts: float | None = None,
) -> None:
    """Append one per-event sample (e.g. a run's dispatch latency at its
    start transition) — the SLO engine's event-grade series, finer than
    the snapshot cadence."""
    from vantage6_tpu_torch.common.fleet import sample_kind

    db.execute(
        "INSERT INTO fleet_metric "
        "(source, service, seq, name, kind, value, ts) "
        "VALUES (?, ?, ?, ?, ?, ?, ?)",
        [source, service, 0, name, sample_kind(name), float(value),
         ts if ts is not None else time.time()],
    )


def prune(db: Any, now: float | None = None) -> int:
    """Delete samples/events past the retention floor, keeping the
    newest row per (source, series) so quiet sources stay visible as
    stale instead of vanishing. Returns rows deleted."""
    now = now if now is not None else time.time()
    floor = now - RETENTION_S
    cur = db.execute(
        "DELETE FROM fleet_metric WHERE ts < ? AND id NOT IN "
        "(SELECT MAX(id) FROM fleet_metric GROUP BY source, name)",
        [floor],
    )
    deleted = cur.rowcount or 0
    cur = db.execute("DELETE FROM fleet_event WHERE ts < ?", [floor])
    deleted += cur.rowcount or 0
    if deleted:
        REGISTRY.counter("v6t_fleet_pruned_rows_total").inc(deleted)
    return deleted


def sources(db: Any, now: float | None = None) -> list[dict[str, Any]]:
    """Per-source freshness: newest snapshot age, push seq, series count.
    Also refreshes the fleet census gauges — every caller of the fleet
    view or the watchdog feed keeps them current."""
    now = now if now is not None else time.time()
    out = []
    for r in db.query(
        "SELECT source, MAX(service) AS service, MAX(ts) AS last_ts, "
        "MAX(seq) AS seq, COUNT(DISTINCT name) AS series "
        "FROM fleet_metric GROUP BY source ORDER BY source"
    ):
        age = now - float(r["last_ts"])
        out.append({
            "source": r["source"],
            "service": r["service"] or "",
            "last_seen_at": float(r["last_ts"]),
            "age_s": round(age, 3),
            "stale": age > STALE_AFTER_S,
            "seq": int(r["seq"] or 0),
            "series": int(r["series"]),
        })
    REGISTRY.gauge("v6t_fleet_sources").set(len(out))
    REGISTRY.gauge("v6t_fleet_stale_sources").set(
        sum(1 for s in out if s["stale"])
    )
    return out


def _latest_rows(db: Any) -> list[dict[str, Any]]:
    return db.query(
        "SELECT m.source, m.name, m.kind, m.value, m.ts FROM fleet_metric m "
        "JOIN (SELECT source, name, MAX(id) AS mid FROM fleet_metric "
        "GROUP BY source, name) x ON m.id = x.mid"
    )


def census(db: Any) -> dict[str, dict[str, float]]:
    """The merged fleet census: latest value per (source, series),
    summed across sources per series. Counters sum into fleet totals by
    construction; gauges sum into fleet capacity/occupancy (per-source
    values remain readable through the raw samples)."""
    counters: dict[str, float] = {}
    gauges: dict[str, float] = {}
    for r in _latest_rows(db):
        bucket = counters if r["kind"] == "counter" else gauges
        bucket[r["name"]] = bucket.get(r["name"], 0.0) + float(r["value"] or 0)
    return {"counters": counters, "gauges": gauges}


def top_deltas(
    db: Any,
    window_s: float,
    now: float | None = None,
    k: int = TOP_K_DELTAS,
) -> list[dict[str, Any]]:
    """The k counter series that moved most over the trailing window —
    newest minus oldest in-window sample per (source, series), summed
    per series. The "what is the fleet doing right now" read."""
    now = now if now is not None else time.time()
    rows = db.query(
        "SELECT source, name, value, ts FROM fleet_metric "
        "WHERE kind = 'counter' AND ts >= ? ORDER BY id",
        [now - window_s],
    )
    first: dict[tuple[str, str], float] = {}
    last: dict[tuple[str, str], float] = {}
    for r in rows:
        key = (r["source"], r["name"])
        first.setdefault(key, float(r["value"] or 0))
        last[key] = float(r["value"] or 0)
    deltas: dict[str, float] = {}
    for key, end in last.items():
        d = end - first[key]
        if d > 0:
            deltas[key[1]] = deltas.get(key[1], 0.0) + d
    ranked = sorted(deltas.items(), key=lambda kv: -kv[1])[:k]
    return [
        {"name": name, "delta": round(delta, 6), "window_s": window_s}
        for name, delta in ranked
    ]


def metric_series(
    db: Any, name: str, since: float
) -> list[dict[str, Any]]:
    """All samples of one series since ``since``, oldest first, across
    every source — the SLO engine's windowed history."""
    return [
        {"metric": name, "source": r["source"], "ts": float(r["ts"]),
         "value": float(r["value"] or 0)}
        for r in db.query(
            "SELECT source, value, ts FROM fleet_metric "
            "WHERE name = ? AND ts >= ? ORDER BY ts",
            [name, since],
        )
    ]


def recent_events(
    db: Any, since: float, limit: int = 100
) -> list[dict[str, Any]]:
    out = []
    for r in db.query(
        "SELECT source, service, kind, ts, data FROM fleet_event "
        "WHERE ts >= ? ORDER BY id DESC LIMIT ?",
        [since, limit],
    ):
        try:
            data = json.loads(r["data"]) if r["data"] else {}
        except (TypeError, ValueError):
            data = {}
        out.append({
            "source": r["source"], "service": r["service"] or "",
            "kind": r["kind"], "ts": float(r["ts"]), **data,
        })
    out.reverse()
    return out


def liveness(
    db: Any, now: float | None = None
) -> tuple[int, int, list[dict[str, Any]]]:
    """(fresh daemon sources, total daemon sources, all sources) — the
    daemon-liveness SLO's subject. Only daemon-service sources count:
    a finished bench Federation going quiet is expected, a daemon is
    not."""
    rows = sources(db, now)
    daemons = [s for s in rows if s["service"].startswith("daemon")]
    fresh = sum(1 for s in daemons if not s["stale"])
    return fresh, len(daemons), rows


def fleet_view(db: Any, now: float | None = None) -> dict[str, Any]:
    """`GET /api/fleet`'s body (also doctor --live's raw material)."""
    from vantage6_tpu_torch.runtime.watchdog import WATCHDOG

    now = now if now is not None else time.time()
    fast_window = float(WATCHDOG.config.get("slo_fast_window_s", 300.0))
    fresh, daemons, rows = liveness(db, now)
    return {
        "ts": now,
        "sources": rows,
        "census": census(db),
        "top_deltas": top_deltas(db, fast_window, now),
        "events": recent_events(db, now - fast_window),
        "liveness": {
            "fresh_daemons": fresh,
            "daemons": daemons,
            "ratio": (fresh / daemons) if daemons else 1.0,
            "stale_after_s": STALE_AFTER_S,
        },
        "retention_s": RETENTION_S,
    }


def health_block(db: Any, now: float | None = None) -> dict[str, Any]:
    """The compact fleet section folded into `GET /api/health`."""
    now = now if now is not None else time.time()
    fresh, daemons, rows = liveness(db, now)
    return {
        "sources": len(rows),
        "stale_sources": sum(1 for s in rows if s["stale"]),
        "fresh_daemons": fresh,
        "daemons": daemons,
    }
