"""Shared-store pub/sub: the EventHub surface over the storage backend.

One `EventHub` per process is exactly right for a single-replica server:
every emitter and every long-poller share its lock and condition variable.
With N replicas the emitting mutation can land on the OTHER replica, so
`GET /api/event?wait=` must observe a stream that spans processes. This
module provides `DbPubSub` — the same emit/fetch/collect/stats surface as
`events.EventHub`, backed by the `pubsub_event` table of the shared
storage backend (migration v7):

- **emit** appends a row (the AUTOINCREMENT seq is the global cursor —
  one ordered stream across all replicas), wakes this replica's local
  long-pollers immediately via the in-process condition variable, and
  prunes the table down to the bounded replay window, recording the
  eviction floor in `pubsub_meta` so `truncated` survives pruning.
- **collect** (the long-poll primitive) blocks on the local condition with
  a short ADAPTIVE re-check interval: a local emit wakes it instantly,
  a remote replica's emit is observed within ~`poll_floor`..`poll_ceil`
  seconds — dispatch latency stays event-propagation-shaped without a
  cross-process wakeup channel.
- **subscribers** (the websocket bridge) get local emits pushed inline;
  a lazily-started pump thread tails the table so remote emits reach
  them too.

Replica liveness rides the same store: `record_heartbeat` upserts this
replica's row in `replica_heartbeat`, `list_replicas` is what
`/api/health` and the watchdog's `replica_lapsed` rule read.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable

from vantage6_tpu_torch.server.db import Database
from vantage6_tpu_torch.server.events import Event

# a heartbeat older than this is a lapsed replica (crashed, partitioned,
# or stopped without deregistering) — /api/health and the watchdog agree
# on one number so the operator sees one story
REPLICA_STALE_AFTER = 15.0
# a heartbeat this old is an ancient departure, not worth reporting at all
REPLICA_FORGET_AFTER = 3600.0


class DbPubSub:
    """EventHub-compatible pub/sub over the shared `pubsub_event` table."""

    SHARED = True  # the app layer keys substrate decisions off this

    def __init__(
        self,
        db: Database,
        replica_id: str = "",
        buffer_size: int = 4096,
        poll_floor: float = 0.02,
        poll_ceil: float = 0.25,
    ):
        self.db = db
        self.replica_id = replica_id
        self.buffer_size = buffer_size
        self.poll_floor = poll_floor
        self.poll_ceil = poll_ceil
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        # subscriber registry: each replica pushes to ITS websocket
        # replica-local: bridges; the tables carry events between replicas
        self._subs: dict[int, tuple[set[str] | None, Callable[[Event], None]]] = {}  # guarded-by: _lock
        self._next_sub = 1  # guarded-by: _lock
        self._emits = 0  # guarded-by: _lock  (prune cadence counter)
        # replica-local: the pump thread tails the SHARED stream for this
        # replica's push subscribers (started on first subscribe)
        self._pump: threading.Thread | None = None  # guarded-by: _lock
        self._pump_stop = threading.Event()
        self._closed = False

    # ------------------------------------------------------------------ emit
    def emit(self, name: str, data: dict[str, Any], room: str = "all") -> Event:
        ts = time.time()
        cur = self.db.execute(
            "INSERT INTO pubsub_event (name, room, data, ts) "
            "VALUES (?, ?, ?, ?)",
            [name, room, json.dumps(data), ts],
        )
        ev = Event(seq=int(cur.lastrowid), name=name, room=room,
                   data=data, ts=ts)
        with self._cond:
            self._emits += 1
            prune = self._emits % 64 == 0
            self._cond.notify_all()
            subs = list(self._subs.values())
        if prune:
            self._prune(ev.seq)
        # push to local subscribers inline (same contract as EventHub);
        # remote replicas' subscribers get it from their pump thread
        for rooms, cb in subs:
            if rooms is None or room in rooms or room == "all":
                try:
                    cb(ev)
                except Exception:
                    pass  # a broken subscriber must not break the emitter
        return ev

    def _prune(self, newest_seq: int) -> None:
        floor = newest_seq - self.buffer_size
        if floor <= 0:
            return
        try:
            cur = self.db.execute(
                "DELETE FROM pubsub_event WHERE seq <= ?", [floor]
            )
            if cur.rowcount:
                self.db.execute(
                    "INSERT INTO pubsub_meta (key, value) VALUES "
                    "('evicted_through', ?) ON CONFLICT(key) DO UPDATE "
                    "SET value = MAX(value, excluded.value)",
                    [floor],
                )
        except Exception:  # pragma: no cover - pruning must never 500 a poll
            pass

    # ------------------------------------------------------------- subscribe
    def subscribe(
        self,
        callback: Callable[[Event], None],
        rooms: list[str] | None = None,
    ) -> int:
        with self._lock:
            sid = self._next_sub
            self._next_sub += 1
            self._subs[sid] = (
                set(rooms) if rooms is not None else None, callback
            )
            if self._pump is None and not self._closed:
                self._pump_stop.clear()
                self._pump = threading.Thread(
                    target=self._pump_loop, name="dbpubsub-pump", daemon=True
                )
                self._pump.start()
            return sid

    def unsubscribe(self, sid: int) -> None:
        with self._lock:
            self._subs.pop(sid, None)

    def _pump_loop(self) -> None:
        """Tail the shared stream for this replica's push subscribers.
        Local emits were already delivered inline, but re-delivering them
        here would duplicate — so the pump starts at the CURRENT cursor
        and only forwards events it has not yet seen, which by
        construction excludes nothing remote and may re-include a local
        emit raced between cursor read and insert; subscribers (the ws
        bridge) treat events idempotently by seq."""
        cursor = self.cursor
        while not self._pump_stop.wait(self.poll_ceil):
            try:
                events = self.fetch(since=cursor)
            except Exception:
                continue  # backend momentarily busy — next tick retries
            for ev in events:
                cursor = max(cursor, ev.seq)
                with self._lock:
                    subs = list(self._subs.values())
                for rooms, cb in subs:
                    if rooms is None or ev.room in rooms or ev.room == "all":
                        try:
                            cb(ev)
                        except Exception:
                            pass

    # ---------------------------------------------------------------- replay
    def fetch(
        self, since: int = 0, rooms: list[str] | None = None
    ) -> list[Event]:
        return self._fetch(since, rooms, None)

    def _fetch(
        self,
        since: int,
        rooms: list[str] | None,
        names: set[str] | None,
    ) -> list[Event]:
        rows = self.db.query(
            "SELECT seq, name, room, data, ts FROM pubsub_event "
            "WHERE seq > ? ORDER BY seq",
            [since],
        )
        want = set(rooms) if rooms is not None else None
        out = []
        for r in rows:
            if want is not None and r["room"] not in want and r["room"] != "all":
                continue
            if names is not None and r["name"] not in names:
                continue
            out.append(Event(
                seq=r["seq"], name=r["name"], room=r["room"],
                data=json.loads(r["data"]) if r["data"] else {}, ts=r["ts"],
            ))
        return out

    def wait_for(
        self,
        since: int = 0,
        rooms: list[str] | None = None,
        timeout: float = 0.0,
        names: set[str] | None = None,
    ) -> list[Event]:
        events, _, _ = self.collect(since, rooms, timeout, names)
        return events

    def collect(
        self,
        since: int = 0,
        rooms: list[str] | None = None,
        timeout: float = 0.0,
        names: set[str] | None = None,
    ) -> tuple[list[Event], int, bool]:
        """(events, cursor, truncated), blocking up to `timeout` — the
        long-poll primitive. A LOCAL emit wakes the condition instantly;
        a REMOTE replica's emit is caught by the adaptive re-check (the
        wait interval starts at `poll_floor` and stretches toward
        `poll_ceil` the longer nothing arrives). The cursor snapshot is
        taken in the same query round as the event scan."""
        deadline = time.monotonic() + max(0.0, timeout)
        interval = self.poll_floor
        while True:
            events = self._fetch(since, rooms, names)
            cursor = self.cursor
            if events or time.monotonic() >= deadline:
                return events, max(cursor, since if not events else 0), \
                    since < self.evicted_through
            remaining = deadline - time.monotonic()
            with self._cond:
                self._cond.wait(min(interval, max(0.0, remaining)))
            interval = min(interval * 2, self.poll_ceil)

    def truncated(self, since: int) -> bool:
        return since < self.evicted_through

    @property
    def evicted_through(self) -> int:
        rows = self.db.query(
            "SELECT value FROM pubsub_meta WHERE key = 'evicted_through'"
        )
        return int(rows[0]["value"]) if rows else 0

    @property
    def cursor(self) -> int:
        rows = self.db.query("SELECT MAX(seq) AS c FROM pubsub_event")
        return int(rows[0]["c"] or 0)

    def stats(self) -> dict[str, int]:
        rows = self.db.query(
            "SELECT COUNT(*) AS n, MAX(seq) AS c FROM pubsub_event"
        )
        with self._lock:
            subs = len(self._subs)
        return {
            "buffer_len": int(rows[0]["n"]),
            "cursor": int(rows[0]["c"] or 0),
            "evicted_through": self.evicted_through,
            "subscribers": subs,
        }

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._subs.clear()
            pump = self._pump
            self._pump = None
        self._pump_stop.set()
        if pump is not None:
            pump.join(timeout=2.0)


# ----------------------------------------------------------- replica status
def record_heartbeat(
    db: Database, replica_id: str, started_at: float
) -> None:
    """Upsert this replica's liveness row (called at startup and from the
    watchdog feed's periodic tick — no dedicated heartbeat thread)."""
    db.execute(
        "INSERT INTO replica_heartbeat "
        "(replica_id, pid, started_at, last_seen_at) VALUES (?, ?, ?, ?) "
        "ON CONFLICT(replica_id) DO UPDATE SET "
        "last_seen_at = excluded.last_seen_at, pid = excluded.pid",
        [replica_id, os.getpid(), started_at, time.time()],
    )


def drop_heartbeat(db: Database, replica_id: str) -> None:
    """Clean departure: a replica shutting down on purpose removes its row
    so it does not linger as 'lapsed' in every peer's health verdict."""
    db.execute(
        "DELETE FROM replica_heartbeat WHERE replica_id = ?", [replica_id]
    )


def list_replicas(db: Database, now: float | None = None) -> list[dict[str, Any]]:
    """Every recently-seen replica with its liveness verdict — the
    shared-store truth behind /api/health's `replicas` block and the
    watchdog's `replica_lapsed` evidence."""
    now = now if now is not None else time.time()
    out = []
    for r in db.query(
        "SELECT replica_id, pid, started_at, last_seen_at "
        "FROM replica_heartbeat ORDER BY replica_id"
    ):
        age = now - r["last_seen_at"]
        if age > REPLICA_FORGET_AFTER:
            continue
        out.append({
            "replica_id": r["replica_id"],
            "pid": r["pid"],
            "started_at": r["started_at"],
            "last_seen_at": r["last_seen_at"],
            "alive": age <= REPLICA_STALE_AFTER,
        })
    return out
