"""Realtime event hub: rooms, push subscriptions, cursor-based catch-up.

Parity: the reference's SocketIO namespace (SURVEY.md §2 item 6) — rooms per
collaboration and per node carry `node-online/offline`, `task-created`,
`status-update`, `kill`, `ping` events between server, nodes and UI. Here
the hub is transport-neutral: in-process subscribers get push callbacks
(same-host federations, tests), remote nodes get the events over a
websocket bridge or by cursor catch-up (`fetch(since=...)` — how a
reconnecting node re-syncs its missed queue, the reference's
`sync_task_queue_with_server`).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable

# canonical event names (reference SocketIO events)
NODE_ONLINE = "node-online"
NODE_OFFLINE = "node-offline"
TASK_CREATED = "task-created"
STATUS_UPDATE = "status-update"
KILL_TASK = "kill-task"
PING = "ping"
SESSION_DELETED = "session-deleted"  # nodes drop their local session store
# server-internal: one replica's cache invalidation, applied by the others
# (data: {"entity": user|node|role|rule|collaboration, "id": int|None});
# rides the shared event stream in REPLICA_ROOM, which no client's room
# set ever includes, so daemons/UIs never see it
CACHE_INVALIDATE = "cache-invalidate"

# server-to-server room for CACHE_INVALIDATE (never granted to clients)
REPLICA_ROOM = "replicas"


def collaboration_room(collaboration_id: int) -> str:
    return f"collaboration_{collaboration_id}"


def node_room(node_id: int) -> str:
    return f"node_{node_id}"


@dataclasses.dataclass(frozen=True)
class Event:
    seq: int
    name: str
    room: str
    data: dict[str, Any]
    ts: float

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


class EventHub:
    """Thread-safe pub/sub with a bounded replay buffer.

    Blocking consumers (the REST long-poll, `wait_for`) ride a condition
    variable notified on every emit, so a waiting daemon/client wakes the
    moment an event lands instead of on its next polling sweep. Eviction
    is tracked (`evicted_through`): a `fetch(since=...)` whose cursor
    predates the oldest buffered event has MISSED events the buffer can no
    longer replay — consumers must resync from primary state, and the
    REST layer surfaces this as `truncated` so they know to.
    """

    def __init__(self, buffer_size: int = 4096):
        self.buffer_size = buffer_size
        # EventHub is the SINGLE-replica hub; shared-store deployments
        # replica-local: swap in DbPubSub (app.py selects on db.SHARED)
        self._buffer: deque[Event] = deque(maxlen=buffer_size)  # guarded-by: _lock
        self._seq = itertools.count(1)  # replica-local: see _buffer
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        # seq of the newest event the bounded buffer has DROPPED (0: none)
        self._evicted_through = 0  # guarded-by: _lock
        # subscriber id -> (rooms | None for all, callback)
        # replica-local: push subscribers live in THIS process
        self._subs: dict[int, tuple[set[str] | None, Callable[[Event], None]]] = {}  # guarded-by: _lock
        self._sub_ids = itertools.count(1)  # replica-local: see _subs

    # ------------------------------------------------------------------ emit
    def emit(self, name: str, data: dict[str, Any], room: str = "all") -> Event:
        with self._lock:
            ev = Event(
                seq=next(self._seq), name=name, room=room,
                data=data, ts=time.time(),
            )
            if len(self._buffer) == self.buffer_size:
                # deque(maxlen) silently drops the head; remember how far
                # the replay window has moved so fetch() can report gaps
                self._evicted_through = self._buffer[0].seq
            self._buffer.append(ev)
            self._cond.notify_all()
            subs = list(self._subs.values())
        for rooms, cb in subs:
            if rooms is None or room in rooms or room == "all":
                try:
                    cb(ev)
                except Exception:
                    pass  # a broken subscriber must not break the emitter
        return ev

    # ------------------------------------------------------------- subscribe
    def subscribe(
        self,
        callback: Callable[[Event], None],
        rooms: list[str] | None = None,
    ) -> int:
        with self._lock:
            sid = next(self._sub_ids)
            self._subs[sid] = (set(rooms) if rooms is not None else None, callback)
            return sid

    def unsubscribe(self, sid: int) -> None:
        with self._lock:
            self._subs.pop(sid, None)

    # ---------------------------------------------------------------- replay
    def fetch(
        self, since: int = 0, rooms: list[str] | None = None
    ) -> list[Event]:
        """Events after sequence `since`, filtered to `rooms` (None = all).

        A node that reconnects calls this with its last-seen cursor to drain
        whatever it missed.
        """
        with self._lock:
            return self._fetch_locked(since, rooms, None)

    def _fetch_locked(
        self,
        since: int,
        rooms: list[str] | None,
        names: set[str] | None,
    ) -> list[Event]:
        want = set(rooms) if rooms is not None else None
        return [
            ev
            for ev in self._buffer
            if ev.seq > since
            and (want is None or ev.room in want or ev.room == "all")
            and (names is None or ev.name in names)
        ]

    def wait_for(
        self,
        since: int = 0,
        rooms: list[str] | None = None,
        timeout: float = 0.0,
        names: set[str] | None = None,
    ) -> list[Event]:
        """`fetch`, but blocks up to `timeout` seconds until at least one
        matching event exists — the long-poll primitive. Returns [] on
        timeout. Wakes IMMEDIATELY on a matching emit (condition variable),
        so dispatch latency is event propagation, not polling cadence.

        `names` narrows the wake set: a daemon only dispatches on
        task-created/kill-task/session-deleted, and without the filter
        every status-update in its collaboration would wake all N daemons
        — an N× request amplification per event under load.
        """
        deadline = time.monotonic() + max(0.0, timeout)
        with self._cond:
            while True:
                events = self._fetch_locked(since, rooms, names)
                if events:
                    return events
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._cond.wait(remaining)

    def collect(
        self,
        since: int = 0,
        rooms: list[str] | None = None,
        timeout: float = 0.0,
        names: set[str] | None = None,
    ) -> tuple[list[Event], int, bool]:
        """ATOMIC (events, cursor, truncated) snapshot, blocking like
        `wait_for`. The cursor is read under the SAME lock as the event
        scan, so it covers exactly the events visible to this snapshot —
        reading `hub.cursor` after a separate fetch would cover an event
        emitted in the gap without delivering it, and a cursor-following
        consumer (the daemon) would then skip it forever."""
        deadline = time.monotonic() + max(0.0, timeout)
        with self._cond:
            while True:
                events = self._fetch_locked(since, rooms, names)
                if events:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            cursor = self._buffer[-1].seq if self._buffer else 0
            return events, cursor, since < self._evicted_through

    def truncated(self, since: int) -> bool:
        """Whether a consumer at cursor `since` has missed events the
        bounded buffer can no longer replay (buffer overflow)."""
        with self._lock:
            return since < self._evicted_through

    @property
    def evicted_through(self) -> int:
        with self._lock:
            return self._evicted_through

    @property
    def cursor(self) -> int:
        """Sequence number of the newest event (0 when empty)."""
        with self._lock:
            return self._buffer[-1].seq if self._buffer else 0

    def stats(self) -> dict[str, int]:
        """One atomic snapshot for the telemetry registry: buffer fill,
        cursor position, eviction watermark, subscriber count."""
        with self._lock:
            return {
                "buffer_len": len(self._buffer),
                "cursor": self._buffer[-1].seq if self._buffer else 0,
                "evicted_through": self._evicted_through,
                "subscribers": len(self._subs),
            }
