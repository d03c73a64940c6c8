"""Station executor pool — parallel host-path execution.

The reference network runs one daemon per node, all concurrently: a round's
wall-clock is max-over-stations, not sum-over-stations. This module gives the
in-process Federation the same semantics for host-mode runs:

- A shared ``ThreadPoolExecutor`` of ``workers`` threads executes queued run
  items.
- **Per-station serialization**: each station has a FIFO queue and at most
  ONE thread ever executes that station's items at a time (matching the
  one-daemon-per-node reality, and keeping per-station session stores safe
  without fine-grained locking inside algorithms).
- **Re-entrant help while waiting** (the deadlock-avoidance rule for nested
  subtasks): a thread that is executing a run and blocks waiting for other
  runs (a central partial inside ``wait_for_results`` / a nested
  ``create_task(wait=True)``) lends itself to the queue via
  :meth:`help_or_wait` — it may claim items of any idle station AND of
  stations it itself holds (its own run is suspended in the wait, so the
  one-thread-per-station invariant is preserved). This is why a pool of ANY
  size, even 1, cannot deadlock on central→partial fan-out, including a
  central whose subtask lands on its own station.

Threads that are NOT executing a run (e.g. the user's main thread polling
``wait_for_results``) never steal work — they sleep on the condition variable
so an explicit ``timeout`` keeps its polling semantics.

The port's copy of ``vantage6_tpu/runtime/executor.py`` (framework-free).
"""
from __future__ import annotations

import threading
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

# telemetry: queue-depth visibility across every live pool in the process
# (the unified registry's executor series — docs/observability.md; the
# collector itself is registered by common.telemetry, which imports this
# set lazily so the series exists even before any pool does). A WeakSet
# so abandoned pools vanish from the gauge with their GC, not at an
# explicit close.
_LIVE_POOLS: "weakref.WeakSet[StationExecutor]" = weakref.WeakSet()


class StationExecutor:
    """FIFO-per-station work queue on top of a bounded thread pool."""

    def __init__(self, n_stations: int, workers: int):
        if n_stations < 1:
            raise ValueError("n_stations must be >= 1")
        if workers < 1:
            raise ValueError(
                "workers must be >= 1 (use no executor at all for the "
                "synchronous escape hatch)"
            )
        self.n_stations = n_stations
        self.workers = workers
        self._cond = threading.Condition()
        # guarded-by: _cond
        self._queues: list[deque[Callable[[], Any]]] = [
            deque() for _ in range(n_stations)
        ]
        # thread currently executing (or holding, while blocked in a nested
        # wait) each station; None = idle
        self._executing: list[threading.Thread | None] = [None] * n_stations  # guarded-by: _cond
        self._inflight = 0  # guarded-by: _cond
        self._rr = 0  # guarded-by: _cond (round-robin claim start)
        self._tls = threading.local()
        self._shutdown = False  # guarded-by: _cond
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="v6t-station"
        )
        _LIVE_POOLS.add(self)

    # ----------------------------------------------------------------- submit
    def submit(self, station: int, item: Callable[[], Any]) -> None:
        """Queue ``item`` on ``station``'s FIFO; a pool thread (or a helping
        waiter) will execute it, never concurrently with another item of the
        same station."""
        if not 0 <= station < self.n_stations:
            raise ValueError(f"unknown station {station}")
        with self._cond:
            if self._shutdown:
                raise RuntimeError("executor is shut down")
            self._queues[station].append(item)
            self._inflight += 1
            self._cond.notify_all()
        self._pool.submit(self._pump)

    # ------------------------------------------------------------------ claim
    def _held(self) -> list[int]:
        """Stations the CURRENT thread is executing items for, innermost
        last (a stack: re-entrant helping nests)."""
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _claim(self, steal_held: bool) -> tuple[int, Callable[[], Any]] | None:
        """Pop the next item of a claimable station (idle, or — when
        ``steal_held`` — held by this very thread, whose run is suspended in
        a wait). Returns None when nothing is claimable right now."""
        me = threading.current_thread()
        held = self._held()
        with self._cond:
            n = self.n_stations
            start = self._rr
            self._rr = (self._rr + 1) % n
            for off in range(n):
                s = (start + off) % n
                if not self._queues[s]:
                    continue
                owner = self._executing[s]
                if owner is None or (steal_held and owner is me and s in held):
                    item = self._queues[s].popleft()
                    self._executing[s] = me
                    return s, item
        return None

    def _run_item(self, station: int, item: Callable[[], Any]) -> None:
        held = self._held()
        held.append(station)
        try:
            item()
        finally:
            held.pop()
            with self._cond:
                self._inflight -= 1
                if station not in held:
                    self._executing[station] = None
                more = bool(self._queues[station]) and not self._shutdown
                self._cond.notify_all()
            if more:
                # whoever ran this item may stop draining (a helper returning
                # to its wait loop): make sure a pool thread comes back for
                # the rest of this station's queue
                self._pool.submit(self._pump)

    def _pump(self) -> None:
        """Pool-thread drain loop: claim and run items until none are
        claimable. One pump is submitted per item, so queued work can never
        be orphaned — extra pumps find nothing and exit."""
        while True:
            claimed = self._claim(steal_held=False)
            if claimed is None:
                return
            self._run_item(*claimed)

    # ------------------------------------------------------------------- wait
    def help_or_wait(self, timeout: float) -> bool:
        """One iteration of a wait loop.

        A thread currently executing a run (``held`` non-empty) lends itself
        to the queue — claiming any idle station's item or, re-entrantly, an
        item of a station it holds. Other threads (and helpers that find
        nothing claimable) sleep up to ``timeout`` on the condition variable,
        which is notified on every submit and completion. Returns True if an
        item was executed inline.
        """
        if self._held():
            claimed = self._claim(steal_held=True)
            if claimed is not None:
                self._run_item(*claimed)
                return True
        with self._cond:
            if self._inflight:
                self._cond.wait(timeout)
        return False

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every submitted item has executed (or ``timeout``
        elapsed). Returns True when the queue is empty."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._inflight:
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining if remaining is not None else 1.0)
        return True

    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    def stats(self) -> dict[str, Any]:
        """Queue-depth view for the ops plane (watchdog queue_buildup feed
        + /api/alerts context): total inflight, worker capacity, and the
        per-station queue lengths that tell a uniformly-loaded pool from
        one station's FIFO wedged behind a long run."""
        with self._cond:
            return {
                "inflight": self._inflight,
                "workers": self.workers,
                "n_stations": self.n_stations,
                "queued_per_station": [len(q) for q in self._queues],
                "executing_stations": [
                    i for i, t in enumerate(self._executing) if t is not None
                ],
            }

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Tear down the pool. Queued-but-unstarted items are dropped —
        only for Federation teardown, never mid-protocol."""
        _LIVE_POOLS.discard(self)  # dropped items would pin the gauge
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        self._pool.shutdown(wait=False, cancel_futures=True)
