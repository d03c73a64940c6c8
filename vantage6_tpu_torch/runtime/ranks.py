"""The task plane of a ``Federation`` over the ranks of a process group.

Every rank runs the same task program (its top-level ``create_task`` and
``aggregate_stacked`` calls, in the same order), as each JAX process runs
the same Python under ``jax.distributed``. What a run does, though, must
happen once in the federation: a station's host-mode run draws from its
station's secret and keys, and the run records, metrics and executor
accounting count it once. So a host run executes on one rank, its
station's owner (the first rank of the station's slot), and its record
reaches the other ranks; and a run may create tasks or aggregate, which
the other ranks must join, since a device-mode step and an aggregation
are collective.

The ranks share one ordered log of task-plane events in the group's
key-value store (the ``torch.distributed`` rendezvous store, under a
prefix of the federation's own):

- ``task``: a task and its runs, with ids drawn from the store's
  counters. Rank 0 posts the top-level tasks (the k-th top-level
  ``create_task`` of every rank is the k-th such event), a run's own rank
  the tasks that run creates. Each rank builds the records and dispatches
  them: its own stations' host runs execute here, the others wait for
  their ``run`` event, and a device-mode step runs on every rank.
- ``run``: a host run's terminal record (status, result, log, times),
  posted by its owner.
- ``aggregate``: ``aggregate_stacked`` called inside a run; every rank
  applies it (the reduction is collective) and the calling rank returns
  its result.

Each rank applies the events in log order, in whichever of its threads
waits on the plane, one event at a time (a reentrant lock: a handler that
waits for runs applies the events after its own). The log is the one
order: two ranks issue the collectives of the events in the same order.
Every event carries its root, the top-level task it descends from, and a
rank applies no event of a top-level task its program has not created
yet: what the program does between two tasks (new datasets, say) comes
before that task's events on every rank. The last rank to apply an event
deletes it from the store.

A payload is what ``torch.save`` writes, and it is read back with
``weights_only=True``: tensors, numpy arrays and scalars, the wire's
``SparseVector``, and Python's containers and scalars (``SHAREABLE``). A
run whose result holds anything else cannot reach the other ranks, and
fails on every rank with a log that says so.
"""
from __future__ import annotations

import datetime
import functools
import io
import itertools
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed import distributed_c10d

# federations over a group built in this process: the k-th one of every
# rank shares the k-th prefix of the store
_PLANES = itertools.count()

# a key another rank must set first (an event, a published identity)
WAIT_S = 600.0
# how often a thread that waits for an event another thread applies looks
POLL_S = 0.005


@functools.cache
def _shareable() -> tuple[list[Any], frozenset[str]]:
    """The globals a payload may name beyond ``torch.load``'s own safe set
    (numpy's arrays, dtypes and scalars, the wire's ``SparseVector``), and
    their pickled names."""
    from vantage6_tpu_torch.common.serialization import SparseVector

    allowed = [
        *{type(np.dtype(c)) for c in np.typecodes["All"] + "OSUV"},
        np.ndarray, np.dtype,
        np.zeros(1).__reduce__()[0],  # numpy's array reconstructor
        np.float64(0).__reduce__()[0],  # and its scalar one
        SparseVector,
    ]
    return allowed, frozenset(f"{g.__module__}.{g.__qualname__}"
                              for g in allowed)


class UnshareableError(TypeError):
    """A payload names a global ``loads`` will not load."""


def dumps(obj: Any) -> bytes:
    """An event's payload as bytes (tensors included, on any device);
    ``UnshareableError`` if it holds what ``loads`` refuses."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    blob = buf.getvalue()
    names = set(torch.serialization.get_unsafe_globals_in_checkpoint(
        io.BytesIO(blob))) - _shareable()[1]
    if names:
        raise UnshareableError(
            f"cannot share {sorted(names)} across the ranks: a payload holds"
            " tensors, numpy arrays and scalars, SparseVector, and Python "
            "containers and scalars")
    return blob


# torch's safe-globals context edits one process-wide set: one load at a
# time, so no load's exit removes the globals from under another's
_LOAD_LOCK = threading.Lock()


def loads(blob: bytes, device: torch.device) -> Any:
    with _LOAD_LOCK, torch.serialization.safe_globals(_shareable()[0]):
        return torch.load(io.BytesIO(blob), map_location=device,
                          weights_only=True)


class RankPlane:
    """One rank's side of the shared event log of a ``Federation``."""

    def __init__(self, federation: Any, group: Any):
        mesh = federation.mesh
        if mesh.slot is None:
            raise ValueError(
                f"rank {mesh.rank} of {mesh.world_size} holds no station: "
                f"{mesh.n_stations} stations take {mesh.station_axis_size} "
                f"slots of {mesh.devices_per_station} ranks; run the "
                "federation on "
                f"{mesh.station_axis_size * mesh.devices_per_station} ranks"
            )
        self.fed = federation
        self.mesh = mesh
        prefix = (f"v6t-federation/{next(_PLANES)}/"
                  f"{','.join(map(str, mesh.ranks))}/")
        self.store = dist.PrefixStore(prefix,
                                      distributed_c10d._get_default_store())
        self.lock = threading.RLock()  # guards the fields below
        self.applied = 0  # events of the log applied here
        self.top = 0  # top-level tasks created here
        self.top_tasks: dict[int, int] = {}  # k -> task id
        self.roots: dict[int, int] = {}  # task id -> its top-level task
        self.results: dict[int, Any] = {}  # event -> this rank's answer
        self.next_event: dict[str, Any] | None = None  # read, not applied
        self.local = threading.local()  # in_run: a run executes here

    # ------------------------------------------------------------ layout
    def owner(self, station: int) -> int:
        """The group rank that executes ``station``'s host runs: the first
        rank of its slot."""
        mesh = self.mesh
        return (station // mesh.stations_per_slot) * mesh.devices_per_station

    def owns(self, station: int) -> bool:
        return self.owner(station) == self.mesh.rank

    @property
    def in_run(self) -> bool:
        return getattr(self.local, "in_run", False)

    # --------------------------------------------------------------- ids
    def ids(self, n_runs: int) -> tuple[int, list[int]]:
        """A task id and ``n_runs`` run ids, unique across the ranks."""
        task_id = self.store.add("ids/task", 1)
        last = self.store.add("ids/run", n_runs)
        return task_id, list(range(last - n_runs + 1, last + 1))

    # --------------------------------------------------------------- log
    def post(self, kind: str, payload: dict[str, Any], root: int) -> int:
        """Append an event of the top-level task ``root``; returns its
        place in the log."""
        seq = self.store.add("log/n", 1)
        self.store.set(f"log/{seq}", dumps(
            {"kind": kind, "from": self.mesh.rank, "root": root, **payload}))
        return seq

    def _read(self, seq: int) -> dict[str, Any]:
        key = f"log/{seq}"
        self.store.wait([key], datetime.timedelta(seconds=WAIT_S))
        return loads(self.store.get(key), self.mesh.device)

    def _release(self, seq: int) -> None:
        """Count event ``seq`` applied here; the last rank deletes it."""
        if self.store.add(f"done/{seq}", 1) == self.mesh.world_size:
            self.store.delete_key(f"log/{seq}")
            self.store.delete_key(f"done/{seq}")

    def apply(self, until: int | None = None) -> None:
        """Apply the log's events in order: up to ``until`` (waiting for
        them), else those posted so far; stop at an event of a top-level
        task this rank's program has not created yet."""
        with self.lock:
            last = self.store.add("log/n", 0) if until is None else until
            while self.applied < last:
                if self.next_event is None:
                    self.next_event = self._read(self.applied + 1)
                event = self.next_event
                if event["root"] > self.top:
                    return
                self.next_event = None
                self.applied += 1
                seq = self.applied
                out = getattr(self.fed, f"_apply_{event['kind']}")(event)
                if event["from"] == self.mesh.rank:
                    self.results[seq] = out
                self._release(seq)

    def answer(self, seq: int, wait_s: float = WAIT_S) -> Any:
        """What applying this rank's event ``seq`` returned here. An event
        of a top-level task this rank's program has not created yet may
        come first in the log; then this waits for the program to reach
        it (another thread applies the events meanwhile)."""
        deadline = time.monotonic() + wait_s
        while True:
            self.apply(until=seq)
            with self.lock:
                if self.applied >= seq:
                    return self.results.pop(seq)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"rank {self.mesh.rank}: event {seq} waits behind a "
                    f"top-level task this rank's program has not created "
                    f"within {wait_s} s")
            time.sleep(POLL_S)

    # --------------------------------------------------------- top level
    def next_top(self) -> int:
        with self.lock:
            self.top += 1
            return self.top

    def top_task(self, k: int, wait_s: float = WAIT_S) -> int:
        """The id of the k-th top-level task (rank 0 posts it), applying
        the log until its event."""
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=wait_s)
        while True:
            with self.lock:
                if k in self.top_tasks:
                    return self.top_tasks.pop(k)
                n = self.store.add("log/n", 0)
                if self.applied < n:
                    self.apply(until=self.applied + 1)
                    continue
            if datetime.datetime.now() > deadline:
                raise TimeoutError(
                    f"rank {self.mesh.rank}: top-level task {k} was not "
                    f"posted by rank 0 within {wait_s} s")
            self.store.wait([f"log/{n + 1}"],
                            datetime.timedelta(seconds=wait_s))

    # -------------------------------------------------------- identities
    def publish_identity(self, station: int, public_key: str) -> None:
        self.store.set(f"identity/{station}", public_key.encode())

    def identity(self, station: int) -> str:
        """``station``'s public identity key, as its owner published it
        when it made the key."""
        key = f"identity/{station}"
        self.store.wait([key], datetime.timedelta(seconds=WAIT_S))
        return self.store.get(key).decode()
