"""Task and Run records — the control-plane vocabulary of the reference.

Parity: vantage6-server ORM `Task` / `Run` entities (SURVEY.md §2 item 2) and
the status lifecycle of §2 item 23. A *task* is one request ("run `method` of
`image` on these organizations"); it fans out into one *run* per target
organization. The reference persists these in SQLAlchemy and moves them via
REST+SocketIO; here they are in-memory records moved by the orchestrator, with
identical states so client code observing them ports unchanged.

The port's copy of ``vantage6_tpu/runtime/task.py`` (framework-free).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any

from vantage6_tpu_torch.common.enums import TaskStatus

_task_ids = itertools.count(1)
_run_ids = itertools.count(1)


@dataclasses.dataclass
class Run:
    """One organization's execution of a task (reference: `Run`, né `Result`).

    Status transitions are thread-safe and terminal-sticky: with the station
    executor pool a run may be started by a worker thread while `kill_task`
    flips it to KILLED from another — whoever reaches a terminal state first
    wins, and a late `finish`/`crash` must NOT overwrite a kill (parity: the
    server rejects status patches on terminal runs with 409). Each mutator
    returns whether it applied.
    """

    id: int
    task_id: int
    organization: str
    station_index: int
    status: TaskStatus = TaskStatus.PENDING
    result: Any = None
    log: str = ""
    assigned_at: float = dataclasses.field(default_factory=time.time)
    # set when the run is queued onto the station executor pool; together
    # with started_at/finished_at this gives the queued→started→finished
    # lifecycle runtime.metrics.run_lifecycle decomposes (straggler view)
    queued_at: float | None = None
    started_at: float | None = None
    finished_at: float | None = None
    # on-wire payload accounting (common.serialization.wire_nbytes): what
    # this run's input/result WOULD cost on the v2 binary wire — lets the
    # straggler view tell compute-bound from transfer-bound stations even
    # in the in-process host path, which never actually serializes. None =
    # not measured or not wire-serializable.
    input_wire_bytes: int | None = None
    result_wire_bytes: int | None = None
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def start(self) -> bool:
        with self._lock:
            if self.status.is_finished:
                return False  # killed while queued: never goes ACTIVE
            self.status = TaskStatus.ACTIVE
            self.started_at = time.time()
            return True

    def finish(self, result: Any) -> bool:
        with self._lock:
            if self.status.is_finished:
                return False  # killed mid-execution: drop the result
            self.result = result
            self.status = TaskStatus.COMPLETED
            self.finished_at = time.time()
            return True

    def crash(self, log: str) -> bool:
        with self._lock:
            if self.status.is_finished:
                return False
            self.log = log
            self.status = TaskStatus.CRASHED
            self.finished_at = time.time()
            return True

    def kill(self) -> bool:
        """Parity: the server's kill event. Queued (not-yet-started) and
        ACTIVE runs flip to KILLED; finished runs are immutable."""
        with self._lock:
            if self.status.is_finished:
                return False
            self.status = TaskStatus.KILLED
            self.finished_at = time.time()
            return True

    def mark_queued(self) -> None:
        self.queued_at = time.time()


@dataclasses.dataclass
class Task:
    """A federated task: method + input fanned out to organizations.

    `image` survives as the algorithm identifier (the reference addresses
    algorithms by Docker image name; here it names a registered algorithm
    module — same role, no container).
    """

    id: int
    name: str
    method: str
    image: str
    organizations: list[str]
    input_: dict[str, Any] = dataclasses.field(default_factory=dict)
    databases: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    parent_id: int | None = None  # subtasks created by a central fn
    init_org: str = ""
    init_user: str = ""
    collaboration: str = ""
    # sessions: the workspace this task runs in + the handle its returned
    # dataframe is persisted under at each station
    session_id: int | None = None
    store_as: str | None = None
    # estimated v2 on-wire size of input_ (shared by every run — a
    # broadcast sends ONE ciphertext; see encrypt_bytes_broadcast)
    input_wire_bytes: int | None = None
    runs: list[Run] = dataclasses.field(default_factory=list)
    created_at: float = dataclasses.field(default_factory=time.time)
    # Device-mode only: the stacked [S, ...] on-device result pytree (full
    # station axis) plus the [S] participation mask — 1.0 where the station
    # was targeted by this task AND completed. Central aggregation consumes
    # both without a host round-trip.
    stacked_result: Any = None
    participation: Any = None

    @property
    def status(self) -> TaskStatus:
        """Aggregate status over runs (reference computes the same rollup)."""
        if not self.runs:
            return TaskStatus.PENDING
        statuses = {r.status for r in self.runs}
        for bad in (TaskStatus.KILLED, TaskStatus.NOT_ALLOWED, TaskStatus.NO_IMAGE,
                    TaskStatus.CRASHED, TaskStatus.FAILED):
            if bad in statuses:
                return bad
        if statuses == {TaskStatus.COMPLETED}:
            return TaskStatus.COMPLETED
        if TaskStatus.ACTIVE in statuses or TaskStatus.INITIALIZING in statuses:
            return TaskStatus.ACTIVE
        return TaskStatus.PENDING

    @property
    def is_finished(self) -> bool:
        return self.status.is_finished

    def results(self) -> list[Any]:
        return [r.result for r in self.runs]

    def to_dict(self) -> dict[str, Any]:
        """Wire shape compatible with the reference's /api/task JSON."""
        return {
            "id": self.id,
            "name": self.name,
            "image": self.image,
            "method": self.method,
            "status": self.status.value,
            "parent": {"id": self.parent_id} if self.parent_id else None,
            "collaboration": {"name": self.collaboration},
            "runs": [
                {
                    "id": r.id,
                    "organization": r.organization,
                    "status": r.status.value,
                }
                for r in self.runs
            ],
        }


def new_task(**kw: Any) -> Task:
    return Task(id=next(_task_ids), **kw)


def new_run(**kw: Any) -> Run:
    return Run(id=next(_run_ids), **kw)


def new_run_ids(n: int) -> list[int]:
    """The ids of ``n`` new runs."""
    return [next(_run_ids) for _ in range(n)]
