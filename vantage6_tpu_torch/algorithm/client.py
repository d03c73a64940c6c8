"""AlgorithmClient — the in-algorithm SDK.

Parity: vantage6-algorithm-tools AlgorithmClient (SURVEY.md §2 item 17): the
client a *central* function uses to fan out subtasks to organizations and
collect their results. In the reference every call tunnels through the node
proxy to the server over HTTPS with a container JWT; here calls go straight
into the Federation orchestrator, and `wait_for_results` — seconds of polling
per round in the reference (§3.2) — returns results that, for device-mode
partials, are still resident on the card as a stacked pytree.

Surface kept reference-shaped::

    task = client.task.create(input_={"method": ..., "kwargs": {...}},
                              organizations=[0, 1, 2])
    results = client.wait_for_results(task_id=task["id"])
    orgs = client.organization.list()

The port's copy of ``vantage6_tpu/algorithm/client.py``, plus
``device`` (the card the partials run on).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:  # pragma: no cover
    from vantage6_tpu_torch.runtime.federation import Federation
    from vantage6_tpu_torch.runtime.task import Task


class AlgorithmClient:
    def __init__(
        self,
        federation: "Federation",
        task: "Task | None" = None,
        station: int = 0,
        image: str = "",
    ):
        self._fed = federation
        self._task = task  # the task this algorithm runs as (parent of subtasks)
        self._station = station
        # Algorithm identifier for tasks created without a parent context
        # (top-level client use); inside a run, the parent task's image wins.
        self._image = image or (task.image if task else "")
        self.task = _TaskSubClient(self)
        self.result = _ResultSubClient(self)
        self.run = _RunSubClient(self)
        self.organization = _OrganizationSubClient(self)

    # Reference signature: wait_for_results(task_id, interval=1). With the
    # station executor pool these are REAL polling knobs: a task created
    # with wait=False may still be queued/executing, and this call blocks
    # (helping the pool when called from inside a pooled run — the nested
    # fan-out deadlock-avoidance rule, docs/host_executor.md) until its runs
    # finish or `timeout` passes (TimeoutError, like the reference client).
    def wait_for_results(
        self,
        task_id: int,
        interval: float = 1.0,
        timeout: float | None = None,
    ) -> list[Any]:
        # timeout default None = block until done, like the reference
        # client's defaults (and Federation.wait_for_results); pass a value
        # to opt into TimeoutError-at-deadline polling.
        return self._fed.wait_for_results(
            task_id, timeout=timeout, interval=interval
        )

    def task_timing(self, task_id: int) -> dict[str, Any]:
        """Per-run lifecycle + straggler decomposition + per-round wire
        accounting (bytes out/in, encode/decode seconds, broadcast dedup
        hits) for one of this algorithm's (sub)tasks — see
        ``Federation.task_timing``. Central code uses this to adapt to
        stations that are transfer-bound rather than compute-bound."""
        return self._fed.task_timing(task_id)

    @property
    def device(self) -> Any:
        """The card this federation's device-mode partials run on (a
        ``torch.device``); central code places what it sends them here."""
        return self._fed.mesh.device

    def wait_for_stacked_result(self, task_id: int) -> tuple[Any, Any]:
        """Device fast path (no reference equivalent): returns ``(stacked,
        mask)`` — the on-device [S, ...] result pytree over the FULL station
        axis plus the [S] f32 participation mask (1.0 where the station was
        targeted and completed). Central code aggregates with
        ``vantage6_tpu_torch.fed.collectives`` passing ``mask=mask`` and
        never pulls per-station results to host."""
        t = self._fed.get_task(task_id)
        self._fed.wait_for_results(task_id)  # raise on failures
        if t.stacked_result is None:
            raise ValueError(
                f"task {task_id} was not a device-mode partial; use "
                "wait_for_results()"
            )
        return t.stacked_result, t.participation

    def aggregate_stacked(
        self, task_id: int, weights: Any = None,
        agg_mode: str = "replicated",
    ) -> Any:
        """Masked weighted-mean over a device-mode task's stacked result —
        ``agg_mode`` selects replicated (all-reduce) vs scattered
        (reduce-scatter + all-gather, optionally bf16 on the wire)
        aggregation; see Federation.aggregate_stacked."""
        self._fed.wait_for_results(task_id)  # raise on failures
        return self._fed.aggregate_stacked(
            task_id, weights=weights, agg_mode=agg_mode
        )

    def compress_update(self, tree: Any, name: str = "update") -> Any:
        """Compress a model-delta tree for the uplink under the
        federation's configured compressor, with THIS station's
        error-feedback accumulator. A partial returns the compressed
        payload as its result; the central side folds it back with
        ``decompress_update``. Pass-through when no compressor is
        configured, so the call can stay in place unconditionally."""
        return self._fed.compress_update(self._station, tree, name=name)

    def decompress_update(self, payload: Any) -> Any:
        """Materialize the dense update from a `compress_update` payload
        (pass-through for uncompressed results)."""
        return self._fed.decompress_update(payload)


class _TaskSubClient:
    def __init__(self, parent: AlgorithmClient):
        self._p = parent

    def create(
        self,
        input_: dict[str, Any],
        organizations: list[int],
        name: str = "subtask",
        databases: list[dict[str, Any]] | None = None,
        session: int | None = None,
        store_as: str | None = None,
        wait: bool = True,
        **_compat: Any,
    ) -> dict[str, Any]:
        """Create a subtask on the given organization ids.

        Returns the task as a dict (reference wire shape, incl. ``id``).
        Subtasks inherit the parent's session when none is given, so a
        central function's fan-out reads/writes the same workspace.
        ``wait=False`` dispatches asynchronously onto the station executor
        pool and returns immediately — create every subtask first, then
        collect with ``wait_for_results``, and the fan-out runs in parallel
        (reference nodes behave exactly this way).
        """
        parent = self._p._task
        image = parent.image if parent else self._p._image
        if not image:
            raise ValueError(
                "no algorithm image in scope — construct AlgorithmClient "
                "with image=... for top-level use"
            )
        if session is None and parent is not None:
            session = parent.session_id
        task = self._p._fed.create_task(
            image=image,
            input_=input_,
            organizations=organizations,
            name=name,
            databases=databases,
            parent=parent,
            session=session,
            store_as=store_as,
            wait=wait,
        )
        return task.to_dict()

    def get(self, task_id: int) -> dict[str, Any]:
        return self._p._fed.get_task(task_id).to_dict()


class _ResultSubClient:
    def __init__(self, parent: AlgorithmClient):
        self._p = parent

    def get(self, task_id: int) -> list[Any]:
        """Reference: GET /api/result?task_id — list of decrypted results."""
        return self._p._fed.wait_for_results(task_id)

    def from_task(self, task_id: int) -> list[Any]:
        return self.get(task_id)


class _RunSubClient:
    def __init__(self, parent: AlgorithmClient):
        self._p = parent

    def from_task(self, task_id: int) -> list[dict[str, Any]]:
        t = self._p._fed.get_task(task_id)
        return [
            {
                "id": r.id,
                "organization": r.organization,
                "status": r.status.value,
                "result": r.result,
                "log": r.log,
            }
            for r in t.runs
        ]


class _OrganizationSubClient:
    def __init__(self, parent: AlgorithmClient):
        self._p = parent

    def list(self) -> list[dict[str, Any]]:
        return self._p._fed.organizations()

    def get(self, id_: int) -> dict[str, Any]:
        return self._p._fed.organizations()[id_]
