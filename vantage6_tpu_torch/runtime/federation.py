"""The Federation orchestrator: server + nodes, re-founded on one mesh.

Parity mapping (SURVEY.md §3):

- reference server task queue + SocketIO fan-out  -> `create_task` dispatch
- node daemon picking up a task                   -> per-station execution
- DockerManager policy check / image check        -> `_check_policies`
- algorithm container running `wrap_algorithm`    -> `AlgorithmEnvironment`
  bound around the registered function
- node harvesting results + PATCH status          -> Run.finish/crash
- `wait_for_results` polling over HTTPS           -> immediate fetch (host
  mode) or an on-device stacked result (device mode)

Two execution modes per partial function:

- **host mode** (default): arbitrary Python (pandas/sklearn) runs per-station
  in-process — full reference compatibility for existing algorithm logic.
- **device mode** (`@device_step`): the partial is vmap-able; all
  stations execute as ONE batched program via `FederationMesh.fed_map(...,
  batched=True)` (``torch.func.vmap`` over the station axis), results stay
  on the card, and aggregation is a masked reduction over the station
  axis. This is the card's fast path that replaces container lifecycle +
  HTTPS polling. A partial that cannot run under vmap crashes its runs
  with the traceback; there is no per-station loop to fall back to.

Counterpart of ``vantage6_tpu/runtime/federation.py``, on one card or over
the ranks of a ``torch.distributed`` group (``group=``, one card a rank:
``FederationMesh(..., group=, devices_per_station=)``, every rank running
the same task program, its host runs executed once, on their station's
rank, and shared through ``runtime.ranks``), with
the learning-plane record of device aggregations (``learning_history``),
the host-plane delta compression (``compress_update``/
``decompress_update``, error feedback kept per station) and the ops
plane: the watchdog feed (``watchdog_feed``), the autopilot with the
Federation as its actuator (``autopilot: {enabled: true}``), the fleet
push at round boundaries (``attach_fleet_push``), the ``V6T_FAULTS``
points of host runs, the ``async_round`` flight note, and RSA org
identities (a run's ``identity``/``org_identities``, made on first use).
"""
from __future__ import annotations

import contextlib
import fnmatch
import threading
import time
import traceback
from types import ModuleType
from typing import Any, Callable

import numpy as np
import torch

from vantage6_tpu_torch.algorithm.context import (
    AlgorithmEnvironment,
    RunMetadata,
    algorithm_environment,
)
from vantage6_tpu_torch.algorithm.data_loading import load_data
from vantage6_tpu_torch.algorithm.decorators import is_v6t_function
from vantage6_tpu_torch.common.enums import TaskStatus
from vantage6_tpu_torch.core.config import DatabaseConfig, FederationConfig
from vantage6_tpu_torch._tree import tree_map
from vantage6_tpu_torch.core.mesh import FederationMesh, Station
from vantage6_tpu_torch.runtime.executor import StationExecutor
from vantage6_tpu_torch.runtime.task import Run, Task, new_run_ids, new_task
from vantage6_tpu_torch.runtime.tracing import TRACER

# how often a wait over a group looks for the other ranks' records
PLANE_POLL_S = 0.005


class Federation:
    """One collaboration's stations + task engine.

    ``algorithms`` maps an image name (the reference's Docker-image role) to a
    module or ``{name: fn}`` dict of algorithm functions. ``device`` is the
    card the stations' device-mode partials run on (CUDA unless ``"cpu"``
    is asked for). ``config.compressor`` arms ``compress_update``;
    ``config.learning_stats`` records every device-mode aggregation into
    the learning plane.

    ``group`` (a ``torch.distributed`` process group, ``core.distributed``)
    spreads the stations over its ranks in slots of
    ``config.devices_per_station`` ranks, the reference's mesh over every
    process's devices; every rank builds the Federation and runs the same
    task program. A device-mode step runs each rank's ``[S_local, ...]``
    block and gathers the rows once, so every run's result reads on every
    rank; ``aggregate_stacked`` reduces the local rows with the
    collectives (``mesh=``). A host-mode run executes once, on the first
    rank of its station's slot, and its record is shared with the other
    ranks (``runtime.ranks``): every rank's task records are the
    one-process Federation's. ``kill_task``, ``run_buffered`` and the
    autopilot act on this rank's records.
    """

    def __init__(
        self,
        config: FederationConfig,
        device: str | torch.device | None = None,
        algorithms: dict[str, ModuleType | dict[str, Callable]] | None = None,
        metrics: Any = None,
        group: Any = None,
    ):
        config.validate()
        if config.devices_per_station != 1 and group is None:
            raise NotImplementedError(
                "a Federation without a process group runs every station "
                "in this process, on one card; stations spanning ranks "
                "(devices_per_station > 1) need the ranks: pass group= "
                "(core.distributed), as ROADMAP.md queue 1, item 12.5 "
                "describes"
            )
        self.config = config
        # optional MetricsLogger: host runs emit queued→started→finished
        # lifecycle events so stragglers are visible (runtime.metrics)
        self.metrics = metrics
        self.mesh = FederationMesh(
            config.n_stations, device=device, group=group,
            devices_per_station=config.devices_per_station)
        self._plane = None
        if group is not None:
            from vantage6_tpu_torch.runtime.ranks import RankPlane

            self._plane = RankPlane(self, group)
        self.stations = [
            Station(index=i, name=s.name, organization=s.organization or s.name)
            for i, s in enumerate(config.stations)
        ]
        self._online = [True] * config.n_stations
        # -------------------------------------------- autopilot actuator state
        # masked: autopilot (or operator) exclusion from selection AND the
        # participation mask — an anomalous station keeps its runs but its
        # results carry zero aggregate weight. selection weights bias
        # run_buffered's over-selection away from stragglers. staleness
        # counts rounds since a station last landed an accepted update
        # (run_buffered credit; AsyncRoundSpec discounts on it). The
        # admission flag makes _dispatch queue host runs instead of
        # submitting (queue_buildup remediation).
        self._masked = [False] * config.n_stations
        self._selection_weights = [1.0] * config.n_stations
        self._staleness = [0] * config.n_stations
        self._admission_limited = False
        # fused K-round dispatches driven through run_fused_rounds — the
        # round index each dispatch's metrics record carries
        self._fused_dispatches = 0
        # per-station LOCAL secrets (DH mask agreement, secureagg_dh):
        # generated here exactly as each real node would generate its own;
        # central/aggregator code has no accessor — partials reach their own
        # station's secret through the AlgorithmEnvironment only
        import secrets as _secrets

        self._station_secrets = [
            _secrets.token_bytes(32) for _ in range(config.n_stations)
        ]
        # org RSA identity keys (advert signing, secureagg_dh): generated
        # LAZILY — RSA keygen costs seconds and most workloads never sign
        self._identity_cryptors: list[Any] = [None] * config.n_stations  # guarded-by: _identity_lock
        # station data: per-station {label: dataset}; device-mode stacked
        # arrays cached per label.
        self._data: list[dict[str, Any]] = [{} for _ in self.stations]
        # sessions (reference v4.7): per-station in-memory dataframe stores,
        # keyed session id -> {handle: DataFrame} — the simulator analogue
        # of each node's local pickle store. Session BOOKKEEPING is shared
        # between the user thread (create/delete) and pool workers
        # (store_as finishes).
        self._sessions: dict[int, dict[str, Any]] = {}  # guarded-by: _session_lock
        self._session_stores: list[dict[int, dict[str, Any]]] = [
            {} for _ in self.stations
        ]
        self._session_ids = iter(range(1, 10**9))
        self._stacked_cache: dict[str, Any] = {}  # guarded-by: _stacked_lock
        self._algorithms: dict[str, dict[str, Callable]] = {}
        for image, mod in (algorithms or {}).items():
            self.register_algorithm(image, mod)
        self.tasks: dict[int, Task] = {}
        # ------------------------------------------------ host executor pool
        # Host-mode runs dispatch onto a StationExecutor (per-station FIFO
        # serialization over a shared thread pool); 0 workers = today's
        # fully synchronous dispatch. Concurrency makes these shared
        # structures contended — each gets its own lock:
        workers = config.resolved_executor_workers()
        self._executor: StationExecutor | None = (
            StationExecutor(config.n_stations, workers) if workers > 0 else None
        )
        if self._executor is not None:
            # abandoned Federations (construction sites predating close())
            # must not leak pool threads: tear the executor down at GC.
            # finalize refs the EXECUTOR, not self — no resurrection cycle.
            import weakref

            self._executor_finalizer = weakref.finalize(
                self, StationExecutor.close, self._executor
            )
        # run ids queued/executing on the pool (NOT the same as PENDING:
        # a PENDING run on an offline station is owed, not in flight)
        self._inflight_runs: set[int] = set()  # guarded-by: _inflight_lock
        # --------------------------------------------- gradient compression
        # Host-plane delta compression: ONE DeltaCompressor holds every
        # station's error-feedback accumulator (keyed "station:name", each
        # station's compression error re-injected into ITS next update).
        # Its internal lock guards the bookkeeping; pool workers for
        # different stations compress concurrently, and the per-station
        # FIFO guarantees one station never races itself.
        self.compressor = config.compressor
        self._delta_compressor = None
        if self.compressor is not None and not getattr(
            self.compressor, "identity", False
        ):
            from vantage6_tpu_torch.fed.compression import DeltaCompressor

            self._delta_compressor = DeltaCompressor(
                self.compressor, device=self.mesh.device)
        self._inflight_lock = threading.Lock()
        self._stacked_lock = threading.Lock()   # _stacked_cache builds
        self._identity_lock = threading.Lock()  # lazy RSA keygen
        self._session_lock = threading.Lock()   # session bookkeeping
        # ------------------------------------------------------- watchdog
        # feed the process watchdog this federation's run/queue state
        # (stuck_run + queue_buildup + straggler_station in the simulator
        # topology, same rules the server feeds from its DB). Weakref
        # closure: an abandoned Federation must not be pinned alive by the
        # singleton — a dead ref yields None and close() unregisters.
        import weakref

        from vantage6_tpu_torch.runtime.watchdog import WATCHDOG

        self._watchdog_key = key = f"federation-{id(self)}"
        wref = weakref.ref(self)

        def _feed() -> dict[str, Any] | None:
            fed = wref()
            if fed is None:
                # GC'd without close(): reap the registration from inside
                # its own callback, or abandoned Federations would grow
                # the singleton's feed table forever
                WATCHDOG.unregister_feed(key, _feed)
                return None
            return fed.watchdog_feed()

        self._watchdog_feed_fn = _feed
        WATCHDOG.register_feed(key, _feed)
        # ------------------------------------------------------- autopilot
        # opt-in closed-loop remediation (config.autopilot.enabled): the
        # Federation is its own actuator — mask_station /
        # set_selection_weight / set_admission_limited below. close()
        # detaches the listener.
        # ------------------------------------------------------ fleet push
        # opt-in (attach_fleet_push): a Federation embedded next to a real
        # control plane ships its snapshot at round boundaries, so the
        # fleet view covers the aggregator process too — not just daemons
        self.fleet = None
        self.autopilot = None
        ap_cfg = dict(config.autopilot or {})
        if ap_cfg.get("enabled"):
            from vantage6_tpu_torch.runtime.autopilot import Autopilot

            self.autopilot = Autopilot(
                actuator=self,
                dry_run=ap_cfg.get("dry_run"),
                disable=set(ap_cfg.get("disable") or ()),
                config={
                    k: v for k, v in ap_cfg.items()
                    if k not in ("enabled", "dry_run", "disable")
                },
                listener_key=f"autopilot-{key}",
            ).attach()

    # ------------------------------------------------------------ fleet push
    def attach_fleet_push(
        self,
        request: Callable[..., Any],
        source: str | None = None,
        interval: float | None = None,
    ) -> Any:
        """Arm fleet telemetry pushes for this Federation. ``request`` is
        any REST callable with the ``request(method, endpoint,
        json_body=...)`` shape (a bound ``RestSession.request``, a
        daemon's replica-rotating ``request``). Pushes ride the round
        boundaries (:meth:`wait_for_results`, :meth:`run_buffered`,
        :meth:`run_fused_rounds`), rate-limited to the push interval —
        an embedder that never calls this pays nothing."""
        from vantage6_tpu_torch.common.fleet import FleetPusher

        self.fleet = FleetPusher(
            source=source or f"federation:{self.config.name}",
            service="federation",
            request=request,
            interval=interval,
        )
        return self.fleet

    def _fleet_tick(self) -> None:
        pusher = self.fleet
        if pusher is not None:
            pusher.maybe_push()  # fail-soft + capability-pinned inside

    # ------------------------------------------------------------------ data
    def load_all_data(self) -> None:
        """Read every station's configured databases (csv/parquet/sql/...)."""
        for i, scfg in enumerate(self.config.stations):
            for db in scfg.databases:
                self._data[i][db.label] = load_data(db)
        # under the lock: a pooled device run could be building a stacked
        # entry from the OLD data concurrently; clear must not interleave
        with self._stacked_lock:
            self._stacked_cache.clear()

    def set_datasets(self, label: str, datasets: list[Any]) -> None:
        """Programmatically supply one dataset per station (mock-style)."""
        if len(datasets) != self.n_stations:
            raise ValueError(
                f"need {self.n_stations} datasets, got {len(datasets)}"
            )
        for i, d in enumerate(datasets):
            self._data[i][label] = d
        with self._stacked_lock:
            self._stacked_cache.pop(label, None)

    def station_data(self, station: int, label: str = "default") -> Any:
        if label not in self._data[station]:
            raise KeyError(
                f"station {self.stations[station].name} has no data {label!r} "
                "(call load_all_data() or set_datasets())"
            )
        return self._data[station][label]

    def stacked_data(self, label: str = "default") -> Any:
        """Stack all stations' array data [S, ...] and shard over the mesh.

        Device-mode partials consume this; requires homogeneous shapes (pad +
        mask ragged data upstream — see fed.collectives participation masks).
        """
        with self._stacked_lock:
            if label not in self._stacked_cache:
                per = [
                    self.station_data(i, label) for i in range(self.n_stations)
                ]
                stacked = tree_map(
                    lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]),
                    per[0], *per[1:],
                )
                self._stacked_cache[label] = self.mesh.shard_stacked(stacked)
            return self._stacked_cache[label]

    # ------------------------------------------------------------ algorithms
    def register_algorithm(
        self, image: str, module: ModuleType | dict[str, Callable]
    ) -> None:
        if isinstance(module, dict):
            fns = dict(module)
        else:
            # Only functions DEFINED in the module are dispatchable — imported
            # helpers (decorators, torch, ...) must not become callable methods.
            # Exception: a dynamically assembled module (types.ModuleType, no
            # __spec__) can't satisfy the __module__ check — functools.wraps
            # keeps the defining file's name — so there, and only there,
            # v6t-decorated functions are dispatchable too. Real imported
            # modules keep the strict filter: an imported decorated partial
            # must not become remotely callable under this image's name.
            dynamic = getattr(module, "__spec__", None) is None
            fns = {
                name: fn
                for name, fn in vars(module).items()
                if callable(fn)
                and not name.startswith("_")
                and (
                    getattr(fn, "__module__", None) == module.__name__
                    or (dynamic and is_v6t_function(fn))
                )
            }
        self._algorithms[image] = fns

    def resolve_function(self, image: str, method: str) -> Callable | None:
        return self._algorithms.get(image, {}).get(method)

    # ------------------------------------------------------------- stations
    @property
    def n_stations(self) -> int:
        return len(self.stations)

    def organization_ids(self) -> list[int]:
        return list(range(self.n_stations))

    def organizations(self) -> list[dict[str, Any]]:
        return [
            {"id": s.index, "name": s.organization}
            for s in self.stations
        ]

    def set_station_online(self, station: int, online: bool) -> None:
        """Failure injection: an offline station's runs stay PENDING (the
        reference queues tasks for offline nodes the same way)."""
        was = self._online[station]
        self._online[station] = online
        if online and not was:
            self._drain_pending(station)

    def participation_mask(self) -> torch.Tensor:
        """1.0 for stations that may contribute to aggregates: online AND
        not masked out by the autopilot/operator. An [S] f32 tensor on the
        mesh's device."""
        return torch.tensor(
            [
                1.0 if (on and not masked) else 0.0
                for on, masked in zip(self._online, self._masked)
            ],
            dtype=torch.float32,
            device=self.mesh.device,
        )

    # ------------------------------------------------- autopilot capabilities
    # The duck-typed actuator surface runtime.autopilot probes (the engine
    # skips policies whose capability is absent). All are also callable by
    # operators directly.
    def mask_station(self, station: int, masked: bool = True) -> None:
        """Exclude (or re-include) a station from `participation_mask` and
        from run_buffered selection — the anomalous_station remediation.
        Its runs still execute; their results just carry zero weight."""
        self._masked[station] = bool(masked)

    def set_selection_weight(self, station: int, weight: float) -> None:
        """Bias run_buffered's weighted over-selection — the
        straggler_station remediation shrinks this toward 0 (never to 0:
        selection keeps a floor so the station can redeem itself)."""
        if weight < 0:
            raise ValueError("selection weight must be >= 0")
        self._selection_weights[station] = float(weight)

    def set_admission_limited(self, limited: bool) -> None:
        """Admission control (queue_buildup remediation): when limited,
        newly created host runs stay PENDING instead of dispatching onto
        the executor. Lifting the limit drains everything queued."""
        was = self._admission_limited
        self._admission_limited = bool(limited)
        if was and not limited:
            for station in range(self.n_stations):
                if self._online[station]:
                    self._drain_pending(station, wait=False)

    def selection_weights(self) -> list[float]:
        return list(self._selection_weights)

    def station_staleness(self) -> list[int]:
        """Rounds since each station last landed an accepted update in a
        buffered-async round (0 = accepted last round / never selected)."""
        return list(self._staleness)

    # ----------------------------------------------------------------- tasks
    # --------------------------------------------------------------- sessions
    def create_session(self, name: str = "session") -> int:
        """A workspace whose named dataframes persist at each station
        between tasks (reference v4.7 'sessions'); returns its id."""
        sid = next(self._session_ids)
        with self._session_lock:
            self._sessions[sid] = {"name": name, "dataframes": {}}
        return sid

    def session_dataframes(self, session_id: int) -> dict[str, Any]:
        """Bookkeeping: handle -> {ready, columns} (content stays local)."""
        return dict(self._sessions[session_id]["dataframes"])

    def delete_session(self, session_id: int) -> None:
        # one locked region for bookkeeping AND stores: a store_as run
        # finishing concurrently inserts its dataframe under this same
        # lock only while the session still exists, so the cleanup below
        # can never race a re-insert (which would leak the dataframe)
        with self._session_lock:
            self._sessions.pop(session_id, None)
            for store in self._session_stores:
                store.pop(session_id, None)

    def create_task(
        self,
        image: str,
        input_: dict[str, Any],
        organizations: list[int] | None = None,
        name: str = "task",
        databases: list[dict[str, Any]] | None = None,
        parent: Task | None = None,
        init_user: str = "",
        session: int | None = None,
        store_as: str | None = None,
        wait: bool = True,
    ) -> Task:
        """Create + dispatch a task (reference: POST /api/task + fan-out).

        ``input_`` is the reference's wire shape: ``{"method", "args",
        "kwargs"}``. Host-mode runs dispatch onto the station executor pool
        (per-station serialization; docs/host_executor.md); with the default
        ``wait=True`` this call blocks until every dispatched run reached a
        terminal state, so statuses observed afterwards match the historical
        synchronous behavior. ``wait=False`` returns immediately with the
        dispatched runs in flight (PENDING until a worker starts them, then
        ACTIVE) — poll with ``wait_for_results(timeout=..., interval=...)``.
        Offline stations keep their runs PENDING (not in flight) until
        `set_station_online` drains them, in both modes.
        """
        method = input_.get("method")
        if not method:
            raise ValueError('input_ needs a "method"')
        if session is not None and session not in self._sessions:
            raise ValueError(f"unknown session {session}")
        if store_as is not None and session is None:
            raise ValueError("store_as requires a session")
        for d in databases or []:
            if d.get("type") == "session":
                if session is None:
                    raise ValueError(
                        "session dataframe reference without a session"
                    )
                handle = d.get("dataframe") or d.get("label")
                if handle not in self._sessions[session]["dataframes"]:
                    raise ValueError(
                        f"session has no dataframe {handle!r} (known: "
                        f"{sorted(self._sessions[session]['dataframes'])})"
                    )
        if parent and not init_user:
            # Subtasks act on behalf of the user who created the parent, so
            # allowed_users policies apply to the whole task tree.
            init_user = parent.init_user
        orgs = (
            list(organizations)
            if organizations is not None
            else self.organization_ids()
        )
        for o in orgs:
            if not 0 <= o < self.n_stations:
                raise ValueError(f"unknown organization id {o}")
        fields = dict(
            name=name,
            method=method,
            image=image,
            organizations=[self.stations[o].organization for o in orgs],
            input_=input_,
            databases=databases or [{"label": "default"}],
            parent_id=parent.id if parent else None,
            collaboration=self.config.name,
            init_user=init_user,
            session_id=session,
            store_as=store_as,
        )
        # on-wire input size (estimated v2 frame bytes, metadata-only walk —
        # no device transfer, no actual encode): one measurement shared by
        # every run, the same way a v2 broadcast shares one ciphertext
        from vantage6_tpu_torch.common.serialization import wire_nbytes

        fields["input_wire_bytes"] = wire_nbytes(input_)
        if self._plane is None:
            task = new_task(**fields)
            self._open_task(task, new_run_ids(len(orgs)), orgs)
        else:
            task = self._create_over_ranks(fields, orgs, top=parent is None)
        if wait:
            self._await_inflight(task.runs)
        return task

    def _open_task(self, task: Task, run_ids: list[int],
                   orgs: list[int]) -> None:
        """Give ``task`` its runs (ids ``run_ids``, one a station of
        ``orgs``), record it and dispatch it."""
        if task.store_as is not None:
            # a pool worker finishing a concurrent store_as run mutates the
            # same bookkeeping dict from _refresh_session_ready
            with self._session_lock:
                self._sessions[task.session_id]["dataframes"][
                    task.store_as] = {"ready": False, "columns": []}
        task.runs = [
            Run(
                id=run_id,
                task_id=task.id,
                organization=self.stations[o].organization,
                station_index=o,
                input_wire_bytes=task.input_wire_bytes,
            )
            for run_id, o in zip(run_ids, orgs, strict=True)
        ]
        self.tasks[task.id] = task
        # in-process analogue of the server's dispatch span: roots a new
        # trace when the caller isn't already inside one, so a simulator
        # round traces exactly like a daemon-topology round
        with TRACER.span(
            "server.dispatch", kind="dispatch", service="federation",
            attrs={"task_id": task.id, "n_runs": len(task.runs)},
        ):
            self._dispatch(task)

    # ----------------------------------------------------- across the ranks
    def _create_over_ranks(self, fields: dict[str, Any], orgs: list[int],
                           top: bool) -> Task:
        """A task created over the group: the k-th top-level task is rank
        0's k-th ``task`` event, a task a run creates is posted by the
        run's rank; every rank opens it when it applies the event."""
        plane = self._plane
        if top:
            k = plane.next_top()
            if self.mesh.rank == 0:
                self._post_task(fields, orgs, root=k, top=True)
            return self.tasks[plane.top_task(k)]
        root = plane.roots[fields["parent_id"]]
        return self.tasks[plane.answer(self._post_task(fields, orgs, root))]

    def _post_task(self, fields: dict[str, Any], orgs: list[int],
                   root: int, top: bool = False) -> int:
        task_id, run_ids = self._plane.ids(len(orgs))
        return self._plane.post("task", dict(
            id=task_id, fields=fields, run_ids=run_ids, orgs=orgs, top=top),
            root=root)

    def _apply_task(self, event: dict[str, Any]) -> int:
        task = Task(id=event["id"], **event["fields"])
        self._plane.roots[task.id] = event["root"]
        if event["top"]:
            self._plane.top_tasks[event["root"]] = task.id
        self._open_task(task, event["run_ids"], event["orgs"])
        return task.id

    def _post_run(self, run: Run) -> None:
        """Share a host run's terminal record with the other ranks; a
        result they cannot load fails the run, here and there."""
        from vantage6_tpu_torch.runtime.ranks import UnshareableError

        def post():
            self._plane.post("run", dict(
                task=run.task_id, run=run.id, status=run.status.value,
                result=run.result, log=run.log, queued_at=run.queued_at,
                started_at=run.started_at, finished_at=run.finished_at,
                result_wire_bytes=run.result_wire_bytes),
                root=self._plane.roots[run.task_id])

        try:
            post()
        except UnshareableError as e:
            with run._lock:
                run.status, run.result = TaskStatus.FAILED, None
                run.log = "\n".join(filter(None, (run.log, str(e))))
            post()

    def _apply_run(self, event: dict[str, Any]) -> None:
        if event["from"] == self.mesh.rank:
            return  # the record this rank wrote
        task = self.tasks[event["task"]]
        run = next(r for r in task.runs if r.id == event["run"])
        with run._lock:
            run.status = TaskStatus(event["status"])
            run.result, run.log = event["result"], event["log"]
            run.queued_at, run.started_at, run.finished_at = (
                event["queued_at"], event["started_at"],
                event["finished_at"])
            run.result_wire_bytes = event["result_wire_bytes"]
        with self._inflight_lock:
            self._inflight_runs.discard(run.id)
        if task.store_as:
            self._refresh_session_ready(task)

    def _apply_aggregate(self, event: dict[str, Any]) -> Any:
        return self._aggregate(self.tasks[event["task"]], event["weights"],
                               event["agg_mode"])

    def get_task(self, task_id: int) -> Task:
        return self.tasks[task_id]

    def kill_task(self, task_id: int) -> None:
        """Parity: the server's `kill` SocketIO event.

        Under the executor pool this also interrupts QUEUED runs mid-flight:
        a killed run's queue item is skipped when a worker pops it (terminal
        states are sticky — see Run), and a run killed while executing has
        its late result dropped by `Run.finish`.
        """
        for r in self.tasks[task_id].runs:
            r.kill()

    # --------------------------------------------- buffered-async rounds
    def select_stations(
        self,
        n: int,
        rng: np.random.Generator | None = None,
        pool: list[int] | None = None,
    ) -> list[int]:
        """Weighted sample (without replacement) of ``n`` eligible
        stations — online, not masked, optionally restricted to ``pool``
        — proportional to their selection weights. The autopilot's
        straggler remediation shrinks a weight; a shrunken station is
        still selectable (it can redeem itself), just rarely. Seed the
        generator for deterministic rounds."""
        rng = rng if rng is not None else np.random.default_rng()
        candidates = [
            i for i in (pool if pool is not None else range(self.n_stations))
            if self._online[i] and not self._masked[i]
        ]
        if not candidates:
            raise RuntimeError(
                "no eligible stations (all offline or masked)"
            )
        if n >= len(candidates):
            return candidates
        weights = np.asarray(
            [self._selection_weights[i] for i in candidates], np.float64
        )
        # a zero-weight station stays reachable when nothing else is; the
        # tiny floor keeps the distribution valid without letting a
        # shrunken straggler outdraw healthy peers
        weights = np.maximum(weights, 1e-9)
        chosen = rng.choice(
            len(candidates), size=n, replace=False, p=weights / weights.sum()
        )
        return sorted(candidates[int(j)] for j in chosen)

    def run_buffered(
        self,
        image: str,
        input_: dict[str, Any],
        spec: Any,  # fed.fedavg.AsyncRoundSpec (duck-typed: core stays light)
        organizations: list[int] | None = None,
        rng: np.random.Generator | None = None,
        name: str = "async_round",
        databases: list[dict[str, Any]] | None = None,
        parent: "Task | None" = None,
        interval: float = 0.01,
    ) -> dict[str, Any]:
        """One FedBuff-style buffered round (tentpole layer a): dispatch
        ``spec.quorum + spec.over_select`` stations, accept the FIRST
        ``quorum`` completions, kill whatever is still running at quorum
        or at ``spec.deadline_s`` — via the existing `kill_task`, whose
        per-run kills are no-ops on completed runs (terminal-sticky Run
        transitions make over-kill safe) — and credit staleness: accepted
        stations reset to 0, selected-but-not-accepted stations +1.

        Returns a dict with the finished ``task``, ``accepted`` /
        ``killed`` station lists, an ``accept_mask`` [S] float array and
        the pre-credit ``staleness`` [S] array — exactly the
        ``FedAvg.async_round(accept_mask=..., staleness=...)`` inputs, so
        masks, compression EF and learning stats compose through the
        unchanged round.

        Over-selection rides the normal dispatch (and, in the daemon
        topology, claim-batch) unchanged: the extra ``over_select`` runs
        are ordinary runs that happen to get killed late.
        """
        spec.validate()
        rng = rng if rng is not None else np.random.default_rng()
        selected = self.select_stations(
            spec.n_select, rng=rng, pool=organizations
        )
        quorum = min(spec.quorum, len(selected))
        t0 = time.monotonic()
        with TRACER.span(
            "async.round", kind="dispatch", service="federation",
            attrs={
                "quorum": quorum, "selected": len(selected),
                "deadline_s": spec.deadline_s,
            },
        ):
            task = self.create_task(
                image, input_, organizations=selected, name=name,
                databases=databases, parent=parent, wait=False,
            )
            deadline = t0 + spec.deadline_s
            while True:
                done = [
                    r for r in task.runs
                    if r.status == TaskStatus.COMPLETED
                ]
                if len(done) >= quorum:
                    break
                if time.monotonic() >= deadline:
                    break
                if not self._runs_in_flight(task.runs):
                    # nothing left running (failures / offline stations):
                    # waiting out the deadline would buy nothing
                    break
                step = max(1e-3, min(interval, deadline - time.monotonic()))
                if self._executor is not None:
                    self._executor.help_or_wait(step)
                else:
                    time.sleep(step)
            # first-K by completion time IS the buffer: a run completing
            # after the quorum snapshot still exists, it just isn't in
            # this round's aggregate
            done.sort(key=lambda r: (r.finished_at or 0.0, r.id))
            accepted = done[:quorum]
            # kill_task, not per-run surgery: terminal-sticky transitions
            # keep every COMPLETED run completed; only live stragglers
            # flip to KILLED
            self.kill_task(task.id)
        killed = [
            r.station_index for r in task.runs
            if r.status == TaskStatus.KILLED
        ]
        accepted_stations = sorted(r.station_index for r in accepted)
        accepted_set = set(accepted_stations)
        # staleness snapshot BEFORE credit: this round's accepted updates
        # are discounted by how long their stations were absent
        staleness = np.asarray(self._staleness, np.float32)
        for st in selected:
            self._staleness[st] = (
                0 if st in accepted_set else self._staleness[st] + 1
            )
        accept_mask = np.zeros(self.n_stations, np.float32)
        for st in accepted_stations:
            accept_mask[st] = 1.0
        from vantage6_tpu_torch.common.telemetry import REGISTRY

        REGISTRY.counter("v6t_async_rounds_total").inc()
        if killed:
            REGISTRY.counter("v6t_async_stragglers_killed_total").inc(
                len(killed)
            )
        try:
            from vantage6_tpu_torch.common.flight import FLIGHT

            FLIGHT.note(
                "async_round", task=task.id, quorum=quorum,
                selected=selected, accepted=accepted_stations,
                killed=sorted(killed), round_s=time.monotonic() - t0,
                deadline_s=spec.deadline_s,
            )
        except Exception:  # pragma: no cover
            pass
        self._fleet_tick()  # round boundary: ship the fleet snapshot
        return {
            "task": task,
            "selected": selected,
            "accepted": accepted_stations,
            "killed": sorted(killed),
            "accept_mask": accept_mask,
            "staleness": staleness,
            "quorum": quorum,
            "round_s": time.monotonic() - t0,
        }

    def run_fused_rounds(
        self,
        engine: Any,  # fed.fedavg.FedAvg (duck-typed: core stays light)
        params: Any,
        stacked_x: Any,
        stacked_y: Any,
        counts: Any,
        key: Any,
        n_rounds: int,
        opt_state: Any = None,
        donate: bool = True,
        metrics: Any = None,  # runtime.metrics.MetricsLogger
        batch_idx: Any = None,
    ) -> dict[str, Any]:
        """Thin host driver over the FUSED K-round device program: ONE
        ``engine.run_rounds`` call (on the card, one captured round
        replayed K times) carries this federation's CURRENT participation
        mask across all ``n_rounds`` rounds, and the host waits for the
        card once per dispatch instead of once per round. The roster is
        sampled at dispatch time — a station going offline mid-dispatch
        affects the NEXT dispatch, which is the fused program's
        freshness/throughput trade (pick K accordingly).

        ``metrics`` (a MetricsLogger) gets one ``round`` record per
        dispatch with ``rounds_per_dispatch=n_rounds``, so per-logical-
        round throughput stays comparable to the sequential driver.
        ``batch_idx`` (``[n_rounds, S, local_steps, batch]``, port only)
        injects the engine's batch indices instead of drawing them with
        ``key``. Returns ``{"params", "opt_state", "losses", "stats",
        "mask", "seconds", "rounds_per_sec"}``.
        """
        mask = self.participation_mask()

        def dispatch() -> Any:
            out = engine.run_rounds(
                params, stacked_x, stacked_y, counts, key, n_rounds,
                mask=mask, opt_state=opt_state, donate=donate,
                batch_idx=batch_idx,
            )
            if mask.device.type == "cuda":
                torch.cuda.synchronize(mask.device)
            return out

        t0 = time.monotonic()
        with TRACER.span(
            "fused.rounds", kind="dispatch", service="federation",
            attrs={"n_rounds": n_rounds,
                   "online": int(sum(self._online[i] and not self._masked[i]
                                     for i in range(self.n_stations)))},
        ):
            if metrics is not None:
                with metrics.round_timer(
                    self._fused_dispatches, rounds_per_dispatch=n_rounds
                ):
                    out = dispatch()
            else:
                out = dispatch()
        self._fused_dispatches += 1
        self._fleet_tick()  # dispatch boundary: ship the fleet snapshot
        dt = time.monotonic() - t0
        return {
            "params": out[0],
            "opt_state": out[1],
            "losses": out[2],
            "stats": out[3],
            "mask": mask,
            "seconds": dt,
            "rounds_per_sec": n_rounds / dt if dt > 0 else None,
        }

    # ------------------------------------------------------------- wait loop
    def _runs_in_flight(self, runs: list[Run]) -> list[Run]:
        with self._inflight_lock:
            return [r for r in runs if r.id in self._inflight_runs]

    def _await_inflight(
        self,
        runs: list[Run],
        timeout: float | None = None,
        interval: float = 0.1,
        task_id: int | None = None,
        stop_on_failure: bool = False,
    ) -> None:
        """Wait until none of ``runs`` is queued/executing on the pool.

        Inside an executor worker (a central partial waiting on its
        subtasks) each iteration lends the thread to queued work
        (StationExecutor.help_or_wait) — the rule that makes nested
        ``create_task`` deadlock-free at any pool size. ``stop_on_failure``
        returns early as soon as any run fails (wait_for_results raises on
        the failure without draining siblings first).
        """
        if self._executor is None and self._plane is None:
            # close() drops queued-but-unstarted work without clearing
            # _inflight_runs (the pool items never run their finally): say
            # so, instead of letting wait_for_results misread the stranded
            # PENDING runs as "offline stations"
            stranded = self._runs_in_flight(runs)
            if stranded:
                raise RuntimeError(
                    "federation closed while runs "
                    f"{[r.id for r in stranded]} were queued — their "
                    "queued work was dropped"
                )
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._plane is not None:
                # the other ranks' records, and what their runs ask of this
                # rank
                self._plane.apply()
            if stop_on_failure and any(r.status.has_failed for r in runs):
                return
            busy = self._runs_in_flight(runs)
            if not busy:
                return
            if deadline is not None and time.monotonic() >= deadline:
                stations = sorted({r.organization for r in busy})
                raise TimeoutError(
                    f"task {task_id if task_id is not None else busy[0].task_id}"
                    f" still running at {stations} after {timeout}s"
                )
            step = interval
            if self._plane is not None:
                step = min(step, PLANE_POLL_S)  # a record may come any time
            if deadline is not None:
                step = max(1e-3, min(step, deadline - time.monotonic()))
            executor = self._executor  # close() may null it mid-wait
            if executor is not None:
                executor.help_or_wait(step)
            elif self._plane is not None:
                time.sleep(step)
            else:
                raise RuntimeError(
                    "federation closed while waiting for runs "
                    f"{[r.id for r in busy]} — their queued work was dropped"
                )

    def wait_for_results(
        self,
        task_id: int,
        timeout: float | None = None,
        interval: float = 0.1,
    ) -> list[Any]:
        """Fetch results of finished runs (reference: poll /api/result).

        Blocks while the task's runs are queued/executing on the executor
        pool (``timeout``/``interval`` give the reference client's polling
        semantics; TimeoutError when the deadline passes first). Raises if
        the task failed; PENDING runs on offline stations — owed, not in
        flight — raise a RuntimeError naming the stations still owed a
        result.
        """
        task = self.tasks[task_id]
        self._await_inflight(
            task.runs, timeout=timeout, interval=interval, task_id=task_id,
            stop_on_failure=True,
        )
        bad = [r for r in task.runs if r.status.has_failed]
        if bad:
            r = bad[0]
            raise RuntimeError(
                f"task {task_id} {r.status.value} at {r.organization}: {r.log}"
            )
        waiting = [r.organization for r in task.runs if not r.status.is_finished]
        if waiting:
            raise RuntimeError(
                f"task {task_id} still waiting on offline station(s) "
                f"{waiting} — bring them online or re-create the task "
                "excluding them"
            )
        self._fleet_tick()  # round boundary: ship the fleet snapshot
        return task.results()

    # -------------------------------------------------------------- dispatch
    def _check_policies(self, task: Task, station: int) -> TaskStatus | None:
        """DockerManager-equivalent policy gate (SURVEY.md §2 item 11)."""
        if task.image not in self._algorithms:
            return TaskStatus.NO_IMAGE
        pol = self.config.stations[station].policies
        allowed = pol.get("allowed_algorithms")
        if allowed and not any(fnmatch.fnmatch(task.image, a) for a in allowed):
            return TaskStatus.NOT_ALLOWED
        users = pol.get("allowed_users")
        # An anonymous task does NOT bypass a user allow-list: deny-by-default.
        if users and task.init_user not in users:
            return TaskStatus.NOT_ALLOWED
        return None

    def _dispatch(self, task: Task) -> None:
        fn = self.resolve_function(task.image, task.method)
        # Policy/image gates run per station first (a NO_IMAGE station fails
        # its run; others may still compute — reference behaves the same).
        runnable: list[Run] = []
        for run in task.runs:
            verdict = self._check_policies(task, run.station_index)
            if verdict is not None:
                run.status = verdict
                run.log = f"policy gate: {verdict.value}"
            elif fn is None:
                run.status = TaskStatus.FAILED
                run.log = (
                    f"method {task.method!r} not found in image {task.image!r}"
                )
            elif not self._online[run.station_index]:
                run.status = TaskStatus.PENDING  # queued until reconnect
            elif self._admission_limited and not getattr(
                fn, "__v6t_device_step__", False
            ):
                # autopilot admission control (queue_buildup): host runs
                # queue PENDING instead of dispatching; lifting the limit
                # drains them (set_admission_limited). Device-mode programs
                # are exempt — they never transit the executor backlog the
                # alert is about.
                run.status = TaskStatus.PENDING
            else:
                runnable.append(run)
        if not runnable or fn is None:
            return
        if getattr(fn, "__v6t_device_step__", False):
            # device mode stays synchronous: all stations already execute as
            # ONE batched program — there is nothing to parallelize host-side
            self._run_device_step(task, fn, runnable)
        else:
            self._run_host_runs(task, fn, runnable)

    def _run_host_runs(self, task: Task, fn: Callable,
                       runs: list[Run]) -> None:
        """Execute host runs, on the pool if there is one. Over a group
        only this rank's stations' runs execute here; the others' are in
        flight until their owner's record arrives (``_apply_run``)."""
        if self._plane is not None:
            remote = [r for r in runs
                      if not self._plane.owns(r.station_index)]
            with self._inflight_lock:
                self._inflight_runs.update(r.id for r in remote)
            runs = [r for r in runs if self._plane.owns(r.station_index)]
        for run in runs:
            if self._executor is None:
                self._run_host(task, fn, run)
            else:
                self._submit_host_run(task, fn, run)

    def _submit_host_run(self, task: Task, fn: Callable, run: Run) -> None:
        """Queue one host-mode run on the station executor (per-station FIFO
        — two runs never execute concurrently on one station)."""
        run.mark_queued()
        with self._inflight_lock:
            self._inflight_runs.add(run.id)
        # capture the submitter's trace context NOW: the pool worker that
        # executes the item has no ambient span, and without this capture
        # every pooled run would fall out of its task's trace
        trace_parent = TRACER.current_context()

        def item() -> None:
            try:
                # killed while queued: skip without ever going ACTIVE
                if not run.status.is_finished:
                    self._run_host(task, fn, run, trace_parent=trace_parent)
            finally:
                with self._inflight_lock:
                    self._inflight_runs.discard(run.id)

        self._executor.submit(run.station_index, item)

    def _resolve_frame(self, task: Task, station: int, d: dict[str, Any]):
        if d.get("type") == "session":
            handle = d.get("dataframe") or d.get("label")
            store = self._session_stores[station].get(task.session_id, {})
            if handle not in store:
                raise KeyError(
                    f"session {task.session_id} has no materialized "
                    f"dataframe {handle!r} at station {station} (did its "
                    "extraction task run?)"
                )
            return store[handle]
        return self.station_data(station, d.get("label", "default"))

    def _store_session_result(self, task: Task, run: Run, result: Any):
        """Persist a store_as run's dataframe at ITS station; the run's
        recorded result is metadata only (same contract as node.runner)."""
        import pandas as pd

        df = result
        if isinstance(df, dict) and "dataframe" in df:
            df = df["dataframe"]
        if not isinstance(df, pd.DataFrame):
            raise RuntimeError(
                f"task stores dataframe {task.store_as!r} but the algorithm"
                f" returned {type(result).__name__}, not a DataFrame"
            )
        meta = {
            "stored": task.store_as,
            "session_id": task.session_id,
            "rows": int(len(df)),
            "columns": [
                {"name": str(c), "dtype": str(t)}
                for c, t in df.dtypes.items()
            ],
        }
        # store + bookkeeping in ONE locked region, gated on the session
        # still existing: a delete_session racing this finish must neither
        # crash a successfully-computed run (KeyError on the popped
        # bookkeeping — same deleted-mid-run tolerance as
        # _refresh_session_ready) nor see the dataframe re-inserted after
        # its cleanup (an orphaned-store leak)
        with self._session_lock:
            session = self._sessions.get(task.session_id)
            if session is not None:
                self._session_stores[run.station_index].setdefault(
                    task.session_id, {}
                )[task.store_as] = df
                book = session["dataframes"].get(task.store_as)
                if book is not None:
                    book["columns"] = meta["columns"]
        return meta

    def _refresh_session_ready(self, task: Task) -> None:
        """ready = EVERY station's run completed. Evaluated AFTER each run's
        finish (not inside _store_session_result): with pooled execution two
        stations finishing concurrently would each see the other still
        ACTIVE and neither would flip the flag."""
        with self._session_lock:
            session = self._sessions.get(task.session_id)
            if session is None:  # deleted mid-run
                return
            book = session["dataframes"].get(task.store_as)
            if book is not None:
                book["ready"] = all(
                    r.status == TaskStatus.COMPLETED for r in task.runs
                )

    # -------------------------------------------------------------- identity
    def _station_identity(self, station: int):
        """This station's org RSA identity cryptor (lazy keygen, cached) —
        each real node would hold its own key file; the simulator generates
        one per station the first time an algorithm signs. Keygen is locked:
        concurrent pooled runs must not both generate (and then disagree on)
        a station's identity."""
        plane = self._plane
        if plane is not None and not plane.owns(station):
            raise RuntimeError(
                f"station {station}'s identity key is held by rank "
                f"{plane.owner(station)}, which runs its runs")
        if self._identity_cryptors[station] is None:
            from vantage6_tpu_torch.common.encryption import RSACryptor

            with self._identity_lock:
                if self._identity_cryptors[station] is None:
                    cryptor = RSACryptor(RSACryptor.create_new_rsa_key())
                    if plane is not None:  # the other ranks verify with it
                        plane.publish_identity(station,
                                               cryptor.public_key_str)
                    self._identity_cryptors[station] = cryptor
        return self._identity_cryptors[station]

    def _org_identity_registry(self) -> dict[int, str]:
        """station index -> base64 PEM public identity key, for ALL
        stations — the out-of-band trust root advert verification needs
        (over a group, the keys of the other ranks' stations as their
        owners published them)."""
        plane = self._plane
        return {
            i: (plane.identity(i) if plane is not None and not plane.owns(i)
                else self._station_identity(i).public_key_str)
            for i in range(self.n_stations)
        }

    def _resolve_frame(self, task: Task, station: int, d: dict[str, Any]):
        if d.get("type") == "session":
            handle = d.get("dataframe") or d.get("label")
            store = self._session_stores[station].get(task.session_id, {})
            if handle not in store:
                raise KeyError(
                    f"session {task.session_id} has no materialized "
                    f"dataframe {handle!r} at station {station} (did its "
                    "extraction task run?)"
                )
            return store[handle]
        return self.station_data(station, d.get("label", "default"))

    def _store_session_result(self, task: Task, run: Run, result: Any):
        """Persist a store_as run's dataframe at ITS station; the run's
        recorded result is metadata only (same contract as node.runner)."""
        import pandas as pd

        df = result
        if isinstance(df, dict) and "dataframe" in df:
            df = df["dataframe"]
        if not isinstance(df, pd.DataFrame):
            raise RuntimeError(
                f"task stores dataframe {task.store_as!r} but the algorithm"
                f" returned {type(result).__name__}, not a DataFrame"
            )
        meta = {
            "stored": task.store_as,
            "session_id": task.session_id,
            "rows": int(len(df)),
            "columns": [
                {"name": str(c), "dtype": str(t)}
                for c, t in df.dtypes.items()
            ],
        }
        # store + bookkeeping in ONE locked region, gated on the session
        # still existing: a delete_session racing this finish must neither
        # crash a successfully-computed run (KeyError on the popped
        # bookkeeping — same deleted-mid-run tolerance as
        # _refresh_session_ready) nor see the dataframe re-inserted after
        # its cleanup (an orphaned-store leak)
        with self._session_lock:
            session = self._sessions.get(task.session_id)
            if session is not None:
                self._session_stores[run.station_index].setdefault(
                    task.session_id, {}
                )[task.store_as] = df
                book = session["dataframes"].get(task.store_as)
                if book is not None:
                    book["columns"] = meta["columns"]
        return meta

    def _refresh_session_ready(self, task: Task) -> None:
        """ready = EVERY station's run completed. Evaluated AFTER each run's
        finish (not inside _store_session_result): with pooled execution two
        stations finishing concurrently would each see the other still
        ACTIVE and neither would flip the flag."""
        with self._session_lock:
            session = self._sessions.get(task.session_id)
            if session is None:  # deleted mid-run
                return
            book = session["dataframes"].get(task.store_as)
            if book is not None:
                book["ready"] = all(
                    r.status == TaskStatus.COMPLETED for r in task.runs
                )

    # ------------------------------------------------------------- host mode
    def _run_host(
        self, task: Task, fn: Callable, run: Run, trace_parent: Any = None,
    ) -> None:
        """Execute one host run here; over a group, then share its
        terminal record with the other ranks."""
        if self._plane is None:
            self._execute_host(task, fn, run, trace_parent)
            return
        try:
            self._execute_host(task, fn, run, trace_parent)
        finally:
            if run.started_at is not None and run.status.is_finished:
                self._post_run(run)

    def _execute_host(
        self, task: Task, fn: Callable, run: Run, trace_parent: Any = None,
    ) -> None:
        from vantage6_tpu_torch.algorithm.client import AlgorithmClient
        from vantage6_tpu_torch.common.faults import FAULTS

        if not run.start():
            return  # killed between queue-pop and start
        # fault-injection points (common.faults, V6T_FAULTS=): a delayed
        # station models slow hardware/data skew (straggler food group); a
        # dropped result leaves the run wedged ACTIVE — the stuck_run
        # watchdog rule's food, and what a crashed daemon looks like from
        # the server's side
        FAULTS.sleep_station_delay(run.station_index)
        if FAULTS.drop_result(run.station_index):
            return
        try:
            frames = [
                self._resolve_frame(task, run.station_index, d)
                for d in task.databases
            ]
        except Exception:
            run.crash(traceback.format_exc(limit=8))
            return
        env = AlgorithmEnvironment(
            dataframes=frames,
            client=AlgorithmClient(self, task=task, station=run.station_index),
            metadata=RunMetadata(
                task_id=task.id,
                run_id=run.id,
                node_id=run.station_index,
                organization=run.organization,
                collaboration=self.config.name,
            ),
            station_secret=self._station_secrets[run.station_index],
            # zero-arg factories: RSA keygen costs seconds, so identities
            # materialize only if the algorithm actually signs/verifies
            identity=lambda i=run.station_index: self._station_identity(i),
            org_identities=self._org_identity_registry,
        )
        args = task.input_.get("args", []) or []
        kwargs = task.input_.get("kwargs", {}) or {}
        try:
            # kind="exec" feeds the straggler view; the parent is either
            # the captured submit-time context (pooled path) or the
            # ambient dispatch span (synchronous path)
            with TRACER.span(
                "runner.exec", kind="exec", service="federation",
                parent=(
                    trace_parent if trace_parent is not None
                    else TRACER.current_context()
                ),
                attrs={
                    "task_id": task.id, "run_id": run.id,
                    "station": run.station_index,
                    "organization_id": run.organization,
                },
                require_parent=True,
            ), algorithm_environment(env), self._in_run():
                result = fn(*args, **kwargs)
            if task.store_as:
                result = self._store_session_result(task, run, result)
            # size the result BEFORE finish (post-kill the record is
            # immutable); metadata-only walk, None when not wire-shaped
            from vantage6_tpu_torch.common.serialization import wire_nbytes

            run.result_wire_bytes = wire_nbytes(result)
            if run.finish(result):
                if task.store_as:
                    self._refresh_session_ready(task)
            elif task.store_as:
                # killed mid-execution: finish() dropped the result, so the
                # already-committed dataframe must not stay readable either
                # — store state and run status would otherwise disagree
                self._session_stores[run.station_index].get(
                    task.session_id, {}
                ).pop(task.store_as, None)
        except Exception:
            run.crash(traceback.format_exc(limit=8))
        finally:
            if self.metrics is not None:
                from vantage6_tpu_torch.runtime.metrics import run_lifecycle

                self.metrics.log(
                    "host_run", task_id=task.id, **run_lifecycle(run)
                )

    @contextlib.contextmanager
    def _in_run(self):
        """Marks this thread as executing a run (over a group, what the
        run asks of the device plane is posted to every rank)."""
        if self._plane is None:
            yield
            return
        local = self._plane.local
        was, local.in_run = getattr(local, "in_run", False), True
        try:
            yield
        finally:
            local.in_run = was

    # ----------------------------------------------------------- device mode
    def _run_device_step(
        self, task: Task, fn: Callable, runnable: list[Run]
    ) -> None:
        """All stations' partials as ONE batched program.

        The function receives this station's tensor data (label of the
        task's first database) plus input_ args/kwargs; `fed_map` runs it
        under ``torch.func.vmap`` across the FULL station axis (one program
        — non-participants compute too, but their output is excluded), and
        participating stations' slices land in their Run records as device
        tensors. The full stacked output plus a [S] participation mask are
        kept on the task so central code aggregates on device with the mask
        (fed collectives all accept one). Tensor and numpy leaves of the
        args/kwargs are placed on the mesh's device first (JAX moves them
        implicitly; torch refuses mixed devices).
        """
        label = task.databases[0].get("label", "default")
        args = self._place_args(tuple(task.input_.get("args", []) or []))
        kwargs = self._place_args(dict(task.input_.get("kwargs", {}) or {}))
        for run in runnable:
            run.start()
        try:
            # ONE span for the collective program (all stations execute it
            # together — a per-station split would be fiction); joins the
            # ambient dispatch span so device rounds trace like host rounds
            with TRACER.span(
                "device.step", kind="exec", service="federation",
                attrs={
                    "task_id": task.id,
                    "n_stations": len(runnable),
                },
                require_parent=True,
            ):
                stacked = self.stacked_data(label)
                out = self.mesh.fed_map(
                    lambda d: fn(d, *args, **kwargs), stacked, batched=True
                )
                if self.mesh.group is not None:
                    # every station's rows on every rank: a run's result
                    # reads here whichever rank computed it
                    from vantage6_tpu_torch.fed.collectives import (
                        all_gather_rows,
                    )

                    out = tree_map(lambda x: all_gather_rows(self.mesh, x),
                                   out)
        except Exception:
            tb = traceback.format_exc(limit=8)
            for run in runnable:
                run.crash(tb)
            return
        task.stacked_result = out
        mask = [0.0] * self.n_stations
        for run in runnable:
            mask[run.station_index] = 1.0
        new_mask = torch.tensor(mask, dtype=torch.float32,
                                device=self.mesh.device)
        task.participation = (
            new_mask
            if task.participation is None
            # A drain after reconnect adds to the already-completed set.
            else torch.maximum(task.participation, new_mask)
        )
        for run in runnable:
            i = run.station_index
            run.finish(tree_map(lambda x: x[i], out))

    def _place_args(self, tree: Any) -> Any:
        """Tensor and numpy leaves of a device step's args on the mesh's
        device; other leaves (Python scalars, strings) unchanged."""
        device = self.mesh.device

        def place(x: Any) -> Any:
            if isinstance(x, torch.Tensor):
                return x.to(device)
            if isinstance(x, np.ndarray):
                return torch.as_tensor(x, device=device)
            return x

        return tree_map(place, tree)

    # --------------------------------------------------- device aggregation
    def aggregate_stacked(
        self,
        task: "Task | int",
        weights: Any = None,
        agg_mode: str = "replicated",
    ) -> Any:
        """Weighted-mean aggregation of a device-mode task's stacked result,
        masked by its participation (the central half of a device-mode
        round, kept on device).

        ``agg_mode``:
          - ``"replicated"``: ``fed_mean`` — the weighted sum and division
            in each leaf's dtype.
          - ``"scattered"``: the flat f32 form (``fed_mean_scattered_tree``;
            on one card the scatter and the gather are the identity);
            f32-equivalent to replicated.
          - ``"scattered_bf16"``: same, with the summed vector rounded to
            bfloat16 as the wire would carry it.
        """
        if isinstance(task, int):
            task = self.get_task(task)
        if task.stacked_result is None:
            raise ValueError(
                f"task {task.id} has no stacked (device-mode) result"
            )
        if self._plane is not None and self._plane.in_run:
            # a run aggregates: every rank joins the collective reduction
            return self._plane.answer(self._plane.post("aggregate", dict(
                task=task.id, weights=weights, agg_mode=agg_mode),
                root=self._plane.roots[task.id]))
        return self._aggregate(task, weights, agg_mode)

    def _aggregate(self, task: Task, weights: Any, agg_mode: str) -> Any:
        """``aggregate_stacked`` on this rank; over a group, the reduction
        of the local stations' rows over the station group (``mesh=``)."""
        from vantage6_tpu_torch.fed.collectives import (
            fed_mean,
            fed_mean_scattered_tree,
        )

        stacked, mesh = task.stacked_result, None
        if self.mesh.group is not None:
            mesh, rows = self.mesh, self.mesh.local_stations
            stacked = tree_map(lambda x: x[rows.start:rows.stop], stacked)
        # the aggregation leg of the round's trace (no-op outside a trace)
        with TRACER.span(
            "aggregate", kind="aggregate", service="federation",
            attrs={"task_id": task.id, "agg_mode": agg_mode},
            require_parent=True,
        ):
            if agg_mode == "replicated":
                out = fed_mean(
                    stacked, weights=weights,
                    mask=task.participation, mesh=mesh,
                )
            elif agg_mode not in ("scattered", "scattered_bf16"):
                raise ValueError(
                    f"unknown agg_mode {agg_mode!r} (replicated | scattered"
                    " | scattered_bf16)"
                )
            else:
                out = fed_mean_scattered_tree(
                    self.mesh,
                    stacked,
                    weights=weights,
                    mask=task.participation,
                    comm_dtype=(
                        torch.bfloat16 if agg_mode == "scattered_bf16"
                        else None
                    ),
                )
        # OUTSIDE the aggregate span: the stats pass waits on a
        # device->host pull of the stacked result, which must not inflate
        # the aggregation-latency telemetry it sits next to
        self._record_learning(task, weights)
        return out

    def _record_learning(self, task: Task, weights: Any) -> None:
        """Learning-plane record of one device-mode aggregation: the
        per-station update stats of the stacked result (every leaf,
        flat-packed in ``_tree`` order, as the JAX package packs it), keyed
        by the PARENT task when there is one, so a central loop's per-round
        subtasks accumulate into one trajectory. Gated by
        ``FederationConfig.learning_stats`` (the ``[S, N]`` pull to the
        host is the cost). The pull is the aggregation's own (a device
        error propagates); a recording error is logged at debug level and
        never fails the aggregation."""
        if not getattr(self.config, "learning_stats", True):
            return
        from vantage6_tpu_torch.fed.collectives import flatten_stacked
        from vantage6_tpu_torch.runtime.learning import (
            LEARNING,
            update_stats_host,
        )

        def host(x: Any) -> Any:
            if isinstance(x, torch.Tensor):
                return x.detach().cpu().numpy()
            return None if x is None else np.asarray(x)

        key = task.parent_id if task.parent_id is not None else task.id
        flat = flatten_stacked(task.stacked_result).detach().float().cpu()
        w, m = host(weights), host(task.participation)
        try:
            stats = update_stats_host(flat.numpy(), weights=w, mask=m)
            LEARNING.history(key).record_stats(stats)
        except Exception:
            import logging

            logging.getLogger("vantage6_tpu_torch/federation").debug(
                "learning-plane recording failed for task %s", task.id,
                exc_info=True,
            )

    def learning_history(self, task_id: int):
        """The learning-plane RoundHistory recorded for ``task_id`` (its
        own id or, for per-round subtasks, the parent's), or None."""
        from vantage6_tpu_torch.runtime.learning import LEARNING

        return LEARNING.get(task_id)

    # ------------------------------------------------- gradient compression
    def compress_update(
        self, station: int, tree: Any, name: str = "update"
    ) -> Any:
        """Station-side half of the host-plane delta exchange: compress
        ``tree`` (a model delta; tensors stay on their device) under the
        federation's compressor, with THIS station's error-feedback
        accumulator re-injected first and updated after (keyed ``(station,
        name)``). Returns a wire-serializable payload whose sparse half is
        a v2 ``SparseVector``; recorded as a ``device.compress`` span and
        counted in the ``v6t_compress_*`` series. A pass-through without
        an (effective) compressor, so algorithm code can leave the call in
        place unconditionally."""
        dc = self._delta_compressor
        if dc is None:
            return tree
        return dc.compress(tree, name=f"{station}:{name}", station=station)

    def decompress_update(self, payload: Any) -> Any:
        """Server-side half: the dense update tree, on the federation's
        device, from a ``compress_update`` wire payload
        (``device.decompress`` span). A pass-through for anything that is
        not a compressed payload, so mixed result lists fold uniformly.
        The spec rides the wire: no config needed here."""
        from vantage6_tpu_torch.fed.compression import decompress_wire_tree

        return decompress_wire_tree(payload, device=self.mesh.device)

    # ------------------------------------------------------ elastic recovery
    def _drain_pending(self, station: int, wait: bool = True) -> None:
        """Reference parity: a reconnecting node syncs its missed task queue
        (`sync_task_queue_with_server`) and executes what it owes. Host runs
        drain through the executor pool (per-station FIFO keeps them ordered
        after anything already queued); the call blocks until the owed runs
        finished, so `set_station_online` keeps its synchronous contract.
        ``wait=False`` submits without blocking — the admission-control
        revert path, which runs on the watchdog's listener thread and must
        not stall evaluation behind the very backlog it is draining."""
        owed: list[Run] = []
        with self._inflight_lock:
            already = set(self._inflight_runs)
        # snapshot: pool workers insert nested tasks concurrently, and a
        # live dict iteration would die with "changed size during iteration"
        for task in list(self.tasks.values()):
            fn = self.resolve_function(task.image, task.method)
            if fn is None:
                continue
            for run in task.runs:
                if (
                    run.station_index == station
                    and run.status == TaskStatus.PENDING
                    and run.id not in already
                ):
                    if getattr(fn, "__v6t_device_step__", False):
                        self._run_device_step(task, fn, [run])
                    else:
                        self._run_host_runs(task, fn, [run])
                        if self._executor is not None:
                            owed.append(run)
        if owed and wait:
            self._await_inflight(owed)

    # --------------------------------------------------------- observability
    def task_timing(self, task_id: int) -> dict[str, Any]:
        """Per-run queued→started→finished lifecycle plus the max-vs-sum
        round-time decomposition (straggler view): a parallel round costs
        max-over-stations, a sequential one sum-over-stations. ``wire``
        adds the per-round payload accounting (bytes out/in over this
        task's runs + the process-wide encode/decode/broadcast counters),
        so transfer-bound stations are distinguishable from compute-bound
        ones."""
        from vantage6_tpu_torch.runtime.metrics import (
            round_decomposition,
            run_lifecycle,
            wire_totals,
        )

        task = self.tasks[task_id]
        return {
            "task_id": task_id,
            "runs": [run_lifecycle(r) for r in task.runs],
            **round_decomposition(task.runs),
            "wire": wire_totals(task.runs),
        }

    def watchdog_feed(self) -> dict[str, Any]:
        """This federation's state for the watchdog rules
        (runtime.watchdog): ACTIVE in-flight runs (stuck_run), executor
        queue depth (queue_buildup — the telemetry gauges cover the
        totals; this adds per-station queue detail to the feed for
        operators reading /api/alerts context), and the straggler view of
        recently finished multi-run tasks (straggler_station)."""
        now = time.time()
        with self._inflight_lock:
            inflight = set(self._inflight_runs)
        runs = []
        rounds = []
        tasks = list(self.tasks.values())
        # resolve the (small) inflight set by scanning NEWEST tasks first
        # and stopping once every id is found — the feed runs every
        # watchdog tick, and a long-lived simulator holds its whole task
        # history in this dict; O(all runs ever) per tick would make the
        # watchdog itself the slow component
        pending = set(inflight)
        for task in reversed(tasks):
            if not pending:
                break
            for run in task.runs:
                if run.id not in pending:
                    continue
                pending.discard(run.id)
                if run.status == TaskStatus.ACTIVE:
                    runs.append({
                        "run_id": run.id,
                        "task_id": task.id,
                        "status": "active",
                        "assigned_at": run.assigned_at,
                        "started_at": run.started_at,
                        "organization_id": run.station_index,
                    })
        # WEDGED runs: ACTIVE but no longer queued/executing on the pool —
        # a worker returned without the run reaching a terminal state (a
        # dropped result, fault-injected or real). Exactly the stuck_run
        # rule's food, and invisible to the inflight scan above.
        seen_ids = {r["run_id"] for r in runs}
        for task in tasks[-self.config.n_stations * 8:]:
            for run in task.runs:
                if (
                    run.status == TaskStatus.ACTIVE
                    and run.id not in inflight
                    and run.id not in seen_ids
                ):
                    runs.append({
                        "run_id": run.id,
                        "task_id": task.id,
                        "status": "active",
                        "assigned_at": run.assigned_at,
                        "started_at": run.started_at,
                        "organization_id": run.station_index,
                    })
        for task in tasks[-self.config.n_stations * 8:]:
            if len(task.runs) < 2 or not task.is_finished:
                continue
            execs = [
                (r.station_index, r.finished_at - r.started_at)
                for r in task.runs
                if r.started_at is not None and r.finished_at is not None
            ]
            if len(execs) < 2:
                continue
            durs = [d for _, d in execs]
            straggler, max_s = max(execs, key=lambda e: e[1])
            rounds.append({
                "task_id": task.id,
                "straggler_station": straggler,
                "max_exec_s": max_s,
                "mean_exec_s": sum(durs) / len(durs),
                "n": len(execs),
            })
        executor = self._executor
        state: dict[str, Any] = {"runs": runs, "rounds": rounds, "now": now}
        if executor is not None:
            state["executor"] = executor.stats()
        # autopilot/async context for operators reading /api/alerts: which
        # stations are currently masked or down-weighted, and the
        # admission flag (scalar keys are ignored by feed_items — rules
        # only consume the list-valued entries above)
        state["stations_masked"] = [
            i for i, m in enumerate(self._masked) if m
        ]
        state["selection_weights"] = list(self._selection_weights)
        state["staleness"] = list(self._staleness)
        state["admission_limited"] = self._admission_limited
        return state

    # -------------------------------------------------------------- teardown
    def close(self) -> None:
        """Tear down the executor pool (queued-but-unstarted runs are
        dropped). Idempotent; the Federation stays readable."""
        from vantage6_tpu_torch.runtime.watchdog import WATCHDOG

        if self.autopilot is not None:
            self.autopilot.detach()
            self.autopilot = None
        WATCHDOG.unregister_feed(self._watchdog_key, self._watchdog_feed_fn)
        if self._executor is not None:
            self._executor.close()
            self._executor = None


def federation_from_datasets(
    datasets: list[Any],
    algorithms: dict[str, Any],
    label: str = "default",
    device: str | torch.device | None = None,
    name: str = "mock",
    executor_workers: int | None = None,
    group: Any = None,
    devices_per_station: int = 1,
) -> Federation:
    """Build a ready Federation from in-memory per-station datasets —
    the MockAlgorithmClient construction path. ``device`` is the card
    (CUDA unless ``"cpu"`` is asked for); ``executor_workers`` configures
    the host-path station executor pool (None = auto, 0 = synchronous;
    see FederationConfig); ``group`` and ``devices_per_station`` lay the
    stations out over a process group's ranks (every rank passes every
    station's dataset)."""
    from vantage6_tpu_torch.core.config import StationConfig

    cfg = FederationConfig(
        name=name,
        executor_workers=executor_workers,
        devices_per_station=devices_per_station,
        stations=[
            StationConfig(
                name=f"station_{i}",
                organization=f"org_{i}",
                databases=[DatabaseConfig(label=label, type="array")],
            )
            for i in range(len(datasets))
        ],
    )
    fed = Federation(cfg, device=device, algorithms=algorithms, group=group)
    fed.set_datasets(label, datasets)
    return fed
