"""The node daemon — one data station's agent.

Parity: vantage6-node `Node` (SURVEY.md §2 item 10, call stack §3.3):
authenticate with the api_key → set up encryption + proxy + runner →
go online → sync missed work → listen for tasks → execute → report.
The reference listens on a SocketIO socket; here the daemon drains the
server's room-scoped event cursor (push via websockets arrives with the
same payloads — the cursor IS the reconnect path in both designs).
"""
from __future__ import annotations

import queue
import random
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable

from vantage6_tpu_torch.common.encryption import CryptorBase, DummyCryptor, RSACryptor
from vantage6_tpu_torch.common.rest import RestError, RestSession
from vantage6_tpu_torch.common.enums import TaskStatus
from vantage6_tpu_torch.common.log import setup_logging
from vantage6_tpu_torch.common.serialization import deserialize
from vantage6_tpu_torch.node.gates import VPNManager
from vantage6_tpu_torch.node.proxy import NodeProxy
from vantage6_tpu_torch.node.runner import (
    PolicyViolation,
    RunSpec,
    TaskRunner,
    UnknownAlgorithm,
)
from vantage6_tpu_torch.runtime.tracing import TRACER, parse_traceparent

log = setup_logging("vantage6_tpu_torch/node")


def backoff_delay(
    base: float,
    failures: int,
    cap: float = 10.0,
    rng: Callable[[], float] = random.random,
) -> float:
    """Capped exponential backoff with jitter for the event-poll retry.

    Failure n sleeps uniform(0.5, 1.0) × min(cap, base · 2^(n-1)). The
    jitter is the point: 32 daemons that all lost the same restarting
    server must retry DECORRELATED, not hammer it again in lockstep at a
    fixed multiple of their shared poll_interval.
    """
    delay = min(cap, base * (2 ** max(0, failures - 1)))
    return delay * (0.5 + 0.5 * rng())


class _PendingReport:
    """One queued run PATCH awaiting its batch flush."""

    __slots__ = ("run_id", "fields", "done", "error")

    def __init__(self, run_id: int, fields: dict[str, Any]):
        self.run_id = run_id
        self.fields = fields
        self.done = threading.Event()
        self.error: Exception | None = None


class _BatchReporter:
    """Coalesces concurrent run status/result PATCHes into one
    ``PATCH /api/run/batch`` request.

    Worker threads call `submit_and_wait` — synchronous per caller (the
    ACTIVE-before-barrier and report-before-return orderings are
    preserved), but the TRANSPORT batches whatever is queued at flush
    time: when several of the daemon's workers finish near-simultaneously
    their reports ride one request. A lone report degrades to a batch of
    one. Per-item server outcomes (409 terminal, 403, ...) are re-raised
    in the submitting thread as RestError, so every existing caller-side
    handler (the 409 "already terminal" path) works unchanged. If the
    server lacks the batch endpoint (404/405: un-upgraded server), the
    items are replayed as per-run PATCHes and the daemon pins itself to
    the per-run path.
    """

    def __init__(self, daemon: "NodeDaemon"):
        self._daemon = daemon
        self._q: "queue.Queue[_PendingReport]" = queue.Queue()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()

    def submit_and_wait(self, run_id: int, fields: dict[str, Any]) -> None:
        item = _PendingReport(run_id, fields)
        self._ensure_thread()
        self._q.put(item)
        if not item.done.wait(timeout=120.0):
            raise RestError(504, f"batched report for run {run_id} timed out")
        if item.error is not None:
            raise item.error

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="v6t-report"
                )
                self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            self._flush(self._drain(first))
        # stop requested: flush whatever is still queued so a final
        # COMPLETED report is never abandoned mid-shutdown
        try:
            while True:
                self._flush(self._drain(self._q.get_nowait()))
        except queue.Empty:
            pass

    def _drain(self, first: _PendingReport) -> list[_PendingReport]:
        batch = [first]
        while len(batch) < 250:
            try:
                batch.append(self._q.get_nowait())
            except queue.Empty:
                break
        return batch

    def _flush(self, batch: list[_PendingReport]) -> None:
        d = self._daemon
        if d._batch_ok is False:
            for item in batch:
                self._flush_single(item)
            return
        try:
            resp = d.request(
                "PATCH",
                "run/batch",
                {"runs": [{"id": it.run_id, **it.fields} for it in batch]},
            )
        except RestError as e:
            if e.status in (404, 405):
                d._batch_ok = False  # un-upgraded server: per-run forever
                for item in batch:
                    self._flush_single(item)
                return
            self._finish_all(batch, e)
            return
        except Exception as e:
            self._finish_all(batch, e)
            return
        by_id = {r.get("id"): r for r in resp.get("data", [])}
        for item in batch:
            r = by_id.get(item.run_id)
            if r is None:
                item.error = RestError(
                    500, f"batch response missing run {item.run_id}"
                )
            elif r.get("status_code", 200) >= 400:
                item.error = RestError(r["status_code"], r.get("msg", ""))
            item.done.set()

    def _flush_single(self, item: _PendingReport) -> None:
        try:
            self._daemon.request("PATCH", f"run/{item.run_id}", item.fields)
        except Exception as e:
            item.error = e
        item.done.set()

    @staticmethod
    def _finish_all(batch: list[_PendingReport], err: Exception) -> None:
        for item in batch:
            item.error = err
            item.done.set()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)


def _join_device_engine(cfg: dict[str, Any]) -> Any:
    """Join the device engine's process group (a no-op without a
    coordinator) and return the ``torch.device`` its runs execute on: the
    rank's device when a group was joined, else ``cfg["device"]`` (the
    current card when unset). Raises without CUDA unless ``"cpu"``."""
    import torch

    from vantage6_tpu_torch.core import distributed as _dist
    from vantage6_tpu_torch.core.mesh import resolve_device

    device = cfg.get("device")
    _dist.initialize(
        coordinator_address=cfg.get("coordinator"),
        num_processes=cfg.get("num_processes"),
        process_id=cfg.get("process_id"),
        local_device_ids=cfg.get("local_device_ids"),
        auto=bool(cfg.get("auto", False)),
        device=device,
    )
    joined = _dist.rank_device()
    if joined is not None:
        return joined
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_engine: no CUDA device is available; set "
                "device_engine['device'] = 'cpu' to run on the CPU "
                "explicitly"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class NodeDaemon:
    def __init__(
        self,
        api_url: str,
        api_key: str,
        algorithms: dict[str, str] | None = None,
        databases: list[dict[str, Any]] | None = None,
        policies: dict[str, Any] | None = None,
        private_key: str | Path | None = None,
        mode: str = "sandbox",
        poll_interval: float = 0.25,
        sync_interval: float = 15.0,
        ping_interval: float | None = None,
        fleet_push_interval: float | None = None,
        name: str = "",
        max_concurrent_runs: int = 4,
        station_secret: str | bytes | None = None,
        vpn: dict[str, Any] | None = None,
        device_engine: dict[str, Any] | None = None,
        transport: str = "batched",
        event_wait: float = 2.0,
    ):
        # control-plane transport policy:
        # - transport="batched" (default): claim sweeps, per-run dispatch
        #   fetches and status reports ride the multi-run endpoints
        #   (POST /run/claim-batch, PATCH /run/batch), falling back to the
        #   per-run endpoints automatically against an un-upgraded server;
        #   "per-run" pins the legacy per-run path (mixed-version testing).
        # - event_wait>0: event polls long-poll (?wait=S) so a dispatched
        #   run wakes this daemon on event PROPAGATION, with the
        #   poll_interval sweep demoted to the anti-entropy fallback;
        #   0 pins the legacy fixed-interval polling.
        if transport not in ("batched", "per-run"):
            raise ValueError(
                f"transport must be 'batched' or 'per-run', got {transport!r}"
            )
        # Device-engine membership FIRST. With a coordinator configured
        # this daemon becomes one rank of the federation's process group
        # (core.distributed); an empty dict enables the engine on this
        # process's own device only. This is how the control plane meets
        # the device data plane: a server-submitted engine="device" task
        # executes as ONE collective program spanning every member daemon.
        # ``device`` names the device the runs use: the card by default,
        # the CPU (gloo between ranks) only when "cpu" is asked for; without
        # CUDA and without "cpu" the daemon refuses to start.
        self.device_engine_cfg = device_engine
        self.engine_device = None
        if device_engine is not None:
            self.engine_device = _join_device_engine(device_engine)
        # replica-aware transport: `api_url` may be a comma-separated list
        # of server replica URLs (N stateless replicas over one shared
        # store — docs/control_plane.md). The daemon talks to ONE at a
        # time (api_urls[0] initially) and rotates to the next on a
        # connection-level failure; any replica serves any request, so a
        # rotation is invisible above the transport.
        self.api_urls = [
            u.strip().rstrip("/") for u in api_url.split(",") if u.strip()
        ]
        if not self.api_urls:
            raise ValueError("api_url must name at least one server URL")
        self._url_index = 0
        self.api_url = self.api_urls[0]
        self.api_key = api_key
        self.poll_interval = poll_interval
        self.sync_interval = sync_interval
        # ping-window bookkeeping (the server watchdog's daemon_lapsed
        # rule watches node.last_seen_at): the sync worker POSTs a ping at
        # least every ping_interval so a live daemon never lapses, and the
        # counters below tell a dump whether THIS side was failing to ping
        # or the server was failing to hear
        self.ping_interval = (
            min(sync_interval, 10.0) if ping_interval is None
            else max(0.1, float(ping_interval))
        )
        self.last_ping_at: float | None = None
        self.ping_failures = 0
        # double-dispatch ledger (see _execute_run's activation CAS)
        self.activations_won = 0
        self.activations_lost = 0
        self.transport = transport
        self.event_wait = max(0.0, float(event_wait))
        # None = capability unknown; False = server lacks the batch
        # endpoints / long-poll (detected once, then pinned)
        self._batch_ok: bool | None = (
            None if transport == "batched" else False
        )
        self._long_poll: bool | None = None
        self._poll_failures = 0
        # consecutive full replica-URL rotations that found NO reachable
        # server (reset on any success): drives the capped jittered
        # backoff between sweeps, so N daemons that lost the whole
        # control plane re-probe decorrelated instead of in lockstep
        self._rotation_streak = 0
        self._reporter = _BatchReporter(self)
        # run_id -> claim-batch entry (run dict + embedded task +
        # container token): what a batched claim prefetched so _execute
        # skips its per-run GET run / GET task / POST token round-trips
        self._prefetched: dict[int, dict[str, Any]] = {}  # guarded-by: _claim_lock
        self._access_token: str | None = None
        self._refresh_token: str | None = None
        self._rest = RestSession(
            self.api_url,
            token_getter=lambda: self._access_token,
            refresh=self._refresh,
        )
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._cursor = 0
        self._killed: set[int] = set()
        # Runs execute in workers, NOT the listen thread: a central run
        # blocks on its own subtasks, which may land on THIS node — the
        # reference gets the same concurrency from parallel containers.
        self._pool = ThreadPoolExecutor(
            max_workers=max_concurrent_runs, thread_name_prefix="v6t-run"
        )
        self._claimed: set[int] = set()  # guarded-by: _claim_lock
        self._claim_lock = threading.Lock()
        # one sweep at a time: the sync worker and a post-restart resync
        # must not interleave their claim-check -> PATCH windows
        self._sync_lock = threading.Lock()
        # device-engine runs execute on a DEDICATED single worker in
        # ascending task-id order: collective SPMD programs must enter in
        # the same globally agreed order on every member daemon, or two
        # concurrent device tasks grabbed in opposite orders deadlock the
        # mesh (each member waiting inside a different program)
        self._device_queue: "queue.PriorityQueue[tuple[int, int]]" = (
            queue.PriorityQueue()
        )
        self._device_thread: threading.Thread | None = None
        self._sync_thread: threading.Thread | None = None

        # authenticate (reference: Node.__init__ authenticates first)
        data = self._post_raw(
            "token/node", {"api_key": api_key}, auth=False
        )
        self._access_token = data["access_token"]
        self._refresh_token = data["refresh_token"]
        self.info = data["node"]
        self.id: int = self.info["id"]
        self.organization_id: int = self.info["organization"]["id"]
        self.collaboration_id: int = self.info["collaboration"]["id"]
        self.name = name or self.info["name"]

        # fleet telemetry push (common/fleet.py): this daemon ships its
        # compact snapshot + flight-note deltas through the same
        # replica-rotating request path as everything else, on the sync
        # worker's cadence. Capability-pinned inside the pusher: against
        # a pre-fleet server the first 404 turns pushing into a no-op.
        from vantage6_tpu_torch.common.fleet import FleetPusher

        self.fleet = FleetPusher(
            source=f"daemon:{self.name}",
            service="daemon",
            request=self.request,
            interval=fleet_push_interval,
        )

        collab = self.request("GET", f"collaboration/{self.collaboration_id}")
        self.encrypted: bool = bool(collab.get("encrypted"))

        # encryption: the node holds its organization's private key
        if self.encrypted:
            if private_key is None:
                raise ValueError(
                    "collaboration is encrypted: the node needs a "
                    "private_key path"
                )
            self.cryptor: CryptorBase = RSACryptor(private_key)
            self._register_public_key()
        else:
            self.cryptor = DummyCryptor()

        self.runner = TaskRunner(
            algorithms=algorithms,
            databases=databases,
            policies=policies,
            mode=mode,
            station_secret=station_secret,
            device_engine=device_engine is not None,
            engine_device=self.engine_device,
        )
        # VPN parity (reference item 13): no WireGuard exists here — the
        # manager's surviving job is registering algorithm-declared ports as
        # server Port entities so iterative/MPC algorithms can discover peers
        self.vpn = VPNManager(**(vpn or {}))
        if self.vpn.enabled:
            self.vpn.setup()  # logs the platform stance, returns False
        self.proxy = NodeProxy(
            server_url=self.api_url,
            cryptor=self.cryptor,
            collaboration_id=self.collaboration_id,
            encrypted=self.encrypted,
        )
        self._proxy_server = None

    @classmethod
    def from_context(cls, ctx: Any, **overrides: Any) -> "NodeDaemon":
        """Build from a NodeContext (YAML instance config)."""
        cfg = ctx.config
        return cls(
            api_url=cfg["api_url"],
            api_key=cfg["api_key"],
            algorithms=cfg.get("algorithms", {}) or {},
            databases=cfg.get("databases", []) or [],
            policies=cfg.get("policies", {}) or {},
            private_key=(
                str(ctx.private_key_path)
                if (cfg.get("encryption", {}) or {}).get("enabled")
                else None
            ),
            mode=(cfg.get("runner", {}) or {}).get("mode", "sandbox"),
            name=ctx.name,
            station_secret=cfg.get("station_secret") or None,
            vpn=cfg.get("vpn") or None,
            device_engine=cfg.get("device_engine"),
            transport=cfg.get("transport", "batched"),
            event_wait=cfg.get("event_wait", 2.0),
            ping_interval=cfg.get("ping_interval"),
            fleet_push_interval=cfg.get("fleet_push_interval"),
            **overrides,
        )

    # ------------------------------------------------------------------ http
    def _post_raw(self, endpoint: str, body: Any, auth: bool = True) -> Any:
        session = self._rest if auth else RestSession(self.api_url)
        return session.request("POST", endpoint, body)

    def request(
        self,
        method: str,
        endpoint: str,
        json_body: Any = None,
        params: dict[str, Any] | None = None,
        timeout: float | None = None,
    ) -> Any:
        """One control-plane request, replica-aware: a CONNECTION-level
        failure (socket refused/reset/timed out — the server process is
        gone) rotates to the next replica URL and retries, once per
        configured replica. HTTP-level errors (RestError) pass through
        untouched: the server answered, the replica is fine.

        A FULL failed rotation (every replica refused) means the whole
        control plane is gone, not one process — the daemon backs off
        with capped jitter (same `backoff_delay` as the event poll,
        streak persisted across calls) and makes one more sweep before
        raising, so a fleet that lost all replicas at once re-probes
        decorrelated."""
        if len(self.api_urls) == 1:
            # single-URL daemons keep the historical fail-fast contract;
            # the event poll's own backoff paces the retries
            return self._rest.request(
                method, endpoint, json_body, params, timeout=timeout
            )
        last_exc: Exception | None = None
        for sweep in range(2):
            for _ in range(len(self.api_urls)):
                try:
                    result = self._rest.request(
                        method, endpoint, json_body, params, timeout=timeout
                    )
                except RestError:
                    raise
                except OSError as e:
                    last_exc = e
                    self._rotate_replica(e)
                    continue
                if self._rotation_streak:
                    log.info(
                        "control plane reachable again after %d failed "
                        "rotation(s)", self._rotation_streak,
                    )
                    self._rotation_streak = 0
                return result
            assert last_exc is not None
            self._rotation_streak += 1
            delay = backoff_delay(
                max(self.poll_interval, 0.05), self._rotation_streak,
                cap=5.0,
            )
            from vantage6_tpu_torch.common.flight import FLIGHT
            from vantage6_tpu_torch.common.telemetry import REGISTRY

            REGISTRY.counter("v6t_daemon_rotation_total").inc()
            FLIGHT.note(
                "replica_rotation_failed", attempt=self._rotation_streak,
                replicas=len(self.api_urls), retry_in_s=round(delay, 3),
                error=str(last_exc),
            )
            # one warning per streak (the _poll_once convention): entry
            # at WARNING, the rest at DEBUG, recovery at INFO above
            if self._rotation_streak == 1:
                log.warning(
                    "all %d replica URLs unreachable; backing off %.2fs "
                    "before re-sweep (further rotations logged at DEBUG): "
                    "%s", len(self.api_urls), delay, last_exc,
                )
            else:
                log.debug(
                    "full rotation %d failed (retry in %.2fs): %s",
                    self._rotation_streak, delay, last_exc,
                )
            if sweep == 0:
                self._stop.wait(delay)
        assert last_exc is not None
        raise last_exc

    def _rotate_replica(self, cause: Exception) -> None:
        """Point the transport at the next replica (all replicas are
        stateless over one store, so any of them serves any request).
        The in-flight proxy keeps its original URL until restart."""
        self._url_index = (self._url_index + 1) % len(self.api_urls)
        self.api_url = self.api_urls[self._url_index]
        self._rest.base_url = self.api_url
        log.warning(
            "server connection failed (%s); rotating to replica %s",
            cause, self.api_url,
        )

    # --------------------------------------------------- batched transport
    def _claim_batch(
        self,
        run_ids: list[int] | None = None,
        reset_orphans: bool = False,
        max_runs: int = 250,
    ) -> list[dict[str, Any]] | None:
        """One ``POST /api/run/claim-batch``; None when the server lacks
        the endpoint (the daemon pins itself to the per-run path)."""
        if self._batch_ok is False:
            return None
        body: dict[str, Any] = {"max": max_runs}
        if run_ids is not None:
            # explicit dispatch: the caller already claimed these ids
            body["run_ids"] = run_ids
        else:
            with self._claim_lock:
                body["exclude_run_ids"] = sorted(self._claimed)
        if reset_orphans:
            body["reset_orphans"] = True
        t_wall, t_perf = time.time(), time.perf_counter()
        try:
            resp = self.request("POST", "run/claim-batch", body)
        except RestError as e:
            if e.status in (404, 405):
                log.info("server lacks claim-batch; using per-run dispatch")
                self._batch_ok = False
                return None
            raise
        self._batch_ok = True
        entries = resp.get("data", [])
        # claim attribution for SWEEP-prefetched runs: the batch round-trip
        # IS their claim window — stash it so _execute can record a
        # daemon.claim span even though it never fetches (sweep-claimed
        # runs — offline daemon, lost event — are precisely the
        # slow-dispatch cases the trace exists to explain)
        claim_s = time.perf_counter() - t_perf
        for entry in entries:
            entry["_claim_wall0"] = t_wall
            entry["_claim_s"] = claim_s
        return entries

    def _report(self, run_id: int, **fields: Any) -> None:
        """Report run status/result — batched (coalescing reporter) when
        the server supports it, per-run PATCH otherwise."""
        if self.transport == "batched" and self._batch_ok is not False:
            self._reporter.submit_and_wait(run_id, fields)
        else:
            self.request("PATCH", f"run/{run_id}", fields)

    def _iter_pages(self, endpoint: str, params: dict[str, Any] | None = None):
        """Yield every item of a paginated listing (full page drain, 250 a
        page) — the ONE pagination loop the read-only listing sweeps share.
        The orphan pass in `_sync_missed_runs_locked` keeps its own loop: it
        MUTATES the filtered set mid-drain and needs page-reset control."""
        page = 1
        while True:
            body = self.request(
                "GET", endpoint,
                params={**(params or {}), "per_page": 250, "page": page},
            )
            data = body.get("data", [])
            yield from data
            total = body.get("pagination", {}).get("total", 0)
            if page * 250 >= total or not data:
                return
            page += 1

    def _refresh(self) -> bool:
        if self._refresh_token:
            try:
                data = RestSession(self.api_url).request(
                    "POST", "token/refresh",
                    {"refresh_token": self._refresh_token},
                )
                self._access_token = data["access_token"]
                self._refresh_token = data.get(
                    "refresh_token", self._refresh_token
                )
                return True
            except RestError:
                pass
        # refresh rejected: the server may have RESTARTED with a fresh JWT
        # secret (no configured jwt_secret). The api_key is the node's
        # durable credential — re-authenticate from scratch so a server
        # bounce never bricks a running daemon.
        try:
            data = self._post_raw(
                "token/node", {"api_key": self.api_key}, auth=False
            )
            # inside the try: a token response missing a key must fail-soft
            # to False (the documented contract), not raise KeyError out of
            # the request path; a response without refresh_token keeps the
            # old one rather than clearing it
            self._access_token = data["access_token"]
            self._refresh_token = data.get(
                "refresh_token", self._refresh_token
            )
        except Exception as e:
            log.warning("node re-authentication failed: %s", e)
            return False
        log.info("re-authenticated with api_key (refresh token rejected — "
                 "server restart?)")
        return True

    def _register_public_key(self) -> None:
        org = self.request("GET", f"organization/{self.organization_id}")
        pub = self.cryptor.public_key_str  # type: ignore[union-attr]
        if org.get("public_key") != pub:
            self.request(
                "PATCH",
                f"organization/{self.organization_id}",
                {"public_key": pub},
            )

    # ------------------------------------------------------------- lifecycle
    def start(self, background: bool = True) -> "NodeDaemon":
        # crash forensics: label this process's flight recorder and arm
        # dump-on-fatal + kill -USR2 (docs/observability.md). Idempotent —
        # a test process hosting several daemons installs the hooks once.
        from vantage6_tpu_torch.common.flight import install as flight_install

        flight_install(service=f"daemon:{self.name}")
        self._proxy_server = self.proxy.serve()
        self.request("PATCH", f"node/{self.id}", {"status": "online"})
        self._cursor = self.request("GET", "event", params={"since": 0})[
            "cursor"
        ]
        self._sync_missed_runs()
        self._reconcile_sessions()
        self._sync_thread = threading.Thread(
            target=self._sync_worker, daemon=True, name="v6t-sync"
        )
        self._sync_thread.start()
        if self.runner.device_engine:
            self._device_thread = threading.Thread(
                target=self._device_worker, daemon=True,
                name="v6t-device-engine",
            )
            self._device_thread.start()
        if background:
            self._thread = threading.Thread(target=self._listen, daemon=True)
            self._thread.start()
            return self
        self._listen()
        return self

    def crash(self) -> None:
        """Simulate a hard process death (V6T_FAULTS `crash`): every
        worker stops but the node is NEVER patched offline — the server
        only learns through its `daemon_lapsed` watchdog rule, exactly
        like a real SIGKILL mid-round. Used by the fault-injection
        harness; see docs/OPERATOR_GUIDE.md "autopilot"."""
        self._stop.set()
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._reporter.stop()
        if self._proxy_server:
            self._proxy_server.stop()
            self._proxy_server = None

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
        if self._device_thread:
            self._device_thread.join(timeout=10)
        if self._sync_thread:
            self._sync_thread.join(timeout=10)
        self._pool.shutdown(wait=True, cancel_futures=True)
        # after the pool: workers inside submit_and_wait need the reporter
        # alive until their final report flushed
        self._reporter.stop()
        try:
            self.request("PATCH", f"node/{self.id}", {"status": "offline"})
        except Exception:
            pass
        if self._proxy_server:
            self._proxy_server.stop()

    # ---------------------------------------------------------------- listen
    def _listen(self) -> None:
        """Prefer websocket push (SocketIO parity); the REST cursor remains
        the fallback AND the gap-filler after any socket drop."""
        from vantage6_tpu_torch.common.faults import FAULTS

        discover_at = 0.0
        ws_url: str | None = None
        while not self._stop.is_set():
            if FAULTS.daemon_crash():
                log.error(
                    "injected daemon crash (V6T_FAULTS): dying without "
                    "the offline handshake"
                )
                self.crash()
                return
            now = time.monotonic()
            if now >= discover_at:
                ws_url = self._discover_ws()
                # no bridge on the server is the steady state for polling
                # deployments — don't double request load re-asking every
                # cycle; after a drop the next re-discovery is soon enough
                discover_at = now + (10.0 if ws_url is None else 1.0)
            if ws_url:
                self._listen_ws(ws_url)  # returns on disconnect or stop
                if self._stop.is_set():
                    return
                discover_at = 0.0  # re-discover after a drop
            # event fetch: long-poll when the server supports it (the
            # request itself blocks until an event lands, so no sleep);
            # the fixed poll_interval survives only as the legacy-server
            # cadence and the post-failure pacing
            waited = self._poll_once()
            if not waited:
                self._stop.wait(self.poll_interval)

    def _discover_ws(self) -> str | None:
        try:
            return self.request("GET", "health").get("websocket_url")
        except Exception:
            return None

    def _poll_once(self) -> bool:
        """One event fetch. Returns True when no further sleep is needed
        (the server long-polled for us, or the failure path already slept
        its backoff)."""
        # name filter: _handle only acts on these three, and without the
        # filter every status-update in the collaboration room would wake
        # every long-polling daemon (N× request amplification per event)
        params: dict[str, Any] = {
            "since": self._cursor,
            "names": "task-created,kill-task,session-deleted",
        }
        use_wait = self.event_wait > 0 and self._long_poll is not False
        if use_wait:
            params["wait"] = self.event_wait
        try:
            batch = self.request(
                "GET", "event", params=params,
                # a long poll must not hang forever on a dead server: give
                # the server its window plus generous transit margin
                timeout=(self.event_wait + 30.0) if use_wait else None,
            )
        except Exception as e:
            # capped exponential backoff + jitter: N daemons that lost the
            # same restarting server must NOT retry in lockstep
            self._poll_failures += 1
            delay = backoff_delay(
                max(self.poll_interval, 0.05), self._poll_failures
            )
            # ONE warning per failure streak, not one per retry: a server
            # restart used to spam a warning every backoff step across
            # every daemon. The streak's shape stays fully recorded — a
            # telemetry counter per failure and a flight-recorder note per
            # attempt (the dump shows each retry) — while the console gets
            # one line on entry and one on recovery.
            from vantage6_tpu_torch.common.flight import FLIGHT
            from vantage6_tpu_torch.common.telemetry import REGISTRY

            REGISTRY.counter("v6t_daemon_backoff_total").inc()
            FLIGHT.note(
                "event_poll_error", attempt=self._poll_failures,
                retry_in_s=round(delay, 3), error=str(e),
            )
            if self._poll_failures == 1:
                log.warning(
                    "event poll failed, entering backoff (retry in "
                    "%.2fs; further retries logged at DEBUG): %s", delay, e,
                )
            else:
                log.debug(
                    "event poll failed (attempt %d, retry in %.2fs): %s",
                    self._poll_failures, delay, e,
                )
            self._stop.wait(delay)
            return True
        if self._poll_failures:
            log.info(
                "event poll recovered after %d failed attempt(s)",
                self._poll_failures,
            )
        self._poll_failures = 0
        self._long_poll = bool(batch.get("long_poll"))
        if batch.get("truncated"):
            # the replay buffer overflowed past our cursor: events were
            # LOST, not delayed. Same exposure as a cursor regression —
            # resync everything an event could have carried.
            log.info(
                "event buffer overflowed past cursor %s; resyncing "
                "runs/kills/sessions", self._cursor,
            )
            self._cursor = batch["cursor"]
            self._heal()
        if batch["cursor"] < self._cursor:
            # the hub's sequence counter runs BEHIND our watermark: the
            # server restarted (in-memory hub, fresh counter). Keeping the
            # old watermark would filter out every future event forever —
            # adopt the new sequence space and heal (see _heal).
            log.info(
                "event cursor regressed %s -> %s (server restart); "
                "resyncing runs/kills/sessions", self._cursor,
                batch["cursor"],
            )
            self._cursor = batch["cursor"]
            # a restarted server also lost its capability answer
            self._long_poll = None
            self._batch_ok = (
                None if self.transport == "batched" else False
            )
            self._heal()
        else:
            self._cursor = max(self._cursor, batch["cursor"])
        for event in batch["data"]:
            self._handle(event)
        return use_wait and bool(batch.get("long_poll"))

    def _heal(self) -> None:
        """Resync everything an event could have carried: queued runs,
        kills (a missed kill-task would let a killed run execute to
        completion), and deleted sessions (a missed session-deleted leaves
        extracted dataframes on disk) — runs have the periodic sweep as
        backstop, kills and sessions only have this."""
        for heal in (self._sync_missed_runs, self._sync_kills,
                     self._reconcile_sessions):
            try:
                heal()
            except Exception as e:
                log.warning("event-gap %s failed: %s", heal.__name__, e)

    def _listen_ws(self, ws_url: str) -> None:
        import json as _json

        try:
            # inside the try: a missing websockets package must degrade to
            # polling, not kill the listen thread
            from websockets.sync.client import connect

            with connect(ws_url) as ws:
                ws.send(
                    _json.dumps(
                        {"token": self._access_token, "since": self._cursor}
                    )
                )
                hello = _json.loads(ws.recv(timeout=10))
                if not hello.get("connected"):
                    log.warning("ws auth rejected: %s", hello)
                    return
                log.info("event push connected (%s)", ws_url)
                while not self._stop.is_set():
                    try:
                        msg = _json.loads(ws.recv(timeout=self.poll_interval))
                    except TimeoutError:
                        continue
                    event = msg.get("event")
                    if event:
                        self._cursor = max(self._cursor, event["seq"])
                        self._handle(event)
        except Exception as e:
            log.warning("event push dropped (%s); falling back to polling", e)

    def _handle(self, event: dict[str, Any]) -> None:
        name, data = event["name"], event["data"]
        if name == "task-created" and data.get("run_id"):
            if data.get("organization_id") == self.organization_id:
                self._submit(data["run_id"])
        elif name == "kill-task":
            self._killed.add(data.get("run_id"))
        elif name == "session-deleted" and data.get("session_id"):
            # drop the LOCAL dataframe store for the deleted workspace
            self.runner.drop_session(data["session_id"])

    def _submit(self, run_id: int, entry: dict[str, Any] | None = None) -> None:
        with self._claim_lock:
            if run_id in self._claimed:
                return
            self._claimed.add(run_id)
            if entry is not None:
                self._prefetched[run_id] = entry
        self._pool.submit(self._execute_logged, run_id)

    def _unclaim(self, run_id: int) -> None:
        """Give a run back to the sweep after a failure that never reached
        a terminal status patch — a claimed-but-dead run would otherwise be
        orphaned for this daemon's whole life."""
        with self._claim_lock:
            self._claimed.discard(run_id)
            self._prefetched.pop(run_id, None)

    def _execute_logged(self, run_id: int, dispatched: bool = False) -> None:
        try:
            self._execute(run_id, dispatched=dispatched)
        except Exception:
            log.error("run %s worker crashed:\n%s", run_id,
                      traceback.format_exc(limit=8))
            # whatever state the run is in, this thread is done with it; if
            # the crash left it non-terminal, the anti-entropy sweep (or a
            # restart) must be able to pick it up again
            self._unclaim(run_id)

    def _device_worker(self) -> None:
        """Drain device-engine runs one at a time, lowest task id first.

        The local PriorityQueue only orders runs already delivered to THIS
        daemon; the globally agreed order every mesh member must follow is
        the server-assigned task id. So before entering a popped run, ask
        the server whether an EARLIER device run for this node is still
        pending (its event may simply not have arrived yet) — if so, run
        that one first and keep the popped run queued.
        """
        if self.engine_device is not None \
                and self.engine_device.type == "cuda":
            import torch

            # this thread runs every device program: bind it to the card
            torch.cuda.set_device(self.engine_device)
        attempted: set[int] = set()
        # a task's engine is immutable: resolve each task id once, not on
        # every ordering scan (the scan runs per device-run dispatch)
        engine_cache: dict[int, str] = {}
        while not self._stop.is_set():
            try:
                task_id, run_id = self._device_queue.get(timeout=0.25)
            except queue.Empty:
                continue
            lower = self._lower_pending_device_run(
                task_id, attempted, engine_cache
            )
            if lower is not None:
                self._device_queue.put((task_id, run_id))
                l_task_id, l_run_id = lower
                with self._claim_lock:
                    self._claimed.add(l_run_id)
                attempted.add(l_run_id)
                self._execute_logged(l_run_id, dispatched=True)
                continue
            attempted.add(run_id)
            self._execute_logged(run_id, dispatched=True)

    def _lower_pending_device_run(
        self,
        task_id: int,
        attempted: set[int],
        engine_cache: dict[int, str],
    ) -> tuple[int, int] | None:
        """The server's word on ordering: the lowest-task-id PENDING device
        run assigned to this node that precedes ``task_id`` (excluding runs
        this worker already attempted — a run that failed before reaching a
        terminal status must not wedge the queue). Drains every page: the
        decisive run hiding on page 2 of a deep backlog would re-open the
        opposite-order deadlock this check exists to prevent."""
        from vantage6_tpu_torch.core import distributed as _dist

        if _dist.process_count() <= 1:
            # single-process mesh: no peer daemon to agree with, so local
            # queue order suffices — skip the server scan entirely
            return None
        candidates: list[tuple[int, int]] = []
        try:
            for run in self._iter_pages(
                "run", {"status": TaskStatus.PENDING.value}
            ):
                tid = (run.get("task") or {}).get("id")
                if tid is None or tid >= task_id or run["id"] in attempted:
                    continue
                candidates.append((tid, run["id"]))
        except Exception:
            return None  # can't consult the server: local order only
        for tid, rid in sorted(candidates):
            engine = engine_cache.get(tid)
            if engine is None:
                try:
                    engine = self.request(
                        "GET", f"task/{tid}"
                    ).get("engine") or "process"
                except Exception:
                    continue
                engine_cache[tid] = engine
            if engine == "device":
                return (tid, rid)
        return None

    def _await_device_peers(self, task: dict[str, Any], run_id: int) -> None:
        """Control-plane barrier before entering a collective SPMD program.

        Entering the program while ANY member daemon will never arrive
        (its run failed to decrypt, was killed, its node refused or is
        offline) blocks this thread inside the collectives until the comm
        backend's own timeout fires. This barrier waits until every peer
        run is ACTIVE (its daemon patched ACTIVE immediately before its own
        barrier) and aborts cleanly if a peer reaches a failed state or the
        wait times out. Single-process meshes skip it: their programs span
        no other daemon.
        """
        from vantage6_tpu_torch.core import distributed as _dist

        if _dist.process_count() <= 1:
            return
        timeout = float(
            (self.device_engine_cfg or {}).get("barrier_timeout", 120.0)
        )
        failed_states = {s.value for s in TaskStatus.failed_statuses()}
        waiting_states = {
            TaskStatus.PENDING.value,
            TaskStatus.INITIALIZING.value,
        }
        deadline = time.monotonic() + timeout
        while not self._stop.is_set():
            runs = self._all_task_runs(task["id"])
            peers = [r for r in runs if r["id"] != run_id]
            if not peers:
                # fail closed: on a multi-process mesh a device task always
                # has peer runs; seeing none means the server hid them
                # (scoped listing) — entering the collective alone would
                # block in the comm backend
                raise RuntimeError(
                    "no peer runs visible for a multi-process device task "
                    "— refusing to enter the collective program alone"
                )
            bad = [r for r in peers if r["status"] in failed_states]
            if bad:
                raise RuntimeError(
                    "aborting before collective entry: peer run(s) "
                    f"{[(r['id'], r['status']) for r in bad]} will never "
                    "join the SPMD program"
                )
            if run_id in self._killed:
                raise RuntimeError("run killed while awaiting peers")
            if all(r["status"] not in waiting_states for r in peers):
                return
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"device-engine barrier timed out after {timeout:.0f}s: "
                    f"peer runs still "
                    f"{[(r['id'], r['status']) for r in peers if r['status'] in waiting_states]}"
                    " — not entering the collective program without them"
                )
            # status transitions are human-scale; N daemons hammering the
            # server at sub-second cadence buys no freshness
            self._stop.wait(1.0)
        raise RuntimeError("daemon stopping; device run abandoned")

    def _all_task_runs(self, task_id: int) -> list[dict[str, Any]]:
        """EVERY run of a task (full page drain — a >250-org collaboration
        must not hide still-pending peers behind page 1)."""
        return list(self._iter_pages(f"task/{task_id}/run"))

    def _sync_missed_runs(self) -> None:
        """Reference: sync_task_queue_with_server — reclaim every run this
        node owes an execution. Runs at start AND periodically
        (``_sync_worker``); the claim set makes it idempotent and safe
        mid-life:

        - PENDING runs (queued while offline, or whose event was lost) are
          simply (re-)submitted — `_submit` dedupes via the claim set;
        - INITIALIZING/ACTIVE runs NOT in the claim set are orphans —
          left by a previous daemon life, or finished work whose terminal
          report was lost — and are reset to pending server-side, then
          re-executed. Anything this daemon is currently executing IS in
          the claim set and is never touched; that guard (not "the claim
          set is empty at start") is what makes mid-life reclaim sound.

        Serialized by ``_sync_lock``: the periodic sweep and a
        post-restart resync must not interleave claim-check -> PATCH.

        Against a batch-capable server the WHOLE sweep — orphan reset plus
        pending claim, with run/task/token prefetched — is one
        ``claim-batch`` request per 250 runs instead of the page-walking
        per-run reset loop below (which remains the mixed-version path).
        """
        with self._sync_lock:
            if self.transport == "batched" and self._batch_ok is not False:
                try:
                    if self._claim_batch_sweep():
                        return
                except Exception as e:
                    log.warning(
                        "batched claim sweep failed (%s); falling back to "
                        "the per-run sweep", e,
                    )
            self._sync_missed_runs_locked()

    def _claim_batch_sweep(self) -> bool:
        """Sweep via claim-batch; False when the server lacks the endpoint
        (the caller then runs the legacy per-run sweep)."""
        while True:
            entries = self._claim_batch(reset_orphans=True)
            if entries is None:
                return False
            for entry in entries:
                self._submit(entry["id"], entry)
            if len(entries) < 250:
                return True
            # a full page: newly claimed ids join the exclude list, so the
            # next request returns the NEXT slice of the backlog

    def _sync_kills(self) -> None:
        """Re-learn kills this node may have missed (post-restart heal):
        the kill-task EVENT is the only push channel, so after a cursor
        reset the killed set is rebuilt from the server's run statuses.
        Drains EVERY page like the other listings here — the listing is
        id-ascending, so with >250 historical kills the RECENT ones (the
        dangerous ones: their runs may still be executing locally) would
        hide behind page 1."""
        for run in self._iter_pages(
            "run", {"status": TaskStatus.KILLED.value}
        ):
            self._killed.add(run["id"])

    def _sync_missed_runs_locked(self) -> None:
        # Orphan statuses FIRST: were PENDING processed first, a run it
        # just submitted could go ACTIVE in a worker thread and then be
        # "reclaimed" (reset to pending mid-execution) by the pass that
        # follows. The claimed-set guard below closes the rest of that
        # window.
        for status in (TaskStatus.INITIALIZING, TaskStatus.ACTIVE,
                       TaskStatus.PENDING):
            mutating = status is not TaskStatus.PENDING
            page = 1
            while True:
                # the orphan pass MUTATES the filtered set (each PATCH
                # removes a run from this status), so after any progress it
                # re-fetches page 1 — incrementing the page would skip
                # everything the shrinkage slid onto page 1. A page of
                # only claimed (still-executing) runs advances the page
                # instead: reclaimable orphans behind it must not starve.
                body = self.request(
                    "GET",
                    "run",
                    params={
                        "status": status.value,
                        "per_page": 250,
                        "page": page,
                    },
                )
                progressed = skipped = 0
                for run in body["data"]:
                    if mutating:
                        with self._claim_lock:
                            if run["id"] in self._claimed:
                                skipped += 1  # executing in THIS daemon
                                continue
                        try:
                            self.request(
                                "PATCH",
                                f"run/{run['id']}",
                                {
                                    "status": TaskStatus.PENDING.value,
                                    "log": "orphaned mid-run (daemon "
                                           "restart or lost report); "
                                           "re-queued by sync",
                                },
                            )
                        except Exception as e:
                            # e.g. 409: finished/killed between list + patch
                            log.info(
                                "orphan run %s not re-queued: %s",
                                run["id"], e,
                            )
                            continue
                        progressed += 1
                    self._submit(run["id"])
                if not body["data"]:
                    break
                if mutating:
                    if progressed > 0:
                        page = 1       # set shrank: start over
                    elif skipped > 0:
                        page += 1      # page was all claimed: look deeper
                    else:
                        break          # only PATCH failures left: no spin
                    continue
                total = body.get("pagination", {}).get("total", 0)
                if page * 250 >= total:
                    break
                page += 1

    def _sync_worker(self) -> None:
        """Periodic run sweep (anti-entropy). Events remain the fast path;
        this closes the gaps events cannot guarantee against — a hub replay
        buffer overflow between polls, a dropped socket frame, a run whose
        first execution attempt failed before any status patch, or a run
        whose TERMINAL patch was lost (finished work stuck ACTIVE at the
        server). Orphan reclaim is safe mid-life because anything this
        daemon currently executes is in the claim set and skipped."""
        next_sweep = time.monotonic() + self.sync_interval
        next_ping = time.monotonic()  # first ping immediately
        next_push = time.monotonic() + self.fleet.interval
        while True:
            now = time.monotonic()
            # wake exactly at the next due event — pings, sweeps and
            # fleet pushes each keep their OWN cadence instead of
            # quantizing to a shared tick (a shared tick silently
            # stretched the 15 s sweep to 20)
            wait = max(0.0, min(next_ping, next_sweep, next_push) - now)
            if self._stop.wait(wait):
                return
            now = time.monotonic()
            if now >= next_push:
                next_push = now + self.fleet.interval
                # fail-soft by contract (counter + flight note inside);
                # a pre-fleet server pins this into a no-op
                self.fleet.maybe_push()
            if now >= next_ping:
                next_ping = now + self.ping_interval
                try:
                    self.ping()
                except Exception as e:
                    # a missed ping window flips the server's
                    # daemon_lapsed alert — record the miss on THIS side
                    # too so a dump shows which end was failing
                    self.ping_failures += 1
                    from vantage6_tpu_torch.common.flight import FLIGHT

                    FLIGHT.note(
                        "ping_failed", failures=self.ping_failures,
                        error=str(e),
                    )
                    if self.ping_failures == 1:
                        log.warning("server ping failed: %s", e)
            if now >= next_sweep:
                # fixed cadence (+= not now+): a slow sweep must not
                # push every later sweep back; if we fell more than one
                # period behind, re-anchor instead of bursting
                next_sweep += self.sync_interval
                if next_sweep <= now:
                    next_sweep = now + self.sync_interval
                try:
                    self._sync_missed_runs()
                except Exception as e:
                    log.warning("anti-entropy run sweep failed: %s", e)

    def _reconcile_sessions(self) -> None:
        """Drop local session stores whose server session no longer exists.

        The SESSION_DELETED event only reaches connected nodes; a node
        offline at deletion time would otherwise keep extracted (possibly
        sensitive) dataframes on disk forever. A 404 probe per locally
        stored session closes that gap at every (re)start.
        """
        from vantage6_tpu_torch.common.rest import RestError

        for d in self.runner.work_dir.glob("session_*"):
            try:
                sid = int(d.name.split("_", 1)[1])
            except ValueError:
                continue
            try:
                self.request("GET", f"session/{sid}")
            except RestError as e:
                if e.status == 404:
                    log.info(
                        "session %s deleted while offline; dropping store",
                        sid,
                    )
                    self.runner.drop_session(sid)
            except Exception as e:
                log.warning("session %s reconcile probe failed: %s", sid, e)

    # --------------------------------------------------------------- execute
    def _execute(self, run_id: int, dispatched: bool = False) -> None:
        with self._claim_lock:
            pre = self._prefetched.pop(run_id, None)
        prefetched_token: str | None = None
        # claim attribution: when THIS call pays the fetch round-trip(s)
        # (event dispatch / per-run path — a sweep-prefetched entry already
        # paid inside claim-batch), measure it and record a retroactive
        # daemon.claim span once the task's trace context is known
        claim_wall0, claim_perf0 = time.time(), time.perf_counter()
        fetched_here = pre is None
        if pre is None and self.transport == "batched" \
                and self._batch_ok is not False:
            # event-dispatch fast path: run + task + container token in ONE
            # request instead of GET run / GET task / POST token/container
            try:
                entries = self._claim_batch(run_ids=[run_id], max_runs=1)
            except Exception as e:
                log.error("cannot fetch run %s: %s", run_id, e)
                self._unclaim(run_id)  # still pending server-side: retryable
                return
            if entries is not None:
                if not entries:
                    # not pending anymore (or gone): same outcome as the
                    # per-run status check below
                    return
                pre = entries[0]
        if pre is not None:
            run = pre
            task = pre["task"]
            prefetched_token = pre.get("container_token")
        else:
            try:
                run = self.request("GET", f"run/{run_id}")
            except Exception as e:
                log.error("cannot fetch run %s: %s", run_id, e)
                self._unclaim(run_id)  # still pending server-side: retryable
                return
            if run["status"] != TaskStatus.PENDING.value:
                return
            task = self.request("GET", f"task/{run['task']['id']}")
        if run["status"] != TaskStatus.PENDING.value or run_id in self._killed:
            return
        if (
            task.get("engine") == "device"
            and self.runner.device_engine
            and not dispatched
        ):
            # re-route to the dedicated ordered device worker (see __init__);
            # an UNconfigured node falls through so the runner records the
            # PolicyViolation as NOT_ALLOWED. The prefetched claim goes back
            # so the device worker's later _execute reuses it.
            if pre is not None:
                with self._claim_lock:
                    self._prefetched[run_id] = pre
            self._device_queue.put((task["id"], run_id))
            return
        # one federated task = ONE trace: the server persisted the creating
        # request's context on the task; every span below attaches to it.
        # Untraced tasks (old server, tracing off) resolve to None and the
        # spans are no-ops — require_parent keeps polling noise out.
        tctx = parse_traceparent(task.get("traceparent"))
        service = f"daemon:{self.name}"
        trace_attrs = {
            "run_id": run_id, "task_id": task.get("id"),
            "node_id": self.id, "organization_id": self.organization_id,
        }
        if tctx is not None:
            if fetched_here:
                wall0: float | None = claim_wall0
                claim_s = time.perf_counter() - claim_perf0
            else:  # sweep-prefetched: use the batch round-trip's window
                wall0 = pre.get("_claim_wall0")
                claim_s = pre.get("_claim_s", 0.0)
            if wall0 is not None:
                TRACER.record_span(
                    "daemon.claim", wall0, claim_s,
                    parent=tctx, kind="claim", service=service,
                    attrs=trace_attrs,
                )
        with TRACER.span(
            "daemon.exec", kind="daemon", parent=tctx, service=service,
            attrs=trace_attrs, require_parent=True,
        ):
            self._execute_run(run_id, run, task, prefetched_token)

    def _execute_run(
        self,
        run_id: int,
        run: dict[str, Any],
        task: dict[str, Any],
        prefetched_token: str | None,
    ) -> None:
        def patch(**kw: Any) -> None:
            try:
                self._report(run_id, **kw)
            except RuntimeError as e:
                # 409 = the server already moved the run to a terminal state
                # (killed mid-execution); the server's word is final
                if "409" in str(e):
                    log.info("run %s already terminal at server: %s", run_id, e)
                else:
                    raise
        try:
            payload = deserialize(
                self.cryptor.decrypt_str_to_bytes(run["input"] or ""),
                writable=True,  # args flow into algorithm code (may mutate)
            )
        except Exception:
            patch(
                status=TaskStatus.FAILED.value,
                log="cannot decrypt/deserialize input "
                + traceback.format_exc(limit=2),
                finished_at=time.time(),
            )
            return
        if task.get("engine") == "device":
            # every DETERMINISTIC refusal must happen BEFORE this daemon
            # goes ACTIVE: peers' barriers read ACTIVE as "will enter the
            # collective program", and a post-ACTIVE refusal would leave
            # them blocked inside the collectives (see preflight_device)
            try:
                self.runner.preflight_device(
                    task["image"],
                    str(task.get("init_user", {}).get("id", "")),
                )
            except PolicyViolation as e:
                patch(
                    status=TaskStatus.NOT_ALLOWED.value,
                    log=str(e),
                    finished_at=time.time(),
                )
                return
            except UnknownAlgorithm as e:
                patch(
                    status=TaskStatus.NO_IMAGE.value,
                    log=str(e),
                    finished_at=time.time(),
                )
                return
        # inside the daemon.exec span: this record (and everything the run
        # logs from here on this thread) carries the task's trace_id, the
        # join key a flight-recorder dump correlates logs to spans with
        log.info(
            "run %s: executing %s/%s for task %s", run_id,
            task.get("image"), task.get("method"), task.get("id"),
        )
        # activation is the dispatch serialization point: the server takes
        # it as a compare-and-swap (PENDING -> ACTIVE, one winner). A 409
        # here means another claimant — this daemon's own duplicate
        # dispatch, or the same run claimed through a DIFFERENT server
        # replica — already activated it, and executing anyway would
        # double-run the algorithm. Unlike the terminal-state 409s that
        # `patch` swallows mid-run, a lost activation ABORTS the run.
        try:
            self._report(
                run_id, status=TaskStatus.ACTIVE.value,
                started_at=time.time(),
            )
        except RuntimeError as e:
            if "409" in str(e):
                log.info(
                    "run %s activation lost (already active/terminal at "
                    "server): %s — dropping", run_id, e,
                )
                self.activations_lost += 1
                return
            raise
        # past the CAS: this daemon is THE executor of this run. The two
        # counters are the bench's double-dispatch ledger — across all
        # daemons, activations_won must equal the number of runs created.
        self.activations_won += 1
        if self.vpn.enabled:
            # register the algorithm's declared ports (module EXPOSED_PORTS;
            # reference: EXPOSE labels) as server Port entities before the
            # run starts, so peer partials can look them up mid-round
            try:
                for p in self.runner.algorithm_ports(task["image"]):
                    self.request(
                        "POST",
                        "port",
                        {"run_id": run_id, "port": p, "label": "vpn"},
                    )
            except Exception as e:
                log.warning("port registration failed for run %s: %s",
                            run_id, e)
        try:
            # everything after ACTIVE must record its failure, or the run
            # sticks ACTIVE forever while the researcher polls
            token = prefetched_token or self.request(
                "POST",
                "token/container",
                {"task_id": task["id"], "image": task["image"]},
            )["container_token"]
            session = task.get("session") or {}
            spec = RunSpec(
                run_id=run_id,
                task_id=task["id"],
                image=task["image"],
                engine=task.get("engine") or "process",
                method=payload.get("method", task["method"]),
                input_payload=payload,
                databases=task.get("databases") or [],
                session_id=session.get("id"),
                store_as=task.get("store_as"),
                token=token,
                server_url=(
                    self._proxy_server.url if self._proxy_server else ""
                ),
                metadata={
                    "node_id": self.id,
                    "organization": str(self.organization_id),
                    "collaboration": str(self.collaboration_id),
                    "init_user": str(task.get("init_user", {}).get("id", "")),
                },
            )
            if spec.engine == "device" and self.runner.device_engine:
                self._await_device_peers(task, run_id)
            # kind="exec" is what the straggler view groups by station
            with TRACER.span(
                "runner.exec", kind="exec",
                service=f"daemon:{self.name}",
                attrs={
                    "run_id": run_id,
                    "organization_id": self.organization_id,
                    "node_id": self.id,
                    "engine": spec.engine,
                },
                require_parent=True,
            ):
                result = self.runner.run(spec)
        except PolicyViolation as e:
            patch(
                status=TaskStatus.NOT_ALLOWED.value,
                log=str(e),
                finished_at=time.time(),
            )
            return
        except UnknownAlgorithm as e:
            patch(
                status=TaskStatus.NO_IMAGE.value,
                log=str(e),
                finished_at=time.time(),
            )
            return
        except Exception:
            patch(
                status=TaskStatus.CRASHED.value,
                log=traceback.format_exc(limit=8),
                finished_at=time.time(),
            )
            return
        if run_id in self._killed:
            # killed while executing: the server already holds KILLED; do
            # not deliver results the user cancelled
            log.info("run %s was killed mid-execution; dropping result", run_id)
            return
        # result goes back encrypted toward the INITIATING organization —
        # still inside the record-failure envelope: a missing/invalid init-org
        # public key or a serialization error must not leave the run ACTIVE
        # forever with the result silently lost
        from vantage6_tpu_torch.common.serialization import serialize

        try:
            init_org = task.get("init_org", {}).get("id")
            pubkey = ""
            if self.encrypted and init_org is not None:
                org = self.request("GET", f"organization/{init_org}")
                pubkey = org.get("public_key") or ""
            # the node's wire_format policy covers the UPLOADED result too
            # (not just the container ABI): a node pinned to v1 for old
            # researcher clients must not push v2 binary result blobs
            wire_format = self.runner.policies.get("wire_format")
            blob = self.cryptor.encrypt_bytes_to_str(
                serialize(result, format=wire_format),
                pubkey,
                format=wire_format,
            )
            # result upload as its own hop: serialize+encrypt above stay in
            # daemon.exec; this span is PURELY the report round-trip (which
            # may coalesce into a PATCH run/batch — the wait is the cost)
            with TRACER.span(
                "daemon.report", kind="report",
                service=f"daemon:{self.name}",
                attrs={"run_id": run_id, "result_bytes": len(blob)},
                require_parent=True,
            ):
                patch(
                    status=TaskStatus.COMPLETED.value,
                    result=blob,
                    finished_at=time.time(),
                )
        except Exception:
            patch(
                status=TaskStatus.FAILED.value,
                log="result delivery failed: "
                + traceback.format_exc(limit=4),
                finished_at=time.time(),
            )
            return
        if spec.store_as and isinstance(result, dict) and result.get("stored"):
            # session bookkeeping only (the dataframe stayed local); a
            # failed report must not fail the COMPLETED run
            try:
                self.request(
                    "PATCH",
                    f"session/{spec.session_id}/dataframe/{spec.store_as}",
                    {"ready": True, "columns": result.get("columns") or []},
                )
            except Exception as e:
                log.warning(
                    "session dataframe report failed for run %s: %s",
                    run_id, e,
                )

    # --------------------------------------------------------------- health
    def ping(self) -> None:
        self.request("POST", "ping")
        self.last_ping_at = time.time()
        self.ping_failures = 0

    def alerts(self) -> dict[str, Any]:
        """The server watchdog's alert state (GET /api/alerts) — the
        daemon-side client of the ops plane, for operators shelling into
        a station and for tests asserting the federation's health."""
        return self.request("GET", "alerts")
