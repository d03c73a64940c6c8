"""The control-plane server application.

Parity: vantage6-server's `ServerApp`/`run_server` (SURVEY.md §2 item 1):
bind the database, migrate the schema, seed the rule matrix + default roles,
ensure a root user, register the REST resources and the event hub, serve.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Callable

from vantage6_tpu_torch.common.context import ServerContext
from vantage6_tpu_torch.common.log import setup_logging
from vantage6_tpu_torch.server import models
from vantage6_tpu_torch.server.auth import TokenAuthority
from vantage6_tpu_torch.server.events import EventHub
from vantage6_tpu_torch.server.permission import PermissionManager
from vantage6_tpu_torch.server.resources import register_resources
from vantage6_tpu_torch.server.web import App, AppServer, TestClient

log = setup_logging("vantage6_tpu_torch/server")

# replica-local: disambiguates in-process replicas sharing one pid
_REPLICA_SEQ = itertools.count(1)


class ServerApp:
    def __init__(
        self,
        uri: str = "sqlite:///:memory:",
        jwt_secret: str | None = None,
        algorithm_policy: Callable[[str], bool] | None = None,
        mailer: Any = None,
        store_url: str | None = None,
        replica_id: str | None = None,
    ):
        self.started_at = time.time()
        self.db = models.init(uri)
        # replica identity: stamped on every request span (web.App), the
        # heartbeat table, and /api/health — how trace_view attributes
        # per-hop latency per replica when N of us share one store
        self.replica_id = replica_id or os.environ.get(
            "V6T_REPLICA_ID"
        ) or f"srv-{os.getpid()}-{next(_REPLICA_SEQ)}"
        self.pm = PermissionManager()
        self.default_roles = self.pm.ensure_default_roles()
        self.tokens = TokenAuthority(jwt_secret)
        # event substrate keyed off the backend: a SHARED store (N replica
        # processes) needs the event stream and cache-invalidation bus IN
        # the store; a single replica keeps the in-process hub unchanged
        if self.db.SHARED:
            from vantage6_tpu_torch.server.pubsub import DbPubSub, record_heartbeat

            self.hub: Any = DbPubSub(self.db, replica_id=self.replica_id)
            record_heartbeat(self.db, self.replica_id, self.started_at)
            # cross-replica cache coherence: start draining CACHE_INVALIDATE
            # events emitted by the peers from "now"
            self._inval_cursor = self.hub.cursor
        else:
            self.hub = EventHub()
            self._inval_cursor = 0
        self._inval_last_drain = 0.0  # replica-local: drain rate limiter
        self._inval_lock = threading.Lock()
        # hot-path caches (server/cache.py): token→principal resolution and
        # org→collaborations visibility. Explicitly invalidated by the
        # mutating endpoints in resources.py; short TTL as backstop.
        from vantage6_tpu_torch.server.cache import AuthCache, VisibilityCache

        self.auth_cache = AuthCache()
        self.vis_cache = VisibilityCache()
        # account recovery mail (reference: SMTP; pluggable here — the
        # default LogMailer records messages for dev/test deployments)
        from vantage6_tpu_torch.server.mail import LogMailer

        self.mailer = mailer or LogMailer()
        # optional algorithm-store gate: image -> allowed? (SURVEY §2 item 9;
        # wired up by the store service or a static allow-list)
        self.algorithm_policy = algorithm_policy
        # linked algorithm store (SURVEY §2 item 9); the UI browses it
        # through the server-side proxy at /api/store/algorithm
        self.store_url = store_url.rstrip("/") if store_url else None
        self.ws_url: str | None = None  # set by an attached WebSocketBridge
        # replica-local: each replica serves its own websocket bridges
        self._bridges: list[Any] = []  # stopped in close()
        self.app = App("server", replica_id=self.replica_id)
        # learning plane over the shared store: round records key on
        # (task, round) in the learning_round table, so a trajectory whose
        # per-round subtasks were served by different replicas still reads
        # back as ONE history from /api/rounds (runtime/learning.py)
        self._learning_store: Any = None
        if self.db.SHARED:
            from vantage6_tpu_torch.runtime.learning import LEARNING, LearningStore

            self._learning_store = LearningStore(self.db)
            LEARNING.attach_store(self._learning_store)
        # unified telemetry (common.telemetry): this server's hot-state
        # gauges — event hub fill/eviction, cache hit rates — join the
        # process-wide wire/REST/executor/tracing series behind
        # GET /api/metrics. Keyed registration: a newer ServerApp in the
        # same process replaces this one's collector.
        from vantage6_tpu_torch.common.telemetry import REGISTRY

        REGISTRY.register_collector("server", self._telemetry_collector)
        # live health watchdog (runtime.watchdog): this server feeds the
        # process singleton its DB view (ACTIVE runs for stuck_run, node
        # ping freshness for daemon_lapsed) and registers the self-checks
        # behind the /api/health verdict. Keyed registration — a newer
        # ServerApp in the same process replaces this one's feed — and the
        # evaluation thread is refcounted (started here, stopped in close).
        from vantage6_tpu_torch.runtime.watchdog import WATCHDOG

        self.watchdog = WATCHDOG
        WATCHDOG.register_feed("server", self._watchdog_feed)
        WATCHDOG.register_component("event_hub", self._hub_check)
        WATCHDOG.register_component("tracer_sink", _tracer_sink_check)
        WATCHDOG.start()
        # autopilot remediation over the store (runtime.autopilot,
        # docs/OPERATOR_GUIDE.md "autopilot"): opt-in via V6T_AUTOPILOT.
        # The server actuator only carries the requeue capabilities —
        # selection/mask/admission policies self-suppress here. Listener
        # key is per-replica: two replicas may both attach, and the
        # store-level CAS keeps their concurrent remediation exactly-once.
        # fleet self-ingest cadence: the server is itself a fleet source —
        # its snapshot lands in the fleet tables on the watchdog tick,
        # rate-limited to the push interval like any remote pusher
        # replica-local: watchdog-thread-only cursor state
        self._fleet_last_push = 0.0
        self._fleet_notes_since = time.time()
        self._fleet_seq = 0
        self.autopilot = None
        if os.environ.get("V6T_AUTOPILOT", "").strip().lower() in (
            "1", "true", "yes", "on",
        ):
            from vantage6_tpu_torch.runtime.autopilot import Autopilot

            self.autopilot = Autopilot(
                actuator=ServerActuator(self),
                listener_key=f"autopilot-{self.replica_id}",
            )
            self.autopilot.attach()
        register_resources(self)
        from vantage6_tpu_torch.server.ui import register_ui

        register_ui(self)

    def drain_invalidations(self) -> None:
        """Apply CACHE_INVALIDATE events other replicas committed to the
        shared stream (resources.py emits them next to its local
        invalidate calls). Called from the auth hot path, rate-limited to
        one stream read per ~25 ms — the cross-replica staleness bound;
        the caches' own TTL stays the backstop. No-op on an in-process
        hub: there a local invalidate already covered the only replica."""
        if not getattr(self.hub, "SHARED", False):
            return
        now = time.monotonic()
        with self._inval_lock:
            if now - self._inval_last_drain < 0.025:
                return
            self._inval_last_drain = now
            cursor = self._inval_cursor
        from vantage6_tpu_torch.server.events import CACHE_INVALIDATE, REPLICA_ROOM

        try:
            events = self.hub.fetch(since=cursor, rooms=[REPLICA_ROOM])
            new_cursor = self.hub.cursor
        except Exception:  # backend busy — next request retries
            return
        for ev in events:
            if ev.name != CACHE_INVALIDATE:
                continue
            entity = (ev.data or {}).get("entity")
            pid = (ev.data or {}).get("id")
            if entity in ("user", "node") and pid is not None:
                self.auth_cache.invalidate_principal(entity, pid)
            elif entity in ("role", "rule"):
                self.auth_cache.invalidate_all()
            elif entity == "collaboration":
                self.vis_cache.invalidate_all()
        with self._inval_lock:
            self._inval_cursor = max(self._inval_cursor, new_cursor)

    def _watchdog_feed(self) -> dict[str, Any]:
        """The server's run/node state for the watchdog rules: every
        ACTIVE run (with the task's traceparent so a stuck_run alert lands
        on the round's own trace) and every online node's ping freshness.
        Runs on the watchdog thread — db.py keeps one sqlite connection
        per thread for exactly this access pattern. On a SHARED backend
        the periodic tick doubles as this replica's heartbeat, and the
        peers' heartbeat rows feed the `replica_lapsed` rule."""
        if models.Model.db is None:  # closed mid-evaluation
            return {}
        runs = []
        task_tp: dict[int, str | None] = {}
        for run in models.TaskRun.list(status="active"):
            if run.task_id not in task_tp:
                task = models.Task.get(run.task_id)
                task_tp[run.task_id] = task.traceparent if task else None
            runs.append({
                "run_id": run.id,
                "task_id": run.task_id,
                "status": "active",
                "assigned_at": run.assigned_at,
                "started_at": run.started_at,
                "organization_id": run.organization_id,
                "node_id": run.node_id,
                "traceparent": task_tp[run.task_id],
            })
        nodes = [
            {
                "node_id": n.id,
                "name": n.name,
                "status": n.status or "offline",
                "last_seen_at": n.last_seen_at,
            }
            for n in models.Node.list(status="online")
        ]
        feed: dict[str, Any] = {"runs": runs, "nodes": nodes}
        if self.db.SHARED:
            from vantage6_tpu_torch.server import pubsub

            try:
                pubsub.record_heartbeat(
                    self.db, self.replica_id, self.started_at
                )
                feed["replicas"] = pubsub.list_replicas(self.db)
            except Exception:  # heartbeat must never break the rule feeds
                pass
        # fleet fabric (server/fleet.py): self-ingest this replica's own
        # compact snapshot on the push cadence — the server is a fleet
        # source like any daemon — then publish the store-backed series
        # and freshness census the SLO rules read. The tick piggybacks
        # the watchdog thread exactly as remote pushers piggyback their
        # ping workers.
        from vantage6_tpu_torch.common import fleet as fleet_push
        from vantage6_tpu_torch.server import fleet

        now = time.time()
        if now - self._fleet_last_push >= fleet_push.push_interval():
            self._fleet_last_push = now
            try:
                payload = fleet_push.build_snapshot(
                    self.replica_id, "server", self._fleet_seq,
                    notes_since=self._fleet_notes_since,
                )
                fleet.ingest(self.db, payload)
                self._fleet_seq += 1
                for note in payload.get("notes") or []:
                    ts = note.get("ts")
                    if isinstance(ts, (int, float)):
                        self._fleet_notes_since = max(
                            self._fleet_notes_since, float(ts)
                        )
            except Exception:  # self-ingest must never break the rule feeds
                pass
        slow = float(self.watchdog.config.get("slo_slow_window_s", 3600.0))
        feed["fleet_sources"] = fleet.sources(self.db, now)
        feed["slo_dispatch"] = fleet.metric_series(
            self.db, "v6t_run_dispatch_seconds", now - slow
        )
        feed["slo_rounds"] = fleet.metric_series(
            self.db, "v6t_round_updates_total", now - slow
        )
        return feed

    def _hub_check(self) -> tuple[bool, str]:
        try:
            stats = self.hub.stats()
        except Exception as e:  # pragma: no cover - hub is in-process
            return False, f"event hub stats raised: {e}"
        return True, (
            f"buffer {stats['buffer_len']}, cursor {stats['cursor']}"
        )

    def _telemetry_collector(self) -> dict[str, float]:
        hub = self.hub.stats()
        return {
            "v6t_event_hub_buffer_len": hub["buffer_len"],
            "v6t_event_hub_cursor": hub["cursor"],
            "v6t_event_hub_evicted_through": hub["evicted_through"],
            "v6t_event_hub_subscribers": hub["subscribers"],
            "v6t_auth_cache_hits_total": self.auth_cache.hits,
            "v6t_auth_cache_misses_total": self.auth_cache.misses,
            "v6t_auth_cache_entries": len(self.auth_cache),
            "v6t_visibility_cache_hits_total": self.vis_cache.hits,
            "v6t_visibility_cache_misses_total": self.vis_cache.misses,
            "v6t_visibility_cache_entries": len(self.vis_cache),
            "v6t_server_uptime_seconds": time.time() - self.started_at,
        }

    def close(self) -> None:
        """Stop attached bridges and release the database binding (required
        before a new ServerApp in the same process — see models.init).
        Idempotent: the watchdog's evaluation thread is refcounted, so a
        second close() must not decrement again (it would stop a newer
        embedder's loop in the same process)."""
        if getattr(self, "_closed", False):
            return
        self._closed = True
        for bridge in list(self._bridges):
            try:
                bridge.stop()
            except Exception:  # pragma: no cover
                pass
        self._bridges.clear()
        # symmetric with __init__'s register: a closed server must not
        # keep reporting (or be pinned alive by) the telemetry registry
        from vantage6_tpu_torch.common.telemetry import REGISTRY
        from vantage6_tpu_torch.runtime.watchdog import WATCHDOG

        if self.autopilot is not None:
            self.autopilot.detach()
            self.autopilot = None
        # only if still ours: a newer ServerApp may have replaced the feed
        # (keyed registration — same story as the telemetry collector);
        # the shared components go only when no server feed remains at all
        WATCHDOG.unregister_feed("server", self._watchdog_feed)
        if not WATCHDOG.has_feed("server"):
            WATCHDOG.unregister_component("event_hub")
            WATCHDOG.unregister_component("tracer_sink")
        # reconcile once with the feed gone: alerts THIS server's state
        # raised are proposed by nothing anymore and clear now, instead of
        # haunting the singleton until some future embedder's first tick
        try:
            WATCHDOG.evaluate()
        except Exception:  # pragma: no cover - teardown must not fail
            pass
        WATCHDOG.stop()
        REGISTRY.unregister_collector("server", self._telemetry_collector)
        if self._learning_store is not None:
            from vantage6_tpu_torch.runtime.learning import LEARNING

            LEARNING.detach_store(self._learning_store)
        if self.db.SHARED:
            from vantage6_tpu_torch.server import pubsub

            try:  # clean departure: don't linger as "lapsed" in peers' health
                pubsub.drop_heartbeat(self.db, self.replica_id)
            except Exception:  # pragma: no cover - teardown must not fail
                pass
        if hasattr(self.hub, "close"):
            self.hub.close()
        # refcounted: with in-process replicas over one SHARED store, only
        # the last close actually unbinds/closes the database (models.release)
        models.release(self.db)

    # ----------------------------------------------------------------- seed
    def ensure_root(
        self,
        username: str = "root",
        password: str | None = None,
        organization_name: str = "root",
    ) -> tuple[models.User, str | None]:
        """Idempotently create the root org + root user (reference seeds the
        same at first start). Returns (user, generated_password | None)."""
        user = models.User.first(username=username)
        if user is not None:
            return user, None
        org = models.Organization.first(name=organization_name)
        if org is None:
            org = models.Organization(name=organization_name).save()
        import secrets

        generated = password or secrets.token_urlsafe(16)
        user = models.User(username=username, organization_id=org.id)
        user.set_password(generated)
        user.save()
        user.add_role(self.default_roles["Root"])
        log.info("created root user %r", username)
        return user, generated

    # ---------------------------------------------------------------- serve
    def test_client(self) -> TestClient:
        return TestClient(self.app)

    def serve_ws(self, host: str = "127.0.0.1", port: int = 0):
        """Start the SocketIO-equivalent push bridge (SURVEY §2 item 6)."""
        from vantage6_tpu_torch.server.ws import WebSocketBridge

        bridge = WebSocketBridge(self, host, port).start_background()
        self._bridges.append(bridge)
        return bridge

    def serve(
        self, host: str = "127.0.0.1", port: int = 7601, background: bool = False
    ) -> AppServer:
        server = AppServer(self.app, host, port)
        log.info("serving control plane on %s", server.url)
        if background:
            return server.start_background()
        server.serve_forever()
        return server


class ServerActuator:
    """Autopilot capabilities over the server's store (duck-typed by
    runtime.autopilot): re-queue runs orphaned by a lapsed daemon or a
    lapsed replica. Selection-weight / mask / admission capabilities are
    Federation-side — policies needing them self-suppress here.

    Both requeues are CAS-guarded (`TaskRun.compare_and_swap` with the
    observed status as the expectation), the same idiom as claim-batch's
    orphan reset: two replicas' autopilots remediating the SAME
    daemon_lapsed alert concurrently re-queue each orphan exactly once —
    the loser's swap fails and it leaves the run alone.
    """

    def __init__(self, srv: ServerApp):
        self.srv = srv

    def _requeue(
        self, run: "models.TaskRun", status: Any, message: str
    ) -> bool:
        from vantage6_tpu_torch.common.enums import TaskStatus
        from vantage6_tpu_torch.server import events as ev

        if not models.TaskRun.compare_and_swap(
            run.id,
            sets={"status": TaskStatus.PENDING.value, "log": message},
            expect={"status": status.value},
        ):
            return False
        task = models.Task.get(run.task_id)
        if task is not None:
            self.srv.hub.emit(
                ev.STATUS_UPDATE,
                {
                    "task_id": task.id,
                    "run_id": run.id,
                    "status": TaskStatus.PENDING.value,
                    "organization_id": run.organization_id,
                    "task_status": task.status(),
                },
                room=ev.collaboration_room(task.collaboration_id),
            )
        return True

    def requeue_node_runs(self, node_id: int) -> int:
        """daemon_lapsed remediation: the node stopped pinging mid-run,
        so its INITIALIZING/ACTIVE runs will never report — put them back
        to PENDING for whoever claims next (the restarted daemon, or a
        peer node of the same organization). Returns how many runs THIS
        caller re-queued (a concurrent peer's CAS wins count there)."""
        from vantage6_tpu_torch.common.enums import TaskStatus

        node = models.Node.get(node_id)
        if node is None:
            return 0
        requeued = 0
        for status in (TaskStatus.INITIALIZING, TaskStatus.ACTIVE):
            for run in models.TaskRun.list(
                status=status.value, organization_id=node.organization_id
            ):
                if run.node_id is not None and run.node_id != node_id:
                    continue  # a sibling node's live work
                if self._requeue(
                    run, status,
                    "daemon lapsed mid-run; re-queued by autopilot",
                ):
                    requeued += 1
        return requeued

    def requeue_replica_runs(self, replica_id: str) -> int:
        """replica_lapsed remediation: a peer replica died; any run whose
        node has meanwhile gone offline has lost both its server AND its
        executor — re-queue those. Runs of still-online nodes are left
        alone (any surviving replica serves their reports)."""
        from vantage6_tpu_torch.common.enums import TaskStatus

        requeued = 0
        node_status: dict[int | None, str] = {None: "offline"}
        for status in (TaskStatus.INITIALIZING, TaskStatus.ACTIVE):
            for run in models.TaskRun.list(status=status.value):
                if run.node_id not in node_status:
                    node = models.Node.get(run.node_id)
                    node_status[run.node_id] = (
                        (node.status or "offline") if node else "offline"
                    )
                if node_status[run.node_id] == "online":
                    continue
                if self._requeue(
                    run, status,
                    f"replica {replica_id} lapsed with the node offline; "
                    "re-queued by autopilot",
                ):
                    requeued += 1
        return requeued


def _tracer_sink_check() -> tuple[bool, str]:
    """Tracer health for /api/health: a configured-then-failed span sink
    means trace evidence is being lost — degraded, not fatal."""
    from vantage6_tpu_torch.runtime.tracing import TRACER

    stats = TRACER.stats()
    if stats["sink_errors"] > 0:
        return False, (
            f"JSONL span sink disabled after {stats['sink_errors']} write "
            "failure(s); spans continue in the ring buffer only"
        )
    return True, (
        f"{stats['spans_recorded']} spans recorded, "
        f"{stats['spans_dropped']} evicted"
    )


def run_server(ctx: ServerContext, background: bool = False) -> AppServer:
    """Start a server from an instance context (reference: `v6 server start`)."""
    from vantage6_tpu_torch.common.flight import install as flight_install
    from vantage6_tpu_torch.server.mail import mailer_from_config

    # arm crash forensics for the server process: dump the flight rings on
    # any uncaught exception or `kill -USR2` (docs/observability.md)
    flight_install(service="server")
    srv = ServerApp(
        uri=ctx.uri,
        jwt_secret=ctx.config.get("jwt_secret") or None,
        mailer=mailer_from_config(ctx.config.get("smtp")),
        store_url=ctx.config.get("store_url") or None,
    )
    user, generated = srv.ensure_root()
    if generated:
        # printed once at first start; operators change it immediately
        log.warning("root password (first start): %s", generated)
    return srv.serve(port=ctx.port, background=background)
