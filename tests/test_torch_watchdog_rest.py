"""The port's watchdog behind its server and daemon: ``/api/health``
verdict + components, ``/api/alerts``, ``POST /api/debug/dump`` auth +
bundle, the fault-injection acceptance smoke (wedged ACTIVE run + lapsed
node), and the daemon's event-poll backoff.

The port's copy of ``tests/test_watchdog.py``'s ``TestServerApi`` and
``TestDaemonBackoff``, the cases that waited for the server and the daemon.
"""
import logging
import time

import pytest

from vantage6_tpu_torch.common.flight import FLIGHT, read_bundle
from vantage6_tpu_torch.common.telemetry import REGISTRY
from vantage6_tpu_torch.runtime.tracing import TRACER, parse_traceparent
from vantage6_tpu_torch.runtime.watchdog import DEFAULT_RULES, WATCHDOG
from vantage6_tpu_torch.server.app import ServerApp


@pytest.fixture()
def srv():
    TRACER.configure(enabled=True, sample=1.0, sink=None)
    TRACER.clear()
    # the singleton watchdog reads the process-global learning registry
    # (registered feed): histories recorded by EARLIER test modules'
    # aggregations must not leak alerts into this server's verdict
    from vantage6_tpu_torch.runtime.learning import LEARNING

    LEARNING.clear()
    app = ServerApp()
    app.ensure_root(password="rootpass123")
    yield app
    app.close()
    # restore singleton thresholds touched by tests
    WATCHDOG.configure(
        interval=5.0, run_deadline_s=300.0, ping_window_s=60.0,
    )


def _login(srv):
    c = srv.test_client()
    c.token = c.post(
        "/api/token/user",
        json_body={"username": "root", "password": "rootpass123"},
    ).json["access_token"]
    return c




class TestServerApi:
    def test_health_ok_with_components(self, srv):
        h = srv.test_client().get("/api/health").json
        assert h["status"] == "ok"
        assert set(h["components"]) >= {"event_hub", "tracer_sink",
                                        "watchdog"}
        assert all(c["ok"] for c in h["components"].values())
        assert h["alerts"]["active"] == 0
        # the capability card survives the upgrade
        assert h["long_poll"] is True and h["metrics"] == "/api/metrics"

    def test_health_degraded_on_component_failure(self, srv):
        WATCHDOG.register_component("injected", lambda: (False, "broken"))
        try:
            h = srv.test_client().get("/api/health").json
            assert h["status"] == "degraded"
            assert h["components"]["injected"]["detail"] == "broken"
        finally:
            WATCHDOG.unregister_component("injected")
        assert srv.test_client().get("/api/health").json["status"] == "ok"

    def test_alerts_endpoint_shape(self, srv):
        a = srv.test_client().get("/api/alerts").json
        assert a["active"] == [] and a["status"] == "ok"
        assert set(a["rules"]) == {r.name for r in DEFAULT_RULES}
        assert all(
            row["summary"] and row["runbook"]
            for row in a["rules"].values()
        )

    def test_debug_dump_requires_auth(self, srv):
        c = srv.test_client()
        assert c.post("/api/debug/dump").status == 401
        r = _login(srv).post("/api/debug/dump")
        assert r.status == 201
        assert read_bundle(r.json["path"])[0]["type"] == "flight_header"

    def test_double_close_keeps_newer_embedders_watchdog(self):
        """close() is idempotent: a second close of an old ServerApp must
        not decrement the refcounted singleton again and stop a NEWER
        embedder's evaluation thread."""
        a = ServerApp()
        a.close()
        b = ServerApp()
        try:
            with WATCHDOG._lock:
                users = WATCHDOG._users
            assert users >= 1 and WATCHDOG._thread is not None
            a.close()  # stale re-close: must be a no-op
            with WATCHDOG._lock:
                assert WATCHDOG._users == users
            assert (
                WATCHDOG._thread is not None and WATCHDOG._thread.is_alive()
            )
        finally:
            b.close()

    def test_wedged_run_and_lapsed_node_degrade(self, srv):
        """The acceptance smoke, deterministic: a run wedged ACTIVE past
        its deadline + a node online past its ping window raise their
        alerts on the next evaluation, flip /api/health to degraded, and
        a dump doctors into a timeline naming the stuck run."""
        from vantage6_tpu_torch.server import models as m

        c = _login(srv)
        org = c.post("/api/organization", json_body={"name": "o"}).json
        collab = c.post("/api/collaboration", json_body={
            "name": "c", "organization_ids": [org["id"]],
        }).json
        node = c.post("/api/node", json_body={
            "organization_id": org["id"],
            "collaboration_id": collab["id"],
        }).json
        with TRACER.span("client.task_create"):
            task = c.post("/api/task", json_body={
                "collaboration_id": collab["id"],
                "organizations": [{"id": org["id"]}],
                "image": "img",
                "input": {"method": "m"},
            }).json
        run_id = task["runs"][0]
        run = m.TaskRun.get(run_id)
        run.status = "active"
        run.started_at = time.time() - 100
        run.save()
        dbnode = m.Node.get(node["id"])
        dbnode.status = "online"
        dbnode.last_seen_at = time.time() - 100
        dbnode.save()
        WATCHDOG.configure(run_deadline_s=5.0, ping_window_s=5.0)
        active = WATCHDOG.evaluate()
        rules = {a["rule"] for a in active}
        assert {"stuck_run", "daemon_lapsed"} <= rules
        stuck = next(a for a in active if a["rule"] == "stuck_run")
        assert stuck["labels"]["run_id"] == run_id
        # the alert is parented on the task's own trace
        assert parse_traceparent(stuck["traceparent"]).trace_id \
            == task["trace_id"]
        assert c.get("/api/health").json["status"] == "degraded"
        api = c.get("/api/alerts").json
        assert {a["rule"] for a in api["active"]} >= {"stuck_run",
                                                      "daemon_lapsed"}
        # post-mortem: dump + doctor name the stuck run
        dump = c.post("/api/debug/dump").json
        import tools.doctor as doctor

        rc = doctor.main([dump["path"], "--trace",
                          task["trace_id"][:8], "--tail", "0"])
        assert rc == 0
        rows = doctor.timeline(
            doctor.load([dump["path"]]), trace=task["trace_id"][:8]
        )
        assert any(
            r.get("name") == "alert.stuck_run" for r in rows
        )
        digest = doctor.alert_digest(doctor.load([dump["path"]]))
        stuck_row = next(d for d in digest if d["rule"] == "stuck_run")
        assert f"run {run_id}" in stuck_row["message"]
        assert stuck_row["runbook"]
        # healed: watchdog clears, health recovers
        run2 = m.TaskRun.get(run_id)
        run2.status = "completed"
        run2.save()
        dbnode2 = m.Node.get(node["id"])
        dbnode2.last_seen_at = time.time()
        dbnode2.save()
        WATCHDOG.evaluate()
        assert c.get("/api/health").json["status"] == "ok"

    def test_tracer_sink_failure_degrades_health(self, srv, tmp_path):
        """The tracer-sink component self-check: a span sink that died
        mid-flight (disk full / unwritable path) must flip /api/health
        to degraded — trace evidence is being lost."""
        c = srv.test_client()
        assert c.get("/api/health").json["status"] == "ok"
        TRACER.configure(sink=str(tmp_path / "no-such-dir" / "x.jsonl"))
        try:
            with TRACER.span("doomed"):
                pass  # the write fails, sink_errors increments
            h = c.get("/api/health").json
            assert h["status"] == "degraded"
            assert not h["components"]["tracer_sink"]["ok"]
            assert "sink" in h["components"]["tracer_sink"]["detail"]
        finally:
            # the public heal path: re-pointing/clearing the sink resets
            # the failure streak — no hand-poking of sink_errors needed
            TRACER.configure(sink=None)
        assert TRACER.sink_errors == 0
        assert c.get("/api/health").json["status"] == "ok"

    def test_metrics_exposes_watchdog_series(self, srv):
        WATCHDOG.evaluate()
        text = srv.test_client().get("/api/metrics").body.decode()
        for series in (
            "v6t_alerts_active", "v6t_watchdog_evaluations_total",
            "v6t_health_degraded", "v6t_flight_records",
        ):
            assert series in text


# -------------------------------------------------- daemon backoff satellite
class TestDaemonBackoff:
    def test_one_warning_per_streak_and_counter(self, srv):
        from vantage6_tpu_torch.node.daemon import NodeDaemon

        http = srv.serve(port=0, background=True)
        c = _login(srv)
        org = c.post("/api/organization", json_body={"name": "bo"}).json
        collab = c.post("/api/collaboration", json_body={
            "name": "bc", "organization_ids": [org["id"]],
        }).json
        node = c.post("/api/node", json_body={
            "organization_id": org["id"],
            "collaboration_id": collab["id"],
        }).json
        d = NodeDaemon(
            api_url=http.url, api_key=node["api_key"],
            mode="inline", poll_interval=0.01, event_wait=0.0,
        )
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        daemon_log = logging.getLogger("vantage6_tpu_torch/node")
        old_level = daemon_log.level
        daemon_log.addHandler(handler)
        daemon_log.setLevel(logging.DEBUG)
        before = REGISTRY.snapshot().get("v6t_daemon_backoff_total", 0)
        try:
            http.stop()  # the server goes away mid-life
            for _ in range(3):
                assert d._poll_once() is True  # backoff slept for us
        finally:
            daemon_log.removeHandler(handler)
            daemon_log.setLevel(old_level)
        poll_records = [
            r for r in records if "event poll failed" in r.getMessage()
        ]
        warnings = [r for r in poll_records
                    if r.levelno == logging.WARNING]
        debugs = [r for r in poll_records if r.levelno == logging.DEBUG]
        assert len(warnings) == 1  # once per streak
        assert len(debugs) == 2   # the rest demoted
        assert REGISTRY.snapshot()["v6t_daemon_backoff_total"] == before + 3
        # every attempt still lands in the flight recorder
        notes = [n for n in list(FLIGHT._notes)
                 if n["kind"] == "event_poll_error"]
        assert len(notes) >= 3

    def test_ping_bookkeeping(self, srv):
        from vantage6_tpu_torch.node.daemon import NodeDaemon
        from vantage6_tpu_torch.server import models as m

        http = srv.serve(port=0, background=True)
        c = _login(srv)
        org = c.post("/api/organization", json_body={"name": "po"}).json
        collab = c.post("/api/collaboration", json_body={
            "name": "pc", "organization_ids": [org["id"]],
        }).json
        node = c.post("/api/node", json_body={
            "organization_id": org["id"],
            "collaboration_id": collab["id"],
        }).json
        try:
            d = NodeDaemon(
                api_url=http.url, api_key=node["api_key"], mode="inline",
                sync_interval=30.0, ping_interval=0.5,
            )
            assert d.ping_interval == 0.5
            before = m.Node.get(node["id"]).last_seen_at
            d.ping()
            assert d.last_ping_at is not None
            assert d.ping_failures == 0
            after = m.Node.get(node["id"]).last_seen_at
            assert after is not None and (before is None or after >= before)
        finally:
            http.stop()


# ------------------------------------------------------------------- doctor
