"""The fleet telemetry fabric on the port's server: pushes ingested by any
replica of one store, retention of old samples, and a live fleet of
daemons pushing to ``/api/telemetry`` and read back from ``/api/fleet``.

The port's copy of ``tests/test_fleet.py``'s ``TestCrossReplicaIngest``,
``TestRetention`` and ``TestLiveFleet``, the cases that waited for the
server and the daemon.
"""
import time

import pytest

from vantage6_tpu_torch.common.fleet import encode_push
from vantage6_tpu_torch.server import fleet as fleet_store
from vantage6_tpu_torch.server.app import ServerApp

SECRET = "fleet-shared-jwt-secret"
ROOT_PW = "rootpass123"


@pytest.fixture()
def pair(tmp_path):
    uri = "sqlite+wal:///" + str(tmp_path / "cp.db")
    a = ServerApp(uri=uri, jwt_secret=SECRET, replica_id="replica-a")
    b = ServerApp(uri=uri, jwt_secret=SECRET, replica_id="replica-b")
    a.ensure_root(password=ROOT_PW)
    yield a, b
    b.close()
    a.close()


def _root(srv: ServerApp):
    c = srv.test_client()
    r = c.post("/api/token/user", {"username": "root", "password": ROOT_PW})
    assert r.status == 200, r
    c.token = r.json["access_token"]
    return c


def _node_client(root_client, srv: ServerApp):
    org = root_client.post("/api/organization", {"name": "fleet_org"}).json
    collab = root_client.post(
        "/api/collaboration",
        {"name": "fleet", "organization_ids": [org["id"]]},
    ).json
    node = root_client.post(
        "/api/node",
        {"organization_id": org["id"], "collaboration_id": collab["id"]},
    ).json
    c = srv.test_client()
    r = c.post("/api/token/node", {"api_key": node["api_key"]})
    assert r.status == 200, r
    c.token = r.json["access_token"]
    return c


def _payload(source: str, metrics: dict, notes=(), service="daemon",
             seq=0, ts=None):
    return {
        "source": source,
        "service": service,
        "seq": seq,
        "ts": ts if ts is not None else time.time(),
        "metrics": metrics,
        "notes": list(notes),
    }


# ------------------------------------------------------------ wire + ingest

class TestCrossReplicaIngest:
    def test_push_through_either_replica_one_census(self, pair):
        """The acceptance path: two daemon snapshots pushed through
        DIFFERENT replicas of one shared WAL store read back as ONE
        coherent fleet census from both replicas' GET /api/fleet."""
        a, b = pair
        ca = _root(a)
        na = _node_client(ca, a)
        # the same node principal authenticates against replica B too —
        # one shared store, one credential set
        nb = b.test_client()
        nb.token = na.token
        # a name only THIS test pushes: the replicas self-ingest their
        # own registry (which carries real v6t_* totals from the rest
        # of the suite), so a shared name's census sum is unpredictable
        probe = "v6t_fleet_probe_calls_total"
        r1 = na.post("/api/telemetry", encode_push(_payload(
            "daemon:alpha", {probe: 10.0},
            notes=[{"kind": "fleet_test_note", "ts": time.time()}],
        )))
        assert r1.status == 201, r1
        assert r1.json["accepted"] and r1.json["metrics"] == 1
        assert r1.json["events"] == 1
        r2 = nb.post("/api/telemetry", encode_push(_payload(
            "daemon:beta", {probe: 4.0}, seq=2,
        )))
        assert r2.status == 201, r2
        for srv in (a, b):
            view = srv.test_client().get("/api/fleet").json
            names = {s["source"] for s in view["sources"]}
            assert {"daemon:alpha", "daemon:beta"} <= names
            assert view["liveness"]["daemons"] >= 2
            # undeclared names merge as gauges (sample_kind's
            # conservative default); still summed across sources
            assert view["census"]["gauges"][probe] == 14.0
            assert any(e["kind"] == "fleet_test_note"
                       for e in view["events"])

    def test_bad_push_is_a_400_not_a_crash(self, pair):
        a, _b = pair
        na = _node_client(_root(a), a)
        r = na.post("/api/telemetry", {"blob": "@@not-wire@@"})
        assert r.status == 400
        r = na.post("/api/telemetry", ["not", "a", "dict"])
        assert r.status == 400

    def test_push_requires_a_principal(self, pair):
        a, _b = pair
        c = a.test_client()
        r = c.post("/api/telemetry", encode_push(_payload(
            "daemon:anon", {"v6t_rest_calls_total": 1.0},
        )))
        assert r.status == 401

    def test_health_carries_the_fleet_block(self, pair):
        a, b = pair
        na = _node_client(_root(a), a)
        na.post("/api/telemetry", encode_push(_payload(
            "daemon:alpha", {"v6t_rest_calls_total": 1.0},
        )))
        health = b.test_client().get("/api/health").json
        assert health["fleet"]["sources"] >= 1
        assert health["fleet"]["url"] == "/api/fleet"


class TestRetention:
    def test_prune_keeps_newest_row_per_source_series(self, pair):
        a, _b = pair
        now = time.time()
        old = now - fleet_store.RETENTION_S - 60.0
        for ts, value in ((old, 1.0), (old + 1.0, 2.0)):
            a.db.execute(
                "INSERT INTO fleet_metric "
                "(source, service, seq, name, kind, value, ts) "
                "VALUES (?, ?, ?, ?, ?, ?, ?)",
                ["daemon:quiet", "daemon", 0, "v6t_rest_calls_total",
                 "counter", value, ts],
            )
        fleet_store.record_sample(
            a.db, "daemon:busy", "daemon", "v6t_rest_calls_total", 9.0
        )
        deleted = fleet_store.prune(a.db, now)
        assert deleted == 1  # the older of the two expired rows
        rows = a.db.query(
            # the replicas self-ingest their own snapshots on watchdog
            # ticks; scope to the two hand-seeded daemon sources
            "SELECT source, value FROM fleet_metric "
            "WHERE source LIKE 'daemon:%' ORDER BY source"
        )
        by_src = {r["source"]: r["value"] for r in rows}
        # the quiet source survives as its newest sample -> visible as
        # STALE in the census instead of vanishing
        assert by_src == {"daemon:quiet": 2.0, "daemon:busy": 9.0}
        srcs = {s["source"]: s for s in fleet_store.sources(a.db, now)}
        assert srcs["daemon:quiet"]["stale"]
        assert not srcs["daemon:busy"]["stale"]


# --------------------------------------------------------------- SLO engine
class TestLiveFleet:
    def test_seeded_fast_burn_raises_within_one_evaluation_and_doctor_live(
        self, tmp_path, capsys
    ):
        """End to end on a real HTTP server: seed an over-target dispatch
        series in the store, one watchdog evaluation raises the SLO alert
        naming the objective and window, and `doctor --live` renders the
        burning SLO + the lagging source. Clearing the series clears the
        alert on the next clean evaluation (no state bleeds out)."""
        uri = "sqlite+wal:///" + str(tmp_path / "live.db")
        srv = ServerApp(uri=uri, jwt_secret=SECRET, replica_id="live-a")
        srv.ensure_root(password=ROOT_PW)
        http = srv.serve(port=0, background=True)
        keep = {k: srv.watchdog.config[k]
                for k in ("slo_burn_threshold", "slo_min_samples")}
        try:
            for _ in range(6):
                fleet_store.record_sample(
                    srv.db, "daemon:slowpoke", "daemon",
                    "v6t_run_dispatch_seconds", 9.5,
                )
            srv.watchdog.configure(slo_burn_threshold=1.5,
                                   slo_min_samples=2)
            active = srv.watchdog.evaluate()  # ONE evaluation suffices
            slo = next(
                a for a in active if a["rule"] == "slo_dispatch_latency"
            )
            assert "99% of run dispatches" in slo["message"]
            assert "window" in slo["message"]
            assert "daemon:slowpoke" in slo["message"]

            import tools.doctor as doctor

            rc = doctor.main(["--live", http.url])
            out = capsys.readouterr().out
            assert rc == 0
            assert "fleet digest:" in out
            assert "BURNING SLO" in out
            assert "slo_dispatch_latency" in out          # names the SLO
            # the burn message names the offender; the digest names the
            # most-lagging source (may be the server's own self-ingest)
            assert "worst source daemon:slowpoke" in out
            assert "lagging source:" in out
        finally:
            # recovery path doubles as cleanup: drop the seeded series,
            # restore thresholds, and the next clean pass clears the alert
            srv.db.execute(
                "DELETE FROM fleet_metric "
                "WHERE name = 'v6t_run_dispatch_seconds'"
            )
            srv.watchdog.configure(**keep)
            remaining = {
                a["rule"] for a in srv.watchdog.evaluate()
            }
            http.stop()
            srv.close()
        assert "slo_dispatch_latency" not in remaining

    def test_doctor_live_unreachable_server_degrades(self, capsys):
        import tools.doctor as doctor

        rc = doctor.main(["--live", "http://127.0.0.1:9"])  # nothing there
        err = capsys.readouterr().err
        assert rc == 1
        assert "cannot poll" in err


# -------------------------------------------------- pre-fleet server interop
