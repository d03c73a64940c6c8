"""Daemon replica-rotation backoff against the port's server: a full
failed rotation bumps v6t_daemon_rotation_total + the streak and sleeps a
capped jittered delay; any success resets the streak; single-URL daemons
keep the historical fail-fast contract.

The port's copy of ``tests/test_autopilot.py``'s
``TestDaemonRotationBackoff``, which waited for the server and the daemon.
"""
import time

import pytest

from vantage6_tpu_torch.common.faults import FAULTS
from vantage6_tpu_torch.common.flight import FLIGHT
from vantage6_tpu_torch.common.telemetry import REGISTRY


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.clear()
    yield
    FAULTS.clear()



class TestDaemonRotationBackoff:
    def test_full_rotation_backs_off_and_success_resets(self):
        from vantage6_tpu_torch.node.daemon import NodeDaemon
        from vantage6_tpu_torch.server.app import ServerApp

        srv = ServerApp()
        srv.ensure_root(password="rootpass123")
        http = srv.serve(port=0, background=True)
        try:
            c = srv.test_client()
            c.token = c.post(
                "/api/token/user",
                {"username": "root", "password": "rootpass123"},
            ).json["access_token"]
            org = c.post("/api/organization", {"name": "rot_o"}).json
            collab = c.post("/api/collaboration", {
                "name": "rot_c", "organization_ids": [org["id"]],
            }).json
            node = c.post("/api/node", {
                "organization_id": org["id"],
                "collaboration_id": collab["id"],
            }).json
            d = NodeDaemon(
                api_url=f"{http.url},{http.url}",
                api_key=node["api_key"],
                mode="inline", poll_interval=0.01, event_wait=0.0,
            )
            assert len(d.api_urls) == 2
            before = REGISTRY.snapshot().get("v6t_daemon_rotation_total", 0)
            real = d._rest.request

            def refused(*a, **k):
                raise ConnectionRefusedError("injected: whole plane gone")

            d._rest.request = refused
            t0 = time.monotonic()
            with pytest.raises(OSError):
                d.request("GET", "health")
            took = time.monotonic() - t0
            # two sweeps over both replicas, one failed-rotation streak
            # entry per sweep, one (tiny: base=poll_interval floor) sleep
            assert d._rotation_streak == 2
            assert (
                REGISTRY.snapshot()["v6t_daemon_rotation_total"]
                == before + 2
            )
            assert took < 2.0
            notes = [
                n for n in list(FLIGHT._notes)
                if n["kind"] == "replica_rotation_failed"
            ]
            assert len(notes) >= 2 and notes[-1]["replicas"] == 2
            # any success resets the streak
            d._rest.request = real
            assert d.request("GET", "health")["status"]
            assert d._rotation_streak == 0
            # single-URL daemons keep the historical fail-fast contract:
            # no rotation bookkeeping, no added sleeps
            d.api_urls = [d.api_url]
            d._rest.request = refused
            mid = REGISTRY.snapshot().get("v6t_daemon_rotation_total", 0)
            with pytest.raises(OSError):
                d.request("GET", "health")
            assert d._rotation_streak == 0
            assert (
                REGISTRY.snapshot().get("v6t_daemon_rotation_total", 0)
                == mid
            )
        finally:
            http.stop()
            srv.close()
