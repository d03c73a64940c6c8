"""``POST /api/debug/profile`` on the port's server: users only (401
anonymous, 403 for a node), the torch.profiler window registered in the
flight recorder, a bad body refused.

The port's copy of ``tests/test_profiling.py``'s ``TestProfileEndpoint``,
which waited for the server.
"""
import json

import pytest

from vantage6_tpu_torch.common.flight import FLIGHT
from vantage6_tpu_torch.runtime.tracing import TRACER


@pytest.fixture(autouse=True)
def observatory():
    """Tracing armed and the flight recorder empty, per test."""
    TRACER.configure(enabled=True, sample=1.0, sink=None)
    TRACER.clear()
    FLIGHT.clear()
    yield


class TestProfileEndpoint:
    @pytest.fixture()
    def srv(self):
        from vantage6_tpu_torch.server.app import ServerApp

        app = ServerApp()
        yield app
        app.close()

    def _root_client(self, srv):
        c = srv.test_client()
        srv.ensure_root(password="rootpass123")
        r = c.post(
            "/api/token/user",
            {"username": "root", "password": "rootpass123"},
        )
        c.token = r.json["access_token"]
        return c

    def test_requires_auth(self, srv):
        c = srv.test_client()
        assert c.post("/api/debug/profile", {"seconds": 0.05}).status == 401

    def test_node_token_refused(self, srv):
        c = self._root_client(srv)
        org = c.post("/api/organization", {"name": "o"}).json
        collab = c.post(
            "/api/collaboration",
            {"name": "c", "organization_ids": [org["id"]]},
        ).json
        node = c.post(
            "/api/node",
            {"organization_id": org["id"],
             "collaboration_id": collab["id"]},
        ).json
        nc = srv.test_client()
        r = nc.post("/api/token/node", {"api_key": node["api_key"]})
        nc.token = r.json["access_token"]
        assert nc.post(
            "/api/debug/profile", {"seconds": 0.05}
        ).status == 403

    def test_user_window_registered_in_flight(self, srv, tmp_path,
                                              monkeypatch):
        monkeypatch.setenv("V6T_PROFILE_DIR", str(tmp_path))
        c = self._root_client(srv)
        r = c.post("/api/debug/profile", {"seconds": 0.05})
        assert r.status == 201, r
        assert r.json["path"].startswith(str(tmp_path))
        assert r.json["seconds"] == 0.05
        dump = FLIGHT.dump(path=str(tmp_path / "bundle.jsonl"))
        recs = [json.loads(line) for line in open(dump)]
        assert any(
            rec.get("kind") == "profile_window"
            and rec.get("path") == r.json["path"]
            for rec in recs
        )

    def test_bad_seconds_rejected(self, srv):
        c = self._root_client(srv)
        assert c.post(
            "/api/debug/profile", {"seconds": "fast"}
        ).status == 400
