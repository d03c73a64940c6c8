"""WebSocket push bridge: auth, room scoping, replay, daemon integration.

The port's copy of ``tests/test_ws.py`` with its imports switched to
``vantage6_tpu_torch``.
"""
import json
import time

import pytest

# the push bridge is optional — without `websockets` the REST event cursor
# remains the full-fidelity path, so these tests skip rather than fail
pytest.importorskip("websockets")
from websockets.sync.client import connect  # noqa: E402

from vantage6_tpu_torch.server.app import ServerApp


@pytest.fixture()
def world():
    srv = ServerApp()
    srv.ensure_root(password="rootpass123")
    http = srv.serve(port=0, background=True)
    bridge = srv.serve_ws()
    from vantage6_tpu_torch.client import UserClient

    client = UserClient(http.url)
    client.authenticate("root", "rootpass123")
    org = client.organization.create(name="org")
    collab = client.collaboration.create(
        name="c", organization_ids=[org["id"]]
    )
    node_info = client.node.create(
        organization_id=org["id"], collaboration_id=collab["id"]
    )
    yield {
        "srv": srv,
        "http": http,
        "bridge": bridge,
        "client": client,
        "org": org,
        "collab": collab,
        "node_info": node_info,
    }
    bridge.stop()
    http.stop()
    srv.close()


def node_token(world):
    import requests

    r = requests.post(
        f"{world['http'].url}/api/token/node",
        json={"api_key": world["node_info"]["api_key"]},
    )
    return r.json()["access_token"]


def make_task(world):
    return world["client"].task.create(
        collaboration=world["collab"]["id"],
        organizations=[world["org"]["id"]],
        image="img",
        input_={"method": "m"},
    )


class TestBridge:
    def test_health_advertises_ws(self, world):
        health = world["client"].util.health()
        assert health["websocket_url"] == world["bridge"].url

    def test_bad_token_rejected(self, world):
        with connect(world["bridge"].url) as ws:
            ws.send(json.dumps({"token": "garbage"}))
            msg = json.loads(ws.recv(timeout=5))
            assert "error" in msg

    def test_push_and_replay(self, world):
        tok = node_token(world)
        # a task created BEFORE connect is replayed via `since`
        make_task(world)
        with connect(world["bridge"].url) as ws:
            ws.send(json.dumps({"token": tok, "since": 0}))
            hello = json.loads(ws.recv(timeout=5))
            assert hello["connected"] and hello["cursor"] >= 1
            replayed = json.loads(ws.recv(timeout=5))["event"]
            assert replayed["name"] == "task-created"
            # and a live event is pushed
            make_task(world)
            deadline = time.time() + 10
            names = []
            while time.time() < deadline:
                try:
                    msg = json.loads(ws.recv(timeout=1))
                except TimeoutError:
                    continue
                if "event" in msg:
                    names.append(msg["event"]["name"])
                    break
            assert "task-created" in names

    def test_ping_pong(self, world):
        tok = node_token(world)
        with connect(world["bridge"].url) as ws:
            ws.send(json.dumps({"token": tok, "since": 10**9}))
            json.loads(ws.recv(timeout=5))  # hello
            ws.send(json.dumps({"ping": 42}))
            deadline = time.time() + 10
            while time.time() < deadline:
                msg = json.loads(ws.recv(timeout=2))
                if msg.get("pong") == 42:
                    return
            raise AssertionError("no pong")

    def test_room_scoping_on_socket(self, world):
        """A node of another collaboration receives nothing."""
        c = world["client"]
        lone = c.organization.create(name="lone")
        c2 = c.collaboration.create(name="c2", organization_ids=[lone["id"]])
        n2 = c.node.create(organization_id=lone["id"], collaboration_id=c2["id"])
        import requests

        tok2 = requests.post(
            f"{world['http'].url}/api/token/node",
            json={"api_key": n2["api_key"]},
        ).json()["access_token"]
        with connect(world["bridge"].url) as ws:
            ws.send(json.dumps({"token": tok2, "since": 0}))
            json.loads(ws.recv(timeout=5))  # hello
            make_task(world)  # activity in the OTHER collaboration
            with pytest.raises(TimeoutError):
                ws.recv(timeout=1.5)


class TestUI:
    def test_ui_served_with_markers(self, world):
        page = world["srv"].test_client().get("/")
        assert page.status == 200
        assert page.headers["Content-Type"].startswith("text/html")
        html = page.body.decode()
        for marker in ("vantage6-tpu", 'id="signin"', 'id="tasks"', "showTask"):
            assert marker in html
        # /ui alias serves the same page
        assert world["srv"].test_client().get("/ui").body == page.body

    def test_ui_task_wire_shape(self, world):
        """The exact POST the UI's JS sends (base64 input per org) works."""
        import base64

        c = world["client"]
        blob = base64.b64encode(json.dumps({"method": "m"}).encode()).decode()
        r = c.request(
            "POST",
            "task",
            {
                "name": "ui task",
                "image": "img",
                "method": "m",
                "collaboration_id": world["collab"]["id"],
                "organizations": [{"id": world["org"]["id"], "input": blob}],
            },
        )
        assert r["id"] and r["status"] == "pending"


def test_daemon_uses_push(world_factory=None):
    """End-to-end: daemon connects to the bridge and executes a pushed task."""
    import numpy as np
    import pandas as pd
    import tempfile
    from pathlib import Path

    from vantage6_tpu_torch.client import UserClient
    from vantage6_tpu_torch.node.daemon import NodeDaemon

    srv = ServerApp()
    srv.ensure_root(password="rootpass123")
    http = srv.serve(port=0, background=True)
    bridge = srv.serve_ws()
    try:
        client = UserClient(http.url)
        client.authenticate("root", "rootpass123")
        org = client.organization.create(name="org")
        collab = client.collaboration.create(
            name="c", organization_ids=[org["id"]]
        )
        info = client.node.create(
            organization_id=org["id"], collaboration_id=collab["id"]
        )
        tmp = Path(tempfile.mkdtemp())
        pd.DataFrame({"x": np.arange(10.0)}).to_csv(tmp / "d.csv", index=False)
        daemon = NodeDaemon(
            http.url,
            info["api_key"],
            algorithms={"avg": "vantage6_tpu_torch.workloads.average"},
            databases=[{"label": "default", "type": "csv", "uri": str(tmp / "d.csv")}],
            mode="inline",
            poll_interval=0.1,
        )
        daemon.start()
        try:
            task = client.task.create(
                collaboration=collab["id"],
                organizations=[org["id"]],
                image="avg",
                input_={"method": "partial_average", "kwargs": {"column": "x"}},
            )
            out = client.wait_for_results(task["id"], interval=0.1, timeout=30)
            assert out[0]["sum"] == 45.0
        finally:
            daemon.stop()
    finally:
        bridge.stop()
        http.stop()
        srv.close()
