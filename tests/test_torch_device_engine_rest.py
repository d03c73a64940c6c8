"""The port's control plane meets its device data plane: a task submitted
through UserClient → server → node daemons runs as ONE collective program
over the daemons' devices.

Single-process here (the port's copy of ``tests/test_device_engine.py``): a
daemon with ``device_engine={"device": "cpu"}`` serves engine="device" tasks
on its own device (inline forcing, device lock, result path), and an
unconfigured daemon refuses them (NOT_ALLOWED). Two daemon processes over
gloo are ``tests/test_torch_device_engine_rest_mp.py``.
"""
import time

import numpy as np
import pandas as pd
import pytest

from vantage6_tpu_torch.client import UserClient
from vantage6_tpu_torch.node.daemon import NodeDaemon
from vantage6_tpu_torch.server.app import ServerApp

IMAGE = "device-engine"
MODULE = "vantage6_tpu_torch.workloads.device_engine"


# ------------------------------------------------------------ single-process
@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("device_engine")
    rng = np.random.default_rng(7)
    df = pd.DataFrame({"age": rng.uniform(20, 80, 60).round(1)})
    df.to_csv(tmp / "s0.csv", index=False)

    srv = ServerApp()
    srv.ensure_root(password="rootpass123")
    http = srv.serve(port=0, background=True)
    client = UserClient(http.url)
    client.authenticate("root", "rootpass123")
    orgs = [client.organization.create(name=f"deorg{i}") for i in range(2)]
    collab = client.collaboration.create(
        name="device", organization_ids=[o["id"] for o in orgs]
    )
    daemons = []
    for i, org in enumerate(orgs):
        node_info = client.node.create(
            organization_id=org["id"], collaboration_id=collab["id"]
        )
        d = NodeDaemon(
            api_url=http.url,
            api_key=node_info["api_key"],
            algorithms={IMAGE: MODULE},
            databases=[
                {"label": "default", "type": "csv", "uri": str(tmp / "s0.csv")}
            ],
            mode="sandbox",  # device engine must OVERRIDE this to inline
            poll_interval=0.05,
            # node 0 is a device-engine member (local mesh); node 1 is NOT
            device_engine={"device": "cpu"} if i == 0 else None,
        )
        d.start()
        daemons.append(d)
    yield {
        "client": client, "orgs": orgs, "collab": collab,
        "daemons": daemons, "df": df,
    }
    for d in daemons:
        d.stop()
    http.stop()
    srv.close()


class TestSingleProcess:
    def test_device_task_requires_full_membership(self, stack):
        c = stack["client"]
        with pytest.raises(Exception, match="every organization"):
            c.task.create(
                collaboration=stack["collab"]["id"],
                organizations=[stack["orgs"][0]["id"]],
                image=IMAGE, engine="device",
                input_={"method": "device_column_stats",
                        "kwargs": {"column": "age", "pad_to": 128}},
            )

    def test_engine_validated(self, stack):
        c = stack["client"]
        with pytest.raises(Exception, match="engine"):
            c.task.create(
                collaboration=stack["collab"]["id"],
                organizations=[o["id"] for o in stack["orgs"]],
                image=IMAGE, engine="warp",
                input_={"method": "device_column_stats"},
            )

    def test_device_run_and_unconfigured_refusal(self, stack):
        c, df = stack["client"], stack["df"]
        task = c.task.create(
            collaboration=stack["collab"]["id"],
            organizations=[o["id"] for o in stack["orgs"]],
            image=IMAGE, engine="device",
            input_={"method": "device_column_stats",
                    "kwargs": {"column": "age", "pad_to": 128}},
        )
        assert task["engine"] == "device"
        # node 0 completes on its local mesh; node 1 (no device_engine
        # config) must refuse with NOT_ALLOWED — wait for both terminal
        deadline = time.time() + 60
        while time.time() < deadline:
            runs = c.paginate(f"task/{task['id']}/run")
            if all(r["status"] in ("completed", "not allowed")
                   for r in runs):
                break
            time.sleep(0.1)
        by_status = {r["status"] for r in runs}
        assert by_status == {"completed", "not allowed"}, runs
        done = next(r for r in runs if r["status"] == "completed")
        from vantage6_tpu_torch.common.serialization import deserialize
        import base64

        result = deserialize(base64.b64decode(done["result"]))
        np.testing.assert_allclose(result["mean"], df["age"].mean(),
                                   rtol=1e-5)
        assert result["n_stations"] == 1  # single-process local mesh
        refused = next(r for r in runs if r["status"] == "not allowed")
        assert "device-engine" in refused["log"]

    def test_device_engine_requires_module_marker(self, stack):
        """engine="device" must not become a sandbox bypass: modules
        without the DEVICE_ENGINE marker are refused inline execution."""
        from vantage6_tpu_torch.node.runner import PolicyViolation, RunSpec

        d = stack["daemons"][0]  # device-engine member
        d.runner.algorithms["plain-algo"] = "vantage6_tpu_torch.workloads.average"
        spec = RunSpec(
            run_id=999, task_id=999, image="plain-algo",
            method="partial_average", input_payload={}, engine="device",
        )
        with pytest.raises(PolicyViolation, match="DEVICE_ENGINE"):
            d.runner.run(spec)


class TestPeerBarrier:
    """_await_device_peers: the control-plane barrier that keeps a daemon
    from entering a collective program its peers will never join."""

    def _multi(self, monkeypatch):
        from vantage6_tpu_torch.core import distributed

        monkeypatch.setattr(distributed, "process_count", lambda: 2)

    def _patch_runs(self, monkeypatch, daemon, statuses):
        def fake_request(method, endpoint, json_body=None, params=None):
            assert endpoint.endswith("/run")
            return {"data": [
                {"id": i + 1, "status": s} for i, s in enumerate(statuses)
            ]}

        monkeypatch.setattr(daemon, "request", fake_request)

    def test_single_process_skips(self, stack):
        # no peers to wait for on a local mesh: returns immediately
        stack["daemons"][0]._await_device_peers({"id": 1}, run_id=1)

    def test_aborts_when_peer_failed(self, stack, monkeypatch):
        d = stack["daemons"][0]
        self._multi(monkeypatch)
        self._patch_runs(monkeypatch, d, ["active", "not allowed"])
        with pytest.raises(RuntimeError, match="never join"):
            d._await_device_peers({"id": 7}, run_id=1)

    def test_times_out_on_stuck_peer(self, stack, monkeypatch):
        d = stack["daemons"][0]
        self._multi(monkeypatch)
        self._patch_runs(monkeypatch, d, ["active", "pending"])
        monkeypatch.setattr(d, "device_engine_cfg", {"barrier_timeout": 0.3})
        with pytest.raises(RuntimeError, match="timed out"):
            d._await_device_peers({"id": 7}, run_id=1)

    def test_passes_when_all_peers_active(self, stack, monkeypatch):
        d = stack["daemons"][0]
        self._multi(monkeypatch)
        self._patch_runs(monkeypatch, d, ["active", "active", "completed"])
        d._await_device_peers({"id": 7}, run_id=1)

    def test_fails_closed_when_peers_invisible(self, stack, monkeypatch):
        # a server that scopes the run listing to this node's own org
        # would make the barrier vacuous — refuse to enter alone instead
        d = stack["daemons"][0]
        self._multi(monkeypatch)
        self._patch_runs(monkeypatch, d, ["active"])  # own run only
        with pytest.raises(RuntimeError, match="alone"):
            d._await_device_peers({"id": 7}, run_id=1)


