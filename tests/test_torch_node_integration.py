"""Full-stack integration: server + node daemons + UserClient over real HTTP.

Parity: SURVEY.md §4 — the reference's multi-node story is a demo network on
one machine; here the whole federation (control plane, N station daemons,
researcher client) runs in-process over localhost sockets, exercising call
stacks §3.1 (task → result), §3.2 (central fan-out), and the encryption
boundary.

The port's copy of ``tests/test_node_integration.py`` with its imports switched to
``vantage6_tpu_torch``. Its encrypted end-to-end case holds the stored inputs to
wire-v2 sealed frames (``ENC_MAGIC``), where the reference still looks
for the v1 cryptor's ``$`` separator.
"""
import base64
import time

import numpy as np
import pandas as pd
import pytest

from vantage6_tpu_torch.client import UserClient
from vantage6_tpu_torch.common.encryption import ENC_MAGIC
from vantage6_tpu_torch.node.daemon import NodeDaemon
from vantage6_tpu_torch.node.runner import RunSpec, TaskRunner
from vantage6_tpu_torch.server.app import ServerApp


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """server + 2-org encrypted-capable collaboration + 2 inline nodes."""
    tmp = tmp_path_factory.mktemp("stack")
    # write per-station data
    rng = np.random.default_rng(7)
    frames = []
    for i, name in enumerate(("hospital_a", "hospital_b")):
        df = pd.DataFrame({"age": rng.normal(50 + i * 4, 8, 120)})
        df.to_csv(tmp / f"{name}.csv", index=False)
        frames.append(df)

    srv = ServerApp()
    srv.ensure_root(password="rootpass123")
    http = srv.serve(port=0, background=True)

    client = UserClient(http.url)
    client.authenticate("root", "rootpass123")
    orgs = [
        client.organization.create(name=n) for n in ("hospital_a", "hospital_b")
    ]
    collab = client.collaboration.create(
        name="demo", organization_ids=[o["id"] for o in orgs]
    )
    daemons = []
    for i, org in enumerate(orgs):
        node_info = client.node.create(
            organization_id=org["id"], collaboration_id=collab["id"]
        )
        daemon = NodeDaemon(
            api_url=http.url,
            api_key=node_info["api_key"],
            algorithms={"v6-average-py": "vantage6_tpu_torch.workloads.average"},
            databases=[
                {
                    "label": "default",
                    "type": "csv",
                    "uri": str(tmp / f"{org['name']}.csv"),
                }
            ],
            mode="inline",
            poll_interval=0.05,
        )
        daemon.start()
        daemons.append(daemon)
    yield {
        "server": srv,
        "http": http,
        "client": client,
        "orgs": orgs,
        "collab": collab,
        "daemons": daemons,
        "frames": frames,
        "tmp": tmp,
    }
    for d in daemons:
        d.stop()
    http.stop()
    srv.close()


def test_partial_task_roundtrip(stack):
    """§3.1: researcher task → node executes → result comes back."""
    client, collab, orgs = stack["client"], stack["collab"], stack["orgs"]
    task = client.task.create(
        collaboration=collab["id"],
        organizations=[o["id"] for o in orgs],
        image="v6-average-py",
        input_={"method": "partial_average", "kwargs": {"column": "age"}},
    )
    results = client.wait_for_results(task["id"], interval=0.05, timeout=30)
    assert len(results) == 2
    pooled = pd.concat(stack["frames"])["age"]
    total = sum(r["sum"] for r in results)
    count = sum(r["count"] for r in results)
    assert count == len(pooled)
    assert abs(total / count - pooled.mean()) < 1e-9


def test_central_fanout_through_proxy(stack):
    """§3.2: central runs at node A, fans out subtasks via the proxy."""
    client, collab, orgs = stack["client"], stack["collab"], stack["orgs"]
    task = client.task.create(
        collaboration=collab["id"],
        organizations=[orgs[0]["id"]],
        image="v6-average-py",
        input_={"method": "central_average", "kwargs": {"column": "age"}},
    )
    results = client.wait_for_results(task["id"], interval=0.05, timeout=60)
    pooled = pd.concat(stack["frames"])["age"]
    assert abs(results[0]["average"] - pooled.mean()) < 1e-9
    # subtask bookkeeping: child task exists with parent set and same job
    tasks = client.task.list()
    child = next(t for t in tasks if t["parent"] and t["parent"]["id"] == task["id"])
    assert child["job_id"] == task["job_id"]


def test_node_status_lifecycle(stack):
    client = stack["client"]
    nodes = client.node.list()
    assert all(n["status"] == "online" for n in nodes)


def test_policy_violation_sets_not_allowed(stack):
    """A node whose allow-list excludes the image refuses the run."""
    client, collab, orgs, tmp = (
        stack["client"],
        stack["collab"],
        stack["orgs"],
        stack["tmp"],
    )
    lone = client.organization.create(name="strict_org")
    client.collaboration.update(
        collab["id"], organization_ids=[lone["id"]]
    )
    node_info = client.node.create(
        organization_id=lone["id"], collaboration_id=collab["id"]
    )
    daemon = NodeDaemon(
        api_url=stack["http"].url,
        api_key=node_info["api_key"],
        algorithms={"v6-average-py": "vantage6_tpu_torch.workloads.average"},
        databases=[
            {"label": "default", "type": "csv",
             "uri": str(tmp / "hospital_a.csv")}
        ],
        policies={"allowed_algorithms": ["approved-*"]},
        mode="inline",
        poll_interval=0.05,
    )
    daemon.start()
    try:
        task = client.task.create(
            collaboration=collab["id"],
            organizations=[lone["id"]],
            image="v6-average-py",
            input_={"method": "partial_average", "kwargs": {"column": "age"}},
        )
        with pytest.raises(Exception, match="not allowed"):
            client.wait_for_results(task["id"], interval=0.05, timeout=30)
    finally:
        daemon.stop()


def test_crash_propagates_log(stack):
    client, collab, orgs = stack["client"], stack["collab"], stack["orgs"]
    task = client.task.create(
        collaboration=collab["id"],
        organizations=[orgs[0]["id"]],
        image="v6-average-py",
        input_={"method": "partial_average", "kwargs": {"column": "no_such"}},
    )
    with pytest.raises(Exception) as e:
        client.wait_for_results(task["id"], interval=0.05, timeout=30)
    assert "crashed" in str(e.value)


def test_offline_node_syncs_missed_tasks(stack):
    """Reference: sync_task_queue_with_server after reconnect."""
    client, collab, tmp = stack["client"], stack["collab"], stack["tmp"]
    org = client.organization.create(name="latecomer")
    client.collaboration.update(collab["id"], organization_ids=[org["id"]])
    node_info = client.node.create(
        organization_id=org["id"], collaboration_id=collab["id"]
    )
    # task created while the node is NOT running
    task = client.task.create(
        collaboration=collab["id"],
        organizations=[org["id"]],
        image="v6-average-py",
        input_={"method": "partial_average", "kwargs": {"column": "age"}},
    )
    time.sleep(0.2)
    daemon = NodeDaemon(
        api_url=stack["http"].url,
        api_key=node_info["api_key"],
        algorithms={"v6-average-py": "vantage6_tpu_torch.workloads.average"},
        databases=[
            {"label": "default", "type": "csv",
             "uri": str(tmp / "hospital_b.csv")}
        ],
        mode="inline",
        poll_interval=0.05,
    )
    daemon.start()  # _sync_missed_runs picks it up
    try:
        results = client.wait_for_results(task["id"], interval=0.05, timeout=30)
        assert results[0]["count"] == 120
    finally:
        daemon.stop()


def test_encrypted_collaboration_e2e(stack):
    """E2E crypto: inputs sealed per org key, results sealed toward the
    researcher's org; the server stores only ciphertext."""
    pytest.importorskip("cryptography")
    client_plain, tmp = stack["client"], stack["tmp"]
    orgs = [
        client_plain.organization.create(name=n) for n in ("enc_a", "enc_b")
    ]
    collab = client_plain.collaboration.create(
        name="secret", encrypted=True,
        organization_ids=[o["id"] for o in orgs],
    )
    daemons = []
    for i, org in enumerate(orgs):
        node_info = client_plain.node.create(
            organization_id=org["id"], collaboration_id=collab["id"]
        )
        d = NodeDaemon(
            api_url=stack["http"].url,
            api_key=node_info["api_key"],
            algorithms={"v6-average-py": "vantage6_tpu_torch.workloads.average"},
            databases=[
                {"label": "default", "type": "csv",
                 "uri": str(tmp / f"hospital_{'ab'[i]}.csv")}
            ],
            private_key=tmp / f"enc_key_{i}.pem",
            mode="inline",
            poll_interval=0.05,
        )
        d.start()
        daemons.append(d)
    try:
        # researcher belongs to org enc_a: give them a user + key there
        researcher_role = next(
            r for r in client_plain.role.list() if r["name"] == "Researcher"
        )
        client_plain.user.create(
            username="carol",
            password="carolpass123",
            organization_id=orgs[0]["id"],
            roles=[researcher_role["id"]],
        )
        carol = UserClient(stack["http"].url)
        carol.authenticate("carol", "carolpass123")
        # reuse node A's org key (researcher shares the org keypair — the
        # reference's model: encryption is per-organization)
        carol.setup_encryption(tmp / "enc_key_0.pem")
        task = carol.task.create(
            collaboration=collab["id"],
            organizations=[o["id"] for o in orgs],
            image="v6-average-py",
            input_={"method": "partial_average", "kwargs": {"column": "age"}},
        )
        # ciphertext at rest: each stored input is a wire-v2 sealed frame
        # (base64 of a blob that starts with ENC_MAGIC), never plaintext
        raw_runs = stack["client"].run.from_task(task["id"])
        assert len(raw_runs) == len(orgs)
        for r in raw_runs:
            blob = base64.b64decode(r["input"], validate=True)
            assert blob.startswith(ENC_MAGIC), blob[:8]
            assert b"partial_average" not in blob
        results = carol.wait_for_results(task["id"], interval=0.05, timeout=60)
        total = sum(r["sum"] for r in results)
        count = sum(r["count"] for r in results)
        pooled = pd.concat(stack["frames"])["age"]
        assert count == len(pooled)
        assert abs(total / count - pooled.mean()) < 1e-9
    finally:
        for d in daemons:
            d.stop()


class TestRunnerSandbox:
    """The subprocess container-ABI path (reference: docker run)."""

    def test_sandbox_executes_wrap_abi(self, tmp_path):
        df = pd.DataFrame({"x": [1.0, 2.0, 3.0]})
        csv = tmp_path / "d.csv"
        df.to_csv(csv, index=False)
        runner = TaskRunner(
            algorithms={"avg": "vantage6_tpu_torch.workloads.average"},
            databases=[{"label": "default", "type": "csv", "uri": str(csv)}],
            mode="sandbox",
            work_dir=tmp_path,
        )
        out = runner.run(
            RunSpec(
                run_id=1,
                task_id=1,
                image="avg",
                method="partial_average",
                input_payload={
                    "method": "partial_average",
                    "kwargs": {"column": "x"},
                },
            )
        )
        assert out == {"sum": 6.0, "count": 3}
        # the log file was harvested (reference: docker logs)
        assert (tmp_path / "run_1" / "log").exists()

    def test_sandbox_crash_collects_log(self, tmp_path):
        runner = TaskRunner(
            algorithms={"avg": "vantage6_tpu_torch.workloads.average"},
            databases=[{"label": "default", "type": "csv", "uri": "/nope.csv"}],
            mode="sandbox",
            work_dir=tmp_path,
        )
        with pytest.raises(RuntimeError, match="exited"):
            runner.run(
                RunSpec(
                    run_id=2,
                    task_id=1,
                    image="avg",
                    method="partial_average",
                    input_payload={"method": "partial_average",
                                   "kwargs": {"column": "x"}},
                )
            )


def test_result_delivery_failure_marks_run_failed(stack, tmp_path):
    """Regression (ADVICE r1): if encrypting/uploading the result fails
    (here: the initiating org's public key is garbage), the run must be
    patched FAILED with a log — not stuck ACTIVE with the result lost."""
    pytest.importorskip("cryptography")
    client_plain, tmp = stack["client"], stack["tmp"]
    orgs = [
        client_plain.organization.create(name=n) for n in ("del_a", "del_b")
    ]
    collab = client_plain.collaboration.create(
        name="delivery", encrypted=True,
        organization_ids=[o["id"] for o in orgs],
    )
    node_info = client_plain.node.create(
        organization_id=orgs[1]["id"], collaboration_id=collab["id"]
    )
    daemon = NodeDaemon(
        api_url=stack["http"].url,
        api_key=node_info["api_key"],
        algorithms={"v6-average-py": "vantage6_tpu_torch.workloads.average"},
        databases=[
            {"label": "default", "type": "csv",
             "uri": str(tmp / "hospital_b.csv")}
        ],
        private_key=tmp_path / "del_b.pem",
        mode="inline",
        poll_interval=0.05,
    )
    daemon.start()
    try:
        researcher_role = next(
            r for r in client_plain.role.list() if r["name"] == "Researcher"
        )
        client_plain.user.create(
            username="dave",
            password="davepass1234",
            organization_id=orgs[0]["id"],
            roles=[researcher_role["id"]],
        )
        # provision dave's org keypair as root (a Researcher may not PATCH
        # the org), then let setup_encryption find it already registered
        from vantage6_tpu_torch.common.encryption import RSACryptor

        cryptor = RSACryptor(tmp_path / "del_a.pem")
        client_plain.organization.update(
            orgs[0]["id"], public_key=cryptor.public_key_str
        )
        dave = UserClient(stack["http"].url)
        dave.authenticate("dave", "davepass1234")
        dave.setup_encryption(tmp_path / "del_a.pem")
        # corrupt the INITIATING org's public key AFTER client setup: the
        # node's result encryption toward it must now fail
        client_plain.organization.update(
            orgs[0]["id"], public_key="not-a-valid-key"
        )
        task = dave.task.create(
            collaboration=collab["id"],
            organizations=[orgs[1]["id"]],
            image="v6-average-py",
            input_={"method": "partial_average", "kwargs": {"column": "age"}},
        )
        deadline = time.time() + 30
        run = None
        while time.time() < deadline:
            run = client_plain.run.from_task(task["id"])[0]
            if run["status"] not in ("pending", "active"):
                break
            time.sleep(0.05)
        assert run is not None and run["status"] == "failed", run
        assert "result delivery failed" in (run["log"] or "")
    finally:
        daemon.stop()


def test_vpn_port_registration_roundtrip(stack, monkeypatch):
    """Gates wiring (VERDICT r1 #5): a vpn-enabled node registers the
    algorithm's declared EXPOSED_PORTS as server Port entities before the
    run executes, so peers can discover them mid-round."""
    from vantage6_tpu_torch.workloads import average as avg_mod

    monkeypatch.setattr(avg_mod, "EXPOSED_PORTS", [7071], raising=False)
    client, collab, tmp = stack["client"], stack["collab"], stack["tmp"]
    org = client.organization.create(name="vpn_org")
    client.collaboration.update(collab["id"], organization_ids=[org["id"]])
    node_info = client.node.create(
        organization_id=org["id"], collaboration_id=collab["id"]
    )
    daemon = NodeDaemon(
        api_url=stack["http"].url,
        api_key=node_info["api_key"],
        algorithms={"v6-average-py": "vantage6_tpu_torch.workloads.average"},
        databases=[
            {"label": "default", "type": "csv",
             "uri": str(tmp / "hospital_a.csv")}
        ],
        mode="inline",
        poll_interval=0.05,
        vpn={"enabled": True},
    )
    daemon.start()
    try:
        task = client.task.create(
            collaboration=collab["id"],
            organizations=[org["id"]],
            image="v6-average-py",
            input_={"method": "partial_average", "kwargs": {"column": "age"}},
        )
        client.wait_for_results(task["id"], interval=0.05, timeout=30)
        run = client.run.from_task(task["id"])[0]
        ports = client.request("GET", "port", params={"run_id": run["id"]})[
            "data"
        ]
        assert [p["port"] for p in ports] == [7071]
        assert ports[0]["label"] == "vpn"
    finally:
        daemon.stop()


def test_anti_entropy_sweep_recovers_lost_terminal_report(stack, tmp_path):
    """A run stuck ACTIVE at the server (its terminal report was lost) is
    reclaimed by the daemon's periodic sweep WITHOUT a restart — and a run
    currently executing is never touched (claim-set guard)."""
    import numpy as np
    import pandas as pd

    client = stack["client"]
    org = client.organization.create(name="sweep_org")
    collab = client.collaboration.create(
        name="sweep_collab", organization_ids=[org["id"]]
    )
    csv = tmp_path / "sweep.csv"
    pd.DataFrame({"age": np.arange(30.0)}).to_csv(csv, index=False)
    node_info = client.node.create(
        organization_id=org["id"], collaboration_id=collab["id"]
    )
    daemon = NodeDaemon(
        api_url=stack["http"].url,
        api_key=node_info["api_key"],
        algorithms={"v6-average-py": "vantage6_tpu_torch.workloads.average"},
        databases=[{"label": "default", "type": "csv", "uri": str(csv)}],
        mode="inline",
        poll_interval=0.05,
        sync_interval=0.5,
    )
    daemon.start()
    try:
        task = client.task.create(
            collaboration=collab["id"],
            organizations=[org["id"]],
            image="v6-average-py",
            input_={"method": "partial_average", "kwargs": {"column": "age"}},
        )
        client.wait_for_results(task["id"], interval=0.05, timeout=30)
        run = client.run.from_task(task["id"])[0]
        # simulate a lost terminal report: force the COMPLETED run back to
        # ACTIVE server-side, as if the daemon's final PATCH never arrived
        from vantage6_tpu_torch.server import models as m

        row = m.TaskRun.get(run["id"])
        row.status = "active"
        row.result = None
        row.finished_at = None
        row.save()
        # the daemon must NOT still hold the claim (successful runs keep
        # their claim for the daemon's life) — drop it to model "previous
        # attempt is truly gone", which is what a lost report means
        daemon._unclaim(run["id"])
        deadline = time.time() + 15
        while time.time() < deadline:
            got = client.run.from_task(task["id"])[0]
            if got["status"] == "completed" and got["result"]:
                break
            time.sleep(0.2)
        else:
            raise AssertionError(
                f"sweep never recovered the orphaned run: {got['status']}"
            )
        # the re-executed result is the same answer
        results = client.wait_for_results(task["id"], timeout=10)
        assert results[0]["count"] == 30
    finally:
        daemon.stop()
