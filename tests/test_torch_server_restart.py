"""Control-plane restart resilience (own module: ServerApp binds the
class-level Model.db, so this test must not run while another module's
server fixture is live).

The port's copy of ``tests/test_server_restart.py`` with its imports switched to
``vantage6_tpu_torch``.
"""
import time

from vantage6_tpu_torch.client import UserClient
from vantage6_tpu_torch.node.daemon import NodeDaemon


def test_server_restart_daemon_survives(tmp_path):
    """Control-plane bounce resilience: the server process restarts on the
    SAME sqlite file with a FRESH JWT secret and an EMPTY event hub; a
    running daemon re-authenticates with its api_key, detects the cursor
    regression, resyncs, and completes a task submitted after the restart
    — no daemon restart needed. (Reference: nodes ride out server redeploys
    via SocketIO reconnect + sync_task_queue_with_server.)"""
    import numpy as np
    import pandas as pd

    from vantage6_tpu_torch.server.app import ServerApp

    db = f"sqlite:///{tmp_path}/ctrl.db"
    csv = tmp_path / "a.csv"
    pd.DataFrame({"age": np.arange(50.0)}).to_csv(csv, index=False)

    srv = ServerApp(uri=db)
    srv.ensure_root(password="rootpass123")
    http = srv.serve(port=0, background=True)
    port = http.port
    client = UserClient(http.url)
    client.authenticate("root", "rootpass123")
    org = client.organization.create(name="restart_org")
    collab = client.collaboration.create(
        name="restart_collab", organization_ids=[org["id"]]
    )
    node_info = client.node.create(
        organization_id=org["id"], collaboration_id=collab["id"]
    )
    daemon = NodeDaemon(
        api_url=http.url,
        api_key=node_info["api_key"],
        algorithms={"v6-average-py": "vantage6_tpu_torch.workloads.average"},
        databases=[{"label": "default", "type": "csv", "uri": str(csv)}],
        mode="inline",
        poll_interval=0.1,
        sync_interval=1.0,
    )
    daemon.start()
    try:
        # sanity: a task completes pre-restart (also advances the cursor)
        t1 = client.task.create(
            collaboration=collab["id"],
            organizations=[org["id"]],
            image="v6-average-py",
            input_={"method": "partial_average", "kwargs": {"column": "age"}},
        )
        assert client.wait_for_results(t1["id"], timeout=30)[0]["count"] == 50

        # ---- bounce the server: same DB file, same port, new process
        # state (fresh random JWT secret, empty in-memory event hub)
        http.stop()
        srv.close()
        srv2 = ServerApp(uri=db)
        http2 = srv2.serve(port=port, background=True)
        try:
            client2 = UserClient(http2.url)
            client2.authenticate("root", "rootpass123")
            t2 = client2.task.create(
                collaboration=collab["id"],
                organizations=[org["id"]],
                image="v6-average-py",
                input_={"method": "partial_average",
                        "kwargs": {"column": "age"}},
            )
            out = client2.wait_for_results(t2["id"], timeout=30)[0]
            assert out["count"] == 50
            # the daemon healed its cursor: live events flow again, so a
            # third task completes FAST (event path, not just the sweep)
            t3 = client2.task.create(
                collaboration=collab["id"],
                organizations=[org["id"]],
                image="v6-average-py",
                input_={"method": "partial_average",
                        "kwargs": {"column": "age"}},
            )
            assert client2.wait_for_results(
                t3["id"], timeout=30
            )[0]["count"] == 50
        finally:
            http2.stop()
            srv2.close()
    finally:
        daemon.stop()


def test_cursor_regression_rebuilds_killed_set(tmp_path):
    """A kill issued while the daemon's event stream was dead must land in
    the daemon's killed set via the post-regression heal, not be lost."""
    import numpy as np
    import pandas as pd

    from vantage6_tpu_torch.server.app import ServerApp

    db = f"sqlite:///{tmp_path}/k.db"
    csv = tmp_path / "k.csv"
    pd.DataFrame({"age": np.arange(10.0)}).to_csv(csv, index=False)
    srv = ServerApp(uri=db)
    srv.ensure_root(password="rootpass123")
    http = srv.serve(port=0, background=True)
    client = UserClient(http.url)
    client.authenticate("root", "rootpass123")
    org = client.organization.create(name="k_org")
    collab = client.collaboration.create(
        name="k_collab", organization_ids=[org["id"]]
    )
    ni = client.node.create(
        organization_id=org["id"], collaboration_id=collab["id"]
    )
    daemon = NodeDaemon(
        api_url=http.url,
        api_key=ni["api_key"],
        algorithms={"v6-average-py": "vantage6_tpu_torch.workloads.average"},
        databases=[{"label": "default", "type": "csv", "uri": str(csv)}],
        mode="inline",
        poll_interval=0.1,
        sync_interval=60.0,  # sweep out of the way: the REGRESSION must heal
    )
    daemon.start()
    try:
        t = client.task.create(
            collaboration=collab["id"],
            organizations=[org["id"]],
            image="v6-average-py",
            input_={"method": "partial_average", "kwargs": {"column": "age"}},
        )
        client.wait_for_results(t["id"], timeout=30)
        run = client.run.from_task(t["id"])[0]
        # mark the run killed server-side as if the kill happened while the
        # daemon's event stream was down, and force a cursor regression
        from vantage6_tpu_torch.server import models as m

        row = m.TaskRun.get(run["id"])
        row.status = "killed by user"
        row.save()
        assert run["id"] not in daemon._killed
        deadline = time.time() + 10
        while time.time() < deadline and run["id"] not in daemon._killed:
            # re-assert each iteration: the poll thread's unsynchronized
            # max() read-modify-write can clobber a single write in a
            # microsecond window — rare flake, closed by repetition
            daemon._cursor = 10**9  # watermark far ahead of the hub
            time.sleep(0.2)
        assert run["id"] in daemon._killed, "kill never re-learned"
    finally:
        daemon.stop()
        http.stop()
        srv.close()
