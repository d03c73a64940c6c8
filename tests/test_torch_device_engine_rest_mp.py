"""Multi-process device engine through REST: TWO daemon OS processes join
one gloo process group on the CPU (``device_engine={"device": "cpu",
...}``), each loads ONLY its own station's CSV, and
``UserClient.task.create(engine="device")`` returns a federated result
computed by ONE collective program spanning both daemons.

The port's copy of ``tests/test_device_engine_mp.py``. The ranks meet at a
``file://`` rendezvous in the test's ``tmp_path`` (never a probed free port:
several test workers run at once), and the children run with ``jax``
blocked. Separate file from ``test_torch_device_engine_rest.py``: the server
binds the process-wide ``Model.db``, so the single-process module-scoped
stack must not coexist.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pandas as pd
import pytest

from vantage6_tpu_torch.client import UserClient
from vantage6_tpu_torch.server.app import ServerApp

IMAGE = "device-engine"

# ------------------------------------------------------------- multi-process
_CHILD = textwrap.dedent(
    """
    import sys, time
    sys.modules["jax"] = None  # the port runs without JAX

    api_url, api_key, csv, pid, n, init = (
        sys.argv[1], sys.argv[2], sys.argv[3],
        int(sys.argv[4]), int(sys.argv[5]), sys.argv[6],
    )
    from vantage6_tpu_torch.node.daemon import NodeDaemon

    d = NodeDaemon(
        api_url=api_url,
        api_key=api_key,
        algorithms={"device-engine":
                    "vantage6_tpu_torch.workloads.device_engine"},
        databases=[{"label": "default", "type": "csv", "uri": csv}],
        mode="sandbox",
        poll_interval=0.05,
        device_engine={
            "coordinator": init,
            "num_processes": n,
            "process_id": pid,
            "device": "cpu",
        },
    )
    d.start()
    print("READY", flush=True)
    while True:
        time.sleep(0.2)
    """
)


@pytest.fixture()
def cluster(tmp_path):
    """Server in THIS process; two device-engine daemons as OS processes,
    each a gloo rank on the CPU with its own CSV."""
    rng = np.random.default_rng(42)
    frames = []
    for i in range(2):
        # station i: disjoint value ranges so the pooled mean discriminates,
        # plus a separable 2-feature labeled set for the training task
        age = rng.uniform(20 + 30 * i, 50 + 30 * i, 40 + 10 * i).round(1)
        x0 = rng.normal(0, 1, age.size)
        label = (x0 + 0.1 * rng.normal(0, 1, age.size) > 0).astype(float)
        df = pd.DataFrame({"age": age, "x0": x0, "x1": rng.normal(0, 1, age.size),
                           "label": label})
        df.to_csv(tmp_path / f"station{i}.csv", index=False)
        frames.append(df)

    srv = ServerApp()
    srv.ensure_root(password="rootpass123")
    http = srv.serve(port=0, background=True)
    client = UserClient(http.url)
    client.authenticate("root", "rootpass123")
    orgs = [client.organization.create(name=f"mporg{i}") for i in range(2)]
    collab = client.collaboration.create(
        name="mp-device", organization_ids=[o["id"] for o in orgs]
    )
    keys = [
        client.node.create(
            organization_id=o["id"], collaboration_id=collab["id"]
        )["api_key"]
        for o in orgs
    ]

    init = f"file://{tmp_path / 'rendezvous'}"
    script = tmp_path / "daemon_child.py"
    script.write_text(_CHILD)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {
        **os.environ,
        "PYTHONPATH": os.pathsep.join(
            p for p in (repo_root, os.environ.get("PYTHONPATH")) if p
        ),
        "OMP_NUM_THREADS": "1",
    }
    for var in ("V6T_COORDINATOR", "V6T_NUM_PROCESSES", "V6T_PROCESS_ID"):
        env.pop(var, None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), http.url, keys[i],
             str(tmp_path / f"station{i}.csv"), str(i), "2", init],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        )
        for i in range(2)
    ]
    try:
        # both daemons online at the server = mesh joined + listening
        deadline = time.time() + 120
        while time.time() < deadline:
            nodes = client.node.list()
            if sum(1 for n_ in nodes if n_["status"] == "online") >= 2:
                break
            if any(p.poll() is not None for p in procs):
                errs = [p.communicate()[1][-2000:] for p in procs
                        if p.poll() is not None]
                raise RuntimeError(f"daemon child died: {errs}")
            time.sleep(0.2)
        else:
            raise RuntimeError("daemons never came online")
        yield {
            "client": client, "orgs": orgs, "collab": collab,
            "frames": frames,
        }
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        http.stop()
        srv.close()


def test_task_spans_two_daemon_processes(cluster):
    """UserClient.task.create → ONE collective program over both daemons'
    ranks → wait_for_results returns the identical replicated federated
    aggregate from every daemon."""
    c = cluster["client"]
    task = c.task.create(
        collaboration=cluster["collab"]["id"],
        organizations=[o["id"] for o in cluster["orgs"]],
        image=IMAGE, engine="device",
        input_={"method": "device_column_stats",
                "kwargs": {"column": "age", "pad_to": 128}},
    )
    results = c.wait_for_results(task["id"], timeout=240)
    assert len(results) == 2
    pooled = np.concatenate(
        [f["age"].to_numpy(np.float64) for f in cluster["frames"]]
    )
    for r in results:
        # computed over the GLOBAL mesh: both stations' rows, 2 processes
        assert r["n_stations"] == 2
        assert r["global_devices"] == 2
        np.testing.assert_allclose(r["mean"], pooled.mean(), rtol=1e-5)
        np.testing.assert_allclose(r["std"], pooled.std(), rtol=1e-4)
        assert r["count"] == pooled.size
    # each daemon reported from its own process slot, same aggregate
    assert {r["process_index"] for r in results} == {0, 1}
    assert results[0]["mean"] == results[1]["mean"]


def test_training_spans_two_daemon_processes(cluster):
    """Federated logistic regression trained as ONE collective program
    (rounds of fed_map local steps and a weighted all-reduce merge) across
    both daemon processes."""
    c = cluster["client"]
    task = c.task.create(
        collaboration=cluster["collab"]["id"],
        organizations=[o["id"] for o in cluster["orgs"]],
        image=IMAGE, engine="device",
        input_={
            "method": "device_logistic_fit",
            "kwargs": {
                "feature_columns": ["x0", "x1"],
                "label_column": "label",
                "rounds": 3, "local_steps": 4, "batch_rows": 64,
                "lr": 0.5,
            },
        },
    )
    results = c.wait_for_results(task["id"], timeout=240)
    assert len(results) == 2
    # the merged model is REPLICATED: both daemons hold it bit-for-bit
    assert results[0]["weights"] == results[1]["weights"]
    assert results[0]["bias"] == results[1]["bias"]
    # it learned the separable direction (x0 decides the label)
    w = results[0]["weights"]
    assert w[0] > 3 * abs(w[1])
    for r in results:
        assert r["local_accuracy"] >= 0.85
