"""Bonawitz secure aggregation through the port's TASK PLANE: all four
protocol rounds (advertise → share → upload → reveal) run as real tasks
through the port's server + node daemons over localhost sockets —
including a GENUINE dropout: one station daemon is killed between the share
round and its upload, and the survivor-set sum completes exactly.

The port's copy of ``tests/test_bonawitz_taskplane.py``'s
``test_full_protocol_no_dropout`` and ``test_dropout_recovered``, which
waited for the server and the daemon.
"""
import secrets as pysecrets
import time

import numpy as np
import pandas as pd
import pytest

pytest.importorskip("cryptography")  # protocol rounds derive X25519 keys

from vantage6_tpu_torch.client import UserClient
from vantage6_tpu_torch.node.daemon import NodeDaemon
from vantage6_tpu_torch.server.app import ServerApp

IMAGE = "v6-secure-average"
MODULE = "vantage6_tpu_torch.workloads.secure_average"
N = 3


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """server + 3-org collaboration + 3 inline nodes with station secrets.

    Node 2 gets a SLOW poll interval: the dropout test needs a safe window
    to kill it after its share task completes but before it discovers its
    upload task.
    """
    tmp = tmp_path_factory.mktemp("bonawitz")
    rng = np.random.default_rng(29)
    frames = []
    for i in range(N):
        df = pd.DataFrame({"age": rng.normal(40 + 6 * i, 7, 60 + 10 * i)})
        df.to_csv(tmp / f"s{i}.csv", index=False)
        frames.append(df)

    srv = ServerApp()
    srv.ensure_root(password="rootpass123")
    http = srv.serve(port=0, background=True)
    client = UserClient(http.url)
    client.authenticate("root", "rootpass123")
    orgs = [client.organization.create(name=f"bzorg{i}") for i in range(N)]
    collab = client.collaboration.create(
        name="bz", organization_ids=[o["id"] for o in orgs]
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
                {"label": "default", "type": "csv", "uri": str(tmp / f"s{i}.csv")}
            ],
            mode="inline",
            poll_interval=1.0 if i == N - 1 else 0.05,
            # the LAST station must genuinely be slow to see its tasks
            # (the dropout test kills it inside that window) — pin it to
            # legacy fixed-interval polling; long-poll wakeups would make
            # it react in milliseconds and void the test's premise
            event_wait=0.0 if i == N - 1 else 2.0,
            station_secret=pysecrets.token_hex(32),
        )
        d.start()
        daemons.append(d)
    yield {
        "client": client, "orgs": orgs, "collab": collab,
        "daemons": daemons, "frames": frames, "http": http, "srv": srv,
        "tmp": tmp,
    }
    for d in daemons:
        d.stop()
    http.stop()
    srv.close()


def _central_task(c, stack, **extra_kwargs):
    kwargs = {
        "column": "age",
        "max_abs": 2.0**16,
        "poll_interval": 0.1,
        **extra_kwargs,
    }
    return c.task.create(
        collaboration=stack["collab"]["id"],
        organizations=[stack["orgs"][0]["id"]],
        image=IMAGE,
        input_={"method": "central_secure_average_bonawitz", "kwargs": kwargs},
        name="bz_central",
    )


def _tasks_by_prefix(c, prefix):
    return [t for t in c.paginate("task") if t["name"].startswith(prefix)]


def test_full_protocol_no_dropout(stack):
    """Happy path: four rounds through server+nodes, exact pooled mean,
    masked uploads on the wire, reveal round always runs."""
    c = stack["client"]
    task = _central_task(c, stack, upload_timeout=60.0)
    out = c.wait_for_results(task["id"], timeout=180)[0]
    pooled = pd.concat(stack["frames"])["age"]
    assert out["count"] == len(pooled)
    assert abs(out["average"] - pooled.mean()) < 1e-2
    assert out["dropped"] == []
    # all four round types actually crossed the control plane
    for prefix, expect in (
        ("bz_advertise", N), ("bz_share", N), ("bz_upload", N),
        ("bz_reveal", N),
    ):
        assert len(_tasks_by_prefix(c, prefix)) >= expect, prefix


def test_dropout_recovered(stack):
    """Kill station 2 after its share round completes but before it
    uploads: the survivor-set aggregate completes and matches the pooled
    mean over stations 0 and 1 only."""
    c = stack["client"]
    before_shares = len(_tasks_by_prefix(c, "bz_share"))
    task = _central_task(c, stack, upload_timeout=8.0)

    # wait until all N NEW share tasks completed (round 2 done)...
    deadline = time.time() + 60
    while time.time() < deadline:
        shares = _tasks_by_prefix(c, "bz_share")
        new = shares[before_shares:]
        if len(new) >= N and all(t["status"] == "completed" for t in new):
            break
        time.sleep(0.02)
    else:
        pytest.fail("share round never completed")
    # ...then kill the slow-polling station BEFORE it can see its upload
    # task (its poll interval is 1.0s; we react within ~20ms)
    stack["daemons"][N - 1].stop()

    try:
        out = c.wait_for_results(task["id"], timeout=240)[0]
    finally:
        pass
    survivors_pooled = pd.concat(stack["frames"][: N - 1])["age"]
    assert out["dropped"] == [stack["orgs"][N - 1]["id"]]
    assert out["count"] == len(survivors_pooled)
    assert abs(out["average"] - survivors_pooled.mean()) < 1e-2
    # reveal round ran among the survivors only
    reveals = _tasks_by_prefix(c, "bz_reveal")
    assert all(t["status"] == "completed" for t in reveals)
