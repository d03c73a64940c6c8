"""Two stateless control-plane replicas over ONE shared WAL store.

docs/control_plane.md "running N replicas": every test boots two
`ServerApp` instances against the same ``sqlite+wal`` file — the
in-process twin of two replica processes (`models.init` refcounts the
shared binding; the semantics under test — CAS mutations, the pubsub
event stream, the cache-invalidation bus, the (task, round) learning
store — are the same SQL either way, and `bench.py --worker cpscale`
exercises the real multi-process topology).

What must hold with N replicas:

- one activation winner per run, no matter which replica each PATCH
  lands on (the double-dispatch hole);
- the orphan-reset sweep on replica A cannot clobber a run another
  replica just completed (CAS status guard);
- a long-poller on replica A wakes for replica B's emit (shared
  pubsub_event stream);
- replica B's caches drop entries replica A's mutations invalidated
  (CACHE_INVALIDATE on the bus);
- a FedAvg round trajectory whose per-round work lands on different
  replicas reads back as ONE history from /api/rounds on EITHER replica.

The port's copy of ``tests/test_replicas.py`` with its imports switched to
``vantage6_tpu_torch``.
"""
import base64
import threading
import time
import urllib.request

import numpy as np
import pandas as pd
import pytest

from vantage6_tpu_torch.server import models as m
from vantage6_tpu_torch.server.app import ServerApp

SECRET = "replica-shared-jwt-secret"
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


def _node(srv: ServerApp, api_key: str):
    c = srv.test_client()
    r = c.post("/api/token/node", {"api_key": api_key})
    assert r.status == 200, r
    c.token = r.json["access_token"]
    return c


def _seed(a: ServerApp) -> dict:
    """org + collab + node + one pending run, all via replica A."""
    c = _root(a)
    org = c.post("/api/organization", {"name": "org_a"}).json
    collab = c.post(
        "/api/collaboration",
        {"name": "demo", "organization_ids": [org["id"]]},
    ).json
    node = c.post(
        "/api/node",
        {"organization_id": org["id"], "collaboration_id": collab["id"]},
    ).json
    run = _new_run(c, collab["id"], org["id"])
    return {
        "root": c, "org": org, "collab": collab, "node": node, "run": run,
    }


def _new_run(root_client, collab_id: int, org_id: int) -> dict:
    task = root_client.post(
        "/api/task",
        {
            "image": "v6-average-py",
            "method": "partial_average",
            "collaboration_id": collab_id,
            "organizations": [
                {"id": org_id, "input": base64.b64encode(b"{}").decode()}
            ],
        },
    ).json
    runs = root_client.get(f"/api/run?task_id={task['id']}").json["data"]
    assert len(runs) == 1 and runs[0]["status"] == "pending"
    return runs[0]


def test_two_replicas_one_binding(pair):
    a, b = pair
    # one refcounted store handle in-process; each replica keeps its OWN
    # hub instance, but both are shared-stream substrates over that store
    assert a.db is b.db and a.db.SHARED
    assert a.hub is not b.hub
    assert getattr(a.hub, "SHARED", False) and getattr(b.hub, "SHARED", False)
    # /api/health on either replica reports the whole fleet from DB truth
    for srv, own in ((a, "replica-a"), (b, "replica-b")):
        health = srv.test_client().get("/api/health").json
        assert health["replica_id"] == own
        fleet = {r["replica_id"]: r["alive"] for r in health["replicas"]}
        assert fleet == {"replica-a": True, "replica-b": True}


def test_activation_cas_exactly_once(pair):
    a, b = pair
    s = _seed(a)
    run_id = s["run"]["id"]
    # the same node daemon sees both replicas; its token was minted by A
    # and verifies on B (shared jwt_secret + shared principal rows)
    na, nb = (
        _node(a, s["node"]["api_key"]), _node(b, s["node"]["api_key"])
    )
    # the dispatch race: the daemon's activation PATCH lands on BOTH
    # replicas (retry after a timeout whose first attempt actually won) —
    # exactly one 200; the loser's 409 is what prevents double execution
    r1 = na.patch(f"/api/run/{run_id}", {"status": "active"})
    r2 = nb.patch(f"/api/run/{run_id}", {"status": "active"})
    assert (r1.status, r2.status) == (200, 409), (r1, r2)
    assert "already active" in r2.json["msg"]
    # same primitive at the model layer: the guarded UPDATE admits one
    assert not m.TaskRun.compare_and_swap(
        run_id, sets={"status": "active"}, expect={"status": "pending"}
    )
    assert m.TaskRun.get(run_id).status == "active"


def test_orphan_reset_cannot_clobber_cross_replica_progress(pair):
    a, b = pair
    s = _seed(a)
    run_id = s["run"]["id"]
    na, nb = (
        _node(a, s["node"]["api_key"]), _node(b, s["node"]["api_key"])
    )
    # run completes THROUGH replica B...
    assert nb.patch(f"/api/run/{run_id}", {"status": "active"}).status == 200
    assert nb.patch(
        f"/api/run/{run_id}", {"status": "completed", "result": "42"}
    ).status == 200
    # ...so replica A's reset CAS (expect=active) must lose, not re-queue:
    # this is the exact interleaving a stale full-row save would corrupt
    assert not m.TaskRun.compare_and_swap(
        run_id, sets={"status": "pending"}, expect={"status": "active"}
    )
    # and the sweep endpoint on A agrees — nothing reset, result intact
    sweep = na.post("/api/run/claim-batch", {"reset_orphans": True}).json
    assert sweep["n_reset"] == 0
    row = m.TaskRun.get(run_id)
    assert (row.status, row.result) == ("completed", "42")
    # a GENUINE orphan (activated via A, daemon died) IS recovered by a
    # sweep arriving at the other replica
    orphan = _new_run(s["root"], s["collab"]["id"], s["org"]["id"])
    assert na.patch(
        f"/api/run/{orphan['id']}", {"status": "active"}
    ).status == 200
    sweep = nb.post("/api/run/claim-batch", {"reset_orphans": True}).json
    assert sweep["n_reset"] == 1
    assert m.TaskRun.get(orphan["id"]).status == "pending"
    assert any(e["id"] == orphan["id"] for e in sweep["data"])


def test_long_poll_wakes_on_other_replicas_emit(pair):
    a, b = pair
    got: dict = {}

    def poll():
        since = a.hub.cursor
        got["events"], got["cursor"], _ = a.hub.collect(
            since=since, timeout=5.0
        )

    t = threading.Thread(target=poll)
    t.start()
    time.sleep(0.1)  # the poller is blocked on replica A's condition
    t0 = time.monotonic()
    b.hub.emit("replica.test", {"x": 1})
    t.join(timeout=5.0)
    waited = time.monotonic() - t0
    assert not t.is_alive()
    assert [e.name for e in got["events"]] == ["replica.test"]
    # the adaptive re-check bounds cross-replica latency to ~poll_ceil,
    # not the long-poll timeout
    assert waited < 2.0, f"cross-replica wake took {waited:.2f}s"


def test_cache_invalidation_rides_the_bus(pair):
    a, b = pair
    s = _seed(a)
    root_a = s["root"]
    uid = root_a.post(
        "/api/user",
        {
            "username": "mallory",
            "password": "mallorypass123",
            "organization_id": s["org"]["id"],
        },
    ).json["id"]
    # mallory's session lives on replica B: the first request caches her
    # token → principal resolution THERE
    cb = b.test_client()
    tok = cb.post(
        "/api/token/user",
        {"username": "mallory", "password": "mallorypass123"},
    ).json["access_token"]
    cb.token = tok
    assert cb.get(f"/api/user/{uid}").status == 200
    assert b.auth_cache.get(tok) is not None
    # replica A mutates the principal → CACHE_INVALIDATE on the shared
    # stream → B's next drain (rate-limited to ~25 ms) evicts the token
    assert root_a.patch(
        f"/api/user/{uid}", {"firstname": "Mal"}
    ).status == 200
    time.sleep(0.06)
    b.drain_invalidations()
    assert b.auth_cache.get(tok) is None


def test_fedavg_round_trajectory_spans_replicas(pair, tmp_path):
    """Acceptance: a full FedAvg round trajectory whose
    per-round subtasks were served by DIFFERENT replicas reads back as
    one (task, round)-keyed history via /api/rounds — from either
    replica, and independent of any one replica's process memory."""
    from vantage6_tpu_torch.client import UserClient
    from vantage6_tpu_torch.node.daemon import NodeDaemon
    from vantage6_tpu_torch.runtime.learning import LEARNING, update_stats_host

    a, b = pair
    LEARNING.clear()
    rng = np.random.default_rng(12)
    frames = {}
    for name, shift in (("st_a", 0.0), ("st_b", 4.0)):
        df = pd.DataFrame({"age": rng.normal(50 + shift, 8, 80)})
        df.to_csv(tmp_path / f"{name}.csv", index=False)
        frames[name] = df
    http_a = a.serve(port=0, background=True)
    http_b = b.serve(port=0, background=True)
    daemons = []
    try:
        client_a = UserClient(http_a.url)
        client_a.authenticate("root", ROOT_PW)
        client_b = UserClient(http_b.url)
        client_b.authenticate("root", ROOT_PW)
        orgs = [
            client_a.organization.create(name=n) for n in ("st_a", "st_b")
        ]
        collab = client_a.collaboration.create(
            name="fed", organization_ids=[o["id"] for o in orgs]
        )
        # station daemons with OPPOSITE replica preference: station A's
        # claims/reports land on replica B first and vice versa, so every
        # round's runs are dispatched through both replicas
        for org, urls in (
            (orgs[0], f"{http_b.url},{http_a.url}"),
            (orgs[1], f"{http_a.url},{http_b.url}"),
        ):
            info = client_a.node.create(
                organization_id=org["id"], collaboration_id=collab["id"]
            )
            d = NodeDaemon(
                api_url=urls,
                api_key=info["api_key"],
                algorithms={"v6-average-py": "vantage6_tpu_torch.workloads.average"},
                databases=[{
                    "label": "default", "type": "csv",
                    "uri": str(tmp_path / f"{org['name']}.csv"),
                }],
                mode="inline",
                poll_interval=0.05,
            )
            d.start()
            daemons.append(d)
        # the FedAvg "global model": a scalar the rounds pull toward the
        # pooled mean (lr 0.5 → update norms decay geometrically)
        w, lr = 0.0, 0.5
        # the central FedAvg loop: a fresh per-round subtask pair, created
        # and awaited via ALTERNATING replicas; the aggregation's learning
        # record keys on the round-0 task id (the federation's parent-key
        # convention) and allocates round indices from the shared store
        key = None
        for r in range(4):
            create_cl, wait_cl = (
                (client_a, client_b) if r % 2 == 0 else (client_b, client_a)
            )
            task = create_cl.task.create(
                collaboration=collab["id"],
                organizations=[o["id"] for o in orgs],
                image="v6-average-py",
                input_={"method": "partial_average",
                        "kwargs": {"column": "age"}},
            )
            key = key if key is not None else task["id"]
            results = wait_cl.wait_for_results(
                task["id"], interval=0.1, timeout=60
            )
            assert len(results) == 2
            # FedAvg step: per-station update toward the station mean; the
            # pooled update shrinks as w converges on the pooled mean
            flat = np.array(
                [[lr * (res["sum"] / res["count"] - w)] for res in results],
                np.float32,
            )
            w += float(flat.mean())
            LEARNING.history(key).record_stats(
                update_stats_host(flat), loss=1.0 / (r + 1)
            )
        # both replicas serve the SAME contiguous 4-round trajectory
        via_a = client_a.request("GET", f"rounds/{key}")
        via_b = client_b.request("GET", f"rounds/{key}")
        assert [rec["round"] for rec in via_a["rounds"]] == [0, 1, 2, 3]
        assert via_a["rounds"] == via_b["rounds"]
        assert via_a["summary"]["rounds"] == 4
        assert key in [t["task"] for t in client_b.request("GET", "rounds")["tasks"]]
        # the norm trajectory converges (our synthetic 0.5x decay)
        norms = [rec["update_norm"] for rec in via_a["rounds"]]
        assert norms[0] > norms[-1] > 0
        # the history survives process memory loss: a replica that never
        # recorded anything (fresh registry) still serves the full
        # trajectory from the shared learning_round table
        LEARNING.clear()
        again = client_b.request("GET", f"rounds/{key}")
        assert again["rounds"] == via_a["rounds"]
        # and both replicas actually carried HTTP traffic for the round
        # work (the daemons' opposite URL preference)
        for url in (http_a.url, http_b.url):
            text = urllib.request.urlopen(url + "/api/metrics").read().decode()
            line = next(
                ln for ln in text.splitlines()
                if ln.startswith("v6t_http_requests_total")
            )
            assert float(line.rsplit(" ", 1)[1]) > 0
    finally:
        for d in daemons:
            d.stop()
        http_a.stop()
        http_b.stop()
        LEARNING.clear()


def test_autopilot_requeue_exactly_once_across_replicas(pair):
    """Both replicas' autopilots remediate the SAME
    daemon_lapsed alert concurrently — the CAS guard inside
    ServerActuator._requeue lets exactly one of them re-queue the
    orphaned ACTIVE run; the loser's swap fails and it reports 0."""
    from vantage6_tpu_torch.server.app import ServerActuator

    a, b = pair
    s = _seed(a)
    run_id = s["run"]["id"]
    node_id = s["node"]["id"]
    # the daemon activated the run, then lapsed mid-execution
    na = _node(a, s["node"]["api_key"])
    assert na.patch(f"/api/run/{run_id}", {"status": "active"}).status == 200
    actuators = [ServerActuator(a), ServerActuator(b)]
    results = [None, None]
    barrier = threading.Barrier(2)

    def remediate(i):
        barrier.wait()
        results[i] = actuators[i].requeue_node_runs(node_id)

    threads = [
        threading.Thread(target=remediate, args=(i,)) for i in range(2)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(results) == [0, 1], results
    run = m.TaskRun.get(run_id)
    assert run.status == "pending"
    assert "re-queued by autopilot" in (run.log or "")
    # remediating again finds nothing ACTIVE: the action is idempotent
    assert actuators[0].requeue_node_runs(node_id) == 0
