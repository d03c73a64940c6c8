"""Control-plane scale smoke (VERDICT r4 next #4; SURVEY.md §2.4 scale-out).

The reference scales its control plane horizontally (RabbitMQ-backed
SocketIO); this rebuild's stance is a single-process server whose
orchestration SEMANTICS survive federation-scale load. This test is the
evidence at demo scale: one server, 32 inline node daemons, a few hundred
mixed tasks (partial fan-outs of random width, central fan-outs through the
node proxy, a batch killed right after submit) while one node is bounced
mid-run — then it asserts

- every non-killed task reaches COMPLETED inside the deadline (none lost),
- every task has EXACTLY one run per targeted organization (none lost,
  none duplicated, even for the bounced node's backlog),
- killed tasks terminate (killed or already-completed, never stuck),
- submit→finish latency p95 stays under a demo-scale bound,
- the event stream is cursor-consistent: strictly increasing seqs and a
  mid-stream `since` replay returning exactly the suffix.

Measured numbers are printed for BASELINE.md's control-plane section.

The port's copy of ``tests/test_scale_smoke.py`` with its imports switched to
``vantage6_tpu_torch``.
"""
import time

import numpy as np
import pandas as pd
import pytest

from vantage6_tpu_torch.client import UserClient
from vantage6_tpu_torch.common.enums import TaskStatus
from vantage6_tpu_torch.node.daemon import NodeDaemon
from vantage6_tpu_torch.server.app import ServerApp

N_NODES = 32
N_PARTIAL = 170          # partial tasks at random width
N_CENTRAL = 12           # central fan-outs through the node proxy
N_KILLED = 10            # killed immediately after submit
BOUNCE_IDX = 5           # this node is stopped/restarted mid-run
DEADLINE_S = 300.0
P95_BOUND_S = 30.0       # demo-scale latency bound (inline nodes, 1 host)

IMAGE = "v6-average-py"
MODULE = "vantage6_tpu_torch.workloads.average"


def _mk_daemon(http_url, api_key, csv_path):
    return NodeDaemon(
        api_url=http_url,
        api_key=api_key,
        algorithms={IMAGE: MODULE},
        databases=[{"label": "default", "type": "csv", "uri": str(csv_path)}],
        mode="inline",
        poll_interval=0.25,
    )


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scale")
    rng = np.random.default_rng(11)
    srv = ServerApp()
    srv.ensure_root(password="rootpass123")
    http = srv.serve(port=0, background=True)
    client = UserClient(http.url)
    client.authenticate("root", "rootpass123")

    # the root org joins the collaboration so the root user's event-room
    # scope covers the collaboration room (events assertions below)
    root_org = next(o for o in client.organization.list() if o["name"] == "root")
    orgs, keys, csvs = [], [], []
    for i in range(N_NODES):
        org = client.organization.create(name=f"scale{i:02d}")
        csv = tmp / f"s{i:02d}.csv"
        pd.DataFrame({"age": rng.uniform(20, 80, 20).round(1)}).to_csv(
            csv, index=False
        )
        orgs.append(org)
        csvs.append(csv)
    collab = client.collaboration.create(
        name="scale",
        organization_ids=[root_org["id"], *(o["id"] for o in orgs)],
    )
    daemons = []
    for i, org in enumerate(orgs):
        ni = client.node.create(
            organization_id=org["id"], collaboration_id=collab["id"]
        )
        keys.append(ni["api_key"])
        d = _mk_daemon(http.url, ni["api_key"], csvs[i])
        d.start()
        daemons.append(d)
    yield {
        "client": client, "orgs": orgs, "collab": collab,
        "daemons": daemons, "keys": keys, "csvs": csvs, "http": http,
        "rng": rng,
    }
    for d in daemons:
        d.stop()
    http.stop()
    srv.close()


def test_scale_churn_and_cursor_replay(world):
    client, orgs, collab = world["client"], world["orgs"], world["collab"]
    rng = world["rng"]
    org_ids = [o["id"] for o in orgs]

    submitted: dict[int, dict] = {}  # task id -> {t0, orgs, kind}
    killed_ids: list[int] = []

    def submit_partial(k_orgs: int, targets: list[int] | None = None) -> int:
        if targets is None:
            targets = [
                int(v) for v in rng.choice(org_ids, k_orgs, replace=False)
            ]
        t0 = time.time()
        t = client.task.create(
            collaboration=collab["id"],
            organizations=targets,
            image=IMAGE,
            input_={"method": "partial_average", "kwargs": {"column": "age"}},
        )
        submitted[t["id"]] = {"t0": t0, "orgs": set(targets), "kind": "partial"}
        return t["id"]

    def submit_central() -> int:
        home = int(rng.choice(org_ids))
        t0 = time.time()
        # explicit fan-out targets: the collaboration also contains the
        # ROOT org (joined for event-room scope), which has no node — a
        # default "all orgs" fan-out would wait forever on it, exactly as
        # the reference does for a node-less organization
        t = client.task.create(
            collaboration=collab["id"],
            organizations=[home],
            image=IMAGE,
            input_={"method": "central_average",
                    "kwargs": {"column": "age", "organizations": org_ids}},
        )
        submitted[t["id"]] = {"t0": t0, "orgs": {home}, "kind": "central"}
        return t["id"]

    # ---- phase 1: first third of the load with everything healthy
    for i in range(N_PARTIAL // 3):
        submit_partial(int(rng.integers(2, 7)))
        if i % 20 == 10:
            submit_central()

    # ---- phase 2: bounce one node; its backlog must survive the restart
    bounced_org = orgs[BOUNCE_IDX]["id"]
    world["daemons"][BOUNCE_IDX].stop()
    for i in range(N_PARTIAL // 3):
        if i % 10 == 0:
            # guarantee a backlog lands on the downed node: explicit targets
            other = int(rng.choice([o for o in org_ids if o != bounced_org]))
            submit_partial(2, targets=[bounced_org, other])
        else:
            submit_partial(int(rng.integers(2, 7)))
        if i % 8 == 3 and len(killed_ids) < N_KILLED:
            ktid = submit_partial(3)
            client.task.kill(ktid)
            killed_ids.append(ktid)
            submitted[ktid]["kind"] = "killed"
    # restart the bounced node with the SAME identity
    d = _mk_daemon(world["http"].url, world["keys"][BOUNCE_IDX],
                   world["csvs"][BOUNCE_IDX])
    d.start()
    world["daemons"][BOUNCE_IDX] = d

    # ---- phase 3: the rest of the load, central tasks included
    for i in range(N_PARTIAL - 2 * (N_PARTIAL // 3)):
        submit_partial(int(rng.integers(2, 7)))
        if i % 15 == 5:
            submit_central()
    while sum(1 for s in submitted.values() if s["kind"] == "central") \
            < N_CENTRAL:
        submit_central()

    # ---- drain: every task must reach a terminal state
    deadline = time.time() + DEADLINE_S
    pending = set(submitted)
    statuses: dict[int, str] = {}
    while pending and time.time() < deadline:
        for tid in list(pending):
            st = TaskStatus(client.task.get(tid)["status"])
            if st.is_finished:
                statuses[tid] = st.value
                pending.discard(tid)
        time.sleep(0.5)
    assert not pending, (
        f"{len(pending)} tasks never finished: "
        f"{[(t, client.task.get(t)['status']) for t in list(pending)[:5]]}"
    )

    # ---- invariant: terminal status per kind
    for tid, meta in submitted.items():
        if meta["kind"] == "killed":
            assert statuses[tid] in (TaskStatus.KILLED.value,
                                     TaskStatus.COMPLETED.value), \
                (tid, statuses[tid])
        else:
            assert statuses[tid] == TaskStatus.COMPLETED.value, \
                (tid, statuses[tid], meta)

    # ---- invariant: exactly one run per targeted org, none lost/duplicated
    latencies = []
    for tid, meta in submitted.items():
        runs = client.run.from_task(tid)
        run_orgs = [r["organization"]["id"] for r in runs]
        assert len(run_orgs) == len(set(run_orgs)), \
            f"task {tid}: duplicated runs {run_orgs}"
        if meta["kind"] != "killed":
            assert set(run_orgs) == meta["orgs"], \
                f"task {tid}: runs {sorted(run_orgs)} != targets " \
                f"{sorted(meta['orgs'])}"
            fins = [r["finished_at"] for r in runs]
            assert all(f is not None for f in fins), (tid, runs)
            latencies.append(max(fins) - meta["t0"])
        else:
            # killed: no zombie runs left pending/active
            for r in runs:
                assert TaskStatus(r["status"]).is_finished, (tid, r)

    # ---- latency distribution (printed for BASELINE.md)
    lat = np.asarray(latencies)
    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
    print(
        f"\nscale smoke: nodes={N_NODES} tasks={len(submitted)} "
        f"runs={int(sum(len(m['orgs']) for m in submitted.values()))} "
        f"latency p50={p50:.2f}s p95={p95:.2f}s p99={p99:.2f}s "
        f"max={lat.max():.2f}s"
    )
    assert p95 < P95_BOUND_S, f"p95 {p95:.2f}s exceeds {P95_BOUND_S}s"

    # ---- event-cursor replay correctness under churn
    full = client.util.events(since=0)
    events = full["data"]
    seqs = [e["seq"] for e in events]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs), \
        "event seqs not strictly increasing"
    assert full["cursor"] == seqs[-1]
    mid = seqs[len(seqs) // 2]
    suffix = client.util.events(since=mid)["data"]
    assert [e["seq"] for e in suffix] == [s for s in seqs if s > mid], \
        "mid-cursor replay is not exactly the suffix"
    # the kill events for killed tasks are in the (bounded) buffer tail or
    # were legitimately evicted; whichever kills ARE present must reference
    # tasks we actually killed — nothing else may emit kill-task here
    kill_events = [e for e in events if e["name"] == "kill-task"]
    for e in kill_events:
        assert e["data"].get("task_id") in set(killed_ids)
    # node churn shows up as offline/online for the bounced node
    names = {e["name"] for e in events}
    assert "task-created" in names and "status-update" in names
