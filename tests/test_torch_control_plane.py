"""Control-plane fast path: batched REST, long-poll wakeups,
hot-path caches, EventHub overflow/resync, and a tier-1-safe mini smoke.

Covers:
- the batched endpoints (`POST /run/claim-batch`, `PATCH /run/batch`) —
  scoping, orphan reset, explicit-ids dispatch, per-item outcomes;
- the long-poll event channel — early wake on emit, cursor probe,
  name filter, `truncated` after buffer overflow;
- EventHub under concurrent emit/fetch, and the daemon's
  overflow→resync / cursor-regression paths;
- the token→principal auth cache (hit + explicit invalidation on
  credential/role mutation) and the db layer's where-column validation;
- the poll-failure backoff (capped, jittered);
- a 4-daemon mini smoke with a bounded dispatch p95 and run parity,
  including one LEGACY (per-run + fixed-poll) daemon against the same
  server — the mixed-version guarantee.

The port's copy of ``tests/test_control_plane.py`` with its imports switched to
``vantage6_tpu_torch``.
"""
import threading
import time

import numpy as np
import pandas as pd
import pytest

from vantage6_tpu_torch.client import UserClient
from vantage6_tpu_torch.common.enums import TaskStatus
from vantage6_tpu_torch.node.daemon import NodeDaemon, backoff_delay
from vantage6_tpu_torch.server import models as m
from vantage6_tpu_torch.server.app import ServerApp
from vantage6_tpu_torch.server.events import EventHub


@pytest.fixture()
def srv():
    app = ServerApp()
    yield app
    app.close()


@pytest.fixture()
def seeded(srv):
    c = srv.test_client()
    srv.ensure_root(password="rootpass123")
    r = c.post("/api/token/user",
               {"username": "root", "password": "rootpass123"})
    c.token = r.json["access_token"]
    orgs = [
        c.post("/api/organization", {"name": name}).json
        for name in ("cp_a", "cp_b")
    ]
    collab = c.post(
        "/api/collaboration",
        {"name": "cp", "organization_ids": [o["id"] for o in orgs]},
    ).json
    keys, nodes = [], []
    for o in orgs:
        resp = c.post(
            "/api/node",
            {"organization_id": o["id"], "collaboration_id": collab["id"]},
        ).json
        keys.append(resp.pop("api_key"))
        nodes.append(resp)
    return {"client": c, "orgs": orgs, "collab": collab,
            "nodes": nodes, "api_keys": keys}


def node_login(srv, api_key):
    c = srv.test_client()
    r = c.post("/api/token/node", {"api_key": api_key})
    assert r.status == 200, r
    c.token = r.json["access_token"]
    return c, r.json["node"]


def make_task(seeded, org_ids=None, n=1):
    c = seeded["client"]
    out = []
    for _ in range(n):
        t = c.post(
            "/api/task",
            {
                "image": "img",
                "collaboration_id": seeded["collab"]["id"],
                "organizations": [
                    {"id": oid, "input": ""}
                    for oid in (org_ids or [seeded["orgs"][0]["id"]])
                ],
            },
        ).json
        out.append(t)
    return out


# ------------------------------------------------------------- claim-batch
class TestClaimBatch:
    def test_sweep_returns_run_task_token(self, srv, seeded):
        make_task(seeded, n=3)
        nc, node = node_login(srv, seeded["api_keys"][0])
        resp = nc.post("/api/run/claim-batch", {}).json
        assert len(resp["data"]) == 3
        for entry in resp["data"]:
            assert entry["status"] == TaskStatus.PENDING.value
            assert entry["task"]["image"] == "img"
            assert entry["container_token"]
        # the minted token is a working container credential
        cc = srv.test_client()
        cc.token = resp["data"][0]["container_token"]
        assert cc.get("/api/whoami").json["type"] == "container"

    def test_scoped_to_own_org_and_collab(self, srv, seeded):
        make_task(seeded, org_ids=[seeded["orgs"][1]["id"]])
        nc, _ = node_login(srv, seeded["api_keys"][0])
        assert nc.post("/api/run/claim-batch", {}).json["data"] == []

    def test_explicit_run_ids_skip_non_pending(self, srv, seeded):
        (t,) = make_task(seeded)
        nc, _ = node_login(srv, seeded["api_keys"][0])
        rid = t["runs"][0]
        got = nc.post("/api/run/claim-batch", {"run_ids": [rid]}).json
        assert [e["id"] for e in got["data"]] == [rid]
        nc.patch(f"/api/run/{rid}",
                 {"status": TaskStatus.COMPLETED.value, "result": "r"})
        got = nc.post("/api/run/claim-batch", {"run_ids": [rid]}).json
        assert got["data"] == []  # terminal: silently skipped

    def test_orphan_reset_respects_exclusions(self, srv, seeded):
        t1, t2 = make_task(seeded, n=2)
        nc, _ = node_login(srv, seeded["api_keys"][0])
        r1, r2 = t1["runs"][0], t2["runs"][0]
        for rid in (r1, r2):
            nc.patch(f"/api/run/{rid}",
                     {"status": TaskStatus.ACTIVE.value, "started_at": 1.0})
        resp = nc.post(
            "/api/run/claim-batch",
            {"reset_orphans": True, "exclude_run_ids": [r2]},
        ).json
        # r1 reset to pending and re-delivered; r2 (still executing at the
        # daemon, says the exclude list) untouched
        assert resp["n_reset"] == 1
        assert [e["id"] for e in resp["data"]] == [r1]
        assert m.TaskRun.get(r2).status == TaskStatus.ACTIVE.value

    def test_requires_node_credentials(self, srv, seeded):
        assert seeded["client"].post(
            "/api/run/claim-batch", {}
        ).status == 403


# --------------------------------------------------------------- run/batch
class TestRunBatchPatch:
    def test_per_item_outcomes(self, srv, seeded):
        (t,) = make_task(
            seeded,
            org_ids=[seeded["orgs"][0]["id"], seeded["orgs"][1]["id"]],
        )
        nc, _ = node_login(srv, seeded["api_keys"][0])
        mine, foreign = sorted(t["runs"])
        run_a = m.TaskRun.get(mine)
        if run_a.organization_id != seeded["orgs"][0]["id"]:
            mine, foreign = foreign, mine
        nc.patch(f"/api/run/{mine}", {"status": TaskStatus.KILLED.value})
        resp = nc.patch(
            "/api/run/batch",
            {"runs": [
                {"id": mine, "status": TaskStatus.COMPLETED.value},
                {"id": foreign, "status": TaskStatus.COMPLETED.value},
                {"id": 424242, "status": TaskStatus.COMPLETED.value},
            ]},
        ).json
        by_id = {r["id"]: r for r in resp["data"]}
        assert by_id[mine]["status_code"] == 409       # terminal immutable
        assert by_id[foreign]["status_code"] == 403    # other org's run
        assert by_id[424242]["status_code"] == 404
        # the 409 must not have changed anything
        assert m.TaskRun.get(mine).status == TaskStatus.KILLED.value

    def test_success_emits_status_events(self, srv, seeded):
        (t,) = make_task(seeded)
        nc, _ = node_login(srv, seeded["api_keys"][0])
        rid = t["runs"][0]
        before = srv.hub.cursor
        resp = nc.patch(
            "/api/run/batch",
            {"runs": [{
                "id": rid,
                "status": TaskStatus.COMPLETED.value,
                "result": "blob",
                "finished_at": 2.0,
            }]},
        ).json
        assert resp["data"] == [{"id": rid, "status_code": 200}]
        events = [e for e in srv.hub.fetch(before)
                  if e.name == "status-update"]
        assert events and events[-1].data["run_id"] == rid
        assert events[-1].data["task_status"] == TaskStatus.COMPLETED.value

    def test_validation_is_400(self, srv, seeded):
        nc, _ = node_login(srv, seeded["api_keys"][0])
        assert nc.patch("/api/run/batch", {"runs": []}).status == 400
        assert nc.patch(
            "/api/run/batch", {"runs": [{"status": "completed"}]}
        ).status == 400  # id required


# ---------------------------------------------------------- event long-poll
class TestEventLongPoll:
    def test_wait_returns_early_on_emit(self, srv, seeded):
        c = seeded["client"]
        cursor = c.get("/api/event?since=-1").json["cursor"]

        def emit_later():
            time.sleep(0.15)
            srv.hub.emit("status-update", {"x": 1}, room="all")

        threading.Thread(target=emit_later, daemon=True).start()
        t0 = time.perf_counter()
        batch = c.get(f"/api/event?since={cursor}&wait=5").json
        elapsed = time.perf_counter() - t0
        assert [e["name"] for e in batch["data"]] == ["status-update"]
        assert elapsed < 2.0  # woke on the emit, not the 5 s window

    def test_wait_times_out_empty(self, srv, seeded):
        c = seeded["client"]
        cursor = c.get("/api/event?since=-1").json["cursor"]
        t0 = time.perf_counter()
        batch = c.get(f"/api/event?since={cursor}&wait=0.2").json
        assert batch["data"] == []
        assert 0.15 <= time.perf_counter() - t0 < 2.0

    def test_names_filter_gates_wake_and_data(self, srv, seeded):
        c = seeded["client"]
        cursor = c.get("/api/event?since=-1").json["cursor"]
        srv.hub.emit("task-created", {"a": 1}, room="all")
        srv.hub.emit("status-update", {"b": 2}, room="all")
        batch = c.get(
            f"/api/event?since={cursor}&names=status-update"
        ).json
        assert [e["name"] for e in batch["data"]] == ["status-update"]

    def test_cursor_probe(self, srv, seeded):
        c = seeded["client"]
        srv.hub.emit("task-created", {"a": 1}, room="all")
        batch = c.get("/api/event?since=-1&wait=5").json
        assert batch["data"] == []  # probe never replays nor blocks
        assert batch["cursor"] == srv.hub.cursor
        assert batch["long_poll"] is True

    def test_bad_wait_is_400(self, srv, seeded):
        assert seeded["client"].get(
            "/api/event?since=0&wait=soon"
        ).status == 400

    def test_truncated_flag_after_overflow(self, srv, seeded):
        c = seeded["client"]
        small = EventHub(buffer_size=8)
        srv.hub = small
        for i in range(20):
            small.emit("status-update", {"i": i}, room="all")
        batch = c.get("/api/event?since=2").json
        assert batch["truncated"] is True
        # a cursor inside the retained window is fine
        batch = c.get(f"/api/event?since={small.cursor - 1}").json
        assert batch["truncated"] is False


# ------------------------------------------------------------------ EventHub
class TestEventHub:
    def test_eviction_accounting(self):
        hub = EventHub(buffer_size=4)
        for i in range(4):
            hub.emit("e", {"i": i})
        assert hub.evicted_through == 0 and not hub.truncated(0)
        hub.emit("e", {"i": 4})  # evicts seq 1
        assert hub.evicted_through == 1
        assert hub.truncated(0) and not hub.truncated(1)

    def test_wait_for_wakes_on_matching_emit(self):
        hub = EventHub()
        got = []

        def waiter():
            got.extend(hub.wait_for(0, rooms=["r1"], timeout=5.0))

        th = threading.Thread(target=waiter)
        th.start()
        time.sleep(0.05)
        hub.emit("x", {}, room="other")   # must NOT wake r1
        time.sleep(0.05)
        hub.emit("y", {}, room="r1")
        th.join(timeout=5)
        assert [e.name for e in got] == ["y"]

    def test_concurrent_emit_fetch_consistent(self):
        """Under concurrent emit/collect the stream stays strictly
        ordered and a cursor chain never duplicates or silently drops a
        retained event: every event not delivered falls inside a window
        the SAME atomic snapshot flagged as truncated."""
        hub = EventHub(buffer_size=64)  # small: forces overflow mid-run
        n_emitters, per_emitter = 4, 200
        stop = threading.Event()
        seen: list[int] = []
        lost_window = []

        def emitter(k):
            for i in range(per_emitter):
                hub.emit("e", {"k": k, "i": i})

        def reader():
            cursor = 0
            while not stop.is_set() or hub.cursor > cursor:
                evs, new_cursor, truncated = hub.collect(cursor)
                if truncated:
                    # overflow DETECTED in the same snapshot: the gap is
                    # bounded by the eviction horizon (read after — may
                    # only overestimate, never under)
                    lost_window.append((cursor, hub.evicted_through))
                for e in evs:
                    seen.append(e.seq)
                cursor = max(cursor, new_cursor)

        threads = [threading.Thread(target=emitter, args=(k,))
                   for k in range(n_emitters)]
        rt = threading.Thread(target=reader)
        rt.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stop.set()
        rt.join(timeout=10)
        assert seen == sorted(seen)                  # strictly increasing
        assert len(seen) == len(set(seen))           # no duplicates
        total = n_emitters * per_emitter
        lost = sum(b - a for a, b in lost_window)
        assert len(seen) + lost >= total             # gap fully accounted
        assert hub.cursor == total


# -------------------------------------------------- daemon resync + backoff
class TestDaemonHealing:
    def test_backoff_caps_and_jitters(self):
        # deterministic rng at both ends of the jitter range
        lo = [backoff_delay(0.25, n, rng=lambda: 0.0) for n in range(1, 9)]
        hi = [backoff_delay(0.25, n, rng=lambda: 1.0) for n in range(1, 9)]
        assert lo == [d / 2 for d in hi]             # jitter spans [0.5, 1]x
        assert hi[0] == 0.25 and hi[1] == 0.5        # exponential from base
        assert max(hi) <= 10.0                       # capped
        assert hi[-1] == 10.0
        # decorrelation: two daemons rarely pick the same delay
        import random
        a = backoff_delay(0.25, 5, rng=random.Random(1).random)
        b = backoff_delay(0.25, 5, rng=random.Random(2).random)
        assert a != b

    def test_overflow_triggers_full_resync(self, srv, seeded, tmp_path):
        """Hub overflow between polls → truncated → the daemon resyncs
        runs AND kills from primary state (the 4096-ring guarantee)."""
        http = srv.serve(port=0, background=True)
        try:
            pd.DataFrame({"age": [30.0, 40.0]}).to_csv(
                tmp_path / "d.csv", index=False
            )
            d = NodeDaemon(
                api_url=http.url,
                api_key=seeded["api_keys"][0],
                algorithms={"img": "vantage6_tpu_torch.workloads.average"},
                databases=[{"label": "default", "type": "csv",
                            "uri": str(tmp_path / "d.csv")}],
                mode="inline",
                poll_interval=0.1,
                event_wait=0.0,  # deterministic polling for the test
            )
            # shrink the ring AFTER daemon start so the overflow happens
            # between this daemon's polls
            d.start()
            time.sleep(0.3)
            small = EventHub(buffer_size=4)
            # keep the sequence space AHEAD of the daemon's cursor so this
            # reads as overflow, not restart-regression
            for _ in range(d._cursor + 8):
                small.emit("noise", {}, room="all")
            srv.hub = small
            # a task + an immediate kill, both riding only the (lost) ring
            (t,) = make_task(seeded)
            rid = t["runs"][0]
            run = m.TaskRun.get(rid)
            run.status = TaskStatus.KILLED.value
            run.save()
            for _ in range(12):  # flood: evict the task/kill events
                small.emit("noise", {}, room="all")
            deadline = time.time() + 10
            while rid not in d._killed and time.time() < deadline:
                time.sleep(0.1)
            assert rid in d._killed, "kill not re-learned after overflow"
        finally:
            d.stop()
            http.stop()


# ------------------------------------------------------- auth cache behavior
class TestAuthCache:
    def test_hit_skips_requery(self, srv, seeded):
        c = seeded["client"]
        assert c.get("/api/health").status == 200
        h0 = srv.auth_cache.hits
        assert c.get("/api/user").status == 200
        assert srv.auth_cache.hits > h0

    def test_password_change_kills_cached_token(self, srv, seeded):
        c = seeded["client"]
        assert c.get("/api/user").status == 200  # cached now
        r = c.post("/api/password/change", {
            "current_password": "rootpass123",
            "new_password": "newpass12345",
        })
        assert r.status == 200
        # the OLD token must die immediately, cache notwithstanding
        assert c.get("/api/user").status == 401

    def test_role_rules_edit_invalidates(self, srv, seeded):
        c = seeded["client"]
        viewer = next(r for r in c.get("/api/role").json["data"]
                      if r["name"] == "Viewer")
        bob = c.post("/api/user", {
            "username": "bob", "password": "bobpass12345",
            "organization_id": seeded["orgs"][0]["id"],
            "roles": [viewer["id"]],
        }).json
        bc = srv.test_client()
        r = bc.post("/api/token/user",
                    {"username": "bob", "password": "bobpass12345"})
        bc.token = r.json["access_token"]
        assert bc.get("/api/user").status == 200  # bob cached WITH rules
        # root strips every rule from Viewer → bob loses user-view NOW
        assert c.patch(
            f"/api/role/{viewer['id']}", {"rules": []}
        ).status == 200
        assert bc.get("/api/user").status == 403

    def test_node_status_flows_despite_cache(self, srv, seeded):
        nc, node = node_login(srv, seeded["api_keys"][0])
        assert nc.post("/api/ping").status == 200
        assert nc.post("/api/ping").status == 200  # cached principal
        assert m.Node.get(node["id"]).status == "online"


# ------------------------------------------------------- db where validation
class TestDbColumnValidation:
    def test_bad_where_kwarg_is_typeerror_before_sql(self, srv):
        with pytest.raises(TypeError, match="unknown where column"):
            m.TaskRun.list(**{"status; DROP TABLE run--": "x"})
        with pytest.raises(TypeError, match="unknown where column"):
            m.TaskRun.first(nonexistent_column=1)
        with pytest.raises(TypeError, match="unknown where column"):
            m.TaskRun.count(bogus=1)

    def test_bad_order_rejected(self, srv):
        with pytest.raises(TypeError, match="unknown order column"):
            m.TaskRun.list(order="id; DROP TABLE run")
        with pytest.raises(TypeError, match="bad order direction"):
            m.TaskRun.list(order="id sideways")
        assert m.TaskRun.list(order="id desc") == []  # direction ok

    def test_legit_columns_still_work(self, srv, seeded):
        assert m.TaskRun.count(status=TaskStatus.PENDING.value) == 0
        make_task(seeded)
        assert m.TaskRun.count(status=TaskStatus.PENDING.value) == 1


# ------------------------------------------------------------- mini smoke
N_MINI = 4
MINI_TASKS = 12
MINI_P95_BOUND_S = 5.0  # generous: shared-CI bound, not a perf claim


class TestMiniSmoke:
    def test_mini_control_plane_smoke(self, tmp_path):
        """4 batched+pushed daemons + 1 LEGACY daemon against one server:
        every task completes, exactly one run per targeted org, bounded
        end-to-end p95 — the tier-1-safe slice of the 32-daemon smoke."""
        rng = np.random.default_rng(3)
        srv = ServerApp()
        srv.ensure_root(password="rootpass123")
        http = srv.serve(port=0, background=True)
        daemons = []
        try:
            client = UserClient(http.url)
            client.authenticate("root", "rootpass123")
            orgs, keys, csvs = [], [], []
            for i in range(N_MINI):
                org = client.organization.create(name=f"mini{i}")
                csv = tmp_path / f"m{i}.csv"
                pd.DataFrame(
                    {"age": rng.uniform(20, 80, 16).round(1)}
                ).to_csv(csv, index=False)
                orgs.append(org)
                csvs.append(csv)
            collab = client.collaboration.create(
                name="mini",
                organization_ids=[o["id"] for o in orgs],
            )
            for i, org in enumerate(orgs):
                ni = client.node.create(
                    organization_id=org["id"],
                    collaboration_id=collab["id"],
                )
                keys.append(ni["api_key"])
                legacy = i == N_MINI - 1  # mixed-version: one old daemon
                d = NodeDaemon(
                    api_url=http.url,
                    api_key=ni["api_key"],
                    algorithms={
                        "v6-average-py": "vantage6_tpu_torch.workloads.average"
                    },
                    databases=[{"label": "default", "type": "csv",
                                "uri": str(csvs[i])}],
                    mode="inline",
                    poll_interval=0.1,
                    transport="per-run" if legacy else "batched",
                    event_wait=0.0 if legacy else 2.0,
                )
                d.start()
                daemons.append(d)
            org_ids = [o["id"] for o in orgs]
            latencies = []
            for i in range(MINI_TASKS):
                targets = [org_ids[i % N_MINI],
                           org_ids[(i + 1) % N_MINI]]
                t0 = time.perf_counter()
                t = client.task.create(
                    collaboration=collab["id"],
                    organizations=targets,
                    image="v6-average-py",
                    input_={"method": "partial_average",
                            "kwargs": {"column": "age"}},
                )
                res = client.wait_for_results(
                    t["id"], interval=0.1, timeout=60.0
                )
                latencies.append(time.perf_counter() - t0)
                assert len(res) == 2 and all(
                    r["count"] == 16 for r in res
                )
                runs = client.run.from_task(t["id"])
                run_orgs = [r["organization"]["id"] for r in runs]
                assert sorted(run_orgs) == sorted(targets)  # none lost/dup
                assert all(
                    r["status"] == TaskStatus.COMPLETED.value for r in runs
                )
            p95 = float(np.percentile(np.asarray(latencies), 95))
            assert p95 < MINI_P95_BOUND_S, f"p95 {p95:.2f}s"
            # the batched daemons actually used the fast path...
            assert all(d._batch_ok for d in daemons[:-1])
            assert all(d._long_poll for d in daemons[:-1])
            # ...and the legacy daemon stayed on the per-run path
            assert daemons[-1]._batch_ok is False
        finally:
            for d in daemons:
                d.stop()
            http.stop()
            srv.close()
