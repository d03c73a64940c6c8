"""REST API tests via the in-process test client (SURVEY.md §4: server tests
= test client + in-memory DB + seeded fixtures, permission matrix heavy).

The port's copy of ``tests/test_server_api.py`` with its imports switched to
``vantage6_tpu_torch``.
"""
import pytest

from vantage6_tpu_torch.server.app import ServerApp
from vantage6_tpu_torch.server.auth import totp_code
from vantage6_tpu_torch.server import models as m
from vantage6_tpu_torch.server.db import Model


@pytest.fixture()
def srv():
    app = ServerApp()
    yield app
    app.close()


@pytest.fixture()
def seeded(srv):
    """root user + two orgs in a collaboration, each with a node + researcher."""
    c = srv.test_client()
    root, pw = srv.ensure_root(password="rootpass123")
    r = c.post("/api/token/user", {"username": "root", "password": "rootpass123"})
    assert r.status == 200, r
    c.token = r.json["access_token"]

    orgs = []
    for name in ("hospital_a", "hospital_b"):
        orgs.append(c.post("/api/organization", {"name": name}).json)
    collab = c.post(
        "/api/collaboration",
        {"name": "demo", "organization_ids": [o["id"] for o in orgs]},
    ).json
    nodes, keys = [], []
    for o in orgs:
        resp = c.post(
            "/api/node",
            {"organization_id": o["id"], "collaboration_id": collab["id"]},
        ).json
        keys.append(resp.pop("api_key"))
        nodes.append(resp)
    # researcher at org A
    researcher_role = next(
        r for r in c.get("/api/role").json["data"] if r["name"] == "Researcher"
    )
    alice = c.post(
        "/api/user",
        {
            "username": "alice",
            "password": "alicepass123",
            "organization_id": orgs[0]["id"],
            "roles": [researcher_role["id"]],
        },
    ).json
    return {
        "client": c,
        "root_token": c.token,
        "orgs": orgs,
        "collab": collab,
        "nodes": nodes,
        "api_keys": keys,
        "alice": alice,
    }


def login(srv, username, password):
    c = srv.test_client()
    r = c.post("/api/token/user", {"username": username, "password": password})
    assert r.status == 200, r
    c.token = r.json["access_token"]
    return c


def node_login(srv, api_key):
    c = srv.test_client()
    r = c.post("/api/token/node", {"api_key": api_key})
    assert r.status == 200, r
    c.token = r.json["access_token"]
    return c, r.json["node"]


class TestServiceEndpoints:
    def test_health_and_version(self, srv):
        c = srv.test_client()
        assert c.get("/api/health").json["status"] == "ok"
        assert "version" in c.get("/api/version").json

    def test_unknown_route_404(self, srv):
        assert srv.test_client().get("/api/nope").status == 404


class TestAuth:
    def test_bad_password_and_lockout(self, srv, seeded):
        c = srv.test_client()
        for _ in range(m.User.MAX_FAILED_ATTEMPTS):
            r = c.post(
                "/api/token/user", {"username": "alice", "password": "wrong!"}
            )
            assert r.status == 401
        r = c.post(
            "/api/token/user", {"username": "alice", "password": "alicepass123"}
        )
        assert r.status == 401 and "locked" in r.json["msg"]

    def test_mfa_flow(self, srv, seeded):
        user = m.User.first(username="alice")
        from vantage6_tpu_torch.server.auth import generate_totp_secret

        user.totp_secret = generate_totp_secret()
        user.save()
        c = srv.test_client()
        r = c.post(
            "/api/token/user", {"username": "alice", "password": "alicepass123"}
        )
        assert r.status == 401 and "MFA" in r.json["msg"]
        r = c.post(
            "/api/token/user",
            {
                "username": "alice",
                "password": "alicepass123",
                "mfa_code": totp_code(user.totp_secret),
            },
        )
        assert r.status == 200

    def test_refresh(self, srv, seeded):
        c = srv.test_client()
        r = c.post(
            "/api/token/user", {"username": "alice", "password": "alicepass123"}
        )
        r2 = c.post("/api/token/refresh", {"refresh_token": r.json["refresh_token"]})
        assert r2.status == 200 and "access_token" in r2.json

    def test_missing_token_is_401(self, srv, seeded):
        assert srv.test_client().get("/api/user").status == 401

    def test_node_token(self, srv, seeded):
        c, node = node_login(srv, seeded["api_keys"][0])
        assert node["id"] == seeded["nodes"][0]["id"]
        r = c.post("/api/token/node", {"api_key": "bogus"})
        assert r.status == 401


class TestPermissionMatrix:
    def test_researcher_cannot_create_users_or_orgs(self, srv, seeded):
        c = login(srv, "alice", "alicepass123")
        assert (
            c.post("/api/user", {"username": "eve", "password": "evepass1234"}).status
            == 403
        )
        assert c.post("/api/organization", {"name": "evil"}).status == 403

    def test_researcher_sees_only_own_collaboration(self, srv, seeded):
        root = seeded["client"]
        lone = root.post("/api/organization", {"name": "lone"}).json
        root.post("/api/collaboration", {"name": "other", "organization_ids": [lone["id"]]})
        c = login(srv, "alice", "alicepass123")
        names = {x["name"] for x in c.get("/api/collaboration").json["data"]}
        assert names == {"demo"}
        orgs = {x["name"] for x in c.get("/api/organization").json["data"]}
        assert orgs == {"hospital_a", "hospital_b"}

    def test_researcher_can_create_task_root_collab_only(self, srv, seeded):
        c = login(srv, "alice", "alicepass123")
        r = c.post(
            "/api/task",
            {
                "image": "v6-average-py",
                "method": "partial_average",
                "collaboration_id": seeded["collab"]["id"],
                "organizations": [{"id": seeded["orgs"][0]["id"], "input": "e30="}],
            },
        )
        assert r.status == 201, r

    def test_node_cannot_create_tasks(self, srv, seeded):
        c, _ = node_login(srv, seeded["api_keys"][0])
        r = c.post(
            "/api/task",
            {
                "image": "x",
                "collaboration_id": seeded["collab"]["id"],
                "organizations": [{"id": seeded["orgs"][0]["id"]}],
            },
        )
        assert r.status == 403

    def test_delete_requires_permission(self, srv, seeded):
        c = login(srv, "alice", "alicepass123")
        assert c.delete(f"/api/collaboration/{seeded['collab']['id']}").status == 403
        assert srv.test_client().delete("/api/user/1").status == 401


class TestTaskLifecycle:
    def _make_task(self, seeded, orgs=None):
        c = seeded["client"]
        targets = orgs if orgs is not None else [o["id"] for o in seeded["orgs"]]
        return c.post(
            "/api/task",
            {
                "name": "avg",
                "image": "v6-average-py",
                "method": "partial_average",
                "collaboration_id": seeded["collab"]["id"],
                "organizations": [{"id": i, "input": "input-" + str(i)} for i in targets],
            },
        ).json

    def test_fanout_creates_runs_and_events(self, srv, seeded):
        task = self._make_task(seeded)
        assert task["status"] == "pending"
        runs = seeded["client"].get(f"/api/task/{task['id']}/run").json["data"]
        assert len(runs) == 2
        # node sees a task-created event in its room
        c, node = node_login(srv, seeded["api_keys"][0])
        evs = c.get("/api/event?since=0").json["data"]
        names = [e["name"] for e in evs]
        assert "task-created" in names

    def test_node_executes_and_patches(self, srv, seeded):
        task = self._make_task(seeded)
        c, node = node_login(srv, seeded["api_keys"][0])
        my_runs = [
            r
            for r in c.get(f"/api/run?task_id={task['id']}").json["data"]
            if r["organization"]["id"] == node["organization"]["id"]
        ]
        assert len(my_runs) == 1 and my_runs[0]["input"].startswith("input-")
        rid = my_runs[0]["id"]
        assert c.patch(f"/api/run/{rid}", {"status": "active"}).status == 200
        r = c.patch(
            f"/api/run/{rid}", {"status": "completed", "result": "sum=42"}
        )
        assert r.status == 200
        got = seeded["client"].get(f"/api/run/{rid}").json
        assert got["status"] == "completed" and got["result"] == "sum=42"

    def test_node_cannot_patch_other_orgs_run(self, srv, seeded):
        task = self._make_task(seeded)
        c, node = node_login(srv, seeded["api_keys"][0])
        other = [
            r
            for r in c.get(f"/api/run?task_id={task['id']}").json["data"]
            if r["organization"]["id"] != node["organization"]["id"]
        ]
        # node only sees its own runs in the list
        assert not other
        all_runs = seeded["client"].get(f"/api/run?task_id={task['id']}").json["data"]
        foreign = next(
            r for r in all_runs
            if r["organization"]["id"] != node["organization"]["id"]
        )
        assert c.patch(f"/api/run/{foreign['id']}", {"status": "active"}).status == 403

    def test_kill_task(self, srv, seeded):
        task = self._make_task(seeded)
        r = seeded["client"].post("/api/kill/task", {"task_id": task["id"]})
        assert r.status == 200 and len(r.json["killed_runs"]) == 2
        from vantage6_tpu_torch.common.enums import TaskStatus

        assert (
            seeded["client"].get(f"/api/task/{task['id']}").json["status"]
            == TaskStatus.KILLED.value
        )
        c, node = node_login(srv, seeded["api_keys"][0])
        evs = c.get("/api/event?since=0").json["data"]
        assert any(e["name"] == "kill-task" for e in evs)

    def test_terminal_status_is_immutable(self, srv, seeded):
        """A node finishing late must not overwrite KILLED (409)."""
        task = self._make_task(seeded)
        seeded["client"].post("/api/kill/task", {"task_id": task["id"]})
        c, node = node_login(srv, seeded["api_keys"][0])
        all_runs = seeded["client"].get(f"/api/run?task_id={task['id']}").json["data"]
        mine = next(
            r for r in all_runs
            if r["organization"]["id"] == node["organization"]["id"]
        )
        r = c.patch(
            f"/api/run/{mine['id']}", {"status": "completed", "result": "late"}
        )
        assert r.status == 409
        got = seeded["client"].get(f"/api/run/{mine['id']}").json
        assert got["status"] == "killed by user" and got["result"] != "late"

    def test_run_status_filter(self, srv, seeded):
        self._make_task(seeded)
        c = seeded["client"]
        pending = c.get("/api/run?status=pending").json["data"]
        assert pending and all(r["status"] == "pending" for r in pending)
        assert c.get("/api/run?status=completed").json["data"] == []

    def test_container_token_and_subtask(self, srv, seeded):
        task = self._make_task(seeded)
        nc, node = node_login(srv, seeded["api_keys"][0])
        r = nc.post(
            "/api/token/container",
            {"task_id": task["id"], "image": "v6-average-py"},
        )
        assert r.status == 200
        cc = srv.test_client()
        cc.token = r.json["container_token"]
        # the container creates a subtask at the OTHER org
        sub = cc.post(
            "/api/task",
            {
                "image": "v6-average-py",
                "method": "partial_average",
                "collaboration_id": seeded["collab"]["id"],
                "organizations": [{"id": seeded["orgs"][1]["id"], "input": "x"}],
            },
        )
        assert sub.status == 201, sub
        assert sub.json["parent"]["id"] == task["id"]
        assert sub.json["job_id"] == task["job_id"]
        # ... but not with a different image
        evil = cc.post(
            "/api/task",
            {
                "image": "other-image",
                "collaboration_id": seeded["collab"]["id"],
                "organizations": [{"id": seeded["orgs"][1]["id"]}],
            },
        )
        assert evil.status == 403

    def test_task_to_wrong_org_rejected(self, srv, seeded):
        c = seeded["client"]
        outsider = c.post("/api/organization", {"name": "outsider"}).json
        r = c.post(
            "/api/task",
            {
                "image": "x",
                "collaboration_id": seeded["collab"]["id"],
                "organizations": [{"id": outsider["id"]}],
            },
        )
        assert r.status == 400

    def test_study_scoping(self, srv, seeded):
        c = seeded["client"]
        study = c.post(
            "/api/study",
            {
                "name": "sub",
                "collaboration_id": seeded["collab"]["id"],
                "organization_ids": [seeded["orgs"][0]["id"]],
            },
        ).json
        # task in study at a non-member org fails
        r = c.post(
            "/api/task",
            {
                "image": "x",
                "collaboration_id": seeded["collab"]["id"],
                "study_id": study["id"],
                "organizations": [{"id": seeded["orgs"][1]["id"]}],
            },
        )
        assert r.status == 400
        r = c.post(
            "/api/task",
            {
                "image": "x",
                "collaboration_id": seeded["collab"]["id"],
                "study_id": study["id"],
                "organizations": [{"id": seeded["orgs"][0]["id"]}],
            },
        )
        assert r.status == 201


class TestNodeLifecycle:
    def test_api_key_shown_once_and_duplicate_rejected(self, srv, seeded):
        c = seeded["client"]
        listed = c.get("/api/node").json["data"]
        assert all("api_key" not in n for n in listed)
        dup = c.post(
            "/api/node",
            {
                "organization_id": seeded["orgs"][0]["id"],
                "collaboration_id": seeded["collab"]["id"],
            },
        )
        assert dup.status == 409

    def test_online_offline_events(self, srv, seeded):
        c, node = node_login(srv, seeded["api_keys"][0])
        r = c.patch(f"/api/node/{node['id']}", {"status": "online"})
        assert r.status == 200 and r.json["status"] == "online"
        # researcher in the collaboration sees the event
        ac = login(srv, "alice", "alicepass123")
        evs = ac.get("/api/event?since=0").json["data"]
        assert any(e["name"] == "node-online" for e in evs)

    def test_ping_updates_last_seen(self, srv, seeded):
        c, node = node_login(srv, seeded["api_keys"][0])
        assert c.post("/api/ping").status == 200
        got = seeded["client"].get(f"/api/node/{node['id']}").json
        assert got["last_seen_at"] is not None


class TestEventCursor:
    def test_cursor_catchup_is_room_scoped(self, srv, seeded):
        root = seeded["client"]
        # create second collaboration with its own node
        lone = root.post("/api/organization", {"name": "lone"}).json
        collab2 = root.post(
            "/api/collaboration", {"name": "c2", "organization_ids": [lone["id"]]}
        ).json
        n2 = root.post(
            "/api/node",
            {"organization_id": lone["id"], "collaboration_id": collab2["id"]},
        ).json
        key2 = n2["api_key"]
        # activity in collab 1
        root.post(
            "/api/task",
            {
                "image": "x",
                "collaboration_id": seeded["collab"]["id"],
                "organizations": [{"id": seeded["orgs"][0]["id"]}],
            },
        )
        c2, _ = node_login(srv, key2)
        evs = c2.get("/api/event?since=0").json["data"]
        assert evs == []  # nothing from the other collaboration's rooms

    def test_validation_errors_are_400(self, srv, seeded):
        c = seeded["client"]
        r = c.post("/api/task", {"collaboration_id": seeded["collab"]["id"]})
        assert r.status == 400  # missing image/organizations
        r = c.post("/api/user", {"username": "u", "password": "short"})
        assert r.status == 400


class TestSecurityRegressions:
    """Regressions for review findings: escalation, disclosure, 500s."""

    def test_role_grant_escalation_blocked(self, srv, seeded):
        root = seeded["client"]
        roles = root.get("/api/role").json["data"]
        root_role = next(r for r in roles if r["name"] == "Root")
        org_admin = next(r for r in roles if r["name"] == "Organization Admin")
        # an org admin may not mint users with roles beyond their own rules
        admin = root.post(
            "/api/user",
            {
                "username": "admin_a",
                "password": "adminpass123",
                "organization_id": seeded["orgs"][0]["id"],
                "roles": [org_admin["id"]],
            },
        ).json
        c = login(srv, "admin_a", "adminpass123")
        r = c.post(
            "/api/user",
            {
                "username": "sneaky",
                "password": "sneakypass123",
                "organization_id": seeded["orgs"][0]["id"],
                "roles": [root_role["id"]],
            },
        )
        assert r.status == 403
        # nor self-assign Root via PATCH
        r = c.patch(f"/api/user/{admin['id']}", {"roles": [root_role["id"]]})
        assert r.status == 403

    def test_node_task_runs_scoped_to_own_org(self, srv, seeded):
        task = seeded["client"].post(
            "/api/task",
            {
                "image": "x",
                "collaboration_id": seeded["collab"]["id"],
                "organizations": [
                    {"id": o["id"], "input": f"secret-{o['id']}"}
                    for o in seeded["orgs"]
                ],
            },
        ).json
        c, node = node_login(srv, seeded["api_keys"][0])
        runs = c.get(f"/api/task/{task['id']}/run").json["data"]
        assert len(runs) == 1
        assert runs[0]["organization"]["id"] == node["organization"]["id"]

    def test_garbage_token_is_401_not_500(self, srv, seeded):
        c = srv.test_client()
        for bad in ("a.b.$$$", "x", "..", "a.b"):
            assert c.get("/api/user", token=bad).status == 401

    def test_container_of_deleted_task_gets_401(self, srv, seeded):
        task = seeded["client"].post(
            "/api/task",
            {
                "image": "img",
                "collaboration_id": seeded["collab"]["id"],
                "organizations": [{"id": seeded["orgs"][0]["id"]}],
            },
        ).json
        nc, _ = node_login(srv, seeded["api_keys"][0])
        ct = nc.post(
            "/api/token/container", {"task_id": task["id"], "image": "img"}
        ).json["container_token"]
        seeded["client"].delete(f"/api/task/{task['id']}")
        cc = srv.test_client()
        cc.token = ct
        assert cc.get("/api/organization").status == 401
        assert cc.get("/api/event").status == 401

    def test_node_cannot_delete_itself(self, srv, seeded):
        c, node = node_login(srv, seeded["api_keys"][0])
        assert c.delete(f"/api/node/{node['id']}").status == 403
        assert seeded["client"].get(f"/api/node/{node['id']}").status == 200

    def test_port_listing_scoped(self, srv, seeded):
        root = seeded["client"]
        task = root.post(
            "/api/task",
            {
                "image": "x",
                "collaboration_id": seeded["collab"]["id"],
                "organizations": [{"id": seeded["orgs"][0]["id"]}],
            },
        ).json
        nc, node = node_login(srv, seeded["api_keys"][0])
        run = nc.get(f"/api/run?task_id={task['id']}").json["data"][0]
        nc.post("/api/port", {"run_id": run["id"], "port": 8080, "label": "vpn"})
        # a node in an unrelated collaboration sees nothing
        lone = root.post("/api/organization", {"name": "lone2"}).json
        c2 = root.post(
            "/api/collaboration", {"name": "c3", "organization_ids": [lone["id"]]}
        ).json
        n2 = root.post(
            "/api/node",
            {"organization_id": lone["id"], "collaboration_id": c2["id"]},
        ).json
        other, _ = node_login(srv, n2["api_key"])
        assert other.get("/api/port").json["data"] == []
        assert len(nc.get("/api/port").json["data"]) == 1

    def test_double_init_raises(self, srv):
        import pytest as _pytest

        from vantage6_tpu_torch.server import models as models_mod

        with _pytest.raises(RuntimeError, match="already bound"):
            models_mod.init("sqlite:///:memory:")


class TestContainerJobScoping:
    """Regression (ADVICE r1): a container token is confined to its own task
    tree (job) — a malicious algorithm must not enumerate inputs/results of
    other tasks in the collaboration — and to its own collaboration's
    collaboration/node metadata."""

    def _mk_task(self, seeded):
        c = seeded["client"]
        return c.post(
            "/api/task",
            {
                "name": "avg",
                "image": "v6-average-py",
                "method": "partial_average",
                "collaboration_id": seeded["collab"]["id"],
                "organizations": [
                    {"id": o["id"], "input": "secret-" + o["name"]}
                    for o in seeded["orgs"]
                ],
            },
        ).json

    def _container(self, srv, seeded, task):
        nc, _ = node_login(srv, seeded["api_keys"][0])
        r = nc.post(
            "/api/token/container",
            {"task_id": task["id"], "image": task["image"]},
        )
        assert r.status == 200, r
        cc = srv.test_client()
        cc.token = r.json["container_token"]
        return cc

    def test_container_confined_to_own_job(self, srv, seeded):
        t_own = self._mk_task(seeded)
        t_other = self._mk_task(seeded)  # same collaboration, different job
        assert t_own["job_id"] != t_other["job_id"]
        cc = self._container(srv, seeded, t_own)

        # task list: own job only
        ids = {t["id"] for t in cc.get("/api/task").json["data"]}
        assert t_own["id"] in ids and t_other["id"] not in ids
        # task by id
        assert cc.get(f"/api/task/{t_own['id']}").status == 200
        assert cc.get(f"/api/task/{t_other['id']}").status == 403
        # run list: no runs of the other job (whose inputs are secrets)
        own_runs = cc.get("/api/run").json["data"]
        other_run_ids = {
            r["id"]
            for r in seeded["client"]
            .get(f"/api/task/{t_other['id']}/run")
            .json["data"]
        }
        assert other_run_ids
        assert not other_run_ids & {r["id"] for r in own_runs}
        # runs of the other task, by task filter and by id
        assert cc.get(f"/api/task/{t_other['id']}/run").status == 403
        assert cc.get(f"/api/run/{next(iter(other_run_ids))}").status == 403

    def test_container_subtask_stays_visible(self, srv, seeded):
        t_own = self._mk_task(seeded)
        cc = self._container(srv, seeded, t_own)
        sub = cc.post(
            "/api/task",
            {
                "image": "v6-average-py",
                "method": "partial_average",
                "collaboration_id": seeded["collab"]["id"],
                "organizations": [{"id": seeded["orgs"][1]["id"], "input": "x"}],
            },
        ).json
        assert sub["job_id"] == t_own["job_id"]
        ids = {t["id"] for t in cc.get("/api/task").json["data"]}
        assert sub["id"] in ids
        assert cc.get(f"/api/task/{sub['id']}/run").status == 200

    def test_container_collab_and_node_metadata_scoped(self, srv, seeded):
        c = seeded["client"]
        org_c = c.post("/api/organization", {"name": "hospital_c"}).json
        collab2 = c.post(
            "/api/collaboration",
            {"name": "other", "organization_ids": [org_c["id"]]},
        ).json
        node2 = c.post(
            "/api/node",
            {"organization_id": org_c["id"], "collaboration_id": collab2["id"]},
        ).json
        t_own = self._mk_task(seeded)
        cc = self._container(srv, seeded, t_own)
        assert cc.get(f"/api/collaboration/{seeded['collab']['id']}").status == 200
        assert cc.get(f"/api/collaboration/{collab2['id']}").status == 403
        assert cc.get(f"/api/node/{seeded['nodes'][0]['id']}").status == 200
        assert cc.get(f"/api/node/{node2['id']}").status == 403

    def test_run_patch_rejects_unknown_status(self, srv, seeded):
        """Regression (ADVICE r1): arbitrary status strings must 400, or a
        later TaskStatus(run.status) 500s and Task.status() misclassifies."""
        t = self._mk_task(seeded)
        nc, _ = node_login(srv, seeded["api_keys"][0])
        rid = nc.get(f"/api/run?task_id={t['id']}").json["data"][0]["id"]
        assert nc.patch(f"/api/run/{rid}", {"status": "bogus"}).status == 400
        assert nc.patch(f"/api/run/{rid}", {"status": "active"}).status == 200


class TestSessionReadiness:
    """A session dataframe is 'ready' only once EVERY node of its
    (re)building task has completed — the first reporter must not flip it
    while peers are still extracting."""

    def test_ready_requires_all_runs_completed(self, srv, seeded):
        from vantage6_tpu_torch.common.enums import TaskStatus

        c = seeded["client"]
        collab = seeded["collab"]
        s = c.post(
            "/api/session",
            {"name": "rd", "collaboration_id": collab["id"]},
        ).json
        task = c.post(
            "/api/task",
            {
                "image": "algo",
                "collaboration_id": collab["id"],
                "organizations": [
                    {"id": o["id"], "input": ""} for o in seeded["orgs"]
                ],
                "session_id": s["id"],
                "store_as": "prep",
            },
        ).json
        assert task["store_as"] == "prep"
        runs = [
            m.TaskRun.get(rid)
            for rid in [
                r["id"]
                for r in c.get(f"/api/task/{task['id']}/run").json["data"]
            ]
        ]
        n0, _ = node_login(srv, seeded["api_keys"][0])
        n1, _ = node_login(srv, seeded["api_keys"][1])

        # node 0 completes ITS run and reports — peers still pending
        runs[0].status = TaskStatus.COMPLETED.value
        runs[0].save()
        r = n0.open(
            "PATCH",
            f"/api/session/{s['id']}/dataframe/prep",
            {"ready": True, "columns": [{"name": "age", "dtype": "f8"}]},
        )
        assert r.status == 200
        assert r.json["ready"] is False  # peer run not finished

        # node 1 completes and reports — NOW it flips
        runs[1].status = TaskStatus.COMPLETED.value
        runs[1].save()
        r = n1.open(
            "PATCH", f"/api/session/{s['id']}/dataframe/prep",
            {"ready": True},
        )
        assert r.json["ready"] is True

        # users may not report dataframe state
        r = c.open(
            "PATCH", f"/api/session/{s['id']}/dataframe/prep",
            {"ready": True},
        )
        assert r.status == 403
