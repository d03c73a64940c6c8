"""Web UI (SURVEY.md §2 item 27) of the port's server: the buildless SPA
carries the admin surface (organizations / users / roles CRUD) and store
browsing — served markup + every API endpoint the page's JS calls.

The port's copy of ``tests/test_ui.py`` without the cases that need the
algorithm store (``test_wizard_arg_types_covered`` and
``TestStoreReviewWorkflowViaProxy``), which is not ported yet."""
import re

import pytest

from vantage6_tpu_torch.server.app import ServerApp


@pytest.fixture()
def srv():
    app = ServerApp()
    app.ensure_root(password="rootpass123")
    yield app
    app.close()


def _login(srv):
    c = srv.test_client()
    r = c.post("/api/token/user", {"username": "root", "password": "rootpass123"})
    c.token = r.json["access_token"]
    return c


class TestPage:
    def test_admin_and_store_markup_present(self, srv):
        page = srv.test_client().get("/").body.decode()
        for anchor in (
            'id="tab_admin"', 'id="tab_store"', 'id="a_orgs"', 'id="a_users"',
            'id="a_roles"', 'id="u_create"', 'id="r_create"', 'id="o_create"',
            'id="s_algos"', "data-tab=", "refreshAdmin", "refreshStore",
        ):
            assert anchor in page, anchor

    def test_every_js_api_endpoint_exists(self, srv):
        """Each `api("METHOD", "path")` call in the page resolves to a live
        route — markup can't drift ahead of the API."""
        page = srv.test_client().get("/").body.decode()
        c = _login(srv)
        calls = set(re.findall(
            r'api\("(GET|POST|PATCH|DELETE)",\s*[`"]([\w/?=&]+)', page
        ))
        assert len(calls) >= 8
        for method, path in calls:
            path = path.split("?")[0]
            if method != "GET" or path.endswith("/"):
                continue  # mutating calls need bodies, dynamic segments
                # (`task/${id}`) truncate at the interpolation — GETs on
                # static paths prove the routing
            if path.startswith("store/"):
                continue  # legitimately 404s when no store is linked
                # (covered by test_store.TestServerStoreProxy and
                # TestStoreReviewWorkflowViaProxy)
            r = c.get("/api/" + path)
            assert r.status != 404, (method, path, r.status)


class TestAdminScreensAPI:
    """The endpoints behind each admin screen, exercised as the UI uses
    them (these are the screens' API contracts)."""

    def test_organization_screen(self, srv):
        c = _login(srv)
        r = c.post("/api/organization", {"name": "ui_org", "country": "nl"})
        assert r.status == 201
        rows = c.get("/api/organization").json["data"]
        assert any(
            o["name"] == "ui_org" and o["country"] == "nl" for o in rows
        )

    def test_user_screen_create_list_delete(self, srv):
        c = _login(srv)
        org = c.post("/api/organization", {"name": "u_org"}).json
        role = next(
            r for r in c.get("/api/role").json["data"]
            if r["name"] == "Researcher"
        )
        made = c.post(
            "/api/user",
            {
                "username": "ui_user",
                "password": "uiuserpass12",
                "email": "ui@example.org",
                "organization_id": org["id"],
                "roles": [role["id"]],
            },
        )
        assert made.status == 201
        rows = c.get("/api/user").json["data"]
        row = next(u for u in rows if u["username"] == "ui_user")
        assert row["roles"] == [role["id"]]
        assert c.open("DELETE", f"/api/user/{row['id']}").status == 204
        assert not any(
            u["username"] == "ui_user"
            for u in c.get("/api/user").json["data"]
        )

    def test_role_screen_create_with_rules(self, srv):
        c = _login(srv)
        rules = c.get("/api/rule?per_page=500").json["data"]
        pick = [r["id"] for r in rules if r["name"] == "task"][:2]
        assert pick
        made = c.post(
            "/api/role",
            {"name": "ui_role", "organization_id": None, "rules": pick},
        )
        assert made.status == 201
        got = next(
            r for r in c.get("/api/role").json["data"]
            if r["name"] == "ui_role"
        )
        assert sorted(got["rules"]) == sorted(pick)


class TestWizardStudySessionScreens:
    """Round-4 UI surface: the store-metadata task wizard, study screens
    and session screens — markup + the API contracts the page JS drives."""

    def test_markup_present(self, srv):
        page = srv.test_client().get("/").body.decode()
        for anchor in (
            'id="t_algo"', 'id="t_wizard"', 'id="w_function"', 'id="w_args"',
            'id="t_study"', 'id="t_session"', 'id="t_store_as"',
            'id="studies"', 'id="st_create"', 'id="st_orgs"',
            'id="sessions"', 'id="se_create"', 'id="se_scope"',
            "loadWizardAlgos", "wizardKwargs", "renderWizardArgs",
            "deleteSession", "killTask", 'id="s_detailpanel"',
            "showStoreAlgo", 'id="pw_change"', "password/change",
        ):
            assert anchor in page, anchor

    def test_kill_flow(self, srv):
        """The kill button's endpoint, driven as the page JS does."""
        c = _login(srv)
        org = c.post("/api/organization", {"name": "kill_org"}).json
        collab = c.post(
            "/api/collaboration",
            {"name": "kill_collab", "organization_ids": [org["id"]]},
        ).json
        c.post(
            "/api/node",
            {"organization_id": org["id"],
             "collaboration_id": collab["id"]},
        )
        import base64
        import json as _json

        blob = base64.b64encode(_json.dumps({"method": "m"}).encode()).decode()
        task = c.post(
            "/api/task",
            {"name": "kill_me", "image": "x", "method": "m",
             "collaboration_id": collab["id"],
             "organizations": [{"id": org["id"], "input": blob}]},
        ).json
        r = c.post("/api/kill/task", {"task_id": task["id"]})
        assert r.status == 200
        got = c.get(f"/api/task/{task['id']}").json
        assert got["status"] == "killed by user"

    def test_study_screen_flow(self, srv):
        c = _login(srv)
        orgs = [
            c.post("/api/organization", {"name": f"st_org{i}"}).json
            for i in range(3)
        ]
        collab = c.post(
            "/api/collaboration",
            {"name": "st_collab",
             "organization_ids": [o["id"] for o in orgs]},
        ).json
        # page payload shape: name, collaboration_id, organization_ids
        made = c.post(
            "/api/study",
            {"name": "ui_study", "collaboration_id": collab["id"],
             "organization_ids": [orgs[0]["id"], orgs[1]["id"]]},
        )
        assert made.status == 201
        # the table renderer reads id/name/collaboration/organizations
        row = next(
            s for s in c.get("/api/study").json["data"]
            if s["name"] == "ui_study"
        )
        assert row["collaboration"] == collab["id"]
        assert sorted(row["organizations"]) == sorted(
            [orgs[0]["id"], orgs[1]["id"]]
        )
        # the task form targets the STUDY's organizations
        got = c.get(f"/api/study/{row['id']}").json
        assert sorted(got["organizations"]) == sorted(row["organizations"])

    def test_session_screen_flow(self, srv):
        c = _login(srv)
        org = c.post("/api/organization", {"name": "se_org"}).json
        collab = c.post(
            "/api/collaboration",
            {"name": "se_collab", "organization_ids": [org["id"]]},
        ).json
        made = c.post(
            "/api/session",
            {"name": "ui_session", "collaboration_id": collab["id"],
             "scope": "collaboration"},
        )
        assert made.status == 201
        # renderer reads id/name/collaboration.id/scope/dataframes
        row = next(
            s for s in c.get("/api/session").json["data"]
            if s["name"] == "ui_session"
        )
        assert row["collaboration"]["id"] == collab["id"]
        assert row["scope"] == "collaboration"
        assert row["dataframes"] == []
        assert c.open(
            "DELETE", f"/api/session/{row['id']}"
        ).status in (200, 204)
        assert not any(
            s["name"] == "ui_session"
            for s in c.get("/api/session").json["data"]
        )


class TestJSContractDrift:
    """VERDICT r2 weak #8: drive the CRUD flow with the payload shapes
    EXTRACTED from the rendered page's JS — if the page's api("POST", ...)
    object keys drift from what the API accepts, this fails, not a user."""

    def _extract_post_keys(self, page: str, path: str) -> set[str]:
        m = re.search(
            r'api\("POST",\s*"%s",?\s*\n?\s*\{(.*?)\}\);' % path,
            page,
            re.S,
        )
        assert m, f"page JS has no POST {path} call"
        return set(re.findall(r"(\w+):", m.group(1)))

    def test_create_flows_use_page_payload_shapes(self, srv):
        page = srv.test_client().get("/").body.decode()
        c = _login(srv)

        org_keys = self._extract_post_keys(page, "organization")
        assert "name" in org_keys
        values = {"name": "drift_org", "country": "nl"}
        assert org_keys <= set(values), org_keys
        r = c.post("/api/organization", {k: values[k] for k in org_keys})
        assert r.status == 201, r.json
        org_id = r.json["id"]
        assert any(
            o["id"] == org_id for o in c.get("/api/organization").json["data"]
        )

        user_keys = self._extract_post_keys(page, "user")
        role = next(
            x for x in c.get("/api/role").json["data"]
            if x["name"] == "Researcher"
        )
        values = {
            "username": "drift_user",
            "password": "driftpass123",
            "email": None,
            "organization_id": org_id,
            "roles": [role["id"]],
        }
        assert user_keys <= set(values), user_keys
        r = c.post("/api/user", {k: values[k] for k in user_keys})
        assert r.status == 201, r.json
        assert any(
            u["username"] == "drift_user"
            for u in c.get("/api/user").json["data"]
        )

        role_keys = self._extract_post_keys(page, "role")
        rules = [
            x["id"] for x in c.get("/api/rule?per_page=500").json["data"]
        ][:2]
        values = {"name": "drift_role", "organization_id": None,
                  "rules": rules}
        assert role_keys <= set(values), role_keys
        r = c.post("/api/role", {k: values[k] for k in role_keys})
        assert r.status == 201, r.json
        assert any(
            x["name"] == "drift_role" for x in c.get("/api/role").json["data"]
        )


class TestRound5Screens:
    """Round-5 UI surface (VERDICT r4 next #5): run-log viewer, rule-level
    role management, user role assignment, and the store review workflow
    driven through the server's authenticated same-origin proxy."""

    def test_markup_present(self, srv):
        page = srv.test_client().get("/").body.decode()
        for anchor in (
            'id="runlogpanel"', "showRunLog", 'id="rl_log"', 'id="rl_result"',
            'id="roledetail"', 'id="rd_save"', 'id="rd_delete"',
            'id="rd_edit_rules"', 'id="userdetail"', 'id="ud_save"',
            "showRole", "showUser",
            'id="s_status"', 'id="sa_submit"', 'id="sa_functions"',
            'id="s_d_reviews"', 'id="s_d_startreview"', "decideReview",
            "refreshStoreReviews",
        ):
            assert anchor in page, anchor

    def test_role_manage_flow(self, srv):
        """rd_save's contract: PATCH role/<id> replaces the rule set."""
        c = _login(srv)
        rules = c.get("/api/rule?per_page=500").json["data"]
        task_rules = [r["id"] for r in rules if r["name"] == "task"]
        node_rules = [r["id"] for r in rules if r["name"] == "node"]
        made = c.post(
            "/api/role",
            {"name": "r5_role", "organization_id": None,
             "rules": task_rules[:2]},
        ).json
        r = c.patch(f"/api/role/{made['id']}", {"rules": node_rules[:2]})
        assert r.status == 200, r.json
        got = c.get(f"/api/role/{made['id']}").json
        assert sorted(got["rules"]) == sorted(node_rules[:2])
        # rename, keep rules
        r = c.patch(f"/api/role/{made['id']}", {"name": "r5_renamed"})
        assert r.status == 200
        assert c.get(f"/api/role/{made['id']}").json["name"] == "r5_renamed"
        # a non-admin cannot edit a global role (rd_save surfaces the 403)
        org = c.post("/api/organization", {"name": "r5_org"}).json
        researcher = next(
            x for x in c.get("/api/role").json["data"]
            if x["name"] == "Researcher"
        )
        c.post("/api/user", {
            "username": "r5_user", "password": "r5userpass12",
            "organization_id": org["id"], "roles": [researcher["id"]],
        })
        c2 = srv.test_client()
        tok = c2.post("/api/token/user", {
            "username": "r5_user", "password": "r5userpass12",
        }).json["access_token"]
        c2.token = tok
        assert c2.patch(
            f"/api/role/{made['id']}", {"rules": task_rules[:1]}
        ).status == 403

    def test_user_role_reassign_flow(self, srv):
        """ud_save's contract: PATCH user/<id> {roles} replaces roles."""
        c = _login(srv)
        org = c.post("/api/organization", {"name": "ud_org"}).json
        roles = c.get("/api/role").json["data"]
        researcher = next(x for x in roles if x["name"] == "Researcher")
        viewer = next(
            (x for x in roles if x["name"] == "Viewer"), researcher
        )
        u = c.post("/api/user", {
            "username": "ud_user", "password": "uduserpass12",
            "organization_id": org["id"], "roles": [researcher["id"]],
        }).json
        r = c.patch(f"/api/user/{u['id']}", {"roles": [viewer["id"]]})
        assert r.status == 200, r.json
        assert c.get(f"/api/user/{u['id']}").json["roles"] == [viewer["id"]]
