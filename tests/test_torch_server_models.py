"""Tests for the server control plane: ORM, RBAC matrix, auth tokens.

The port's copy of ``tests/test_server_models.py`` with its imports switched to
``vantage6_tpu_torch``.
"""
import time

import pytest

from vantage6_tpu_torch.server import models as m
from vantage6_tpu_torch.server.auth import (
    AuthError,
    TokenAuthority,
    decode_jwt,
    encode_jwt,
    generate_totp_secret,
    totp_code,
    verify_totp,
)
from vantage6_tpu_torch.server.db import Model
from vantage6_tpu_torch.server.permission import Operation, PermissionManager, Scope


@pytest.fixture()
def db():
    database = m.init("sqlite:///:memory:")
    yield database
    database.close()
    Model.db = None


@pytest.fixture()
def seeded(db):
    """Two orgs in one collaboration, a root user and a researcher."""
    org_a = m.Organization(name="org_a").save()
    org_b = m.Organization(name="org_b").save()
    org_c = m.Organization(name="org_c").save()  # outside the collaboration
    collab = m.Collaboration(name="demo", encrypted=False).save()
    collab.add_organization(org_a)
    collab.add_organization(org_b)
    pm = PermissionManager()
    roles = pm.ensure_default_roles()
    root = m.User(username="root", organization_id=org_a.id)
    root.set_password("rootpw")
    root.save()
    root.add_role(roles["Root"])
    researcher = m.User(username="alice", organization_id=org_a.id)
    researcher.set_password("alicepw")
    researcher.save()
    researcher.add_role(roles["Researcher"])
    return {
        "orgs": [org_a, org_b, org_c],
        "collab": collab,
        "pm": pm,
        "root": root,
        "researcher": researcher,
        "roles": roles,
    }


class TestORM:
    def test_crud_roundtrip(self, db):
        org = m.Organization(name="x", country="NL").save()
        assert org.id is not None
        got = m.Organization.get(org.id)
        assert got.name == "x" and got.country == "NL"
        got.name = "y"
        got.save()
        assert m.Organization.get(org.id).name == "y"
        got.delete()
        assert m.Organization.get(org.id) is None

    def test_json_and_bool_columns(self, db):
        c = m.Collaboration(name="c", encrypted=True).save()
        assert m.Collaboration.get(c.id).encrypted is True
        t = m.Task(
            name="t",
            image="avg",
            method="partial",
            collaboration_id=c.id,
            databases=[{"label": "default"}],
        ).save()
        assert m.Task.get(t.id).databases == [{"label": "default"}]

    def test_list_filters_and_pagination(self, db):
        for i in range(10):
            m.Organization(name=f"org{i}", country="NL" if i % 2 else "DE").save()
        nl = m.Organization.list(country="NL")
        assert len(nl) == 5
        page = m.Organization.list(limit=3, offset=3)
        assert [o.name for o in page] == ["org3", "org4", "org5"]
        assert m.Organization.count(country="DE") == 5

    def test_schema_migration_adds_columns(self, db):
        import sqlite3

        if tuple(map(int, sqlite3.sqlite_version.split("."))) < (3, 35):
            pytest.skip("ALTER TABLE ... DROP COLUMN needs sqlite >= 3.35")
        # simulate an old table missing a column, then re-ensure
        db.execute("ALTER TABLE organization DROP COLUMN domain")
        m.Organization.ensure_schema()
        m.Organization(name="z", domain="z.org").save()
        assert m.Organization.first(name="z").domain == "z.org"

    def test_unknown_field_rejected(self, db):
        with pytest.raises(TypeError, match="unknown fields"):
            m.Organization(name="x", nope=1)

    def test_task_status_rollup(self, db):
        t = m.Task(name="t", image="i", method="f", collaboration_id=1).save()
        assert t.status() == "pending"
        r1 = m.TaskRun(task_id=t.id, organization_id=1, status="completed").save()
        m.TaskRun(task_id=t.id, organization_id=2, status="active").save()
        assert t.status() == "active"
        r3 = m.TaskRun(task_id=t.id, organization_id=3, status="crashed").save()
        assert t.status() == "crashed"
        r3.delete()
        r2 = m.TaskRun.first(task_id=t.id, status="active")
        r2.status = "completed"
        r2.save()
        assert t.status() == "completed"
        assert r1.id in [r.id for r in t.runs()]


class TestRBAC:
    def test_rule_matrix_seeded_once(self, seeded):
        n = m.Rule.count()
        PermissionManager()  # idempotent re-seed
        assert m.Rule.count() == n

    def test_root_has_global_scope(self, seeded):
        pm, root = seeded["pm"], seeded["root"]
        assert pm.user_scope(root, "task", Operation.DELETE) == Scope.GLOBAL
        assert pm.allowed(root, "user", Operation.CREATE, organization_id=999)

    def test_researcher_matrix(self, seeded):
        pm, alice = seeded["pm"], seeded["researcher"]
        collab = seeded["collab"]
        org_a, org_b, org_c = seeded["orgs"]
        # may create tasks in own collaboration
        assert pm.allowed(
            alice, "task", Operation.CREATE, collaboration_id=collab.id
        )
        # may NOT create users at all
        assert pm.user_scope(alice, "user", Operation.CREATE) is None
        # may view orgs inside the collaboration, not outside
        assert pm.allowed(
            alice, "organization", Operation.VIEW, collaboration_id=collab.id
        )
        # collaboration without alice's org: denied
        other = m.Collaboration(name="other").save()
        other.add_organization(org_c)
        assert not pm.allowed(
            alice, "task", Operation.CREATE, collaboration_id=other.id
        )

    def test_own_scope(self, seeded):
        pm = seeded["pm"]
        org_a = seeded["orgs"][0]
        bob = m.User(username="bob", organization_id=org_a.id)
        bob.set_password("pw")
        bob.save()
        m.user_rule.add(bob.id, pm.rule("task", Scope.OWN, Operation.VIEW))
        assert pm.allowed(bob, "task", Operation.VIEW, owner_id=bob.id)
        assert not pm.allowed(bob, "task", Operation.VIEW, owner_id=seeded["root"].id)

    def test_org_admin_cannot_cross_org(self, seeded):
        pm, roles = seeded["pm"], seeded["roles"]
        org_a, org_b, _ = seeded["orgs"]
        admin = m.User(username="admin_b", organization_id=org_b.id)
        admin.set_password("pw")
        admin.save()
        admin.add_role(roles["Organization Admin"])
        assert pm.allowed(admin, "user", Operation.CREATE, organization_id=org_b.id)
        assert not pm.allowed(admin, "user", Operation.CREATE, organization_id=org_a.id)


class TestAuthPrimitives:
    def test_password_hashing(self, db):
        u = m.User(username="u", organization_id=1)
        u.set_password("s3cret")
        u.save()
        assert u.check_password("s3cret")
        assert not u.check_password("wrong")
        assert "s3cret" not in (u.password_hash or "")

    def test_lockout_after_failed_attempts(self, db):
        u = m.User(username="u", organization_id=1)
        u.set_password("pw")
        u.save()
        for _ in range(m.User.MAX_FAILED_ATTEMPTS):
            u.record_login(False)
        assert u.is_locked_out()
        u.record_login(True)
        assert not u.is_locked_out()

    def test_jwt_roundtrip_and_tamper(self):
        token = encode_jwt({"sub": {"type": "user", "id": 1}}, "secret")
        assert decode_jwt(token, "secret")["sub"]["id"] == 1
        with pytest.raises(AuthError):
            decode_jwt(token, "othersecret")
        with pytest.raises(AuthError):
            decode_jwt(token[:-4] + "AAAA", "secret")

    def test_jwt_expiry(self):
        token = encode_jwt({"sub": {}, "exp": time.time() - 1}, "s")
        with pytest.raises(AuthError, match="expired"):
            decode_jwt(token, "s")

    def test_token_authority_flow(self):
        ta = TokenAuthority("srv-secret")
        pair = ta.user_tokens(7)
        sub = ta.identity(pair["access_token"])
        assert sub == {"type": "user", "id": 7}
        with pytest.raises(AuthError):
            ta.identity(pair["refresh_token"])  # wrong use
        refreshed = ta.refresh(pair["refresh_token"])
        assert ta.identity(refreshed["access_token"])["id"] == 7

    def test_container_token_not_refreshable(self):
        ta = TokenAuthority("s")
        tok = ta.container_token(node_id=1, task_id=2, image="avg", organization_id=3)
        sub = ta.identity(tok)
        assert sub["type"] == "container" and sub["task_id"] == 2
        with pytest.raises(AuthError):
            ta.refresh(tok)

    def test_totp(self):
        secret = generate_totp_secret()
        code = totp_code(secret)
        assert verify_totp(secret, code)
        assert verify_totp(secret, totp_code(secret, time.time() - 30))  # skew
        assert not verify_totp(secret, "000000") or code == "000000"

    def test_node_api_key(self, db):
        node = m.Node(name="n", organization_id=1, collaboration_id=1)
        key = m.Node.generate_api_key()
        node.set_api_key(key)
        node.save()
        assert m.Node.by_api_key(key).id == node.id
        assert m.Node.by_api_key("wrong") is None
