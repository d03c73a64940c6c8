"""Account recovery (password + 2FA reset over emailed single-use tokens)
and versioned schema migrations (VERDICT r1 #6; SURVEY.md §2 items 7/8).

The port's copy of ``tests/test_recovery_migrations.py`` with its imports switched to
``vantage6_tpu_torch``.
"""
import sqlite3

import pytest

from vantage6_tpu_torch.server import migrations
from vantage6_tpu_torch.server import models as m
from vantage6_tpu_torch.server.app import ServerApp
from vantage6_tpu_torch.server.auth import totp_code
from vantage6_tpu_torch.server.db import Database


@pytest.fixture()
def srv():
    app = ServerApp()
    yield app
    app.close()


@pytest.fixture()
def seeded(srv):
    c = srv.test_client()
    srv.ensure_root(password="rootpass123")
    r = c.post("/api/token/user", {"username": "root", "password": "rootpass123"})
    c.token = r.json["access_token"]
    org = c.post("/api/organization", {"name": "org"}).json
    researcher = next(
        r for r in c.get("/api/role").json["data"] if r["name"] == "Researcher"
    )
    c.post(
        "/api/user",
        {
            "username": "erin",
            "password": "erinpass1234",
            "email": "erin@example.org",
            "organization_id": org["id"],
            "roles": [researcher["id"]],
        },
    )
    return {"client": c}


def _reset_token(srv):
    """Last mailed reset token (LogMailer records messages)."""
    body = srv.mailer.sent[-1].body
    return next(
        line for line in body.splitlines() if line.count(".") == 2 and len(line) > 40
    )


class TestPasswordReset:
    def test_lost_and_reset_flow(self, srv, seeded):
        c = srv.test_client()
        r = c.post("/api/recover/lost", {"username": "erin"})
        assert r.status == 200
        assert srv.mailer.sent[-1].to == "erin@example.org"
        token = _reset_token(srv)
        r = c.post(
            "/api/recover/reset",
            {"reset_token": token, "password": "brandnewpass1"},
        )
        assert r.status == 200
        # old password dead, new password works
        assert (
            c.post(
                "/api/token/user",
                {"username": "erin", "password": "erinpass1234"},
            ).status
            == 401
        )
        assert (
            c.post(
                "/api/token/user",
                {"username": "erin", "password": "brandnewpass1"},
            ).status
            == 200
        )

    def test_lookup_by_email(self, srv, seeded):
        c = srv.test_client()
        c.post("/api/recover/lost", {"email": "erin@example.org"})
        assert srv.mailer.sent[-1].to == "erin@example.org"

    def test_token_is_single_use(self, srv, seeded):
        c = srv.test_client()
        c.post("/api/recover/lost", {"username": "erin"})
        token = _reset_token(srv)
        assert (
            c.post(
                "/api/recover/reset",
                {"reset_token": token, "password": "firstreset12"},
            ).status
            == 200
        )
        r = c.post(
            "/api/recover/reset",
            {"reset_token": token, "password": "secondreset12"},
        )
        assert r.status == 401 and "used" in r.json["msg"]

    def test_unknown_account_not_revealed(self, srv, seeded):
        c = srv.test_client()
        n_before = len(srv.mailer.sent)
        r = c.post("/api/recover/lost", {"username": "nobody"})
        assert r.status == 200  # same answer as for a real account
        assert len(srv.mailer.sent) == n_before

    def test_garbage_token_rejected(self, srv, seeded):
        c = srv.test_client()
        r = c.post(
            "/api/recover/reset",
            {"reset_token": "a.b.c", "password": "whatever1234"},
        )
        assert r.status == 401

    def test_reset_clears_lockout(self, srv, seeded):
        c = srv.test_client()
        for _ in range(m.User.MAX_FAILED_ATTEMPTS):
            c.post("/api/token/user", {"username": "erin", "password": "bad!"})
        c.post("/api/recover/lost", {"username": "erin"})
        token = _reset_token(srv)
        c.post(
            "/api/recover/reset",
            {"reset_token": token, "password": "afterlock123"},
        )
        user = m.User.first(username="erin")
        assert not user.is_locked_out()


class TestPasswordChange:
    """Self-service /api/password/change: requires the CURRENT password
    even with a valid token (a stolen session must not take the account)."""

    def _login(self, srv, username, password):
        c = srv.test_client()
        r = c.post(
            "/api/token/user", {"username": username, "password": password}
        )
        assert r.status == 200, r.json
        c.token = r.json["access_token"]
        return c

    def test_change_and_relogin(self, srv, seeded):
        c = self._login(srv, "erin", "erinpass1234")
        r = c.post(
            "/api/password/change",
            {"current_password": "erinpass1234",
             "new_password": "brandnewpass1"},
        )
        assert r.status == 200
        # old password dead, new one works
        bad = srv.test_client().post(
            "/api/token/user",
            {"username": "erin", "password": "erinpass1234"},
        )
        assert bad.status == 401
        self._login(srv, "erin", "brandnewpass1")

    def test_change_evicts_all_sessions(self, srv, seeded):
        """A stolen session must not survive the victim's password change:
        user tokens carry a credential fingerprint, so BOTH the old access
        token and the old refresh token die the moment it rotates."""
        victim = self._login(srv, "erin", "erinpass1234")
        attacker = self._login(srv, "erin", "erinpass1234")  # stolen copy
        attacker_refresh = srv.test_client().post(
            "/api/token/user",
            {"username": "erin", "password": "erinpass1234"},
        ).json["refresh_token"]
        r = victim.post(
            "/api/password/change",
            {"current_password": "erinpass1234",
             "new_password": "brandnewpass1"},
        )
        assert r.status == 200
        # the attacker's ACCESS token is dead...
        got = attacker.get("/api/whoami")
        assert got.status == 401, got.json
        assert "superseded" in got.json["msg"]
        # ...and their REFRESH token cannot mint new ones
        ref = srv.test_client().post(
            "/api/token/refresh", {"refresh_token": attacker_refresh}
        )
        assert ref.status == 401
        # even the victim's own old token is dead; fresh login works
        assert victim.get("/api/whoami").status == 401
        self._login(srv, "erin", "brandnewpass1")

    def test_guessing_feeds_lockout(self, srv, seeded):
        """A token holder must not get a free password-guessing oracle:
        wrong current_password counts toward the login lockout."""
        c = self._login(srv, "erin", "erinpass1234")
        for _ in range(5):
            r = c.post(
                "/api/password/change",
                {"current_password": "wrong-guess-1",
                 "new_password": "whatever12345"},
            )
            assert r.status == 401
        locked = c.post(
            "/api/password/change",
            {"current_password": "erinpass1234",
             "new_password": "whatever12345"},
        )
        assert locked.status == 401
        assert "locked" in locked.json["msg"]

    def test_wrong_current_password_rejected(self, srv, seeded):
        c = self._login(srv, "erin", "erinpass1234")
        r = c.post(
            "/api/password/change",
            {"current_password": "guess-guess-1",
             "new_password": "brandnewpass1"},
        )
        assert r.status == 401
        self._login(srv, "erin", "erinpass1234")  # unchanged

    def test_short_new_password_rejected(self, srv, seeded):
        c = self._login(srv, "erin", "erinpass1234")
        r = c.post(
            "/api/password/change",
            {"current_password": "erinpass1234", "new_password": "short"},
        )
        assert r.status == 400

    def test_requires_auth(self, srv, seeded):
        r = srv.test_client().post(
            "/api/password/change",
            {"current_password": "x", "new_password": "longenough1"},
        )
        assert r.status == 401

    def test_client_sdk_method(self, srv, seeded):
        from vantage6_tpu_torch.client import UserClient

        http = srv.serve(port=0, background=True)
        try:
            uc = UserClient(http.url)
            uc.authenticate("erin", "erinpass1234")
            uc.change_password("erinpass1234", "sdkchanged123")
            uc2 = UserClient(http.url)
            uc2.authenticate("erin", "sdkchanged123")
        finally:
            http.stop()


class TestTwoFactorReset:
    def test_2fa_lost_and_reset(self, srv, seeded):
        user = m.User.first(username="erin")
        from vantage6_tpu_torch.server.auth import generate_totp_secret

        old_secret = generate_totp_secret()
        user.totp_secret = old_secret
        user.save()
        c = srv.test_client()
        r = c.post(
            "/api/recover/2fa/lost",
            {"username": "erin", "password": "erinpass1234"},
        )
        assert r.status == 200
        token = _reset_token(srv)
        r = c.post("/api/recover/2fa/reset", {"reset_token": token})
        assert r.status == 200
        new_secret = r.json["totp_secret"]
        assert new_secret != old_secret
        # login works with the NEW secret only
        r = c.post(
            "/api/token/user",
            {
                "username": "erin",
                "password": "erinpass1234",
                "mfa_code": totp_code(new_secret),
            },
        )
        assert r.status == 200

    def test_2fa_lost_needs_password(self, srv, seeded):
        c = srv.test_client()
        n_before = len(srv.mailer.sent)
        c.post("/api/recover/2fa/lost", {"username": "erin", "password": "no"})
        assert len(srv.mailer.sent) == n_before

    def test_2fa_lost_counts_toward_lockout(self, srv, seeded):
        """Regression (review r2): the endpoint must not be a
        password-guessing oracle outside the lockout counter."""
        c = srv.test_client()
        for _ in range(m.User.MAX_FAILED_ATTEMPTS):
            c.post(
                "/api/recover/2fa/lost",
                {"username": "erin", "password": "guess!"},
            )
        r = c.post(
            "/api/token/user",
            {"username": "erin", "password": "erinpass1234"},
        )
        assert r.status == 401 and "locked" in r.json["msg"]

    def test_2fa_reset_token_single_use(self, srv, seeded):
        """Regression (review r2): a token dies after ONE 2FA reset — the
        fingerprint binds the totp secret, not just the password."""
        c = srv.test_client()
        c.post(
            "/api/recover/2fa/lost",
            {"username": "erin", "password": "erinpass1234"},
        )
        token = _reset_token(srv)
        assert c.post("/api/recover/2fa/reset",
                      {"reset_token": token}).status == 200
        r = c.post("/api/recover/2fa/reset", {"reset_token": token})
        assert r.status == 401 and "used" in r.json["msg"]


class TestMigrations:
    def test_fresh_db_is_at_latest(self, srv):
        assert migrations.current_version(srv.db) == migrations.SCHEMA_VERSION
        versions = migrations.applied_versions(srv.db)
        assert versions == [v for v, _, _ in migrations.MIGRATIONS]

    def test_migrate_v0_database(self, tmp_path):
        """A database laid down WITHOUT version tracking (round-1 layout,
        duplicate org names included) upgrades in order and gains the
        constraints."""
        path = tmp_path / "old.db"
        with sqlite3.connect(path) as conn:
            conn.execute(
                "CREATE TABLE organization (id INTEGER PRIMARY KEY "
                "AUTOINCREMENT, created_at REAL, name TEXT)"
            )
            conn.executemany(
                "INSERT INTO organization (created_at, name) VALUES (1, ?)",
                [("hospital",), ("hospital",), ("clinic",)],
            )
            conn.execute(
                "CREATE TABLE user (id INTEGER PRIMARY KEY AUTOINCREMENT, "
                "created_at REAL, username TEXT)"
            )
            conn.executemany(
                "INSERT INTO user (created_at, username) VALUES (1, ?)",
                [("alice",), ("alice",)],
            )
        db = m.init(f"sqlite:///{path}", replace=True)
        try:
            assert (
                migrations.current_version(db) == migrations.SCHEMA_VERSION
            )
            names = sorted(
                r["name"] for r in db.query("SELECT name FROM organization")
            )
            assert len(set(names)) == 3  # deduped
            assert "hospital" in names  # oldest spelling kept
            users = sorted(
                r["username"] for r in db.query("SELECT username FROM user")
            )
            assert len(set(users)) == 2 and "alice" in users
            # the unique constraint is live now
            with pytest.raises(sqlite3.IntegrityError):
                db.execute(
                    "INSERT INTO user (created_at, username) "
                    "VALUES (1, 'alice')"
                )
        finally:
            db.close()
            m.Model.db = None

    def test_migrations_are_recorded_once(self, tmp_path):
        path = tmp_path / "twice.db"
        db = m.init(f"sqlite:///{path}")
        v1 = migrations.applied_versions(db)
        db.close()
        m.Model.db = None
        db = m.init(f"sqlite:///{path}", replace=True)  # reopen = no-op
        try:
            assert migrations.applied_versions(db) == v1
            rows = db.query("SELECT COUNT(*) AS n FROM schema_version")
            assert rows[0]["n"] == len(migrations.MIGRATIONS)
        finally:
            db.close()
            m.Model.db = None

    def test_future_schema_rejected(self, tmp_path):
        path = tmp_path / "future.db"
        db = Database(f"sqlite:///{path}")
        migrations.ensure_version_table(db)
        db.execute(
            "INSERT INTO schema_version VALUES (?, 'from the future', 1)",
            [migrations.SCHEMA_VERSION + 10],
        )
        db.close()
        with pytest.raises(RuntimeError, match="newer than this server"):
            m.init(f"sqlite:///{path}", replace=True)
        m.Model.db = None
