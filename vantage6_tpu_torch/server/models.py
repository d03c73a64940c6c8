"""Control-plane entities.

Parity: vantage6-server ORM models (SURVEY.md §2 item 2) — `User`, `Node`,
`Organization`, `Collaboration`, `Study`, `Task`, `Run`, `Rule`, `Role`,
`Port` — with the same relationships (collaboration↔organizations m2m,
study⊂collaboration, task→runs fan-out, node = one org's agent in one
collaboration, user/role/rule RBAC graph).
"""
from __future__ import annotations

import hashlib
import os
import secrets
import time
from typing import Any

from vantage6_tpu_torch.common.enums import TaskStatus
from vantage6_tpu_torch.server.db import Database, LinkTable, Model, open_backend

# ------------------------------------------------------------------ entities


class Organization(Model):
    TABLE = "organization"
    COLUMNS = {
        "name": "str",
        "address1": "str",
        "address2": "str",
        "zipcode": "str",
        "country": "str",
        "domain": "str",
        "public_key": "str",  # base64 PEM for E2E payload encryption
    }

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "name": self.name,
            "country": self.country,
            "domain": self.domain,
            "public_key": self.public_key or "",
            "collaborations": collaboration_member.lefts_for(self.id),
        }


class Collaboration(Model):
    TABLE = "collaboration"
    COLUMNS = {
        "name": "str",
        "encrypted": "bool",
    }

    def organization_ids(self) -> list[int]:
        return collaboration_member.rights_for(self.id)

    def add_organization(self, org: Organization) -> None:
        collaboration_member.add(self.id, org.id)

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "name": self.name,
            "encrypted": bool(self.encrypted),
            "organizations": self.organization_ids(),
            "studies": [s.id for s in Study.list(collaboration_id=self.id)],
        }


class Study(Model):
    """A subset of a collaboration's organizations (reference: v4.5+)."""

    TABLE = "study"
    COLUMNS = {
        "name": "str",
        "collaboration_id": "int",
    }

    def organization_ids(self) -> list[int]:
        return study_member.rights_for(self.id)

    def add_organization(self, org: Organization) -> None:
        study_member.add(self.id, org.id)

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "name": self.name,
            "collaboration": self.collaboration_id,
            "organizations": self.organization_ids(),
        }


# ------------------------------------------------------------- authenticate


def hash_password(password: str, salt: bytes | None = None) -> str:
    salt = salt or os.urandom(16)
    digest = hashlib.scrypt(
        password.encode(), salt=salt, n=2**14, r=8, p=1, dklen=32
    )
    return salt.hex() + "$" + digest.hex()


def check_password(password: str, hashed: str) -> bool:
    try:
        salt_hex, digest_hex = hashed.split("$")
    except (ValueError, AttributeError):
        return False
    redo = hashlib.scrypt(
        password.encode(),
        salt=bytes.fromhex(salt_hex),
        n=2**14,
        r=8,
        p=1,
        dklen=32,
    )
    return secrets.compare_digest(redo.hex(), digest_hex)


class User(Model):
    TABLE = "user"
    COLUMNS = {
        "username": "str",
        "password_hash": "str",
        "email": "str",
        "firstname": "str",
        "lastname": "str",
        "organization_id": "int",
        "failed_login_attempts": "int",
        "last_login_attempt": "float",
        "totp_secret": "str",  # set => MFA required
    }

    MAX_FAILED_ATTEMPTS = 5
    LOCKOUT_SECONDS = 60.0

    def set_password(self, password: str) -> None:
        self.password_hash = hash_password(password)

    def check_password(self, password: str) -> bool:
        return check_password(password, self.password_hash or "")

    def is_locked_out(self) -> bool:
        if (self.failed_login_attempts or 0) < self.MAX_FAILED_ATTEMPTS:
            return False
        return (
            time.time() - (self.last_login_attempt or 0.0)
            < self.LOCKOUT_SECONDS
        )

    def record_login(self, success: bool) -> None:
        self.last_login_attempt = time.time()
        self.failed_login_attempts = (
            0 if success else (self.failed_login_attempts or 0) + 1
        )
        self.save()

    # RBAC
    def role_ids(self) -> list[int]:
        return user_role.rights_for(self.id)

    def add_role(self, role: "Role") -> None:
        user_role.add(self.id, role.id)

    def rule_ids(self) -> set[int]:
        """All rules: direct extra rules + via roles.

        `_rules_cache` (set by the auth cache on token resolution) skips
        the 1+R link-table queries per permission check; role/rule
        mutations invalidate the auth cache, which drops the cached user
        object and this snapshot with it.
        """
        cached = getattr(self, "_rules_cache", None)
        if cached is not None:
            return set(cached)
        rules = set(user_rule.rights_for(self.id))
        for rid in self.role_ids():
            rules.update(role_rule.rights_for(rid))
        return rules

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "username": self.username,
            "email": self.email,
            "firstname": self.firstname,
            "lastname": self.lastname,
            "organization": {"id": self.organization_id},
            "roles": self.role_ids(),
        }


class Node(Model):
    """One organization's data-station agent inside one collaboration."""

    TABLE = "node"
    COLUMNS = {
        "name": "str",
        "api_key_hash": "str",
        "organization_id": "int",
        "collaboration_id": "int",
        "station_index": "int",  # device mapping: which sub-mesh slot
        "status": "str",  # "online" | "offline"
        "last_seen_at": "float",
    }

    @staticmethod
    def generate_api_key() -> str:
        return secrets.token_urlsafe(32)

    def set_api_key(self, api_key: str) -> None:
        self.api_key_hash = hashlib.sha256(api_key.encode()).hexdigest()

    def check_api_key(self, api_key: str) -> bool:
        return secrets.compare_digest(
            hashlib.sha256(api_key.encode()).hexdigest(),
            self.api_key_hash or "",
        )

    @classmethod
    def by_api_key(cls, api_key: str) -> "Node | None":
        h = hashlib.sha256(api_key.encode()).hexdigest()
        return cls.first(api_key_hash=h)

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "name": self.name,
            "organization": {"id": self.organization_id},
            "collaboration": {"id": self.collaboration_id},
            "station_index": self.station_index,
            "status": self.status or "offline",
            "last_seen_at": self.last_seen_at,
        }


# ------------------------------------------------------------------- RBAC


class Rule(Model):
    """One permission atom: resource × scope × operation (SURVEY §2 item 4)."""

    TABLE = "rule"
    COLUMNS = {
        "name": "str",  # resource, e.g. "task"
        "scope": "str",  # own|organization|collaboration|global
        "operation": "str",  # view|create|edit|delete|send|receive
    }

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "name": self.name,
            "scope": self.scope,
            "operation": self.operation,
        }


class Role(Model):
    TABLE = "role"
    COLUMNS = {
        "name": "str",
        "description": "str",
        "organization_id": "int",  # NULL => default/global role
    }

    def rule_ids(self) -> list[int]:
        return role_rule.rights_for(self.id)

    def add_rule(self, rule: Rule) -> None:
        role_rule.add(self.id, rule.id)

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "name": self.name,
            "description": self.description,
            "organization": (
                {"id": self.organization_id} if self.organization_id else None
            ),
            "rules": self.rule_ids(),
        }


# ------------------------------------------------------------------- tasks


class Task(Model):
    TABLE = "task"
    COLUMNS = {
        "name": "str",
        "description": "str",
        "image": "str",
        "method": "str",
        "collaboration_id": "int",
        "study_id": "int",
        "parent_id": "int",
        "init_org_id": "int",
        "init_user_id": "int",
        "databases": "json",
        "job_id": "int",  # groups a task tree (reference: run_id/job_id)
        "session_id": "int",  # sessions: task runs inside this workspace
        "store_as": "str",    # sessions: nodes persist the run's returned
                              # dataframe under this handle
        "engine": "str",      # "process" (default: node sandbox/inline) or
                              # "device": the run executes as ONE SPMD
                              # program over the nodes' global device mesh
        # distributed tracing (runtime.tracing): the creating request's
        # trace context. trace_id groups every span of this task's
        # federated round; traceparent is the full W3C header the daemons
        # parent their claim/exec/report spans on.
        "trace_id": "str",
        "traceparent": "str",
    }

    def runs(self) -> list["TaskRun"]:
        return TaskRun.list(task_id=self.id)

    def _run_rollup(self) -> tuple[list[int], set[str]]:
        """The task's run ids (ascending) and their distinct statuses
        (a NULL status as ""), read as ONE row: under the in-memory
        store's lock a query pays a GIL round trip for every row it steps,
        so the rollup never fetches the runs themselves."""
        (row,) = self._db().query(
            "SELECT group_concat(id) AS ids, "
            "group_concat(DISTINCT ifnull(status, '')) AS statuses "
            f"FROM {TaskRun.TABLE} WHERE task_id = ?",
            [self.id],
        )
        if row["ids"] is None:
            return [], set()
        return (
            sorted(int(i) for i in row["ids"].split(",")),
            set(row["statuses"].split(",")),
        )

    def status(self) -> str:
        """Aggregate status rollup over runs (same order as the runtime)."""
        return self._status_of(self._run_rollup()[1])

    @staticmethod
    def _status_of(statuses: set[str]) -> str:
        if not statuses:
            return TaskStatus.PENDING.value
        for bad in (
            TaskStatus.KILLED,
            TaskStatus.NOT_ALLOWED,
            TaskStatus.NO_IMAGE,
            TaskStatus.CRASHED,
            TaskStatus.FAILED,
        ):
            if bad.value in statuses:
                return bad.value
        if statuses == {TaskStatus.COMPLETED.value}:
            return TaskStatus.COMPLETED.value
        if (
            TaskStatus.ACTIVE.value in statuses
            or TaskStatus.INITIALIZING.value in statuses
        ):
            return TaskStatus.ACTIVE.value
        return TaskStatus.PENDING.value

    def to_dict(self) -> dict[str, Any]:
        run_ids, statuses = self._run_rollup()
        return {
            "id": self.id,
            "name": self.name,
            "description": self.description,
            "image": self.image,
            "method": self.method,
            "status": self._status_of(statuses),
            "collaboration": {"id": self.collaboration_id},
            "study": {"id": self.study_id} if self.study_id else None,
            "parent": {"id": self.parent_id} if self.parent_id else None,
            "init_org": {"id": self.init_org_id},
            "init_user": {"id": self.init_user_id},
            "job_id": self.job_id,
            "databases": self.databases or [],
            "session": {"id": self.session_id} if self.session_id else None,
            "store_as": self.store_as or None,
            "engine": self.engine or "process",
            "trace_id": self.trace_id or None,
            "traceparent": self.traceparent or None,
            "runs": run_ids,
        }


class TaskRun(Model):
    """One organization's run of a task (reference: `Run`, né `Result`)."""

    TABLE = "run"
    COLUMNS = {
        "task_id": "int",
        "organization_id": "int",
        "node_id": "int",
        "status": "str",
        "input": "str",  # (encrypted) serialized input for THIS org
        "result": "str",  # (encrypted) serialized result
        "log": "str",
        "assigned_at": "float",
        "started_at": "float",
        "finished_at": "float",
    }

    def to_dict(self, include_result: bool = True) -> dict[str, Any]:
        d = {
            "id": self.id,
            "task": {"id": self.task_id},
            "organization": {"id": self.organization_id},
            "node": {"id": self.node_id},
            "status": self.status,
            "input": self.input,
            "log": self.log,
            "assigned_at": self.assigned_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
        }
        if include_result:
            d["result"] = self.result
        return d


class Session(Model):
    """A workspace persisting named dataframes AT THE NODES between tasks
    (reference: v4.7+ 'sessions' — data-extraction tasks materialize
    dataframes once; later preprocessing/compute tasks reuse them without
    re-reading the source databases). The server stores ONLY bookkeeping;
    dataframe content never leaves its node."""

    TABLE = "session"
    COLUMNS = {
        "name": "str",
        "collaboration_id": "int",
        "study_id": "int",
        "owner_id": "int",  # creating user
        "scope": "str",     # "own" | "collaboration" — who may use it
    }

    def dataframes(self) -> list["SessionDataframe"]:
        return SessionDataframe.list(session_id=self.id)

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "name": self.name,
            "collaboration": {"id": self.collaboration_id},
            "study": {"id": self.study_id} if self.study_id else None,
            "owner": {"id": self.owner_id},
            "scope": self.scope or "collaboration",
            "created_at": self.created_at,
            "dataframes": [d.to_dict() for d in self.dataframes()],
        }


class SessionDataframe(Model):
    """Bookkeeping for one named dataframe in a session: which task last
    (re)built it, whether every node has materialized it, and its column
    metadata — the content itself lives only in the nodes' session stores."""

    TABLE = "session_dataframe"
    COLUMNS = {
        "session_id": "int",
        "handle": "str",
        "last_task_id": "int",
        "ready": "bool",
        "columns": "json",  # [{name, dtype}] as reported by nodes
    }

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "session": {"id": self.session_id},
            "handle": self.handle,
            "last_task": (
                {"id": self.last_task_id} if self.last_task_id else None
            ),
            "ready": bool(self.ready),
            "columns": self.columns or [],
        }


class Port(Model):
    """An exposed algorithm port (reference: VPN inter-container traffic)."""

    TABLE = "port"
    COLUMNS = {
        "run_id": "int",
        "port": "int",
        "label": "str",
    }

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "run": {"id": self.run_id},
            "port": self.port,
            "label": self.label,
        }


# --------------------------------------------------------------- link tables

collaboration_member = LinkTable(
    "collaboration_organization", "collaboration_id", "organization_id"
)
study_member = LinkTable("study_organization", "study_id", "organization_id")
user_role = LinkTable("user_role", "user_id", "role_id")
role_rule = LinkTable("role_rule", "role_id", "rule_id")
user_rule = LinkTable("user_rule", "user_id", "rule_id")

# replica-local: code-derived constant, identical on every replica
ALL_MODELS: list[type[Model]] = [
    Organization,
    Collaboration,
    Study,
    User,
    Node,
    Rule,
    Role,
    Task,
    TaskRun,
    Port,
    Session,
    SessionDataframe,
]
# replica-local: code-derived constant, identical on every replica
ALL_LINKS = [collaboration_member, study_member, user_role, role_rule, user_rule]


# how many ServerApps share the current Model.db binding (SHARED backends
# allow in-process replicas over one store; see init/release)
_BINDING_REFS = 0  # replica-local: refcount of THIS process's db binding


def init(uri: str = "sqlite:///:memory:", replace: bool = False) -> Database:
    """Bind the database and migrate the schema (alembic-equivalent).

    One process hosts ONE control-plane database per model hierarchy
    (`Model.db` is class-level state); a second `init` without closing the
    first would silently redirect live handlers, so it raises instead.
    Services needing their own DB in-process (the algorithm store) use their
    own `Model` subclass hierarchy with its own `db` binding.

    Exception: a SHARED backend (``sqlite+wal``) re-initialised with the
    SAME uri returns the existing binding refcounted — two in-process
    server replicas over one store are exactly the multi-replica topology
    the backend exists for. `release()` unbinds only when the last
    holder lets go.
    """
    global _BINDING_REFS
    if Model.db is not None and not replace:
        if Model.db.SHARED and getattr(Model.db, "uri", None) == uri:
            _BINDING_REFS += 1
            return Model.db
        raise RuntimeError(
            "server models already bound to a database; close it and set "
            "Model.db = None (or pass replace=True) before rebinding"
        )
    db = open_backend(uri)
    Model.db = db
    _BINDING_REFS = 1
    for m in ALL_MODELS:
        m.ensure_schema()
    for link in ALL_LINKS:
        link.ensure_schema()
    # versioned upgrades on top of the additive DDL (constraints, backfills,
    # indexes — recorded in schema_version; see server.migrations)
    from vantage6_tpu_torch.server import migrations

    migrations.migrate(db)
    return db


def release(db: Database) -> None:
    """Drop one holder's claim on the binding `init` returned. The binding
    (and connection) is closed only when the LAST in-process holder
    releases — a shared-backend replica closing must not unbind the other
    replica's live handlers mid-request."""
    global _BINDING_REFS
    if Model.db is not db:
        # already rebound (tests replace=True) — close the orphan quietly
        db.close()
        return
    _BINDING_REFS -= 1
    if _BINDING_REFS <= 0:
        _BINDING_REFS = 0
        db.close()
        Model.db = None
