"""Versioned schema migrations (reference: alembic; SURVEY.md §2 item 8).

Two-layer upgrade story, mirroring what alembic gives the reference:

1. **Additive DDL** — `Model.ensure_schema` creates missing tables/columns on
   every start (covers the common "new field" case with zero ceremony).
2. **Versioned migrations** (this module) — ordered, recorded, run-once
   steps for everything additive DDL cannot express: constraints, indexes,
   data backfills, renames. Each applied version is a row in
   ``schema_version`` (version, description, applied_at), so an operator can
   audit exactly which upgrades a database has seen, and an old database
   opened by a new server is upgraded deterministically, in order.

Writing a migration: append ``(N, "description", fn)`` to ``MIGRATIONS``
with N = previous + 1. ``fn(db)`` runs after ``ensure_schema`` (all
tables/columns exist) and must be safe on both fresh and populated
databases. Never reorder or edit an applied migration — append a new one.
"""
from __future__ import annotations

import time
from typing import Callable

from vantage6_tpu_torch.common.log import setup_logging
from vantage6_tpu_torch.server.db import Database

log = setup_logging("vantage6_tpu_torch/server.migrations")


def _m1_baseline(db: Database) -> None:
    """v1: baseline — tables come from ensure_schema's additive DDL."""


def _m2_unique_username(db: Database) -> None:
    """v2: usernames must be unique (login identity). Pre-existing
    duplicates are disambiguated with an id suffix, keeping the OLDEST
    spelling intact (it is the one whose owner expects to log in)."""
    rows = db.query(
        "SELECT username, COUNT(*) AS n FROM user "
        "GROUP BY username HAVING n > 1"
    )
    for r in rows:
        dupes = db.query(
            "SELECT id FROM user WHERE username = ? ORDER BY id",
            [r["username"]],
        )
        for row in dupes[1:]:
            db.execute(
                "UPDATE user SET username = username || '_' || id "
                "WHERE id = ?",
                [row["id"]],
            )
    db.execute(
        "CREATE UNIQUE INDEX IF NOT EXISTS uq_user_username "
        "ON user(username)"
    )


def _m3_unique_org_name(db: Database) -> None:
    """v3: organization names are unique (the reference enforces the same;
    task targeting and node naming key on them)."""
    rows = db.query(
        "SELECT name, COUNT(*) AS n FROM organization "
        "GROUP BY name HAVING n > 1"
    )
    for r in rows:
        dupes = db.query(
            "SELECT id FROM organization WHERE name = ? ORDER BY id",
            [r["name"]],
        )
        for row in dupes[1:]:
            db.execute(
                "UPDATE organization SET name = name || ' (' || id || ')' "
                "WHERE id = ?",
                [row["id"]],
            )
    db.execute(
        "CREATE UNIQUE INDEX IF NOT EXISTS uq_organization_name "
        "ON organization(name)"
    )


def _m4_hot_query_indexes(db: Database) -> None:
    """v4: indexes for the hottest control-plane queries — node run polling
    by status and container job-tree scoping by job_id."""
    db.execute(
        "CREATE INDEX IF NOT EXISTS idx_run_status ON run(status)"
    )
    db.execute(
        "CREATE INDEX IF NOT EXISTS idx_task_job_id ON task(job_id)"
    )
    db.execute(
        "CREATE UNIQUE INDEX IF NOT EXISTS uq_node_org_collab "
        "ON node(organization_id, collaboration_id)"
    )


def _m5_dispatch_indexes(db: Database) -> None:
    """v5: composite indexes for the control-plane fast path — the batched
    claim sweep selects runs by (organization, status) and by
    (node, status); the single-column idx_run_status from v4 still forces
    a scan over every completed run of a busy org."""
    db.execute(
        "CREATE INDEX IF NOT EXISTS idx_run_org_status "
        "ON run(organization_id, status)"
    )
    db.execute(
        "CREATE INDEX IF NOT EXISTS idx_run_node_status "
        "ON run(node_id, status)"
    )


def _m6_trace_metadata(db: Database) -> None:
    """v6: distributed-tracing task metadata. The columns themselves
    (task.trace_id, task.traceparent) arrive via additive DDL; this adds
    the lookup index so "every task of trace X" — the trace_view /
    observability join — is not a table scan on a busy server."""
    db.execute(
        "CREATE INDEX IF NOT EXISTS idx_task_trace_id ON task(trace_id)"
    )


def _m7_replica_tables(db: Database) -> None:
    """v7: shared-store substrate for N server replicas. Four tables:
    the cross-replica event stream (`pubsub_event` — the DbPubSub ring,
    append + bounded prune), its watermark (`pubsub_meta` — eviction
    floor so truncation survives the pruner), replica liveness
    (`replica_heartbeat` — /api/health and the watchdog's replica view),
    and the learning plane keyed by (task, round) (`learning_round` — a
    round trajectory whose per-round subtasks land on different replicas
    still reads back as ONE history)."""
    db.execute(
        "CREATE TABLE IF NOT EXISTS pubsub_event ("
        "seq INTEGER PRIMARY KEY AUTOINCREMENT, "
        "name TEXT NOT NULL, room TEXT NOT NULL, "
        "data TEXT, ts REAL NOT NULL)"
    )
    db.execute(
        "CREATE TABLE IF NOT EXISTS pubsub_meta ("
        "key TEXT PRIMARY KEY, value INTEGER NOT NULL)"
    )
    db.execute(
        "CREATE TABLE IF NOT EXISTS replica_heartbeat ("
        "replica_id TEXT PRIMARY KEY, pid INTEGER, "
        "started_at REAL NOT NULL, last_seen_at REAL NOT NULL)"
    )
    db.execute(
        "CREATE TABLE IF NOT EXISTS learning_round ("
        "task_key TEXT NOT NULL, round INTEGER NOT NULL, "
        "data TEXT NOT NULL, ts REAL NOT NULL, "
        "PRIMARY KEY (task_key, round))"
    )


def _m8_fleet_tables(db: Database) -> None:
    """v8: fleet telemetry fabric. Two append-only tables behind
    `POST /api/telemetry` / `GET /api/fleet` (server/fleet.py):
    `fleet_metric` — timestamped metric samples, one row per (source,
    series) per pushed snapshot, CAS-free appends pruned by the
    retention floor; `fleet_event` — flight-note/alert deltas riding
    the same pushes. Both are keyed for the two hot reads: the census
    ("latest row per source+series") and the SLO engine's windowed
    series scan ("all samples of series X since T")."""
    db.execute(
        "CREATE TABLE IF NOT EXISTS fleet_metric ("
        "id INTEGER PRIMARY KEY AUTOINCREMENT, "
        "source TEXT NOT NULL, service TEXT, seq INTEGER, "
        "name TEXT NOT NULL, kind TEXT, value REAL, ts REAL NOT NULL)"
    )
    db.execute(
        "CREATE INDEX IF NOT EXISTS idx_fleet_metric_name_ts "
        "ON fleet_metric(name, ts)"
    )
    db.execute(
        "CREATE INDEX IF NOT EXISTS idx_fleet_metric_source "
        "ON fleet_metric(source, name, id)"
    )
    db.execute(
        "CREATE TABLE IF NOT EXISTS fleet_event ("
        "id INTEGER PRIMARY KEY AUTOINCREMENT, "
        "source TEXT NOT NULL, service TEXT, kind TEXT NOT NULL, "
        "ts REAL NOT NULL, data TEXT)"
    )
    db.execute(
        "CREATE INDEX IF NOT EXISTS idx_fleet_event_ts ON fleet_event(ts)"
    )


# replica-local: code-derived constant, identical on every replica
MIGRATIONS: list[tuple[int, str, Callable[[Database], None]]] = [
    (1, "baseline schema", _m1_baseline),
    (2, "unique index on user.username (+dedupe)", _m2_unique_username),
    (3, "unique index on organization.name (+dedupe)", _m3_unique_org_name),
    (4, "hot-query indexes: run.status, task.job_id, node uniqueness",
     _m4_hot_query_indexes),
    (5, "dispatch-path indexes: run(org,status), run(node,status)",
     _m5_dispatch_indexes),
    (6, "tracing metadata index: task(trace_id)", _m6_trace_metadata),
    (7, "replica tables: pubsub event stream, heartbeats, learning rounds",
     _m7_replica_tables),
    (8, "fleet telemetry tables: cross-host metric samples + event deltas",
     _m8_fleet_tables),
]

SCHEMA_VERSION = MIGRATIONS[-1][0]


def ensure_version_table(db: Database) -> None:
    db.execute(
        "CREATE TABLE IF NOT EXISTS schema_version ("
        "version INTEGER PRIMARY KEY, "
        "description TEXT NOT NULL, "
        "applied_at REAL NOT NULL)"
    )


def applied_versions(db: Database) -> list[int]:
    ensure_version_table(db)
    return [
        r["version"]
        for r in db.query("SELECT version FROM schema_version ORDER BY version")
    ]


def current_version(db: Database) -> int:
    versions = applied_versions(db)
    return versions[-1] if versions else 0


def migrate(db: Database) -> list[int]:
    """Apply every unapplied migration in order; returns versions applied
    now. Raises if the database is AHEAD of this code (downgrades are not
    supported — run a matching or newer server)."""
    ensure_version_table(db)
    done = set(applied_versions(db))
    ahead = [v for v in done if v > SCHEMA_VERSION]
    if ahead:
        raise RuntimeError(
            f"database schema version {max(ahead)} is newer than this "
            f"server's {SCHEMA_VERSION} — upgrade the server, downgrades "
            "are not supported"
        )
    applied_now = []
    for version, description, fn in MIGRATIONS:
        if version in done:
            continue
        fn(db)
        db.execute(
            "INSERT INTO schema_version (version, description, applied_at) "
            "VALUES (?, ?, ?)",
            [version, description, time.time()],
        )
        log.info("schema migrated to v%d: %s", version, description)
        applied_now.append(version)
    return applied_now
