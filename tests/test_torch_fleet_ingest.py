"""One fleet push, one transaction, and the task rollup in one row.

(a) The port's ``server/fleet.py::ingest`` writes the JAX package's
    ``fleet_metric`` and ``fleet_event`` rows (every column, ids included,
    in order) for pushes whose metrics span several insert chunks, with
    flight notes, non-numeric values, skewed and missing stamps and a prune
    between them, in memory, in a file and in a WAL file store; the fleet
    view over them is the reference's.
(b) A push takes the in-memory store's lock once (the reference's takes it
    once a statement), concurrent pushes land whole, and
    ``Database.execute_batch`` rolls a failing batch back whole.
(c) ``Task.status()`` and ``Task.to_dict()`` read the task's run ids and
    statuses as one aggregate row through ``run``'s ``task_id`` index, and
    ``GET /api/task`` and ``GET /api/task/<id>`` answer what the JAX
    package's server answers over the same database file.
"""
import importlib
import time

import pytest

from vantage6_tpu.server import fleet as jax_fleet
from vantage6_tpu_torch.server import fleet
from vantage6_tpu_torch.server.db import Database, WalDatabase
from vantage6_tpu_torch.server.migrations import _m8_fleet_tables

NOW = float(int(time.time()))
FLEETS = (jax_fleet, fleet)


def _payloads():
    """Five pushes: 3 metric chunks and 2 note chunks in the first."""
    metrics = {(f"v6t_s{i:03d}_total" if i % 2 else f"v6t_g{i:03d}"): i / 4
               for i in range(300)}
    metrics.update({"v6t_text": "x", "v6t_flag": True, "v6t_none": None,
                    "v6t_int_total": 7})
    notes = [{"kind": "alert", "ts": NOW - 3, "rule": "stuck_run", "n": 2},
             {"kind": "fleet_push_failed", "error": "HTTP 500"},
             {"ts": NOW - 1, "rule": "no kind"}, "not a note",
             {"kind": "ancient", "ts": NOW - 10**6}]
    notes += [{"kind": "step", "ts": NOW - 2, "i": i} for i in range(130)]
    return [
        {"source": "daemon:a", "service": "daemon", "seq": 0,
         "ts": NOW - 10, "metrics": metrics, "notes": notes},
        {"source": "daemon:b", "service": "daemon", "seq": 3,
         "ts": NOW + 3600, "metrics": {"v6t_g": 1.5}},
        {"source": "srv-1", "service": "server", "seq": 1, "ts": NOW - 10**6,
         "metrics": {"v6t_h_total": 2}, "notes": [{"kind": "boot"}]},
        {"source": "daemon:c", "metrics": {"v6t_g": 0.25},
         "notes": [{"kind": "late", "ts": NOW - 5}]},
        {"source": "daemon:d", "service": "daemon"},
    ]


def _store(kind, path):
    if kind == "memory":
        db = Database("sqlite:///:memory:")
    elif kind == "file":
        db = Database(f"sqlite:///{path}")
    else:
        db = WalDatabase(f"sqlite+wal:///{path}")
    _m8_fleet_tables(db)
    return db


def _rows(db):
    return {t: [tuple(r) for r in db.query(f"SELECT * FROM {t} ORDER BY id")]
            for t in ("fleet_metric", "fleet_event")}


@pytest.mark.parametrize("kind", ["memory", "file", "wal"])
def test_ingest_writes_the_reference_rows(kind, tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    dbs = [_store(kind, tmp_path / f"{f.__name__}.db") for f in FLEETS]
    try:
        for f in FLEETS:  # a prune after the second and the fourth push
            monkeypatch.setattr(f, "PRUNE_EVERY", 2)
            monkeypatch.setattr(f, "_INGESTS", 0)
        for payload in _payloads():
            assert (jax_fleet.ingest(dbs[0], payload)
                    == fleet.ingest(dbs[1], payload))
        ref, port = (_rows(db) for db in dbs)
        assert port == ref
        assert len(port["fleet_metric"]) == 304
        # the prune took the ancient note; the rest stayed in order
        assert [r[3] for r in port["fleet_event"]][:3] == [
            "alert", "fleet_push_failed", "step"]
        assert len(port["fleet_event"]) == 134
        assert (fleet.fleet_view(dbs[1], NOW)
                == jax_fleet.fleet_view(dbs[0], NOW))
    finally:
        for db in dbs:
            db.close()


class _CountingLock:
    """A reentrant lock that counts its outermost holds."""

    def __init__(self, lock):
        self.lock, self.holds, self.depth = lock, 0, 0

    def __enter__(self):
        self.lock.acquire()
        self.holds += self.depth == 0
        self.depth += 1
        return self

    def __exit__(self, *exc):
        self.depth -= 1
        self.lock.release()


def _holds(f, payload):
    db = _store("memory", None)
    try:
        db._memory_lock = lock = _CountingLock(db._memory_lock)
        f.ingest(db, payload)
        return lock.holds, len(_rows(db)["fleet_event"])
    finally:
        db.close()


def test_a_push_takes_the_memory_lock_once(monkeypatch):
    for f in FLEETS:
        monkeypatch.setattr(f, "PRUNE_EVERY", 10**9)
    payload = _payloads()[0]
    holds, events = _holds(fleet, payload)
    assert (holds, events) == (1, 133)
    # the reference holds it for each metric chunk and each note
    assert _holds(jax_fleet, payload) == (3 + 133, 133)
    assert _holds(fleet, {"source": "daemon:d"}) == (0, 0)


def test_concurrent_pushes_land_whole(monkeypatch):
    """Pushes from more threads than cores, with a short switch interval:
    each push's rows get consecutive ids (no push interleaves another's)."""
    import sys
    import threading

    monkeypatch.setattr(fleet, "PRUNE_EVERY", 10**9)
    metrics = {f"v6t_g{i:03d}": float(i) for i in range(250)}
    notes = [{"kind": "step", "ts": NOW, "i": i} for i in range(3)]
    db = _store("memory", None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def pusher(t):
            for seq in range(5):
                fleet.ingest(db, {"source": f"daemon:{t}", "seq": seq,
                                  "service": "daemon", "metrics": metrics,
                                  "notes": notes})

        threads = [threading.Thread(target=pusher, args=(t,))
                   for t in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    try:
        ids = {}
        for r in db.query("SELECT id, source, seq FROM fleet_metric"):
            ids.setdefault((r["source"], r["seq"]), []).append(r["id"])
        assert len(ids) == 60
        for got in ids.values():
            assert sorted(got) == list(range(min(got), min(got) + 250))
        assert len(_rows(db)["fleet_event"]) == 180
    finally:
        db.close()


@pytest.mark.parametrize("kind", ["memory", "file", "wal"])
def test_execute_batch_rolls_back_whole(kind, tmp_path):
    db = _store(kind, tmp_path / "batch.db")
    try:
        ok = ("INSERT INTO fleet_event (source, kind, ts) VALUES (?, ?, ?)",
              ["s", "k", 1.0])
        with pytest.raises(Exception, match="no such table"):
            db.execute_batch([ok, ("INSERT INTO nowhere VALUES (?)", [1])])
        assert _rows(db)["fleet_event"] == []
        db.execute_batch([ok, ok])
        assert [r[0] for r in _rows(db)["fleet_event"]] == [1, 2]
    finally:
        db.close()


# ------------------------------------------------------ (c) task rollup
ORGS = 4
# each task's run statuses (None: a run whose status was never set)
STATUSES = [
    ["completed"] * 4,
    ["completed", "completed", "failed", "completed"],
    ["completed", None, "completed", "completed"],
    ["active", "pending", "pending", "completed"],
    ["initializing", "completed", "completed", "completed"],
    ["killed by user", "crashed", "completed", "active"],
    ["non-existing image", "not allowed", "pending", "pending"],
    ["pending"] * 4,
]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.server.{name}")


def _task_db(uri):
    """A port server's file: 4 organizations, one task for each status
    combination (a run an organization), a task whose runs were deleted."""
    srv = _mod("vantage6_tpu_torch", "app").ServerApp(uri=uri)
    try:
        srv.ensure_root(password="rootpass123")
        c = srv.test_client()
        c.token = c.post("/api/token/user", {
            "username": "root", "password": "rootpass123",
        }).json["access_token"]
        orgs = [c.post("/api/organization", {"name": f"o{i}"}).json["id"]
                for i in range(ORGS)]
        collab = c.post("/api/collaboration", {
            "name": "c", "organization_ids": orgs}).json["id"]
        for i, statuses in enumerate(STATUSES + [[]]):
            task = c.post("/api/task", {
                "name": f"t{i}", "image": "v6-average-py",
                "collaboration_id": collab,
                "organizations": [{"id": o, "input": "e30="}
                                  for o in orgs]}).json
            assert len(task["runs"]) == ORGS
            if not statuses:
                srv.db.execute("DELETE FROM run WHERE task_id = ?",
                               [task["id"]])
            for rid, status in zip(task["runs"], statuses):
                srv.db.execute("UPDATE run SET status = ? WHERE id = ?",
                               [status, rid])
    finally:
        srv.close()


def _read_tasks(pkg, uri):
    srv = _mod(pkg, "app").ServerApp(uri=uri)
    try:
        c = srv.test_client()
        c.token = c.post("/api/token/user", {
            "username": "root", "password": "rootpass123",
        }).json["access_token"]
        listed = c.get("/api/task").json["data"]
        one = [c.get(f"/api/task/{t['id']}").json for t in listed]
        return _mask(listed), _mask(one)
    finally:
        srv.close()


def _mask(obj, key=""):
    if key.endswith("_at") or key in ("trace_id", "traceparent"):
        return "<masked>" if obj is not None else None
    if isinstance(obj, dict):
        return {k: _mask(v, k) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def test_task_answers_are_the_reference_over_one_database(tmp_path):
    uri = "sqlite:///" + str(tmp_path / "tasks.db")
    _task_db(uri)
    port = _read_tasks("vantage6_tpu_torch", uri)
    assert port == _read_tasks("vantage6_tpu", uri)
    listed, one = port
    assert listed == one
    assert [t["status"] for t in listed] == [
        "completed", "failed", "pending", "active", "active",
        "killed by user", "not allowed", "pending", "pending"]
    assert [len(t["runs"]) for t in listed] == [ORGS] * len(STATUSES) + [0]
    assert all(t["runs"] == sorted(t["runs"]) for t in listed)


def test_task_rollup_is_one_indexed_row(tmp_path):
    uri = "sqlite:///" + str(tmp_path / "tasks.db")
    _task_db(uri)
    models = _mod("vantage6_tpu_torch", "models")
    srv = _mod("vantage6_tpu_torch", "app").ServerApp(uri=uri)
    try:
        seen = []
        query = srv.db.query

        def recording(sql, params=()):
            rows = query(sql, params)
            seen.append((sql, list(params), len(rows)))
            return rows

        task = models.Task.get(1)
        srv.db.query = recording
        status, as_dict = task.status(), task.to_dict()
        del srv.db.query
        assert status == as_dict["status"] == "completed"
        assert as_dict["runs"] == [r.id for r in task.runs()]
        (sql, params, n), again = seen
        assert again == (sql, params, 1) and n == 1
        plan = " ".join(r["detail"] for r in srv.db.query(
            "EXPLAIN QUERY PLAN " + sql, params))
        assert "USING INDEX idx_run_task_id" in plan, plan
    finally:
        srv.close()
