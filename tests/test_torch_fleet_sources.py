"""The port's fleet sources aggregate (``server/fleet.py::sources``, behind
``GET /api/health``'s fleet block, ``/api/fleet`` and the watchdog feed)
and the views over it, against the JAX package's on the same store at
every step: pushes from several sources and services, per-event samples
whose timestamps go backwards, a push sequence that restarts, a prune
that deletes rows, rows deleted by hand, and two replicas over one WAL
file store, one pruning while the other reads."""
import time

import pytest

from vantage6_tpu.server import fleet as jax_fleet
from vantage6_tpu_torch.server import fleet
from vantage6_tpu_torch.server.db import Database, WalDatabase
from vantage6_tpu_torch.server.migrations import _m8_fleet_tables

# ingest clamps a push's stamp to the last RETENTION_S of the wall clock
NOW = float(int(time.time()))


def _push(db, source, service, seq, ts, names):
    fleet.ingest(db, {"source": source, "service": service, "seq": seq,
                      "ts": ts, "metrics": {n: float(i)
                                            for i, n in enumerate(names)}})


def _same(db, now=NOW):
    port = fleet.sources(db, now)
    assert port == jax_fleet.sources(db, now)
    assert fleet.health_block(db, now) == jax_fleet.health_block(db, now)
    return port


@pytest.fixture
def db():
    d = Database("sqlite:///:memory:")
    _m8_fleet_tables(d)  # the fleet tables, as migration v8 makes them
    yield d
    d.close()


def test_sources_are_the_reference_at_every_step(db, monkeypatch):
    monkeypatch.setattr(fleet, "PRUNE_EVERY", 10**9)  # prune by hand only
    assert _same(db) == []
    names = [f"v6t_series_{i}" for i in range(7)]
    for seq in range(3):
        for s in range(4):
            _push(db, f"daemon:d{s}", "daemon", seq, NOW - 100 + seq,
                  names[:4 + s % 3])
        got = _same(db)
    assert [r["series"] for r in got] == [4, 5, 6, 4]
    # a sample stamped earlier than the source's newest, a new series,
    # another service, and a restarted push sequence
    fleet.record_sample(db, "daemon:d1", "daemon", "v6t_run_dispatch_seconds",
                        0.5, ts=NOW - 5000)
    _push(db, "srv-1", "server", 9, NOW - 50, names[:2])
    _push(db, "daemon:d2", "daemon", 0, NOW - 120, names)
    got = _same(db)
    assert {r["source"]: r["seq"] for r in got}["daemon:d2"] == 2
    # a prune deletes the old rows, keeping the newest of each series
    deleted = fleet.prune(db, now=NOW - 99.5 + fleet.RETENTION_S)
    assert deleted > 0
    _same(db)
    _push(db, "daemon:d0", "daemon", 3, NOW - 10, names[:1])
    _same(db)
    # rows deleted by hand, then as many appended as were deleted
    n = db.query("SELECT COUNT(*) AS n FROM fleet_metric "
                 "WHERE source = 'daemon:d3'")[0]["n"]
    db.execute("DELETE FROM fleet_metric WHERE source = 'daemon:d3'")
    _push(db, "daemon:d4", "daemon", 0, NOW - 1, [f"x{i}" for i in range(n)])
    got = _same(db)
    assert "daemon:d3" not in {r["source"] for r in got}
    db.execute("DELETE FROM fleet_metric")
    assert _same(db) == []


def test_the_fleet_view_is_the_reference(db):
    """``fleet_view`` (``/api/fleet``: sources, census, liveness) and the
    census, after pushes, a sample and a prune."""
    for seq in range(3):
        _push(db, "daemon:a", "daemon", seq, NOW - 300 + seq, ["m1", "m2"])
        _push(db, "srv-1", "server", seq, NOW - 20 + seq, ["m1", "m3"])
    fleet.record_sample(db, "daemon:a", "daemon", "v6t_run_dispatch_seconds",
                        0.25, ts=NOW - 2)
    for _ in range(2):
        assert fleet.census(db) == jax_fleet.census(db)
        assert fleet.fleet_view(db, NOW) == jax_fleet.fleet_view(db, NOW)
        fleet.prune(db, now=NOW - 298.5 + fleet.RETENTION_S)


def test_two_replicas_over_one_store(tmp_path):
    """Two replicas over one store read the same sources, also after one
    of them prunes."""
    uri = f"sqlite+wal:///{tmp_path / 'store.db'}"
    a, b = WalDatabase(uri), WalDatabase(uri)
    _m8_fleet_tables(a)
    try:
        for seq in range(4):
            _push(a, "daemon:x", "daemon", seq, NOW - 200 + seq, ["m1", "m2"])
            _push(b, "daemon:y", "daemon", seq, NOW - 200 + seq, ["m3"])
            _same(a), _same(b)
        assert fleet.prune(a, now=NOW - 198.5 + fleet.RETENTION_S) > 0
        assert _same(b) == _same(a)
    finally:
        a.close()
        b.close()
