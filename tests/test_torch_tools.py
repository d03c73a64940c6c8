"""The repository's tools read what the port writes.

Copies of the classes that drive ``tools/`` (``tests/test_watchdog.py``'s
``TestDoctor``, ``tests/test_learning.py``'s ``TestSurfaces``) with their
inputs made by the port: its flight recorder dumps the bundles (its
logger, tracer and watchdog feed them), its tracer writes the span sink,
and its learning plane the learning records. The
unchanged ``tools/doctor.py``, ``tools/trace_view.py`` and
``tools/check_collect.py`` read them, so a format of the port that drifts
from the JAX package's fails here.

``TestBenchTrend`` has no copy: ``tools/bench_trend.py`` reads the
benchmark's ``BENCH_rNN.json`` rounds, and the port writes none.
"""
import json
import logging
import subprocess
import sys
import time

import numpy as np
import pytest

from vantage6_tpu_torch.common.flight import FLIGHT, read_bundle
from vantage6_tpu_torch.common.log import record_to_dict, setup_logging
from vantage6_tpu_torch.runtime.learning import (
    LEARNING,
    RoundHistory,
    update_stats_host,
)
from vantage6_tpu_torch.runtime.tracing import TRACER, summarize
from vantage6_tpu_torch.runtime.watchdog import RULE_CATALOG, WATCHDOG

log = setup_logging("vantage6_tpu_torch/tools-test")


@pytest.fixture()
def tracer():
    TRACER.configure(enabled=True, sample=1.0, sink=None)
    TRACER.clear()
    yield TRACER
    TRACER.configure(enabled=True, sample=1.0, sink=None)


def _quiet_watchdog():
    """Clear the singleton watchdog's alerts that earlier test modules in
    this process left: their learning records, the feeds of their
    Federations never closed (anomalous stations, runs left ACTIVE), and
    the metric history its windowed rules read (retraces counted there
    would raise ``recompile_storm`` here)."""
    LEARNING.clear()
    with WATCHDOG._lock:
        leaked = [k for k in WATCHDOG._feeds if k.startswith("federation-")]
        WATCHDOG._metric_history.clear()
    for key in leaked:
        WATCHDOG.unregister_feed(key)
    WATCHDOG.evaluate()


@pytest.fixture(autouse=True)
def _clean():
    _quiet_watchdog()
    FLIGHT.clear()
    yield
    _quiet_watchdog()  # leave no alert of this test active
    FLIGHT.clear()


def _stuck_runs(runs):
    """One ``WATCHDOG.evaluate()`` over a feed of ``runs`` ((run_id,
    traceparent) pairs) ACTIVE for 1000 s: raises or re-observes the
    port's ``stuck_run`` alert of each. Returns the active alerts."""
    now = time.time()
    feed = {"runs": [{"run_id": rid, "task_id": 7, "status": "active",
                      "started_at": now - 1000.0, "traceparent": tp}
                     for rid, tp in runs]}
    WATCHDOG.register_feed("tools-test", lambda: feed)
    try:
        return WATCHDOG.evaluate()
    finally:
        WATCHDOG.unregister_feed("tools-test")


# ------------------------------------------------------------------- doctor
class TestDoctor:
    def _bundle(self, tmp_path, runs=((42, True),), repeat=1):
        """A bundle the port writes: a traced ``exec`` span with a log line
        inside it, an untraced log line beside it and one far away, and
        the ``stuck_run`` alert of each run (traced into the span's trace
        where asked), evaluated ``repeat`` times. Returns (path, trace)."""
        with TRACER.span("exec", kind="exec") as sp:
            log.info("later")
            trace = sp.context.trace_id
            tp = sp.context.to_traceparent()
        log.info("ambient")
        far = logging.LogRecord(log.name, logging.INFO, __file__, 0,
                                "far away untraced", None, None)
        far.created += 99999.0
        FLIGHT.record_log(record_to_dict(far))
        try:
            for _ in range(repeat):
                _stuck_runs([(rid, tp if traced else None)
                             for rid, traced in runs])
                time.sleep(0.01)
            path = FLIGHT.dump(path=str(tmp_path / "bundle.jsonl"),
                               reason="test")
        finally:
            WATCHDOG.evaluate()  # no feed: the alerts clear
        return path, trace

    def test_digest_explains_against_catalog(self, tmp_path, tracer):
        import tools.doctor as doctor

        path, trace = self._bundle(tmp_path)
        digest = doctor.alert_digest(doctor.load([path]))
        assert len(digest) == 1
        row = digest[0]
        assert row["rule"] == "stuck_run"
        assert row["summary"] == RULE_CATALOG["stuck_run"]["summary"]
        assert row["trace_id"] == trace

    def test_digest_dedups_on_labels_not_message(self, tmp_path, tracer):
        """One alert re-observed with a grown age in its message is ONE
        digest entry (key = rule+labels, the watchdog's own identity); a
        different run of the same rule is a second entry."""
        import tools.doctor as doctor

        path, _ = self._bundle(tmp_path, runs=((42, True), (7, False)),
                               repeat=3)
        recs = doctor.load([path])
        notes = [r for r in recs if r.get("kind") == "alert_raised"]
        alerts = [r for r in recs if r.get("type") == "alert"]
        assert len(notes) == 2 and len(alerts) == 2
        assert {a["count"] for a in alerts} == {3}
        digest = doctor.alert_digest(recs)
        assert len(digest) == 2
        assert {str(d["labels"].get("run_id")) for d in digest} == {"42", "7"}

    def test_timeline_merges_and_orders(self, tmp_path, tracer):
        import tools.doctor as doctor

        path, _ = self._bundle(tmp_path)
        rows = doctor.timeline(doctor.load([path]))
        ts = [r["ts"] for r in rows]
        assert ts == sorted(ts)
        # the watchdog's alert_raised notes join the logs and spans
        assert {r["type"] for r in rows} == {"log", "span", "note"}

    def test_trace_filter_keeps_ambient_window(self, tmp_path, tracer):
        import tools.doctor as doctor

        path, trace = self._bundle(tmp_path)
        rows = doctor.timeline(doctor.load([path]), trace=trace[:8],
                               window=5.0)
        msgs = {r.get("msg") or r.get("name") for r in rows}
        assert "exec" in msgs and "later" in msgs
        assert "ambient" in msgs            # untraced but inside window
        assert "far away untraced" not in msgs

    def test_cli_exit_codes(self, tmp_path, capsys, tracer):
        import tools.doctor as doctor

        path, _ = self._bundle(tmp_path)
        assert doctor.main([path]) == 0
        out = capsys.readouterr().out
        assert "run 42" in out and "stuck_run" in out
        empty = tmp_path / "empty.jsonl"
        empty.write_text("")
        assert doctor.main([str(empty)]) == 1


# ------------------------------------------------------- doctor / trace_view
class TestSurfaces:
    def test_summarize_learning_plane(self, tracer):
        h = RoundHistory("sv")
        with TRACER.span("root", kind="test") as root:
            tid = root.context.trace_id
            for i in range(4):
                h.record(
                    update_norm=4.0 - i, station_norms=[1.0, 2.0],
                    station_cos=[0.9, -0.3], loss=1.0 - 0.1 * i,
                    round_index=i,
                )
        s = summarize(TRACER.drain(tid))
        lp = s["learning_plane"]
        assert lp["n_rounds"] == 4
        task = lp["tasks"][0]
        assert task["task"] == "sv"
        assert task["first_update_norm"] == 4.0
        assert task["last_update_norm"] == 1.0
        assert task["norm_decay_pct"] == pytest.approx(75.0)
        assert task["min_station_cos"] == pytest.approx(-0.3)
        assert task["min_cos_station"] == 1

    def test_summarize_learning_plane_is_per_task(self, tracer):
        """Two tasks' interleaved rounds must not fabricate one merged
        trajectory — each task gets its own first->last norm."""
        ha, hb = RoundHistory("A"), RoundHistory("B")
        with TRACER.span("root", kind="test") as root:
            tid = root.context.trace_id
            for i in range(3):
                ha.record(update_norm=3.0 - i, station_norms=[1.0],
                          station_cos=[1.0], round_index=i)
                hb.record(update_norm=10.0 + i, station_norms=[1.0],
                          station_cos=[1.0], round_index=i)
        lp = summarize(TRACER.drain(tid))["learning_plane"]
        rows = {t["task"]: t for t in lp["tasks"]}
        assert rows["A"]["norm_decay_pct"] == pytest.approx(
            100 * 2 / 3.0, abs=0.01
        )
        assert rows["B"]["norm_decay_pct"] == pytest.approx(-20.0)

    def test_trace_view_renders_learning_callout(self, tracer, tmp_path):
        h = RoundHistory("tv")
        sink = tmp_path / "spans.jsonl"
        TRACER.configure(enabled=True, sample=1.0, sink=str(sink))
        with TRACER.span("root", kind="test"):
            h.record(
                update_norm=2.0, station_norms=[1.0], station_cos=[0.5],
            )
        TRACER.configure(sink=None)
        out = subprocess.run(
            [sys.executable, "tools/trace_view.py", str(sink)],
            capture_output=True, text=True, timeout=60,
        )
        assert out.returncode == 0
        assert "learning plane" in out.stdout

    def test_doctor_learning_digest(self, tmp_path, tracer):
        h = LEARNING.history("doc-task")
        rng = np.random.default_rng(1)
        for i in range(5):
            flat = rng.standard_normal((4, 8)).astype(np.float32)
            flat[1] = -10 * flat.mean(axis=0)  # station 1 contrarian
            st = update_stats_host(flat)
            h.record_stats(st, loss=1.0 - 0.1 * i)
        path = str(tmp_path / "bundle.jsonl")
        assert FLIGHT.dump(path=path, reason="test")
        out = subprocess.run(
            [sys.executable, "tools/doctor.py", path, "--json"],
            capture_output=True, text=True, timeout=60,
        )
        assert out.returncode == 0
        digest = json.loads(out.stdout)["learning"]
        assert digest is not None
        task = next(
            t for t in digest["tasks"] if t["task"] == "doc-task"
        )
        assert task["rounds_seen"] == 5
        assert len(task["stations"]) == 4
        # text render shows the table too
        out2 = subprocess.run(
            [sys.executable, "tools/doctor.py", path],
            capture_output=True, text=True, timeout=60,
        )
        assert "learning-plane digest" in out2.stdout
        assert "doc-task" in out2.stdout

    def test_flight_dump_carries_learning_summaries(self, tmp_path):
        h = LEARNING.history("fd")
        h.record(update_norm=1.0, station_norms=[1.0], station_cos=[1.0])
        path = FLIGHT.dump(path=str(tmp_path / "b.jsonl"), reason="t")
        recs = read_bundle(path)
        learning = [r for r in recs if r.get("type") == "learning"]
        assert any(r.get("task") == "fd" for r in learning)

    def test_check_collect_learning_audit_clean(self, tmp_path, monkeypatch):
        """``check_learning_plane`` audits the JAX package's files by path;
        here it reads the port's: its telemetry, watchdog and
        ``runtime/learning.py`` stand where the tool looks."""
        import tools.check_collect as cc
        from vantage6_tpu_torch.common import telemetry
        from vantage6_tpu_torch.runtime import watchdog

        root = tmp_path / "root"
        (root / "vantage6_tpu" / "runtime").mkdir(parents=True)
        (root / "vantage6_tpu" / "runtime" / "learning.py").write_text(
            open(sys.modules[LEARNING.__module__].__file__).read())
        monkeypatch.setattr(cc, "_REPO_ROOT", str(root))
        monkeypatch.setattr(sys, "path", [str(root)] + sys.path)
        monkeypatch.setitem(sys.modules, "vantage6_tpu.common.telemetry",
                            telemetry)
        monkeypatch.setitem(sys.modules, "vantage6_tpu.runtime.watchdog",
                            watchdog)
        assert cc.check_learning_plane() == []

    def test_metrics_snapshot_helper(self):
        from vantage6_tpu_torch.runtime.metrics import learning_snapshot

        LEARNING.history("ms").record(
            update_norm=1.0, station_norms=[1.0], station_cos=[1.0]
        )
        assert any(s["task"] == "ms" for s in learning_snapshot())
