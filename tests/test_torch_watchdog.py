"""The port's watchdog, flight recorder and log sinks, on the CPU.

Copies of the JAX package's suites with their imports switched to the
port (``tests/test_watchdog.py``'s ``TestRules``, ``TestEngine``,
``TestHealth``, ``TestFlightRecorder`` and
``TestTornTailUnderConcurrentWriter``; ``tests/test_learning.py``'s
``TestLearningRules``, whose two engine cases run the port's ``FedAvg`` on
the CPU), then the cross-package cases: every default rule's ``check`` on
the same feed dicts and metric history gives identical findings in both
packages, and the port's own wiring: the ``learning`` and
``device_plane`` feeds on ``WATCHDOG``, a ``Federation``'s feed naming a
run that a ``drop`` fault wedged, and ``alert`` records in a flight dump.
Sizes: a few stations, a few rounds.
"""
import importlib
import json
import logging
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch

from vantage6_tpu_torch.common.faults import FAULTS
from vantage6_tpu_torch.common.flight import FLIGHT, FlightRecorder, read_bundle
from vantage6_tpu_torch.common.log import (
    disable_json_sink,
    enable_json_sink,
    setup_logging,
)
from vantage6_tpu_torch.common.telemetry import KNOWN_METRICS, REGISTRY
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed.fedavg import FedAvg, FedAvgSpec
from vantage6_tpu_torch.runtime.learning import LEARNING
from vantage6_tpu_torch.runtime.metrics import read_jsonl
from vantage6_tpu_torch.runtime.tracing import TRACER, parse_traceparent, read_spans
from vantage6_tpu_torch.runtime.watchdog import (
    DEFAULT_RULES,
    RULE_CATALOG,
    SEVERITIES,
    WATCHDOG,
    AlertRule,
    RuleContext,
    Watchdog,
    default_rules,
    station_window_flags,
)

JWD = importlib.import_module("vantage6_tpu.runtime.watchdog")


@pytest.fixture(autouse=True)
def _clean_learning():
    LEARNING.clear()
    yield
    LEARNING.clear()


@pytest.fixture()
def tracer():
    TRACER.configure(enabled=True, sample=1.0, sink=None)
    TRACER.clear()
    yield TRACER
    TRACER.configure(enabled=True, sample=1.0, sink=None)


@pytest.fixture()
def wd():
    """A fresh engine instance (not the process singleton) so alert state
    never bleeds between tests."""
    return Watchdog(interval=60.0)


def ctx(snapshot=None, history=None, feeds=None, config=None, now=None):
    from collections import deque

    w = Watchdog(interval=60.0)
    cfg = dict(w.config)
    cfg.update(config or {})
    return RuleContext(
        snapshot or {},
        {k: deque(v) for k, v in (history or {}).items()},
        feeds or {},
        cfg,
        now if now is not None else time.time(),
    )


def rule(name):
    return next(r for r in DEFAULT_RULES if r.name == name)


# ---------------------------------------------------------------- the rules
class TestRules:
    def test_stuck_run_fires_past_deadline(self):
        now = time.time()
        c = ctx(
            feeds={"f": {"runs": [{
                "run_id": 7, "task_id": 3, "status": "active",
                "started_at": now - 100, "traceparent": "tp",
            }]}},
            config={"run_deadline_s": 5.0}, now=now,
        )
        found = rule("stuck_run").check(c)
        assert len(found) == 1
        assert "run 7" in found[0]["message"]
        assert found[0]["labels"] == {"run_id": 7, "task_id": 3}
        assert found[0]["traceparent"] == "tp"

    def test_stuck_run_quiet_within_deadline_and_for_pending(self):
        now = time.time()
        c = ctx(
            feeds={"f": {"runs": [
                {"run_id": 1, "task_id": 1, "status": "active",
                 "started_at": now - 1},
                {"run_id": 2, "task_id": 1, "status": "pending",
                 "assigned_at": now - 9999},
            ]}},
            config={"run_deadline_s": 5.0}, now=now,
        )
        assert rule("stuck_run").check(c) == []

    def test_stuck_run_recent_status_event_defers(self):
        now = time.time()
        c = ctx(
            feeds={"f": {"runs": [{
                "run_id": 1, "task_id": 1, "status": "active",
                "started_at": now - 100, "last_event_ts": now - 1,
            }]}},
            config={"run_deadline_s": 5.0}, now=now,
        )
        assert rule("stuck_run").check(c) == []

    def test_daemon_lapsed(self):
        now = time.time()
        c = ctx(
            feeds={"f": {"nodes": [
                {"node_id": 1, "name": "a", "status": "online",
                 "last_seen_at": now - 100},
                {"node_id": 2, "name": "b", "status": "online",
                 "last_seen_at": now - 1},
                {"node_id": 3, "name": "c", "status": "offline",
                 "last_seen_at": now - 9999},  # gracefully offline: fine
            ]}},
            config={"ping_window_s": 10.0}, now=now,
        )
        found = rule("daemon_lapsed").check(c)
        assert [f["labels"]["node_id"] for f in found] == [1]

    def test_straggler_needs_repetition_and_ratio(self):
        def rounds(station, n, ratio):
            return [
                {"task_id": i, "straggler_station": station,
                 "max_exec_s": ratio, "mean_exec_s": 1.0, "n": 4}
                for i in range(n)
            ]

        cfg = {"straggler_rounds": 3, "straggler_ratio": 3.0,
               "straggler_window": 8}
        assert rule("straggler_station").check(
            ctx(feeds={"f": {"rounds": rounds(2, 3, 5.0)}}, config=cfg)
        )[0]["labels"] == {"station": 2}
        # only twice: quiet
        assert rule("straggler_station").check(
            ctx(feeds={"f": {"rounds": rounds(2, 2, 5.0)}}, config=cfg)
        ) == []
        # often but mild skew: quiet
        assert rule("straggler_station").check(
            ctx(feeds={"f": {"rounds": rounds(2, 8, 1.5)}}, config=cfg)
        ) == []

    def test_queue_buildup_requires_sustained_backlog(self):
        now = time.time()
        cfg = {"queue_factor": 4.0, "queue_sustain_evals": 2}
        snap = {"v6t_executor_capacity": 2.0,
                "v6t_executor_inflight_items": 100.0}
        sustained = {
            "v6t_executor_inflight_items": [(now - 1, 100.0), (now, 100.0)]
        }
        spike = {
            "v6t_executor_inflight_items": [(now - 1, 0.0), (now, 100.0)]
        }
        assert rule("queue_buildup").check(
            ctx(snapshot=snap, history=sustained, config=cfg)
        )
        assert rule("queue_buildup").check(
            ctx(snapshot=snap, history=spike, config=cfg)
        ) == []
        # "sustained" is a wall-clock claim: two qualifying samples landed
        # milliseconds apart (an ad-hoc evaluate() racing the loop tick)
        # must NOT count, while the same samples a real interval apart do
        timed_cfg = {**cfg, "eval_interval_s": 5.0}
        burst = {
            "v6t_executor_inflight_items": [(now - 0.01, 100.0),
                                            (now, 100.0)]
        }
        assert rule("queue_buildup").check(
            ctx(snapshot=snap, history=burst, config=timed_cfg)
        ) == []
        spaced = {
            "v6t_executor_inflight_items": [(now - 5.0, 100.0),
                                            (now, 100.0)]
        }
        assert rule("queue_buildup").check(
            ctx(snapshot=snap, history=spaced, config=timed_cfg)
        )

    def test_event_cursor_lag_on_truncated_fetches(self):
        """Fires on ACTUAL truncated fetches, not on eviction alone —
        a busy server's full ring evicts on every emit as steady state."""
        now = time.time()
        snap = {"v6t_event_hub_evicted_through": 9000.0,
                "v6t_event_hub_cursor": 5000.0}
        lagging = {
            "v6t_event_truncated_total": [(now - 1, 2.0), (now, 5.0)]
        }
        # eviction churns but nobody asked for lost history: stays quiet
        healthy_churn = {
            "v6t_event_truncated_total": [(now - 1, 5.0), (now, 5.0)],
            "v6t_event_hub_evicted_through": [(now - 1, 100.0),
                                              (now, 9000.0)],
        }
        fired = rule("event_cursor_lag").check(
            ctx(snapshot=snap, history=lagging)
        )
        assert fired and "truncated" in fired[0]["message"]
        assert rule("event_cursor_lag").check(
            ctx(snapshot=snap, history=healthy_churn)
        ) == []
        # the FIRST truncation of a process lifetime: the engine zero-fills
        # the absent counter's history, so the rule sees 0 -> 1 and fires —
        # while a count that predates the watchdog (single sample, no
        # zero baseline recorded after it) must NOT read as a fresh jump
        first_ever = {"v6t_event_truncated_total": [(now - 1, 0.0),
                                                    (now, 1.0)]}
        assert rule("event_cursor_lag").check(
            ctx(snapshot=snap, history=first_ever)
        )
        preexisting = {"v6t_event_truncated_total": [(now, 7.0)]}
        assert rule("event_cursor_lag").check(
            ctx(snapshot=snap, history=preexisting)
        ) == []

    def test_ef_mass_growth_needs_monotonic_growth(self):
        now = time.time()
        cfg = {"ef_growth_evals": 3}
        mono = {"v6t_compress_ef_norm": [
            (now - i, v) for i, v in zip(range(4, -1, -1), [1, 2, 3, 4, 5])
        ]}
        wobbling = {"v6t_compress_ef_norm": [
            (now - i, v) for i, v in zip(range(4, -1, -1), [1, 2, 3, 2, 4])
        ]}
        assert rule("ef_mass_growth").check(ctx(history=mono, config=cfg))
        assert rule("ef_mass_growth").check(
            ctx(history=wobbling, config=cfg)
        ) == []

    def test_rule_audit_contract(self):
        """The exact invariants tools/check_collect.py gates on."""
        declared = {n for n, _k, _h in KNOWN_METRICS}
        names = [r.name for r in DEFAULT_RULES]
        assert len(names) == len(set(names))
        for r in DEFAULT_RULES:
            r.validate()
            assert r.severity in SEVERITIES
            assert set(r.metrics) <= declared, r.name
            assert r.name in RULE_CATALOG
            assert RULE_CATALOG[r.name]["runbook"]

    def test_rule_validate_rejects_bad_shapes(self):
        good = dict(severity="warning", summary="s", runbook="r",
                    metrics=(), check=lambda c: [])
        with pytest.raises(ValueError):
            AlertRule(name="CamelCase", **good).validate()
        with pytest.raises(ValueError):
            AlertRule(name="ok_name", **{**good, "severity": "bad"}).validate()
        with pytest.raises(ValueError):
            AlertRule(name="ok_name", **{**good, "runbook": ""}).validate()


# ------------------------------------------------------------------ engine
class TestEngine:
    def test_raise_dedup_clear_cycle(self, wd, tracer):
        state = {"runs": [{"run_id": 1, "task_id": 1, "status": "active",
                           "started_at": time.time() - 100}]}
        wd.configure(run_deadline_s=5.0)
        wd.register_feed("t", lambda: state)
        active = wd.evaluate()
        assert [a["rule"] for a in active] == ["stuck_run"]
        # second eval: same alert, deduplicated, count grows
        active = wd.evaluate()
        assert len(active) == 1 and active[0]["count"] == 2
        # fault healed: cleared into recent
        state["runs"] = []
        assert wd.evaluate() == []
        recent = wd.recent_alerts()
        assert recent[0]["rule"] == "stuck_run"
        assert recent[0]["resolved_at"] is not None

    def test_alert_span_lands_on_task_trace(self, wd, tracer):
        with tracer.span("client.task_create") as sp:
            tp = sp.context.to_traceparent()
            trace_id = sp.context.trace_id
        wd.configure(run_deadline_s=5.0)
        wd.register_feed("t", lambda: {"runs": [{
            "run_id": 9, "task_id": 2, "status": "active",
            "started_at": time.time() - 100, "traceparent": tp,
        }]})
        wd.evaluate()
        spans = tracer.drain(trace_id)
        names = {s["name"] for s in spans}
        assert "alert.stuck_run" in names
        alert_span = next(s for s in spans if s["name"] == "alert.stuck_run")
        assert alert_span["attrs"]["label_run_id"] == 9
        assert alert_span["events"][0]["name"] == "alert_raised"

    def test_telemetry_counters_and_gauges(self, wd):
        before = REGISTRY.snapshot()
        state = {"nodes": [{"node_id": 5, "name": "n", "status": "online",
                            "last_seen_at": time.time() - 999}]}
        wd.configure(ping_window_s=1.0)
        wd.register_feed("t", lambda: state)
        wd.evaluate()
        state["nodes"] = []
        wd.evaluate()
        after = REGISTRY.snapshot()
        assert after["v6t_alerts_raised_total"] >= before.get(
            "v6t_alerts_raised_total", 0) + 1
        assert after["v6t_alerts_cleared_total"] >= before.get(
            "v6t_alerts_cleared_total", 0) + 1
        assert after["v6t_watchdog_evaluations_total"] >= before.get(
            "v6t_watchdog_evaluations_total", 0) + 2
        assert after["v6t_alerts_active"] == 0

    def test_feed_failure_is_failsoft_and_counted(self, wd):
        calls = {"n": 0}

        def bad():
            calls["n"] += 1
            raise RuntimeError("db gone")

        wd.register_feed("bad", bad)
        before = REGISTRY.snapshot().get("v6t_watchdog_feed_errors_total", 0)
        assert wd.evaluate() == []
        assert wd.evaluate() == []
        assert calls["n"] == 2
        assert REGISTRY.snapshot()["v6t_watchdog_feed_errors_total"] >= before + 2

    def test_feed_failure_holds_active_alerts(self, wd):
        """A transiently failing feed is loss of evidence, not recovery:
        active alerts hold (same raised_at, no clear transition) until a
        clean evaluation stops proposing them."""
        state = {"runs": [{"run_id": 3, "task_id": 3, "status": "active",
                           "started_at": time.time() - 100}],
                 "fail": False}

        def feed():
            if state["fail"]:
                raise RuntimeError("database is locked")
            return {"runs": state["runs"]}

        wd.configure(run_deadline_s=5.0)
        wd.register_feed("t", feed)
        first = wd.evaluate()
        assert [a["rule"] for a in first] == ["stuck_run"]
        raised_at = first[0]["raised_at"]
        state["fail"] = True
        held = wd.evaluate()
        assert [a["rule"] for a in held] == ["stuck_run"]
        assert held[0]["raised_at"] == raised_at
        assert wd.recent_alerts() == []  # no flap through resolved
        # feed recovers, fault still present: the SAME alert continues
        state["fail"] = False
        again = wd.evaluate()
        assert again[0]["raised_at"] == raised_at and again[0]["count"] == 2
        # clean evaluation without the fault finally clears it
        state["runs"] = []
        assert wd.evaluate() == []
        assert wd.recent_alerts()[0]["resolved_at"] is not None

    def test_crashed_rule_holds_its_alerts(self, wd):
        """A rule that crashes mid-evaluation must not clear the alerts it
        raised earlier — only a successful pass that stops proposing them
        may."""
        state = {"mode": "fire"}

        def check(ctx):
            if state["mode"] == "crash":
                raise RuntimeError("boom")
            if state["mode"] == "fire":
                return [{"message": "m", "labels": {"k": 1}}]
            return []

        wd.add_rule(AlertRule(
            name="crashy_rule", severity="warning", summary="s",
            runbook="r", metrics=(), check=check,
        ))
        assert [a["rule"] for a in wd.evaluate()] == ["crashy_rule"]
        state["mode"] = "crash"
        assert [a["rule"] for a in wd.evaluate()] == ["crashy_rule"]
        assert wd.recent_alerts() == []
        state["mode"] = "quiet"
        assert wd.evaluate() == []
        assert wd.recent_alerts()[0]["rule"] == "crashy_rule"

    def test_unregister_feed_conditional(self, wd):
        f1, f2 = (lambda: None), (lambda: None)
        wd.register_feed("k", f1)
        wd.register_feed("k", f2)  # replacement
        wd.unregister_feed("k", f1)  # stale unregister: must not evict f2
        assert wd._feeds.get("k") is f2
        wd.unregister_feed("k", f2)
        assert "k" not in wd._feeds

    def test_duplicate_rule_rejected(self, wd):
        with pytest.raises(ValueError, match="duplicate"):
            wd.add_rule(default_rules()[0])

    def test_configure_rejects_unknown_key(self, wd):
        with pytest.raises(ValueError, match="unknown watchdog config"):
            wd.configure(not_a_knob=1)


# ------------------------------------------------------------------ health
class TestHealth:
    def test_components_fold_into_verdict(self, wd):
        assert wd.health()["status"] == "ok"
        wd.register_component("db", lambda: (False, "disk full"))
        h = wd.health()
        assert h["status"] == "degraded"
        assert h["components"]["db"] == {"ok": False, "detail": "disk full"}
        wd.register_component("db", lambda: True)  # bare-bool contract
        assert wd.health()["status"] == "ok"

    def test_raising_component_counts_as_failed(self, wd):
        wd.register_component("boom", lambda: 1 / 0)
        h = wd.health()
        assert h["status"] == "degraded"
        assert "self-check raised" in h["components"]["boom"]["detail"]

    def test_critical_alert_degrades(self, wd):
        wd.configure(run_deadline_s=1.0)
        wd.register_feed("t", lambda: {"runs": [{
            "run_id": 1, "task_id": 1, "status": "active",
            "started_at": time.time() - 100}]})
        wd.evaluate()
        h = wd.health()
        assert h["status"] == "degraded"
        assert h["alerts"] == {"active": 1, "critical": 1}

    def test_warning_alert_does_not_degrade(self, wd):
        wd.register_feed("t", lambda: {"nodes": []})
        wd.add_rule(AlertRule(
            name="test_warn", severity="warning", summary="s", runbook="r",
            metrics=(), check=lambda c: [{"message": "m", "labels": {}}],
        ))
        wd.evaluate()
        assert wd.health()["status"] == "ok"

    def test_self_check_states(self, wd):
        ok, detail = wd.self_check()
        assert ok and "on-demand" in detail
        wd.start(interval=0.05)
        try:
            deadline = time.time() + 5
            while wd.last_eval_at is None and time.time() < deadline:
                time.sleep(0.01)
            ok, _ = wd.self_check()
            assert ok
        finally:
            wd.stop()
        # stopped again: back to on-demand ok
        assert wd.self_check()[0]


# ---------------------------------------------------------- flight recorder
class TestFlightRecorder:
    def test_rings_are_bounded(self):
        fr = FlightRecorder(capacity=64)
        for i in range(200):
            fr.note("spam", i=i)
        assert fr.stats()["notes"] == 64

    def test_dump_and_read_bundle(self, tmp_path, tracer):
        fr = FlightRecorder(capacity=64)
        fr.record_log({"ts": time.time(), "level": "INFO", "msg": "x",
                       "trace_id": "", "span_id": "", "logger": "t",
                       "thread": 1})
        fr.note("rest_error", status=500)
        fr.snapshot_metrics()
        path = fr.dump(path=str(tmp_path / "b.jsonl"), reason="test",
                       detail="why")
        recs = read_bundle(path)
        types = {r["type"] for r in recs}
        assert {"flight_header", "log", "note", "metrics"} <= types
        header = recs[0]
        assert header["reason"] == "test" and header["detail"] == "why"
        assert fr.stats()["dumps_written"] == 1

    def test_read_bundle_skips_torn_tail(self, tmp_path):
        p = tmp_path / "torn.jsonl"
        p.write_text(
            json.dumps({"type": "note", "ts": 1.0, "kind": "k"}) + "\n"
            + '{"type": "note", "ts": 2.0, "kin'  # torn mid-write
        )
        recs = read_bundle(str(p))
        assert len(recs) == 1

    def test_log_tap_carries_trace_ids(self, tracer):
        log = setup_logging("vantage6_tpu_torch/test_flight_tap")
        FLIGHT.clear()
        with tracer.span("op") as sp:
            log.info("inside")
            trace_id = sp.context.trace_id
        logs = list(FLIGHT._logs)
        mine = [r for r in logs if r["msg"] == "inside"]
        assert mine and mine[-1]["trace_id"] == trace_id
        # the span itself was tapped too
        assert any(
            s["trace_id"] == trace_id for s in FLIGHT._spans
        )

    def test_json_sink_runtime_toggle(self, tmp_path, tracer):
        log = setup_logging("vantage6_tpu_torch/test_json_sink")
        path = tmp_path / "log.jsonl"
        enable_json_sink(str(path))
        try:
            with tracer.span("jop") as sp:
                log.warning("structured %s", "hello")
                trace_id = sp.context.trace_id
        finally:
            disable_json_sink()
        recs = read_jsonl(path)
        mine = [r for r in recs if r["msg"] == "structured hello"]
        assert mine and mine[0]["trace_id"] == trace_id
        assert mine[0]["level"] == "WARNING"
        # disabled: no further writes
        log.warning("after close")
        assert not any(
            r["msg"] == "after close" for r in read_jsonl(path)
        )

    def test_disable_is_sticky_against_env_resurrection(
        self, tmp_path, monkeypatch
    ):
        """disable_json_sink() must hold even when V6T_LOG_JSON is set: a
        later FIRST-time setup_logging (lazily-imported module) would
        otherwise silently re-arm the env sink the caller switched off."""
        from vantage6_tpu_torch.common import log as logmod

        path = tmp_path / "env.jsonl"
        monkeypatch.setenv("V6T_LOG_JSON", str(path))
        disable_json_sink()
        setup_logging("vantage6_tpu_torch/sticky-probe")
        assert logmod._JSON_HANDLER is None
        # an explicit re-enable clears the stickiness
        enable_json_sink(str(path))
        assert logmod._JSON_HANDLER is not None
        disable_json_sink()

    def test_install_is_idempotent_and_first_label_wins(self):
        from vantage6_tpu_torch.common import flight

        fr1 = flight.install(service="test-svc")
        named = FLIGHT.service  # "test-svc" only if WE were first to name
        fr2 = flight.install()
        assert fr1 is fr2 is FLIGHT
        # first-writer-wins: a later embedder (e.g. a daemon starting in a
        # server process) must not re-label the process-global recorder
        flight.install(service="late-relabel")
        assert FLIGHT.service == named

    def test_usr2_arming_retries_on_main_thread_install(self):
        """A background-thread first installer can't arm SIGUSR2 (only the
        main thread may set signal handlers); a later main-thread install
        must retry instead of finding the process marked installed and
        leaving the probe dead forever."""
        import signal

        from vantage6_tpu_torch.common import flight

        prev_handler = signal.getsignal(signal.SIGUSR2)
        prev_armed = flight._usr2_armed
        try:
            signal.signal(signal.SIGUSR2, signal.SIG_DFL)
            flight._usr2_armed = False
            t = threading.Thread(target=flight.install)
            t.start(); t.join()
            assert not flight._usr2_armed
            assert signal.getsignal(signal.SIGUSR2) is signal.SIG_DFL
            flight.install()  # main thread: the retry arms the probe
            assert flight._usr2_armed
            assert signal.getsignal(signal.SIGUSR2) is not signal.SIG_DFL
        finally:
            flight._usr2_armed = prev_armed
            signal.signal(signal.SIGUSR2, prev_handler)


# ----------------------------------------------- torn tails, live (satellite)
class TestTornTailUnderConcurrentWriter:
    def _hammer(self, path, make_line, reader, n_lines=300):
        """Writer thread appends (with flushes mid-line); reader polls
        concurrently — every successful read must parse cleanly."""
        stop = threading.Event()
        errors = []

        def write():
            with open(path, "w", buffering=1) as fh:
                for i in range(n_lines):
                    line = make_line(i)
                    # tear every 7th line across two unflushed writes
                    cut = len(line) // 2
                    fh.write(line[:cut])
                    fh.flush()
                    fh.write(line[cut:] + "\n")
            stop.set()

        def read():
            while not stop.is_set():
                try:
                    for rec in reader(path):
                        assert isinstance(rec, dict)
                except FileNotFoundError:
                    pass
                except Exception as e:  # pragma: no cover
                    errors.append(e)
                    return

        w = threading.Thread(target=write)
        r = threading.Thread(target=read)
        w.start(); r.start()
        w.join(timeout=30); r.join(timeout=30)
        assert not errors
        final = reader(path)
        assert len(final) == n_lines

    def test_read_spans_concurrent(self, tmp_path):
        self._hammer(
            str(tmp_path / "spans.jsonl"),
            lambda i: json.dumps(
                {"trace_id": f"t{i:04d}", "span_id": "s", "name": "n",
                 "ts": float(i), "dur": 0.0}
            ),
            read_spans,
        )

    def test_read_jsonl_concurrent(self, tmp_path):
        self._hammer(
            str(tmp_path / "metrics.jsonl"),
            lambda i: json.dumps({"event": "round", "round": i}),
            read_jsonl,
        )




# ------------------------------------------------------- the learning rules
def _toy_problem(S=4, n=16, d=3, flip=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, n, d)).astype(np.float32)
    beta = np.linspace(1.0, -1.0, d).astype(np.float32)
    y = (x @ beta + 0.01 * rng.standard_normal((S, n))).astype(np.float32)
    if flip is not None:
        y[flip] = -y[flip]

    def loss_fn(p, bx, by, w):
        pred = bx @ p
        return torch.sum(w * (pred - by) ** 2) / torch.clamp_min(
            torch.sum(w), 1.0)

    return (loss_fn, torch.from_numpy(x), torch.from_numpy(y),
            torch.full((S,), float(n)))


def _learning_feed(round_items, task_items):
    return {"learning": {
        "learning_rounds": round_items, "learning_tasks": task_items,
    }}


def _anomaly_rounds(n, station=2, cos=-0.8, stations=4):
    out = []
    for r in range(n):
        sts = []
        for s in range(stations):
            sts.append({
                "station": s,
                "norm": 1.0,
                "cos": cos if s == station else 0.95,
            })
        out.append({
            "task": "tk", "round": r, "ts": time.time(),
            "update_norm": 1.0, "median_norm": 1.0, "stations": sts,
        })
    return out


class TestLearningRules:
    def test_anomalous_station_fires_on_low_cos_and_names_stat(self):
        c = ctx(feeds=_learning_feed(_anomaly_rounds(5), []))
        found = rule("anomalous_station").check(c)
        assert len(found) == 1
        assert found[0]["labels"] == {"task": "tk", "station": 2}
        assert "station 2" in found[0]["message"]
        assert "cosine" in found[0]["message"]

    def test_anomalous_station_fires_on_norm_outlier(self):
        rounds = _anomaly_rounds(5, cos=0.95)  # all cosines healthy
        for r in rounds:
            r["stations"][1]["norm"] = 9.0  # 9x the median
        c = ctx(feeds=_learning_feed(rounds, []))
        found = rule("anomalous_station").check(c)
        assert len(found) == 1
        assert found[0]["labels"]["station"] == 1
        assert "norm" in found[0]["message"]
        assert "9.0x" in found[0]["message"]

    def test_anomalous_station_skips_masked_out_stations(self):
        """The runbook's remediation is 'mask the station' — once masked,
        its fictional SPMD-computed stats must stop feeding the alert,
        or the alert could never be cleared by its own runbook."""
        rounds = _anomaly_rounds(6)  # station 2 contrarian
        for r in rounds:
            r["stations"][2]["participating"] = False
        c = ctx(feeds=_learning_feed(rounds, []))
        assert rule("anomalous_station").check(c) == []

    def test_masked_station_excluded_end_to_end(self):
        """Engine round with a mask: the masked station's weight rides
        the stats, the feed marks it non-participating, and the median
        covers participants only."""
        loss_fn, x, y, counts = _toy_problem(flip=1)
        eng = FedAvg(FederationMesh(4, device="cpu"), FedAvgSpec(
            loss_fn=loss_fn, local_steps=1, batch_size=8
        ))
        hist = eng.attach_history("masked")
        mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
        p0 = torch.zeros(3)
        eng.round(p0, eng.init(p0), x, y, counts, 0, mask=mask)
        item = hist.feed_items()[0][-1]
        flags = {s["station"]: s["participating"] for s in item["stations"]}
        assert flags == {0: True, 1: False, 2: True, 3: True}
        live_norms = [
            s["norm"] for s in item["stations"] if s["participating"]
        ]
        assert item["median_norm"] == pytest.approx(
            float(np.median(live_norms))
        )

    def test_anomalous_station_window_is_per_task(self):
        """Concurrent tasks must not dilute each other's evidence: task
        A's poisoned station stays detectable even when other tasks'
        rounds dominate the merged feed's tail."""
        poisoned = _anomaly_rounds(6)  # task "tk", station 2 contrarian
        noise = []
        for i in range(20):  # 20 healthy rounds from OTHER tasks, newer
            r = _anomaly_rounds(1, cos=0.9)[0]
            r["task"] = f"other-{i % 4}"
            r["ts"] = time.time() + 1 + i
            noise.append(r)
        c = ctx(feeds=_learning_feed(poisoned + noise, []))
        found = rule("anomalous_station").check(c)
        assert len(found) == 1
        assert found[0]["labels"] == {"task": "tk", "station": 2}

    def test_anomalous_station_needs_repeats(self):
        c = ctx(feeds=_learning_feed(_anomaly_rounds(2), []))
        assert rule("anomalous_station").check(c) == []

    def test_anomalous_station_quiet_on_healthy(self):
        c = ctx(feeds=_learning_feed(_anomaly_rounds(8, cos=0.9), []))
        assert rule("anomalous_station").check(c) == []

    def test_anomalous_station_ignores_zero_norm_degenerates(self):
        """A station that sent NOTHING (zero-norm row) degenerates to
        cos == 0 — absence of signal, not a contrarian update; same for
        a zero pooled update. Neither may flag."""
        rounds = _anomaly_rounds(6, cos=0.95)
        for r in rounds:
            r["stations"][2]["norm"] = 0.0
            r["stations"][2]["cos"] = 0.0
        dead_pool = _anomaly_rounds(6, cos=0.0)
        for r in dead_pool:
            r["task"] = "tk2"
            r["update_norm"] = 0.0
        c = ctx(feeds=_learning_feed(rounds + dead_pool, []))
        assert rule("anomalous_station").check(c) == []

    def test_model_divergence_fires_on_monotone_growth(self):
        task = {"task": "tk", "rounds": 10, "peak_norm": 2.0,
                "recent_norms": [1.0, 1.2, 1.5, 1.9, 2.4]}
        found = rule("model_divergence").check(
            ctx(feeds=_learning_feed([], [task]))
        )
        assert len(found) == 1
        assert "diverging" in found[0]["message"]
        assert found[0]["labels"] == {"task": "tk"}

    def test_model_divergence_quiet_on_wobble_and_tiny_growth(self):
        wobble = {"task": "a", "rounds": 10, "peak_norm": 2.0,
                  "recent_norms": [1.0, 1.4, 1.2, 1.9, 2.4]}
        tiny = {"task": "b", "rounds": 10, "peak_norm": 2.0,
                "recent_norms": [1.0, 1.001, 1.002, 1.003, 1.004]}
        c = ctx(feeds=_learning_feed([], [wobble, tiny]))
        assert rule("model_divergence").check(c) == []

    def test_non_convergence_fires_past_budget(self):
        task = {"task": "tk", "rounds": 40, "peak_norm": 1.0,
                "recent_norms": [0.8] * 16}
        found = rule("non_convergence").check(
            ctx(feeds=_learning_feed([], [task]))
        )
        assert len(found) == 1
        assert "stalled" in found[0]["message"]

    def test_non_convergence_growth_message_names_the_rise(self):
        """Non-monotonic GROWTH past the budget is non-convergence too,
        but the message must say the norm rose, not 'fell only -80%'."""
        task = {"task": "tk", "rounds": 40, "peak_norm": 2.0,
                "recent_norms": [1.0, 1.5, 1.3, 1.8]}
        found = rule("non_convergence").check(
            ctx(feeds=_learning_feed([], [task]))
        )
        assert len(found) == 1
        assert "ROSE 80.0%" in found[0]["message"]
        assert "fell only" not in found[0]["message"]
        young = {"task": "a", "rounds": 5, "peak_norm": 1.0,
                 "recent_norms": [0.8] * 5}
        decaying = {"task": "b", "rounds": 40, "peak_norm": 1.0,
                    "recent_norms": [0.8 * (0.9 ** i) for i in range(16)]}
        c = ctx(feeds=_learning_feed([], [young, decaying]))
        assert rule("non_convergence").check(c) == []

    def test_non_convergence_quiet_when_converged_at_bottom(self):
        done = {"task": "tk", "rounds": 40, "peak_norm": 1.0,
                "recent_norms": [0.001] * 16}
        c = ctx(feeds=_learning_feed([], [done]))
        assert rule("non_convergence").check(c) == []

    def test_rules_in_catalog(self):
        for name in (
            "anomalous_station", "model_divergence", "non_convergence",
        ):
            assert name in RULE_CATALOG
            assert RULE_CATALOG[name]["runbook"]

    def test_shared_helper_counts_and_worst(self):
        rounds = [
            {"v": [("a", 1.0, "one")]},
            {"v": [("a", 3.0, "three"), ("b", 1.0, "b1")]},
            {"v": []},
        ]
        counts, worst, n = station_window_flags(
            rounds, 2, lambda r: r["v"]
        )
        # window=2 drops the first round
        assert n == 2
        assert counts == {"a": 1, "b": 1}
        assert worst["a"] == (3.0, "three")

    def test_straggler_still_fires_through_helper(self):
        rounds = [
            {"straggler_station": 2, "max_exec_s": 9.0,
             "mean_exec_s": 1.0, "n": 4}
            for _ in range(4)
        ]
        found = rule("straggler_station").check(
            ctx(feeds={"f": {"rounds": rounds}})
        )
        assert len(found) == 1
        assert found[0]["labels"] == {"station": 2}
        assert "9.0x the round mean" in found[0]["message"]

    def test_end_to_end_engine_to_alert(self):
        """Label-flipped station through the REAL pipeline: engine stats →
        LEARNING feed → singleton-registered feed → rule fires naming it."""
        loss_fn, x, y, counts = _toy_problem(flip=3, seed=5)
        eng = FedAvg(FederationMesh(4, device="cpu"), FedAvgSpec(
            loss_fn=loss_fn, local_steps=2, batch_size=8, local_lr=0.05
        ))
        hist = eng.attach_history("e2e")
        p0 = torch.zeros(3)
        eng.run_rounds(p0, x, y, counts, 0, 5, donate=False)
        assert hist.rounds_total == 5
        wd = Watchdog(interval=60.0)
        wd.register_feed("learning", LEARNING.feed)
        active = wd.evaluate()
        anomalies = [a for a in active if a["rule"] == "anomalous_station"]
        assert len(anomalies) == 1
        assert anomalies[0]["labels"]["station"] == 3



# ------------------------------------------------- the two packages' rules
def _firing_state(now):
    """(snapshot, history, feeds, config) under which every default rule
    proposes a finding."""
    snapshot = {"v6t_executor_capacity": 2.0,
                "v6t_executor_inflight_items": 100.0,
                "v6t_event_hub_evicted_through": 9000.0,
                "v6t_event_hub_cursor": 5000.0}
    history = {
        "v6t_executor_inflight_items": [(now - 5.0, 100.0), (now, 100.0)],
        "v6t_event_truncated_total": [(now - 1, 2.0), (now, 5.0)],
        "v6t_compress_ef_norm": [(now - 4 + i, 1.0 + i) for i in range(5)],
        "v6t_jit_retraces_total": [(now - 4 + i, float(2 * i))
                                   for i in range(5)],
        "v6t_device_mem_bytes_in_use": [(now - 4 + i, 1e9 * 1.1 ** i)
                                        for i in range(5)],
    }
    rounds = _anomaly_rounds(5)
    for r in _anomaly_rounds(5, station=1, cos=0.95):
        r["task"] = "tk2"
        r["stations"][1]["norm"] = 9.0
        rounds.append(r)
    dispatch = [{"metric": "v6t_run_dispatch_seconds", "source": "daemon:slow",
                 "ts": now - 1.0 - i, "value": 5.0} for i in range(6)]
    throughput = (
        [{"metric": "v6t_round_updates_total", "source": "srv",
          "ts": now - age, "value": 600.0 - age}
         for age in (590.0, 400.0, 200.0, 70.0)]
        + [{"metric": "v6t_round_updates_total", "source": "srv",
            "ts": now - age, "value": 530.0} for age in (50.0, 5.0)])
    feeds = {
        "server": {
            "runs": [{"run_id": 7, "task_id": 3, "status": "active",
                      "started_at": now - 100, "traceparent": "tp"}],
            "nodes": [{"node_id": 1, "name": "a", "status": "online",
                       "last_seen_at": now - 100}],
            "replicas": [{"replica_id": "r1", "pid": 4, "alive": False,
                          "last_seen_at": now - 30}],
            "slo_dispatch": dispatch,
            "slo_rounds": throughput,
            "fleet_sources": [
                {"source": "daemon:ok", "service": "daemon", "age_s": 1.0,
                 "stale": False},
                {"source": "daemon:gone", "service": "daemon",
                 "age_s": 500.0, "stale": True}],
        },
        "federation": {"rounds": [
            {"task_id": i, "straggler_station": 2, "max_exec_s": 5.0,
             "mean_exec_s": 1.0, "n": 4} for i in range(4)]},
        "device_plane": {"retraces": [
            {"function": "fedavg.round", "ts": now,
             "changed": "[0][1]: float32[8,4] -> float32[9,4]"}]},
        **_learning_feed(rounds, [
            {"task": "div", "rounds": 10, "peak_norm": 2.4,
             "recent_norms": [1.0, 1.2, 1.5, 1.9, 2.4]},
            {"task": "stall", "rounds": 40, "peak_norm": 1.0,
             "recent_norms": [0.8] * 16}]),
    }
    config = {"run_deadline_s": 5.0, "ping_window_s": 10.0,
              "ef_growth_evals": 3, "slo_dispatch_target_s": 0.5,
              "slo_error_budget": 0.25, "slo_burn_threshold": 2.0,
              "slo_fast_window_s": 60.0, "slo_slow_window_s": 600.0,
              "slo_liveness_ratio": 0.75, "eval_interval_s": 5.0}
    return snapshot, history, feeds, config


def _findings(pkg, state, now):
    snapshot, history, feeds, config = state
    cfg = dict(pkg.Watchdog(interval=60.0).config)
    cfg.update(config)
    c = pkg.RuleContext(snapshot, {k: deque(v) for k, v in history.items()},
                        feeds, cfg, now)
    return {r.name: r.check(c) for r in pkg.DEFAULT_RULES}


@pytest.mark.parametrize("firing", [True, False])
def test_every_rule_gives_the_jax_packages_findings(firing):
    """The 15 default rules, their names, severities and runbooks, and
    their findings on the same feed dicts and history: identical."""
    assert len(DEFAULT_RULES) == 15
    assert RULE_CATALOG == JWD.RULE_CATALOG
    assert ([(r.name, r.severity, r.metrics) for r in DEFAULT_RULES]
            == [(r.name, r.severity, r.metrics) for r in JWD.DEFAULT_RULES])
    now = time.time()
    state = _firing_state(now) if firing else ({}, {}, {}, {})
    ours, theirs = _findings(importlib.import_module(
        "vantage6_tpu_torch.runtime.watchdog"), state, now), \
        _findings(JWD, state, now)
    assert ours == theirs
    if firing:
        assert all(ours.values()), [n for n, f in ours.items() if not f]
    else:
        assert not any(ours.values())


def test_engine_config_is_the_jax_packages():
    assert Watchdog(interval=60.0).config == JWD.Watchdog(
        interval=60.0).config


# ------------------------------------------------------- the port's feeds
def test_learning_and_device_plane_feeds_are_registered():
    importlib.import_module("vantage6_tpu_torch.runtime.profiling")
    assert WATCHDOG.has_feed("learning")
    assert WATCHDOG.has_feed("device_plane")


def test_federation_feed_names_a_wedged_run():
    """A ``drop`` fault leaves a host run ACTIVE; the Federation's feed
    hands it to ``stuck_run``, and ``close()`` unregisters the feed."""
    from vantage6_tpu_torch.algorithm import data
    from vantage6_tpu_torch.runtime.federation import federation_from_datasets

    @data(1)
    def total(d):
        return float(np.sum(d["x"]))

    fed = federation_from_datasets(
        [{"x": np.arange(4.0) + i} for i in range(3)],
        {"img": {"total": total}}, executor_workers=0, device="cpu")
    assert WATCHDOG.has_feed(fed._watchdog_key)
    FAULTS.configure("drop:station=1")
    try:
        task = fed.create_task("img", {"method": "total"})
    finally:
        FAULTS.clear()
    wedged = [r for r in task.runs if r.station_index == 1][0]
    wd = Watchdog(interval=60.0).configure(run_deadline_s=0.0)
    wd.register_feed("fed", fed.watchdog_feed)
    time.sleep(0.01)
    stuck = [a for a in wd.evaluate() if a["rule"] == "stuck_run"]
    assert [a["labels"] for a in stuck] == [
        {"run_id": wedged.id, "task_id": task.id}]
    state = fed.watchdog_feed()
    assert state["stations_masked"] == [] and state["admission_limited"] \
        is False
    fed.close()
    assert not WATCHDOG.has_feed(fed._watchdog_key)


def test_flight_dump_carries_alert_records(tmp_path):
    state = {"nodes": [{"node_id": 4, "name": "n4", "status": "online",
                        "last_seen_at": time.time() - 600.0}]}
    WATCHDOG.register_feed("test-flight-alerts", lambda: state)
    try:
        WATCHDOG.evaluate()
        recs = read_bundle(FLIGHT.dump(path=str(tmp_path / "b.jsonl"),
                                       reason="test"))
    finally:
        WATCHDOG.unregister_feed("test-flight-alerts")
        WATCHDOG.evaluate()
    alerts = [r for r in recs if r["type"] == "alert"]
    assert any(a["rule"] == "daemon_lapsed" and a["labels"] == {"node_id": 4}
               for a in alerts)
    assert not any(a["labels"] == {"node_id": 4}
                   for a in WATCHDOG.active_alerts())
