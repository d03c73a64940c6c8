"""End-to-end distributed tracing + unified telemetry.

Covers:
- traceparent parse/format round-trip and malformed-header tolerance;
- Tracer semantics: nesting, require_parent, sampling propagation,
  bounded ring buffer with drop accounting, retroactive record_span,
  JSONL sink + read_spans on torn files;
- the telemetry registry: instruments, collectors (keyed replacement),
  Prometheus text rendering, name validation;
- GET /api/health + GET /api/metrics on the server (absorbed wire/REST/
  executor/event-hub/cache series) and the client util surface;
- trace metadata persisted on tasks (trace_id/traceparent via migration
  v6) and flowing through claim-batch;
- tools/trace_view.py (per-hop table + Perfetto export);
- the acceptance smoke: ONE task through a 4-daemon HTTP topology makes
  ONE trace covering client create → server dispatch → daemon claim →
  runner exec → result upload → aggregation, exporting valid Perfetto
  trace_event JSON.

The port's copy of ``tests/test_observability.py`` with its imports switched to
``vantage6_tpu_torch``.
"""
import json
import threading

import numpy as np
import pandas as pd
import pytest

from vantage6_tpu_torch.client import UserClient
from vantage6_tpu_torch.common.enums import TaskStatus
from vantage6_tpu_torch.common.telemetry import (
    REGISTRY,
    TelemetryRegistry,
    validate_metric_name,
)
from vantage6_tpu_torch.node.daemon import NodeDaemon
from vantage6_tpu_torch.runtime.tracing import (
    TRACER,
    Tracer,
    parse_traceparent,
    read_spans,
    summarize,
    to_trace_events,
)
from vantage6_tpu_torch.server.app import ServerApp


@pytest.fixture()
def tracer():
    """A fresh, fully-sampled tracer state on the GLOBAL tracer (the one
    the instrumented code paths use), restored afterwards."""
    TRACER.configure(enabled=True, sample=1.0, sink=None)
    TRACER.clear()
    yield TRACER
    TRACER.configure(enabled=True, sample=1.0, sink=None)


# ------------------------------------------------------------- traceparent
class TestTraceparent:
    def test_roundtrip(self, tracer):
        with tracer.span("root") as sp:
            tp = sp.context.to_traceparent()
        ctx = parse_traceparent(tp)
        assert ctx.trace_id == sp.context.trace_id
        assert ctx.span_id == sp.context.span_id
        assert ctx.sampled

    def test_unsampled_flag(self):
        ctx = parse_traceparent("00-" + "ab" * 16 + "-" + "cd" * 8 + "-00")
        assert ctx is not None and not ctx.sampled

    @pytest.mark.parametrize("bad", [
        None, "", "garbage", "00-short-short-01",
        "01-" + "ab" * 16 + "-" + "cd" * 8 + "-01",   # unknown version
        "00-" + "00" * 16 + "-" + "cd" * 8 + "-01",   # all-zero trace
        "00-" + "ab" * 16 + "-" + "00" * 8 + "-01",   # all-zero span
        "00-" + "AB" * 16,                            # truncated
    ])
    def test_malformed_headers_yield_none(self, bad):
        assert parse_traceparent(bad) is None


# ------------------------------------------------------------------ tracer
class TestTracer:
    def test_nesting_parents(self, tracer):
        with tracer.span("outer") as outer:
            with tracer.span("inner") as inner:
                pass
        spans = {s["name"]: s for s in tracer.drain(outer.context.trace_id)}
        assert spans["inner"]["parent_id"] == outer.context.span_id
        assert spans["outer"]["parent_id"] is None
        assert spans["inner"]["trace_id"] == spans["outer"]["trace_id"]

    def test_require_parent_without_parent_is_noop(self, tracer):
        before = tracer.stats()["spans_recorded"]
        with tracer.span("orphan", require_parent=True) as sp:
            assert sp.context is None
        assert tracer.stats()["spans_recorded"] == before

    def test_unsampled_trace_propagates_but_records_nothing(self, tracer):
        tracer.configure(sample=0.0)
        before = tracer.stats()["spans_recorded"]
        with tracer.span("root") as sp:
            # context still exists (ids propagate downstream as 00-flag)
            ctx = tracer.current_context()
            assert ctx is not None and not ctx.sampled
            with tracer.span("child"):
                pass
            assert sp.context is None  # NULL span
        assert tracer.stats()["spans_recorded"] == before

    def test_disabled_tracer_is_inert(self, tracer):
        tracer.configure(enabled=False)
        with tracer.span("x") as sp:
            assert sp.context is None
            assert tracer.current_context() is None

    def test_exception_marks_error_and_reraises(self, tracer):
        with pytest.raises(ValueError):
            with tracer.span("boom") as sp:
                raise ValueError("x")
        (rec,) = tracer.drain(sp.context.trace_id)
        assert rec["status"] == "error"

    def test_ring_buffer_bounded_with_drop_accounting(self):
        t = Tracer().configure(enabled=True, sample=1.0, buffer_size=8)
        for _ in range(20):
            with t.span("s"):
                pass
        assert len(t.drain()) == 8
        assert t.stats()["spans_dropped"] == 12

    def test_record_span_retroactive(self, tracer):
        with tracer.span("root") as root:
            parent = root.context
        ctx = tracer.record_span(
            "late", start_ts=123.0, dur=0.5, parent=parent, kind="claim",
            attrs={"run_id": 7},
        )
        assert ctx.trace_id == parent.trace_id
        rec = [
            s for s in tracer.drain(parent.trace_id) if s["name"] == "late"
        ][0]
        assert rec["parent_id"] == parent.span_id
        assert rec["ts"] == 123.0 and rec["dur"] == 0.5

    def test_record_span_without_parent_records_nothing(self, tracer):
        assert tracer.record_span("x", 0.0, 1.0, parent=None) is None

    def test_sink_jsonl_and_torn_tail(self, tmp_path, tracer):
        sink = tmp_path / "spans.jsonl"
        tracer.configure(sink=str(sink))
        with tracer.span("sunk"):
            pass
        tracer.configure(sink=None)  # flush/close
        with open(sink, "a") as fh:
            fh.write('{"trace_id": "torn')  # killed mid-write
        spans = read_spans(str(sink))
        assert [s["name"] for s in spans] == ["sunk"]

    def test_threads_have_independent_context(self, tracer):
        seen = {}

        def other():
            seen["ctx"] = tracer.current_context()

        with tracer.span("main-thread"):
            th = threading.Thread(target=other)
            th.start()
            th.join()
        assert seen["ctx"] is None


# ------------------------------------------------------------------ export
class TestExportAndSummary:
    def _make_spans(self, tracer):
        with tracer.span("root", service="client") as root:
            with tracer.span(
                "exec-a", kind="exec", service="daemon:a",
                attrs={"organization_id": 1},
            ):
                pass
            with tracer.span(
                "exec-b", kind="exec", service="daemon:b",
                attrs={"organization_id": 2},
            ):
                import time
                time.sleep(0.01)
        return tracer.drain(root.context.trace_id)

    def test_perfetto_export_shape(self, tracer):
        spans = self._make_spans(tracer)
        out = to_trace_events(spans)
        assert json.loads(json.dumps(out))  # JSON-serializable
        xs = [e for e in out["traceEvents"] if e["ph"] == "X"]
        metas = [e for e in out["traceEvents"] if e["ph"] == "M"]
        assert len(xs) == len(spans)
        assert {m["args"]["name"] for m in metas} == {
            "client", "daemon:a", "daemon:b",
        }
        for e in xs:
            assert e["ts"] > 0 and e["dur"] >= 0 and e["pid"] >= 1
            assert "trace_id" in e["args"]

    def test_summarize_straggler(self, tracer):
        spans = self._make_spans(tracer)
        s = summarize(spans)
        assert s["n_traces"] == 1
        assert s["spans"]["exec-b"]["count"] == 1
        # org 2 slept: it is the straggler
        assert s["straggler"]["station"] == "2"


# --------------------------------------------------------------- telemetry
class TestTelemetryRegistry:
    def test_counter_gauge_histogram_render(self):
        reg = TelemetryRegistry()
        reg.counter("v6t_test_total").inc(3)
        reg.gauge("v6t_test_gauge").set(1.5)
        h = reg.histogram("v6t_test_seconds", buckets=(0.1, 1.0))
        h.observe(0.05)
        h.observe(0.5)
        text = reg.render_prometheus()
        assert "v6t_test_total 3" in text
        assert "v6t_test_gauge 1.5" in text
        assert 'v6t_test_seconds_bucket{le="0.1"} 1' in text
        assert 'v6t_test_seconds_bucket{le="1.0"} 2' in text
        assert 'v6t_test_seconds_bucket{le="+Inf"} 2' in text
        assert "v6t_test_seconds_count 2" in text

    def test_get_or_create_idempotent_kind_conflict_raises(self):
        reg = TelemetryRegistry()
        c = reg.counter("v6t_x_total")
        assert reg.counter("v6t_x_total") is c
        with pytest.raises(ValueError):
            reg.gauge("v6t_x_total")

    def test_name_validation(self):
        for bad in ("CamelCase", "9starts_with_digit", "has-dash", ""):
            with pytest.raises(ValueError):
                validate_metric_name(bad)
        validate_metric_name("v6t_fine_name_2")

    def test_collector_keyed_replacement(self):
        reg = TelemetryRegistry()
        reg.register_collector("src", lambda: {"v6t_a": 1})
        assert reg.snapshot()["v6t_a"] == 1
        reg.register_collector("src", lambda: {"v6t_a": 2})
        assert reg.snapshot()["v6t_a"] == 2

    def test_broken_collector_skipped(self):
        reg = TelemetryRegistry()
        reg.counter("v6t_ok_total").inc()

        def boom():
            raise RuntimeError("dead source")

        reg.register_collector("dead", boom)
        assert reg.snapshot()["v6t_ok_total"] == 1  # scrape survives

    def test_global_registry_has_absorbed_series(self):
        snap = REGISTRY.snapshot()
        for name in (
            "v6t_wire_encode_bytes_total",
            "v6t_rest_calls_total",
            "v6t_executor_inflight_items",
            "v6t_trace_spans_recorded_total",
        ):
            assert name in snap, name


# ------------------------------------------------------------ server routes
class TestServerEndpoints:
    @pytest.fixture()
    def srv(self):
        app = ServerApp()
        app.ensure_root(password="rootpass123")
        yield app
        app.close()

    def test_health_capabilities(self, srv):
        h = srv.test_client().get("/api/health").json
        assert h["status"] == "ok"
        assert h["metrics"] == "/api/metrics"
        assert h["long_poll"] is True
        assert "version" in h and "tracing" in h

    def test_metrics_prometheus_text(self, srv):
        resp = srv.test_client().get("/api/metrics")
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.body.decode()
        # parseable: every sample line is "name{labels}? value"
        for line in text.strip().splitlines():
            if line.startswith("#"):
                continue
            name, value = line.rsplit(" ", 1)
            float(value)
            assert name
        for series in (
            "v6t_wire_encode_bytes_total",
            "v6t_rest_calls_total",
            "v6t_executor_inflight_items",
            "v6t_event_hub_buffer_len",
            "v6t_auth_cache_hits_total",
            "v6t_visibility_cache_entries",
            "v6t_http_requests_total",
            "v6t_server_uptime_seconds",
            "v6t_trace_buffer_len",
        ):
            assert series in text, series

    def test_event_hub_and_cache_gauges_move(self, srv):
        c = srv.test_client()
        r = c.post("/api/token/user",
                   {"username": "root", "password": "rootpass123"})
        c.token = r.json["access_token"]
        c.get("/api/whoami")
        c.get("/api/whoami")  # second resolve: cache hit
        srv.hub.emit("ping", {}, room="all")
        text = c.get("/api/metrics").body.decode()

        def value(name):
            for line in text.splitlines():
                if line.startswith(name + " "):
                    return float(line.split()[-1])
            raise AssertionError(f"{name} not in /metrics")

        assert value("v6t_event_hub_buffer_len") >= 1
        assert value("v6t_auth_cache_hits_total") >= 1
        assert value("v6t_auth_cache_entries") >= 1

    def test_task_carries_trace_metadata(self, srv, tracer):
        c = srv.test_client()
        r = c.post("/api/token/user",
                   {"username": "root", "password": "rootpass123"})
        c.token = r.json["access_token"]
        org = c.post("/api/organization", {"name": "tr"}).json
        collab = c.post(
            "/api/collaboration",
            {"name": "tr", "organization_ids": [org["id"]]},
        ).json
        with tracer.span("client.task_create", service="client") as sp:
            t = c.post(
                "/api/task",
                {"image": "img", "collaboration_id": collab["id"],
                 "organizations": [{"id": org["id"], "input": ""}]},
                headers={"traceparent": sp.context.to_traceparent()},
            ).json
        assert t["trace_id"] == sp.context.trace_id
        parsed = parse_traceparent(t["traceparent"])
        assert parsed.trace_id == sp.context.trace_id
        # untraced create → NULL metadata, not a crash
        t2 = c.post(
            "/api/task",
            {"image": "img", "collaboration_id": collab["id"],
             "organizations": [{"id": org["id"], "input": ""}]},
        ).json
        assert t2["trace_id"] is None and t2["traceparent"] is None
        # migration v6 applied
        from vantage6_tpu_torch.server.migrations import current_version

        assert current_version(srv.db) >= 6

    def test_server_span_joins_incoming_trace(self, srv, tracer):
        c = srv.test_client()
        with tracer.span("probe", service="client") as sp:
            c.get(
                "/api/health",
                headers={"traceparent": sp.context.to_traceparent()},
            )
        names = {
            s["name"] for s in tracer.drain(sp.context.trace_id)
        }
        assert "http GET /api/health" in names

    def test_untraced_request_mints_no_trace(self, srv, tracer):
        before = tracer.stats()["spans_recorded"]
        srv.test_client().get("/api/health")
        assert tracer.stats()["spans_recorded"] == before

    def test_long_poll_route_untimed(self, srv):
        from vantage6_tpu_torch.server.web import _HTTP_SECONDS

        c = srv.test_client()
        r = c.post("/api/token/user",
                   {"username": "root", "password": "rootpass123"})
        c.token = r.json["access_token"]
        before = _HTTP_SECONDS.snapshot()["count"]
        c.get("/api/event?since=0")  # long-poll route: counted, not timed
        assert _HTTP_SECONDS.snapshot()["count"] == before
        c.get("/api/health")         # ordinary route: timed
        assert _HTTP_SECONDS.snapshot()["count"] == before + 1

    def test_http_span_nests_inside_rest_span(self, srv, tracer):
        """Over real HTTP, the server's handler span must parent on the
        REST-hop span (hop minus nested server span = transport cost)."""
        http = srv.serve(port=0, background=True)
        try:
            client = UserClient(http.url)
            with tracer.span("probe", service="client") as sp:
                client.util.health()
            spans = {
                s["name"]: s for s in tracer.drain(sp.context.trace_id)
            }
            rest = spans["rest GET /api/health"]
            handler = spans["http GET /api/health"]
            assert rest["parent_id"] == sp.context.span_id
            assert handler["parent_id"] == rest["span_id"]
        finally:
            http.stop()


class TestEnvFailSoft:
    def test_malformed_env_knobs_fall_back(self, monkeypatch):
        monkeypatch.setenv("V6T_TRACE_SAMPLE", "0,5")
        monkeypatch.setenv("V6T_TRACE_BUFFER", "8k")
        t = Tracer()  # must not raise: a typo'd knob is not fatal
        assert t.sample == 1.0
        assert t._buf.maxlen == 8192

    def test_sink_failure_counted_and_disabled(self, tmp_path):
        t = Tracer().configure(
            enabled=True, sample=1.0,
            sink=str(tmp_path / "no_such_dir" / "x.jsonl"),
        )
        with t.span("s"):
            pass
        assert t.stats()["sink_errors"] == 1
        assert t.sink is None            # disabled after first failure
        assert len(t.drain()) == 1       # ring buffer unaffected


# ---------------------------------------------------------------- trace CLI
def _import_trace_view():
    import importlib.util
    import os

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tools", "trace_view.py",
    )
    spec = importlib.util.spec_from_file_location("trace_view", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestTraceView:
    def test_cli_table_and_export(self, tmp_path, tracer, capsys):
        sink = tmp_path / "trace.jsonl"
        tracer.configure(sink=str(sink))
        with tracer.span("root", service="client"):
            with tracer.span(
                "runner.exec", kind="exec",
                attrs={"organization_id": 4},
            ):
                pass
        tracer.configure(sink=None)
        trace_view = _import_trace_view()
        export = tmp_path / "perfetto.json"
        rc = trace_view.main([str(sink), "--export", str(export)])
        assert rc == 0
        out = capsys.readouterr().out
        assert "runner.exec" in out and "straggler station: 4" in out
        perfetto = json.loads(export.read_text())
        assert any(e["ph"] == "X" for e in perfetto["traceEvents"])

    def test_cli_empty_input(self, tmp_path, capsys):
        trace_view = _import_trace_view()
        empty = tmp_path / "empty.jsonl"
        empty.write_text("")
        assert trace_view.main([str(empty)]) == 1


class TestSandboxTraceABI:
    def test_wrap_algorithm_joins_trace_from_env(
        self, tmp_path, tracer, monkeypatch
    ):
        """The container ABI carries the trace: TaskRunner exports
        V6T_TRACEPARENT and wrap_algorithm executes under a span joined on
        it — so a sandboxed central's subtask REST calls propagate the
        task's trace (wrap_algorithm is a plain function; calling it
        in-process exercises the exact ABI without subprocess cost)."""
        import types

        from vantage6_tpu_torch.algorithm.wrap import wrap_algorithm
        from vantage6_tpu_torch.common.serialization import (
            deserialize,
            serialize,
        )

        seen = {}

        def probe():
            seen["ctx"] = TRACER.current_context()
            return {"ok": True}

        mod = types.ModuleType("obs_probe_algo")
        mod.probe = probe
        inp, outp = tmp_path / "in", tmp_path / "out"
        inp.write_bytes(serialize({"method": "probe"}))
        monkeypatch.setenv("INPUT_FILE", str(inp))
        monkeypatch.setenv("OUTPUT_FILE", str(outp))
        monkeypatch.setenv(
            "USER_REQUESTED_DATABASE_LABELS", ""
        )
        with tracer.span("runner.exec", kind="exec") as sp:
            monkeypatch.setenv(
                "V6T_TRACEPARENT", sp.context.to_traceparent()
            )
            wrap_algorithm(mod)
        assert deserialize(outp.read_bytes()) == {"ok": True}
        assert seen["ctx"] is not None
        assert seen["ctx"].trace_id == sp.context.trace_id
        names = {
            s["name"] for s in tracer.drain(sp.context.trace_id)
        }
        assert "algorithm.run" in names

    def test_runner_sandbox_env_carries_traceparent(
        self, tmp_path, tracer, monkeypatch
    ):
        """TaskRunner._run_sandbox exports the current trace context to
        the child's environment (captured without spawning a subprocess)."""
        import subprocess as sp_mod

        from vantage6_tpu_torch.node.runner import RunSpec, TaskRunner

        captured = {}

        def fake_run(cmd, env=None, **kw):
            captured["env"] = env
            (tmp_path / "work" / "run_1" / "output").write_bytes(
                __import__(
                    "vantage6_tpu_torch.common.serialization",
                    fromlist=["serialize"],
                ).serialize({"ok": True})
            )
            return types_namespace(returncode=0, stdout="", stderr="")

        class types_namespace:
            def __init__(self, **kw):
                self.__dict__.update(kw)

        runner = TaskRunner(
            algorithms={"img": "vantage6_tpu_torch.workloads.average"},
            databases=[{"label": "default", "type": "csv", "uri": "x"}],
            mode="sandbox",
            work_dir=tmp_path / "work",
        )
        monkeypatch.setattr(sp_mod, "run", fake_run)
        spec = RunSpec(
            run_id=1, task_id=1, image="img", method="partial_average",
            input_payload={"method": "partial_average"},
        )
        with tracer.span("runner.exec", kind="exec") as sp:
            runner.run(spec)
        assert captured["env"]["V6T_TRACEPARENT"] == (
            sp.context.to_traceparent()
        )


class TestSweepClaimAttribution:
    def test_sweep_prefetched_run_still_gets_claim_span(
        self, tmp_path, tracer
    ):
        """A run claimed by the anti-entropy SWEEP (not event dispatch)
        must still record a daemon.claim span — sweep-claimed runs are
        precisely the slow-dispatch cases the trace exists to explain."""
        rng = np.random.default_rng(9)
        srv = ServerApp()
        srv.ensure_root(password="rootpass123")
        http = srv.serve(port=0, background=True)
        d = None
        try:
            client = UserClient(http.url)
            client.authenticate("root", "rootpass123")
            org = client.organization.create(name="sweep0")
            csv = tmp_path / "sweep.csv"
            pd.DataFrame(
                {"age": rng.uniform(20, 80, 8).round(1)}
            ).to_csv(csv, index=False)
            collab = client.collaboration.create(
                name="sweep", organization_ids=[org["id"]]
            )
            ni = client.node.create(
                organization_id=org["id"], collaboration_id=collab["id"]
            )
            # the task is created while the daemon is OFFLINE: its
            # task-created event predates the daemon's startup cursor, so
            # the STARTUP SWEEP (claim-batch prefetch) is deterministically
            # what claims the run — the exact reconnect scenario whose
            # claim hop used to go unattributed
            t = client.task.create(
                collaboration=collab["id"],
                organizations=[org["id"]],
                image="v6-average-py",
                input_={"method": "partial_average",
                        "kwargs": {"column": "age"}},
            )
            d = NodeDaemon(
                api_url=http.url,
                api_key=ni["api_key"],
                algorithms={
                    "v6-average-py": "vantage6_tpu_torch.workloads.average"
                },
                databases=[{"label": "default", "type": "csv",
                            "uri": str(csv)}],
                mode="inline",
                poll_interval=0.1,
            )
            d.start()
            client.wait_for_results(t["id"], interval=0.1, timeout=60.0)
            spans = tracer.drain(client.trace_context(t["id"]).trace_id)
            claims = [s for s in spans if s["name"] == "daemon.claim"]
            assert len(claims) == 1
            assert claims[0]["dur"] > 0.0
            assert {s["name"] for s in spans} >= {
                "daemon.exec", "runner.exec", "daemon.report",
            }
        finally:
            if d is not None:
                d.stop()
            http.stop()
            srv.close()


# -------------------------------------------------------- acceptance smoke
N_SMOKE = 4
SMOKE_TASKS = 3


class TestTraceSmoke:
    def test_one_task_one_trace_across_four_daemons(self, tmp_path, tracer):
        """THE acceptance criterion: a federated task through the 4-daemon
        HTTP topology produces a single trace whose spans cover client
        create → server dispatch → daemon claim → runner exec → result
        upload → aggregation; the trace exports to valid Perfetto
        trace_event JSON and trace_view renders a per-hop table."""
        rng = np.random.default_rng(5)
        srv = ServerApp()
        srv.ensure_root(password="rootpass123")
        http = srv.serve(port=0, background=True)
        daemons = []
        try:
            client = UserClient(http.url)
            client.authenticate("root", "rootpass123")
            orgs, csvs = [], []
            for i in range(N_SMOKE):
                org = client.organization.create(name=f"obs{i}")
                csv = tmp_path / f"o{i}.csv"
                pd.DataFrame(
                    {"age": rng.uniform(20, 80, 16).round(1)}
                ).to_csv(csv, index=False)
                orgs.append(org)
                csvs.append(csv)
            collab = client.collaboration.create(
                name="obs",
                organization_ids=[o["id"] for o in orgs],
            )
            for i, org in enumerate(orgs):
                ni = client.node.create(
                    organization_id=org["id"],
                    collaboration_id=collab["id"],
                )
                d = NodeDaemon(
                    api_url=http.url,
                    api_key=ni["api_key"],
                    algorithms={
                        "v6-average-py": "vantage6_tpu_torch.workloads.average"
                    },
                    databases=[{"label": "default", "type": "csv",
                                "uri": str(csvs[i])}],
                    mode="inline",
                    poll_interval=0.1,
                )
                d.start()
                daemons.append(d)
            org_ids = [o["id"] for o in orgs]
            trace_ids = set()
            for _ in range(SMOKE_TASKS):
                t = client.task.create(
                    collaboration=collab["id"],
                    organizations=org_ids,
                    image="v6-average-py",
                    input_={"method": "partial_average",
                            "kwargs": {"column": "age"}},
                )
                res = client.wait_for_results(
                    t["id"], interval=0.1, timeout=60.0
                )
                ctx = client.trace_context(t["id"])
                assert ctx is not None
                assert t["trace_id"] == ctx.trace_id
                trace_ids.add(ctx.trace_id)
                with tracer.span(
                    "aggregate", kind="aggregate", service="client",
                    parent=ctx,
                ):
                    total = sum(r["sum"] for r in res)
                    count = sum(r["count"] for r in res)
                    assert count == N_SMOKE * 16 and total > 0
                runs = client.run.from_task(t["id"])
                assert all(
                    r["status"] == TaskStatus.COMPLETED.value for r in runs
                )
            # one trace per task, never cross-contaminated
            assert len(trace_ids) == SMOKE_TASKS
            last = ctx.trace_id
            spans = tracer.drain(last)
            names = {s["name"] for s in spans}
            for required in (
                "client.task_create",   # client create (trace root)
                "server.dispatch",      # server dispatch
                "daemon.claim",         # daemon claim
                "daemon.exec",
                "runner.exec",          # runner exec
                "daemon.report",        # result upload
                "client.wait_results",
                "aggregate",            # aggregation
            ):
                assert required in names, (required, sorted(names))
            # every daemon executed under THIS trace
            exec_orgs = {
                s["attrs"].get("organization_id")
                for s in spans if s["name"] == "runner.exec"
            }
            assert len(exec_orgs) == N_SMOKE
            # all spans share the task's trace; the root is task_create
            assert {s["trace_id"] for s in spans} == {last}
            roots = [s for s in spans if s["parent_id"] is None]
            assert [r["name"] for r in roots] == ["client.task_create"]
            # Perfetto export is valid trace_event JSON
            perfetto = to_trace_events(spans)
            json.dumps(perfetto)  # serializable
            xs = [e for e in perfetto["traceEvents"] if e["ph"] == "X"]
            assert len(xs) == len(spans)
            services = {
                e["args"]["name"] for e in perfetto["traceEvents"]
                if e["ph"] == "M"
            }
            assert "client" in services and "server" in services
            assert any(s.startswith("daemon:") for s in services)
            # per-hop table renders with the expected hops
            table = summarize(spans)["spans"]
            assert table["runner.exec"]["count"] == N_SMOKE
            assert table["daemon.report"]["count"] == N_SMOKE
            assert summarize(spans)["straggler"] is not None
        finally:
            for d in daemons:
                d.stop()
            http.stop()
            srv.close()
