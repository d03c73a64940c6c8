"""The port's runtime core on the CPU: task and run records, the station
executor pool, metrics, telemetry and tracing, checkpoints, guards, data
loading and the algorithm decorators, each beside the JAX package's where
the two can run the same inputs."""
import importlib
import threading
import time

import numpy as np
import pytest
import torch

from vantage6_tpu_torch.algorithm import context as tctx
from vantage6_tpu_torch.algorithm import data_loading as tload
from vantage6_tpu_torch.algorithm import decorators as tdeco
from vantage6_tpu_torch.common import telemetry as ttel
from vantage6_tpu_torch.common.enums import TaskStatus
from vantage6_tpu_torch.core.config import DatabaseConfig, default_config_dir
from vantage6_tpu_torch.optim import adam
from vantage6_tpu_torch.runtime import checkpoint as tckpt
from vantage6_tpu_torch.runtime import metrics as tmet
from vantage6_tpu_torch.runtime import task as ttask
from vantage6_tpu_torch.runtime.executor import StationExecutor
from vantage6_tpu_torch.runtime.tracing import TRACER, to_trace_events
from vantage6_tpu_torch.utils import guards

jtask = importlib.import_module("vantage6_tpu.runtime.task")
jmet = importlib.import_module("vantage6_tpu.runtime.metrics")
jload = importlib.import_module("vantage6_tpu.algorithm.data_loading")
jconfig = importlib.import_module("vantage6_tpu.core.config")


# ------------------------------------------------------------------ records
def _task(mod, statuses):
    t = mod.new_task(name="t", method="m", image="img",
                     organizations=["a", "b", "c"][:len(statuses)],
                     parent_id=4, collaboration="c")
    for i, st in enumerate(statuses):
        r = mod.new_run(task_id=t.id, organization=f"org_{i}",
                        station_index=i)
        if st == "active":
            r.start()
        elif st == "completed":
            r.start() and r.finish({"i": i})
        elif st == "crashed":
            r.start() and r.crash("trace")
        elif st == "killed":
            r.kill()
        t.runs.append(r)
    return t


@pytest.mark.parametrize("statuses", [
    [], ["pending", "pending"], ["active", "completed"],
    ["completed", "completed"], ["completed", "crashed", "active"],
    ["killed", "completed"], ["pending", "completed"],
])
def test_task_rollup_and_wire_shape_match_the_jax_packages(statuses):
    ours, theirs = _task(ttask, statuses), _task(jtask, statuses)
    assert ours.status.value == theirs.status.value
    assert ours.is_finished == theirs.is_finished
    assert ours.results() == theirs.results()
    a, b = ours.to_dict(), theirs.to_dict()
    for d in (a, b):  # ids come from each package's own counters
        d.pop("id")
        for r in d["runs"]:
            r.pop("id")
    assert a == b


def test_run_transitions_are_terminal_sticky():
    r = ttask.new_run(task_id=1, organization="o", station_index=0)
    assert r.kill() and r.status == TaskStatus.KILLED
    assert not r.start() and not r.finish(1) and not r.crash("x")
    assert r.result is None and r.status == TaskStatus.KILLED
    r2 = ttask.new_run(task_id=1, organization="o", station_index=0)
    r2.mark_queued()
    assert r2.start() and r2.finish({"ok": 1}) and not r2.kill()
    assert r2.status.is_finished and not r2.status.has_failed
    assert r2.queued_at <= r2.started_at <= r2.finished_at


# ----------------------------------------------------------------- executor
@pytest.mark.parametrize("workers", [1, 3])
def test_executor_serializes_each_station(workers):
    """Per-station FIFO at any pool size: one station's items never
    overlap and run in submission order; stations run side by side."""
    ex = StationExecutor(3, workers)
    log, lock = [], threading.Lock()

    def item(s, k):
        def run():
            t0 = time.perf_counter()
            time.sleep(0.01)
            with lock:
                log.append((s, k, t0, time.perf_counter()))
        return run

    try:
        for k in range(4):
            for s in range(3):
                ex.submit(s, item(s, k))
        assert ex.drain(timeout=10)
    finally:
        ex.close()
    assert len(log) == 12
    for s in range(3):
        mine = [e for e in log if e[0] == s]
        assert [e[1] for e in sorted(mine, key=lambda e: e[2])] == [0, 1, 2, 3]
        for a, b in zip(sorted(mine, key=lambda e: e[2]),
                        sorted(mine, key=lambda e: e[2])[1:]):
            assert a[3] <= b[2]
    assert ex.stats()["inflight"] == 0


def test_executor_help_while_waiting_at_one_worker():
    """A running item that waits on another station's item claims it
    itself (the nested fan-out rule): no deadlock with one thread."""
    ex = StationExecutor(2, 1)
    done = threading.Event()

    def inner():
        done.set()

    def outer():
        ex.submit(1, inner)
        deadline = time.monotonic() + 5
        while not done.is_set() and time.monotonic() < deadline:
            ex.help_or_wait(0.01)

    try:
        ex.submit(0, outer)
        assert ex.drain(timeout=5)
    finally:
        ex.close()
    assert done.is_set()
    with pytest.raises(ValueError):
        StationExecutor(2, 0)
    with pytest.raises(RuntimeError, match="shut down"):
        ex.submit(0, inner)


# ------------------------------------------------------------------ metrics
def _timed_runs(mod):
    runs = []
    for i, (q, s, f) in enumerate([(1.0, 1.5, 3.0), (1.0, 2.0, 2.5),
                                   (None, None, None)]):
        r = mod.new_run(task_id=1, organization=f"o{i}", station_index=i,
                        input_wire_bytes=100, assigned_at=0.5)
        r.queued_at, r.started_at, r.finished_at = q, s, f
        if f is not None:
            r.result_wire_bytes = 40 + i
        runs.append(r)
    return runs


def test_run_lifecycle_and_round_decomposition_match_the_jax_packages():
    ours, theirs = _timed_runs(ttask), _timed_runs(jtask)
    for a, b in zip(ours, theirs):
        da, db = tmet.run_lifecycle(a), jmet.run_lifecycle(b)
        da.pop("run_id"), db.pop("run_id")
        assert da == db
    assert tmet.round_decomposition(ours) == jmet.round_decomposition(theirs)
    dec = tmet.round_decomposition(ours)
    assert dec["straggler_station"] == 0 and dec["untimed_stations"] == [2]
    w = tmet.wire_totals(ours)
    assert (w["wire_bytes_out"], w["wire_bytes_in"]) == (300, 81)
    assert set(w["wire_stats"]) == set(jmet.wire_totals(theirs)["wire_stats"])


def test_metrics_logger_jsonl(tmp_path):
    path = tmp_path / "m" / "metrics.jsonl"
    with tmet.MetricsLogger(path) as log:
        with log.round_timer(0, rounds_per_dispatch=5):
            time.sleep(0.001)
        log.log("loss", value=torch.tensor([1.5, 2.0]), arr=np.float32(3))
    log.log("late", x=1)  # after close: counted, not raised
    assert log.dropped_after_close == 1
    with open(path, "a") as f:
        f.write('{"torn": ')  # a killed writer's last line
    recs = tmet.read_jsonl(path)
    assert [r["event"] for r in recs] == ["round", "loss"]
    assert recs[0]["rounds_per_dispatch"] == 5 and recs[0]["seconds"] > 0
    assert recs[1]["value"] == [1.5, 2.0] and recs[1]["arr"] == 3.0


def test_device_memory_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmet.device_memory_all() == []
    assert tmet.device_peak_bytes() is None
    assert tmet.device_peak_bytes("cpu") is None


# ------------------------------------------------------ telemetry, tracing
def test_registry_collects_wire_and_executor_not_rest():
    """The wire, executor and tracing collectors report; since the port's
    ``common/rest.py`` landed, so does the ``rest`` collector, as in the
    JAX package (the name is kept from when it did not)."""
    ex = StationExecutor(2, 2)
    try:
        snap = ttel.REGISTRY.snapshot()
    finally:
        ex.close()
    assert snap["v6t_executor_pools"] >= 1
    assert snap["v6t_executor_capacity"] >= 2
    assert "v6t_wire_encode_calls_total" in snap
    assert "v6t_trace_spans_recorded_total" in snap
    assert "v6t_rest_calls_total" in snap
    text = ttel.REGISTRY.render_prometheus()
    assert "# TYPE v6t_executor_pools gauge" in text
    jtel = importlib.import_module("vantage6_tpu.common.telemetry")
    assert ttel.KNOWN_METRICS == jtel.KNOWN_METRICS


def test_tracing_nests_and_exports():
    TRACER.clear()
    with TRACER.span("a", kind="dispatch", service="federation") as root:
        with TRACER.span("b", kind="exec", service="federation",
                         require_parent=True):
            pass
    with TRACER.span("orphan", kind="exec", require_parent=True):
        pass  # no parent: not recorded
    spans = TRACER.drain(root.trace_id)
    assert sorted(s["name"] for s in spans) == ["a", "b"]
    events = to_trace_events(spans)["traceEvents"]
    assert sum(e.get("ph") == "X" for e in events) == 2


# -------------------------------------------------------------- checkpoint
def test_checkpoint_round_trip_is_bit_identical(tmp_path):
    gen = torch.Generator().manual_seed(5)
    params = {"w": torch.randn(3, 4, generator=gen), "b": torch.zeros(4)}
    opt = adam(1e-3)
    state = opt.init(params)
    _, state = opt.update(params, state._replace(count=torch.tensor(2)))
    mgr = tckpt.CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    for r in (3, 7, 9):
        mgr.save(tckpt.TrainState(params, state, r, gen))
    assert mgr.rounds() == [7, 9] and mgr.latest_round() == 9
    back = mgr.restore(device="cpu")
    assert back.round_index == 9
    for a, b in ((back.params, params), (back.opt_state.mu, state.mu),
                 (back.opt_state.nu, state.nu)):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert torch.equal(back.opt_state.count, state.count)
    expect = torch.rand(5, generator=gen)
    assert torch.equal(torch.rand(5, generator=back.generator("cpu")), expect)
    assert not (tmp_path / "ckpt" / "round_3.pt").exists()
    mgr.close()


def test_checkpoint_restore_without_cuda_requires_explicit_cpu(
        tmp_path, monkeypatch):
    mgr = tckpt.CheckpointManager(tmp_path)
    mgr.save(tckpt.TrainState({"w": torch.ones(2)}, (), 1,
                              torch.Generator().get_state()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.restore()
    assert mgr.restore(device="cpu").params["w"].device.type == "cpu"


def test_checkpoint_resume_continues_training(tmp_path):
    """2 FedAvg rounds after a restore equal 2 uninterrupted rounds."""
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    eng = W.make_engine(n_stations=2, local_steps=1, batch_size=4,
                        device="cpu", learning_stats=False)
    sx, sy, counts = W.make_federated_data(2, n_per_station=8)
    p0 = W.init_params(0, device="cpu")

    def rounds(params, state, gen, n):
        for _ in range(n):
            params, state, _, _ = eng.round(params, state, sx, sy, counts,
                                            key=gen)
        return params, state

    gen = torch.Generator().manual_seed(1)
    p, s = rounds(p0, eng.init(p0), gen, 2)
    mgr = tckpt.CheckpointManager(tmp_path)
    mgr.save(tckpt.TrainState(p, s, 2, gen))
    straight = rounds(p, s, gen, 2)[0]
    back = mgr.restore(device="cpu")
    resumed = rounds(back.params, back.opt_state, back.generator("cpu"), 2)[0]
    assert all(torch.equal(resumed[k][n], straight[k][n])
               for k in straight for n in straight[k])


# ------------------------------------------------------------------- guards
def test_guards_are_a_no_op_on_the_cpu():
    x = torch.arange(4.0)
    with guards.no_implicit_transfers():
        assert float(x.sum()) == 6.0  # no CUDA stream: nothing to catch
    with guards.log_transfers():
        assert x.tolist() == [0.0, 1.0, 2.0, 3.0]


def test_guard_sets_and_restores_the_sync_debug_mode(monkeypatch):
    modes = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with pytest.raises(KeyError):
        with guards.no_implicit_transfers():
            raise KeyError("inside")
    with guards.log_transfers():
        pass
    assert modes == ["error", 0, "warn", 0]


# -------------------------------------------------- data loading, decorators
def test_array_loading_matches_the_jax_packages(tmp_path):
    np.savez(tmp_path / "d.npz", x=np.arange(6.0).reshape(3, 2),
             y=np.arange(3))
    np.save(tmp_path / "a.npy", np.ones((2, 2)))
    for uri in ("d.npz", "a.npy"):
        ours = tload.load_data(DatabaseConfig("d", "array", str(tmp_path / uri)))
        theirs = jload.load_data(jconfig.DatabaseConfig(
            "d", "array", str(tmp_path / uri)))
        if isinstance(ours, dict):
            assert sorted(ours) == sorted(theirs)
            assert all(np.array_equal(ours[k], theirs[k]) for k in ours)
        else:
            assert np.array_equal(ours, theirs)
    sentinel = object()
    assert tload.load_data(DatabaseConfig("d", "array"), data=sentinel) \
        is sentinel
    with pytest.raises(ValueError, match="no uri"):
        tload.load_data(DatabaseConfig("d", "array"))
    with pytest.raises(ValueError, match="unknown database type"):
        tload.load_data(DatabaseConfig("d", "mongo", "x"))


def test_csv_and_sqlite_loading_match_the_jax_packages(tmp_path):
    import sqlite3

    (tmp_path / "a.csv").write_text("x,y\n1,2\n3,4\n")
    db = tmp_path / "d.db"
    with sqlite3.connect(db) as conn:
        conn.execute("create table t (v real)")
        conn.executemany("insert into t values (?)", [(1.5,), (2.5,)])
    cases = [("csv", str(tmp_path / "a.csv"), {}),
             ("sql", f"sqlite:///{db}", {"query": "select v from t"})]
    for kind, uri, opts in cases:
        ours = tload.load_data(DatabaseConfig("d", kind, uri, opts))
        theirs = jload.load_data(jconfig.DatabaseConfig("d", kind, uri, opts))
        assert ours.equals(theirs)


def test_egress_gate_blocks_remote_hosts():
    class Deny:
        def allows(self, uri):
            return False

    with pytest.raises(PermissionError, match="egress"):
        tload.load_data(DatabaseConfig("d", "csv", "https://h.example/a.csv"),
                        whitelist=Deny())


def test_decorators_inject_from_the_environment():
    @tdeco.data(2)
    @tdeco.algorithm_client
    @tdeco.metadata
    def fn(meta, client, df1, df2, k=0):
        return meta.task_id, client, df1, df2, k

    env = tctx.AlgorithmEnvironment(
        dataframes=["a", "b", "c"], client="C",
        metadata=tctx.RunMetadata(task_id=9))
    with tctx.algorithm_environment(env):
        assert fn(k=1) == (9, "C", "a", "b", 1)
    with pytest.raises(RuntimeError, match="no algorithm environment"):
        fn()
    assert tdeco.is_v6t_function(fn) and fn.__v6t_n_dataframes__ == 2
    assert not tdeco.is_v6t_function(len)
    step = tdeco.device_step(lambda d: d)
    assert step.__v6t_device_step__ and tdeco.is_v6t_function(step)
    with tctx.algorithm_environment(tctx.AlgorithmEnvironment(
            dataframes=["only"])):
        with pytest.raises(RuntimeError, match="requests 2"):
            fn()


def test_default_config_dir_is_the_jax_packages(monkeypatch, tmp_path):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    assert default_config_dir() == jconfig.default_config_dir()
    assert default_config_dir() == tmp_path / "vantage6_tpu"
