"""The port's device observatory against the JAX package's, on the CPU.

An observed function keys each call on its abstract signature; the same
call sequence must give the JAX package's dispatch, retrace and
static-sweep counts and the same ``changed`` string naming the leaf
(shape before -> after). The fused runner's cache (``FUSED_CACHE_SIZE``
captured rounds; on the CPU a runner is built without a capture) makes
one ``device.compile`` event per build, counts evictions, and marks the
33rd-and-back signature ``evicted_recompile``, not a retrace.
``profile_window`` writes a ``torch.profiler`` Chrome trace (CPU activity
here) and refuses a second window while one is open. The port's
``v6t_jit_*``, ``v6t_engine_cache_*``, ``v6t_round_*`` and
``v6t_station_*`` series are the set the JAX modules emit.
"""
import importlib
import inspect
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vantage6_tpu_torch.common.flight import FLIGHT
from vantage6_tpu_torch.common.telemetry import KNOWN_METRICS, REGISTRY
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed import compression as C
from vantage6_tpu_torch.fed import fedavg as tf
from vantage6_tpu_torch.runtime import learning as TL
from vantage6_tpu_torch.runtime import profiling as P
from vantage6_tpu_torch.runtime.tracing import TRACER

JP = importlib.import_module("vantage6_tpu.runtime.profiling")


@pytest.fixture(autouse=True)
def _fresh():
    P.DEVICE_OBS.clear()
    yield
    P.DEVICE_OBS.configure(enabled=True, max_signatures=32)


def _counts(fn):
    s = fn.stats()
    return (s["dispatches"], s["signatures"], s["retraces"],
            s["static_sweeps"])


@pytest.mark.parametrize("shapes", [
    [(8, 4), (8, 4), (9, 4)],
    [(3,), (3,), (3,), (5,), (3,)],
    [(2, 2), (2, 3), (2, 4), (2, 2)],
])
def test_signatures_and_retraces_match_jax(shapes):
    JP.DEVICE_OBS.clear()
    ours = P.observed_jit("t.double", lambda x: x * 2)
    theirs = JP.observed_jit("t.double", lambda x: x * 2)
    for shape in shapes:
        ours(torch.ones(shape))
        theirs(jnp.ones(shape))
    assert _counts(ours) == _counts(theirs)[:1] + (
        theirs.n_signatures(), theirs.retraces, theirs.static_sweeps)
    mine = [r["changed"] for r in P.DEVICE_OBS.recent_retraces()
            if r["function"] == "t.double"]
    ref = [r["changed"] for r in JP.DEVICE_OBS.recent_retraces()
           if r["function"] == "t.double"]
    assert mine == ref
    JP.DEVICE_OBS.clear()


def test_retrace_is_noted_in_the_flight_recorder_and_the_feed():
    FLIGHT.clear()
    before = REGISTRY.snapshot().get("v6t_jit_retraces_total", 0)
    f = P.observed_jit("t.note", lambda x, y: x + y)
    f(torch.ones(8, 4), torch.ones(4))
    f(torch.ones(9, 4), torch.ones(4))
    notes = [r for r in FLIGHT._notes if r["kind"] == "retrace"]
    assert notes[-1]["function"] == "t.note"
    assert notes[-1]["changed"] == "[0][0]: float32[8,4] -> float32[9,4]"
    assert P.DEVICE_OBS.watchdog_feed()["retraces"][-1]["function"] == \
        "t.note"
    assert REGISTRY.snapshot()["v6t_jit_retraces_total"] == before + 1


def test_device_dtype_and_scalar_leaves_key_the_signature():
    f = P.observed_jit("t.kinds", lambda x, k: x)
    f(torch.ones(3), 1)
    f(torch.ones(3), 7)  # another int: the same signature
    assert f.stats()["retraces"] == 0
    f(torch.ones(3, dtype=torch.float64), 7)
    assert P.DEVICE_OBS.recent_retraces()[-1]["changed"] == (
        "[0][0]: float32[3] -> float64[3]")
    f(torch.ones(3, dtype=torch.float64), torch.Generator())
    assert "generator" in P.DEVICE_OBS.recent_retraces()[-1]["changed"]
    assert f.stats()["dispatches"] == 4 and f.n_signatures() == 3


def test_static_sweeps_are_not_retraces():
    ours = P.observed_jit("t.k", lambda x, k=1: x * k,
                          static_argnames=("k",), sweep_statics=("k",))
    theirs = JP.observed_jit("t.k", lambda x, k=1: x * k,
                             static_argnames=("k",), sweep_statics=("k",))
    for k in (1, 2, 2, 5):
        ours(torch.ones(3), k=k)
        theirs(jnp.ones(3), k=k)
    assert ours.static_sweeps == theirs.static_sweeps == 2
    assert ours.retraces == theirs.retraces == 0
    JP.DEVICE_OBS.clear()


def test_evicted_signature_is_not_a_retrace():
    P.DEVICE_OBS.configure(max_signatures=2)
    f = P.observed_jit("t.evict", lambda x: x)
    for n in (1, 2, 3, 1):
        f(torch.ones(n))
    assert f.n_signatures() == 2
    assert f.retraces == 2  # 2 and 3 are new; 1 again was evicted


def test_disabled_observatory_forwards_untouched():
    P.DEVICE_OBS.configure(enabled=False)
    f = P.observed_jit("t.off", lambda x: x + 1)
    assert torch.equal(f(torch.zeros(2)), torch.ones(2))
    assert f.stats()["dispatches"] == 0


def test_runner_cache_and_engine_cache_series():
    snap = REGISTRY.snapshot()
    cache = P.RunnerCache("t.runners", max_entries=2)
    built = []
    for key in ("a", "a", "b", "c", "a"):
        cache.get_or_create(key, lambda k=key: built.append(k) or k)
    assert built == ["a", "b", "c", "a"] and len(cache) == 2
    after = REGISTRY.snapshot()
    assert after["v6t_engine_cache_hits_total"] == snap.get(
        "v6t_engine_cache_hits_total", 0) + 1
    assert after["v6t_engine_cache_misses_total"] == snap.get(
        "v6t_engine_cache_misses_total", 0) + 4
    assert P.DEVICE_OBS.engine_cache_stats()["t.runners"] == {
        "hits": 1, "misses": 4, "entries": 2}
    P.engine_cache_event("t.other", True, entries=3)
    assert REGISTRY.snapshot()["v6t_engine_cache_entries"] == 5


def _engine():
    def loss(params, bx, by, w):
        return torch.sum(w * (bx @ params["w"] - by) ** 2) / torch.sum(w)

    return tf.FedAvg(FederationMesh(2, device="cpu"),
                     tf.FedAvgSpec(loss_fn=loss, local_steps=1, batch_size=2))


def test_fused_cache_compiles_evicts_and_marks_the_recompile():
    eng = _engine()
    params, idx = {"w": torch.zeros(3)}, np.zeros((2, 1, 2), np.int64)
    ev0 = REGISTRY.snapshot().get("v6t_jit_cache_evictions_total", 0)
    c0 = REGISTRY.snapshot().get("v6t_jit_compiles_total", 0)

    def run(n, k=1):
        eng.run_rounds(params, torch.ones(2, n, 3), torch.ones(2, n),
                       np.full(2, float(n)), None, k, batch_idx=idx)

    with TRACER.span("test.fused", kind="test") as root:
        for n in range(1, 34):
            run(n)
        run(33)          # cached: a dispatch, no compile
        run(33, k=3)     # a swept static: no compile either
        run(1)           # evicted by the 33rd: built again
        trace_id = root.context.trace_id
    spans = [s for s in TRACER.drain(trace_id)
             if s["name"] == "device.compile"]
    assert len(spans) == 34
    assert spans[0]["attrs"]["retrace"] is False
    assert spans[1]["attrs"]["retrace"] is True
    assert spans[1]["attrs"]["changed"] == (
        "[0][1]: float32[2,1,3] -> float32[2,2,3]")
    assert spans[1]["attrs"]["function"] == "fedavg.run_rounds"
    last = spans[-1]["attrs"]
    assert last["evicted_recompile"] is True and last["retrace"] is False
    assert "capture_ms" not in last  # nothing is captured on the CPU
    snap = REGISTRY.snapshot()
    assert snap["v6t_jit_cache_evictions_total"] == ev0 + 2
    assert snap["v6t_jit_compiles_total"] == c0 + 34
    st = eng._run.stats()
    assert (st["compiles"], st["retraces"], st["static_sweeps"],
            st["evictions"], st["dispatches"]) == (34, 32, 1, 2, 36)
    assert len(eng._fused) == 32 and eng._fused.evictions == 2


def test_round_dispatches_are_observed():
    eng = _engine()
    params, idx = {"w": torch.zeros(3)}, np.zeros((2, 1, 2), np.int64)
    for _ in range(3):
        eng.round(params, eng.init(params), torch.ones(2, 4, 3),
                  torch.ones(2, 4), np.full(2, 4.0), batch_idx=idx)
    assert eng._round.stats()["dispatches"] == 3
    assert eng._round.n_signatures() == 1
    assert eng._round.stats()["compiles"] == 0  # eager: nothing built


def test_compress_delta_retrace_names_the_flat_leaf():
    spec = C.CompressorSpec(topk_ratio=0.5)
    C.compress_delta(spec, np.ones(100, np.float32), device="cpu")
    C.compress_delta(spec, np.ones(120, np.float32), device="cpu")
    rec = P.DEVICE_OBS.recent_retraces()[-1]
    assert rec == {**rec, "function": "compress.delta",
                   "changed": "[0][0]: float32[100] -> float32[120]"}


def test_profile_window_writes_a_trace_and_holds_one_window(tmp_path):
    FLIGHT.clear()

    def work():
        with pytest.raises(P.ProfileBusyError):
            P.profile_window(0.05)
        a = torch.randn(64, 64)
        return a @ a

    with TRACER.span("test.profile", kind="test") as root:
        out = P.profile_window(log_dir=str(tmp_path / "w"), run=work)
        trace_id = root.context.trace_id
    assert out["path"] == str(tmp_path / "w") and out["trace_id"] == trace_id
    events = json.load(open(out["trace"]))["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)
    assert P.trace_kernel_events(out["trace"]) == 0  # no card here
    notes = [r for r in FLIGHT._notes if r["kind"] == "profile_window"]
    assert notes[-1]["path"] == out["path"]
    assert [s["name"] for s in TRACER.drain(trace_id)].count(
        "device.profile") == 1
    # the window is free again
    assert P.profile_window(0.05, log_dir=str(tmp_path / "v"))["seconds"] \
        == 0.05


def test_device_memory_collector(monkeypatch):
    assert P._device_mem_collector() == {} or torch.cuda.is_available()
    from vantage6_tpu_torch.runtime import metrics

    monkeypatch.setattr(metrics, "device_memory_all", lambda: [
        {"id": 0, "bytes_in_use": 10, "peak_bytes": 30},
        {"id": 1, "bytes_in_use": 5, "peak_bytes": 40}])
    assert P._device_mem_collector() == {
        "v6t_device_count": 2.0, "v6t_device_mem_bytes_in_use": 15.0,
        "v6t_device_mem_peak_bytes": 40.0}


def _series(module) -> set[str]:
    pat = r'"(v6t_(?:jit|engine_cache|round|station|device)_\w+)"'
    return set(re.findall(pat, inspect.getsource(module)))


def test_series_names_match_the_jax_modules():
    jax_names = (_series(JP)
                 | _series(importlib.import_module(
                     "vantage6_tpu.runtime.learning")))
    ours = _series(P) | _series(TL)
    # no eager counterpart of XLA's cost/memory analysis: never set
    assert ours == jax_names - {"v6t_jit_compile_temp_bytes",
                                "v6t_jit_compile_flops"}
    assert REGISTRY.snapshot()["v6t_jit_fallbacks_total"] == 0
    known = {name for name, _, _ in KNOWN_METRICS}
    assert ours <= known | {"v6t_device_count"}
