"""The readers of the program's round phases (``portbench/spans.py`` and
the seven ``layer_metrics`` that use it) against synthetic traces worked
by hand, one of them with a range on one thread whose kernels another
thread launches, as autograd's backward does; and, on the card
(``pytest -m cuda benchmark/tests``), a replayed flagship round under the
profiler."""
import contextlib
import json
import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT))

from portbench import cells, spans, trace  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
GPT2 = ["gpt2-medium.ctx1024", "gpt2-medium.ctx128"]
CNN = ["cnn-flagship.dense", "cnn-flagship.topk-int8"]
METRICS = {
    "forward_ms": ("station forward", GPT2),
    "backward_ms": ("station backward", GPT2),
    "local_train_ms": ("station local training", CNN),
    "compress_ms": ("compression", ["cnn-flagship.topk-int8"]),
    "aggregate_ms": ("aggregation", GPT2 + CNN),
    "server_update_ms": ("server step", GPT2 + CNN),
    "dispatch_host_ms": ("fused dispatch (host)", CNN),
}
MAIN, AUTOGRAD = 1, 2


def _round_trace():
    """Two rounds of two stations, in us: each station's ``fed.forward``
    on the main thread launches its kernels from there; its
    ``fed.backward``, opened on the main thread, has its kernels launched
    from autograd's thread; then ``fed.aggregate`` and ``server.update``;
    the loss's copy after them, outside every phase."""
    ranges, device, launches = [], [], {}
    corr = 0

    def kernel(name, t_launch, tid, dur):
        nonlocal corr
        corr += 1
        launches[corr] = (t_launch, tid)
        device.append((name, t_launch + 5.0, dur, corr))

    t = 100.0
    for _ in range(2):
        for _ in range(2):
            ranges.append(("fed.forward", t, 50.0, MAIN))
            kernel("gemm", t + 10.0, MAIN, 30.0)
            kernel("softmax", t + 40.0, MAIN, 8.0)
            t += 50.0
            ranges.append(("fed.backward", t, 80.0, MAIN))
            # autograd's thread: a range of its own, and the launches
            ranges.append(("attention_bwd", t + 10.0, 30.0, AUTOGRAD))
            kernel("gemm_bwd", t + 15.0, AUTOGRAD, 60.0)
            kernel("attn_bwd", t + 20.0, AUTOGRAD, 20.0)
            t += 80.0
        ranges.append(("fed.aggregate", t, 20.0, MAIN))
        kernel("mean", t + 5.0, MAIN, 4.0)
        t += 20.0
        ranges.append(("server.update", t, 30.0, MAIN))
        kernel("adam", t + 5.0, MAIN, 12.0)
        kernel("adam", t + 6.0, MAIN, 12.0)
        t += 30.0
        kernel("copy_loss", t + 1.0, MAIN, 1.0)
        t += 10.0
    # a kernel without a launch record, and a range outside the window
    device.append(("orphan", 120.0, 7.0, 999))
    ranges.append(("fed.forward", t + 500.0, 50.0, MAIN))
    kernel("late", t + 510.0, MAIN, 100.0)
    return trace.Trace(window=(0.0, t + 10.0), device=device,
                       launches=launches, ranges=ranges, host=[], rounds=2)


def _ctx(tr, replays=None):
    return types.SimpleNamespace(trace=tr, _phase_replays=replays)


def _read(name, ctx):
    return cells.reader("layer_metrics", name).read(ctx)


# ---------------------------------------------------------------- spans
def test_a_range_counts_launches_from_another_thread():
    tr = _round_trace()
    # by thread, as Trace.under_range matches: none of the backward's
    calls, seconds = tr.under_range("fed.backward")
    assert calls == 4 and seconds == 0.0
    # by time, on any thread: every backward kernel, 4 x (60 + 20) us
    assert spans.device_seconds(tr, "fed.backward") == pytest.approx(320e-6)
    assert spans.device_seconds(tr, "fed.forward") == pytest.approx(152e-6)
    assert spans.device_seconds(tr, "fed.aggregate") == pytest.approx(8e-6)
    assert spans.device_seconds(tr, "server.update") == pytest.approx(48e-6)


def test_the_phases_cover_the_rounds_but_the_loss_copy():
    tr = _round_trace()
    phases = sum(spans.device_seconds(tr, n) for n in (
        "fed.forward", "fed.backward", "fed.aggregate", "server.update"))
    # the window's device time but the two loss copies, the orphan and
    # the kernel launched after the window's end
    assert phases == pytest.approx(528e-6)


def test_nested_ranges_of_one_name_count_once():
    tr = _round_trace()
    t0, d = tr.ranges[0][1], tr.ranges[0][2]
    tr.ranges.append(("fed.forward", t0 + 5.0, d - 10.0, AUTOGRAD))
    assert spans.device_seconds(tr, "fed.forward") == pytest.approx(152e-6)
    assert spans.host_seconds(tr, "fed.forward") == pytest.approx(200e-6)


def test_no_range_or_no_launch_inside_reads_nothing():
    tr = _round_trace()
    assert spans.device_seconds(tr, "fed.compress") is None
    assert spans.host_seconds(tr, "fedavg.dispatch") is None
    tr.ranges.append(("fed.stats", 1.0, 2.0, MAIN))
    assert spans.device_seconds(tr, "fed.stats") is None


def test_host_seconds_are_the_ranges_own_time():
    tr = _round_trace()
    assert spans.host_seconds(tr, "server.update") == pytest.approx(60e-6)
    # a window in which the card ran nothing, as on the CPU
    tr.device = []
    assert spans.host_seconds(tr, "server.update") is None


# --------------------------------------------------------------- readers
def test_eager_readers_give_milliseconds_a_round():
    ctx = _ctx(_round_trace())
    assert _read("forward_ms", ctx) == pytest.approx(0.076)
    assert _read("backward_ms", ctx) == pytest.approx(0.160)
    assert _read("aggregate_ms", ctx) == pytest.approx(0.004)
    assert _read("server_update_ms", ctx) == pytest.approx(0.024)
    for name in ("local_train_ms", "compress_ms", "dispatch_host_ms"):
        assert _read(name, ctx) is None


REPLAYS = [{"fed.local_train": 18.0, "fed.compress": 2.5, "fed.stats": 0.5,
            "fed.aggregate": 0.25, "server.update": 0.125},
           {"fed.local_train": 20.0, "fed.compress": 2.7, "fed.stats": 0.5,
            "fed.aggregate": 0.75, "server.update": 0.375}]


def _replay_trace():
    """Two dispatches of a replayed round: each ``fedavg.dispatch`` holds
    ``fedavg.inputs`` and ``fedavg.replay``, whose graph launch runs the
    round's kernels; no phase range inside the graph."""
    ranges, device, launches = [], [], {}
    for k, t in enumerate((0.0, 30000.0)):
        ranges += [("fedavg.dispatch", t, 2000.0 + k * 500.0, MAIN),
                   ("fedavg.inputs", t + 10.0, 300.0, MAIN),
                   ("fedavg.replay", t + 400.0, 1500.0, MAIN)]
        launches[k] = (t + 900.0, MAIN)
        device.append(("graph_kernel", t + 950.0, 21000.0, k))
    return trace.Trace(window=(-10.0, 60000.0), device=device,
                       launches=launches, ranges=ranges, host=[], rounds=2)


def test_replayed_readers_take_the_programs_times():
    ctx = _ctx(_replay_trace(), REPLAYS)
    assert _read("local_train_ms", ctx) == pytest.approx(19.0)
    assert _read("compress_ms", ctx) == pytest.approx(2.6)
    assert _read("aggregate_ms", ctx) == pytest.approx(0.5)
    assert _read("server_update_ms", ctx) == pytest.approx(0.25)
    # the dispatch's host time under the profiler: (2000 + 2500) us / 2
    assert _read("dispatch_host_ms", ctx) == pytest.approx(2.25)
    for name in ("forward_ms", "backward_ms"):
        assert _read(name, ctx) is None


def test_a_phase_the_replays_lack_falls_back_to_the_trace():
    tr = _round_trace()
    ctx = _ctx(tr, [{"fed.local_train": 3.0}])
    assert _read("aggregate_ms", ctx) == pytest.approx(0.004)
    assert _read("local_train_ms", ctx) == pytest.approx(3.0)


def test_the_program_is_drained_once_a_traced_run(monkeypatch):
    from vantage6_tpu_torch.runtime import tracing

    calls = []

    def drain():
        calls.append(1)
        return [dict(r) for r in REPLAYS]

    monkeypatch.setattr(tracing.PHASES, "drain", drain)
    ctx = types.SimpleNamespace(trace=_replay_trace())
    for name in METRICS:
        _read(name, ctx)
    assert len(calls) == 1
    assert _read("local_train_ms", ctx) == pytest.approx(19.0)


def test_a_program_without_phases_reads_nothing(monkeypatch):
    """The parent commit's program: no ``PHASES``, no phase ranges."""
    from vantage6_tpu_torch.runtime import tracing

    monkeypatch.delattr(tracing, "PHASES")
    tr = _replay_trace()
    tr.ranges = []
    ctx = types.SimpleNamespace(trace=tr)
    assert all(_read(name, ctx) is None for name in METRICS)


def test_a_program_that_kept_no_replay_reads_nothing(monkeypatch):
    from vantage6_tpu_torch.runtime import tracing

    monkeypatch.setattr(tracing.PHASES, "drain", lambda: [])
    tr = _replay_trace()
    ctx = types.SimpleNamespace(trace=tr)
    for name in ("local_train_ms", "compress_ms", "aggregate_ms",
                 "server_update_ms"):
        assert _read(name, ctx) is None


def test_a_missed_replay_reads_nothing(monkeypatch):
    """A traced replay the program read too late: the replays it kept
    stand for some of the window's rounds only, so no phase is read from
    them, nor from the trace, which holds no range inside a graph."""
    from vantage6_tpu_torch.runtime import tracing

    store = tracing.RoundPhases()
    store._replays.extend(dict(r) for r in REPLAYS)
    store.missed = 1
    monkeypatch.setattr(tracing, "PHASES", store)
    ctx = types.SimpleNamespace(trace=_replay_trace())
    for name in ("local_train_ms", "compress_ms", "aggregate_ms",
                 "server_update_ms"):
        assert _read(name, ctx) is None
    assert spans.replays(ctx) is None
    # drained once, and the count with it
    assert store.missed == 0 and not store._replays
    # the dispatch's host time is the trace's own
    assert _read("dispatch_host_ms", ctx) == pytest.approx(2.25)


# ------------------------------------------------------- BENCHMARK.json
@pytest.mark.parametrize("name", sorted(METRICS))
def test_each_metric_is_declared_for_its_cells(name):
    (entry,) = [m for m in SPEC["per_layer"] if m["name"] == name]
    layer, workloads = METRICS[name]
    assert entry == {"name": name, "unit": "ms", "better": "lower",
                     "source": "device_trace", "layer": layer,
                     "moves": "round_ms", "workloads": workloads}
    for cell in workloads:
        assert name in {m["name"] for m in cells.resolve(cell).per_layer}


# --------------------------------------------------------------- the card
@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a replayed CUDA graph")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_replayed_flagship_round_fills_the_store(card):
    """The compressed flagship round, captured, then replayed under the
    profiler: the program keeps one time a phase for each traced replay,
    the trace holds no phase range inside the graph, and ``aggregate_ms``
    is the store's. A dispatch makes no host sync, traced or not."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vantage6_tpu_torch.runtime import tracing
    from vantage6_tpu_torch.utils import guards

    cell = cells.resolve("cnn-flagship.topk-int8")
    drv = cells.driver(cell).Driver(cell, 2147483659, card)
    drv.build()
    drv.round()  # the capture
    tracing.PHASES.drain()
    tr, _ = trace.traced_rounds(drv.round, torch.cuda.synchronize)
    assert tracing.PHASES.missed == 0
    ctx = types.SimpleNamespace(trace=tr)
    kept = spans.replays(ctx)
    assert kept is not None and len(kept) == tr.rounds
    names = {"fed.local_train", "fed.compress", "fed.stats",
             "fed.aggregate", "server.update"}
    assert all(set(r) == names and min(r.values()) > 0 for r in kept)
    assert not spans.ranges(tr, "fed.aggregate")
    assert _read("aggregate_ms", ctx) == pytest.approx(
        sum(r["fed.aggregate"] for r in kept) / len(kept))
    assert _read("dispatch_host_ms", ctx) > 0
    draws = drv.last_draws
    watched = profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
    for watch in (contextlib.nullcontext(), watched):
        with watch, guards.no_implicit_transfers():
            drv.engine.run_rounds(drv.params, drv.x, drv.y, drv.counts,
                                  None, 1, opt_state=drv.opt,
                                  batch_idx=draws["idx"],
                                  noise=draws["noise"])
    torch.cuda.synchronize()
    tracing.PHASES.drain()
