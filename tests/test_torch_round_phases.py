"""The round phases of ``runtime.tracing`` on the CPU: the ranges a
``torch.profiler`` trace of a round holds, and their nesting; nothing
entered while no profiler watches; a round's result the same, bit for bit,
with the profiler on and off; and the store of replayed phase times, with
stand-in events (a CUDA graph needs the card; the replayed round itself is
held on the card by ``benchmark/tests/test_portbench_spans.py``)."""
import json
import threading

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from vantage6_tpu_torch._tree import tree_leaves
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed.compression import CompressorSpec
from vantage6_tpu_torch.fed.fedavg import FedAvg, FedAvgSpec
from vantage6_tpu_torch.runtime import tracing
from vantage6_tpu_torch.workloads import fed_transformer as TT

S, N_PAD, D, CLASSES = 4, 24, 12, 3
PHASE_NAMES = ("fed.forward", "fed.backward", "fed.local_train",
               "fed.compress", "fed.stats", "fed.aggregate", "server.update",
               "fedavg.dispatch", "fedavg.inputs", "fedavg.capture",
               "fedavg.replay")


def _linear_loss(params, x, y, w):
    ce = F.cross_entropy(x @ params["w"] + params["b"], y, reduction="none")
    return (ce * w).sum() / w.sum()


def _fedavg(compressor=None, shard=False):
    spec = FedAvgSpec(loss_fn=_linear_loss, local_steps=2, batch_size=5,
                      local_lr=0.1, compressor=compressor,
                      shard_server_update=shard)
    return FedAvg(FederationMesh(S, device="cpu"), spec)


def _fedavg_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(S, N_PAD, D, generator=g)
    y = torch.randint(0, CLASSES, (S, N_PAD), generator=g)
    counts = torch.tensor([24.0, 17.0, 9.0, 20.0])
    params = {"w": 0.1 * torch.randn(D, CLASSES, generator=g),
              "b": torch.zeros(CLASSES)}
    return params, x, y, counts


COMPRESSOR = CompressorSpec(topk_ratio=0.25, int8=True, chunk=8)


def _transformer():
    cfg = TT.TransformerConfig(vocab=32, d_model=16, n_heads=2, n_layers=1,
                               max_len=16, attention="flash")
    eng = TT.make_engine(2, 1, cfg, lr=1e-3, device="cpu")
    params, opt = eng.init(3)
    tokens = eng.shard_tokens(TT.make_federated_tokens(2, 2, 16, 32, seed=1))
    return eng, params, opt, tokens


def _traced(fn, tmp_path):
    """``fn()`` under the profiler: (its result, the trace's ranges as
    ``(name, start, end, tid)``, in order of start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = sorted(
        (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
         e["tid"])
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    return out, sorted(ranges, key=lambda r: r[1])


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _before(a, b):
    return a[2] <= b[1]


def _same(a, b):
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


# ------------------------------------------------------------ the ranges
def test_transformer_round_holds_each_phase_per_station(tmp_path):
    eng, params, opt, tokens = _transformer()
    _, ranges = _traced(
        lambda: eng.round(params, opt, tokens, [1.0, 1.0]), tmp_path)
    fwd, bwd = _named(ranges, "fed.forward"), _named(ranges, "fed.backward")
    agg, upd = _named(ranges, "fed.aggregate"), _named(ranges,
                                                       "server.update")
    assert len(fwd) == len(bwd) == 2 and len(agg) == len(upd) == 1
    # each station's forward, then its backward; then the aggregation of
    # every station's gradient, then the server's step
    order = [fwd[0], bwd[0], fwd[1], bwd[1], agg[0], upd[0]]
    assert all(_before(a, b) for a, b in zip(order, order[1:]))
    # the attention ranges of the flash path nest in the station's phases
    attn_f, attn_b = (_named(ranges, "attention_fwd"),
                      _named(ranges, "attention_bwd"))
    assert len(attn_f) == len(attn_b) == 2
    assert all(any(_inside(a, f) for f in fwd) for a in attn_f)
    assert all(any(_inside(a, b) for b in bwd) for a in attn_b)


def test_eager_fedavg_round_with_a_compressor_holds_each_phase_once(
        tmp_path):
    eng = _fedavg(COMPRESSOR)
    params, x, y, counts = _fedavg_inputs()
    state = eng.init(params)
    _, ranges = _traced(
        lambda: eng.round(params, state, x, y, counts, key=5), tmp_path)
    names = ("fed.local_train", "fed.compress", "fed.stats",
             "fed.aggregate", "server.update")
    found = [_named(ranges, n) for n in names]
    assert [len(f) for f in found] == [1] * len(names)
    order = [f[0] for f in found]
    assert all(_before(a, b) for a, b in zip(order, order[1:]))
    assert not [r for r in ranges if r[0].startswith("fedavg.")]


def test_sharded_server_update_keeps_the_phases(tmp_path):
    eng = _fedavg(shard=True)
    params, x, y, counts = _fedavg_inputs()
    _, ranges = _traced(
        lambda: eng.round(params, eng.init(params), x, y, counts, key=5),
        tmp_path)
    agg, upd = _named(ranges, "fed.aggregate"), _named(ranges,
                                                       "server.update")
    assert len(agg) == len(upd) == 1 and _before(agg[0], upd[0])


def test_fused_dispatch_nests_its_host_work_and_the_rounds(tmp_path):
    eng = _fedavg(COMPRESSOR)
    params, x, y, counts = _fedavg_inputs()
    _, ranges = _traced(
        lambda: eng.run_rounds(params, x, y, counts, 7, 2), tmp_path)
    (dispatch,) = _named(ranges, "fedavg.dispatch")
    (inputs,) = _named(ranges, "fedavg.inputs")
    (capture,) = _named(ranges, "fedavg.capture")
    (replay,) = _named(ranges, "fedavg.replay")
    for r in (inputs, capture, replay):
        assert _inside(r, dispatch)
    assert _before(inputs, capture) and _before(capture, replay)
    # on the CPU the round runs eagerly inside the runner: two rounds
    for name in ("fed.local_train", "fed.compress", "fed.stats",
                 "fed.aggregate", "server.update"):
        rounds = _named(ranges, name)
        assert len(rounds) == 2 and all(_inside(r, replay) for r in rounds)
    # a second dispatch of the same signature captures nothing
    _, ranges = _traced(
        lambda: eng.run_rounds(params, x, y, counts, 7, 2), tmp_path)
    assert not _named(ranges, "fedavg.capture")
    assert len(_named(ranges, "fedavg.dispatch")) == 1


def test_async_dispatch_names_its_host_work(tmp_path):
    from vantage6_tpu_torch.fed.fedavg import AsyncRoundSpec

    eng = _fedavg()
    params, x, y, counts = _fedavg_inputs()
    _, ranges = _traced(
        lambda: eng.run_rounds_async(
            params, x, y, counts, 7, 2, [1.0, 1.0, 0.0, 1.0],
            AsyncRoundSpec(quorum=3)), tmp_path)
    (dispatch,) = _named(ranges, "fedavg.dispatch")
    for name in ("fedavg.inputs", "fedavg.replay"):
        assert all(_inside(r, dispatch) for r in _named(ranges, name))
    assert len(_named(ranges, "server.update")) == 2


# ------------------------------------------------- nothing while unwatched
class _CountingRange:
    """A stand-in for ``torch.profiler.record_function`` that counts."""

    names: list = []

    def __init__(self, name):
        type(self).names.append(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_no_profiler_enters_no_range_and_touches_no_event(monkeypatch):
    _CountingRange.names = []
    monkeypatch.setattr(torch.profiler, "record_function", _CountingRange)
    events = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: events.append(k))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: events.append("sync"))
    assert tracing.phase("fed.aggregate") is tracing._NO_PHASE
    eng, params, opt, tokens = _transformer()
    eng.round(params, opt, tokens, [1.0, 1.0])
    fed = _fedavg(COMPRESSOR)
    p, x, y, counts = _fedavg_inputs()
    fed.round(p, fed.init(p), x, y, counts, key=5)
    fed.run_rounds(p, x, y, counts, 7, 2)
    # the attention ranges of the flash path are phases too
    assert _CountingRange.names == []
    assert events == []


def test_a_profiler_enters_one_range_a_phase(monkeypatch):
    _CountingRange.names = []
    monkeypatch.setattr(torch.profiler, "record_function", _CountingRange)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.phase("fed.aggregate"):
            pass
    assert _CountingRange.names == ["fed.aggregate"]


# ------------------------------------------------------- the same result
def test_transformer_round_is_the_same_traced_and_untraced(tmp_path):
    eng, params, opt, tokens = _transformer()
    plain = eng.round(params, opt, tokens, [1.0, 0.0])
    traced, _ = _traced(
        lambda: eng.round(params, opt, tokens, [1.0, 0.0]), tmp_path)
    assert _same(plain, traced)


@pytest.mark.parametrize("compressor", [None, COMPRESSOR])
def test_fedavg_rounds_are_the_same_traced_and_untraced(tmp_path,
                                                        compressor):
    eng = _fedavg(compressor)
    params, x, y, counts = _fedavg_inputs()
    state = eng.init(params)
    plain = eng.round(params, state, x, y, counts, key=5)
    traced, _ = _traced(
        lambda: eng.round(params, state, x, y, counts, key=5), tmp_path)
    assert _same(plain, traced)
    plain = eng.run_rounds(params, x, y, counts, 9, 3)
    traced, _ = _traced(
        lambda: eng.run_rounds(params, x, y, counts, 9, 3), tmp_path)
    assert _same(plain, traced)


# ------------------------------------------------- replayed phases' store
class _Event:
    """A stand-in for a timing ``torch.cuda.Event``: its time is the
    count of events made before it, in ms."""

    made = 0

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing and external
        self.t = float(type(self).made)
        type(self).made += 1
        self.recorded = self.done = False
        self.synced = 0

    def record(self):
        self.recorded = True

    def query(self):
        return self.done

    def synchronize(self):
        self.synced += 1
        self.done = True

    def elapsed_time(self, end):
        # a pair's start precedes its end on the stream: the end's
        # completion is the pair's
        assert end.done
        return end.t - self.t


@pytest.fixture
def store(monkeypatch):
    _Event.made = 0
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    return tracing.RoundPhases()


def _capture(store):
    with store.capturing() as captured:
        with store.phase("fed.local_train"):
            pass
        with store.phase("fed.aggregate"):
            pass
        with store.phase("fed.aggregate"):
            pass
    return captured


def test_capture_records_an_event_pair_a_phase(store):
    captured = _capture(store)
    assert [m[0] for m in captured.marks] == [
        "fed.local_train", "fed.aggregate", "fed.aggregate"]
    assert all(s.recorded and e.recorded for _, s, e in captured.marks)
    # outside the capture the phase is the profiler's again
    assert store.phase("fed.stats") is tracing._NO_PHASE


def test_another_thread_records_nothing_into_a_capture(store):
    seen = []
    with store.capturing() as captured:
        t = threading.Thread(
            target=lambda: seen.append(store.phase("fed.stats")))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert captured.marks == [] and seen == [tracing._NO_PHASE]


def test_two_threads_capture_apart(store):
    """Each thread's capture takes its own phases, whichever ends first."""
    inside, done = threading.Event(), threading.Event()
    got = {}

    def other():
        with store.capturing() as captured:
            inside.set()
            done.wait(timeout=10)
            with store.phase("fed.compress"):
                pass
        got["other"] = captured

    t = threading.Thread(target=other)
    t.start()
    assert inside.wait(timeout=10)
    with store.capturing() as captured:
        with store.phase("fed.local_train"):
            pass
    done.set()
    t.join(timeout=10)
    assert not t.is_alive()
    assert [m[0] for m in captured.marks] == ["fed.local_train"]
    assert [m[0] for m in got["other"].marks] == ["fed.compress"]


def _finish(captured):
    for _, s, e in captured.marks:
        s.done = e.done = True


def test_replays_are_kept_only_under_a_profiler(store):
    captured = _capture(store)
    _finish(captured)
    captured.collect()
    captured.replayed()  # no profiler: nothing kept
    captured.collect()
    assert store.drain() == []
    with profile(activities=[ProfilerActivity.CPU]):
        captured.collect()
        captured.replayed()
        captured.collect()      # the next replay reads the last one
        captured.replayed()
    # the last replay is read when the store is drained
    got = store.drain()
    assert got == [{"fed.local_train": 1.0, "fed.aggregate": 2.0}] * 2
    assert store.drain() == [] and store.missed == 0


def test_an_unfinished_replay_is_missed_not_waited_for(store):
    captured = _capture(store)
    with profile(activities=[ProfilerActivity.CPU]):
        captured.replayed()
        captured.collect()  # its events have not completed: not read
    assert store.missed == 1
    assert all(e.synced == 0 for _, _, e in captured.marks)
    # drained: nothing kept, and the count starts again
    assert store.drain() == [] and store.missed == 0


def test_drain_waits_for_the_last_replay(store):
    captured = _capture(store)
    with profile(activities=[ProfilerActivity.CPU]):
        captured.replayed()
    got = store.drain()
    assert got == [{"fed.local_train": 1.0, "fed.aggregate": 2.0}]
    assert all(e.synced == 1 for _, _, e in captured.marks)


def test_two_rounds_keep_their_own_replays(store):
    """Two captured rounds replayed in turn under a profiler: neither's
    unread replay takes the other's place, and none is missed."""
    a = _capture(store)
    b = _capture(store)
    with profile(activities=[ProfilerActivity.CPU]):
        for captured in (a, b, a, b):
            captured.collect()
            _finish(captured)
            captured.replayed()
    got = store.drain()
    assert store.missed == 0 and len(got) == 4
    assert got.count({"fed.local_train": 1.0, "fed.aggregate": 2.0}) == 4


def test_the_store_keeps_a_bounded_number_of_replays(monkeypatch):
    _Event.made = 0
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(tracing, "PHASE_REPLAYS_KEPT", 3)
    small = tracing.RoundPhases()
    captured = _capture(small)
    _finish(captured)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            captured.collect()
            captured.replayed()
    assert len(small.drain()) == 3


def test_phase_times_are_milliseconds_of_the_events(store):
    captured = _capture(store)
    _finish(captured)
    with profile(activities=[ProfilerActivity.CPU]):
        captured.replayed()
    (times,) = store.drain()
    want = {}
    for name, s, e in captured.marks:
        want[name] = want.get(name, 0.0) + (e.t - s.t)
    assert times == pytest.approx(want)
    assert sum(times.values()) == pytest.approx(3.0)
