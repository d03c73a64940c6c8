"""The port's learning plane against the JAX package's, on the CPU.

``runtime/learning.py`` is numpy on the host in both packages, so the same
seeded stats must give the same numbers exactly: ``update_stats_host``,
``RoundHistory``'s records, ``summary()`` and ``state_arrays()``, and a
``record_engine`` of the port engine's torch stats against the JAX
history's record of the same values in numpy. A device-mode aggregation
records the same history in both packages' ``Federation`` (an elementwise
partial, so both sides' stacked results are equal), keyed by the parent
task; ``FedAvg.attach_history`` records the rounds the engine returns; a
checkpoint carries the history, and the trajectory continues after the
restore. Sizes: 2-5 stations, tens of elements, a few rounds.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vantage6_tpu_torch.common.flight import FLIGHT, read_bundle
from vantage6_tpu_torch.common.telemetry import REGISTRY
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed import fedavg as tf
from vantage6_tpu_torch.runtime import checkpoint as tckpt
from vantage6_tpu_torch.runtime import learning as TL
from vantage6_tpu_torch.runtime.metrics import learning_snapshot

JL = importlib.import_module("vantage6_tpu.runtime.learning")


def _stats(seed, s=5, n=40, ef=True, zero_station=None):
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=(s, n)).astype(np.float32)
    w = rng.uniform(1, 9, size=s).astype(np.float32)
    mask = np.ones(s, np.float32)
    if zero_station is not None:
        mask[zero_station] = 0.0
    e = rng.normal(size=(s, n)).astype(np.float32) if ef else None
    return flat, w, mask, e


def _strip(recs):
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs]


@pytest.mark.parametrize("case", ["plain", "weights_mask_ef", "nan_row"])
def test_update_stats_host_matches_jax(case):
    flat, w, mask, e = _stats(1, zero_station=2)
    kw = {}
    if case != "plain":
        kw = dict(weights=w, mask=mask, ef=e)
    if case == "nan_row":
        flat[2, 3] = np.nan  # a masked-out station's NaN must not leak
    ours = TL.update_stats_host(flat, **kw)
    theirs = JL.update_stats_host(flat, **kw)
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_array_equal(np.asarray(ours[k]),
                                      np.asarray(theirs[k]))


def _histories(n_rounds=6):
    ours, theirs = TL.RoundHistory("t"), JL.RoundHistory("t")
    for r in range(n_rounds):
        flat, w, mask, e = _stats(10 + r, zero_station=1 if r == 2 else None)
        flat *= 1.0 / (r + 1)  # a decaying trajectory
        stats = TL.update_stats_host(flat, weights=w, mask=mask, ef=e)
        for h in (ours, theirs):
            h.record(stats["update_norm"], stats["station_norm"],
                     stats["station_cos"], loss=2.0 - 0.1 * r,
                     station_ef_norms=stats["station_ef_norm"],
                     station_weights=stats["station_weight"],
                     ts=1000.0 + r)
    return ours, theirs


def test_round_history_records_summary_and_state_match_jax():
    ours, theirs = _histories()
    assert ours.rounds() == theirs.rounds()
    assert ours.summary() == theirs.summary()
    a, b = ours.state_arrays(), theirs.state_arrays()
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    assert ours.feed_items() == theirs.feed_items()


def test_record_engine_from_torch_tensors():
    """A fused run's stacked torch stats ``[K, S]`` (and a single round's
    ``[S]``) record as the JAX history records the same numpy values."""
    rng = np.random.default_rng(4)
    k, s = 3, 4
    stats = {"update_norm": rng.uniform(size=k).astype(np.float32),
             "station_norm": rng.uniform(size=(k, s)).astype(np.float32),
             "station_cos": rng.uniform(-1, 1, (k, s)).astype(np.float32),
             "station_weight": np.ones((k, s), np.float32),
             "station_ef_norm": rng.uniform(size=(k, s)).astype(np.float32)}
    losses = rng.uniform(size=k).astype(np.float32)
    ours, theirs = TL.RoundHistory("e"), JL.RoundHistory("e")
    ours.record_engine(torch.from_numpy(losses),
                       {n: torch.from_numpy(v) for n, v in stats.items()})
    theirs.record_engine(losses, stats)
    one = {n: v[0] for n, v in stats.items()}
    ours.record_engine(torch.tensor(losses[0]),
                       {n: torch.from_numpy(np.asarray(v))
                        for n, v in one.items()})
    theirs.record_engine(losses[0], one)
    assert _strip(ours.rounds()) == _strip(theirs.rounds())
    assert [r.get("rounds_per_dispatch") for r in ours.rounds()] == [
        3, 3, 3, None]


def test_stats_to_host_is_one_copy_of_every_entry():
    vals = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.tensor(2.5),
            "c": np.ones(2), "d": None,
            "e": torch.arange(3, dtype=torch.float64)}
    host = TL.stats_to_host(vals)
    assert set(host) == {"a", "b", "c", "e"}
    np.testing.assert_array_equal(host["a"], vals["a"].numpy())
    assert host["b"].shape == () and float(host["b"]) == 2.5
    assert host["e"].dtype == np.float64
    # a pulled dict passes through again without a copy
    again = TL.stats_to_host(host)
    assert all(again[k] is host[k] for k in host)


def _linear_engine(**kw):
    def loss(params, bx, by, w):
        pred = bx @ params["w"] + params["b"]
        return torch.sum(w * (pred - by) ** 2) / torch.clamp(torch.sum(w), 1)

    return tf.FedAvg(FederationMesh(4, device="cpu"), tf.FedAvgSpec(
        loss_fn=loss, local_steps=2, batch_size=4, local_lr=0.05, **kw))


def _linear_data():
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(4, 12, 5)).astype(np.float32)
    ys = (xs @ rng.normal(size=5)).astype(np.float32)
    return (torch.from_numpy(xs), torch.from_numpy(ys),
            torch.full((4,), 12.0), {"w": torch.zeros(5), "b": torch.zeros(())})


def test_attach_history_records_the_engine_rounds():
    eng = _linear_engine()
    sx, sy, counts, p0 = _linear_data()
    hist = eng.attach_history("engine-test")
    assert TL.LEARNING.get("engine-test") is hist
    before = REGISTRY.snapshot().get("v6t_round_updates_total", 0)
    _, _, losses, stats = eng.run_rounds(p0, sx, sy, counts, 5, 3)
    recs = hist.rounds()
    assert len(recs) == 3
    for r, rec in enumerate(recs):
        assert rec["round"] == r and rec["rounds_per_dispatch"] == 3
        assert rec["update_norm"] == float(stats["update_norm"][r])
        assert rec["station_norms"] == stats["station_norm"][r].tolist()
        assert rec["station_cos"] == stats["station_cos"][r].tolist()
        assert rec["loss"] == float(losses[r])
    _, _, _, st = eng.round(p0, eng.init(p0), sx, sy, counts, key=9)
    assert hist.rounds_total == 4
    assert hist.rounds()[-1]["station_norms"] == st["station_norm"].tolist()
    assert REGISTRY.snapshot()["v6t_round_updates_total"] == before + 4
    eng.attach_history(None)
    eng.round(p0, eng.init(p0), sx, sy, counts, key=9)
    assert hist.rounds_total == 4
    TL.LEARNING.clear()


def test_learning_stats_off_records_nothing():
    eng = _linear_engine(learning_stats=False)
    sx, sy, counts, p0 = _linear_data()
    hist = eng.attach_history(TL.RoundHistory("off"))
    eng.run_rounds(p0, sx, sy, counts, 5, 2)
    assert hist.rounds_total == 0


# ----------------------------------------------------------- federation
def _feds():
    feds = {}
    data = [np.random.default_rng(i).normal(size=8).astype(np.float32)
            for i in range(3)]
    for root, lib in (("vantage6_tpu", "jax"), ("vantage6_tpu_torch",
                                                "torch")):
        deco = importlib.import_module(f"{root}.algorithm.decorators")
        fmod = importlib.import_module(f"{root}.runtime.federation")

        if lib == "jax":
            def partial(d):
                return {"w": d * 0.5 - 1.0, "v": d * d}
            ds = [jnp.asarray(x) for x in data]
            kw = {}
        else:
            def partial(d):
                return {"w": d * 0.5 - 1.0, "v": d * d}
            ds = [torch.from_numpy(x) for x in data]
            kw = {"device": "cpu"}
        feds[lib] = fmod.federation_from_datasets(
            ds, {"img": {"partial": deco.device_step(partial)}},
            executor_workers=0, **kw)
    return feds


def test_record_learning_matches_the_jax_federation():
    TL.LEARNING.clear()
    JL.LEARNING.clear()
    feds = _feds()
    weights = np.asarray([1.0, 3.0, 2.0], np.float32)
    hists = {}
    for lib, fed in feds.items():
        parent = fed.create_task("img", {"method": "partial"})
        fed.aggregate_stacked(parent.id)
        for _ in range(2):
            sub = fed.create_task("img", {"method": "partial"},
                                  parent=parent)
            fed.aggregate_stacked(sub.id, weights=weights)
        hists[lib] = fed.learning_history(parent.id)
        fed.close()
    assert hists["torch"].rounds_total == 3
    assert _strip(hists["torch"].rounds()) == _strip(hists["jax"].rounds())
    summary = [s for s in learning_snapshot() if s["rounds"] == 3]
    assert summary and summary[0]["stations"] == hists["jax"].summary()[
        "stations"]


def test_learning_stats_off_in_the_config_records_nothing():
    TL.LEARNING.clear()
    fed = _feds()["torch"]
    fed.config.learning_stats = False
    t = fed.create_task("img", {"method": "partial"})
    fed.aggregate_stacked(t.id)
    assert fed.learning_history(t.id) is None
    fed.close()


def test_flight_dump_holds_the_learning_records(tmp_path):
    TL.LEARNING.clear()
    ours, _ = _histories(3)
    FLIGHT.clear()
    h = TL.LEARNING.history("flight-test")
    for rec in ours.rounds():
        h.record(rec["update_norm"], rec["station_norms"],
                 rec["station_cos"], loss=rec["loss"])
    recs = read_bundle(FLIGHT.dump(str(tmp_path / "b.jsonl")))
    notes = [r for r in recs if r["type"] == "note"
             and r["kind"] == "learning_round"]
    finals = [r for r in recs if r["type"] == "learning"]
    assert len(notes) == 3 and finals[0]["task"] == "flight-test"
    TL.LEARNING.clear()


# ------------------------------------------------------------ checkpoint
def test_checkpoint_carries_the_history_and_continues_it(tmp_path):
    ours, theirs = _histories(5)
    mgr = tckpt.CheckpointManager(tmp_path)
    mgr.save(tckpt.TrainState({"w": torch.ones(2)}, (), 5,
                              torch.Generator().get_state(),
                              history=ours.state_arrays()))
    back = mgr.restore(device="cpu")
    resumed = TL.RoundHistory("t").load_state(back.history)
    assert _strip(resumed.rounds()) == _strip(ours.rounds())
    assert resumed.summary() == theirs.summary()
    assert REGISTRY.snapshot()["v6t_round_norm_decay"] == pytest.approx(
        ours.rounds()[-1]["update_norm"] / ours.peak_norm)
    flat, w, mask, e = _stats(99)
    stats = TL.update_stats_host(flat / 6.0, weights=w, mask=mask, ef=e)
    for h in (resumed, ours):
        h.record_stats(stats, loss=1.0)
    assert resumed.rounds()[-1]["round"] == 5
    assert resumed.rounds_total == ours.rounds_total == 6
    assert resumed.peak_norm == ours.peak_norm
    assert resumed.first_norm == ours.first_norm
    assert _strip(resumed.rounds()) == _strip(ours.rounds())
    # the JAX history loads the port's checkpointed arrays too
    jback = JL.RoundHistory("t").load_state(
        {k: np.asarray(v) for k, v in back.history.items()})
    assert jback.summary() == theirs.summary()


def test_trainstate_generator_resolves_its_device(monkeypatch):
    state = tckpt.TrainState({}, (), 0,
                             torch.Generator().manual_seed(3).get_state())
    expect = torch.rand(4, generator=torch.Generator().manual_seed(3))
    got = torch.rand(4, generator=state.generator("cpu"))
    assert torch.equal(got, expect)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state.generator()
