"""The port's survival workloads (Kaplan-Meier, Cox) against the JAX
package's, on the CPU.

The same seeded numpy rows (4 stations x 100-150, 3 features, integer
times so the grid has ties) go through the JAX function (its Federation on
the CPU) and the port (``device="cpu"``). The JAX host partials read pandas
frames; the port's read the same columns as a dict of numpy arrays.
Counts are compared exactly; f32 statistics within the stated tolerances.
"""
import importlib

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from vantage6_tpu_torch.algorithm import MockAlgorithmClient
from vantage6_tpu_torch.fed import collectives as TC
from vantage6_tpu_torch.runtime.federation import federation_from_datasets
from vantage6_tpu_torch.workloads import survival as TS

JS = importlib.import_module("vantage6_tpu.workloads.survival")
JaxMock = importlib.import_module(
    "vantage6_tpu.algorithm.mock_client").MockAlgorithmClient
jax_federation = importlib.import_module(
    "vantage6_tpu.runtime.federation").federation_from_datasets

COUNTS = [100, 73, 150, 91]  # ragged: rows past a station's count are padding
FEATURES = ["f0", "f1", "f2"]


def synth_survival(n, d=3, seed=0):
    """Exponential survival with known coefficients + uniform censoring;
    times rounded up to integers, so the grid has ties (Breslow)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    beta = np.asarray([0.8, -0.5, 0.3][:d], np.float32)
    t_event = -np.log(rng.uniform(size=n)) / (0.1 * np.exp(x @ beta))
    t_cens = rng.uniform(1, 30, size=n)
    time = np.ceil(np.minimum(t_event, t_cens)).astype(np.float32)
    event = (t_event <= t_cens).astype(np.float32)
    return x, time, event


def _stations(seed):
    """Per-station padded device data (port and JAX take the same dicts),
    host frames as dicts of arrays and as DataFrames, and the pooled rows."""
    x, time, event = synth_survival(sum(COUNTS), seed=seed)
    n_max = max(COUNTS)
    device, frames, edges = [], [], np.cumsum([0] + COUNTS)
    for lo, hi in zip(edges[:-1], edges[1:]):
        pad = n_max - (hi - lo)
        device.append({
            "x": np.pad(x[lo:hi], ((0, pad), (0, 0))),
            "time": np.pad(time[lo:hi], (0, pad)),
            "event": np.pad(event[lo:hi], (0, pad)),
            "count": np.float32(hi - lo),
        })
        cols = {f: x[lo:hi, j] for j, f in enumerate(FEATURES)}
        cols.update(time=time[lo:hi], event=event[lo:hi])
        frames.append(cols)
    return device, frames, (x, time, event)


def _feds(datasets, module_t, module_j, image):
    return (federation_from_datasets(datasets, {image: module_t},
                                     device="cpu"),
            jax_federation(datasets, algorithms={image: module_j}))


def _clients(frames):
    return (MockAlgorithmClient([[{"database": f}] for f in frames],
                                module=TS, device="cpu"),
            JaxMock([[{"database": pd.DataFrame(f)}] for f in frames],
                    module=JS))


def _run(client, method, kwargs):
    task = client.task.create(input_={"method": method, "kwargs": kwargs},
                              organizations=[0])
    (res,) = client.result.get(task["id"])
    return res


# ------------------------------------------------------------ Kaplan-Meier
def test_device_km_counts_are_exact_and_secure_equals_plain():
    data, _, (_, time, event) = _stations(2)
    fed, jfed = _feds(data, TS, JS, "survival")
    grid = np.unique(time[event > 0])
    plain = TS.kaplan_meier_device(fed, grid)
    secure = TS.kaplan_meier_device(fed, grid, secure=True, key=5)
    theirs = JS.kaplan_meier_device(jfed, grid)
    theirs_sec = JS.kaplan_meier_device(jfed, grid, secure=True,
                                        key=jax.random.key(5))
    events = np.asarray([np.sum((time == g) * event) for g in grid])
    at_risk = np.asarray([np.sum(time >= g) for g in grid])
    for res in (plain, secure, theirs, theirs_sec):
        np.testing.assert_array_equal(res["events"], events)
        np.testing.assert_array_equal(res["at_risk"], at_risk)
    # the secure sum's masks cancel: the same f32 counts, bit for bit
    assert np.array_equal(secure["events"], plain["events"])
    assert np.array_equal(secure["at_risk"], plain["at_risk"])
    # f32 division and product over 28 grid points in both packages
    np.testing.assert_allclose(plain["survival"], theirs["survival"],
                               rtol=1e-6)
    np.testing.assert_allclose(secure["survival"], plain["survival"], rtol=0)
    np.testing.assert_array_equal(plain["time"], grid)


def test_secure_km_needs_a_key():
    data, _, (_, time, event) = _stations(2)
    fed = federation_from_datasets(data, {"survival": TS}, device="cpu")
    with pytest.raises(ValueError, match="explicit masking key"):
        TS.kaplan_meier_device(fed, np.unique(time[event > 0]), secure=True)


def test_km_from_counts_matches_jax():
    events = np.asarray([0.0, 3.0, 1.0, 2.0], np.float32)
    at_risk = np.asarray([0.0, 20.0, 11.0, 2.0], np.float32)
    ours = TS.km_from_counts(torch.from_numpy(events),
                             torch.from_numpy(at_risk)).numpy()
    np.testing.assert_allclose(
        ours, np.asarray(JS.km_from_counts(events, at_risk)), rtol=1e-7)


def test_host_km_over_dicts_equals_jax_over_frames():
    _, frames, (_, time, event) = _stations(1)
    ours, theirs = (_run(c, "central_kaplan_meier",
                         {"time_col": "time", "event_col": "event"})
                    for c in _clients(frames))
    # float64 numpy on both sides, the same counting rule: exact
    assert ours == theirs
    assert ours["time"] == sorted(set(time[event > 0].tolist()))


# ------------------------------------------------------------------- Cox
def test_cox_station_stats_match_jax_leaf_by_leaf():
    data, _, (_, time, event) = _stations(3)
    grid = np.unique(time[event > 0]).tolist()
    beta = np.asarray([0.3, -0.2, 0.1], np.float32)
    d = data[1]
    valid = (np.arange(len(d["time"])) < d["count"]).astype(np.float32)
    ours = TS._cox_station_stats(
        *(torch.from_numpy(np.asarray(a)) for a in (
            d["x"], d["time"], d["event"], valid, beta)), grid)
    theirs = JS._cox_station_stats(d["x"], d["time"], d["event"], valid,
                                   beta, grid)
    assert set(ours) == set(theirs) == {"s0", "s1", "s2", "d", "s"}
    for k, v in ours.items():
        ref = np.asarray(theirs[k])
        assert v.shape == ref.shape and v.dtype == torch.float32
        # f32 sums over 73 rows in another order (a product, not an
        # einsum): within 1e-5 of the leaf's largest magnitude
        np.testing.assert_allclose(v.numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(ours["d"].numpy(), np.asarray(theirs["d"]))


def _jax_pooled_cox(x, time, event, n_iter):
    """Newton on the pooled rows through the JAX package's own statistics
    and update (no Federation)."""
    grid = np.unique(time[event > 0]).tolist()
    beta = np.zeros(x.shape[1], np.float32)
    for _ in range(n_iter):
        stats = JS._cox_station_stats(x, time, event,
                                      np.ones(len(time), np.float32), beta,
                                      grid)
        beta, grad = JS.cox_newton_update(stats, beta)
        beta = np.asarray(beta)
    return beta, float(np.linalg.norm(np.asarray(grad)))


def test_fit_cox_device_matches_jax():
    data, _, (x, time, event) = _stations(3)
    fed, jfed = _feds(data, TS, JS, "survival")
    grid = np.unique(time[event > 0])
    # the JAX Federation traces each task's step anew: 3 iterations of its
    # engine, 8 against JAX's pooled Newton
    ours = TS.fit_cox_device(fed, n_features=3, grid=grid, n_iter=3)
    theirs = JS.fit_cox_device(jfed, n_features=3, grid=grid, n_iter=3)
    # f32 Newton on both sides (the JAX suite's federated-vs-pooled
    # tolerance)
    np.testing.assert_allclose(ours["beta"], theirs["beta"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ours["grad_norm"], theirs["grad_norm"],
                               rtol=1e-3)
    ours = TS.fit_cox_device(fed, n_features=3, grid=grid, n_iter=8)
    pooled, _ = _jax_pooled_cox(x, time, event, 8)
    np.testing.assert_allclose(ours["beta"], pooled, rtol=1e-4, atol=1e-5)
    assert ours["grad_norm"] < 1e-2
    with pytest.raises(ValueError, match="n_iter"):
        TS.fit_cox_device(fed, n_features=3, grid=grid, n_iter=0)


def test_host_cox_over_dicts_matches_jax_over_frames():
    _, frames, _ = _stations(4)
    kw = {"feature_cols": FEATURES, "time_col": "time",
          "event_col": "event", "n_iter": 8}
    ours, theirs = (_run(c, "central_cox", kw) for c in _clients(frames))
    assert ours["event_times"] == theirs["event_times"]
    np.testing.assert_allclose(ours["beta"], theirs["beta"], rtol=1e-4,
                               atol=1e-5)
    assert ours["grad_norm"] < 1e-2
    x = np.stack([np.concatenate([f[c] for f in frames]) for c in FEATURES],
                 axis=1)
    pooled, _ = _jax_pooled_cox(
        x, *(np.concatenate([f[c] for f in frames]) for c in ("time",
                                                              "event")), 8)
    np.testing.assert_allclose(ours["beta"], pooled, rtol=1e-4, atol=1e-5)


def test_host_cox_partial_needs_a_device_without_cuda(monkeypatch):
    _, frames, (_, time, event) = _stations(4)
    kw = dict(beta=[0.0] * 3, grid=np.unique(time[event > 0]).tolist(),
              feature_cols=FEATURES, time_col="time", event_col="event")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.partial_cox_stats_host.plain(frames[0], **kw)
    out = TS.partial_cox_stats_host.plain(frames[0], device="cpu", **kw)
    ref = JS.partial_cox_stats_host.plain(pd.DataFrame(frames[0]), **kw)
    for k in ("s0", "s1", "s2", "d", "s"):
        np.testing.assert_allclose(out[k], ref[k],
                                   atol=1e-5 * np.abs(ref[k]).max())


def test_secure_km_counts_at_the_registry_scale_are_exact():
    """Counts up to 2^21 at scale 2^8 stay under secure_sum's 2^31 / 2^8:
    the masked sum is the plain integer sum, exactly."""
    rng = np.random.default_rng(0)
    counts = torch.from_numpy(
        rng.integers(0, 65537, size=(32, 16)).astype(np.float32))
    counts[:, 0] = 65536.0  # the pooled total 2^21
    mask = torch.ones(32)
    sec = TC.secure_sum(counts, 11, scale=2.0**8, mask=mask)
    assert torch.equal(sec, counts.sum(0))
    assert float(sec[0]) == 2.0**21
