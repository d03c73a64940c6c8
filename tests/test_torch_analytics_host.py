"""The host halves of the port's analysis workloads (summary, crosstab,
correlation, quantiles, GLM, vertical LR) against the JAX package's, on the
CPU, and the observed dispatch of the device programs.

The JAX centrals run through its MockAlgorithmClient over pandas frames;
the port's through its own over the same columns as dicts of numpy arrays
(``device="cpu"``). The host arithmetic is numpy float64 (or plain Python)
on both sides, so most results are compared exactly. ``central_glm`` is
held to a float64 numpy IRLS and to the port's ``fit_glm_device``: the JAX
host GLM is red in this environment (``jax.experimental.enable_x64``).
"""
import importlib

import numpy as np
import pandas as pd
import pytest
import torch

from vantage6_tpu_torch.algorithm import MockAlgorithmClient
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.runtime.federation import federation_from_datasets
from vantage6_tpu_torch.runtime.profiling import DEVICE_OBS
from vantage6_tpu_torch.workloads import glm as TG
from vantage6_tpu_torch.workloads import quantiles as TQ
from vantage6_tpu_torch.workloads import stats as TS
from vantage6_tpu_torch.workloads import summary as TSM
from vantage6_tpu_torch.workloads import vertical as TV

JSM = importlib.import_module("vantage6_tpu.workloads.summary")
JS = importlib.import_module("vantage6_tpu.workloads.stats")
JQ = importlib.import_module("vantage6_tpu.workloads.quantiles")
JV = importlib.import_module("vantage6_tpu.workloads.vertical")
JaxMock = importlib.import_module(
    "vantage6_tpu.algorithm.mock_client").MockAlgorithmClient
jax_federation = importlib.import_module(
    "vantage6_tpu.runtime.federation").federation_from_datasets

COUNTS = [40, 17, 29]


def _both(frames, module_t, module_j, method, kwargs):
    """(port result over dicts, JAX result over DataFrames) of one central
    task run at organization 0."""
    out = []
    for client in (
            MockAlgorithmClient([[{"database": f}] for f in frames],
                                module=module_t, device="cpu"),
            JaxMock([[{"database": pd.DataFrame(f)}] for f in frames],
                    module=module_j)):
        task = client.task.create(input_={"method": method,
                                          "kwargs": kwargs},
                                  organizations=[0])
        (res,) = client.result.get(task["id"])
        out.append(res)
    return out


def _numeric_frames(seed, nan_share=0.0):
    rng = np.random.default_rng(seed)
    frames = []
    for n in COUNTS:
        a = rng.normal(2.0, 1.5, size=n)
        b = rng.uniform(size=n)
        for col in (a, b):
            col[rng.uniform(size=n) < nan_share] = np.nan
        frames.append({"a": a, "b": b,
                       "k": rng.integers(-5, 50, size=n).astype(np.int64)})
    return frames


# ---------------------------------------------------------------- summary
def test_partial_summary_over_a_dict_is_pandas_with_nans():
    frame = _numeric_frames(0, nan_share=0.2)[0]
    frame["c"] = np.full(COUNTS[0], np.nan)  # nothing left: count 0
    ours = TSM.partial_summary.plain(frame, ["a", "b", "k", "c"])
    theirs = JSM.partial_summary.plain(pd.DataFrame(frame),
                                       ["a", "b", "k", "c"])
    assert ours.keys() == theirs.keys()
    for key in ours:
        for col in ("a", "b", "k"):
            # numpy's sums over the NaN-filled column, as pandas' nansum:
            # the same numbers, the same types
            assert ours[key][col] == theirs[key][col], (key, col)
            assert type(ours[key][col]) is type(theirs[key][col])
    assert ours["count"]["c"] == theirs["count"]["c"] == 0
    assert ours["sum"]["c"] == theirs["sum"]["c"] == 0.0
    assert np.isnan(ours["min"]["c"]) and np.isnan(theirs["min"]["c"])


def test_central_summary_matches_jax():
    frames = _numeric_frames(1, nan_share=0.1)
    ours, theirs = _both(frames, TSM, JSM, "central_summary",
                         {"columns": ["a", "b", "k"]})
    assert ours == theirs
    pooled = pd.concat([pd.DataFrame(f) for f in frames])
    np.testing.assert_allclose(ours["a"]["std"], pooled["a"].std(),
                               rtol=1e-9)


def test_summary_device_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 40, 3)).astype(np.float32)
    datasets = [{"x": x[i], "count": np.float32(c)}
                for i, c in enumerate(COUNTS)]
    x[1, COUNTS[1]:] = 1e6  # padding must not reach min/max/sums
    ours = TSM.summary_device(federation_from_datasets(
        datasets, {"summary": TSM}, device="cpu"))
    theirs = JSM.summary_device(jax_federation(datasets,
                                               algorithms={"summary": JSM}))
    pooled = np.concatenate([x[i, :c] for i, c in enumerate(COUNTS)])
    assert ours["count"] == theirs["count"] == sum(COUNTS)
    np.testing.assert_array_equal(ours["min"], pooled.min(0))
    np.testing.assert_array_equal(ours["max"], theirs["max"])
    # f32 sums over 86 rows in another order
    for k in ("mean", "std"):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours["std"], pooled.std(0, ddof=1),
                               rtol=1e-4)
    # an integer count leaf promotes as in JAX: s / n and n / (n - 1) in f32
    ints = TSM.summary_device(federation_from_datasets(
        [dict(d, count=np.int32(d["count"])) for d in datasets],
        {"summary": TSM}, device="cpu"))
    assert ints["count"] == sum(COUNTS) and ints["mean"].dtype == np.float32
    for k in ("mean", "std", "min", "max"):
        np.testing.assert_array_equal(ints[k], ours[k])


# ----------------------------------------------------------------- crosstab
def _cat_frames(seed=2):
    rng = np.random.default_rng(seed)
    frames = []
    for n in COUNTS:
        frames.append({
            "site": np.asarray(["a", "b", "c"])[rng.choice(
                3, size=n, p=[0.6, 0.35, 0.05])],
            "stage": rng.integers(1, 4, size=n),                # int: '1'
            "grade": rng.integers(1, 3, size=n).astype(float),  # '1.0'
        })
    return frames


@pytest.mark.parametrize("cols,min_cell", [
    (("site", "stage"), 0), (("site", "grade"), 3), (("stage", "grade"), 5)])
def test_crosstab_matches_jax(cols, min_cell):
    frames = _cat_frames()
    kw = {"row_col": cols[0], "col_col": cols[1], "min_cell_count": min_cell}
    ours, theirs = _both(frames, TS, JS, "central_crosstab", kw)
    assert ours == theirs
    part = TS.partial_crosstab.plain(frames[1], **kw)
    assert part == JS.partial_crosstab.plain(pd.DataFrame(frames[1]), **kw)
    if "grade" in cols:
        assert "1.0" in ours["columns"] or "1.0" in ours["rows"]
    if min_cell:
        assert any(v is None for row in ours["table"] for v in row)


# -------------------------------------------------------------- correlation
def test_correlation_matches_jax_and_pooled():
    frames = _numeric_frames(3, nan_share=0.1)
    ours, theirs = _both(frames, TS, JS, "central_correlation",
                         {"columns": ["a", "b", "k"]})
    assert ours["n"] == theirs["n"]
    # float64 moments on both sides, in one order
    np.testing.assert_allclose(ours["matrix"], theirs["matrix"], atol=1e-14)
    pooled = pd.concat([pd.DataFrame(f) for f in frames]).dropna()
    np.testing.assert_allclose(ours["matrix"], np.corrcoef(
        pooled[["a", "b", "k"]].to_numpy().T), atol=1e-12)
    assert ours["n"] == len(pooled)


# ----------------------------------------------------------------- quantile
@pytest.mark.parametrize("q,lo,hi,tol", [
    (0.5, None, None, 1e-6), (0.9, -10.0, 20.0, 1e-9), (0.1, None, 15.0, 0.0)])
def test_central_quantile_matches_jax(q, lo, hi, tol):
    frames = _numeric_frames(4, nan_share=0.15)
    kw = {"column": "a", "q": q, "lo": lo, "hi": hi, "tol": tol}
    ours, theirs = _both(frames, TQ, JQ, "central_quantile", kw)
    # the same bisection in Python floats over the same counts
    assert ours == theirs
    vals = np.sort(np.concatenate([f["a"] for f in frames]))
    vals = vals[~np.isnan(vals)]
    rank = vals[int(np.ceil(q * len(vals))) - 1]
    assert ours["n"] == len(vals)
    assert rank <= ours["value"] <= rank + max(tol, 0.0)
    if tol == 0.0:  # 64 steps collapse the bracket onto the rank value
        assert ours["value"] == rank


@pytest.mark.parametrize("kw,match", [
    ({"q": 1.0}, "q must be"), ({"lo": 5.0, "hi": 1.0}, "invalid range"),
    ({"lo": -10.0, "hi": 1.0}, "widen the range"),
    ({"lo": 3.0, "hi": 20.0, "q": 0.1}, "lower lo")])
def test_central_quantile_bracket_errors_match_jax(kw, match):
    frames = _numeric_frames(5)
    msgs = []
    for client in (
            MockAlgorithmClient([[{"database": f}] for f in frames],
                                module=TQ, device="cpu"),
            JaxMock([[{"database": pd.DataFrame(f)}] for f in frames],
                    module=JQ)):
        with pytest.raises(ValueError, match=match) as err:
            TQ.central_quantile.plain(client, "a", **kw) \
                if isinstance(client, MockAlgorithmClient) \
                else JQ.central_quantile.plain(client, "a", **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_quantile_partials_drop_nan_as_pandas():
    frame = {"a": np.asarray([3.0, np.nan, 1.0, 7.0]),
             "o": np.asarray([2.0, None, 5.0], object)}
    for col in ("a", "o"):
        assert TQ.partial_bounds.plain(frame, col) == \
            JQ.partial_bounds.plain(pd.DataFrame({col: frame[col]}), col)
        assert TQ.partial_count_below.plain(frame, col, 2.5) == \
            JQ.partial_count_below.plain(pd.DataFrame({col: frame[col]}),
                                         col, 2.5)
    assert TQ.partial_bounds.plain({"a": np.full(2, np.nan)}, "a") == {
        "lo": None, "hi": None, "count": 0}


# ---------------------------------------------------------------------- GLM
def _glm_frames(family, seed=0):
    rng = np.random.default_rng(seed)
    beta = np.asarray([0.3, 0.5, -0.4])
    frames = []
    for n in (120, 80, 100):
        x = rng.normal(size=(n, 2))
        eta = beta[0] + x @ beta[1:]
        if family == "gaussian":
            y = eta + rng.normal(0, 0.5, n)
        elif family == "binomial":
            y = (rng.uniform(size=n) < 1 / (1 + np.exp(-eta))).astype(float)
        else:
            y = rng.poisson(np.exp(eta)).astype(float)
        frames.append({"x0": x[:, 0], "x1": x[:, 1], "y": y,
                       "w": rng.uniform(0.5, 2.0, n)})
    return frames


def _numpy_irls(family, x, y, w, n_iter=50):
    """Pooled float64 IRLS in numpy (weighted), to convergence."""
    beta = np.zeros(x.shape[1])
    for _ in range(n_iter):
        eta = x @ beta
        if family == "gaussian":
            mu, v = eta, np.ones_like(eta)
        elif family == "binomial":
            mu = 1 / (1 + np.exp(-eta))
            v = mu * (1 - mu)
        else:
            mu = np.exp(eta)
            v = mu
        step = np.linalg.solve(x.T @ (x * (w * v)[:, None]),
                               x.T @ (w * (y - mu)))
        beta = beta + step
        if np.abs(step).max() < 1e-14:
            break
    return beta


@pytest.mark.parametrize("family", ["gaussian", "binomial", "poisson"])
def test_central_glm_matches_numpy_irls_and_the_device_fit(family):
    frames = _glm_frames(family)
    client = MockAlgorithmClient([[{"database": f}] for f in frames],
                                 module=TG, device="cpu")
    task = client.task.create(input_={"method": "central_glm", "kwargs": {
        "family": family, "feature_cols": ["x0", "x1"], "label_col": "y"}},
        organizations=[0])
    (res,) = client.result.get(task["id"])
    x = np.concatenate([TG._design(f, ["x0", "x1"]) for f in frames])
    y = np.concatenate([f["y"] for f in frames])
    ref = _numpy_irls(family, x, y, np.ones_like(y))
    assert res["converged"] and res["count"] == len(y)
    assert res["columns"] == ["(intercept)", "x0", "x1"]
    # float64 IRLS to 1e-8 on both sides; the jitter 1e-8 on X'WX (~300)
    np.testing.assert_allclose(res["coefficients"], ref, rtol=1e-8,
                               atol=1e-10)
    sx, sy, m = TG.stack_glm_data(frames, ["x0", "x1"], "y")
    dev = TG.fit_glm_device(FederationMesh(3, "cpu"), sx, sy, m, family)
    np.testing.assert_allclose(res["coefficients"], dev["beta"].numpy(),
                               rtol=1e-8, atol=1e-10)
    # standard errors from the inverse Fisher information at the optimum
    mu = {"gaussian": lambda e: e, "binomial": lambda e: 1 / (1 + np.exp(-e)),
          "poisson": np.exp}[family](x @ ref)
    v = {"gaussian": np.ones_like(mu), "binomial": mu * (1 - mu),
         "poisson": mu}[family]
    disp = (np.sum((y - mu) ** 2) / (len(y) - 3) if family == "gaussian"
            else 1.0)
    se = np.sqrt(np.diag(np.linalg.inv(x.T @ (x * v[:, None]))) * disp)
    np.testing.assert_allclose(res["std_errors"], se, rtol=1e-6)
    np.testing.assert_allclose(res["dispersion"], disp, rtol=1e-6)


def test_central_glm_weights_and_contracts(monkeypatch):
    frames = _glm_frames("poisson", seed=3)
    client = MockAlgorithmClient([[{"database": f}] for f in frames],
                                 module=TG, device="cpu")
    res = TG.central_glm.plain(client, "poisson", ["x0", "x1"], "y",
                               weight_col="w")
    x = np.concatenate([TG._design(f, ["x0", "x1"]) for f in frames])
    y = np.concatenate([f["y"] for f in frames])
    w = np.concatenate([f["w"] for f in frames])
    np.testing.assert_allclose(res["coefficients"],
                               _numpy_irls("poisson", x, y, w), rtol=1e-8,
                               atol=1e-10)
    short = TG.central_glm.plain(client, "binomial", ["x0"], "y", n_iter=1)
    assert short["iterations"] == 1 and not short["converged"]
    with pytest.raises(ValueError, match="unknown family"):
        TG.central_glm.plain(client, "gamma", ["x0"], "y")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.partial_glm_stats.plain(frames[0], [0.0] * 3, "gaussian",
                                   ["x0", "x1"], "y")
    out = TG.partial_glm_stats.plain(frames[0], [0.0] * 3, "gaussian",
                                     ["x0", "x1"], "y", device="cpu")
    assert out["xtwx"].dtype == np.float64 and out["count"] == 120


# ------------------------------------------------------------- vertical LR
def test_central_vertical_logistic_matches_jax():
    rng = np.random.default_rng(6)
    n = 60
    blocks = [rng.normal(size=(n, p)) for p in (2, 3, 1)]
    logit = sum(b @ rng.normal(size=b.shape[1]) for b in blocks)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(float)
    names = [[f"s{s}_{j}" for j in range(b.shape[1])]
             for s, b in enumerate(blocks)]
    frames = [{c: b[:, j] for j, c in enumerate(cols)}
              for b, cols in zip(blocks, names)]
    frames[0]["y"] = y
    kw = {"feature_map": {str(i): c for i, c in enumerate(names)},
          "label_org": 0, "label_col": "y", "n_iter": 25, "lr": 0.5,
          "l2": 0.01}
    ours, theirs = _both(frames, TV, JV, "central_vertical_logistic", kw)
    assert ours["n"] == theirs["n"] == n
    assert ours["weights"].keys() == theirs["weights"].keys()
    # numpy float64 on both sides, the same operations
    for k in ours["weights"]:
        np.testing.assert_allclose(ours["weights"][k], theirs["weights"][k],
                                   rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(ours["losses"], theirs["losses"], rtol=1e-12)
    np.testing.assert_allclose(ours["bias"], theirs["bias"], atol=1e-14)
    assert ours["losses"][-1] < ours["losses"][0]


# ------------------------------------------------------- observed dispatch
def _observed(name):
    (fn,) = [f for f in DEVICE_OBS.functions() if f.name == name]
    return fn


def test_glm_and_quantile_device_calls_are_observed_dispatches():
    frames = _glm_frames("gaussian")
    sx, sy, m = TG.stack_glm_data(frames, ["x0", "x1"], "y")
    mesh = FederationMesh(3, "cpu")
    irls = _observed("glm.irls.gaussian")
    before = irls.dispatches
    TG.fit_glm_device(mesh, sx, sy, m, "gaussian", n_iter=3)
    assert irls.dispatches == before + 1
    assert _observed("glm.irls.poisson").name == "glm.irls.poisson"
    bis = _observed("quantile.bisection")
    before = bis.dispatches
    TQ.quantile_device(mesh, sy, m, q=0.5, n_iter=8)
    assert bis.dispatches == before + 1
    assert bis.stats()["function"] == "quantile.bisection"
