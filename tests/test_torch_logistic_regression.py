"""The port's federated logistic regression against the JAX package's, on
the CPU.

The same seeded numpy rows go through the JAX workload (its Federation and
MockAlgorithmClient on the CPU, pandas frames for the host mode) and the
port (``device="cpu"``, dicts of numpy columns), f32 on both sides.
"""
import importlib

import numpy as np
import pandas as pd
import pytest
import torch

from vantage6_tpu_torch.algorithm import MockAlgorithmClient
from vantage6_tpu_torch.runtime.federation import federation_from_datasets
from vantage6_tpu_torch.workloads import logistic_regression as TL

JL = importlib.import_module("vantage6_tpu.workloads.logistic_regression")
JM = importlib.import_module("vantage6_tpu.models.logistic")
JaxMock = importlib.import_module(
    "vantage6_tpu.algorithm.mock_client").MockAlgorithmClient
jax_federation = importlib.import_module(
    "vantage6_tpu.runtime.federation").federation_from_datasets
synthetic_tabular = importlib.import_module(
    "vantage6_tpu.utils.datasets").synthetic_tabular

FEATURES = [f"f{i}" for i in range(6)]
COUNTS = [50, 31, 44, 50]  # ragged: rows past a station's count are padding


def _rows(seed, scale=1.0):
    x, y = synthetic_tabular(sum(COUNTS), n_features=6, seed=seed)
    return (x * scale).astype(np.float32), y.astype(np.float32)


def _device_data(x, y):
    n_max, edges = max(COUNTS), np.cumsum([0] + COUNTS)
    return [{"x": np.pad(x[lo:hi], ((0, n_max - (hi - lo)), (0, 0))),
             "y": np.pad(y[lo:hi], (0, n_max - (hi - lo))),
             "count": np.float32(hi - lo)}
            for lo, hi in zip(edges[:-1], edges[1:])]


def _frames(x, y):
    edges = np.cumsum([0] + COUNTS)
    out = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        cols = {f: x[lo:hi, j] for j, f in enumerate(FEATURES)}
        cols["outcome"] = y[lo:hi]
        out.append(cols)
    return out


def test_partial_gradient_matches_jax():
    x, y = _rows(0)
    frame = _frames(x, y)[1]
    coefs = {"w": np.linspace(-0.3, 0.3, 6, dtype=np.float32)[:, None],
             "b": np.asarray([0.1], np.float32)}
    ours = TL.partial_gradient.plain(frame, coefs, FEATURES, "outcome",
                                     device="cpu")
    theirs = JL.partial_gradient.plain(pd.DataFrame(frame), coefs, FEATURES,
                                       "outcome")
    assert ours["count"] == theirs["count"] == COUNTS[1]
    # f32 sums over 31 rows of O(1) terms, in another order
    for k in ("grad_w", "grad_b"):
        assert ours[k].shape == theirs[k].shape
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=1e-6)


def test_device_gradient_far_from_zero_is_logaddexp():
    """Logits of |z| up to ~80: the loss is logaddexp(0, z), finite and
    equal to JAX's where exp(z) alone would overflow f32 at z > 88 and a
    thresholded softplus is another function."""
    x, y = _rows(1, scale=12.0)
    params = {"w": np.full((6, 1), 1.5, np.float32),
              "b": np.asarray([0.5], np.float32)}
    z = x @ params["w"][:, 0] + 0.5
    assert np.abs(z).max() > 20 and (z > 20).any() and (z < -20).any()
    data = _device_data(x, y)[0]
    tdata = {k: torch.as_tensor(v) for k, v in data.items()}
    ours = TL.partial_gradient_device(
        tdata, {k: torch.from_numpy(v) for k, v in params.items()})
    theirs = JL.partial_gradient_device(data, params)
    for k in ("w", "b"):
        got, ref = ours["grad"][k].numpy(), np.asarray(theirs["grad"][k])
        assert np.isfinite(got).all()
        # f32 sums over 50 rows of terms up to |x| ~ 40
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def _pooled_gd(x, y, n_iter, lr):
    """Full-batch GD on the pooled rows with the JAX model's loss."""
    import jax

    params = {"w": np.zeros((6, 1), np.float32), "b": np.zeros(1, np.float32)}
    for _ in range(n_iter):
        g = jax.grad(lambda p: JM.binary_loss(p, x, y))(params)
        params = jax.tree.map(lambda p, gg: p - lr * gg, params, g)
    return params


def test_fit_device_matches_jax():
    x, y = _rows(2)
    data = _device_data(x, y)
    fed = federation_from_datasets(data, {"logreg": TL}, device="cpu")
    jfed = jax_federation(data, algorithms={"logreg": JL})
    # the JAX Federation traces each task's step anew: 3 iterations of its
    # engine, 40 against JAX's pooled GD
    ours = TL.fit_device(fed, n_features=6, n_iter=3, lr=0.5)
    theirs = JL.fit_device(jfed, n_features=6, n_iter=3, lr=0.5)
    assert ours["w"].shape == (6, 1) and ours["w"].dtype == torch.float32
    # f32 GD steps, each gradient an f32 sum over 175 rows
    for k in ("w", "b"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   atol=1e-6)
    ours = TL.fit_device(fed, n_features=6, n_iter=40, lr=0.5)
    pooled = _pooled_gd(x, y, 40, 0.5)
    for k in ("w", "b"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(pooled[k]),
                                   atol=1e-5)


def test_central_logistic_over_dicts_matches_jax_over_frames():
    x, y = _rows(3)
    frames = _frames(x, y)
    kw = {"feature_cols": FEATURES, "label_col": "outcome", "n_iter": 30,
          "lr": 0.5}
    out = []
    for client in (
            MockAlgorithmClient([[{"database": f}] for f in frames],
                                module=TL, device="cpu"),
            JaxMock([[{"database": pd.DataFrame(f)}] for f in frames],
                    module=JL)):
        task = client.task.create(
            input_={"method": "central_logistic", "kwargs": kw},
            organizations=[0])
        (res,) = client.result.get(task["id"])
        out.append(res)
    ours, theirs = out
    assert ours["n_samples"] == theirs["n_samples"] == sum(COUNTS)
    assert ours["w"].dtype == np.float32
    # 30 f32 GD steps; the stations' gradients summed in numpy
    np.testing.assert_allclose(ours["w"], theirs["w"], atol=1e-5)
    np.testing.assert_allclose(ours["b"], theirs["b"], atol=1e-5)


def test_host_partial_needs_a_device_without_cuda(monkeypatch):
    x, y = _rows(0)
    frame = _frames(x, y)[0]
    coefs = {"w": np.zeros((6, 1), np.float32), "b": np.zeros(1, np.float32)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.partial_gradient.plain(frame, coefs, FEATURES, "outcome")
    with pytest.raises(ValueError, match="n_iter"):
        client = MockAlgorithmClient([[{"database": frame}]], module=TL,
                                     device="cpu")
        TL.central_logistic.plain(client, FEATURES, "outcome", n_iter=0)
