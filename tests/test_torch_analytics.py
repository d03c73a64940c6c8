"""The port's device analysis programs against the JAX package's, on the CPU.

The same seeded numpy data (ragged stations, padded rows) go through the
JAX function on a one-device mesh and its port on a CPU mesh, in f32 on
both sides; GLM is held to float64 numpy oracles instead (the JAX
package's GLM tests are red in this environment: its host mode calls
``jax.experimental.enable_x64``). The JAX prep helpers take pandas frames,
the port's take plain dicts of numpy columns.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.models import logistic as TL
from vantage6_tpu_torch.utils.datasets import pad_shards
from vantage6_tpu_torch.workloads import glm as TG
from vantage6_tpu_torch.workloads import quantiles as TQ
from vantage6_tpu_torch.workloads import stats as TS
from vantage6_tpu_torch.workloads import vertical as TV

JL = importlib.import_module("vantage6_tpu.models.logistic")
JS = importlib.import_module("vantage6_tpu.workloads.stats")
JQ = importlib.import_module("vantage6_tpu.workloads.quantiles")
JV = importlib.import_module("vantage6_tpu.workloads.vertical")
JaxMesh = importlib.import_module("vantage6_tpu.core.mesh").FederationMesh

S = 3
COUNTS = [40, 17, 29]  # ragged: rows past a station's count are padding


def _meshes(s=S):
    return JaxMesh(s, devices=jax.devices()[:1]), FederationMesh(s, "cpu")


def _padded(seed, p=None, dtype=np.float32, loc=0.0):
    """Ragged station rows, stacked and zero-padded: (x [S, n_max(, p)],
    mask [S, n_max], pooled rows)."""
    rng = np.random.default_rng(seed)
    shape = () if p is None else (p,)
    shards = [(loc + rng.normal(size=(n,) + shape)).astype(dtype)
              for n in COUNTS]
    x, _, counts = pad_shards([(s, s) for s in shards])
    mask = (np.arange(x.shape[1])[None, :] < counts[:, None]).astype(
        np.float32)
    return x, mask, np.concatenate(shards)


# ------------------------------------------------------------- logistic
def test_logistic_model_matches_jax():
    rng = np.random.default_rng(0)
    jp = JL.init_logistic(jax.random.key(0), 5)
    x = rng.normal(size=(9, 5)).astype(np.float32)
    y = (rng.uniform(size=9) < 0.5).astype(np.float32)
    p = TL.params_from_jax(jp, "cpu")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    # f32 on both sides: one small matmul and a log-sum-exp
    tol = dict(rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(TL.logits(p, tx).numpy(),
                               np.asarray(JL.logits(jp, x)), **tol)
    np.testing.assert_allclose(float(TL.binary_loss(p, tx, ty, l2=0.1)),
                               float(JL.binary_loss(jp, x, y, l2=0.1)), **tol)
    np.testing.assert_allclose(TL.predict_proba(p, tx).numpy(),
                               np.asarray(JL.predict_proba(jp, x)), **tol)
    assert float(TL.binary_accuracy(p, tx, ty)) == float(
        JL.binary_accuracy(jp, x, y))
    jm = JL.init_logistic(jax.random.key(1), 5, n_classes=3)
    m = TL.params_from_jax(jm, "cpu")
    yc = rng.integers(0, 3, size=9)
    np.testing.assert_allclose(
        float(TL.multinomial_loss(m, tx, torch.from_numpy(yc), l2=0.01)),
        float(JL.multinomial_loss(jm, x, jnp.asarray(yc), l2=0.01)), **tol)
    np.testing.assert_allclose(TL.predict_proba(m, tx).numpy(),
                               np.asarray(JL.predict_proba(jm, x)), **tol)


def test_init_logistic_shapes_and_scale():
    p = TL.init_logistic(0, 400, device="cpu")
    assert p["w"].shape == (400, 1) and p["b"].shape == (1,)
    assert bool((p["b"] == 0).all())
    assert abs(float(p["w"].std()) - 0.01) < 0.002
    assert torch.equal(p["w"], TL.init_logistic(
        torch.Generator().manual_seed(0), 400, device="cpu")["w"])
    assert TL.init_logistic(0, 4, n_classes=3, device="cpu")["w"].shape == \
        (4, 3)


# ----------------------------------------------------------- correlation
def test_correlation_matches_jax_and_pooled():
    x, m, pooled = _padded(1, p=4, loc=2.0)
    jmesh, mesh = _meshes()
    ours = TS.correlation_device(mesh, x, m)
    theirs = JS.correlation_device(jmesh, jnp.asarray(x), jnp.asarray(m))
    assert ours.dtype == torch.float32 and ours.shape == (4, 4)
    # f32 moment sums over 86 rows, in another summation order
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5)
    np.testing.assert_allclose(ours.numpy(), np.corrcoef(pooled.T),
                               atol=2e-5)
    # float64 rows run in float64
    ours64 = TS.correlation_device(mesh, x.astype(np.float64), m)
    assert ours64.dtype == torch.float64
    np.testing.assert_allclose(ours64.numpy(), np.corrcoef(pooled.T),
                               atol=1e-12)


# -------------------------------------------------------------- crosstab
def _cat_frames(seed=2):
    rng = np.random.default_rng(seed)
    rows = np.asarray(["a", "b", "c"])
    cols = np.asarray([1, 2])
    frames = []
    for n in COUNTS:
        r = rows[rng.choice(3, size=n, p=[0.6, 0.35, 0.05])]
        c = cols[rng.integers(0, 2, size=n)]
        frames.append({"r": r, "c": c})
    return frames


@pytest.mark.parametrize("min_cell", [0, 3])
def test_crosstab_matches_jax(min_cell):
    frames = _cat_frames()
    ours = TS.encode_crosstab(frames, "r", "c")
    theirs = JS.encode_crosstab([pd.DataFrame(f) for f in frames], "r", "c")
    for a, b in zip(ours[:3], theirs[:3]):
        np.testing.assert_array_equal(a, b)
    assert ours[3:] == theirs[3:] == (["a", "b", "c"], ["1", "2"])
    jmesh, mesh = _meshes()
    rc, cc, m = ours[:3]
    t = TS.crosstab_device(mesh, rc, cc, m, 3, 2, min_cell_count=min_cell)
    j = JS.crosstab_device(jmesh, rc, cc, m, 3, 2, min_cell_count=min_cell)
    assert t == j  # exact integer counts, the same cells poisoned
    pooled = np.zeros((3, 2), int)
    for f in frames:
        for r, c in zip(f["r"], f["c"]):
            pooled["abc".index(r), int(c) - 1] += 1
    table = np.asarray([[-1 if v is None else v for v in row]
                        for row in t["table"]])
    assert ((table == pooled) | (table == -1)).all()
    if min_cell:
        assert (table == -1).any()  # the rare category's cells poison
    else:
        assert (table == pooled).all()


# -------------------------------------------------------------- quantile
@pytest.mark.parametrize("q,lo,hi", [(0.5, None, None), (0.9, None, None),
                                     (0.25, -10.0, 10.0)])
def test_quantile_matches_jax_and_rank_value(q, lo, hi):
    x, m, pooled = _padded(3)
    jmesh, mesh = _meshes()
    ours = TQ.quantile_device(mesh, x, m, q=q, lo=lo, hi=hi)
    theirs = JQ.quantile_device(jmesh, x, m, q=q, lo=lo, hi=hi)
    assert ours == theirs  # the same f32 bisection steps, exactly
    rank = np.sort(pooled)[math.ceil(q * len(pooled)) - 1]
    assert ours["value"] == float(rank) and ours["n"] == len(pooled)


def test_quantile_integer_column_and_guards():
    x, m, pooled = _padded(4)
    xi = np.round(x * 10).astype(np.int32)
    jmesh, mesh = _meshes()
    ours = TQ.quantile_device(mesh, xi, m, q=0.5)
    assert ours == JQ.quantile_device(jmesh, xi, m, q=0.5)
    with pytest.raises(ValueError, match="widen the range"):
        TQ.quantile_device(mesh, x, m, q=0.5, lo=-10.0, hi=-5.0)
    with pytest.raises(ValueError, match="lower lo"):
        TQ.quantile_device(mesh, x, m, q=0.5, lo=5.0, hi=10.0)
    with pytest.raises(ValueError, match="no rows"):
        TQ.quantile_device(mesh, x, np.zeros_like(m), q=0.5, lo=0.0, hi=1.0)
    with pytest.raises(ValueError, match="q must be"):
        TQ.quantile_device(mesh, x, m, q=1.0)


# ------------------------------------------------------------------ GLM
def _glm_frames(family, n_stations=3, n=120, seed=0):
    """tests/test_glm.py's data, as dicts of numpy columns."""
    rng = np.random.default_rng(seed)
    beta_true = np.asarray([0.4, -0.8, 0.5])
    frames = []
    for _ in range(n_stations):
        x = rng.normal(0, 1, (n, 2))
        eta = beta_true[0] + x @ beta_true[1:]
        if family == "gaussian":
            y = eta + rng.normal(0, 0.5, n)
        elif family == "binomial":
            y = (rng.uniform(size=n) < 1 / (1 + np.exp(-eta))).astype(float)
        else:
            y = rng.poisson(np.exp(eta)).astype(float)
        frames.append({"x0": x[:, 0], "x1": x[:, 1], "y": y})
    return frames


def _pooled_design(frames):
    x = np.concatenate([np.column_stack([f["x0"], f["x1"]]) for f in frames])
    y = np.concatenate([f["y"] for f in frames])
    return np.column_stack([np.ones(len(y)), x]), y


def _numpy_newton(family, x, y, n_iter=50):
    """Pooled float64 Newton/IRLS in numpy: the MLE."""
    beta = np.zeros(x.shape[1])
    for _ in range(n_iter):
        eta = x @ beta
        mu = 1 / (1 + np.exp(-eta)) if family == "binomial" else np.exp(eta)
        w = mu * (1 - mu) if family == "binomial" else mu
        step = np.linalg.solve(x.T @ (x * w[:, None]), x.T @ (y - mu))
        beta = beta + step
        if np.abs(step).max() < 1e-14:
            break
    return beta


@pytest.mark.parametrize("family", ["gaussian", "binomial", "poisson"])
def test_glm_float64_matches_numpy_oracles(family):
    frames = _glm_frames(family, seed=11)
    frames[1] = {k: v[:70] for k, v in frames[1].items()}  # padded rows
    sx, sy, m = TG.stack_glm_data(frames, ["x0", "x1"], "y")
    assert sx.dtype == np.float64 and sx.shape == (3, 120, 3)
    out = TG.fit_glm_device(FederationMesh(3, "cpu"), sx, sy, m, family)
    beta = out["beta"].numpy()
    assert out["beta"].dtype == torch.float64
    assert out["deltas"].shape == out["deviances"].shape == (25,)
    assert float(out["deltas"][-1]) < 1e-10
    x, y = _pooled_design(frames)
    # float64 IRLS to convergence against float64 references: the jitter
    # (1e-8 on X'WX ~ 1e2) moves beta by ~1e-10
    if family == "gaussian":
        ref, *_ = np.linalg.lstsq(x, y, rcond=None)
    else:
        ref = _numpy_newton(family, x, y)
        mu = 1 / (1 + np.exp(-x @ beta)) if family == "binomial" else \
            np.exp(x @ beta)
        np.testing.assert_allclose(x.T @ (y - mu), 0.0, atol=1e-7)
    np.testing.assert_allclose(beta, ref, rtol=1e-8, atol=1e-9)
    mu = x @ beta if family == "gaussian" else (
        1 / (1 + np.exp(-x @ beta)) if family == "binomial"
        else np.exp(x @ beta))
    with np.errstate(divide="ignore", invalid="ignore"):
        dev = {"gaussian": (y - mu) ** 2,
               "binomial": -2 * (y * np.log(mu) + (1 - y) * np.log(1 - mu)),
               "poisson": 2 * (np.where(y > 0, y * np.log(y / mu), 0)
                               - (y - mu))}[family]
    np.testing.assert_allclose(float(out["deviances"][-1]), dev.sum(),
                               rtol=1e-9)


def test_glm_f32_and_contracts():
    frames = _glm_frames("poisson", n_stations=2, n=50, seed=5)
    sx, sy, m = TG.stack_glm_data(frames, ["x0", "x1"], "y")
    out = TG.fit_glm_device(FederationMesh(2, "cpu"),
                            sx.astype(np.float32), sy.astype(np.float32),
                            m.astype(np.float32), "poisson")
    assert out["beta"].dtype == torch.float32
    x, y = _pooled_design(frames)
    # f32 IRLS: X'WX over 100 rows rounded to f32
    np.testing.assert_allclose(out["beta"].numpy(),
                               _numpy_newton("poisson", x, y), atol=2e-5)
    with pytest.raises(ValueError, match="unknown family"):
        TG.fit_glm_device(FederationMesh(2, "cpu"), sx, sy, m, "gamma")
    with pytest.raises(ValueError, match="feature column"):
        TG.stack_glm_data(frames, [], "y")


# ---------------------------------------------------------- vertical LR
def test_vertical_matches_jax_and_pooled_gd():
    rng = np.random.default_rng(6)
    n = 64
    cols = [["a0", "a1", "a2"], ["b0"], ["c0", "c1"]]
    frames = [{c: rng.normal(size=n) for c in cs} for cs in cols]
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    sx, counts = TV.stack_vertical_blocks(frames, cols)
    jsx, jcounts = JV.stack_vertical_blocks(
        [pd.DataFrame(f) for f in frames], cols)
    np.testing.assert_array_equal(sx, jsx)
    np.testing.assert_array_equal(counts, jcounts)
    jmesh, mesh = _meshes()
    kw = dict(n_iter=30, lr=0.5, l2=0.01)
    ours = TV.fit_vertical_logistic_device(mesh, sx, y, **kw)
    theirs = JV.fit_vertical_logistic_device(jmesh, jnp.asarray(sx),
                                             jnp.asarray(y), **kw)
    # f32 on both sides, 30 GD steps on O(1) features
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours["weights"].numpy(),
                               np.asarray(theirs["weights"]), **tol)
    np.testing.assert_allclose(float(ours["bias"]), float(theirs["bias"]),
                               **tol)
    np.testing.assert_allclose(ours["losses"].numpy(),
                               np.asarray(theirs["losses"]), **tol)
    assert float(ours["weights"][1, 1:].abs().max()) == 0.0  # padding inert
    # pooled float64 GD on the column-concatenated design
    x = np.concatenate([sx[s, :, :c] for s, c in enumerate(counts)],
                       axis=1).astype(np.float64)
    w, b = np.zeros(x.shape[1]), 0.0
    for _ in range(kw["n_iter"]):
        mu = 1 / (1 + np.exp(-(x @ w + b)))
        w = w - kw["lr"] * (x.T @ (mu - y) / n + kw["l2"] * w)
        b = b - kw["lr"] * np.sum(mu - y) / n
    flat = np.concatenate([ours["weights"][s, :c].numpy()
                           for s, c in enumerate(counts)])
    np.testing.assert_allclose(flat, w, atol=1e-5)
    with pytest.raises(ValueError, match="align on rows"):
        TV.stack_vertical_blocks([frames[0], {"b0": np.zeros(n - 1)}],
                                 cols[:2])
    with pytest.raises(ValueError, match="n_iter"):
        TV.fit_vertical_logistic_device(mesh, sx, y, n_iter=0)
