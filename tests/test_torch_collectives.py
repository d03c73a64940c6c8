"""The port's station-axis aggregation against the JAX package's, and its
one-GPU FederationMesh."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed import collectives as tc

jc = importlib.import_module("vantage6_tpu.fed.collectives")


def _stacked(seed, s=4):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(s, 3, 5)).astype(np.float32),
            "b": [rng.normal(size=(s, 7)).astype(np.float32)]}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _assert_tree_close(ours, theirs, **tol):
    for a, b in zip(jax.tree.leaves(theirs), jax.tree.leaves(ours)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol)


MASKS = [None, [1.0, 1.0, 1.0, 0.0], [0.0, 1.0, 0.0, 1.0], [0.0, 0.0, 0.0, 0.0]]


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("weights", [None, [10.0, 20.0, 5.0, 1.0]])
def test_fed_mean_matches_jax(mask, weights):
    x = _stacked(0)
    m = None if mask is None else np.asarray(mask, np.float32)
    w = None if weights is None else np.asarray(weights, np.float32)
    ours = tc.fed_mean(_torch(x), weights=w, mask=m)
    theirs = jc.fed_mean(_jax(x), weights=w, mask=m)
    _assert_tree_close(ours, theirs, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mask", MASKS)
def test_fed_sum_matches_jax(mask):
    x = _stacked(1)
    m = None if mask is None else np.asarray(mask, np.float32)
    _assert_tree_close(tc.fed_sum(_torch(x), mask=m),
                       jc.fed_sum(_jax(x), mask=m), rtol=1e-6, atol=1e-7)


def test_nan_station_under_mask_zero_is_excluded():
    x = _stacked(2)
    x["w"][3] = np.nan
    x["b"][0][3] = np.inf
    mask = np.asarray([1.0, 1.0, 1.0, 0.0], np.float32)
    ours = tc.fed_mean(_torch(x), mask=mask)
    assert all(torch.isfinite(t).all() for t in jax.tree.leaves(ours))
    _assert_tree_close(ours, jc.fed_mean(_jax(x), mask=mask),
                       rtol=1e-6, atol=1e-7)
    _assert_tree_close(tc.fed_sum(_torch(x), mask=mask),
                       jc.fed_sum(_jax(x), mask=mask), rtol=1e-6, atol=1e-7)


def test_all_dropped_gives_zeros():
    x = _stacked(3)
    ours = tc.fed_mean(_torch(x), mask=np.zeros(4, np.float32))
    for t in jax.tree.leaves(ours):
        assert torch.equal(t, torch.zeros_like(t))


def test_bf16_leaf_accumulates_in_leaf_dtype():
    """The _norm_weights contract: sum and division in the leaf's dtype."""
    x = np.random.default_rng(4).normal(size=(16, 64)).astype(np.float32)
    ours = tc.fed_mean(torch.from_numpy(x).to(torch.bfloat16))
    theirs = jc.fed_mean(jnp.asarray(x).astype(jnp.bfloat16))
    assert ours.dtype == torch.bfloat16
    # both round once per station in bf16, in the same order: a few ulps
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(theirs, np.float32),
                               atol=4 * 2.0**-8, rtol=4 * 2.0**-8)


def test_weighted_stats_and_concat_match_jax():
    x = _stacked(5)
    counts = np.asarray([3.0, 4.0, 0.0, 2.0], np.float32)
    mask = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    s_ours, c_ours = tc.fed_weighted_stats(_torch(x), torch.from_numpy(counts),
                                           mask=mask)
    s_jax, c_jax = jc.fed_weighted_stats(_jax(x), jnp.asarray(counts),
                                         mask=mask)
    _assert_tree_close(s_ours, s_jax, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(c_ours.numpy(), np.asarray(c_jax))
    _assert_tree_close(tc.fed_concat(_torch(x)), jc.fed_concat(_jax(x)))
    with pytest.raises(ValueError, match="empty"):
        tc.fed_mean({})


def test_fed_map_runs_each_station_alone():
    mesh = FederationMesh(3, device="cpu")
    assert (mesh.station_axis_size, mesh.stations_per_slot) == (1, 3)
    data = mesh.shard_stacked(np.arange(12, dtype=np.float32).reshape(3, 4))
    scale = mesh.replicate(np.float32(2.0))
    out = mesh.fed_map(lambda x, s: {"sum": x.sum() * s, "x": x}, data,
                       replicated_args=(scale,))
    np.testing.assert_array_equal(out["sum"].numpy(), [12.0, 44.0, 76.0])
    assert torch.equal(out["x"], data)
    with pytest.raises(ValueError):
        FederationMesh(0, device="cpu")
