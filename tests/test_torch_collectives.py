"""The port's station-axis aggregation, flat-pack seam and learning stats
against the JAX package's, and its one-GPU FederationMesh."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vantage6_tpu_torch._tree import tree_leaves
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


def test_fed_map_batched_equals_the_loop():
    mesh = FederationMesh(3, device="cpu")
    data = mesh.shard_stacked(
        np.random.default_rng(7).normal(size=(3, 4, 2)).astype(np.float32))
    w = mesh.replicate(np.float32([[1.0, -2.0], [0.5, 3.0]]))

    def fn(x, w):
        return {"y": torch.tanh(x @ w), "n": (x * x).sum()}

    loop = mesh.fed_map(fn, data, replicated_args=(w,))
    batched = mesh.fed_map(fn, data, replicated_args=(w,), batched=True)
    for k in loop:
        torch.testing.assert_close(batched[k], loop[k], rtol=1e-6, atol=1e-7)


# ----------------------------------------------------- flat-pack and stats

def _cnn_like(seed, s=None):
    """A nested dict built in flax's insertion order (kernel before bias),
    plus a list leaf: jax.tree.leaves sorts the keys, and so must the port."""
    rng = np.random.default_rng(seed)
    lead = () if s is None else (s,)

    def arr(*shape):
        return rng.normal(size=lead + shape).astype(np.float32)

    return {"Dense_0": {"kernel": arr(6, 3), "bias": arr(3)},
            "Conv_0": {"kernel": arr(3, 3, 1, 2), "bias": arr(2)},
            "extra": [arr(4), arr(2, 2)]}


def test_tree_order_is_jax_order():
    tree = _cnn_like(0)
    ours = [x.tolist() for x in tree_leaves(tree)]
    assert ours == [x.tolist() for x in jax.tree.leaves(tree)]


def test_flatten_matches_jax_exactly_and_round_trips():
    tree = _cnn_like(1)
    flat = tc.flatten_tree(_torch(tree))
    j_flat = jc.flatten_tree(_jax(tree))
    assert flat.dtype == torch.float32
    assert np.array_equal(flat.numpy(), np.asarray(j_flat))
    assert tc.flat_size(tree) == jc.flat_size(tree) == flat.numel()
    assert tc.padded_flat_size(10, 4) == jc.padded_flat_size(10, 4) == 12
    padded = torch.nn.functional.pad(flat, (0, 3))  # scatter padding
    back = tc.unflatten_like(_torch(tree), padded)
    _assert_tree_close(back, _jax(tree), rtol=0, atol=0)
    bf = tc.flatten_tree(_torch(tree), dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16


def test_flatten_stacked_matches_jax_exactly_and_round_trips():
    stacked = _cnn_like(2, s=4)
    rows = tc.flatten_stacked(_torch(stacked))
    assert np.array_equal(rows.numpy(),
                          np.asarray(jc.flatten_stacked(_jax(stacked))))
    template = jax.tree.map(lambda x: torch.from_numpy(x[0]), stacked)
    back = tc.unflatten_stacked(template, rows)
    _assert_tree_close(back, _jax(stacked), rtol=0, atol=0)
    with pytest.raises(ValueError, match="empty"):
        tc.flatten_stacked({})


def _rows(seed, s=4, n=37):
    return np.random.default_rng(seed).normal(size=(s, n)).astype(np.float32)


@pytest.mark.parametrize("case", ["plain", "weights", "mask", "ef", "nan",
                                  "all_dropped"])
def test_station_update_stats_match_jax(case):
    x = _rows(3)
    kw = {}
    if case in ("weights", "nan"):
        kw["weights"] = np.asarray([3.0, 1.0, 4.0, 0.5], np.float32)
    if case in ("mask", "nan"):
        kw["mask"] = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    if case == "nan":
        x[1] = np.nan  # a crashed station, masked out
    if case == "ef":
        kw["ef"] = _rows(4)
    if case == "all_dropped":
        kw["mask"] = np.zeros(4, np.float32)
    ours = tc.station_update_stats(
        torch.from_numpy(x),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    theirs = jc.station_update_stats(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in kw.items()})
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   rtol=1e-6, atol=1e-6, equal_nan=True)
    if case == "nan":
        assert np.isfinite(ours["update_norm"].item())
        assert np.isfinite(ours["station_cos"][[0, 2, 3]].numpy()).all()
    if case == "all_dropped":
        assert ours["update_norm"].item() == 0.0


@pytest.mark.parametrize("mask", [np.ones(3, np.float32),
                                  np.eye(4, 3, dtype=np.float32)])
def test_per_round_masks_match_jax(mask):
    ours = tc.per_round_masks(torch.from_numpy(mask), 4)
    theirs = jc.per_round_masks(jnp.asarray(mask), 4)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (4, 3)
    assert np.array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("bad, match", [
    (np.ones((2, 3), np.float32), "per-round mask has 2 rounds, expected 4"),
    (np.ones((4, 3, 1), np.float32), "mask must be"),
])
def test_per_round_masks_errors_match_jax(bad, match):
    with pytest.raises(ValueError, match=match):
        tc.per_round_masks(torch.from_numpy(bad), 4)
    with pytest.raises(ValueError, match=match):
        jc.per_round_masks(jnp.asarray(bad), 4)


@pytest.fixture(scope="module")
def one_slot_meshes():
    from vantage6_tpu.core.mesh import FederationMesh as JaxMesh

    return FederationMesh(4, device="cpu"), JaxMesh(4, devices=jax.devices()[:1])


@pytest.mark.parametrize("comm_dtype", [None, "bfloat16"])
def test_scattered_forms_match_jax_on_one_slot(one_slot_meshes, comm_dtype):
    mesh, jmesh = one_slot_meshes
    x = _stacked(6)
    x["w"][2] = np.nan  # masked out below
    w = np.asarray([2.0, 1.0, 0.0, 3.0], np.float32)
    t_dt = None if comm_dtype is None else getattr(torch, comm_dtype)
    j_dt = None if comm_dtype is None else getattr(jnp, comm_dtype)
    ours = tc.fed_mean_scattered(mesh, _torch(x), weights=w, comm_dtype=t_dt)
    theirs = jc.fed_mean_scattered(jmesh, _jax(x), weights=w,
                                   comm_dtype=j_dt)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               rtol=1e-6, atol=1e-7)
    s = tc.fed_sum_scattered(mesh, _torch(x), weights=w, comm_dtype=t_dt)
    np.testing.assert_allclose(
        s.numpy(), np.asarray(jc.fed_sum_scattered(jmesh, _jax(x), weights=w,
                                                   comm_dtype=j_dt)),
        rtol=1e-6, atol=1e-7)
    assert tc.all_gather_stations(mesh, s) is s
    with pytest.raises(ValueError, match="mesh federates"):
        tc.fed_sum_scattered(FederationMesh(3, device="cpu"), _torch(x))
