"""The port's device engine (``workloads/device_engine.py``) against the JAX
package's at one rank, and across two gloo ranks on the CPU.

At one rank both packages run single-process: the JAX functions through
``__wrapped__`` with a pandas frame, the port's with a dict of numpy
columns. Across ranks the JAX package's own tests skip here (jaxlib's CPU
backend has no multi-process collectives), so the two-rank runs are the
copies of ``tests/test_device_engine_mp.py``'s tasks, called directly in
two processes that each load only their own station's columns, with the
same data sizes, asserts and tolerances.
"""
import importlib

import numpy as np
import pandas as pd
import pytest
from test_torch_distributed import run_ranks

from vantage6_tpu_torch.core import distributed as D
from vantage6_tpu_torch.workloads import device_engine as TE

JE = importlib.import_module("vantage6_tpu.workloads.device_engine")

F32_RTOL = 1e-6
# scattered_bf16 rounds the model to bf16 on the wire every round, in both
# packages; f32 inputs a few ulps apart can round to neighbouring bf16
# values: one bf16 ulp at the weights' magnitudes (below 2)
BF16_ATOL = 2.0**-7


def _frames(n_stations=2, seed=42):
    """tests/test_device_engine_mp.py's stations: disjoint age ranges and a
    separable 2-feature labelled set."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n_stations):
        age = rng.uniform(20 + 30 * i, 50 + 30 * i, 40 + 10 * i).round(1)
        x0 = rng.normal(0, 1, age.size)
        label = (x0 + 0.1 * rng.normal(0, 1, age.size) > 0).astype(float)
        frames.append(pd.DataFrame({"age": age, "x0": x0,
                                    "x1": rng.normal(0, 1, age.size),
                                    "label": label}))
    return frames


def _columns(df):
    return {k: df[k].to_numpy() for k in df.columns}


# ------------------------------------------------------------------ one rank
@pytest.fixture(scope="module")
def station():
    df = pd.concat(_frames(), ignore_index=True)
    df.loc[3, "age"] = np.nan  # dropped by both packages
    return df


def test_column_stats_match_jax(station):
    ours = TE.device_column_stats.__wrapped__(_columns(station), "age",
                                              pad_to=128, device="cpu")
    ref = JE.device_column_stats.__wrapped__(station, "age", pad_to=128)
    np.testing.assert_allclose(ours["mean"], ref["mean"], rtol=F32_RTOL)
    np.testing.assert_allclose(ours["std"], ref["std"], rtol=F32_RTOL)
    assert ours["count"] == ref["count"] == station["age"].count()
    assert (ours["n_stations"], ours["process_index"]) == (1, 0)
    assert ours["global_devices"] == 1  # one rank, one device


@pytest.mark.parametrize("agg_mode",
                         ["replicated", "scattered", "scattered_bf16"])
def test_logistic_fit_matches_jax(station, agg_mode):
    kw = dict(feature_columns=["x0", "x1"], label_column="label", rounds=3,
              local_steps=4, batch_rows=128, lr=0.5, agg_mode=agg_mode)
    ours = TE.device_logistic_fit.__wrapped__(_columns(station),
                                              device="cpu", **kw)
    ref = JE.device_logistic_fit.__wrapped__(station, **kw)
    tol = (dict(rtol=0, atol=BF16_ATOL) if agg_mode == "scattered_bf16"
           else dict(rtol=F32_RTOL, atol=1e-7))
    np.testing.assert_allclose(ours["weights"], ref["weights"], **tol)
    np.testing.assert_allclose(ours["bias"], ref["bias"], **tol)
    assert ours["local_accuracy"] == ref["local_accuracy"]
    assert ours["local_rows"] == ref["local_rows"] == len(station)
    assert ours["agg_mode"] == agg_mode


def test_logistic_fit_rejects_bad_inputs(station):
    cols = _columns(station)
    with pytest.raises(ValueError, match="unknown agg_mode"):
        TE.device_logistic_fit.__wrapped__(cols, ["x0"], "label",
                                           agg_mode="psum", device="cpu")
    with pytest.raises(ValueError, match="raise the task's batch_rows"):
        TE.device_logistic_fit.__wrapped__(cols, ["x0"], "label",
                                           batch_rows=8, device="cpu")
    with pytest.raises(ValueError, match="raise the task's pad_to"):
        TE.device_column_stats.__wrapped__(cols, "age", pad_to=8,
                                           device="cpu")


def test_federation_mesh_is_one_station_per_process():
    """Single-process the mesh holds one station, this process's own; the
    two-rank cases below check ranks 0 and 1 each host theirs."""
    mesh = TE.federation_mesh(device="cpu")
    assert mesh.group is None
    assert (mesh.n_stations, mesh.station_axis_size) == (1, 1)
    assert D.local_stations(mesh) == [D.process_index()] == [0]


# ----------------------------------------------------------------- two ranks
_BODY = """
import numpy as np
from vantage6_tpu_torch.workloads import device_engine as TE

# this process's station only
cols = dict(np.load(f"{sys.argv[4]}/station{rank}.npz"))
res["stats"] = TE.device_column_stats.__wrapped__(cols, "age", pad_to=128)
for mode in ("replicated", "scattered", "scattered_bf16"):
    res[mode] = TE.device_logistic_fit.__wrapped__(
        cols, ["x0", "x1"], "label", rounds=3, local_steps=4,
        batch_rows=64, lr=0.5, agg_mode=mode)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("engine")
    frames = _frames()
    for i, df in enumerate(frames):
        np.savez(tmp / f"station{i}.npz", **_columns(df))
    return frames, run_ranks(tmp, _BODY)


def test_task_spans_two_processes(ranks):
    frames, outs = ranks
    results = [o["stats"] for o in outs]
    pooled = np.concatenate([f["age"].to_numpy(np.float64) for f in frames])
    for r in results:
        # computed over the global mesh: both stations' rows, 2 processes
        assert r["n_stations"] == 2
        assert r["global_devices"] == 2
        np.testing.assert_allclose(r["mean"], pooled.mean(), rtol=1e-5)
        np.testing.assert_allclose(r["std"], pooled.std(), rtol=1e-4)
        assert r["count"] == pooled.size
    # each process reported from its own slot, same aggregate
    assert {r["process_index"] for r in results} == {0, 1}
    assert results[0]["mean"] == results[1]["mean"]


@pytest.mark.parametrize("agg_mode",
                         ["replicated", "scattered", "scattered_bf16"])
def test_training_spans_two_processes(ranks, agg_mode):
    _, outs = ranks
    results = [o[agg_mode] for o in outs]
    # the merged model is replicated: both processes hold it bit for bit
    assert results[0]["weights"] == results[1]["weights"]
    assert results[0]["bias"] == results[1]["bias"]
    # it learned the separable direction (x0 decides the label)
    w = results[0]["weights"]
    assert w[0] > 3 * abs(w[1])
    for r in results:
        assert r["local_accuracy"] >= 0.85
        assert r["n_stations"] == 2
    if agg_mode == "scattered":  # the same mean, another summation order
        ref = outs[0]["replicated"]
        np.testing.assert_allclose(w, ref["weights"], rtol=F32_RTOL,
                                   atol=1e-7)
