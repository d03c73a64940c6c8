"""The port's secure-average workloads and preprocessing against the JAX
package's, on the CPU.

The first part is ``tests/test_secure_average.py``,
``test_host_executor.py``'s three secure-average cases under the executor
pool, ``test_bonawitz_taskplane.py``'s case on the Federation runtime and
``test_preprocess.py::TestPipeline``, with their imports switched to the
port (the port's Federation on ``device="cpu"``; DataFrames as the
reference's cases, dicts of numpy columns where noted). The cross-package
cases run
``apply_pipeline`` on the same frame through both packages (equal frames
out); the secure averages' are in ``test_torch_secure_average_parity.py``.
"""
import importlib
import secrets
import sys

import numpy as np
import pandas as pd
import pytest

from vantage6_tpu_torch import native
from vantage6_tpu_torch.runtime.federation import federation_from_datasets
from vantage6_tpu_torch.workloads import preprocess, secure_average
from vantage6_tpu_torch.workloads.preprocess import apply_pipeline

JPRE = importlib.import_module("vantage6_tpu.workloads.preprocess")


@pytest.fixture()
def frames():
    rng = np.random.default_rng(11)
    return [
        pd.DataFrame({"age": rng.normal(45 + 5 * i, 6, 80)}) for i in range(3)
    ]


# ---------------------------------------- tests/test_secure_average.py
def test_secure_average_federation(frames):
    fed = federation_from_datasets(
        frames, {"v6-secure-average": secure_average}, device="cpu"
    )
    seed = secrets.token_bytes(32).hex()
    task = fed.create_task(
        "v6-secure-average",
        {
            "method": "central_secure_average",
            # max_abs bounds |sum| per party; 2^16 here -> scale ~5461
            "kwargs": {"column": "age", "seed_hex": seed, "max_abs": 2.0**16},
        },
        organizations=[0],
    )
    out = fed.wait_for_results(task.id)[0]
    pooled = pd.concat(frames)["age"]
    assert out["count"] == len(pooled)
    assert abs(out["average"] - pooled.mean()) < 1e-3  # quantization only

    # privacy invariant: every partial's stored result is masked — it must
    # not resemble the quantized plaintext
    scale = 2.0**30 / (3 * 2.0**16)
    for t in fed.tasks.values():
        if t.method != "partial_secure_average":
            continue
        for run in t.runs:
            idx = run.result["party_index"]
            plain = np.asarray(
                [frames[idx]["age"].sum(), len(frames[idx])], np.float32
            )
            q = native.quantize(plain, scale)
            assert not np.array_equal(np.asarray(run.result["masked"]), q)
    fed.close()


def test_large_sums_do_not_wrap(frames):
    """The derived scale keeps big aggregates inside int32 (no silent
    wrap)."""
    rng = np.random.default_rng(3)
    big = [
        pd.DataFrame({"income": rng.lognormal(10, 0.4, 100)}) for _ in range(3)
    ]
    fed = federation_from_datasets(
        big, {"v6-secure-average": secure_average}, device="cpu")
    task = fed.create_task(
        "v6-secure-average",
        {
            "method": "central_secure_average",
            "kwargs": {"column": "income", "seed_hex": "ab" * 32},
        },
        organizations=[0],
    )
    out = fed.wait_for_results(task.id)[0]
    pooled = pd.concat(big)["income"]
    assert out["count"] == 300
    assert abs(out["average"] - pooled.mean()) / pooled.mean() < 1e-3
    fed.close()


def test_secure_average_rejects_single_party(frames):
    fed = federation_from_datasets(
        frames[:1] * 2, {"v6-secure-average": secure_average}, device="cpu"
    )
    task = fed.create_task(
        "v6-secure-average",
        {
            "method": "central_secure_average",
            "kwargs": {
                "column": "age",
                "seed_hex": "00" * 32,
                "organizations": [0],
            },
        },
        organizations=[0],
    )
    with pytest.raises(RuntimeError, match="2 parties"):
        fed.wait_for_results(task.id)
    fed.close()


# ------------------ test_host_executor.py's secure averages, under the pool
def test_bonawitz_e2e_under_pool():
    """The four-round Bonawitz secure average — DH keygen, Shamir shares,
    double-masked uploads, reveal — behaves identically with a parallel
    executor pool (the protocol is pure nested task fan-out)."""
    pytest.importorskip("cryptography")
    rng = np.random.default_rng(7)
    frames = [
        pd.DataFrame({"age": rng.normal(45 + 3 * i, 5, 40)}) for i in range(3)
    ]
    fed = federation_from_datasets(
        frames, {"v6-secure-average": secure_average}, executor_workers=3,
        device="cpu"
    )
    task = fed.create_task(
        "v6-secure-average",
        {
            "method": "central_secure_average_bonawitz",
            "kwargs": {"column": "age", "max_abs": 2.0**16,
                       "poll_interval": 0.02},
        },
        organizations=[0],
    )
    out = fed.wait_for_results(task.id)[0]
    pooled = pd.concat(frames)["age"]
    assert out["count"] == len(pooled)
    assert abs(out["average"] - pooled.mean()) < 1e-2
    assert out["dropped"] == []
    fed.close()


def test_secure_average_seeded_under_pool():
    """The single-seed masked-sum variant: nested parallel fan-out under
    the pool must unmask to the exact pooled mean."""
    rng = np.random.default_rng(3)
    frames = [
        pd.DataFrame({"age": rng.normal(50 + 2 * i, 4, 50)}) for i in range(3)
    ]
    fed = federation_from_datasets(
        frames, {"img": secure_average}, executor_workers=3, device="cpu"
    )
    task = fed.create_task(
        "img",
        {
            "method": "central_secure_average",
            "kwargs": {"column": "age", "seed_hex": "ab" * 32,
                       "max_abs": 2.0**16},
        },
        organizations=[0],
    )
    out = fed.wait_for_results(task.id)[0]
    pooled = pd.concat(frames)["age"]
    assert out["count"] == len(pooled)
    assert abs(out["average"] - pooled.mean()) < 1e-3
    fed.close()


def test_secure_average_dh_parallel_parity():
    """DH variant: pooled parallel fan-out must produce the same average
    as the synchronous path."""
    pytest.importorskip("cryptography")
    rng = np.random.default_rng(13)
    frames = [
        pd.DataFrame({"v": rng.normal(10 * i, 2, 30)}) for i in range(3)
    ]

    def run(workers):
        fed = federation_from_datasets(
            frames, {"img": secure_average}, executor_workers=workers,
            device="cpu"
        )
        task = fed.create_task(
            "img",
            {
                "method": "central_secure_average_dh",
                "kwargs": {"column": "v", "max_abs": 2.0**16},
            },
            organizations=[0],
        )
        out = fed.wait_for_results(task.id)[0]
        fed.close()
        return out

    seq, par = run(0), run(3)
    assert seq["count"] == par["count"] == 90
    assert abs(seq["average"] - par["average"]) < 1e-6


# --------- test_bonawitz_taskplane.py::test_central_bonawitz_on_federation_runtime
def test_central_bonawitz_on_federation_runtime():
    """The same central must also run on the in-process Federation runtime
    (its AlgorithmClient accepts interval/timeout for signature
    compatibility even though nothing polls there)."""
    pytest.importorskip("cryptography")
    rng = np.random.default_rng(5)
    frames = [
        pd.DataFrame({"age": rng.normal(45 + 3 * i, 5, 50)}) for i in range(3)
    ]
    fed = federation_from_datasets(
        frames, {"v6-secure-average": secure_average}, device="cpu")
    task = fed.create_task(
        "v6-secure-average",
        {
            "method": "central_secure_average_bonawitz",
            "kwargs": {"column": "age", "max_abs": 2.0**16},
        },
        organizations=[0],
    )
    out = fed.wait_for_results(task.id)[0]
    fed.close()
    pooled = pd.concat(frames)["age"]
    assert out["count"] == len(pooled)
    assert abs(out["average"] - pooled.mean()) < 1e-2
    assert out["dropped"] == []


# ------------------------------------- test_preprocess.py::TestPipeline
class TestPipeline:
    def _df(self):
        return pd.DataFrame({
            "age": [30.0, 45.0, 60.0, np.nan],
            "weight_kg": [70.0, 80.0, 90.0, 100.0],
            "height_m": [1.6, 1.8, 1.75, 1.7],
        })

    def test_ops_compose(self):
        out = apply_pipeline(self._df(), [
            {"op": "dropna", "columns": ["age"]},
            {"op": "filter", "column": "age", "cmp": "ge", "value": 40},
            {"op": "derive", "column": "bmi",
             "expr": {"op": "div", "args": ["weight_kg", "height_m"]}},
            {"op": "derive", "column": "bmi",
             "expr": {"op": "div", "args": ["bmi", "height_m"]}},
            {"op": "rename", "mapping": {"weight_kg": "weight"}},
            {"op": "select", "columns": ["age", "weight", "bmi"]},
            {"op": "clip", "column": "age", "upper": 50},
        ])
        assert list(out.columns) == ["age", "weight", "bmi"]
        assert out["age"].tolist() == [45.0, 50.0]
        np.testing.assert_allclose(
            out["bmi"], [80 / 1.8**2, 90 / 1.75**2]
        )

    def test_astype_and_literals(self):
        out = apply_pipeline(self._df(), [
            {"op": "derive", "column": "age2",
             "expr": {"op": "mul", "args": ["age", 2]}},
            {"op": "dropna", "columns": ["age2"]},
            {"op": "astype", "column": "age2", "dtype": "int"},
        ])
        assert out["age2"].tolist() == [60, 90, 120]

    @pytest.mark.parametrize("steps,msg", [
        ([{"op": "teleport"}], "unknown op"),
        ([{"op": "select", "columns": ["nope"]}], "unknown columns"),
        ([{"op": "filter", "column": "age", "cmp": "??", "value": 1}],
         "unknown cmp"),
        ([{"op": "derive", "column": "x",
           "expr": {"op": "add", "args": ["age", True]}}], "operand"),
        ([{"op": "filter", "column": "age"}], "missing field"),
        # a typo'd COLUMN must say so, not claim a step field is missing
        ([{"op": "filter", "column": "agee", "cmp": "ge", "value": 1}],
         "unknown columns"),
        ([{"op": "clip", "column": "agee", "upper": 1}], "unknown columns"),
        ([{"op": "dropna", "columns": ["agee"]}], "unknown columns"),
        ([{"op": "astype", "column": "agee", "dtype": "int"}],
         "unknown columns"),
    ])
    def test_bad_pipelines_fail_loudly(self, steps, msg):
        with pytest.raises(ValueError, match=msg):
            apply_pipeline(self._df(), steps)

    def test_all_nan_column_summary_is_json_safe(self):
        import json

        df = pd.DataFrame({"x": [np.nan, np.nan]})
        out = preprocess.column_summary.plain(df)
        assert out["x"]["mean"] is None  # not NaN: strict JSON must parse
        json.loads(json.dumps(out, allow_nan=False))

    def test_no_code_execution_surface(self):
        # the language is data-only: strings are column names, never code
        with pytest.raises(ValueError):
            apply_pipeline(self._df(), [
                {"op": "derive", "column": "x",
                 "expr": {"op": "add",
                          "args": ["__import__('os').system('id')", 1]}},
            ])


# ------------------------------------------------------ cross-package
PIPELINE = [
    {"op": "dropna", "columns": ["age"]},
    {"op": "filter", "column": "age", "cmp": "gt", "value": 35},
    {"op": "derive", "column": "bmi",
     "expr": {"op": "div", "args": ["weight_kg", "height_m"]}},
    {"op": "derive", "column": "bmi",
     "expr": {"op": "div", "args": ["bmi", "height_m"]}},
    {"op": "clip", "column": "bmi", "lower": 18.5, "upper": 30},
    {"op": "rename", "mapping": {"weight_kg": "weight"}},
    {"op": "derive", "column": "decade",
     "expr": {"op": "div", "args": ["age", 10]}},
    {"op": "astype", "column": "decade", "dtype": "int"},
    {"op": "select", "columns": ["age", "weight", "bmi", "decade"]},
]


def _station_columns(seed=5, n=60):
    rng = np.random.default_rng(seed)
    age = rng.uniform(18, 90, n).round(1)
    age[rng.choice(n, 5, replace=False)] = np.nan
    return {"age": age, "weight_kg": rng.uniform(45, 120, n).round(1),
            "height_m": rng.uniform(1.45, 2.0, n).round(2)}


class TestPreprocessAgainstJax:
    def test_apply_pipeline_equal_frames(self):
        cols = _station_columns()
        ours = apply_pipeline(pd.DataFrame(cols), PIPELINE)
        theirs = JPRE.apply_pipeline(pd.DataFrame(cols), PIPELINE)
        pd.testing.assert_frame_equal(ours, theirs, check_exact=True)
        # a station frame that is a dict of columns gives the same frame
        pd.testing.assert_frame_equal(apply_pipeline(cols, PIPELINE), theirs,
                                      check_exact=True)
        assert (preprocess.column_summary.plain(ours)
                == JPRE.column_summary.plain(theirs))

    def test_preprocess_task_through_the_federation(self):
        stations = [_station_columns(seed=s) for s in (1, 2)]
        fed = federation_from_datasets(stations, {"pre": preprocess},
                                       device="cpu")
        try:
            task = fed.create_task("pre", {"method": "preprocess",
                                           "kwargs": {"steps": PIPELINE}})
            outs = fed.wait_for_results(task.id)
        finally:
            fed.close()
        for cols, out in zip(stations, outs):
            pd.testing.assert_frame_equal(
                out, JPRE.apply_pipeline(pd.DataFrame(cols), PIPELINE),
                check_exact=True)

    def test_missing_pandas_is_named(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "pandas", None)
        with pytest.raises(RuntimeError, match="pandas"):
            apply_pipeline(_station_columns(), PIPELINE)
        with pytest.raises(RuntimeError, match="pandas"):
            preprocess.column_summary.plain(_station_columns())
