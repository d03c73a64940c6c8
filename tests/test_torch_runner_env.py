"""The port's sandbox ABI: what a sandboxed run's child process is given.

The reference's container policy pins a sandboxed algorithm to the CPU
unless the node's policies say ``accelerator: true``; the port hides the
card the same way (``CUDA_VISIBLE_DEVICES=""``). The child runs the port's
``algorithm/wrap.py`` and nothing of JAX: a real sandboxed
``partial_average`` round-trips a wire-v2 frame in a child whose ``jax``
import fails.
"""
import os
import subprocess

import numpy as np
import pandas as pd
import pytest

from vantage6_tpu_torch.common.serialization import (
    MAGIC_V2,
    deserialize,
    serialize,
)
from vantage6_tpu_torch.node import runner as runner_mod
from vantage6_tpu_torch.node.runner import RunSpec, TaskRunner

ALGO = {"avg": "vantage6_tpu_torch.workloads.average"}


def _spec(run_id=1):
    return RunSpec(run_id=run_id, task_id=1, image="avg",
                   method="partial_average",
                   input_payload={"method": "partial_average",
                                  "kwargs": {"column": "x"}})


def _capture_child(monkeypatch, tmp_path, policies):
    """Run one sandboxed run with ``subprocess.run`` replaced; return the
    child's argv and environment."""
    seen = {}

    def fake_run(cmd, env, **kw):
        seen["cmd"], seen["env"] = cmd, env
        with open(env["OUTPUT_FILE"], "wb") as f:
            f.write(serialize({"sum": 1.0, "count": 1}))
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(runner_mod.subprocess, "run", fake_run)
    runner = TaskRunner(algorithms=ALGO, mode="sandbox", work_dir=tmp_path,
                        policies=policies,
                        databases=[{"label": "default", "type": "csv",
                                    "uri": str(tmp_path / "d.csv")}])
    assert runner.run(_spec()) == {"sum": 1.0, "count": 1}
    return seen["cmd"], seen["env"]


def test_sandbox_hides_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    cmd, env = _capture_child(monkeypatch, tmp_path, {})
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    # the port pins the card, not JAX: JAX_PLATFORMS passes through as is
    assert env.get("JAX_PLATFORMS") == os.environ.get("JAX_PLATFORMS")
    assert "vantage6_tpu_torch.algorithm.wrap" in cmd[-1]
    assert "wrap_algorithm('vantage6_tpu_torch.workloads.average')" \
        in cmd[-1]


def test_accelerator_policy_keeps_the_card(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    _, env = _capture_child(monkeypatch, tmp_path, {"accelerator": True})
    assert env["CUDA_VISIBLE_DEVICES"] == "0"
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    _, env = _capture_child(monkeypatch, tmp_path / "b",
                            {"accelerator": True})
    assert "CUDA_VISIBLE_DEVICES" not in env


def test_sandboxed_run_without_jax(monkeypatch, tmp_path):
    """A real child process: ``jax`` is shadowed by a package that records
    any import attempt and fails it; the run still completes, its input
    file is a v2 frame and its result decodes."""
    shadow = tmp_path / "shadow" / "jax"
    shadow.mkdir(parents=True)
    marker = tmp_path / "jax_imported"
    (shadow / "__init__.py").write_text(
        f"open({str(marker)!r}, 'w').close()\n"
        "raise ImportError('jax is blocked in this child')\n")
    monkeypatch.setenv("PYTHONPATH", str(shadow.parent))
    rng = np.random.default_rng(0)
    df = pd.DataFrame({"x": rng.normal(3.0, 1.0, 257)})
    csv = tmp_path / "d.csv"
    df.to_csv(csv, index=False)
    work = tmp_path / "work"
    runner = TaskRunner(algorithms=ALGO, mode="sandbox", work_dir=work,
                        databases=[{"label": "default", "type": "csv",
                                    "uri": str(csv)}])
    out = runner.run(_spec(run_id=7))
    assert not marker.exists()
    run_dir = work / "run_7"
    blob = (run_dir / "input").read_bytes()
    assert blob.startswith(MAGIC_V2)
    assert deserialize(blob) == _spec().input_payload
    assert (run_dir / "output").read_bytes().startswith(MAGIC_V2)
    assert out["count"] == 257
    assert out["sum"] == pytest.approx(
        pd.read_csv(csv)["x"].sum(), rel=1e-12)
