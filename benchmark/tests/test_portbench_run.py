"""``run.py``'s whole flow at a tiny size on the CPU, the look for a card
replaced: a well-formed last line, correct for the program as it is, each
compared number beside its limit as the last lines of standard error,
``correct`` false when the control stands in the program's place or when a
fault is planted in the program, and no result without a card or without
the program.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import cpu_checkout  # noqa: E402

CELLS = list(cpu_checkout.TINY)
FAULTS = ("state_unchanged", "half_batch", "no_exchange", "leaf_skipped")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return cpu_checkout.make_checkout(tmp_path_factory.mktemp("checkout"))


def _expected(root, cell, trace):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return {m["name"] for m in e2e}
    names = {m["name"] for m in e2e}
    return {m["name"] for m in spec["per_layer"]
            if m["moves"] in names and cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line_is_well_formed(checkout, cell, trace):
    proc = cpu_checkout.run_cell(checkout, cell, trace=trace)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = cpu_checkout.result_line(proc)
    keys = list(line)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"]["count"] == 1
    assert "memory_peak_bytes" in line["device"]
    for name, metric in line["metrics"].items():
        assert isinstance(metric["value"], float) and metric["unit"]
    expected = _expected(checkout, cell, trace)
    if trace:
        # the CPU is no card of the table of peaks: the shares of a peak
        # read nothing, and no device activity is traced
        assert set(line["metrics"]) == {"device_idle_pct"} <= expected
        assert line["metrics"]["device_idle_pct"]["value"] == 100.0
        assert line["device"]["busy_s"] == 0.0
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == expected
    checks = line["checks"]
    limits = json.loads((checkout / "benchmark" / "workloads"
                         / f"{cell}.json").read_text())["limits"]
    assert list(checks) == list(limits)
    assert all(item["limit"] == limits[name] for name, item in checks.items())
    tail = proc.stderr.strip().splitlines()[-len(checks):]
    for (name, item), text in zip(checks.items(), tail):
        assert text == f"check: {name} {item['value']!r} limit " \
                       f"{item['limit']!r}"


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_program_is_not_correct(checkout, cell, fault):
    proc = cpu_checkout.run_cell(checkout, cell, fault=fault, seconds=0.05)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = cpu_checkout.result_line(proc)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_fp8_control_is_not_correct(checkout, cell, seed):
    proc = cpu_checkout.run_cell(checkout, cell, control=True, seed=seed,
                                 seconds=0.05)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert cpu_checkout.result_line(proc)["correct"] is False


def _bare_run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "gpt2-medium.ctx1024", "--seed", "2147483659", "--seconds", "1"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    """Without CUDA the run must fail and print nothing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _bare_run(cpu_checkout.REPO)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no run:" in proc.stderr


def test_no_result_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copy(cpu_checkout.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(cpu_checkout.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _bare_run(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "vantage6_tpu_torch" in proc.stderr
