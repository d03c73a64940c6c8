"""A tiny checkout of the benchmark, run on the CPU, for the tests.

``make_checkout`` copies ``benchmark/`` into a directory, links the
program's package beside it, and writes a ``BENCHMARK.json`` whose cells
are the real ones cut to a size the CPU runs in seconds: the same drivers,
traffic kinds and limits, with fewer stations, layers, rows and steps.
``run_cell`` runs ``run.py``'s whole flow there in a child process, the
look for a card replaced by the CPU, optionally with one of a driver's
faults planted in the program or with the float8 reference put in the
program's place (the control).

The tiny cells' limits are their own, set as the real cells' were from
readings at their size (the CPU's bf16 program over eight seeds, the
control and each fault over three; 11-18 and 21-23): gpt2-tiny program
grad_gap at most 1.23e-3, grad_diff_gap 6.8e-3 and change_gap 8.9e-4, the
control at least 1.70e-2, 0.131 and 3.6e-3, half of each batch 0.98 on
grad_diff_gap; cnn-tiny program station_gap at most 7.5e-3 and
grad_gap and change_gap 2.4e-2, the control's station_gap at least
2.7e-2, every fault reading 1.0 on a norm gap or 7e-2 on station_gap.
"""
from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

# the real cell each tiny cell stands for, and what is cut
CNN_TINY_LIMITS = {"grad_gap": 0.2, "change_gap": 0.2, "station_gap": 0.014}
TINY = {
    "gpt2-tiny.ctx32": ("gpt2-medium.ctx1024", {
        "model": {"n_embd": 64, "n_layer": 2, "n_head": 4, "n_inner": 256,
                  "n_positions": 64, "vocab_size": 512},
        "federation": {"stations": 2},
    }, {"batch": 4, "seq_len": 32,
        "limits": {"grad_gap": 0.005, "grad_diff_gap": 0.03,
                   "change_gap": 0.0025}}),
    "cnn-tiny.dense": ("cnn-flagship.dense", {
        "federation": {"stations": 4, "per_station": 16, "local_steps": 2,
                       "batch": 4},
    }, {"limits": CNN_TINY_LIMITS}),
    "cnn-tiny.topk-int8": ("cnn-flagship.topk-int8", {
        "federation": {"stations": 4, "per_station": 16, "local_steps": 2,
                       "batch": 4},
    }, {"limits": CNN_TINY_LIMITS}),
}

RUNNER = """
import sys

bench, fault, control = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
sys.path.insert(0, bench)
import run as R

R.set_caches()
R.import_program()
import torch
from portbench import cells


class CpuCard:
    device = torch.device("cpu")

    def available(self, chips):
        return None

    def sync(self):
        pass

    def reset_peak(self):
        pass

    def peak(self):
        return 0

    def describe(self):
        return {"platform": "cpu", "kind": "cpu", "count": 1}


args = R.parse_args(sys.argv[4:])
driver = cells.driver(cells.resolve(args.workload))
if fault != "-":
    build = driver.Driver.build

    def planted(self):
        build(self)
        driver.FAULTS[fault](self)

    driver.Driver.build = planted
if control:
    steps = driver.Driver.check_steps

    def control_steps(self):
        steps(self)
        self.snapshot = self.reference("fp8")

    driver.Driver.check_steps = control_steps
sys.exit(R.run(args, CpuCard()))
"""


def _merge(base: dict, cut: dict) -> dict:
    out = copy.deepcopy(base)
    for key, value in cut.items():
        if isinstance(value, dict) and key != "limits":
            out[key] = _merge(out.get(key, {}), value)
        else:
            out[key] = value
    return out


def make_checkout(root: Path, cells: list[str] | None = None) -> Path:
    """A checkout at ``root`` holding the tiny cells ``cells`` (all by
    default). Returns ``root``."""
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(REPO / "vantage6_tpu_torch", root / "vantage6_tpu_torch")
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = dict(real, configs=[], workloads=[])
    for name in cells or list(TINY):
        stands_for, config_cut, traffic_cut = TINY[name]
        entry = next(w for w in real["workloads"] if w["name"] == stands_for)
        conf_entry = next(c for c in real["configs"]
                          if c["name"] == entry["config"])
        config_name = name.split(".")[0]
        config = _merge(json.loads((REPO / conf_entry["file"]).read_text()),
                        config_cut)
        path = f"benchmark/configs/{config_name}.json"
        (root / path).write_text(json.dumps(config))
        flops = root / "benchmark" / "flops"
        shutil.copy(flops / f"{entry['config']}.py",
                    flops / f"{config_name}.py")
        traffic = _merge(json.loads(
            (BENCH / "workloads" / f"{stands_for}.json").read_text()),
            dict(traffic_cut, config=config_name))
        (root / "benchmark" / "workloads" / f"{name}.json").write_text(
            json.dumps(traffic))
        if config_name not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append(dict(conf_entry, name=config_name,
                                         file=path))
        bench["workloads"].append(dict(entry, name=name, config=config_name))
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = [
                name for name in cells or list(TINY)
                if TINY[name][0] in metric["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (root / "benchmark" / "cpu_run.py").write_text(RUNNER)
    return root


def run_cell(root: Path, cell: str, seed: int = 3, seconds: float = 0.2,
             trace: int = 0, fault: str = "-", control: bool = False,
             timeout: float = 600) -> subprocess.CompletedProcess:
    """``run.py``'s flow for ``cell`` in the checkout at ``root``, on the
    CPU, in a child process started from ``root``."""
    env = dict(os.environ, OMP_NUM_THREADS="2", TMPDIR=str(root))
    cmd = [sys.executable, "benchmark/cpu_run.py", str(root / "benchmark"),
           fault, "1" if control else "0", "--workload", cell,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    return subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)


def result_line(proc: subprocess.CompletedProcess) -> dict:
    return json.loads(proc.stdout.strip().splitlines()[-1])
