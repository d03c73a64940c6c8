#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this process sees.

    python3 benchmark/run.py --workload gpt2-medium.ctx1024 --seed 7 \\
        --seconds 10 --trace 0

From the root of a checkout. The cell, its configuration, its driver and
its metrics are found by name from ``BENCHMARK.json`` (see
``portbench/cells.py``). One run:

1. makes the cell's weights and traffic from ``--seed`` and builds the
   engine (``vantage6_tpu_torch``, from this checkout);
2. runs the check's first steps through the window's own call, which warms
   up every shape the window uses; ``setup_s`` ends here;
3. runs rounds for ``--seconds`` (closed loop: each round ends when its
   loss reaches the host); with ``--trace 1`` then a few rounds more under
   ``torch.profiler``, which the per-layer readers read;
4. frees the program's state and runs the plain reference over the same
   inputs as the first steps, and compares (``portbench/checks.py``);
5. prints each compared number beside its limit as the last lines of
   standard error, and one JSON object as the last line of standard output.

It exits non-zero, printing no result, without CUDA or with fewer cards
than the cell asks for, when the program is not in this checkout, and when
JAX or the JAX package has been loaded by the time the window closes.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(os.path.abspath(__file__)).parent
ROOT = BENCH.parent
PROGRAM = "vantage6_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "vantage6_tpu")
# build and kernel caches: fixed directories inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


class Card:
    """The CUDA card the run measures."""

    def __init__(self, index: int = 0):
        import torch

        self.torch = torch
        self.device = torch.device("cuda", index)
        torch.cuda.set_device(self.device)

    def available(self, chips: int) -> str | None:
        """Why the run cannot go on, or None."""
        torch = self.torch
        if not torch.cuda.is_available():
            return "torch.cuda.is_available() is false"
        count = torch.cuda.device_count()
        if count < chips:
            return (f"the cell asks for {chips} cards, "
                    f"torch.cuda.device_count() is {count}")
        return None

    def sync(self) -> None:
        self.torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        self.torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated(self.device))

    def describe(self) -> dict:
        return {"platform": "gpu",
                "kind": self.torch.cuda.get_device_name(self.device),
                "count": 1, "power_limit_w": power_limit()}


def power_limit() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_caches() -> None:
    for var, sub in CACHES.items():
        path = ROOT / "build" / "benchmark" / "cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def import_program():
    """The program from this checkout, or an error naming why not."""
    for path in (str(BENCH), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import importlib

    module = importlib.import_module(PROGRAM)
    # not resolved: a checkout may reach its package through a link
    where = Path(os.path.abspath(module.__file__))
    if ROOT not in where.parents:
        raise ImportError(f"{PROGRAM} loads from {where}, not from this "
                          f"checkout {ROOT}")
    return module


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def window(driver, seconds: float):
    """Rounds until ``seconds`` have passed: (latencies, window seconds,
    losses)."""
    latencies, losses = [], []
    t0 = time.perf_counter()
    while True:
        start = time.perf_counter()
        losses.append(driver.round())
        end = time.perf_counter()
        latencies.append(end - start)
        if end - t0 >= seconds:
            return latencies, end - t0, losses


def run(args, card: Card) -> int:
    from portbench import cells, checks, trace

    cell = cells.resolve(args.workload)
    why = card.available(cell.chips)
    if why is not None:
        print(f"no run: {why}", file=sys.stderr)
        return 2
    import torch

    driver = cells.driver(cell).Driver(cell, args.seed, card.device)
    t_driver = time.perf_counter()
    driver.setup()
    card.sync()
    setup_s = time.perf_counter() - T_START
    print(f"time: {t_driver - T_START:.3f} s to the driver (imports, the "
          f"card), {setup_s - (t_driver - T_START):.3f} s its set-up",
          file=sys.stderr)
    peak = card.peak()
    card.reset_peak()

    latencies, window_s, losses = window(driver, args.seconds)
    window_peak = card.peak()
    win = types.SimpleNamespace(latencies=latencies, window_s=window_s,
                                rounds=len(latencies), setup_s=setup_s,
                                peak_bytes=window_peak, config=cell.config,
                                traffic=cell.traffic)
    device = card.describe()
    metrics, breakdown = {}, None
    if args.trace:
        tr, traced = trace.traced_rounds(driver.round, card.sync)
        losses += traced
        ctx = types.SimpleNamespace(
            trace=tr, round_s=window_s / len(latencies), config=cell.config,
            traffic=cell.traffic, flops=cells.flops(cell),
            peak=cells.peaks(device["kind"]))
        for m in cell.per_layer:
            value = cells.reader("layer_metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_device_ops(),
                     "idle_gaps": tr.idle_gaps()}
    else:
        for m in cell.end_to_end:
            value = cells.reader("end_to_end", m["name"]).read(win)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device["memory_peak_bytes"] = max(peak, window_peak, card.peak())

    failed = sum(1 for x in losses if not math.isfinite(x))
    driver.release()
    gc.collect()
    numbers, error = {}, None
    t_check = time.perf_counter()
    try:
        numbers = checks.compare(driver.snapshot, driver.reference())
    except Exception:  # the run is then not correct; say why
        error = traceback.format_exc()
        print(error, file=sys.stderr)
    print(f"time: {time.perf_counter() - t_check:.3f} s the reference",
          file=sys.stderr)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        print(f"no result: {', '.join(found)} loaded in the process that "
              "measured", file=sys.stderr)
        return 3
    limits = cell.limits
    correct = (error is None and failed == 0 and bool(limits)
               and checks.judge(numbers, limits))
    shown = {name: {"value": numbers.get(name), "limit": limit}
             for name, limit in limits.items()}
    result = {"correct": correct, "attempted": len(losses), "failed": failed,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = shown
    sys.stdout.flush()
    if error is not None:
        print("check: the reference did not run (see above)", file=sys.stderr)
    for name in sorted(set(numbers) - set(limits)):
        print(f"reading (not compared): {name} {numbers[name]!r}",
              file=sys.stderr)
    print(f"check: non_finite_rounds {failed} limit 0", file=sys.stderr)
    for name, item in shown.items():
        print(f"check: {name} {item['value']!r} limit {item['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    set_caches()
    try:
        import_program()
    except ImportError as exc:
        print(f"no run: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no run: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    return run(args, Card())


if __name__ == "__main__":
    sys.exit(main())
