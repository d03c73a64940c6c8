"""Everything of a cell, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics. Each has files of its own under ``benchmark/``:

- ``workloads/<cell>.json``: the cell's traffic parameters and the limits
  of the numbers its check compares;
- ``configs/<config>.json``: the configuration as it is run, with the name
  of its driver;
- ``drivers/<driver>.py``: the entry point the window drives;
- ``flops/<config>.py``: the operations and bytes of its work;
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: one reader
  a metric.

So a cell, a configuration or a metric is added as new files and an entry
in ``BENCHMARK.json``, with no edit to a file that is there.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict[str, Any]   # configs/<config>.json
    traffic: dict[str, Any]  # workloads/<cell>.json
    end_to_end: list[dict[str, Any]]  # the metrics this cell reports
    per_layer: list[dict[str, Any]]

    @property
    def limits(self) -> dict[str, float]:
        return self.traffic["limits"]


def load_json(path: Path) -> Any:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path) -> ModuleType:
    """The Python file at ``path`` as a module named after its place under
    ``benchmark/`` (file names may hold ``-`` and ``.``)."""
    rel = path.resolve().relative_to(BENCH_DIR).with_suffix("")
    name = "portbench_files." + ".".join(rel.parts).replace("-", "_")
    module = sys.modules.get(name)
    if module is not None:
        return module
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _reports(metric: dict[str, Any], cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in end_to_end}
    # a per-layer metric without a list of cells is read wherever the
    # end-to-end metric it moves is reported
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in reported and _reports(m, name)]
    traffic = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    if traffic.get("config") != entry["config"]:
        raise ValueError(f"workloads/{name}.json names config "
                         f"{traffic.get('config')!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    return Cell(name=name, chips=int(entry["chips"]),
                config_name=entry["config"],
                config=load_json(root / conf["file"]), traffic=traffic,
                end_to_end=end_to_end, per_layer=per_layer)


def driver(cell: Cell) -> ModuleType:
    return load_module(BENCH_DIR / "drivers" / f"{cell.config['driver']}.py")


def flops(cell: Cell) -> ModuleType:
    return load_module(BENCH_DIR / "flops" / f"{cell.config_name}.py")


def reader(kind: str, metric: str) -> ModuleType:
    """The reader of ``metric``: ``kind`` is ``end_to_end`` or
    ``layer_metrics``."""
    return load_module(BENCH_DIR / kind / f"{metric}.py")


def peaks(kind: str) -> dict[str, float] | None:
    """The published peaks of the card named ``kind``, or None for a card
    the table lacks."""
    return load_json(BENCH_DIR / "peaks.json").get(kind)
