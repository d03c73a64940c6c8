"""``BENCHMARK.json`` against the benchmark's contract, and every cell's
files found by name; a cell and a per-layer metric added as new files only.
"""
import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import cpu_checkout  # noqa: E402
from portbench import cells  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CELLS = [w["name"] for w in SPEC["workloads"]]
CHECKED = {"loss_gap", "first_loss_gap", "grad_gap", "tied_grad_gap",
           "grad_diff_gap", "change_gap", "station_gap"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_and_sizes():
    assert set(SPEC) == TOP_KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and \
        isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16
    for path in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path)
        assert ".." not in path.split("/") and not path.startswith("/")
    assert len(SPEC["command"]) <= 32 and all(_line(w)
                                              for w in SPEC["command"])
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")


def test_entries_keys_names_and_units():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for section, required in keys.items():
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names)), section
        for e in SPEC[section]:
            assert set(e) - {"workloads"} == required, (section, e["name"])
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    for c in SPEC["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = cells.resolve(name)
    assert cell.config["name"] == cell.config_name
    assert hasattr(cells.driver(cell), "Driver")
    assert callable(cells.flops(cell).round_flops)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end:
        assert callable(cells.reader("end_to_end", m["name"]).read)
    for m in cell.per_layer:
        assert callable(cells.reader("layer_metrics", m["name"]).read)
    assert cell.limits and set(cell.limits) <= CHECKED
    assert all(v > 0 for v in cell.limits.values())
    assert cells.load_json(BENCH / "workloads" / f"{name}.json")["why"] == \
        next(w for w in SPEC["workloads"] if w["name"] == name)["why"]


def test_cells_a_config_and_a_metric_are_added_as_new_files(tmp_path):
    """Throwaway additions, each as new files and entries in
    BENCHMARK.json, no existing file of the benchmark edited: a cell (a
    new traffic of an existing configuration), a configuration with its
    own cell, and a per-layer metric."""
    root = cpu_checkout.make_checkout(tmp_path, ["gpt2-tiny.ctx32"])
    bench = root / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    traffic = json.loads(
        (bench / "workloads/gpt2-tiny.ctx32.json").read_text())
    traffic.update(traffic="ctx16", seq_len=16, batch=2)
    (bench / "workloads/gpt2-tiny.ctx16.json").write_text(json.dumps(traffic))
    spec["workloads"].append(dict(spec["workloads"][0], name="gpt2-tiny.ctx16",
                                  traffic="ctx16"))
    config = json.loads((bench / "configs/gpt2-tiny.json").read_text())
    config["name"] = "gpt2-micro"
    config["model"].update(n_layer=1, n_head=2)
    (bench / "configs/gpt2-micro.json").write_text(json.dumps(config))
    (bench / "flops/gpt2-micro.py").write_text(
        (bench / "flops/gpt2-tiny.py").read_text())
    (bench / "workloads/gpt2-micro.ctx32.json").write_text(
        json.dumps(dict(traffic, config="gpt2-micro", traffic="ctx32",
                        seq_len=32)))
    spec["configs"].append(dict(spec["configs"][0], name="gpt2-micro",
                                file="benchmark/configs/gpt2-micro.json"))
    spec["workloads"].append(dict(spec["workloads"][0],
                                  name="gpt2-micro.ctx32",
                                  config="gpt2-micro", traffic="ctx32"))
    (bench / "layer_metrics/rounds_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.rounds)\n")
    spec["per_layer"].append({"name": "rounds_traced", "unit": "rounds",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "round_ms",
                              "workloads": ["gpt2-tiny.ctx16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for path, data in before.items():
        assert path.read_bytes() == data
    for cell, trace in (("gpt2-tiny.ctx16", 0), ("gpt2-tiny.ctx16", 1),
                        ("gpt2-micro.ctx32", 0)):
        proc = cpu_checkout.run_cell(root, cell, trace=trace)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = cpu_checkout.result_line(proc)
        if trace:
            assert line["metrics"]["rounds_traced"]["value"] >= 2
        else:
            assert set(line["metrics"]) == {"round_ms", "peak_mem_gib",
                                            "setup_s"}
