"""The moonlight-16b-a3b cell: its files found by name, added as new files
only, and its check at a size the CPU runs (``cpu_checkout.py``'s tiny
checkout with a tiny cell of this configuration): the program reads
``correct: true``, the float8 control and each of the driver's six faults
``false``.

The tiny cell's limits are its own, set as the real cell's are, from
readings at its size (the CPU's bf16 program over eight seeds, 11-18; the
control and each fault over three, 21-23). The program read at most
first_loss_gap 2.1e-5, grad_gap 2.3e-2, grad_diff_gap 9.6e-3 and
change_gap 1.2e-2; the control grad_diff_gap 0.167 at least (its other
numbers no more than 2.6 times the program's); half of each batch and the
aggregation left out grad_gap 0.51 and grad_diff_gap 0.90 at least; the
state unchanged, one leaf's update left out and one held expert's slots
dropped change_gap 1.0; the bias left out of the choice grad_gap 0.72 at
least. Each limit lies between the program's reading and the least
reading that fails, with more room above the program's.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import cpu_checkout  # noqa: E402
from portbench import cells  # noqa: E402

CELL = "moonlight-16b-a3b.ctx2048"
TINY_CELL = "moonlight-tiny.ctx32"
METRICS = ["moe_route_ms", "moe_experts_ms", "experts_roofline_pct",
           "mla_attn_fwd_roofline_pct", "mla_attn_bwd_roofline_pct"]
FAULTS = ("state_unchanged", "half_batch", "no_exchange", "leaf_skipped",
          "expert_dropped", "bias_ignored")
TINY_LIMITS = {"first_loss_gap": 1e-4, "grad_gap": 0.1,
               "grad_diff_gap": 0.05, "change_gap": 0.2}
TINY = (CELL, {
    "model": {"vocab": 512, "d_model": 64, "n_heads": 4, "qk_nope_dim": 16,
              "qk_rope_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
              "n_layers": 3, "first_k_dense": 1, "dense_inter": 128,
              "moe_inter": 32, "n_experts": 8, "top_k": 3, "n_shared": 1,
              "held_experts": [0, 1, 2, 3], "max_len": 64},
    "federation": {"stations": 2},
}, {"batch": 4, "seq_len": 32, "limits": TINY_LIMITS})


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    cpu_checkout.TINY[TINY_CELL] = TINY
    try:
        yield cpu_checkout.make_checkout(tmp_path_factory.mktemp("mla"),
                                         [TINY_CELL])
    finally:
        del cpu_checkout.TINY[TINY_CELL]


def test_cell_config_driver_flops_and_readers_resolve_by_name():
    cell = cells.resolve(CELL)
    assert cell.config["driver"] == "fed_mla_moe"
    driver = cells.driver(cell)
    assert set(driver.FAULTS) == set(FAULTS)
    flops = cells.flops(cell)
    for fn in ("round_flops", "attention_fwd", "attention_bwd",
               "held_experts"):
        assert callable(getattr(flops, fn))
    assert [m["name"] for m in cell.per_layer][-5:] == METRICS
    for name in METRICS:
        assert callable(cells.reader("layer_metrics", name).read)
    assert {m["name"] for m in cell.end_to_end} == {
        "round_ms", "peak_mem_gib", "setup_s"}


def test_the_configuration_is_the_catalog_entry_cut_by_reduced():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"]
                 if c["name"] == "moonlight-16b-a3b")
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["source"] == entry["source"]
    published = config["published"]
    for key, value in published.items():
        if key in entry["reduced"]:
            assert config[key] == config["reduced"][key]["here"]
            assert config["reduced"][key]["published"] == value
        else:
            assert config[key] == value, key
    m = config["model"]
    assert (m["d_model"], m["qk_nope_dim"], m["qk_rope_dim"],
            m["v_head_dim"], m["kv_lora_rank"], m["moe_inter"],
            m["dense_inter"], m["n_experts"], m["top_k"]) == (
        published["hidden_size"], published["qk_nope_head_dim"],
        published["qk_rope_head_dim"], published["v_head_dim"],
        published["kv_lora_rank"], published["moe_intermediate_size"],
        published["intermediate_size"], published["n_routed_experts"],
        published["num_experts_per_tok"])
    assert len(m["held_experts"]) == config["n_routed_experts"]
    assert m["n_layers"] == config["num_hidden_layers"]
    assert m["vocab"] == config["vocab_size"]


def test_no_existing_benchmark_file_is_edited():
    """The cell's files are new; the files of the parent's benchmark it
    reads (portbench, run.py, the readers of the accepted metrics) are
    untouched by it: every file it adds is named after the cell, its
    configuration, its driver or one of its new metrics."""
    ours = {"configs/moonlight-16b-a3b.json",
            "workloads/moonlight-16b-a3b.ctx2048.json",
            "drivers/fed_mla_moe.py", "flops/moonlight-16b-a3b.py",
            "reference/mla_moe.py", "tests/test_portbench_mla_moe.py"}
    ours |= {f"layer_metrics/{m}.py" for m in METRICS}
    for rel in ours:
        assert (BENCH / rel).is_file(), rel


def test_the_program_reads_correct(checkout):
    proc = cpu_checkout.run_cell(checkout, TINY_CELL)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = cpu_checkout.result_line(proc)
    assert line["correct"] is True, line["checks"]
    assert "route_flip_share" in proc.stderr


def test_traced_run_reports_what_the_cpu_can(checkout):
    proc = cpu_checkout.run_cell(checkout, TINY_CELL, trace=1)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = cpu_checkout.result_line(proc)
    assert line["correct"] is True, line["checks"]
    # the CPU is no card of the table of peaks and traces no device
    # activity: every new metric reads nothing, and none raises
    assert set(line["metrics"]) == {"device_idle_pct"}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_is_not_correct(checkout, fault):
    proc = cpu_checkout.run_cell(checkout, TINY_CELL, fault=fault)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert cpu_checkout.result_line(proc)["correct"] is False


def test_the_fp8_control_is_not_correct(checkout):
    proc = cpu_checkout.run_cell(checkout, TINY_CELL, control=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert cpu_checkout.result_line(proc)["correct"] is False


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, 'benchmark'); "
            "import reference.mla_moe; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"vantage6_tpu_torch", "vantage6_tpu", "jax",
                       "portbench"}
    assert "torch" in tops
