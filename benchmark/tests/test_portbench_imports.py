"""Nothing a run loads is JAX or the JAX package; the references load
nothing of the program.

Module names are compared by their top-level name (the part before the
first dot) whole: the program, ``vantage6_tpu_torch``, begins with the JAX
package's name, ``vantage6_tpu``, and must not be taken for it.
"""
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vantage6_tpu"}

LOAD_RUN_PATH = f"""
import json, sys
sys.path.insert(0, {str(BENCH)!r})
import run as R
R.set_caches()
R.import_program()
from portbench import cells
for cell in json.load(open(R.ROOT / "BENCHMARK.json"))["workloads"]:
    c = cells.resolve(cell["name"])
    cells.driver(c)
    cells.flops(c)
    for m in c.end_to_end:
        cells.reader("end_to_end", m["name"])
    for m in c.per_layer:
        cells.reader("layer_metrics", m["name"])
import vantage6_tpu_torch.workloads.fed_transformer
import vantage6_tpu_torch.workloads.fedavg_mnist
import vantage6_tpu_torch.fed.compression
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = f"""
import json, sys
sys.path.insert(0, {str(BENCH)!r})
import reference.cnn, reference.precision, reference.transformer
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _tops(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_path_loads_no_jax():
    tops = _tops(LOAD_RUN_PATH)
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    # the program is loaded, and its name is not mistaken for the JAX one
    assert "vantage6_tpu_torch" in tops


def test_references_load_nothing_of_the_program():
    tops = _tops(LOAD_REFERENCE)
    assert not tops & (FORBIDDEN | {"vantage6_tpu_torch", "portbench"})
    assert "torch" in tops
