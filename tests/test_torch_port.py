"""The PyTorch port stands alone: it imports neither ``jax``, the JAX
package nor ``pandas`` (the card's machine has none), and its entry points
do not fall back to the CPU."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_without_jax():
    """In a fresh interpreter with ``jax`` and ``pandas`` blocked, every
    module of the port and ``chip_smoke.py`` import, and no ``vantage6_tpu``
    module is loaded."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["pandas"] = None
        sys.path.insert(0, sys.argv[1])
        import vantage6_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke  # noqa: F401
        leaked = sorted(m for m in sys.modules
                        if m == "vantage6_tpu" or m.startswith("vantage6_tpu."))
        assert not leaked, leaked
        print(len(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code, REPO], cwd=REPO,
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    # the transformer slice's 11 modules, FedAvg-CNN's 6, compression and
    # the analysis programs' 6, and parallel/ and common/ (5)
    assert int(res.stdout.strip().splitlines()[-1]) >= 28


def test_mesh_without_cuda_requires_explicit_cpu(monkeypatch):
    from vantage6_tpu_torch.core.mesh import FederationMesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederationMesh(4)
    assert FederationMesh(4, device="cpu").device.type == "cpu"


def test_fedavg_engine_without_cuda_requires_explicit_cpu(monkeypatch):
    from vantage6_tpu_torch._tree import tree_leaves
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        W.make_engine()
    eng = W.make_engine(n_stations=2, device="cpu")
    assert eng.device.type == "cpu" and eng.mesh.n_stations == 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        W.init_params(0)
    params = W.init_params(0, device="cpu")
    assert all(p.device.type == "cpu" for p in tree_leaves(params))


def test_analysis_entry_points_without_cuda_require_explicit_cpu(monkeypatch):
    from vantage6_tpu_torch.models import logistic

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        logistic.init_logistic(0, 3)
    params = logistic.init_logistic(0, 3, device="cpu")
    assert all(p.device.type == "cpu" for p in params.values())
