"""The PyTorch port stands alone: it imports neither ``jax``, the JAX
package, ``pandas`` nor ``yaml`` (the card's machine has none of them),
and its entry points do not fall back to the CPU."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_without_jax():
    """In a fresh interpreter with ``jax``, ``pandas`` and ``yaml`` blocked,
    every module of the port and ``chip_smoke.py`` import, and no
    ``vantage6_tpu`` module is loaded."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["pandas"] = None
        sys.modules["yaml"] = None
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
    # the analysis programs' 6, parallel/ and common/ (5), and the task
    # plane's 19 (algorithm/ 6, runtime/ 7, common/ 3, config, guards,
    # average)
    assert int(res.stdout.strip().splitlines()[-1]) >= 47


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


def test_task_plane_without_cuda_requires_explicit_cpu(monkeypatch):
    """``federation_from_datasets``/``MockAlgorithmClient`` without
    ``device=`` raise when no CUDA is present; with ``device="cpu"`` the
    stations' device-mode partials run on the CPU."""
    import numpy as np

    from vantage6_tpu_torch.algorithm import MockAlgorithmClient
    from vantage6_tpu_torch.runtime.federation import federation_from_datasets
    from vantage6_tpu_torch.workloads import average

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = [{"x": np.ones((3, 2), np.float32)}] * 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        federation_from_datasets(data, {"mock": average})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MockAlgorithmClient(datasets=[[{"database": d}] for d in data],
                            module=average)
    client = MockAlgorithmClient(datasets=[[{"database": d}] for d in data],
                                 module=average, device="cpu")
    assert client.device.type == "cpu"
    task = client.task.create(
        input_={"method": "central_average_device",
                "kwargs": {"column_index": 0}}, organizations=[0])
    assert client.result.get(task["id"]) == [{"average": 1.0, "count": 6}]
    stacked = client.federation.stacked_data()
    assert stacked["x"].device.type == "cpu"
