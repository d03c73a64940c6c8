"""The PyTorch port stands alone: it imports neither ``jax``, the JAX
package, ``pandas``, ``yaml``, ``requests``, ``cryptography``,
``websockets`` nor ``marshmallow`` at import time (none need be installed
where the port runs), and its entry points do not fall back to the CPU."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_without_jax():
    """In a fresh interpreter with ``jax``, the JAX package, ``pandas``,
    ``yaml``, ``requests``, ``cryptography``, ``websockets`` and
    ``marshmallow`` blocked, every module of the port and ``chip_smoke.py``
    import, a Federation with the autopilot enabled builds and closes on the
    CPU, the control plane's 27 modules are among them, and no
    ``vantage6_tpu`` module is loaded."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for blocked in ("jax", "vantage6_tpu", "pandas", "yaml", "requests",
                        "cryptography", "websockets", "marshmallow"):
            sys.modules[blocked] = None
        sys.path.insert(0, sys.argv[1])
        import vantage6_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke  # noqa: F401
        from vantage6_tpu_torch.core.config import FederationConfig
        from vantage6_tpu_torch.runtime.federation import Federation
        cfg = FederationConfig.from_dict({
            "federation": {"autopilot": {"enabled": True}},
            "stations": [{"name": "a"}, {"name": "b"}]})
        fed = Federation(cfg, device="cpu")
        assert fed.autopilot.actuator is fed
        fed.close()
        control_plane = [n for n in names if n.split(".")[1] in
                         ("server", "node", "client")
                         or n.endswith("algorithm.wrap")]
        assert len(control_plane) == 27, control_plane
        leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                        and (m == "vantage6_tpu"
                             or m.startswith("vantage6_tpu.")))
        assert not leaked, leaked
        print(len(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code, REPO], cwd=REPO,
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    # the transformer slice's 11 modules, FedAvg-CNN's 6, compression and
    # the analysis programs' 6, parallel/ and common/ (5), the task
    # plane's 19 (algorithm/ 6, runtime/ 7, common/ 3, config, guards,
    # average), the observed planes' 3, the parity ladder's 4, the
    # multi-process 2, the ops plane's 9 (common/ 7, runtime/ 2), and the
    # host crypto's 7 (native, common/ 4, secure_average, preprocess), and
    # the control plane's 27 (server/ 18, node/ 5, client/ 3, wrap)
    assert int(res.stdout.strip().splitlines()[-1]) >= 99


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


def test_node_daemon_device_engine_without_cuda_requires_explicit_cpu(
        monkeypatch):
    """``NodeDaemon(device_engine={})`` without CUDA raises before it
    touches the network; with ``device: "cpu"`` it starts and its runner
    runs device tasks on the CPU (``test_torch_device_engine_rest.py``
    runs them)."""
    from vantage6_tpu_torch.client import UserClient
    from vantage6_tpu_torch.node.daemon import NodeDaemon
    from vantage6_tpu_torch.server.app import ServerApp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cpu'"):
        NodeDaemon(api_url="http://127.0.0.1:9", api_key="unused",
                   device_engine={})
    srv = ServerApp()
    srv.ensure_root(password="rootpass123")
    http = srv.serve(port=0, background=True)
    d = None
    try:
        client = UserClient(http.url)
        client.authenticate("root", "rootpass123")
        org = client.organization.create(name="cpu_engine")
        collab = client.collaboration.create(
            name="cpu_engine", organization_ids=[org["id"]])
        key = client.node.create(organization_id=org["id"],
                                 collaboration_id=collab["id"])["api_key"]
        d = NodeDaemon(
            api_url=http.url, api_key=key, mode="inline", poll_interval=0.05,
            algorithms={"device-engine":
                        "vantage6_tpu_torch.workloads.device_engine"},
            device_engine={"device": "cpu"})
        assert d.engine_device == torch.device("cpu")
        assert d.runner.engine_device == torch.device("cpu")
    finally:
        if d is not None:
            d.stop()
        http.stop()
        srv.close()
