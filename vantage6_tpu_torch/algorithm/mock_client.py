"""MockAlgorithmClient — in-process algorithm testing, reference-compatible.

Parity: vantage6-algorithm-tools MockAlgorithmClient (SURVEY.md §2 item 19),
the official story for unit-testing federated algorithms: supply per-
organization datasets, point at the algorithm module, and central+partial
functions run in-process with no server/node/docker.

Here the mock is a thin veneer over the real Federation runtime (the
framework *is* a production-grade mock in the reference's sense — SURVEY.md
§3.5), so algorithms tested against the mock run unchanged on the card.

Reference-shaped usage::

    client = MockAlgorithmClient(
        datasets=[[{"database": df0}], [{"database": df1}]],  # per org
        module=my_algorithm_module,
    )
    ids = [o["id"] for o in client.organization.list()]
    task = client.task.create(
        input_={"method": "central_average", "kwargs": {"column": "x"}},
        organizations=[ids[0]],
    )
    results = client.result.get(task["id"])

The port's copy of ``vantage6_tpu/algorithm/mock_client.py``:
``device=`` (CUDA unless ``"cpu"`` is asked for) where JAX takes
``devices=``.
"""
from __future__ import annotations

from types import ModuleType
from typing import Any, Callable

from vantage6_tpu_torch.algorithm.client import AlgorithmClient


class MockAlgorithmClient(AlgorithmClient):
    def __init__(
        self,
        datasets: list[list[dict[str, Any]]],
        module: ModuleType | dict[str, Callable] | str,
        collaboration_id: int | None = None,
        organization_ids: list[int] | None = None,
        node_ids: list[int] | None = None,
        device: Any = None,
    ):
        if isinstance(module, str):
            import importlib

            module = importlib.import_module(module)
        # Reference shape: datasets[i] is a LIST of database dicts for org i,
        # each {"database": <df-or-path>, "db_type": ..., ...}. v1 supports
        # one database per org via this path (multi-db via Federation
        # directly).
        per_org: list[Any] = []
        for i, org_dbs in enumerate(datasets):
            if not org_dbs:
                raise ValueError(f"organization {i} has no datasets")
            first = org_dbs[0]
            per_org.append(
                first["database"] if isinstance(first, dict) else first
            )
        # Imported here, not at module top: algorithm/__init__ loads this
        # module, and runtime.federation imports the algorithm package.
        from vantage6_tpu_torch.runtime.federation import federation_from_datasets

        fed = federation_from_datasets(
            per_org, algorithms={"mock": module}, device=device
        )
        del collaboration_id, organization_ids, node_ids  # accepted for parity
        super().__init__(fed, task=None, station=0, image="mock")

    @property
    def federation(self):
        """The underlying runtime (not in the reference API — handy for
        failure injection and device-mode assertions in tests)."""
        return self._fed
