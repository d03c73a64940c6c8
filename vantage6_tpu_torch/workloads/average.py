"""Federated column average — parity with IKNL's v6-average-py.

The reference algorithm (separate repo, SURVEY.md §2 item 28): each
organization's `partial_average` computes {sum, count} of a column over its
own data; `central_average` creates one subtask per organization, waits for
results over the proxy/server, and divides. This module keeps that exact
shape (host mode, works on pandas DataFrames) and adds the device-mode
variant where the partial is a device step and the central division
consumes an on-device stacked result — the minimum end-to-end slice of
SURVEY.md §7.

Counterpart of ``vantage6_tpu/workloads/average.py``.
"""
from __future__ import annotations

from typing import Any

import torch

from vantage6_tpu_torch.algorithm.decorators import (
    algorithm_client,
    data,
    device_step,
)
from vantage6_tpu_torch.fed import collectives


# ----------------------------------------------------------------- host mode
@data(1)
def partial_average(df: Any, column: str) -> dict[str, float]:
    """Per-station partial: sum + count of one column (never raw rows)."""
    col = df[column]
    return {"sum": float(col.sum()), "count": int(col.count())}


@algorithm_client
def central_average(client: Any, column: str, organizations=None) -> dict:
    """Central step: fan out partials, aggregate sums/counts, divide."""
    orgs = organizations or [o["id"] for o in client.organization.list()]
    task = client.task.create(
        input_={"method": "partial_average", "kwargs": {"column": column}},
        organizations=orgs,
        name="partial_average",
    )
    results = client.wait_for_results(task_id=task["id"])
    total = sum(r["sum"] for r in results)
    count = sum(r["count"] for r in results)
    return {"average": total / count, "count": count}


# --------------------------------------------------------------- device mode
@device_step
def partial_average_device(data_: Any, column_index: int) -> dict[str, Any]:
    """Per-station partial on array data [n, d]: column sum + row count.

    Runs for every station in ONE batched program via fed_map.
    """
    x = data_["x"] if isinstance(data_, dict) else data_
    return {
        "sum": torch.sum(x[:, column_index]),
        "count": x.new_full((), x.shape[0], dtype=torch.float32),
    }


@algorithm_client
def central_average_device(client: Any, column_index: int,
                           organizations=None) -> dict:
    """Central step staying on device: the subtask's stacked result is
    aggregated with fed collectives — no per-station host round-trip."""
    orgs = organizations or [o["id"] for o in client.organization.list()]
    task = client.task.create(
        input_={
            "method": "partial_average_device",
            "kwargs": {"column_index": column_index},
        },
        organizations=orgs,
        name="partial_average_device",
    )
    stacked, mask = client.wait_for_stacked_result(task["id"])
    sums, count = collectives.fed_weighted_stats(
        stacked["sum"], stacked["count"], mask=mask
    )
    return {"average": float(sums / count), "count": int(count)}
