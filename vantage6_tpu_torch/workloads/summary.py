"""Federated summary statistics — parity with v6-summary-py.

Per-column count/mean/std/min/max over horizontally partitioned data, where
only aggregate moments (never rows) leave a station. Variance is combined via
the sum-of-squares decomposition, and min/max via elementwise extremes —
exactly what the reference algorithm ships as its "descriptive statistics"
entrypoint.

Counterpart of ``vantage6_tpu/workloads/summary.py``. The host partial
takes any mapping of column name to array (a DataFrame or a dict of numpy
arrays) and keeps pandas' NaN rules: ``count`` excludes NaN, ``sum`` and
the extremes skip it.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from vantage6_tpu_torch.algorithm.decorators import (
    algorithm_client,
    data,
    device_step,
)
from vantage6_tpu_torch.fed.collectives import fed_sum
from vantage6_tpu_torch.workloads._columns import column


def _column_stats(values: np.ndarray) -> tuple:
    """(count, sum, sum of squares, min, max) of one column as pandas'
    ``count``/``sum``/``min``/``max`` give them: NaN filled with 0 for the
    sums (pandas' ``nansum``), dropped for the extremes (NaN when nothing
    is left); native Python numbers."""
    if values.dtype.kind == "f":
        nan = np.isnan(values)
        filled, kept = np.where(nan, 0.0, values).astype(values.dtype), \
            values[~nan]
    else:
        filled = kept = values
    if kept.size:
        lo, hi = kept.min().item(), kept.max().item()
    else:
        lo = hi = float("nan")
    return (int(kept.size), filled.sum().item(), (filled**2).sum().item(),
            lo, hi)


@data(1)
def partial_summary(df: Any, columns: list[str]) -> dict[str, Any]:
    """Per-column count, sum, sum of squares, min and max. As pandas' frame
    reductions give one Series per statistic, a statistic whose columns
    mix ints and floats comes back as floats throughout."""
    stats = {c: _column_stats(column(df, c)) for c in columns}
    out = {}
    for i, key in enumerate(("count", "sum", "sum_sq", "min", "max")):
        vals = {c: s[i] for c, s in stats.items()}
        if any(isinstance(v, float) for v in vals.values()):
            vals = {c: float(v) for c, v in vals.items()}
        out[key] = vals
    return out


@algorithm_client
def central_summary(client: Any, columns: list[str],
                    organizations=None) -> dict[str, Any]:
    orgs = organizations or [o["id"] for o in client.organization.list()]
    task = client.task.create(
        input_={"method": "partial_summary", "kwargs": {"columns": columns}},
        organizations=orgs,
    )
    results = client.wait_for_results(task_id=task["id"])
    out: dict[str, Any] = {}
    for c in columns:
        n = sum(r["count"][c] for r in results)
        s = sum(r["sum"][c] for r in results)
        ss = sum(r["sum_sq"][c] for r in results)
        mean = s / n
        var = max(ss / n - mean**2, 0.0) * (n / max(n - 1, 1))
        out[c] = {
            "count": n,
            "mean": mean,
            "std": float(np.sqrt(var)),
            "min": min(r["min"][c] for r in results),
            "max": max(r["max"][c] for r in results),
        }
    return out


@device_step
def partial_summary_device(data_: Any) -> dict[str, Any]:
    """Device mode on array data {"x": [n, d], "count": []}."""
    x, count = data_["x"], data_["count"]
    valid = (torch.arange(x.shape[0], device=x.device) < count).to(
        x.dtype)[:, None]
    big = torch.finfo(x.dtype).max
    return {
        "count": count,
        "sum": torch.sum(x * valid, dim=0),
        "sum_sq": torch.sum((x * valid) ** 2, dim=0),
        "min": torch.min(torch.where(valid > 0, x, big), dim=0).values,
        "max": torch.max(torch.where(valid > 0, x, -big), dim=0).values,
    }


def summary_device(federation: Any) -> dict[str, Any]:
    from vantage6_tpu_torch.algorithm.client import AlgorithmClient

    client = AlgorithmClient(federation, image="summary")
    task = client.task.create(
        input_={"method": "partial_summary_device"},
        organizations=federation.organization_ids(),
    )
    stacked, mask = client.wait_for_stacked_result(task["id"])
    n = fed_sum(stacked["count"], mask=mask)
    s = fed_sum(stacked["sum"], mask=mask)
    ss = fed_sum(stacked["sum_sq"], mask=mask)
    mean = s / n
    var = torch.clamp(ss / n - mean**2, min=0.0) * (
        n / torch.clamp(n - 1, min=1))
    m = mask[:, None] if stacked["min"].ndim == 2 else mask
    big = torch.finfo(stacked["min"].dtype).max
    mn = torch.min(torch.where(m > 0, stacked["min"], big), dim=0).values
    mx = torch.max(torch.where(m > 0, stacked["max"], -big), dim=0).values
    return {
        "count": n.cpu().numpy(), "mean": mean.cpu().numpy(),
        "std": torch.sqrt(var).cpu().numpy(), "min": mn.cpu().numpy(),
        "max": mx.cpu().numpy(),
    }
