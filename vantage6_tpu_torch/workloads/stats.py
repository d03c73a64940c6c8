"""Federated descriptive statistics: crosstab and correlation.

Counterpart of ``vantage6_tpu/workloads/stats.py``. The device half:

- ``correlation_device``: every station's moment block (n, sum x, x'x)
  over its own rows, one cross-station sum, and the Pearson matrix on the
  device; the moments are additive, so the federated matrix is the pooled
  one;
- ``crosstab_device``: the pooled contingency table of two categorical
  columns as exact integer counts, with the host mode's disclosure rule (a
  station cell in (0, min_cell_count) poisons the pooled cell);
- ``encode_crosstab``: the host-side prep helper turning per-station
  columns into padded integer codes over the shared vocabularies;

and the host half, numpy only, in the reference's task shape:

- ``partial_crosstab``/``central_crosstab``: category-pair counts per
  station with cells under ``min_cell_count`` suppressed at the station
  (-1), summed by the central, a suppressed cell poisoning its total;
- ``partial_moments``/``central_correlation``: the complete-case moment
  block per station, the Pearson matrix from the pooled moments.

A station's data is any mapping from column name to array (a pandas
DataFrame is one; the port does not import pandas). Category values are
compared as the strings of the column's own dtype, as pandas'
``astype(str)`` gives them (an int column ``'1'``, a float one ``'1.0'``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from vantage6_tpu_torch.algorithm.decorators import algorithm_client, data
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed.collectives import fed_sum
from vantage6_tpu_torch.utils.datasets import pad_shards
from vantage6_tpu_torch.workloads._columns import column
from vantage6_tpu_torch.workloads._columns import columns as stack_columns


# ------------------------------------------------------------------ crosstab
@data(1)
def partial_crosstab(
    df: Any,
    row_col: str,
    col_col: str,
    min_cell_count: int = 0,
) -> dict[str, Any]:
    """Category-pair counts on this station's rows.

    Cells below ``min_cell_count`` are SUPPRESSED (reported as -1): the
    reference's disclosure-control stance — a cell of 1 in a rare category
    can identify a person. Suppression happens AT the station, before
    anything crosses the wire.
    """
    counts: dict[tuple[str, str], int] = {}
    for r, c in zip(column(df, row_col).astype(str).tolist(),
                    column(df, col_col).astype(str).tolist()):
        counts[(r, c)] = counts.get((r, c), 0) + 1
    cells = [
        [r, c, (n if n >= min_cell_count else -1)]
        for (r, c), n in sorted(counts.items())
    ]
    return {"cells": cells, "suppressed_below": min_cell_count}


@algorithm_client
def central_crosstab(
    client: Any,
    row_col: str,
    col_col: str,
    min_cell_count: int = 0,
    organizations: list[int] | None = None,
) -> dict[str, Any]:
    """Pooled contingency table. A suppressed station cell poisons the
    pooled cell (reported as null): summing around a hidden count would
    fabricate a total."""
    orgs = organizations or [o["id"] for o in client.organization.list()]
    task = client.task.create(
        input_={
            "method": "partial_crosstab",
            "kwargs": {
                "row_col": row_col,
                "col_col": col_col,
                "min_cell_count": min_cell_count,
            },
        },
        organizations=orgs,
        name="crosstab_partial",
    )
    parts = client.wait_for_results(task_id=task["id"])
    total: dict[tuple[str, str], int | None] = {}
    for part in parts:
        for r, c, n in part["cells"]:
            key = (str(r), str(c))
            if n < 0 or total.get(key, 0) is None:
                total[key] = None  # suppressed anywhere -> unknown total
            else:
                total[key] = total.get(key, 0) + int(n)
    rows = sorted({r for r, _ in total})
    cols = sorted({c for _, c in total})
    table = [
        [total.get((r, c), 0) for c in cols]
        for r in rows
    ]
    return {"rows": rows, "columns": cols, "table": table,
            "suppressed_below": min_cell_count}


# -------------------------------------------------------------- correlation
@data(1)
def partial_moments(df: Any, columns: list[str]) -> dict[str, Any]:
    """Per-station moment block: n, sum x [p], x'x [p, p] over rows with no
    missing value in ``columns`` (complete-case, like the reference)."""
    x = stack_columns(df, columns, np.float64)
    x = x[~np.isnan(x).any(axis=1)]
    return {
        "n": int(x.shape[0]),
        "sum": np.sum(x, axis=0),
        "outer": x.T @ x,
    }


def _pearson_from_moments(n: float, s: np.ndarray, o: np.ndarray) -> np.ndarray:
    """Correlation matrix from pooled (n, sum x, x'x)."""
    mean = s / n
    cov = o / n - np.outer(mean, mean)
    sd = np.sqrt(np.clip(np.diag(cov), 1e-30, None))
    return cov / np.outer(sd, sd)


@algorithm_client
def central_correlation(
    client: Any,
    columns: list[str],
    organizations: list[int] | None = None,
) -> dict[str, Any]:
    """Pooled Pearson correlation matrix — equals the matrix on the
    concatenated rows (moments are additive)."""
    orgs = organizations or [o["id"] for o in client.organization.list()]
    task = client.task.create(
        input_={"method": "partial_moments", "kwargs": {"columns": columns}},
        organizations=orgs,
        name="correlation_partial",
    )
    parts = client.wait_for_results(task_id=task["id"])
    n = float(sum(p["n"] for p in parts))
    if n < 2:
        raise ValueError("fewer than 2 complete rows across the federation")
    s = np.sum([np.asarray(p["sum"]) for p in parts], axis=0)
    o = np.sum([np.asarray(p["outer"]) for p in parts], axis=0)
    corr = _pearson_from_moments(n, s, o)
    return {
        "columns": columns,
        "matrix": [[float(v) for v in row] for row in corr],
        "n": int(n),
    }


# ------------------------------------------------------ correlation (device)


def correlation_device(
    mesh: FederationMesh,
    sx: Any,        # [S, n_max, p] rows (pad with zeros)
    row_mask: Any,  # [S, n_max] 1.0 for real rows
) -> torch.Tensor:
    """Every station's moment block under ``fed_map``, one cross-station
    sum, the correlation computed on the device, in the rows' dtype.
    Returns the ``[p, p]`` matrix."""
    sx = torch.as_tensor(sx, device=mesh.device)
    m = torch.as_tensor(row_mask, device=mesh.device).to(sx.dtype)

    def station_block(x, mv):
        xm = x * mv[:, None]
        return torch.sum(mv), torch.sum(xm, dim=0), xm.T @ xm

    n, s, o = mesh.fed_map(station_block, sx, m, batched=True)
    n, s, o = fed_sum(n), fed_sum(s), fed_sum(o)
    mean = s / n
    cov = o / n - torch.outer(mean, mean)
    sd = torch.sqrt(torch.clamp(torch.diag(cov), min=1e-30))
    return cov / torch.outer(sd, sd)


def encode_crosstab(
    frames: list[Any], row_col: str, col_col: str
) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[str], list[str]]:
    """Per-station columns -> padded int32 codes for ``crosstab_device``:
    (row codes [S, n_max], col codes [S, n_max], row mask [S, n_max],
    row vocabulary, col vocabulary). Values are compared as strings; the
    vocabularies are the sorted unions.

    A host-side prep helper that sees every station's rows (tests,
    single-trust-domain analysis); in a federation each station codes its
    own shard against the shared vocabularies."""
    series = [(np.asarray(f[row_col]).astype(str),
               np.asarray(f[col_col]).astype(str)) for f in frames]
    rows = sorted({v for rs, _ in series for v in rs})
    cols = sorted({v for _, cs in series for v in cs})
    ridx = {v: i for i, v in enumerate(rows)}
    cidx = {v: i for i, v in enumerate(cols)}
    shards = [
        (np.asarray([ridx[v] for v in rs], np.int32),
         np.asarray([cidx[v] for v in cs], np.int32))
        for rs, cs in series
    ]
    pad_to = max(1, max((len(rs) for rs, _ in shards), default=1))
    rc, cc, counts = pad_shards(shards, pad_to=pad_to)
    m = (np.arange(pad_to)[None, :] < counts[:, None]).astype(np.float32)
    return rc, cc, m, rows, cols


def crosstab_device(
    mesh: FederationMesh,
    row_codes: Any,  # [S, n_max] int codes (pad 0, masked out)
    col_codes: Any,  # [S, n_max]
    row_mask: Any,   # [S, n_max] 1.0 for real rows
    n_row_cats: int,
    n_col_cats: int,
    min_cell_count: int = 0,
) -> dict[str, Any]:
    """The pooled contingency table on the device.

    Every station's ``[R, C]`` block is one int32 ``index_add_`` over
    station-offset codes ``s*R*C + r*C + c`` (exact; masked rows add 0),
    the pooled table one sum over stations. A station cell in
    ``(0, min_cell_count)`` poisons the pooled cell (None), as in host
    mode. Returns ``{"table": [[int | None]], "suppressed_below": ...}``."""
    dev = mesh.device
    rc = torch.as_tensor(row_codes, device=dev).to(torch.int64)
    cc = torch.as_tensor(col_codes, device=dev).to(torch.int64)
    m = torch.as_tensor(row_mask, device=dev)
    s = rc.shape[0]
    cells = n_row_cats * n_col_cats
    station = torch.arange(s, device=dev).reshape(-1, 1)
    codes = station * cells + rc * n_col_cats + cc
    tables = torch.zeros(s * cells, dtype=torch.int32, device=dev)
    tables.index_add_(0, codes.reshape(-1), m.to(torch.int32).reshape(-1))
    tables = tables.reshape(s, n_row_cats, n_col_cats)
    pooled = fed_sum(tables).cpu().numpy()
    # suppressed anywhere -> unknown total (host-mode poisoning rule)
    viol = (tables > 0) & (tables < min_cell_count)
    poisoned = (fed_sum(viol.to(torch.int32)) > 0).cpu().numpy()
    table = [
        [None if poisoned[r, c] else int(pooled[r, c])
         for c in range(n_col_cats)]
        for r in range(n_row_cats)
    ]
    return {"table": table, "suppressed_below": min_cell_count}
