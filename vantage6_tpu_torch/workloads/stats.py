"""Federated descriptive statistics on the device: correlation and
crosstab.

Counterpart of the device half of ``vantage6_tpu/workloads/stats.py``:

- ``correlation_device``: every station's moment block (n, sum x, x'x)
  over its own rows, one cross-station sum, and the Pearson matrix on the
  device; the moments are additive, so the federated matrix is the pooled
  one;
- ``crosstab_device``: the pooled contingency table of two categorical
  columns as exact integer counts, with the host mode's disclosure rule (a
  station cell in (0, min_cell_count) poisons the pooled cell);
- ``encode_crosstab``: the host-side prep helper turning per-station
  columns into padded integer codes over the shared vocabularies.

A station's data is any mapping from column name to array (a pandas
DataFrame is one; the port does not import pandas).

Not ported yet: the host partials and centrals (``partial_crosstab``,
``central_crosstab``, ``partial_correlation``, ``central_correlation``),
which drive tasks through the algorithm client and its decorators
(``algorithm/context.py``, ``algorithm/decorators.py``; ROADMAP.md queue 1
items 9 and 10).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed.collectives import fed_sum
from vantage6_tpu_torch.utils.datasets import pad_shards


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
