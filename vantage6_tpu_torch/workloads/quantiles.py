"""Federated quantiles (median and friends) by iterative bisection.

Counterpart of ``vantage6_tpu/workloads/quantiles.py``. No station ever
shares a value: each round the central proposes a cut point and every
station reports only HOW MANY of its rows fall at or below it; bisection
converges on the value whose global rank matches the requested quantile.

- host mode (numpy only, the reference's task shape): ``partial_count_below``
  and ``partial_bounds`` per station over a frame (any mapping of column
  name to array; NaN dropped as pandas' ``dropna``), ``central_quantile``
  driving one task round a bisection step;
- device mode: ``quantile_device``, the whole loop on the device. Each
  step's per-station masked counts run under ``fed_map``, one
  cross-station sum gives the global rank, the ``>= target`` test is a
  ``torch.where``, and only the final values are pulled to the host, where
  the bracket guards run. Its calls are observed as the reference's,
  ``quantile.bisection`` (``runtime/profiling.py``).

Bounds: pass ``lo``/``hi`` when the schema bounds are known; without them
each station's exact min/max is used (a stated disclosure of two extreme
values per station, as in the reference). The JAX package caches the
compiled bisection per mesh and ``n_iter`` (``RunnerCache``); eager torch
compiles nothing, so there is no cache.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from vantage6_tpu_torch.algorithm.decorators import algorithm_client, data
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed.collectives import fed_sum
from vantage6_tpu_torch.runtime.profiling import observed_jit
from vantage6_tpu_torch.workloads._columns import dropna


# ----------------------------------------------------------------- host mode
@data(1)
def partial_count_below(df: Any, column: str, cut: float) -> dict[str, Any]:
    """#rows with value <= cut, plus this station's total (complete-case)."""
    vals = dropna(df[column])
    return {"below": int((vals <= cut).sum()), "count": int(len(vals))}


@data(1)
def partial_bounds(df: Any, column: str) -> dict[str, Any]:
    """Local [min, max] + row count of the column — the documented
    disclosure the range round costs when the caller cannot supply lo/hi
    (the count rides along so no extra rank round is needed)."""
    vals = dropna(df[column])
    if len(vals) == 0:
        return {"lo": None, "hi": None, "count": 0}
    return {
        "lo": float(vals.min()),
        "hi": float(vals.max()),
        "count": int(len(vals)),
    }


@algorithm_client
def central_quantile(
    client: Any,
    column: str,
    q: float = 0.5,
    lo: float | None = None,
    hi: float | None = None,
    tol: float = 1e-6,
    max_iter: int = 64,
    organizations: list[int] | None = None,
) -> dict[str, Any]:
    """The q-quantile of the pooled column without pooling any rows.

    Bisection on the value axis: maintains [lo, hi] bracketing the value
    whose global rank is ceil(q * n); each bisection step is one
    count-below task round (``max_iter`` bounds the bisection steps; the
    returned ``task_rounds`` additionally counts the bounds/bracket
    rounds). 64 steps halve the bracket to ~2^-64 of its width — float64
    exact for any practical range.
    """
    if not 0.0 < q < 1.0:
        raise ValueError("q must be in (0, 1)")
    orgs = organizations or [o["id"] for o in client.organization.list()]

    def fanout(method: str, kwargs: dict) -> list[dict]:
        task = client.task.create(
            input_={"method": method, "kwargs": kwargs},
            organizations=orgs,
            name=f"quantile_{method}",
        )
        return client.wait_for_results(task_id=task["id"])

    def count_below(cut: float) -> int:
        return sum(
            p["below"]
            for p in fanout(
                "partial_count_below", {"column": column, "cut": cut}
            )
        )

    task_rounds = 0
    bounds_rounds = 0
    auto_bounds = lo is None or hi is None
    n = None
    if auto_bounds:
        parts = fanout("partial_bounds", {"column": column})
        task_rounds += 1
        bounds_rounds = 1
        los = [p["lo"] for p in parts if p["lo"] is not None]
        his = [p["hi"] for p in parts if p["hi"] is not None]
        if not los:
            raise ValueError("no station holds any rows for this column")
        lo = min(los) if lo is None else lo
        hi = max(his) if hi is None else hi
        n = sum(p["count"] for p in parts)
    lo, hi = float(lo), float(hi)
    if not hi >= lo:
        raise ValueError(f"invalid range [{lo}, {hi}]")

    if n is None:
        # caller-supplied bounds: one rank round at hi learns n AND proves
        # the quantile is bracketed from above
        parts = fanout("partial_count_below", {"column": column, "cut": hi})
        task_rounds += 1
        n = sum(p["count"] for p in parts)
        if n == 0:
            raise ValueError("no rows across the federation")
        below_hi = sum(p["below"] for p in parts)
        target = int(np.ceil(q * n))
        if below_hi < target:
            # values above hi exist (caller-supplied hi too small): the
            # quantile is not bracketed — fail loudly rather than clamp
            raise ValueError(
                f"hi={hi} has global rank {below_hi} < target {target}; "
                "widen the range"
            )
        # ...and the lo side must bracket from BELOW, or bisection would
        # silently converge onto the caller's lo and return a wrong value
        below_lo = count_below(lo)
        task_rounds += 1
        if below_lo >= target:
            raise ValueError(
                f"lo={lo} already has global rank {below_lo} >= target "
                f"{target}: the quantile lies at or below lo; lower lo"
            )
    else:
        if n == 0:
            raise ValueError("no rows across the federation")
        target = int(np.ceil(q * n))
        # auto bounds: hi is the true global max (rank n >= target) and lo
        # the true min — bisection converges to the min when the quantile
        # IS the min, so no extra bracket rounds are needed

    bisections = 0
    while hi - lo > tol and bisections < max_iter:
        mid = 0.5 * (lo + hi)
        if count_below(mid) >= target:
            hi = mid
        else:
            lo = mid
        task_rounds += 1
        bisections += 1
    return {
        "quantile": q,
        "value": float(hi),
        "n": int(n),
        "bisection_steps": bisections,
        "task_rounds": task_rounds,
        "bounds_rounds": bounds_rounds,
        "bracket": [float(lo), float(hi)],
    }


# --------------------------------------------------------------- device mode
def _bisect(mesh: FederationMesh, sx: torch.Tensor, m: torch.Tensor,
            q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
            n_iter: int):
    """(upper bracket, n, rank of lo, rank of hi) as device scalars. NaN
    bounds are replaced by the masked global min/max."""
    big = torch.tensor(torch.finfo(sx.dtype).max, dtype=sx.dtype,
                       device=sx.device)
    n = fed_sum(mesh.fed_map(torch.sum, m, batched=True))
    # per-station masked extrema come back stacked [S]; the global bound is
    # their min/max
    lo = torch.where(torch.isnan(lo), torch.min(mesh.fed_map(
        lambda xv, mv: torch.min(torch.where(mv > 0, xv, big)), sx, m,
        batched=True)), lo)
    hi = torch.where(torch.isnan(hi), torch.max(mesh.fed_map(
        lambda xv, mv: torch.max(torch.where(mv > 0, xv, -big)), sx, m,
        batched=True)), hi)
    target = torch.ceil(q * n)

    def count_below(cut):
        return fed_sum(mesh.fed_map(
            lambda xv, mv: torch.sum((xv <= cut) * mv), sx, m,
            batched=True))

    blo, bhi = lo, hi
    for _ in range(n_iter):
        mid = 0.5 * (blo + bhi)
        ge = count_below(mid) >= target
        blo, bhi = torch.where(ge, blo, mid), torch.where(ge, mid, bhi)
    return bhi, n, count_below(lo), count_below(hi)


#: the whole bisection, one observed dispatch a call (the reference's label)
_BISECTION = observed_jit("quantile.bisection", _bisect,
                          static_argnames=("n_iter",))


def quantile_device(
    mesh: FederationMesh,
    sx: Any,        # [S, n_max] padded station values
    row_mask: Any,  # [S, n_max] 1.0 for real rows
    q: float = 0.5,
    lo: float | None = None,
    hi: float | None = None,
    n_iter: int = 64,
) -> dict[str, Any]:
    """The whole bisection on the device; returns ``{"quantile", "value",
    "n", "bisection_steps"}``. Integer columns are bisected in f32. Empty
    federations and caller bounds that do not bracket the quantile raise,
    as in host mode."""
    if not 0.0 < q < 1.0:
        raise ValueError("q must be in (0, 1)")
    if lo is not None and hi is not None and not hi >= lo:
        raise ValueError(f"invalid range [{lo}, {hi}]")
    sx = torch.as_tensor(sx, device=mesh.device)
    if not sx.dtype.is_floating_point:
        # bisection needs a float value axis, and the NaN bound sentinel a
        # float slot
        sx = sx.to(torch.float32)
    m = torch.as_tensor(row_mask, device=mesh.device).to(sx.dtype)

    def bound(v):
        return torch.tensor(float("nan") if v is None else v, dtype=sx.dtype,
                            device=sx.device)

    value, n, below_lo, below_hi = _BISECTION(
        mesh, sx, m, torch.tensor(q, dtype=sx.dtype, device=sx.device),
        bound(lo), bound(hi), n_iter=n_iter)
    n = int(n.item())
    if n == 0:
        raise ValueError("no rows across the federation")
    target = int(math.ceil(q * n))
    # the host-mode bracket guards, on caller bounds only (auto bounds are
    # the true extrema and bracket by construction)
    if hi is not None and int(below_hi.item()) < target:
        raise ValueError(
            f"hi={hi} has global rank {int(below_hi.item())} < target "
            f"{target}; widen the range"
        )
    if lo is not None and int(below_lo.item()) >= target:
        raise ValueError(
            f"lo={lo} already has global rank {int(below_lo.item())} >= "
            f"target {target}: the quantile lies at or below lo; lower lo"
        )
    return {
        "quantile": q,
        "value": float(value.item()),
        "n": n,
        "bisection_steps": n_iter,
    }
