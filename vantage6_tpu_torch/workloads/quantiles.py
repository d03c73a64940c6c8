"""Federated quantiles by bisection, on the device.

Counterpart of ``quantile_device`` in ``vantage6_tpu/workloads/quantiles.py``:
each bisection step proposes a cut, every station counts its rows at or
below it (one masked count under ``fed_map``), and one cross-station sum
gives the global rank; ``n_iter`` halvings converge on the smallest value
whose global rank reaches ``ceil(q * n)``. The whole loop stays on the
device: the ``>= target`` test is a ``torch.where``, and only the final
values are pulled to the host, where the bracket guards run.

Bounds: pass ``lo``/``hi`` when the schema bounds are known; without them
the masked global min/max is used (a stated disclosure of two extreme
values per federation, as in host mode).

The JAX package caches the compiled bisection per mesh and ``n_iter``
(``RunnerCache``); eager torch compiles nothing, so there is no cache.

Not ported yet: the host mode (``partial_count_below``, ``partial_bounds``,
``central_quantile``), which drives tasks through the algorithm client
(ROADMAP.md queue 1 items 9 and 10).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed.collectives import fed_sum


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

    value, n, below_lo, below_hi = _bisect(
        mesh, sx, m, torch.tensor(q, dtype=sx.dtype, device=sx.device),
        bound(lo), bound(hi), n_iter)
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
