"""Federated aggregation primitives over the station axis.

Counterpart of the non-scattered half of ``vantage6_tpu/fed/collectives.py``.
Each primitive consumes *stacked* per-station pytrees (leading axis S) and
reduces them on the device. All primitives take an optional participation
``mask`` ([S] bool/float): a dropped station contributes weight 0.
"""
from __future__ import annotations

from typing import Any

import torch

from vantage6_tpu_torch._tree import tree_leaves, tree_map

Pytree = Any


def _station_count(stacked: Pytree) -> int:
    leaves = tree_leaves(stacked)
    if not leaves:
        raise ValueError("empty pytree")
    return leaves[0].shape[0]


def _as_f32(x: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def _norm_weights(
    n: int,
    weights: Any | None,
    mask: Any | None,
    device: torch.device,
) -> torch.Tensor:
    """Normalize ``weights``/``mask`` into one float32 [n] weight vector.

    NUMERICS CONTRACT: weights are always carried as float32 — integer (or
    bf16) ``weights`` are upcast here. ``fed_sum``/``fed_mean`` accumulate
    and divide **in each leaf's dtype** (the f32 weights are cast down to
    the leaf dtype first). A bf16 leaf therefore pays bf16 rounding once per
    station in the sum and once in the division.
    """
    w = (
        torch.ones(n, dtype=torch.float32, device=device)
        if weights is None else _as_f32(weights, device)
    )
    if mask is not None:
        w = w * _as_f32(mask, device)
    return w


def _weighted_leaf_sum(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_i w[i] * x[i] over the leading (station) axis.

    Zero-weight stations are excluded with `where`, not just multiplied by
    0 — a crashed/diverged station whose contribution is inf/nan must not
    poison the aggregate (nan * 0 == nan).
    """
    ww = w.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
    safe_x = torch.where(ww != 0, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))
    return torch.sum(safe_x * ww, dim=0)


def fed_sum(stacked: Pytree, mask: Any | None = None) -> Pytree:
    """Sum each leaf over the station axis."""
    if mask is None:
        return tree_map(lambda x: torch.sum(x, dim=0), stacked)
    return tree_map(
        lambda x: _weighted_leaf_sum(x, _as_f32(mask, x.device)), stacked
    )


def fed_mean(
    stacked: Pytree,
    weights: Any | None = None,
    mask: Any | None = None,
) -> Pytree:
    """Weighted mean over stations — the FedAvg aggregator.

    ``weights`` is typically per-station example counts ([S]); ``mask`` drops
    stations. Division is by the *effective* total weight so dropped
    stations don't bias the mean; when every station is dropped the result
    is zeros, not NaN. Accumulation and division happen in each leaf's own
    dtype (see ``_norm_weights``).
    """
    n = _station_count(stacked)
    device = tree_leaves(stacked)[0].device
    w = _norm_weights(n, weights, mask, device)
    total = torch.sum(w)
    denom = torch.where(total > 0, total, torch.ones_like(total))
    return tree_map(
        lambda x: _weighted_leaf_sum(x, w) / denom.to(x.dtype), stacked
    )


def fed_weighted_stats(
    sums: Pytree, counts: torch.Tensor, mask: Any | None = None
) -> tuple[Pytree, torch.Tensor]:
    """(global sums, global count) from per-station (sums, counts)."""
    return fed_sum(sums, mask=mask), fed_sum(counts, mask=mask)


def fed_concat(stacked: Pytree) -> Pytree:
    """Flatten the station axis into the data axis: [S, n, ...] -> [S*n, ...]."""
    return tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), stacked)
