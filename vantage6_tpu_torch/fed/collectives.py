"""Federated aggregation primitives over the station axis.

Counterpart of ``vantage6_tpu/fed/collectives.py``: the masked, weighted
reductions, the flat-pack seam and learning-plane stats, and the one-card
form of the scattered reductions.

Each primitive consumes *stacked* per-station pytrees (leading axis S) and
reduces them on the device. All primitives take an optional participation
``mask`` ([S] bool/float): a dropped station contributes weight 0.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Any

import torch

from vantage6_tpu_torch._tree import tree_leaves, tree_map, tree_unflatten

if TYPE_CHECKING:  # pragma: no cover
    from vantage6_tpu_torch.core.mesh import FederationMesh

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


# --------------------------------------------------------------------------
# The flat-pack seam: a pytree as one flat f32 vector, a stacked pytree as
# one [S, N] matrix. Leaves are concatenated in ``tree_leaves`` order, which
# is ``jax.tree.leaves``' (dict keys sorted), so the rows match the JAX
# package's element for element.
# --------------------------------------------------------------------------


def flat_size(tree: Pytree) -> int:
    """Total element count of ``tree``'s leaves (static, host-side)."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))


def padded_flat_size(n: int, d: int) -> int:
    """``n`` rounded up to a multiple of ``d`` (the scatter's divisibility)."""
    return n + (-n) % d


def flatten_tree(tree: Pytree, dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """Ravel + concatenate every leaf into one flat [N] vector."""
    parts = [x.to(dtype).reshape(-1) for x in tree_leaves(tree)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def unflatten_like(template: Pytree, flat: torch.Tensor) -> Pytree:
    """Inverse of ``flatten_tree``: split ``flat`` back into ``template``'s
    shapes/dtypes. Extra trailing elements (scatter padding) are ignored."""
    out, off = [], 0
    for leaf in tree_leaves(template):
        size = math.prod(leaf.shape)
        out.append(flat[off:off + size].reshape(leaf.shape).to(leaf.dtype))
        off += size
    return tree_unflatten(template, out)


def flatten_stacked(stacked: Pytree) -> torch.Tensor:
    """Per-station flat-pack: [S, ...] pytree -> ONE [S, N] f32 matrix
    (row i = station i's delta, leaves concatenated in tree order)."""
    leaves = tree_leaves(stacked)
    if not leaves:
        raise ValueError("empty pytree")
    s = leaves[0].shape[0]
    parts = [x.to(torch.float32).reshape(s, -1) for x in leaves]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def unflatten_stacked(template: Pytree, flat: torch.Tensor) -> Pytree:
    """Inverse of ``flatten_stacked``: [S, N] rows back into a stacked
    pytree shaped/dtyped like ``template`` (a PER-STATION pytree, i.e. one
    station's leaf shapes) with the leading station axis restored."""
    s = flat.shape[0]
    out, off = [], 0
    for leaf in tree_leaves(template):
        size = math.prod(leaf.shape)
        out.append(flat[:, off:off + size]
                   .reshape((s,) + tuple(leaf.shape)).to(leaf.dtype))
        off += size
    return tree_unflatten(template, out)


def station_update_stats(
    flat: torch.Tensor,
    weights: Any | None = None,
    mask: Any | None = None,
    ef: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Learning-plane statistics of one round's per-station updates, one
    f32 pass over the flat-packed ``[S, N]`` rows:

    - ``station_norm`` [S]: each station's update L2 norm;
    - ``station_cos`` [S]: cosine of each station's delta to the pooled
      (weighted-mean) delta;
    - ``update_norm`` []: L2 norm of the pooled delta;
    - ``station_weight`` [S]: the effective weight vector, so a consumer
      can tell a participating station from a masked-out one;
    - ``station_ef_norm`` [S] (only when ``ef`` is passed): per-station
      error-feedback mass.

    The pooled delta uses ``fed_mean``'s weighting (f32, zero-weight
    stations excluded with ``where`` so a NaN row cannot poison it, all
    dropped -> zeros). Masked-out stations keep their own norm and cosine.
    """
    x = flat.to(torch.float32)
    s = x.shape[0]
    w = _norm_weights(s, weights, mask, x.device)
    norms = torch.sqrt(torch.sum(x * x, dim=1))
    total = torch.sum(w)
    denom = torch.where(total > 0, total, torch.ones_like(total))
    ww = w.reshape(-1, 1)
    safe = torch.where(ww != 0, x, torch.zeros((), dtype=torch.float32,
                                               device=x.device))
    pooled = torch.sum(safe * ww, dim=0) / denom
    update_norm = torch.sqrt(torch.sum(pooled * pooled))
    dots = x @ pooled
    cos = dots / torch.clamp_min(norms * update_norm, 1e-12)
    out = {
        "station_norm": norms,
        "station_cos": cos,
        "update_norm": update_norm,
        "station_weight": w,
    }
    if ef is not None:
        e = ef.to(torch.float32)
        out["station_ef_norm"] = torch.sqrt(torch.sum(e * e, dim=1))
    return out


def per_round_masks(mask: Any, n_rounds: int) -> torch.Tensor:
    """Participation masks for a fused K-round run as a ``[K, S]`` f32
    matrix: a ``[S]`` mask (one roster for every round) is broadcast, a
    ``[K, S]`` matrix (per-round rosters, async accept masks) is checked
    for its length."""
    m = torch.as_tensor(mask).to(torch.float32)
    if m.ndim == 1:
        return m.expand((n_rounds,) + tuple(m.shape))
    if m.ndim != 2:
        raise ValueError(
            f"mask must be [S] or [n_rounds, S], got rank {m.ndim}"
        )
    if m.shape[0] != n_rounds:
        raise ValueError(
            f"per-round mask has {m.shape[0]} rounds, expected {n_rounds}"
        )
    return m


# --------------------------------------------------------------------------
# Scattered aggregation on one card. The JAX package reduce-scatters the
# flat weighted sum over its D station slots (ZeRO-1 server update); on one
# card D = 1, so the scatter and the all-gather are the identity and only
# the arithmetic stays: f32 accumulation whatever the leaf dtype, and the
# ``comm_dtype`` cast of what would cross the wire. The multi-GPU form
# (NCCL) is ROADMAP.md queue 1 item 9.
# --------------------------------------------------------------------------


def fed_sum_scattered(
    mesh: "FederationMesh",
    stacked: Pytree,
    weights: Any | None = None,
    mask: Any | None = None,
    comm_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Weighted sum over stations as ONE flat f32 vector of
    ``padded_flat_size(N, D)`` elements (D = the mesh's station axis, 1 on
    one card). Zero-weight stations are excluded with ``where``; the sum is
    f32; ``comm_dtype`` rounds the summed vector once, as the wire would."""
    n = _station_count(stacked)
    if n != mesh.n_stations:
        raise ValueError(
            f"stacked has {n} stations but mesh federates {mesh.n_stations}"
        )
    device = tree_leaves(stacked)[0].device
    w = _norm_weights(n, weights, mask, device)

    def leaf_sum(x: torch.Tensor) -> torch.Tensor:
        ww = w.reshape((-1,) + (1,) * (x.ndim - 1))
        xf = x.to(torch.float32)
        safe = torch.where(ww != 0, xf, torch.zeros((), dtype=torch.float32,
                                                    device=device))
        return torch.sum(safe * ww, dim=0)

    flat = flatten_tree([leaf_sum(x) for x in tree_leaves(stacked)])
    pad = padded_flat_size(flat.numel(), mesh.station_axis_size) - flat.numel()
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    if comm_dtype is not None:
        flat = flat.to(comm_dtype)
    return flat.to(torch.float32)


def fed_mean_scattered(
    mesh: "FederationMesh",
    stacked: Pytree,
    weights: Any | None = None,
    mask: Any | None = None,
    comm_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``fed_mean`` as one flat f32 vector (see ``fed_sum_scattered``); the
    division by the effective total weight comes after the cast, with
    ``fed_mean``'s all-dropped guard."""
    n = _station_count(stacked)
    device = tree_leaves(stacked)[0].device
    w = _norm_weights(n, weights, mask, device)
    total = torch.sum(w)
    denom = torch.where(total > 0, total, torch.ones_like(total))
    s = fed_sum_scattered(mesh, stacked, weights=weights, mask=mask,
                          comm_dtype=comm_dtype)
    return s / denom


def all_gather_stations(mesh: "FederationMesh",
                        flat: torch.Tensor) -> torch.Tensor:
    """Re-replicate a station-axis-sharded flat vector: on one card every
    shard is already the whole vector."""
    del mesh
    return flat
