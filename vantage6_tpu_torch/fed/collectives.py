"""Federated aggregation primitives over the station axis.

Counterpart of ``vantage6_tpu/fed/collectives.py``: the masked, weighted
reductions, the flat-pack seam and learning-plane stats, the one-card form
of the scattered reductions, and the secure sums (pairwise int32 masks
that cancel exactly).

Each primitive consumes *stacked* per-station pytrees (leading axis S) and
reduces them on the device. All primitives take an optional participation
``mask`` ([S] bool/float): a dropped station contributes weight 0.
"""
from __future__ import annotations

import math
import operator
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


# --------------------------------------------------------------------------
# Secure aggregation: additive masking with exact modular-int cancellation.
# Station i adds sum_{j>i} PRG(k_ij) - sum_{j<i} PRG(k_ji) to its quantized
# value; the masks cancel in the sum over stations. Values are quantized to
# int32 and masked modulo 2^32, so cancellation is exact.
#
# The JAX package draws each pair mask with jax.random (threefry-2x32 under
# a 64-bit key), which torch cannot reproduce. Here a pair mask is
# Philox-4x32-10 (Salmon et al., SC'11), another counter-based generator,
# keyed by the 64 bits of ``key`` at the counters (block, i, j, 0): a pure
# function of (key, i, j, position), so both parties of a pair regenerate
# it. The bits differ from the JAX package's, the sums do not. As there,
# the masks derive from one ``key`` and an observer without it faces a
# 2^64 key space: the guarantee holds against observers without the key
# (the aggregator threat model needs per-pair secrets; only key
# provisioning changes).
# --------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _key_words(key: Any) -> tuple[int, int]:
    """A 64-bit ``key`` as its (low, high) 32-bit words; a key outside
    ``[0, 2^64)`` raises rather than being cut."""
    k = operator.index(key)
    if not 0 <= k < 2**64:
        raise ValueError(f"key must be an integer in [0, 2**64), got {key}")
    return k & _M32, k >> 32


def _mulhilo(a: int, b: Any) -> tuple[Any, Any]:
    """(high, low) 32-bit words of ``a * b`` for ``a``, ``b`` in [0, 2^32),
    in int64 tensors (or Python ints). The product is below 2^64, so the
    int64 product, which wraps mod 2^64, holds all of its bits: the arithmetic
    shift's sign extension is masked off."""
    p = a * b
    return (p >> 32) & _M32, p & _M32


def _philox(c: list[Any], k0: int, k1: int) -> list[Any]:
    """Philox-4x32-10 of the counter words ``c`` (four int64 tensors or
    Python ints in [0, 2^32), broadcasting) under the key (k0, k1)."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def fold_in(key: int, data: int) -> int:
    """A new 64-bit key from the 64-bit ``key`` and ``data`` (host side):
    two words of Philox at the counter (data, 1), which no pair mask
    uses."""
    lo, hi = _philox([*_key_words(data), 0, 1], *_key_words(key))[:2]
    return lo | (hi << 32)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement)."""
    return (((x + 2**31) & _M32) - 2**31).to(torch.int32)


def _pair_mask(key: int, i: torch.Tensor, j: torch.Tensor,
               numel: int) -> torch.Tensor:
    """Pairwise masks PRG(k_ij) as int32, ``[len(i), numel]``: Philox under
    ``key`` at the counters (block, i, j, 0), four positions a block, the
    same for both parties of each pair."""
    k0, k1 = _key_words(key)
    block = torch.arange((numel + 3) // 4, dtype=torch.int64,
                         device=i.device).reshape(1, -1)
    words = _philox([block, i.to(torch.int64).reshape(-1, 1),
                     j.to(torch.int64).reshape(-1, 1), 0], k0, k1)
    shape = (i.shape[0], block.shape[1])
    out = torch.stack([torch.broadcast_to(w, shape) for w in words], dim=2)
    return _wrap32(out.reshape(shape[0], -1)[:, :numel])


def mask_station_value(key: int, quantized: torch.Tensor) -> torch.Tensor:
    """Every station's pairwise masks added (mod 2^32) to its quantized
    value: ``quantized`` is ``[S, ...]`` int32, one row per station. A loop
    over the S partners, each step one ``[S, numel]`` mask for all
    stations at once."""
    s = quantized.shape[0]
    acc = quantized.reshape(s, -1).to(torch.int64)
    station = torch.arange(s, device=quantized.device)
    for partner in range(s):
        other = torch.full_like(station, partner)
        m = _pair_mask(key, torch.minimum(station, other),
                       torch.maximum(station, other), acc.shape[1])
        sign = torch.where(station == partner, 0,
                           torch.where(other > station, 1, -1))
        acc = acc + sign.reshape(-1, 1) * m.to(torch.int64)
    return _wrap32(acc).reshape(quantized.shape)


def quantize(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``round(x * scale)`` as int32, half to even as ``jnp.round``."""
    return torch.round(x * scale).to(torch.int32)


def dequantize(q: torch.Tensor, scale: float) -> torch.Tensor:
    return q.to(torch.float32) / scale


def secure_sum(
    stacked: torch.Tensor,
    key: int,
    scale: float = 2.0**16,
    mask: Any | None = None,
) -> torch.Tensor:
    """Secure sum over the station axis via pairwise additive masking.

    ``stacked``: ``[S, ...]`` float tensor. Each station's contribution is
    quantized, masked with the pairwise masks, and summed; the int32 sum
    wraps mod 2^32 and the masks cancel exactly. Returns the dequantized
    f32 sum. Max representable |sum| is 2^31/scale.

    ``mask`` ([S]) zeroes non-participating stations' values while every
    station still adds its pairwise masks, so they still cancel."""
    vals = stacked
    if mask is not None:
        m = _as_f32(mask, stacked.device).to(stacked.dtype).reshape(
            (-1,) + (1,) * (stacked.ndim - 1))
        vals = torch.where(m != 0, stacked, torch.zeros(
            (), dtype=stacked.dtype, device=stacked.device)) * m
    q = mask_station_value(key, quantize(vals, scale))
    # torch sums int32 into int64: wrap back to int32 before dequantizing
    return dequantize(_wrap32(torch.sum(q, dim=0, dtype=torch.int64)), scale)


def secure_fed_mean(
    stacked: Pytree,
    weights: Any,
    key: int,
    scale: float = 2.0**16,
) -> Pytree:
    """FedAvg aggregation where both the weighted sums and the total weight
    go through ``secure_sum``: the aggregator never sees one station's
    update in the clear. Leaf ``i`` is masked with ``fold_in(key, i + 1)``.
    """
    device = tree_leaves(stacked)[0].device
    w32 = _as_f32(weights, device)
    total_w = secure_sum(w32, key, scale)
    denom = torch.where(total_w > 0, total_w, torch.ones_like(total_w))
    out = []
    for idx, x in enumerate(tree_leaves(stacked)):
        w = w32.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        out.append(secure_sum(x * w, fold_in(key, idx + 1), scale) / denom)
    return tree_unflatten(stacked, out)
