"""Vertically-partitioned federated logistic regression on the device.

Counterpart of the device half of ``vantage6_tpu/workloads/vertical.py``:
the same patients at every station, each station holding a different
feature block, the labels with the aggregator. Full-batch gradient descent
on the pooled logistic objective: each station computes ``z_s = X_s w_s``
on its own block, the aggregator sums ``eta = b + sum_s z_s`` and forms the
residual, and each station steps its own block with ``X_s' r / n``. It is
pooled gradient descent on the column-concatenated design; the per-sample
partial predictors and the residual cross the aggregator boundary (the
stated exposure of crypto-free vertical LR).

Not ported yet: the host mode (``partial_*``,
``central_vertical_logistic``), which drives tasks through the algorithm
client (ROADMAP.md queue 1 items 9 and 10).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed.collectives import fed_sum


def stack_vertical_blocks(
    frames: list[Any], feature_cols_per_station: list[list[str]]
) -> tuple[np.ndarray, np.ndarray]:
    """Per-station feature blocks -> ``[S, n, p_max]`` f32 (feature axis
    zero-padded) and the true per-station feature counts. Every station
    must hold the same rows in the same order; a frame is any mapping of
    column name to array. Zero-padded feature columns add zero to z and
    get zero gradient, so no feature mask is needed."""
    blocks = [np.stack([np.asarray(f[c], np.float32) for c in cols], axis=1)
              for f, cols in zip(frames, feature_cols_per_station,
                                 strict=True)]
    ns = {b.shape[0] for b in blocks}
    if len(ns) != 1:
        raise ValueError(f"vertical blocks must align on rows; got sizes {ns}")
    p_max = max(b.shape[1] for b in blocks)
    out = np.zeros((len(blocks), ns.pop(), p_max), np.float32)
    for s, b in enumerate(blocks):
        out[s, :, : b.shape[1]] = b
    return out, np.asarray([b.shape[1] for b in blocks], np.int32)


def fit_vertical_logistic_device(
    mesh: FederationMesh,
    sx: Any,  # [S, n, p_max] station feature blocks (zero-padded)
    y: Any,   # [n] labels (aggregator-held)
    n_iter: int = 100,
    lr: float = 1.0,
    l2: float = 0.0,
) -> dict[str, torch.Tensor]:
    """The whole vertical-LR training loop on the device, in the blocks'
    dtype: per iteration each station's z and gradient products under
    ``fed_map`` (its block never leaves it) and one cross-station sum of
    the ``[n]`` partial predictors. Returns ``{"weights" [S, p_max],
    "bias" [], "losses" [n_iter]}``."""
    if n_iter < 1:
        raise ValueError("n_iter must be >= 1")
    sx = torch.as_tensor(sx, device=mesh.device)
    yf = torch.as_tensor(y, device=mesh.device).to(sx.dtype)
    n = sx.shape[1]
    ws = torch.zeros((sx.shape[0], sx.shape[2]), dtype=sx.dtype,
                     device=sx.device)
    b = torch.zeros((), dtype=sx.dtype, device=sx.device)
    losses = []
    for _ in range(n_iter):
        zs = mesh.fed_map(lambda xs, w: xs @ w, sx, ws, batched=True)
        eta = fed_sum(zs) + b
        mu = torch.sigmoid(eta)
        r = (mu - yf) / n
        grads = mesh.fed_map(lambda xs, rr: xs.T @ rr, sx,
                             replicated_args=(r,), batched=True)
        ws = ws - lr * (grads + l2 * ws)
        b = b - lr * torch.sum(mu - yf) / n
        # stable BCE from logits: max(eta,0) - eta*y + log1p(exp(-|eta|))
        losses.append(torch.mean(torch.clamp_min(eta, 0.0) - eta * yf
                                 + torch.log1p(torch.exp(-torch.abs(eta)))))
    return {"weights": ws, "bias": b, "losses": torch.stack(losses)}
