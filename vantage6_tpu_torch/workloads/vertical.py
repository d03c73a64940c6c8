"""Vertically-partitioned federated logistic regression.

Counterpart of ``vantage6_tpu/workloads/vertical.py``: the same patients at every station, each station holding a different
feature block, the labels with the aggregator. Full-batch gradient descent
on the pooled logistic objective: each station computes ``z_s = X_s w_s``
on its own block, the aggregator sums ``eta = b + sum_s z_s`` and forms the
residual, and each station steps its own block with ``X_s' r / n``. It is
pooled gradient descent on the column-concatenated design; the per-sample
partial predictors and the residual cross the aggregator boundary (the
stated exposure of crypto-free vertical LR).

Both modes are here: the host mode in the reference's task shape, numpy
float64 only (``partial_labels``, ``partial_vertical_predictor`` and
``partial_vertical_grad`` per station, ``central_vertical_logistic``
orchestrating one predictor and one gradient fan-out an iteration), and
the device mode, ``fit_vertical_logistic_device``, the whole loop on the
device with one cross-station sum an iteration.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from vantage6_tpu_torch.algorithm.decorators import algorithm_client, data
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed.collectives import fed_sum
from vantage6_tpu_torch.workloads._columns import column, columns


# ----------------------------------------------------------------- host mode
@data(1)
def partial_labels(df: Any, label_col: str) -> dict[str, Any]:
    """The label party's labels, to the AGGREGATOR only (documented
    disclosure: the aggregator is the label holder's delegate here, as in
    the ecosystem's vertical designs where the 'active party' runs the
    central function)."""
    y = column(df, label_col, np.float32)
    return {"y": [float(v) for v in y], "n": int(y.shape[0])}


@data(1)
def partial_vertical_predictor(
    df: Any, feature_cols: list[str], weights: list[float]
) -> dict[str, Any]:
    """This station's partial linear predictor z = X_block @ w_block."""
    x = columns(df, feature_cols, np.float64)
    z = x @ np.asarray(weights, np.float64)
    return {"z": [float(v) for v in z]}


@data(1)
def partial_vertical_grad(
    df: Any, feature_cols: list[str], residual: list[float]
) -> dict[str, Any]:
    """This station's gradient block X_block' r / n (aggregates over rows —
    never rows)."""
    x = columns(df, feature_cols, np.float64)
    r = np.asarray(residual, np.float64)
    g = x.T @ r / max(len(r), 1)
    return {"grad": [float(v) for v in g]}


@algorithm_client
def central_vertical_logistic(
    client: Any,
    feature_map: dict[str, list[str]],  # org id (as str) -> its columns
    label_org: int,
    label_col: str,
    n_iter: int = 100,
    lr: float = 1.0,
    l2: float = 0.0,
) -> dict[str, Any]:
    """Vertical LR, reference-shaped rounds: predictor fan-out + residual
    broadcast + gradient fan-out per iteration. Weight blocks are stored
    by the aggregator but only ever applied at their own station."""
    if n_iter < 1:
        raise ValueError("n_iter must be >= 1")
    orgs = [int(k) for k in feature_map]

    def fanout_per_org(method: str, per_org_kwargs: dict[int, dict]) -> dict:
        # submit ALL per-org tasks first, then collect: serial submit+wait
        # would grow every round's wall-clock S-fold
        tasks = {
            org: client.task.create(
                input_={"method": method, "kwargs": kwargs},
                organizations=[org],
                name=f"vlr_{method}",
            )
            for org, kwargs in per_org_kwargs.items()
        }
        return {
            org: client.wait_for_results(task_id=t["id"])[0]
            for org, t in tasks.items()
        }

    lab = fanout_per_org(
        "partial_labels", {label_org: {"label_col": label_col}}
    )[label_org]
    y = np.asarray(lab["y"], np.float64)
    n = lab["n"]

    weights = {o: np.zeros(len(feature_map[str(o)]), np.float64) for o in orgs}
    bias = 0.0
    losses = []
    for _ in range(n_iter):
        zs = fanout_per_org(
            "partial_vertical_predictor",
            {o: {"feature_cols": feature_map[str(o)],
                 "weights": [float(v) for v in weights[o]]} for o in orgs},
        )
        eta = bias + np.sum([np.asarray(z["z"]) for z in zs.values()], axis=0)
        mu = 1.0 / (1.0 + np.exp(-eta))
        r = mu - y
        eps = 1e-12
        losses.append(float(-np.mean(
            y * np.log(mu + eps) + (1 - y) * np.log(1 - mu + eps)
        )))
        grads = fanout_per_org(
            "partial_vertical_grad",
            {o: {"feature_cols": feature_map[str(o)],
                 "residual": [float(v) for v in r]} for o in orgs},
        )
        for o in orgs:
            weights[o] -= lr * (
                np.asarray(grads[o]["grad"]) + l2 * weights[o]
            )
        bias -= lr * float(np.mean(r))
    return {
        "weights": {str(o): [float(v) for v in weights[o]] for o in orgs},
        "bias": float(bias),
        "losses": losses,
        "n": n,
        "iterations": n_iter,
    }


# --------------------------------------------------------------- device mode


def stack_vertical_blocks(
    frames: list[Any], feature_cols_per_station: list[list[str]]
) -> tuple[np.ndarray, np.ndarray]:
    """Per-station feature blocks -> ``[S, n, p_max]`` f32 (feature axis
    zero-padded) and the true per-station feature counts. Every station
    must hold the same rows in the same order; a frame is any mapping of
    column name to array. Zero-padded feature columns add zero to z and
    get zero gradient, so no feature mask is needed."""
    blocks = [columns(f, cols, np.float32)
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
