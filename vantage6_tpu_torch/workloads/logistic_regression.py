"""Federated logistic regression — parity with v6-logistic-regression-py.

The reference algorithm iterates: central sends coefficients, each
organization computes the local gradient of the regularized log-likelihood
on its rows, central aggregates and updates, repeating to convergence —
federated *full-batch* gradient descent, which is mathematically identical
to pooled training (the selling point for clinical use).

Counterpart of ``vantage6_tpu/workloads/logistic_regression.py``: the
reference-shaped host mode (a frame in, plain arrays out) and the device
mode, where every station's gradient is one ``torch.func.grad`` under the
Federation's ``torch.func.vmap``. The JAX host partial differentiates on
JAX's default device, the accelerator; the port's takes a port-only
``device=`` (CUDA unless ``"cpu"`` is asked for), which ``central_logistic``
fills with the federation's card.
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
from vantage6_tpu_torch.core.mesh import resolve_device
from vantage6_tpu_torch.fed.collectives import fed_sum
from vantage6_tpu_torch.models.logistic import binary_loss, logits
from vantage6_tpu_torch.workloads._columns import column, columns


# ----------------------------------------------------------------- host mode
@data(1)
def partial_gradient(df: Any, coefs: Any, feature_cols: list[str],
                     label_col: str, device: Any = None) -> dict[str, Any]:
    """Per-station gradient + count of the binary NLL at given coefficients,
    computed in f32 on ``device``. Plain arrays out (never raw rows)."""
    dev = resolve_device(device)
    x = torch.from_numpy(columns(df, feature_cols, np.float32)).to(dev)
    y = torch.from_numpy(column(df, label_col, np.float32)).to(dev)
    params = {k: torch.as_tensor(np.asarray(coefs[k], np.float32),
                                 device=dev) for k in ("w", "b")}
    n = x.shape[0]
    grads = torch.func.grad(lambda p: binary_loss(p, x, y) * n)(params)
    return {
        "grad_w": grads["w"].cpu().numpy(),
        "grad_b": grads["b"].cpu().numpy(),
        "count": n,
    }


@algorithm_client
def central_logistic(client: Any, feature_cols: list[str], label_col: str,
                     n_iter: int = 50, lr: float = 1.0,
                     organizations: list[int] | None = None) -> dict[str, Any]:
    """Federated full-batch gradient descent — identical to pooled GD."""
    if n_iter < 1:
        raise ValueError("n_iter must be >= 1")
    orgs = organizations or [o["id"] for o in client.organization.list()]
    n_features = len(feature_cols)
    params = {"w": np.zeros((n_features, 1), np.float32),
              "b": np.zeros((1,), np.float32)}
    for _ in range(n_iter):
        task = client.task.create(
            input_={
                "method": "partial_gradient",
                "kwargs": {
                    "coefs": {"w": params["w"], "b": params["b"]},
                    "feature_cols": feature_cols,
                    "label_col": label_col,
                    "device": str(client.device),
                },
            },
            organizations=orgs,
        )
        results = client.wait_for_results(task_id=task["id"])
        total = sum(r["count"] for r in results)
        gw = sum(np.asarray(r["grad_w"]) for r in results) / total
        gb = sum(np.asarray(r["grad_b"]) for r in results) / total
        params["w"] = params["w"] - lr * gw
        params["b"] = params["b"] - lr * gb
    return {"w": params["w"], "b": params["b"], "n_samples": total}


# --------------------------------------------------------------- device mode
@device_step
def partial_gradient_device(data_: Any, params: Any) -> dict[str, Any]:
    """Per-station summed gradient, all stations in one batched program.

    data_ = {"x": [n_pad, d], "y": [n_pad], "count": []} — padded rows are
    masked out of the sum. ``log(1 + e^z)`` is ``logaddexp(0, z)``, as in
    the reference (softplus's linear branch above 20 is another value).
    """
    x, y, count = data_["x"], data_["y"], data_["count"]
    valid = (torch.arange(x.shape[0], device=x.device) < count).to(
        torch.float32)

    def summed_nll(p):
        z = logits(p, x)[:, 0]
        nll = torch.logaddexp(torch.zeros_like(z), z) - y * z
        return torch.sum(nll * valid)

    return {"grad": torch.func.grad(summed_nll)(params), "count": count}


def fit_device(
    federation: Any,
    n_features: int,
    n_iter: int = 100,
    lr: float = 1.0,
) -> dict[str, torch.Tensor]:
    """Drive device-mode federated GD through the task engine.

    Each iteration is one device-mode task; the gradient sum over stations
    stays on the card (``fed_sum`` with the participation mask). Returns
    the f32 params on the federation's card.
    """
    from vantage6_tpu_torch.algorithm.client import AlgorithmClient

    client = AlgorithmClient(federation, image="logreg")
    dev = client.device
    params = {"w": torch.zeros((n_features, 1), device=dev),
              "b": torch.zeros((1,), device=dev)}
    for _ in range(n_iter):
        task = client.task.create(
            input_={"method": "partial_gradient_device",
                    "kwargs": {"params": params}},
            organizations=federation.organization_ids(),
        )
        stacked, mask = client.wait_for_stacked_result(task["id"])
        total = fed_sum(stacked["count"], mask=mask)
        grad = fed_sum(stacked["grad"], mask=mask)
        params = {k: params[k] - lr * grad[k] / total for k in params}
    return params
