"""Logistic / linear models for tabular federated analysis.

Counterpart of ``vantage6_tpu/models/logistic.py``: a binary (one logit)
or multinomial logistic model as a ``{"w": [p, out], "b": [out]}`` tree of
tensors, usable by the FedAvg engine. ``params_from_jax`` moves the JAX
package's parameters across (same names and layouts).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from vantage6_tpu_torch.core.mesh import resolve_device

Params = dict[str, torch.Tensor]


def init_logistic(generator: torch.Generator | int, n_features: int,
                  n_classes: int = 2,
                  device: str | torch.device | None = None) -> Params:
    """Binary (n_classes=2 -> single logit) or multinomial logistic params:
    ``w ~ N(0, 0.01^2)`` drawn from ``generator`` (a CPU generator, or a
    seed) and zero bias, on ``device`` (CUDA unless ``"cpu"`` is asked
    for). The draws are made on the CPU, so a seed gives the same weights
    on every device."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    out = 1 if n_classes == 2 else n_classes
    params = {
        "w": torch.randn((n_features, out), generator=generator) * 0.01,
        "b": torch.zeros((out,)),
    }
    return {k: v.to(device) for k, v in params.items()}


def params_from_jax(tree: Any, device: str | torch.device) -> Params:
    """A JAX logistic parameter tree (numpy or jax arrays) as float32
    tensors on ``device``."""
    return {k: torch.from_numpy(np.array(tree[k], np.float32)).to(device)
            for k in ("w", "b")}


def logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def binary_loss(params: Params, x: torch.Tensor, y: torch.Tensor,
                l2: float = 0.0) -> torch.Tensor:
    """Mean negative log-likelihood, y in {0,1}, optional L2."""
    z = logits(params, x)[:, 0]
    nll = torch.mean(torch.logaddexp(torch.zeros_like(z), z) - y * z)
    return nll + l2 * torch.sum(params["w"] ** 2)


def multinomial_loss(params: Params, x: torch.Tensor, y: torch.Tensor,
                     l2: float = 0.0) -> torch.Tensor:
    logp = torch.log_softmax(logits(params, x), dim=-1)
    nll = -torch.mean(torch.gather(logp, 1, y.long()[:, None]))
    return nll + l2 * torch.sum(params["w"] ** 2)


def predict_proba(params: Params, x: torch.Tensor) -> torch.Tensor:
    z = logits(params, x)
    if z.shape[1] == 1:
        p = torch.sigmoid(z[:, 0])
        return torch.stack([1 - p, p], dim=1)
    return torch.softmax(z, dim=-1)


def binary_accuracy(params: Params, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    return torch.mean(((logits(params, x)[:, 0] > 0) == (y > 0.5)).to(
        torch.float32))
