"""Functional server optimizers with optax's state and arithmetic.

``adam(lr)`` is ``optax.adam(lr)`` on tensor pytrees: ``b1=0.9``,
``b2=0.999``, ``eps=1e-8``, ``eps_root=0``, state ``(count, mu, nu)``, and
the update ``-lr * mu_hat / (sqrt(nu_hat) + eps)`` with the bias
corrections ``1 - b**count`` taken in float32. The JAX transformer engine
steps its model with it, and FedAdam its server model.

``sgd(lr)`` is ``optax.sgd(lr)`` without momentum: no state, the update
``-lr * g``. ``sgd(1.0)`` on the negative mean delta is plain FedAvg.

Adam's ``count`` is a Python int (the bias corrections are computed on the
host) or a 0-d integer tensor (computed on the device, so a round captured
as a CUDA graph reads the count each replay instead of baking it in).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from vantage6_tpu_torch._tree import tree_map


class AdamState(NamedTuple):
    count: int  # steps taken
    mu: Any  # first moment, like params
    nu: Any  # second moment, like params


B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float

    def init(self, params: Any) -> AdamState:
        return AdamState(
            count=0,
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
        )

    def update(self, grads: Any, state: AdamState,
               params: Any = None) -> tuple[Any, AdamState]:
        del params
        mu = tree_map(lambda g, t: (1 - B1) * g + B1 * t, grads, state.mu)
        nu = tree_map(lambda g, t: (1 - B2) * g**2 + B2 * t, grads, state.nu)
        count = state.count + 1
        # 1 - decay**count in float32, as optax computes it
        if isinstance(count, torch.Tensor):
            n = count.to(torch.float32)
            c1 = 1 - torch.pow(torch.full_like(n, B1), n)
            c2 = 1 - torch.pow(torch.full_like(n, B2), n)
        else:
            c1 = torch.tensor(
                float(np.float32(1) - np.float32(B1) ** np.float32(count)))
            c2 = torch.tensor(
                float(np.float32(1) - np.float32(B2) ** np.float32(count)))
        neg_lr = -float(np.float32(self.lr))

        def step(m, v):
            m_hat = m / c1.to(m.dtype)
            v_hat = v / c2.to(v.dtype)
            u = m_hat / (torch.sqrt(v_hat) + EPS)
            return torch.tensor(neg_lr, dtype=u.dtype) * u

        return tree_map(step, mu, nu), AdamState(count, mu, nu)


def adam(lr: float) -> Adam:
    """``optax.adam(lr)`` with its defaults."""
    return Adam(lr=lr)


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float

    def init(self, params: Any) -> tuple:
        del params
        return ()

    def update(self, grads: Any, state: tuple,
               params: Any = None) -> tuple[Any, tuple]:
        del params
        neg_lr = -float(np.float32(self.lr))
        return tree_map(lambda g: g * neg_lr, grads), state


def sgd(lr: float) -> SGD:
    """``optax.sgd(lr)`` with its defaults (no momentum)."""
    return SGD(lr=lr)


def apply_updates(params: Any, updates: Any) -> Any:
    """params + updates, leaf-wise, in each param's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
