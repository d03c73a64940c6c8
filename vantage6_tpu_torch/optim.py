"""Functional Adam with the state and arithmetic of ``optax.adam(lr)``.

The JAX transformer engine steps its server model with ``optax.adam``; this
is the same transform on tensor pytrees: ``b1=0.9``, ``b2=0.999``,
``eps=1e-8``, ``eps_root=0``, state ``(count, mu, nu)``, and the update
``-lr * mu_hat / (sqrt(nu_hat) + eps)`` with the bias
corrections ``1 - b**count`` taken in float32.
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
        c1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
        neg_lr = -float(np.float32(self.lr))

        def step(m, v):
            m_hat = m / torch.tensor(c1, dtype=m.dtype)
            v_hat = v / torch.tensor(c2, dtype=v.dtype)
            u = m_hat / (torch.sqrt(v_hat) + EPS)
            return torch.tensor(neg_lr, dtype=u.dtype) * u

        return tree_map(step, mu, nu), AdamState(count, mu, nu)


def adam(lr: float) -> Adam:
    """``optax.adam(lr)`` with its defaults."""
    return Adam(lr=lr)


def apply_updates(params: Any, updates: Any) -> Any:
    """params + updates, leaf-wise, in each param's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
