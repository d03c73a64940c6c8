"""Federated generalized linear models on the device (IRLS).

Counterpart of the device half of ``vantage6_tpu/workloads/glm.py``: every
iteration, each station computes the sufficient statistics of the weighted
least-squares step on its own rows (``X'WX``, ``X'Wz`` and its deviance)
under ``fed_map``, one cross-station sum, and a ``p x p`` solve. The
statistics are additive over rows, so the federated fit is pooled IRLS.
Families: gaussian (identity link), binomial (logit), poisson (log).

Everything runs in the inputs' dtype: float64 designs fit in float64 on
the card. ``xlogy`` and the solve are library calls (``torch.special``,
``torch.linalg``), as they are ``jnp`` calls in the JAX package.

The JAX package caches one compiled IRLS program per mesh, family and
``n_iter`` (``RunnerCache``); eager torch compiles nothing, so there is no
cache. Not ported yet: the host mode (``partial_glm_stats``,
``central_glm``), which drives tasks through the algorithm client
(ROADMAP.md queue 1 items 9 and 10).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed.collectives import fed_sum
from vantage6_tpu_torch.utils.datasets import pad_shards

FAMILIES = ("gaussian", "binomial", "poisson")
#: tiny ridge on X'WX: IRLS must not explode on separable/collinear data
_JITTER = 1e-8


def _check_family(family: str) -> str:
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r} (choose from {FAMILIES})")
    return family


def _irls_pieces(family: str, eta: torch.Tensor, y: torch.Tensor,
                 weights: torch.Tensor):
    """(mu, working response z, IRLS weight W, per-row deviance)."""
    xlogy = torch.special.xlogy  # 0 where x == 0
    if family == "gaussian":
        mu = eta
        z = y  # identity link: z = eta + (y - mu) = y
        w = weights
        dev = weights * (y - mu) ** 2
    elif family == "binomial":
        mu = torch.sigmoid(eta)
        dmu = mu * (1.0 - mu) + 1e-12
        z = eta + (y - mu) / dmu
        w = weights * dmu
        # binomial deviance, y in {0,1}: -2 log p(y)
        dev = 2.0 * weights * (
            xlogy(y, y / torch.clamp(mu, 1e-12, 1.0))
            + xlogy(1.0 - y, (1.0 - y) / torch.clamp(1.0 - mu, 1e-12, 1.0))
        )
    else:  # poisson
        # mu clipped away from 0/inf, so an unscaled covariate cannot carry
        # 0 * inf into X'Wz
        mu = torch.clamp(torch.exp(eta), 1e-8, 1e12)
        z = eta + (y - mu) / mu
        w = weights * mu
        dev = 2.0 * weights * (xlogy(y, y / mu) - (y - mu))
    return mu, z, w, dev


def _column(frame: Any, name: str) -> np.ndarray:
    return np.asarray(frame[name], np.float64)


def _design(frame: Any, feature_cols: list[str]) -> np.ndarray:
    """``[n, p+1]`` design matrix with a leading intercept column, from
    any mapping of column name to array (at least one feature)."""
    if not feature_cols:
        raise ValueError("the design needs at least one feature column")
    x = np.stack([_column(frame, c) for c in feature_cols], axis=1)
    return np.concatenate([np.ones((x.shape[0], 1)), x], axis=1)


def fit_glm_device(
    mesh: FederationMesh,
    sx: Any,        # [S, n_max, p] designs (pad rows with zeros)
    sy: Any,        # [S, n_max] labels (pad 0)
    row_mask: Any,  # [S, n_max] 1.0 for real rows
    family: str,
    n_iter: int = 25,
) -> dict[str, torch.Tensor]:
    """The whole federated IRLS, ``n_iter`` iterations on the device with
    no host sync. Returns ``{"beta" [p], "deltas" [n_iter] (max |step|),
    "deviances" [n_iter]}``; convergence is read off the deltas."""
    _check_family(family)
    sx = torch.as_tensor(sx, device=mesh.device)
    sy = torch.as_tensor(sy, device=mesh.device).to(sx.dtype)
    m = torch.as_tensor(row_mask, device=mesh.device).to(sx.dtype)
    p = sx.shape[-1]
    eye = _JITTER * torch.eye(p, dtype=sx.dtype, device=sx.device)

    def station_stats(x, y, mv, beta):
        _, z, w, dev = _irls_pieces(family, x @ beta, y, mv)
        # the row mask rides the IRLS weight: padded rows contribute zero
        xw = x * w[:, None]
        return x.T @ xw, xw.T @ z, torch.sum(dev)

    beta = torch.zeros(p, dtype=sx.dtype, device=sx.device)
    deltas, devs = [], []
    for _ in range(n_iter):
        xtwx, xtwz, dev = mesh.fed_map(station_stats, sx, sy, m,
                                       replicated_args=(beta,), batched=True)
        new_beta = torch.linalg.solve(fed_sum(xtwx) + eye, fed_sum(xtwz))
        deltas.append(torch.max(torch.abs(new_beta - beta)))
        devs.append(fed_sum(dev))
        beta = new_beta
    return {"beta": beta, "deltas": torch.stack(deltas),
            "deviances": torch.stack(devs)}


def stack_glm_data(
    frames: list[Any], feature_cols: list[str], label_col: str
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-station columns -> padded stacked float64 (designs [S, n_max,
    p+1], labels [S, n_max], row mask [S, n_max])."""
    shards = [(_design(f, feature_cols), _column(f, label_col))
              for f in frames]
    sx, sy, counts = pad_shards(shards)
    n_max = sx.shape[1]
    mask = (np.arange(n_max)[None, :] < counts[:, None]).astype(np.float64)
    return sx, sy, mask
