"""Federated generalized linear models (IRLS).

Counterpart of ``vantage6_tpu/workloads/glm.py``. In the device mode, every
iteration, each station computes the sufficient statistics of the weighted
least-squares step on its own rows (``X'WX``, ``X'Wz`` and its deviance)
under ``fed_map``, one cross-station sum, and a ``p x p`` solve. The
statistics are additive over rows, so the federated fit is pooled IRLS.
Families: gaussian (identity link), binomial (logit), poisson (log).

Everything runs in the inputs' dtype: float64 designs fit in float64 on
the card. ``xlogy`` and the solve are library calls (``torch.special``,
``torch.linalg``), as they are ``jnp`` calls in the JAX package. Each
``fit_glm_device`` call is one observed dispatch under the reference's
label, ``glm.irls.{family}`` (``runtime/profiling.py``). The JAX package
caches one compiled IRLS program per mesh, family and ``n_iter``
(``RunnerCache``); eager torch compiles nothing, so there is no cache.

The host mode is the reference's task shape: ``partial_glm_stats`` computes
a station's ``X'WX``, ``X'Wz``, deviance and count in float64 on a card (a
port-only ``device=``; the reference computes it under ``enable_x64`` on
JAX's default device), ``central_glm`` sums them, solves in numpy and
reports standard errors, dispersion and convergence.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from vantage6_tpu_torch.algorithm.decorators import algorithm_client, data
from vantage6_tpu_torch.core.mesh import FederationMesh, resolve_device
from vantage6_tpu_torch.fed.collectives import fed_sum
from vantage6_tpu_torch.runtime.profiling import observed_jit
from vantage6_tpu_torch.utils.datasets import pad_shards
from vantage6_tpu_torch.workloads._columns import column, columns

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


def _design(frame: Any, feature_cols: list[str]) -> np.ndarray:
    """``[n, p+1]`` design matrix with a leading intercept column, from
    any mapping of column name to array (at least one feature)."""
    if not feature_cols:
        raise ValueError("the design needs at least one feature column")
    x = columns(frame, feature_cols, np.float64)
    return np.concatenate([np.ones((x.shape[0], 1)), x], axis=1)


# ----------------------------------------------------------------- host mode
@data(1)
def partial_glm_stats(
    df: Any,
    beta: list[float],
    family: str,
    feature_cols: list[str],
    label_col: str,
    weight_col: str | None = None,
    device: Any = None,
) -> dict[str, Any]:
    """One IRLS step's sufficient statistics on this station's rows, in
    float64 on ``device`` (CUDA unless ``"cpu"`` is asked for).

    Returns X'WX [p,p], X'Wz [p], the station's deviance contribution and
    row count — additive aggregates; never rows.
    """
    _check_family(family)
    dev = resolve_device(device)
    x = torch.from_numpy(_design(df, feature_cols)).to(dev)
    y = torch.from_numpy(column(df, label_col, np.float64)).to(dev)
    wts = (torch.from_numpy(column(df, weight_col, np.float64)).to(dev)
           if weight_col else torch.ones_like(y))
    b = torch.as_tensor(np.asarray(beta, np.float64), device=dev)
    _, z, w, dev_rows = _irls_pieces(family, x @ b, y, wts)
    xw = x * w[:, None]
    return {
        "xtwx": (x.T @ xw).cpu().numpy(),
        "xtwz": (xw.T @ z).cpu().numpy(),
        "deviance": float(torch.sum(dev_rows)),
        "count": int(y.shape[0]),
    }


@algorithm_client
def central_glm(
    client: Any,
    family: str,
    feature_cols: list[str],
    label_col: str,
    weight_col: str | None = None,
    n_iter: int = 25,
    tol: float = 1e-8,
    organizations: list[int] | None = None,
) -> dict[str, Any]:
    """Federated IRLS to convergence — identical to pooled IRLS.

    Returns coefficients (intercept first), standard errors (from the
    inverse Fisher information at the optimum; gaussian dispersion is
    estimated as deviance/(n-p), binomial/poisson use dispersion 1 like
    the reference), final deviance, iteration count and convergence flag.
    The stations compute on the federation's card.
    """
    _check_family(family)
    if n_iter < 1:
        raise ValueError("n_iter must be >= 1")
    orgs = organizations or [o["id"] for o in client.organization.list()]
    p = len(feature_cols) + 1
    beta = np.zeros(p, np.float64)
    deviance = float("inf")
    converged = False
    it = 0
    kwargs_base = {
        "family": family,
        "feature_cols": feature_cols,
        "label_col": label_col,
        "weight_col": weight_col,
        "device": str(client.device),
    }
    for it in range(1, n_iter + 1):
        task = client.task.create(
            input_={
                "method": "partial_glm_stats",
                "kwargs": {**kwargs_base, "beta": [float(v) for v in beta]},
            },
            organizations=orgs,
            name=f"glm_irls_{it}",
        )
        parts = client.wait_for_results(task_id=task["id"])
        xtwx = np.sum([np.asarray(r["xtwx"]) for r in parts], axis=0)
        xtwz = np.sum([np.asarray(r["xtwz"]) for r in parts], axis=0)
        deviance = float(np.sum([r["deviance"] for r in parts]))
        count = int(np.sum([r["count"] for r in parts]))
        new_beta = np.linalg.solve(xtwx + _JITTER * np.eye(p), xtwz)
        delta = float(np.max(np.abs(new_beta - beta)))
        beta = new_beta
        if delta < tol:
            converged = True
            break
    # standard errors at the optimum (one more stats round would refresh
    # XtWX at the final beta; the last iteration's is the standard report)
    cov = np.linalg.inv(xtwx + _JITTER * np.eye(p))
    dispersion = (
        deviance / max(count - p, 1) if family == "gaussian" else 1.0
    )
    se = np.sqrt(np.clip(np.diag(cov) * dispersion, 0.0, None))
    return {
        "coefficients": [float(v) for v in beta],
        "std_errors": [float(v) for v in se],
        "deviance": deviance,
        "dispersion": float(dispersion),
        "iterations": it,
        "converged": converged,
        "count": count,
        "family": family,
        "columns": ["(intercept)", *feature_cols],
    }


# --------------------------------------------------------------- device mode
def _irls(family: str, mesh: FederationMesh, sx: torch.Tensor,
          sy: torch.Tensor, m: torch.Tensor, n_iter: int):
    """``n_iter`` IRLS iterations from zero: (beta, deltas, deviances)."""
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
    return beta, torch.stack(deltas), torch.stack(devs)


#: one observed IRLS a family, under the reference's labels
_IRLS = {family: observed_jit(f"glm.irls.{family}",
                              functools.partial(_irls, family),
                              static_argnames=("n_iter",))
         for family in FAMILIES}


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
    beta, deltas, devs = _IRLS[family](mesh, sx, sy, m, n_iter=n_iter)
    return {"beta": beta, "deltas": deltas, "deviances": devs}


def stack_glm_data(
    frames: list[Any], feature_cols: list[str], label_col: str
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-station columns -> padded stacked float64 (designs [S, n_max,
    p+1], labels [S, n_max], row mask [S, n_max])."""
    shards = [(_design(f, feature_cols), column(f, label_col, np.float64))
              for f in frames]
    sx, sy, counts = pad_shards(shards)
    n_max = sx.shape[1]
    mask = (np.arange(n_max)[None, :] < counts[:, None]).astype(np.float64)
    return sx, sy, mask
