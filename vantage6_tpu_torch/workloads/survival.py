"""Federated survival analysis: Kaplan-Meier + Cox proportional hazards.

Parity targets (SURVEY.md §2 item 28, BASELINE.md workloads 4-5): IKNL's
v6-kaplan-meier-py and federated Cox (WebDISCO-style — Lu et al., the
federated Cox used in the vantage6 ecosystem). Stations never share rows;
they share per-time-grid aggregate statistics, which a sum over the
station axis combines. All device-mode computations use a FIXED global time
grid so shapes stay static across stations; the grid is exchanged up front
exactly like the reference's shared event-time lists (same privacy
tradeoff, stated rather than hidden).

Math (Breslow ties):
- KM: S(t) = prod_{t_k <= t} (1 - d_k / n_k), d_k events at t_k, n_k at risk.
- Cox partial-likelihood score/Hessian per distinct event time t_k with
  S0 = sum_{at risk} w, S1 = sum x w, S2 = sum x x^T w, w = exp(x beta):
  g = sum_k [ s_k - d_k S1_k/S0_k ],
  H = -sum_k d_k [ S2_k/S0_k - (S1_k/S0_k)(S1_k/S0_k)^T ],
  with s_k = sum of covariates of events at t_k. Newton: beta -= H^{-1} g.

Counterpart of ``vantage6_tpu/workloads/survival.py``, its Paillier KM
(``partial_km_counts_paillier``, ``central_kaplan_meier_paillier``,
``decrypt_km``: host big-integer crypto through the port's
``common/paillier.py``) included. The risk-set sums are products against the ``[K, n]`` at-risk weights, so
the ``[K, n, d]`` einsum intermediate of S2 is never built: S2 is one
product with the rows' outer products ``[n, d*d]``. Host partials that
compute with tensors take a port-only ``device=`` (the JAX ones compute on
JAX's default device, the accelerator), which the centrals fill with the
federation's card. Secure KM masks with the port's ``secure_sum`` (an int
key; ``fold_in`` for the second).
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
from vantage6_tpu_torch.fed.collectives import fed_sum, fold_in, secure_sum
from vantage6_tpu_torch.workloads._columns import column, columns


# =========================================================== Kaplan-Meier
@data(1)
def partial_km_counts(df: Any, time_col: str, event_col: str,
                      grid: list[float]) -> dict[str, Any]:
    """Host mode: per-grid-time event and at-risk counts for this station."""
    t = column(df, time_col, np.float64)
    e = column(df, event_col, np.float64)
    g = np.asarray(grid, np.float64)
    events = ((t[None, :] == g[:, None]) * e[None, :]).sum(axis=1)
    at_risk = (t[None, :] >= g[:, None]).sum(axis=1).astype(np.float64)
    return {"events": events, "at_risk": at_risk}


@data(1)
def get_unique_event_times(df: Any, time_col: str, event_col: str) -> list:
    """Host mode: this station's distinct event times (the reference's KM
    shares these; documented privacy tradeoff)."""
    t = column(df, time_col, np.float64)
    e = column(df, event_col).astype(bool)
    return sorted(set(t[e].tolist()))


@algorithm_client
def central_kaplan_meier(client: Any, time_col: str, event_col: str,
                         organizations=None) -> dict[str, Any]:
    """Reference-shaped central KM: union event-time grid, then counts."""
    orgs = organizations or [o["id"] for o in client.organization.list()]
    t1 = client.task.create(
        input_={"method": "get_unique_event_times",
                "kwargs": {"time_col": time_col, "event_col": event_col}},
        organizations=orgs,
    )
    times = sorted({t for r in client.wait_for_results(t1["id"]) for t in r})
    t2 = client.task.create(
        input_={"method": "partial_km_counts",
                "kwargs": {"time_col": time_col, "event_col": event_col,
                           "grid": times}},
        organizations=orgs,
    )
    results = client.wait_for_results(t2["id"])
    events = np.sum([r["events"] for r in results], axis=0)
    at_risk = np.sum([r["at_risk"] for r in results], axis=0)
    surv = np.cumprod(1.0 - np.divide(events, at_risk,
                                      out=np.zeros_like(events),
                                      where=at_risk > 0))
    return {"time": list(times), "survival": surv.tolist(),
            "events": events.tolist(), "at_risk": at_risk.tolist()}


def _valid(n: int, count: torch.Tensor, device: Any) -> torch.Tensor:
    return (torch.arange(n, device=device) < count).to(torch.float32)


@device_step
def partial_km_device(data_: Any, grid: Any) -> dict[str, Any]:
    """Device mode: [K] event/at-risk counts on a fixed grid; padded rows
    masked. data_ = {"time": [n], "event": [n], "count": []}. Each count
    is a product of a 0/1 ``[K, n]`` matrix with a row vector: f32 sums of
    integers below 2^24, exact in any order."""
    t, e, count = data_["time"], data_["event"], data_["count"]
    valid = _valid(t.shape[0], count, t.device)
    g = torch.as_tensor(grid, dtype=torch.float32, device=t.device)
    events = (t[None, :] == g[:, None]).to(torch.float32) @ (e * valid)
    at_risk = (t[None, :] >= g[:, None]).to(torch.float32) @ valid
    return {"events": events, "at_risk": at_risk}


def km_from_counts(events: torch.Tensor,
                   at_risk: torch.Tensor) -> torch.Tensor:
    frac = torch.where(at_risk > 0,
                       events / torch.clamp(at_risk, min=1.0),
                       torch.zeros_like(events))
    return torch.cumprod(1.0 - frac, dim=0)


def kaplan_meier_device(
    federation: Any,
    grid: np.ndarray,
    secure: bool = False,
    key: int | None = None,
) -> dict[str, Any]:
    """Drive device-mode KM; `secure=True` routes counts through the
    additive-masking secure sum (BASELINE workload 5's aggregation mode)
    under the 64-bit int ``key``."""
    from vantage6_tpu_torch.algorithm.client import AlgorithmClient

    client = AlgorithmClient(federation, image="survival")
    task = client.task.create(
        input_={"method": "partial_km_device",
                "kwargs": {"grid": [float(t) for t in grid]}},
        organizations=federation.organization_ids(),
    )
    stacked, mask = client.wait_for_stacked_result(task["id"])
    if secure:
        if key is None:
            raise ValueError(
                "secure=True requires an explicit masking key — a default "
                "constant key would make the masks trivially strippable "
                "(see docs/THREAT_MODEL.md)"
            )
        events = secure_sum(stacked["events"], key, scale=2.0**8, mask=mask)
        at_risk = secure_sum(stacked["at_risk"], fold_in(key, 1),
                             scale=2.0**8, mask=mask)
    else:
        events = fed_sum(stacked["events"], mask=mask)
        at_risk = fed_sum(stacked["at_risk"], mask=mask)
    surv = km_from_counts(events, at_risk)
    return {"time": np.asarray(grid), "survival": surv.cpu().numpy(),
            "events": events.cpu().numpy(),
            "at_risk": at_risk.cpu().numpy()}


# ================================================================= Cox PH
def _cox_station_stats(x, t, e, valid, beta, grid):
    """[K]-grid risk-set statistics for one station at coefficients beta.

    ``rw`` is the ``[K, n]`` at-risk weight matrix ``r_ki w_i``; S0, S1 and
    S2 are its products with 1, x and the rows' outer products, and the
    event sums are products of the ``[K, n]`` event matrix."""
    w = torch.exp(x @ beta) * valid
    g = torch.as_tensor(grid, dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    rw = torch.where(t[None, :] >= g[:, None], w[None, :], zero)  # [K, n]
    ev_at = torch.where(t[None, :] == g[:, None], (e * valid)[None, :],
                        zero)                                     # [K, n]
    n, d = x.shape
    outer = (x[:, :, None] * x[:, None, :]).reshape(n, d * d)
    return {
        "s0": torch.sum(rw, dim=1),                           # [K]
        "s1": rw @ x,                                         # [K, d]
        "s2": (rw @ outer).reshape(-1, d, d),                 # [K, d, d]
        "d": torch.sum(ev_at, dim=1),                         # [K]
        "s": ev_at @ x,                                       # [K, d]
    }


@device_step
def partial_cox_stats(data_: Any, beta: Any, grid: Any) -> dict[str, Any]:
    """Device mode: per-station Cox risk-set statistics (WebDISCO payload).

    data_ = {"x": [n,d], "time": [n], "event": [n], "count": []}.
    """
    x, t, e, count = data_["x"], data_["time"], data_["event"], data_["count"]
    valid = _valid(t.shape[0], count, t.device)
    return _cox_station_stats(x, t, e.to(torch.float32), valid,
                              torch.as_tensor(beta, device=x.device), grid)


def cox_newton_update(agg: dict[str, torch.Tensor], beta: torch.Tensor,
                      ridge: float = 1e-6):
    """One Newton-Raphson step from aggregated risk-set statistics."""
    s0 = torch.clamp(agg["s0"], min=1e-12)
    mean = agg["s1"] / s0[:, None]                       # [K, d]
    grad = torch.sum(agg["s"] - agg["d"][:, None] * mean, dim=0)
    cov = agg["s2"] / s0[:, None, None] - mean[:, :, None] * mean[:, None, :]
    hess = -torch.sum(agg["d"][:, None, None] * cov, dim=0)
    hess = hess - ridge * torch.eye(beta.shape[0], dtype=beta.dtype,
                                    device=beta.device)
    new_beta = beta - torch.linalg.solve(hess, grad)
    return new_beta, grad


def fit_cox_device(
    federation: Any,
    n_features: int,
    grid: np.ndarray,
    n_iter: int = 10,
) -> dict[str, Any]:
    """Federated Cox via Newton-Raphson; per-iteration payload is the
    aggregated [K]-grid statistics, reduced on the card."""
    from vantage6_tpu_torch.algorithm.client import AlgorithmClient

    if n_iter < 1:
        raise ValueError("n_iter must be >= 1")
    client = AlgorithmClient(federation, image="survival")
    beta = torch.zeros((n_features,), device=client.device)
    grid_l = [float(t) for t in grid]
    last_grad = None
    for _ in range(n_iter):
        task = client.task.create(
            input_={"method": "partial_cox_stats",
                    "kwargs": {"beta": beta, "grid": grid_l}},
            organizations=federation.organization_ids(),
        )
        stacked, mask = client.wait_for_stacked_result(task["id"])
        agg = {k: fed_sum(v, mask=mask) for k, v in stacked.items()}
        beta, last_grad = cox_newton_update(agg, beta)
    return {"beta": beta.cpu().numpy(),
            "grad_norm": float(torch.linalg.norm(last_grad))}


# ------------------------------------------------- host-mode Cox (parity)
@data(1)
def partial_cox_stats_host(df: Any, beta: list[float], grid: list[float],
                           feature_cols: list[str], time_col: str,
                           event_col: str, device: Any = None
                           ) -> dict[str, Any]:
    """Host mode: the same statistics from a frame, computed in f32 on
    ``device``; numpy out."""
    dev = resolve_device(device)
    x = torch.from_numpy(columns(df, feature_cols, np.float32)).to(dev)
    t = torch.from_numpy(column(df, time_col, np.float32)).to(dev)
    e = torch.from_numpy(column(df, event_col, np.float32)).to(dev)
    out = _cox_station_stats(x, t, e, torch.ones_like(t),
                             torch.as_tensor(beta, dtype=torch.float32,
                                             device=dev), grid)
    return {k: v.cpu().numpy() for k, v in out.items()}


@algorithm_client
def central_cox(client: Any, feature_cols: list[str], time_col: str,
                event_col: str, n_iter: int = 10,
                organizations=None) -> dict[str, Any]:
    """Reference-shaped central Cox: share event-time grid, iterate Newton
    (the update in f32 on the federation's card, as the reference's on
    JAX's default device)."""
    if n_iter < 1:
        raise ValueError("n_iter must be >= 1")
    orgs = organizations or [o["id"] for o in client.organization.list()]
    dev = client.device
    t1 = client.task.create(
        input_={"method": "get_unique_event_times",
                "kwargs": {"time_col": time_col, "event_col": event_col}},
        organizations=orgs,
    )
    grid = sorted({t for r in client.wait_for_results(t1["id"]) for t in r})
    beta = np.zeros(len(feature_cols), np.float32)
    for _ in range(n_iter):
        task = client.task.create(
            input_={"method": "partial_cox_stats_host",
                    "kwargs": {"beta": beta.tolist(), "grid": grid,
                               "feature_cols": feature_cols,
                               "time_col": time_col,
                               "event_col": event_col,
                               "device": str(dev)}},
            organizations=orgs,
        )
        results = client.wait_for_results(task["id"])
        agg = {
            k: torch.from_numpy(
                np.sum([np.asarray(r[k]) for r in results], axis=0)).to(dev)
            for k in ("s0", "s1", "s2", "d", "s")
        }
        new_beta, grad = cox_newton_update(agg, torch.from_numpy(beta).to(
            dev))
        beta = new_beta.cpu().numpy()
    return {"beta": beta.tolist(), "event_times": grid,
            "grad_norm": float(torch.linalg.norm(grad))}


# ===================================== Kaplan-Meier under Paillier encryption
# The classical untrusted-server secure-sum (BASELINE.md ladder item 5;
# common.paillier): the RESEARCHER generates the keypair and puts only the
# public key in the task input; every station encrypts its per-grid
# (events, at-risk) counts; the central step adds CIPHERTEXTS
# homomorphically and returns the still-encrypted aggregate. Neither the
# central node, the server, nor the relay ever see any count — only the
# researcher, holding the private key, decrypts the pooled curve
# (`decrypt_km` below, run client-side).


@data(1)
def partial_km_counts_paillier(
    df: Any,
    time_col: str,
    event_col: str,
    grid: list[float],
    public_key_n: str,
) -> dict[str, Any]:
    """This station's KM counts, Paillier-encrypted under the researcher's
    public key (hex modulus). Ciphertexts travel as hex strings (python
    bigints; JSON-safe)."""
    from vantage6_tpu_torch.common import paillier

    pk = paillier.PublicKey(int(public_key_n, 16))
    # the COUNTING rule lives in one place: the plain KM partial
    counts = partial_km_counts.plain(df, time_col, event_col, grid)
    return {
        "events_ct": [
            hex(pk.encrypt(int(v))) for v in counts["events"].astype(int)
        ],
        "at_risk_ct": [
            hex(pk.encrypt(int(v))) for v in counts["at_risk"].astype(int)
        ],
    }


@algorithm_client
def central_kaplan_meier_paillier(
    client: Any,
    time_col: str,
    event_col: str,
    grid: list[float],
    public_key_n: str,
    organizations: list[int] | None = None,
) -> dict[str, Any]:
    """Homomorphic aggregation: the central step sums CIPHERTEXTS and
    returns the encrypted pooled counts — it cannot read them."""
    from vantage6_tpu_torch.common import paillier

    pk = paillier.PublicKey(int(public_key_n, 16))
    orgs = organizations or [o["id"] for o in client.organization.list()]
    task = client.task.create(
        input_={
            "method": "partial_km_counts_paillier",
            "kwargs": {
                "time_col": time_col,
                "event_col": event_col,
                "grid": grid,
                "public_key_n": public_key_n,
            },
        },
        organizations=orgs,
        name="km_paillier_partial",
    )
    parts = client.wait_for_results(task_id=task["id"])
    events_ct = [int(c, 16) for c in parts[0]["events_ct"]]
    at_risk_ct = [int(c, 16) for c in parts[0]["at_risk_ct"]]
    for part in parts[1:]:
        events_ct = pk.add_vectors(
            events_ct, [int(c, 16) for c in part["events_ct"]]
        )
        at_risk_ct = pk.add_vectors(
            at_risk_ct, [int(c, 16) for c in part["at_risk_ct"]]
        )
    return {
        "events_ct": [hex(c) for c in events_ct],
        "at_risk_ct": [hex(c) for c in at_risk_ct],
        "grid": [float(v) for v in grid],
        "n_parties": len(orgs),
    }


def decrypt_km(private_key: Any, result: dict[str, Any]) -> dict[str, Any]:
    """RESEARCHER-side: decrypt the pooled counts and build the KM curve.

    ``private_key`` is the common.paillier.PrivateKey whose public half the
    task carried; never send it anywhere.
    """
    events = np.asarray(
        private_key.decrypt_vector(
            int(c, 16) for c in result["events_ct"]
        ),
        np.float64,
    )
    at_risk = np.asarray(
        private_key.decrypt_vector(
            int(c, 16) for c in result["at_risk_ct"]
        ),
        np.float64,
    )
    surv = np.cumprod(
        1.0 - np.divide(events, np.maximum(at_risk, 1.0))
    )
    return {
        "grid": result["grid"],
        "events": events.tolist(),
        "at_risk": at_risk.tolist(),
        "survival": surv.tolist(),
    }
