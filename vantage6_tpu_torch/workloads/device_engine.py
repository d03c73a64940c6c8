"""Device-engine workloads: tasks that run as ONE collective program over
the federation's process group, one station per process.

Counterpart of ``vantage6_tpu/workloads/device_engine.py``. Every member
process (a node daemon, in a deployment) is one rank of a
``torch.distributed`` process group (``core.distributed``) and runs the
SAME method. Inside, the method builds the global ``FederationMesh`` (one
station per process), contributes ONLY its own station's rows through
``stack_local_shards`` (no process ever holds another's data), and the
cross-station reduction is an explicit collective over the group (NCCL
between cards, gloo on the CPU). Every process returns the identical
replicated aggregate.

Contrast with the "process" engine (``workloads/average.py``): there a
central method fans out one subtask per organization and aggregates
partial RESULTS on the host. Here there is no fan-out: a round is local
work on each rank and one collective.

Columns are read through ``workloads/_columns.py``, so a station's frame
may be a pandas DataFrame or a dict of numpy columns. The port's entry
points run on CUDA unless ``device="cpu"`` is asked for; once the process
has joined a group, the mesh runs on the rank's device. The daemon path
(``engine="device"`` tasks, ROADMAP.md queue 1, item 11.5) runs these
methods in a node daemon that joined the group; a ``Federation`` over the
group (``Federation(..., group=)``, item 12.5) runs its device-mode
partials over its ranks.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from vantage6_tpu_torch._tree import tree_map
from vantage6_tpu_torch.algorithm.decorators import data
from vantage6_tpu_torch.core import distributed as D
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed.collectives import (
    all_gather_stations,
    fed_mean_scattered_tree,
    fed_sum,
)
from vantage6_tpu_torch.runtime.profiling import RunnerCache, observed_jit
from vantage6_tpu_torch.workloads import _columns as C

# Marker read by the node runner: these methods must execute in the daemon
# process (a runner subprocess cannot reach the daemon's group membership).
DEVICE_ENGINE = True

# Runners keyed on mesh.fingerprint() + every value a runner bakes in as a
# closure (hyperparameters), FIFO-bounded, each lookup an engine-cache
# event and each call an observed dispatch (runtime.profiling). The mesh
# is an argument of the runner, not part of its closure: a process group
# destroyed and joined again gives an equal fingerprint and a new group.
_ENGINE_RUNNERS = RunnerCache("device_engine")


def _engine_runner(key: tuple, make):
    """Get-or-create an observed runner; ``make()`` builds the
    ObservedFunction on a miss."""
    return _ENGINE_RUNNERS.get_or_create(key, make)


def federation_mesh(device: str | torch.device | None = None
                    ) -> FederationMesh:
    """The global mesh with ONE STATION PER PROCESS.

    A rank drives one device, so each process's station slot is that one
    rank and ``local_stations(mesh) == [process_index]``. The reference
    checks that each daemon's devices divide evenly and enumerate
    contiguously; with one device a rank neither check can fail, so the
    port has neither."""
    return D.global_mesh(n_stations=D.process_count(), device=device)


def _contribute_column(
    mesh: FederationMesh, values: np.ndarray, pad_to: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """This process's column values as its station's ``[1, pad_to]`` block
    of the station-stacked data (zero-padded; the true length carried
    separately as ``[1, 1]``)."""
    values = np.asarray(values, np.float32)
    if values.size > pad_to:
        raise ValueError(
            f"station holds {values.size} rows > pad_to={pad_to}; raise the "
            "task's pad_to (it must be a static bound shared by all nodes)"
        )
    padded = np.zeros((pad_to,), np.float32)
    padded[: values.size] = values
    mine = D.local_stations(mesh)
    x = D.stack_local_shards(mesh, {s: padded for s in mine})
    n = D.stack_local_shards(
        mesh, {s: np.asarray([values.size], np.float32) for s in mine}
    )
    return x, n


def _column_total(mesh: FederationMesh, moments: torch.Tensor
                  ) -> torch.Tensor:
    return fed_sum(moments, mesh=mesh)


@data(1)
def device_column_stats(
    df: Any, column: str, pad_to: int = 4096,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Federated mean/std of one column as one collective program.

    Every member process runs this concurrently; the per-station moments
    are computed under ``fed_map`` (each station sees only its own shard)
    and the cross-station reduction is one all-reduce, so every process
    returns the identical replicated result. ``device`` places the mesh
    when the process has joined no group (CUDA unless ``"cpu"``).
    """
    mesh = federation_mesh(device)
    vals = np.asarray(C.dropna(C.column(df, column)), np.float32)
    x, n = _contribute_column(mesh, vals, pad_to)

    # zero padding is invisible to sum/sumsq; count comes from the true n
    moments = mesh.fed_map(
        lambda xv, nv: torch.stack([torch.sum(xv), torch.sum(xv * xv),
                                    nv[0]]),
        x, n, batched=True,
    )  # [S_local, 3]
    total = _engine_runner(
        ("column_total", mesh.fingerprint()),
        lambda: observed_jit("device_engine.column_total", _column_total),
    )(mesh, moments)
    t = total.cpu().numpy().astype(np.float64)
    mean = t[0] / t[2]
    var = max(t[1] / t[2] - mean * mean, 0.0)
    return {
        "mean": float(mean),
        "std": float(var**0.5),
        "count": int(t[2]),
        "n_stations": int(mesh.n_stations),
        "process_index": int(D.process_index()),
        "global_devices": D.process_count(),
    }


def _local_loss(params, xb, yb, mb):
    w, b = params
    logits = xb @ w + b
    # the reference's subgradients at logits == 0 (every row at the first
    # step from zero weights): jnp.maximum splits its gradient 0.5/0.5, as
    # torch.maximum does, and jnp.abs takes slope 1 there, where
    # torch.abs takes 0; so |x| is written as a where on x >= 0
    per_row = (
        torch.maximum(logits, torch.zeros_like(logits))
        - logits * yb
        + torch.log1p(torch.exp(-torch.where(logits >= 0, logits,
                                             -logits)))
    )
    return torch.sum(per_row * mb) / torch.clamp_min(torch.sum(mb), 1.0)


def _make_train(agg_mode: str, rounds: int, local_steps: int, lr: float):
    """The training program of ``device_logistic_fit``: ``rounds`` rounds
    of ``local_steps`` full-batch gradient steps on each station's rows
    (``fed_map``), each round merged by the row-count-weighted mean."""
    comm_dtype = torch.bfloat16 if agg_mode == "scattered_bf16" else None
    grad = torch.func.grad(_local_loss)

    def station_round(xb, yb, mb, params):
        p = params
        for _ in range(local_steps):
            g = grad(p, xb, yb, mb)
            p = tuple(a - lr * ga for a, ga in zip(p, g))
        return p, torch.sum(mb)

    def train(mesh, params, xs, ys, ms):
        for _ in range(rounds):
            locals_, counts = mesh.fed_map(station_round, xs, ys, ms,
                                           replicated_args=(params,),
                                           batched=True)
            if agg_mode != "replicated":
                # the global [S] weights, every slot's counts in order
                params = fed_mean_scattered_tree(
                    mesh, locals_, weights=all_gather_stations(mesh, counts),
                    comm_dtype=comm_dtype)
                continue
            total = torch.clamp_min(fed_sum(counts, mesh=mesh), 1.0)
            wv = counts / total
            params = fed_sum(tree_map(
                lambda leaf: wv.reshape((-1,) + (1,) * (leaf.ndim - 1))
                * leaf, locals_), mesh=mesh)
        return params

    return train


@data(1)
def device_logistic_fit(
    df: Any,
    feature_columns: list[str],
    label_column: str,
    rounds: int = 5,
    local_steps: int = 4,
    batch_rows: int = 64,
    lr: float = 0.5,
    agg_mode: str = "replicated",
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Federated logistic regression TRAINED as collective rounds.

    Each round: every station takes ``local_steps`` full-batch gradient
    steps on its OWN rows under ``fed_map`` (gradient isolation), then the
    models are combined by row-count-weighted mean through one collective.
    The reference's ``lax.scan`` over rounds is a plain loop.

    ``batch_rows`` is the static per-station row bound (row padding is
    masked out of loss and gradients).

    ``agg_mode`` selects the cross-station merge: ``"replicated"`` (the
    weighted local sum, all-reduced), ``"scattered"`` (reduce-scatter +
    all-gather, ``fed_mean_scattered_tree``), or ``"scattered_bf16"``
    (the same with the model exchange narrowed to bf16 on the wire).
    """
    if agg_mode not in ("replicated", "scattered", "scattered_bf16"):
        raise ValueError(f"unknown agg_mode {agg_mode!r}")
    mesh = federation_mesh(device)
    feats = C.columns(df, list(feature_columns), np.float32)
    labels = C.column(df, label_column, np.float32)
    n_rows, n_feat = feats.shape
    if n_rows > batch_rows:
        raise ValueError(
            f"station holds {n_rows} rows > batch_rows={batch_rows}; raise "
            "the task's batch_rows (static bound shared by all nodes)"
        )
    fx = np.zeros((batch_rows, n_feat), np.float32)
    fx[:n_rows] = feats
    fy = np.zeros((batch_rows,), np.float32)
    fy[:n_rows] = labels
    mask = np.zeros((batch_rows,), np.float32)
    mask[:n_rows] = 1.0

    mine = D.local_stations(mesh)
    sx = D.stack_local_shards(mesh, {s: fx for s in mine})
    sy = D.stack_local_shards(mesh, {s: fy for s in mine})
    sm = D.stack_local_shards(mesh, {s: mask for s in mine})
    params0 = (torch.zeros((n_feat,), dtype=torch.float32, device=mesh.device),
               torch.zeros((), dtype=torch.float32, device=mesh.device))

    # every value the program bakes in joins the cache key; shapes
    # (n_feat, batch_rows) ride the observed signature instead
    train = _engine_runner(
        ("logistic_train", mesh.fingerprint(), agg_mode, rounds,
         local_steps, lr),
        lambda: observed_jit("device_engine.logistic_train",
                             _make_train(agg_mode, rounds, local_steps, lr)),
    )
    with torch.no_grad():
        w, b = train(mesh, params0, sx, sy, sm)
    w = w.cpu().numpy()
    b = float(b)
    # accuracy on the LOCAL rows only — evaluation never crosses stations
    logits = feats @ w + b
    acc = float(np.mean((logits > 0).astype(np.float32) == labels)) \
        if n_rows else 0.0
    return {
        "weights": [float(v) for v in w],
        "bias": b,
        "local_accuracy": acc,
        "local_rows": int(n_rows),
        "n_stations": int(mesh.n_stations),
        "process_index": int(D.process_index()),
        "agg_mode": agg_mode,
    }
