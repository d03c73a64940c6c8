"""FedAvg 2-layer CNN on one GPU — the flagship workload.

Counterpart of ``vantage6_tpu/workloads/fedavg_mnist.py``'s direct-engine
path: ``make_engine`` builds the FedAvg engine over the CNN,
``make_federated_data`` makes MNIST-shaped data (real MNIST when a local
copy exists, synthetic templates otherwise) split Dirichlet non-iid across
stations, ``train_fedavg`` runs the fused rounds and ``evaluate`` scores a
model. ``params_from_jax``/``params_to_numpy`` move the CNN's weights
across; the layouts are the same, so they are plain copies.

The reference-shaped ``partial_train``/``central_fedavg`` need the
algorithm runtime and are not ported yet (ROADMAP.md queue 1 item 9).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from vantage6_tpu_torch._tree import tree_map
from vantage6_tpu_torch.core.mesh import FederationMesh, resolve_device
from vantage6_tpu_torch.fed.fedavg import FedAvg, FedAvgSpec
from vantage6_tpu_torch.models.cnn import CNN, accuracy
from vantage6_tpu_torch.utils.datasets import (
    image_classes,
    pad_shards,
    partition_dirichlet,
)

MODEL = CNN()


def weighted_ce_loss(params, bx, by, w):
    """Per-example-weighted cross entropy (FedAvgSpec.loss_fn signature)."""
    logits = MODEL(params, bx)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, by.long()[:, None])[:, 0]
    return torch.sum(nll * w) / torch.clamp_min(torch.sum(w), 1.0)


def init_params(generator: torch.Generator | int,
                image_shape: tuple[int, int, int] = (28, 28, 1),
                device: str | torch.device | None = None) -> Any:
    """The CNN's float32 parameters from ``generator`` (a CPU generator, or
    a seed), with flax's default initialisers, on ``device`` (CUDA unless
    ``"cpu"`` is asked for). The draws are made on the CPU, so a seed gives
    the same weights on every device."""
    device = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    return tree_map(lambda x: x.to(device),
                    MODEL.init(generator, image_shape))


def params_from_jax(tree: Any, device: str | torch.device) -> Any:
    """A JAX CNN parameter tree (of numpy or jax arrays) as float32 tensors
    on ``device``: same names and layouts, no transposes."""
    return tree_map(
        lambda x: torch.from_numpy(np.array(x, np.float32)).to(device), tree
    )


def params_to_numpy(params: Any) -> Any:
    """The parameter tree as float32 numpy arrays (for JAX, or a file)."""
    return tree_map(lambda x: x.detach().float().cpu().numpy(), params)


# ------------------------------------------------------------ direct engine
def make_engine(
    mesh: FederationMesh | None = None,
    local_steps: int = 10,
    batch_size: int = 32,
    local_lr: float = 0.05,
    server_optimizer: Any = None,
    shard_server_update: bool = False,
    comm_dtype: torch.dtype | None = None,
    compressor: Any = None,
    learning_stats: bool = True,
    local_unroll: int | bool = 1,
    n_stations: int = 32,
    device: str | torch.device | None = None,
) -> FedAvg:
    """The FedAvg-CNN engine on ``mesh`` (default: a ``FederationMesh`` of
    ``n_stations`` on ``device``, CUDA unless ``"cpu"`` is asked for)."""
    if mesh is None:
        mesh = FederationMesh(n_stations, device=device)
    return FedAvg(
        mesh,
        FedAvgSpec(
            loss_fn=weighted_ce_loss,
            local_steps=local_steps,
            batch_size=batch_size,
            local_lr=local_lr,
            server_optimizer=server_optimizer,
            shard_server_update=shard_server_update,
            comm_dtype=comm_dtype,
            compressor=compressor,
            learning_stats=learning_stats,
            local_unroll=local_unroll,
        ),
    )


def make_federated_data(
    n_stations: int,
    n_per_station: int = 256,
    alpha: float = 0.5,
    seed: int = 0,
    mesh: FederationMesh | None = None,
    noise: float = 0.7,
):
    """(x [S, n_max, 28, 28, 1], y [S, n_max], counts [S]) as tensors:
    Dirichlet non-iid across stations, padded and stacked, on the mesh's
    device when a mesh is given. The same shards as the JAX package's for
    the same arguments."""
    x, y = image_classes(n_stations * n_per_station, seed=seed, noise=noise)
    shards = partition_dirichlet(x, y, n_stations, alpha=alpha, seed=seed)
    sx, sy, counts = (torch.from_numpy(a) for a in pad_shards(shards))
    if mesh is not None:
        sx, sy, counts = mesh.shard_stacked((sx, sy, counts))
    return sx, sy, counts


def train_fedavg(
    mesh: FederationMesh,
    n_rounds: int = 20,
    seed: int = 0,
    **engine_kw: Any,
):
    """End-to-end training on synthetic data; returns (params, losses).
    Parameters come from a CPU generator seeded ``seed``, batch indices from
    a device generator seeded ``seed + 1``."""
    engine = make_engine(mesh, **engine_kw)
    sx, sy, counts = make_federated_data(mesh.n_stations, mesh=mesh)
    params = init_params(seed, device=mesh.device)
    params, _, losses, _ = engine.run_rounds(
        params, sx, sy, counts, seed + 1, n_rounds
    )
    return params, losses


def evaluate(params: Any, x: Any, y: Any) -> float:
    """Accuracy of the CNN with ``params`` on (x, y), on the params'
    device."""
    device = params["Dense_1"]["kernel"].device
    with torch.no_grad():
        logits = MODEL(params, torch.as_tensor(x, device=device))
        return float(accuracy(logits, torch.as_tensor(y, device=device)))
