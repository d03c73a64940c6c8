"""Multi-process federation bootstrap on ``torch.distributed``.

Counterpart of ``vantage6_tpu/core/distributed.py``. There every host joins
the JAX coordination service and one ``FederationMesh`` spans every
process's devices. Here every process is one rank of a
``torch.distributed`` process group and drives one device (a CUDA card
under NCCL, or the CPU under gloo when the caller asks for it), and a
``FederationMesh`` built over the group spans the ranks: each rank holds
only its own stations' rows (``[S_local, ...]``) and every cross-station
reduction is an explicit collective over the group (``fed.collectives``).

Deployment contract, as in the reference: every process loads ONLY the
shards of the stations it hosts; ``stack_local_shards`` assembles them
without any process ever holding another process's rows.

With no configuration ``initialize()`` is a no-op and the same code runs on
the one-process mesh.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from vantage6_tpu_torch.core.mesh import FederationMesh, resolve_device

_log = logging.getLogger("vantage6_tpu_torch/distributed")

# the device this process's rank drives, set by initialize()
_rank_device: torch.device | None = None


def is_initialized() -> bool:
    """True once this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: Sequence[int] | None = None,
    auto: bool = False,
    device: str | torch.device | None = None,
) -> bool:
    """Join (or skip) the process group. Idempotent.

    Resolution order per field: explicit argument > environment
    (``V6T_COORDINATOR``, ``V6T_NUM_PROCESSES``, ``V6T_PROCESS_ID``). With
    NO configuration found the default is plain single-process local mode
    (returns False, no side effects). ``auto=True`` reads a launcher's
    environment instead (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, ``LOCAL_RANK``, as ``torchrun`` sets them) and raises
    if there is none, rather than silently running single-process (each
    host training a disjoint federation is the failure this guards
    against).

    ``coordinator_address`` is ``"host:port"`` (a TCP rendezvous at that
    address) or a URL that ``init_process_group`` takes as it is
    (``"file:///path"``, ``"tcp://host:port"``). The backend follows the
    rank's device: NCCL on a CUDA card (``local_device_ids[0]``, else
    ``LOCAL_RANK``, else the current card), gloo when ``device="cpu"`` is
    asked for. Without a CUDA device and without ``device="cpu"`` it
    raises, as every entry point of the port does.

    Returns True when running multi-process (world size > 1), False for
    single-process; a world of one rank is still a process group.
    """
    global _rank_device
    if is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "V6T_COORDINATOR"
    )
    if num_processes is None and os.environ.get("V6T_NUM_PROCESSES"):
        num_processes = int(os.environ["V6T_NUM_PROCESSES"])
    if process_id is None and os.environ.get("V6T_PROCESS_ID"):
        process_id = int(os.environ["V6T_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        if not auto:
            # single-process mode: nothing to join
            return False
        env = os.environ
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if not env.get(k)]
        if missing:
            raise RuntimeError(
                f"auto=True found no launcher environment (unset: "
                f"{missing}); refusing to run single-process — set them "
                "(torchrun does) or pass coordinator_address, "
                "num_processes and process_id"
            )
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a process group needs coordinator_address, num_processes and "
            f"process_id; got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r}"
        )
    if local_device_ids is None and os.environ.get("LOCAL_RANK"):
        local_device_ids = [int(os.environ["LOCAL_RANK"])]
    if device is not None and torch.device(device).type == "cpu":
        rank_device, backend = torch.device("cpu"), "gloo"
    else:
        if local_device_ids:
            rank_device = torch.device("cuda", int(local_device_ids[0]))
        else:
            rank_device = resolve_device(device)
        if rank_device.type != "cuda":
            raise ValueError(f"unsupported device {rank_device} for a rank")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to join "
                "with the gloo backend explicitly"
            )
        torch.cuda.set_device(rank_device)
        backend = "nccl"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id))
    _rank_device = rank_device
    _log.info("joined a %s process group as rank %d of %d on %s", backend,
              dist.get_rank(), dist.get_world_size(), rank_device)
    return dist.get_world_size() > 1


def shutdown() -> None:
    """Leave the process group (``destroy_process_group``); a no-op when
    not joined. The port's ``jax.distributed.shutdown``."""
    global _rank_device
    if is_initialized():
        dist.destroy_process_group()
    _rank_device = None


def backend() -> str | None:
    """The process group's backend (``"nccl"`` or ``"gloo"``), None when
    not joined."""
    return dist.get_backend() if is_initialized() else None


def rank_device() -> torch.device | None:
    """The device this rank drives, None when not joined."""
    return _rank_device if is_initialized() else None


def process_index() -> int:
    """This process's rank (0 single-process): ``jax.process_index()``."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The world size (1 single-process): ``jax.process_count()``."""
    return dist.get_world_size() if is_initialized() else 1


def global_mesh(
    n_stations: int,
    devices_per_station: int = 1,
    device: str | torch.device | None = None,
) -> FederationMesh:
    """A FederationMesh over every rank of the process group.

    Call after ``initialize()``; the mesh runs on the rank's device unless
    ``device`` names another. Single-process (not joined), this is exactly
    ``FederationMesh(n_stations, device=device)``.
    """
    if not is_initialized():
        return FederationMesh(n_stations, device=device,
                              devices_per_station=devices_per_station)
    return FederationMesh(
        n_stations,
        device=device if device is not None else _rank_device,
        group=dist.group.WORLD,
        devices_per_station=devices_per_station,
    )


def local_stations(mesh: FederationMesh) -> list[int]:
    """The station indices THIS process hosts: the contiguous block of its
    station slot (``mesh.local_stations``)."""
    return list(mesh.local_stations)


def stack_local_shards(
    mesh: FederationMesh,
    shards: Mapping[int, np.ndarray] | Sequence[np.ndarray],
    dtype: Any = None,
) -> torch.Tensor:
    """This process's ``[S_local, ...]`` block of the station-stacked data,
    on the mesh's device, from THIS process's shards only.

    ``shards`` maps station index -> that station's (padded) array, and
    must cover exactly ``local_stations(mesh)``: each process contributes
    its own stations; no process ever materializes another's rows. (A plain
    sequence is accepted single-process, where local == all.)
    """
    mine = local_stations(mesh)
    if not mine:
        raise ValueError(
            f"process {process_index()} hosts NO stations: the mesh "
            f"uses {mesh.station_axis_size * mesh.devices_per_station} of "
            "the global devices and none of this process's devices made "
            "the cut — size n_stations/devices_per_station so every "
            "process owns at least one station slot"
        )
    if not isinstance(shards, Mapping):
        shards = dict(enumerate(shards))
    missing = [i for i in mine if i not in shards]
    extra = [i for i in shards if i not in mine]
    if missing or extra:
        raise ValueError(
            f"process {process_index()} hosts stations {mine}; shards "
            f"missing {missing}, not-local {extra} — every process passes "
            "exactly its own stations' data"
        )
    local = np.stack([np.asarray(shards[i], dtype=dtype) for i in mine])
    return torch.from_numpy(local).to(mesh.device)
