"""Federation mesh: N data stations stacked on a leading axis.

Counterpart of ``vantage6_tpu/core/mesh.py``. All per-station state is
stacked on a leading station axis (a tensor ``[S, ...]`` holds every
station's shard), exactly as in the JAX package.

On one card (no process group) the station mesh axis collapses:
``station_axis_size == 1`` and every station folds into the single slot
(``stations_per_slot == S``). ``fed_map`` walks the stations with a Python
loop, or with ``batched=True`` maps the function over the station axis in
one call (``torch.func.vmap``, the counterpart of the JAX package's vmap
inside shard_map). Either way each station's function sees only its own
slice; all cross-station mixing happens explicitly in ``fed.collectives``.

Across ranks (a ``torch.distributed`` process group, ``core.distributed``)
the mesh has the reference's layout: the group's ranks form
``station_axis_size`` slots of ``devices_per_station`` ranks, station ``i``
lives in slot ``i // stations_per_slot`` (contiguous blocks), and each rank
holds only its slot's ``[S_local, ...]`` block. ``fed_map`` runs over that
local block; the collectives reduce over ``station_group`` (one rank of
every slot) and a station's own ranks share ``device_group`` (tensor
parallelism within the station). Ranks past the last full slot host no
station.

Placement is explicit: entry points take a ``device`` and run on CUDA
unless the caller asks for the CPU. Without a CUDA device and without an
explicit ``device="cpu"`` they raise instead of quietly running on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from vantage6_tpu_torch._tree import tree_map

STATION_AXIS = "station"
DEVICE_AXIS = "device"


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA by default, CPU only on
    request. Raises when no device was named and no CUDA device exists."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU explicitly"
        )
    return torch.device("cuda", torch.cuda.current_device())


@dataclasses.dataclass(frozen=True)
class Station:
    """One data station (reference: a vantage6 node at an organization):
    an index into the station axis plus metadata."""

    index: int
    name: str
    organization: str = ""
    databases: dict[str, Any] = dataclasses.field(default_factory=dict)


def _largest_divisor_leq(n: int, cap: int) -> int:
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


class FederationMesh:
    """Owns the device, the station layout and the station-axis execution
    primitives.

    Parameters
    ----------
    n_stations:
        Number of data stations S in the federation.
    device:
        The card this process runs on (default: the current CUDA device;
        ``"cpu"`` must be asked for explicitly).
    group:
        A ``torch.distributed`` process group the federation spans (None:
        one process holds every station). Building a mesh over a group is
        collective when it needs subgroups (``devices_per_station > 1``, or
        ranks left without a station): every rank of the default group
        builds it, in the same order.
    devices_per_station:
        Ranks forming each station's slot (tensor parallelism *within* a
        station rides ``device_group``); 1 without a group.
    """

    def __init__(
        self,
        n_stations: int,
        device: str | torch.device | None = None,
        group: Any = None,
        devices_per_station: int = 1,
    ):
        if n_stations < 1:
            raise ValueError("n_stations must be >= 1")
        self.device = resolve_device(device)
        self.n_stations = n_stations
        self.group = group
        self.devices_per_station = devices_per_station
        self.station_group = self.device_group = None
        if group is None:
            if devices_per_station != 1:
                raise ValueError(
                    "devices_per_station > 1 needs a process group: a "
                    "station spans several ranks (core.distributed)"
                )
            self.rank, self.world_size, self.ranks = 0, 1, (0,)
            self.station_axis_size = _largest_divisor_leq(n_stations, 1)
            self.stations_per_slot = n_stations // self.station_axis_size
            self.slot: int | None = 0
        else:
            self._init_group(group, devices_per_station)
        if self.slot is None:
            self.local_stations = range(0)
        else:
            first = self.slot * self.stations_per_slot
            self.local_stations = range(first,
                                        first + self.stations_per_slot)

    def _init_group(self, group: Any, dps: int) -> None:
        self.world_size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = tuple(dist.get_process_group_ranks(group))
        if dps < 1 or dps > self.world_size:
            raise ValueError(
                f"invalid devices_per_station {dps} for a group of "
                f"{self.world_size} ranks"
            )
        usable = self.world_size // dps
        # station axis size: the largest divisor of S the ranks can hold
        d = self.station_axis_size = _largest_divisor_leq(self.n_stations,
                                                          usable)
        self.stations_per_slot = self.n_stations // d
        self.slot = self.rank // dps if self.rank < d * dps else None
        if dps == 1 and d == self.world_size:
            self.station_group = group
            return
        # subgroups: every rank of the default group creates every one,
        # in the same order (dist.new_group is collective)
        for j in range(dps):
            g = dist.new_group([self.ranks[s * dps + j] for s in range(d)])
            if self.slot is not None and self.rank % dps == j:
                self.station_group = g
        for s in range(d if dps > 1 else 0):
            g = dist.new_group([self.ranks[s * dps + j] for j in range(dps)])
            if self.slot == s:
                self.device_group = g

    def shard_stacked(self, tree: Any) -> Any:
        """Place a pytree of stacked ``[S, ...]`` arrays on the device;
        across ranks only this rank's ``[S_local, ...]`` block is kept."""
        if self.group is None:
            return tree_map(lambda x: torch.as_tensor(x).to(self.device),
                            tree)
        rows = slice(self.local_stations.start, self.local_stations.stop)
        return tree_map(lambda x: torch.as_tensor(x)[rows].to(self.device),
                        tree)

    def replicate(self, tree: Any) -> Any:
        """Place a pytree every station shares (e.g. the model) on the
        device, whole."""
        return tree_map(lambda x: torch.as_tensor(x).to(self.device), tree)

    def fed_map(
        self,
        fn: Callable[..., Any],
        *stacked_args: Any,
        replicated_args: tuple[Any, ...] = (),
        batched: bool = False,
    ) -> Any:
        """Run ``fn`` once per station; return stacked ``[S, ...]`` outputs
        (across ranks: once per local station, ``[S_local, ...]``).

        ``stacked_args`` are pytrees whose leaves carry a leading station
        axis of size S (``S_local`` across ranks); ``replicated_args`` are
        passed to every station unchanged (e.g. the global model).
        ``batched=True`` runs ``fn`` once under ``torch.func.vmap`` over the
        station axis (per-station weights become batched kernels, e.g. a
        grouped convolution) instead of S times in a loop; ``fn`` must then
        be vmap-able (no data-dependent Python control flow, no in-place
        writes to its inputs)."""
        if batched:
            in_dims = ((0,) * len(stacked_args)
                       + (None,) * len(replicated_args))
            return torch.func.vmap(fn, in_dims=in_dims)(*stacked_args,
                                                        *replicated_args)
        outs = []
        for s in range(len(self.local_stations)):
            s_args = [tree_map(lambda x: x[s], a) for a in stacked_args]
            outs.append(fn(*s_args, *replicated_args))
        return tree_map(lambda *xs: torch.stack(xs), outs[0], *outs[1:])

    def fingerprint(self) -> tuple:
        """Hashable identity of everything a cached runner depends on:
        station count, the slot layout, the world size and the group's
        ranks, and the device. Two meshes with equal fingerprints lay the
        stations out the same way, so runners keyed on it
        (``RunnerCache``) are reusable with either."""
        return (
            self.n_stations,
            self.station_axis_size,
            self.devices_per_station,
            self.world_size,
            self.ranks,
            str(self.device),
        )

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"FederationMesh(S={self.n_stations}, "
            f"station_axis={self.station_axis_size}, "
            f"per_slot={self.stations_per_slot}, "
            f"dps={self.devices_per_station}, "
            f"rank={self.rank}/{self.world_size}, "
            f"device={self.device})"
        )
