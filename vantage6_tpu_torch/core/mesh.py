"""Federation mesh on one GPU: N data stations stacked on a leading axis.

Counterpart of ``vantage6_tpu/core/mesh.py``. All per-station state is
stacked on a leading station axis (a tensor ``[S, ...]`` holds every
station's shard), exactly as in the JAX package. On one card the station
mesh axis collapses: ``station_axis_size == 1`` and every station folds into
the single slot (``stations_per_slot == S``). ``fed_map`` walks the stations
with a Python loop, so each station's function runs in isolation; all
cross-station mixing happens explicitly in ``fed.collectives``.

Placement is explicit: entry points take a ``device`` and run on CUDA
unless the caller asks for the CPU. Without a CUDA device and without an
explicit ``device="cpu"`` they raise instead of quietly running on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

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
    """Owns the device and the station-axis execution primitives.

    Parameters
    ----------
    n_stations:
        Number of data stations S in the federation.
    device:
        The card the federation runs on (default: the current CUDA device;
        ``"cpu"`` must be asked for explicitly).
    """

    def __init__(
        self,
        n_stations: int,
        device: str | torch.device | None = None,
    ):
        if n_stations < 1:
            raise ValueError("n_stations must be >= 1")
        self.device = resolve_device(device)
        self.n_stations = n_stations
        self.devices_per_station = 1
        self.station_axis_size = _largest_divisor_leq(n_stations, 1)
        self.stations_per_slot = n_stations // self.station_axis_size

    def shard_stacked(self, tree: Any) -> Any:
        """Place a pytree of stacked ``[S, ...]`` arrays on the device."""
        return tree_map(lambda x: torch.as_tensor(x).to(self.device), tree)

    def replicate(self, tree: Any) -> Any:
        """Place a pytree every station shares (e.g. the model) on the
        device; on one card this is the same move as ``shard_stacked``."""
        return self.shard_stacked(tree)

    def fed_map(
        self,
        fn: Callable[..., Any],
        *stacked_args: Any,
        replicated_args: tuple[Any, ...] = (),
    ) -> Any:
        """Run ``fn`` once per station; return stacked ``[S, ...]`` outputs.

        ``stacked_args`` are pytrees whose leaves carry a leading station
        axis of size S; ``replicated_args`` are passed to every station
        unchanged (e.g. the global model)."""
        outs = []
        for s in range(self.n_stations):
            s_args = [tree_map(lambda x: x[s], a) for a in stacked_args]
            outs.append(fn(*s_args, *replicated_args))
        return tree_map(lambda *xs: torch.stack(xs), outs[0], *outs[1:])

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"FederationMesh(S={self.n_stations}, "
            f"station_axis={self.station_axis_size}, "
            f"per_slot={self.stations_per_slot}, "
            f"device={self.device})"
        )
