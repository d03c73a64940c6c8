"""Checkpoint/resume of federated training state.

The reference has NO mid-task checkpointing (SURVEY.md §5): a failed task is
simply resubmitted, and algorithm state lives only in task payloads. For
multi-hour training that is not acceptable, so this is a deliberate
capability ADD: checkpoints of (global model, server opt state, round
index, generator state) with atomic write + latest-resume, so a preempted
run resumes mid-run.

Counterpart of ``vantage6_tpu/runtime/checkpoint.py``: orbax becomes
``torch.save``/``torch.load(weights_only=True)``, one file per round
(written to a temporary name and renamed, so a crash mid-write never
leaves a torn checkpoint), and JAX's ``rng_key`` becomes the state of an
explicit ``torch.Generator`` (``get_state()``, a uint8 tensor; restore it
with ``set_state``). A restore places the params and the optimizer state
on the device named; the learning-plane history
(``RoundHistory.state_arrays()``, numpy arrays, saved as CPU tensors)
stays on the host, where ``RoundHistory.load_state`` reads it, so a
resumed run's norm-decay trajectory continues.
"""
from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

from vantage6_tpu_torch._tree import tree_map
from vantage6_tpu_torch.core.mesh import resolve_device
from vantage6_tpu_torch.optim import AdamState

# the optimizer states a checkpoint may hold besides tensors and containers
_SAFE_GLOBALS = [AdamState]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    round_index: int
    # torch.Generator.get_state() of the run's batch-index generator; a
    # generator itself is accepted and saved as its state
    rng_state: Any
    # learning-plane round history (runtime.learning.RoundHistory
    # .state_arrays()), optional both ways: None writes no entry; restore
    # it with RoundHistory.load_state
    history: Any = None

    def as_tree(self) -> dict[str, Any]:
        rng = self.rng_state
        if isinstance(rng, torch.Generator):
            rng = rng.get_state()
        tree = {
            "params": self.params,
            "opt_state": self.opt_state,
            "round_index": torch.tensor(self.round_index, dtype=torch.int64),
            "rng_state": rng,
        }
        if self.history is not None:
            tree["history"] = tree_map(
                lambda x: torch.as_tensor(x)
                if isinstance(x, (np.ndarray, np.generic)) else x,
                self.history)
        return tree

    @classmethod
    def from_tree(cls, tree: dict[str, Any]) -> "TrainState":
        return cls(
            params=tree["params"],
            opt_state=tree["opt_state"],
            round_index=int(tree["round_index"]),
            rng_state=tree["rng_state"],
            history=tree.get("history"),
        )

    def generator(self, device: str | torch.device | None = None
                  ) -> torch.Generator:
        """A fresh generator on ``device`` (CUDA unless ``"cpu"`` is asked
        for) holding the saved state."""
        gen = torch.Generator(device=resolve_device(device))
        gen.set_state(self.rng_state)
        return gen


def _to_cpu(x: Any) -> Any:
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


class CheckpointManager:
    """Round-indexed checkpoints in ``directory``, the newest
    ``max_to_keep`` kept."""

    _NAME = re.compile(r"^round_(\d+)\.pt$")

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, round_index: int) -> Path:
        return self.directory / f"round_{round_index}.pt"

    def rounds(self) -> list[int]:
        return sorted(
            int(m.group(1)) for p in self.directory.iterdir()
            if (m := self._NAME.match(p.name))
        )

    def save(self, state: TrainState, wait: bool = False) -> None:
        """Write ``state`` (tensors copied to the host first); ``wait`` is
        the JAX signature's and has no effect: the write is synchronous."""
        del wait
        tree = tree_map(_to_cpu, state.as_tree())
        path = self._path(state.round_index)
        tmp = path.with_suffix(".tmp")
        torch.save(tree, tmp)
        os.replace(tmp, path)
        for old in self.rounds()[:-self.max_to_keep or None]:
            self._path(old).unlink(missing_ok=True)

    def latest_round(self) -> int | None:
        rounds = self.rounds()
        return rounds[-1] if rounds else None

    def restore(self, round_index: int | None = None,
                device: str | torch.device | None = None
                ) -> TrainState | None:
        """The checkpoint of ``round_index`` (default: the newest), its
        params and optimizer state on ``device`` (CUDA unless ``"cpu"`` is
        asked for); None when there is none. The generator state stays a
        CPU byte tensor, as ``set_state`` takes it, and the history CPU
        tensors."""
        device = resolve_device(device)
        step = round_index if round_index is not None else self.latest_round()
        if step is None:
            return None
        with torch.serialization.safe_globals(_SAFE_GLOBALS):
            tree = torch.load(self._path(step), map_location="cpu",
                              weights_only=True)
        for name in ("params", "opt_state"):
            if name in tree:
                tree[name] = tree_map(
                    lambda x: x.to(device) if isinstance(x, torch.Tensor)
                    else x, tree[name])
        return TrainState.from_tree(tree)

    def close(self) -> None:
        """Nothing is pending: saves are synchronous."""
