"""The numbers that decide ``correct`` for a training cell.

A driver reduces its first steps to a ``Snapshot``: each step's loss, the
norm of each leaf of the first step's gradient as the server optimizer got
it, the norm of each leaf's change over the steps and, where the program
reports them, the norm of each station's update in the first step. The
reference makes the same from the same inputs, and ``compare`` turns the
two into:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``first_loss_gap``: the relative gap of the first step's loss, taken
  before any update, so the forward alone;
- ``grad_gap``: the largest gap of a leaf's first-gradient norm, against the
  reference's norm of that leaf or of the median leaf, whichever is larger
  (some leaves' gradients are all but zero); a leaf the model uses at both
  ends (a token embedding tied to the logits) is held apart in
  ``tied_grad_gap``, since its gradient is the sum of two paths;
- ``grad_diff_gap``: the median leaf's norm of the difference of the two
  first gradients, against the same norm as ``grad_gap``: the direction,
  which a norm alone does not see (a batch that lost half its rows keeps
  its gradient's norm);
- ``change_gap``: the same for the change of each leaf over the steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's: those move by round-off alone;
- ``station_gap``: the median over stations of the relative gap of a
  station's first update norm.

A cell's limits name the numbers it compares (``judge``); the others are
readings only.
"""
from __future__ import annotations

import dataclasses
import math
import statistics

# the reference follows the program's first steps: this many
STEPS = 3

# a leaf whose reference gradient norm is under this share of the median
# leaf's moves by round-off alone, and is left out of change_gap
STILL_LEAF = 1e-3


@dataclasses.dataclass
class Snapshot:
    losses: list[float]        # the loss of each step
    grad_norms: list[float]    # per leaf, the first step's gradient
    change_norms: list[float]  # per leaf, params after the steps - before
    station_norms: list[float] | None = None  # per station, first update
    grads: list | None = None  # per leaf, the first step's gradient itself
    tied: int | None = None    # the leaf used at both ends, if one is


def leaf_gaps(prog: list[float], ref: list[float],
              keep: list[bool]) -> list[float | None]:
    """Each kept leaf's gap of norms (None for a leaf left out)."""
    floor = statistics.median(ref)
    return [abs(p - r) / max(r, floor, 1e-30) if k else None
            for p, r, k in zip(prog, ref, keep, strict=True)]


def moving(ref: Snapshot) -> list[bool]:
    """The leaves whose reference gradient is not nought to rounding."""
    floor = statistics.median(ref.grad_norms)
    return [g >= STILL_LEAF * floor for g in ref.grad_norms]


def _norm_gaps(prog: list[float], ref: list[float],
               keep: list[bool]) -> float:
    return max(g for g in leaf_gaps(prog, ref, keep) if g is not None)


def diff_gaps(prog: list, ref: list, ref_norms: list[float]) -> list[float]:
    """Each leaf's norm of the difference of two gradients, against the
    reference's norm of that leaf or of the median leaf (an infinite gap
    where the program's is not finite)."""
    import torch

    floor = statistics.median(ref_norms)
    out = []
    for p, r, n in zip(prog, ref, ref_norms, strict=True):
        d = float(torch.linalg.vector_norm(
            p.to(r.device, torch.float32) - r))
        out.append(d / max(n, floor, 1e-30) if math.isfinite(d)
                   else math.inf)
    return out


def compare(prog: Snapshot, ref: Snapshot) -> dict[str, float]:
    """The numbers of ``prog`` against ``ref`` (NaN in the program reads
    as an infinite gap)."""
    def finite(x):
        return x if math.isfinite(x) else math.inf

    loss_gap = max(abs(finite(p) - r) / abs(r)
                   for p, r in zip(prog.losses, ref.losses, strict=True))
    grads = [finite(x) for x in prog.grad_norms]
    changes = [finite(x) for x in prog.change_norms]
    untied = [i != ref.tied for i in range(len(ref.grad_norms))]
    out = {
        "loss_gap": loss_gap,
        "first_loss_gap": abs(finite(prog.losses[0]) - ref.losses[0])
        / abs(ref.losses[0]),
        "grad_gap": _norm_gaps(grads, ref.grad_norms, untied),
        "change_gap": _norm_gaps(changes, ref.change_norms, moving(ref)),
    }
    if ref.tied is not None:
        out["tied_grad_gap"] = leaf_gaps(
            grads, ref.grad_norms, [True] * len(grads))[ref.tied]
    if prog.grads is not None and ref.grads is not None:
        out["grad_diff_gap"] = statistics.median(
            diff_gaps(prog.grads, ref.grads, ref.grad_norms))
    if prog.station_norms is not None and ref.station_norms is not None:
        out["station_gap"] = statistics.median(
            abs(finite(p) - r) / r for p, r in zip(
                prog.station_norms, ref.station_norms, strict=True))
    return out


def judge(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """True when every number the limits name is within its limit (a
    number missing or NaN fails)."""
    return all(numbers.get(name, math.nan) <= limit
               for name, limit in limits.items())
