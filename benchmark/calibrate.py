#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, at its size.

    python3 benchmark/calibrate.py --workload gpt2-medium.ctx1024 \\
        --seeds 1,2,3,4,5,6,7,8,9,10,11,12 --control 1,2,3 --faults 1,2,3 \\
        --fault half_batch=4,5,6,7,8,9,10,11,12

For each seed of ``--seeds`` the program's check steps run as in a
benchmark run (no window) and are compared with the float32 reference: the
lower readings. For each seed of ``--control`` the float8 reference stands
in the program's place and is compared with the float32 reference of the
same inputs: the control's readings. For each seed of ``--faults`` each
fault the driver knows is planted in the program in turn (``FAULTS``) and
its steps compared the same way; ``--fault NAME=SEEDS`` reads one fault on
more seeds. One JSON line a reading on standard output, with the leaves
that set the gaps and, for a tied leaf, its gaps on its two largest rows
of the reference's gradient and on the rest. The benchmark's own runs run
none of this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as R  # noqa: E402


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def tied_rows(prog, ref) -> dict:
    """The tied leaf's gap of norms and norm of the difference on the two
    rows where the reference's gradient is largest, and on the others."""
    if ref.tied is None:
        return {}
    import torch

    r = ref.grads[ref.tied]
    p = prog.grads[ref.tied].to(r.device, torch.float32)
    rows = torch.linalg.vector_norm(r, dim=1)
    top = torch.topk(rows, 2).indices
    rest = torch.ones_like(rows, dtype=torch.bool)
    rest[top] = False
    out = {"tied_top_rows": top.tolist(),
           "tied_top_share": float(rows[top].square().sum()
                                   / rows.square().sum())}
    for name, sel in (("top", top), ("rest", rest)):
        rn = float(torch.linalg.vector_norm(r[sel]))
        out[f"tied_{name}_gap"] = abs(
            float(torch.linalg.vector_norm(p[sel])) - rn) / rn
        out[f"tied_{name}_diff"] = float(
            torch.linalg.vector_norm(p[sel] - r[sel])) / rn
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control", type=seeds, default=[])
    p.add_argument("--faults", type=seeds, default=[])
    p.add_argument("--fault", action="append", default=[],
                   metavar="NAME=SEEDS")
    args = p.parse_args(argv)
    R.set_caches()
    R.import_program()
    from portbench import cells, checks

    cell = cells.resolve(args.workload)
    card = R.Card()
    why = card.available(cell.chips)
    if why is not None:
        print(f"no run: {why}", file=sys.stderr)
        return 2
    module = cells.driver(cell)
    plan = {name: set(args.faults) for name in module.FAULTS}
    for item in args.fault:
        name, _, text = item.partition("=")
        plan[name] |= set(seeds(text))

    def emit(kind, seed, prog, ref, **extra):
        """The numbers of ``prog`` against ``ref``, with the leaves that
        set the two norm gaps and the leaves left out of change_gap."""
        keep = checks.moving(ref)
        grads = checks.leaf_gaps(prog.grad_norms, ref.grad_norms,
                                 [True] * len(keep))
        changes = checks.leaf_gaps(prog.change_norms, ref.change_norms, keep)
        diffs = checks.diff_gaps(prog.grads, ref.grads, ref.grad_norms)
        worst = {name: max((g, i) for i, g in enumerate(gaps)
                           if g is not None)[1]
                 for name, gaps in (("grad_leaf", grads),
                                    ("change_leaf", changes),
                                    ("grad_diff_leaf", diffs))}
        print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                          **checks.compare(prog, ref), **worst,
                          "grad_diff_max": max(diffs),
                          **tied_rows(prog, ref),
                          "still_leaves": [i for i, k in enumerate(keep)
                                           if not k],
                          "losses": prog.losses, **extra}), flush=True)

    def program(seed, fault=None):
        driver = module.Driver(cell, seed, card.device)
        driver.build()
        undo = module.FAULTS[fault](driver) if fault else None
        try:
            driver.check_steps()
        finally:
            if undo is not None:
                undo()
        driver.release()
        return driver

    for seed in sorted(set(args.seeds) | set(args.control)
                       | set().union(*plan.values())):
        driver = program(seed)
        t0 = time.perf_counter()
        ref = driver.reference()
        if seed in args.seeds:
            emit("program", seed, driver.snapshot, ref,
                 ref_losses=ref.losses, reference_s=time.perf_counter() - t0)
        if seed in args.control:
            emit("control", seed, driver.reference("fp8"), ref)
        for fault in module.FAULTS:
            if seed in plan[fault]:
                emit("fault", seed, program(seed, fault).snapshot, ref,
                     fault=fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
