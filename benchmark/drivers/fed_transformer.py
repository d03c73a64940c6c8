"""Driver of the federated transformer cells: ``FedTransformer.round``.

The engine is ``workloads/fed_transformer.py``'s ``make_engine`` at the
configuration's widths, bf16 compute with flash attention
(``ops/csrc/flash_attention_tc.cu`` forward, the plain f32 backward), one
station slot on the card and every station in every round. A round draws
the stations' tokens on the card (``traffic.federated_tokens``), runs
``round`` and pulls its loss to the host, which ends it.

The weights are made on the card from the seed, 0.02 * N(0, 1) in one draw
(the engine's own scale), and handed to the engine; the check remakes them
from the seed for the reference and holds the two to one checksum.
"""
from __future__ import annotations

import gc

import torch

from portbench import checks, traffic
from portbench.faults import patch
from reference import transformer as ref

# generator streams of a run's draws
WEIGHTS, TOKENS = 0, 1
INIT_STD = 0.02


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.model = cell.config["model"]
        self.federation = cell.config["federation"]
        self.adam = cell.config["server_optimizer"]
        self.traffic = cell.traffic
        self.seed = seed
        self.device = device
        self.engine = None

    # ------------------------------------------------------------ inputs
    def weights(self) -> tuple[dict, float]:
        """The f32 parameters from the seed, drawn on the card in one call,
        and their checksum."""
        m = self.model
        d, v, L = m["n_embd"], m["vocab_size"], m["n_positions"]
        shapes = [(v, d), (L, d)] + [
            (d, 3 * d), (d, d), (d, m["n_inner"]), (m["n_inner"], d)
        ] * m["n_layer"]
        sizes = [a * b for a, b in shapes]
        gen = traffic.generator(self.seed, WEIGHTS, self.device)
        flat = torch.randn(sum(sizes), generator=gen, device=self.device)
        flat.mul_(INIT_STD)
        views = [x.view(s) for x, s in zip(flat.split(sizes), shapes,
                                            strict=True)]
        params = {"embed": views[0], "pos": views[1], "layers": []}
        for i in range(m["n_layer"]):
            w = views[2 + 4 * i:6 + 4 * i]
            params["layers"].append(dict(zip(ref.LAYER_KEYS, w, strict=True)))
        return params, float(flat.double().sum())

    def _tokens(self) -> torch.Tensor:
        t = self.traffic
        return traffic.federated_tokens(
            self.gen, self.federation["stations"], t["batch"], t["seq_len"],
            self.model["vocab_size"])

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        """Build the engine, and run the check's steps through ``round``:
        they warm up every shape the window uses."""
        self.build()
        self.check_steps()

    def build(self) -> None:
        from vantage6_tpu_torch.workloads.fed_transformer import (
            TransformerConfig,
            make_engine,
        )

        m = self.model
        cfg = TransformerConfig(
            vocab=m["vocab_size"], d_model=m["n_embd"], n_heads=m["n_head"],
            n_layers=m["n_layer"], max_len=m["n_positions"],
            dtype=getattr(torch, m["compute_dtype"]),
            attention=m["attention"])
        self.engine = make_engine(self.federation["stations"], 1, cfg,
                                  lr=self.adam["lr"], device=self.device)
        self.params, self.checksum = self.weights()
        self.opt = self.engine.optimizer.init(self.params)
        self.mask = torch.ones(self.federation["stations"],
                               device=self.device)
        self.gen = traffic.generator(self.seed, TOKENS, self.device)

    def check_steps(self) -> None:
        """The first steps, kept for the check: their tokens, their
        losses, the first gradient and each leaf's change."""
        params0 = self.params
        self.steps, losses = [], []
        for n in range(checks.STEPS):
            losses.append(self.round())
            self.steps.append(self.last_tokens)
            if n == 0:  # the gradient Adam got: mu after one step / (1 - b1)
                scale = 1 / (1 - self.adam["b1"])
                grad_norms = [float(torch.linalg.vector_norm(x)) * scale
                              for x in ref.leaves(self.opt.mu)]
                # kept on the host: the card's memory is the program's
                grads = [(x * scale).cpu() for x in ref.leaves(self.opt.mu)]
        change = [float(torch.linalg.vector_norm(a - b)) for a, b in zip(
            ref.leaves(self.params), ref.leaves(params0), strict=True)]
        self.snapshot = checks.Snapshot(losses, grad_norms, change,
                                        grads=grads, tied=ref.TIED)

    def round(self) -> float:
        self.last_tokens = self._tokens()
        self.params, self.opt, loss = self.engine.round(
            self.params, self.opt, self.last_tokens, self.mask)
        return loss.item()

    def release(self) -> None:
        self.engine = self.params = self.opt = self.mask = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def reference(self, precision: str = "float32") -> checks.Snapshot:
        params0, checksum = self.weights()
        if checksum != self.checksum:
            raise RuntimeError("the weights remade from the seed differ: "
                               f"{checksum} != {self.checksum}")
        out = ref.run(params0, self.steps, self.model["n_head"], self.adam,
                      precision=precision)
        return checks.Snapshot(out["losses"], out["grad_norms"],
                               out["change_norms"], grads=out["grads"],
                               tied=ref.TIED)


# ------------------------------------------------------------------ faults
def _state_unchanged(driver: Driver):
    eng = driver.engine
    orig = eng.round

    def round_(params, opt_state, tokens, mask):
        return params, opt_state, orig(params, opt_state, tokens, mask)[2]

    eng.round = round_
    return lambda: delattr(eng, "round")


def _half_batch(driver: Driver):
    from vantage6_tpu_torch.workloads import fed_transformer as ft

    def make(orig):
        def loss_local(params, tokens_local, *a, **kw):
            return orig(params, tokens_local[:tokens_local.shape[0] // 2],
                        *a, **kw)
        return loss_local
    return patch(ft, "loss_local", make)


def _no_exchange(driver: Driver):
    from vantage6_tpu_torch._tree import tree_map
    from vantage6_tpu_torch.fed import collectives

    def make(orig):
        def fed_mean(stacked, *a, **kw):
            return tree_map(lambda x: x[0], stacked)
        return fed_mean
    return patch(collectives, "fed_mean", make)


def _leaf_skipped(driver: Driver):
    from vantage6_tpu_torch.workloads import fed_transformer as ft

    def make(orig):
        def apply_updates(params, updates):
            out = orig(params, updates)
            out["embed"] = params["embed"]
            return out
        return apply_updates
    return patch(ft, "apply_updates", make)


# each plants a fault in the program under a built driver (before setup's
# steps) and returns the function that takes it out; for the tests of the
# check and for reading each fault's numbers on the chip
FAULTS = {
    "state_unchanged": _state_unchanged,
    "half_batch": _half_batch,
    "no_exchange": _no_exchange,
    "leaf_skipped": _leaf_skipped,
}
