"""Driver of the federated MLA-MoE cells: ``FedTransformer.round`` on
DeepSeek-V3's block (``models/mla_moe.py``).

The engine is ``workloads/fed_transformer.py``'s ``make_engine`` with an
``MLAMoEConfig`` at the configuration's widths, bf16 compute, flash
attention (``ops/csrc/flash_attention_tc.cu`` forward at W = 256 for the
q/k width of 192, the plain f32 backward above the backward kernel's
widths), the held experts' share of each MoE layer, one station slot on
the card and every station in every round. A round draws the stations'
tokens on the card (``traffic.federated_tokens`` over the vocabulary
slice), runs ``round`` and pulls its loss to the host, which ends it.

The weights are made on the card from the seed: every trained matrix
0.02 * N(0, 1) in one draw (the engine's own scale), RMSNorm gains 1; the
fixed buffers in draws of their own, each MoE layer's router 0.02 * N(0,
1) and its correction bias 0.05 * N(0, 1). The check remakes them from the
seed for the reference and holds them to one checksum.

The first check step also keeps the program's routing choices, so that the
check can read the share of token-slots the reference chose otherwise
(``route_flip_share``, a reading on standard error, not compared).
"""
from __future__ import annotations

import gc
import sys

import torch

from portbench import checks, traffic
from portbench.faults import patch
from reference import mla_moe as ref

# generator streams of a run's draws
WEIGHTS, TOKENS, BIAS, ROUTER = 0, 1, 2, 3
INIT_STD = 0.02
BIAS_STD = 0.05


def _gain(shape) -> bool:
    return len(shape) == 1


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
    def weights(self) -> tuple[dict, dict, float]:
        """The f32 parameters and the buffers from the seed, drawn on the
        card, and their checksum."""
        m = self.model
        shapes = ref.param_shapes(m)
        flat_shapes = [s for s in ref.leaves(shapes) if not _gain(s)]
        sizes = [a * b for a, b in flat_shapes]
        gen = traffic.generator(self.seed, WEIGHTS, self.device)
        flat = torch.randn(sum(sizes), generator=gen, device=self.device)
        flat.mul_(INIT_STD)
        views = iter(x.view(s) for x, s in zip(flat.split(sizes),
                                                flat_shapes, strict=True))
        params = ref.rebuild(shapes, [
            torch.ones(s, device=self.device) if _gain(s) else next(views)
            for s in ref.leaves(shapes)])
        n_moe = m["n_layers"] - m["first_k_dense"]
        gen = traffic.generator(self.seed, BIAS, self.device)
        bias = BIAS_STD * torch.randn((n_moe, m["n_experts"]), generator=gen,
                                      device=self.device)
        gen = traffic.generator(self.seed, ROUTER, self.device)
        router = INIT_STD * torch.randn((n_moe, m["d_model"], m["n_experts"]),
                                        generator=gen, device=self.device)
        buffers = {"router": list(router.unbind(0)),
                   "score_bias": list(bias.unbind(0))}
        checksum = sum(float(x.double().sum()) for x in (flat, bias, router))
        return params, buffers, checksum

    def _tokens(self) -> torch.Tensor:
        t = self.traffic
        return traffic.federated_tokens(
            self.gen, self.federation["stations"], t["batch"], t["seq_len"],
            self.model["vocab"])

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        """Build the engine, and run the check's steps through ``round``:
        they warm up every shape the window uses."""
        self.build()
        self.check_steps()

    def build(self) -> None:
        from vantage6_tpu_torch.models.mla_moe import MLAMoEConfig
        from vantage6_tpu_torch.workloads.fed_transformer import make_engine

        m = self.model
        cfg = MLAMoEConfig(
            vocab=m["vocab"], d_model=m["d_model"], n_heads=m["n_heads"],
            qk_nope_dim=m["qk_nope_dim"], qk_rope_dim=m["qk_rope_dim"],
            v_head_dim=m["v_head_dim"], kv_lora_rank=m["kv_lora_rank"],
            n_layers=m["n_layers"], first_k_dense=m["first_k_dense"],
            dense_inter=m["dense_inter"], moe_inter=m["moe_inter"],
            n_experts=m["n_experts"], top_k=m["top_k"],
            n_shared=m["n_shared"], held_experts=tuple(m["held_experts"]),
            routed_scale=m["routed_scale"],
            rope_theta=m["rope_theta"], rms_eps=m["rms_eps"],
            max_len=m["max_len"], dtype=getattr(torch, m["compute_dtype"]),
            attention=m["attention"])
        self.params, buffers, self.checksum = self.weights()
        self.engine = make_engine(self.federation["stations"], 1, cfg,
                                  lr=self.adam["lr"], device=self.device,
                                  buffers=buffers)
        self.opt = self.engine.optimizer.init(self.params)
        self.mask = torch.ones(self.federation["stations"],
                               device=self.device)
        self.gen = traffic.generator(self.seed, TOKENS, self.device)

    def check_steps(self) -> None:
        """The first steps, kept for the check: their tokens, their
        losses, the first gradient, each leaf's change and the first
        step's routing choices."""
        from vantage6_tpu_torch.models import mla_moe

        params0 = self.params
        self.steps, losses, chose = [], [], []

        def keep(orig):
            def route(*a, **kw):
                choice, weights = orig(*a, **kw)
                chose.append(choice.cpu())
                return choice, weights
            return route

        for n in range(checks.STEPS):
            undo = patch(mla_moe, "route", keep) if n == 0 else None
            try:
                losses.append(self.round())
            finally:
                if undo is not None:
                    undo()
            self.steps.append(self.last_tokens)
            if n == 0:  # the gradient Adam got: mu after one step / (1 - b1)
                scale = 1 / (1 - self.adam["b1"])
                grad_norms = [float(torch.linalg.vector_norm(x)) * scale
                              for x in ref.leaves(self.opt.mu)]
                # kept on the host: the card's memory is the program's
                grads = [(x * scale).cpu() for x in ref.leaves(self.opt.mu)]
        change = [float(torch.linalg.vector_norm(a - b)) for a, b in zip(
            ref.leaves(self.params), ref.leaves(params0), strict=True)]
        n_moe = self.model["n_layers"] - self.model["first_k_dense"]
        self.choices = [chose[i:i + n_moe]
                        for i in range(0, len(chose), n_moe)]
        self.snapshot = checks.Snapshot(losses, grad_norms, change,
                                        grads=grads)

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
        params0, buffers, checksum = self.weights()
        if checksum != self.checksum:
            raise RuntimeError("the weights remade from the seed differ: "
                               f"{checksum} != {self.checksum}")
        out = ref.run(params0, buffers, self.steps, self.model, self.adam,
                      precision=precision)
        if precision == "float32":
            print("reading (not compared): route_flip_share "
                  f"{ref.flip_share(self.choices, out['choices'])!r}",
                  file=sys.stderr)
        return checks.Snapshot(out["losses"], out["grad_norms"],
                               out["change_norms"], grads=out["grads"])


# ------------------------------------------------------------------ faults
def _state_unchanged(driver: Driver):
    eng = driver.engine
    orig = eng.round

    def round_(params, opt_state, tokens, mask):
        return params, opt_state, orig(params, opt_state, tokens, mask)[2]

    eng.round = round_
    return lambda: delattr(eng, "round")


def _half_batch(driver: Driver):
    from vantage6_tpu_torch.models import mla_moe

    def make(orig):
        def loss_local(params, tokens_local, *a, **kw):
            return orig(params, tokens_local[:tokens_local.shape[0] // 2],
                        *a, **kw)
        return loss_local
    return patch(mla_moe, "loss_local", make)


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


def _expert_dropped(driver: Driver):
    """The token-slots routed to one held expert, the one that takes the
    most, left out."""
    from vantage6_tpu_torch.models import mla_moe

    def make(orig):
        def held_slots(choice, cfg):
            sel, sizes, counts = orig(choice, cfg)
            e = max(range(len(sizes)), key=sizes.__getitem__)
            lo = sum(sizes[:e])
            keep = torch.cat([sel[:lo], sel[lo + sizes[e]:]])
            return keep, sizes[:e] + [0] + sizes[e + 1:], counts
        return held_slots
    return patch(mla_moe, "held_slots", make)


def _bias_ignored(driver: Driver):
    """The experts chosen by the unbiased scores."""
    from vantage6_tpu_torch.models import mla_moe

    def make(orig):
        def route(h, router, bias, cfg):
            return orig(h, router, torch.zeros_like(bias), cfg)
        return route
    return patch(mla_moe, "route", make)


# each plants a fault in the program under a built driver (before setup's
# steps) and returns the function that takes it out; for the tests of the
# check and for reading each fault's numbers on the chip
FAULTS = {
    "state_unchanged": _state_unchanged,
    "half_batch": _half_batch,
    "no_exchange": _no_exchange,
    "leaf_skipped": _leaf_skipped,
    "expert_dropped": _expert_dropped,
    "bias_ignored": _bias_ignored,
}
