"""Driver of the FedAvg-CNN cells: ``FedAvg.run_rounds``, one round a
dispatch.

The engine is ``workloads/fedavg_mnist.py``'s ``make_engine`` (the CNN at
bf16 compute, ``sgd(1.0)`` on the server, the learning stats on, as its
defaults are), with the cell's compressor if it names one. The check reads
the first round's per-station update norms from those stats. Each round
draws its batch indices (and its int8 rounding noise) on the card, calls
``run_rounds(..., n_rounds=1)``, which replays the round's captured CUDA
graph, and pulls the round's loss to the host, which ends it.

The data (synthetic image classes split Dirichlet over the stations) is
made on the host from the seed and padded to a fixed row count; the
weights (LeCun-normal kernels, zero biases, flax's defaults) on the card
in one draw.
"""
from __future__ import annotations

import gc
import math

import torch

from portbench import checks, traffic
from portbench.faults import patch
from reference import cnn as ref

# generator streams of a run's draws
WEIGHTS, INDICES, NOISE = 0, 1, 2
# each station's rows are padded to this many times the mean shard, so
# that every seed's Dirichlet shards fit one shape (the flagship's largest
# over 3,000 seeds was 961 of 1,024 rows)
PAD_FACTOR = 4


def _shapes(model: dict) -> dict[tuple[str, str], tuple[int, ...]]:
    h, w, c = model["image_shape"]
    c0, c1 = model["conv_channels"]
    hidden, classes = model["dense_features"], model["num_classes"]
    flat = (h // 4) * (w // 4) * c1
    return {("Conv_0", "bias"): (c0,), ("Conv_0", "kernel"): (3, 3, c, c0),
            ("Conv_1", "bias"): (c1,), ("Conv_1", "kernel"): (3, 3, c0, c1),
            ("Dense_0", "bias"): (hidden,),
            ("Dense_0", "kernel"): (flat, hidden),
            ("Dense_1", "bias"): (classes,),
            ("Dense_1", "kernel"): (hidden, classes)}


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.model = cell.config["model"]
        self.fed = cell.config["federation"]
        self.traffic = cell.traffic
        self.compressor = cell.traffic.get("compressor")
        self.seed = seed
        self.device = device
        self.engine = None

    # ------------------------------------------------------------ inputs
    def weights(self) -> tuple[dict, float]:
        """float32 parameters from the seed: kernels truncated normal on
        two standard deviations at variance 1 / fan-in, drawn on the card in
        one call; biases zero."""
        shapes = _shapes(self.model)
        kernels = [k for k in ref.LEAVES if k[1] == "kernel"]
        sizes = [math.prod(shapes[k]) for k in kernels]
        gen = traffic.generator(self.seed, WEIGHTS, self.device)
        u = torch.rand(sum(sizes), generator=gen, device=self.device,
                       dtype=torch.float64)
        lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
        hi = 0.5 * (1 + math.erf(2 / math.sqrt(2)))
        z = math.sqrt(2) * torch.special.erfinv(2 * (lo + (hi - lo) * u) - 1)
        trunc_std = 0.87962566103423978  # of N(0, 1) cut at +-2
        params: dict = {}
        for key, part in zip(kernels, z.split(sizes), strict=True):
            fan_in = math.prod(shapes[key][:-1])
            scale = math.sqrt(1.0 / fan_in) / trunc_std
            params.setdefault(key[0], {})[key[1]] = (
                (part * scale).to(torch.float32).view(shapes[key]))
        for key, shape in shapes.items():
            if key[1] == "bias":
                params[key[0]][key[1]] = torch.zeros(shape,
                                                     device=self.device)
        total = sum(float(t.double().sum()) for t in ref.leaves(params))
        return params, total

    def data(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        fed = self.fed
        x, y, counts = traffic.federated_images(
            self.seed, fed["stations"], fed["per_station"], fed["alpha"],
            fed["noise"], PAD_FACTOR * fed["per_station"])
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (x, y, counts))

    def n_pad(self) -> int:
        n = sum(math.prod(s) for s in _shapes(self.model).values())
        chunk = self.compressor["chunk"]
        return math.ceil(n / chunk) * chunk

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        """Build the engine and run the check's steps through
        ``run_rounds``: the first captures the round's graph."""
        self.build()
        self.check_steps()

    def build(self) -> None:
        from vantage6_tpu_torch.fed.compression import CompressorSpec
        from vantage6_tpu_torch.workloads.fedavg_mnist import make_engine

        comp = self.compressor
        spec = None if comp is None else CompressorSpec(
            topk_ratio=comp["topk_ratio"], int8=comp["int8"],
            chunk=comp["chunk"], error_feedback=comp["error_feedback"])
        fed = self.fed
        self.engine = make_engine(
            n_stations=fed["stations"], local_steps=fed["local_steps"],
            batch_size=fed["batch"], local_lr=fed["local_lr"],
            compressor=spec, device=self.device)
        self.x, self.y, self.counts = self.data()
        self.params, self.checksum = self.weights()
        self.opt = self.engine.init(self.params)
        self.gen_idx = traffic.generator(self.seed, INDICES, self.device)
        self.gen_noise = traffic.generator(self.seed, NOISE, self.device)

    def check_steps(self) -> None:
        params0 = self.params
        self.steps, losses, after = [], [], []
        for _ in range(checks.STEPS):
            losses.append(self.round())
            self.steps.append(self.last_draws)
            after.append(ref.leaves(self.params))
            if len(after) == 1:  # each station's update, as the stats say
                stations = self.last_stats["station_norm"][0].tolist()
        start = ref.leaves(params0)
        # sgd(1.0) keeps no state: the first pseudo-gradient is the first
        # step's params0 - params1
        grads = [(a - b).cpu() for a, b in zip(start, after[0], strict=True)]
        change = [float(torch.linalg.vector_norm(a - b))
                  for a, b in zip(after[-1], start, strict=True)]
        self.snapshot = checks.Snapshot(
            losses, [float(torch.linalg.vector_norm(g)) for g in grads],
            change, stations, grads=grads)

    def round(self) -> float:
        fed = self.fed
        idx = traffic.batch_indices(self.gen_idx, self.counts,
                                    fed["local_steps"], fed["batch"])
        noise = None
        if self.compressor is not None and self.compressor["int8"]:
            noise = traffic.uniform_noise(self.gen_noise, fed["stations"],
                                          self.n_pad())
        self.last_draws = {"idx": idx, "noise": noise}
        self.params, self.opt, losses, self.last_stats = \
            self.engine.run_rounds(self.params, self.x, self.y, self.counts,
                                   None, 1, opt_state=self.opt,
                                   batch_idx=idx, noise=noise)
        return losses[0].item()

    def release(self) -> None:
        self.engine = self.params = self.opt = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def reference(self, precision: str = "float32") -> checks.Snapshot:
        params0, checksum = self.weights()
        if checksum != self.checksum:
            raise RuntimeError("the weights remade from the seed differ: "
                               f"{checksum} != {self.checksum}")
        spec = {"local_lr": self.fed["local_lr"],
                "compressor": self.compressor}
        out = ref.run(params0, self.x, self.y, self.counts, self.steps, spec,
                      precision=precision)
        return checks.Snapshot(out["losses"], out["grad_norms"],
                               out["change_norms"], out["station_norms"],
                               grads=out["grads"])


# ------------------------------------------------------------------ faults
def _state_unchanged(driver: Driver):
    eng = driver.engine
    orig = eng.run_rounds

    def run_rounds(params, *a, opt_state=None, **kw):
        out = orig(params, *a, opt_state=opt_state, **kw)
        return (params, opt_state) + tuple(out[2:])

    eng.run_rounds = run_rounds
    return lambda: delattr(eng, "run_rounds")


def _half_batch(driver: Driver):
    from vantage6_tpu_torch.fed import fedavg

    def make(orig):
        def local_sgd(loss_fn, x, y, idx, params, lr):
            return orig(loss_fn, x, y, idx[:, :idx.shape[1] // 2], params, lr)
        return local_sgd
    return patch(fedavg, "local_sgd", make)


def _no_exchange(driver: Driver):
    from vantage6_tpu_torch._tree import tree_map
    from vantage6_tpu_torch.fed import fedavg

    def make(orig):
        def fed_mean(stacked, *a, **kw):
            return tree_map(lambda x: x[0], stacked)
        return fed_mean
    return patch(fedavg, "fed_mean", make)


def _leaf_skipped(driver: Driver):
    from vantage6_tpu_torch.fed import fedavg

    def make(orig):
        def apply_updates(params, updates):
            out = orig(params, updates)
            out["Dense_0"]["kernel"] = params["Dense_0"]["kernel"]
            return out
        return apply_updates
    return patch(fedavg, "apply_updates", make)


# each plants a fault in the program under a built driver (before the
# check's steps) and returns the function that takes it out; for the tests
# of the check and for reading each fault's numbers on the chip
FAULTS = {
    "state_unchanged": _state_unchanged,
    "half_batch": _half_batch,
    "no_exchange": _no_exchange,
    "leaf_skipped": _leaf_skipped,
}
