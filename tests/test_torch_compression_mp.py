"""The port's compressed FedAvg round across ranks (``FedAvg(compressor=)``
on a mesh over a process group) on real gloo groups on the CPU.

Every rank holds the error-feedback accumulators of its own stations
(``[S_local, N]``), draws the global rounding noise and keeps its rows, and
all-gathers the compressed payloads, from which it reconstructs every
station's delta and aggregates them in the one-process order. So the round
is the one-process round bit for bit, whatever the layout, given the same
local updates. The one-process round runs in a child of the same kind, one
thread each (a BLAS call's summation order depends on the thread count),
and the test holds the two equal with ``torch.equal``. Each station's local
steps run on their own (``fed_map`` without ``batched``) in both forms:
under ``vmap`` the CPU's batched kernels are not invariant to the number of
stations batched (in the third round at 6 stations on 2 ranks, station 5's
local loss from a block of 3 differed from its loss in the block of 6 in
the fourth digit, from identical parameters, indices and data), which no
layout of the aggregation can undo. The
one-process round is held to the JAX package's by
``tests/test_torch_compression.py``.

Layouts: 4 stations on 2 ranks (2 a rank), 6 on 2 (3 a rank), 4 on 4 (1 a
rank) and 6 on 4, where the mesh takes 3 slots of 2 and the fourth rank
hosts no station. Each runs three EF-carrying rounds from one key, station
1 masked out in the second, with top-k and int8 together, under the plain
server step and under ``shard_server_update`` (Adam); top-k alone and int8
alone run at 4 stations on 2 ranks. Rank 0 also runs the one-process
rounds, which every rank is held to. One group of each size serves the
whole file.
"""
import pytest
import torch

from test_torch_distributed import run_ranks

_BODY = """
import numpy as np
from vantage6_tpu_torch._tree import tree_leaves
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed.compression import CompressorSpec
from vantage6_tpu_torch.optim import adam
from vantage6_tpu_torch.utils.datasets import synthetic_image_classes
from vantage6_tpu_torch.workloads import fedavg_mnist as W

COMPRESSORS = {
    "topk": CompressorSpec(topk_ratio=0.25),
    "int8": CompressorSpec(int8=True, chunk=64),
    "topk_int8": CompressorSpec(topk_ratio=0.25, int8=True, chunk=64),
}
# top-k with int8 at every layout, each compressor alone at 4 on 2 ranks
BOTH = [("topk_int8", False), ("topk_int8", True)]
ALONE = [("topk", False), ("int8", False)]
ROUNDS, MASKED_ROUND, MASKED = 3, 1, 1

# each station's local steps on its own (see the module's docstring)
_fed_map = FederationMesh.fed_map
FederationMesh.fed_map = lambda self, fn, *args, replicated_args=(), \
    batched=False: _fed_map(self, fn, *args, replicated_args=replicated_args)

for n_stations in (4, 6):
    mesh = D.global_mesh(n_stations=n_stations)
    mine = D.local_stations(mesh)
    res[("stations", n_stations)] = mine
    if not mine:  # the mesh left this rank without a station slot
        continue
    shards = [synthetic_image_classes(8, seed=1000 + s)
              for s in range(n_stations)]
    counts = torch.tensor([8.0, 6.0, 8.0, 5.0, 7.0, 4.0][:n_stations])
    mask = torch.ones(n_stations)
    mask[MASKED] = 0.0
    data = {
        "ranks": (mesh,
                  D.stack_local_shards(mesh, {s: shards[s][0] for s in mine}),
                  D.stack_local_shards(mesh, {s: shards[s][1] for s in mine})),
    }
    if rank == 0:  # the one-process round, held against every rank's
        data["one"] = (FederationMesh(n_stations, device="cpu"),
                       torch.from_numpy(np.stack([x for x, _ in shards])),
                       torch.from_numpy(np.stack([y for _, y in shards])))
    for name, sharded in BOTH + (ALONE if (world, n_stations) == (2, 4)
                                 else []):
        for form, (m, sx, sy) in data.items():
            eng = W.make_engine(
                m, local_steps=2, batch_size=4, local_lr=0.1,
                compressor=COMPRESSORS[name], shard_server_update=sharded,
                server_optimizer=adam(0.01) if sharded else None)
            params = W.init_params(0, device="cpu")
            opt = eng.init(params)
            gen = torch.Generator().manual_seed(5)
            rounds = []
            for r in range(ROUNDS):
                params, opt, loss, stats = eng.round(
                    params, opt, sx, sy, counts, key=gen,
                    mask=mask if r == MASKED_ROUND else None)
                # the server state as its tensors (torch.load takes no
                # optimizer classes)
                server = [t for t in tree_leaves(opt["server"])
                          if isinstance(t, torch.Tensor)]
                rounds.append((params, {"ef": opt["ef"], "server": server},
                               loss, stats))
            res[(n_stations, name, sharded, form)] = rounds
            if form == "ranks" and not sharded:
                # the fused run across the ranks, against eager rounds
                params0 = W.init_params(0, device="cpu")
                fused = eng.run_rounds(params0, sx, sy, counts, 0, 2)
                p, o = params0, eng.init(params0)
                gen, eager = torch.Generator().manual_seed(0), []
                for _ in range(2):
                    p, o, loss, st = eng.round(p, o, sx, sy, counts, key=gen)
                    eager.append(loss)
                res[("fused", n_stations, name)] = (
                    fused[0], fused[1]["ef"], fused[2], p, o["ef"],
                    torch.stack(eager))
"""


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("two"), _BODY, n=2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("four"), _BODY, n=4)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in x for t in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


LAYOUT_CASES = (
    [(2, 4, name, False) for name in ("topk", "int8", "topk_int8")]
    + [(world, n, "topk_int8", sharded) for world in (2, 4) for n in (4, 6)
       for sharded in (False, True) if (world, n, sharded) != (2, 4, False)]
)


@pytest.mark.parametrize("world,n_stations,name,sharded", LAYOUT_CASES)
def test_compressed_rounds_equal_the_one_process_rounds(
        two, four, world, n_stations, name, sharded):
    ranks = {2: two, 4: four}[world]
    hosting = [r for r in ranks if r[("stations", n_stations)]]
    per = n_stations // len(hosting)
    assert [r[("stations", n_stations)] for r in hosting] == [
        list(range(i * per, (i + 1) * per)) for i in range(len(hosting))]
    assert len(hosting) == (3 if (world, n_stations) == (4, 6) else world)
    one = ranks[0][(n_stations, name, sharded, "one")]
    assert _leaves(one[0][0])
    for r in hosting:
        rounds = r[(n_stations, name, sharded, "ranks")]
        rows = slice(r[("stations", n_stations)][0],
                     r[("stations", n_stations)][-1] + 1)
        for k, ((p, opt, loss, stats), (p1, opt1, loss1, stats1)) in (
                enumerate(zip(rounds, one))):
            assert _equal(p, p1), f"round {k}: params"
            assert torch.equal(loss, loss1), f"round {k}: loss"
            assert list(stats) == list(stats1)
            assert _equal(stats, stats1), f"round {k}: learning stats"
            # the rank's EF rows are the one-process EF's rows; the server
            # state (a shard of it under shard_server_update) is the same
            assert opt["ef"].shape == (per, opt1["ef"].shape[1])
            assert torch.equal(opt["ef"], opt1["ef"][rows]), f"round {k}"
            if not sharded:
                assert _equal(opt["server"], opt1["server"])
        # the replicated model is the same bytes on every rank
        assert _equal(rounds[-1][0], hosting[0][
            (n_stations, name, sharded, "ranks")][-1][0])


def test_a_masked_stations_accumulator_waits(two):
    """Station 1, masked out in round 1, ships nothing: its EF row after
    round 1 is its row after round 0; the others' rows move."""
    rounds = two[0][(4, "topk_int8", False, "ranks")]
    ef0, ef1 = rounds[0][1]["ef"], rounds[1][1]["ef"]
    assert torch.equal(ef1[1], ef0[1])
    assert not torch.equal(ef1[0], ef0[0])
    assert float(rounds[1][3]["station_weight"][1]) == 0.0


def test_fused_compressed_rounds_across_ranks_raise(two, four):
    """Named for what it held before ROADMAP item 12.1: a compressed
    FedAvg's fused run across ranks raised. It runs now, and two fused
    rounds equal two eager rounds of the same key over the same group bit
    for bit: params, each rank's EF rows and the losses."""
    runs = [r[k] for r in (*two, *four[:3]) for k in r
            if isinstance(k, tuple) and k[0] == "fused"]
    # two ranks: 3 compressors at 4 stations, 1 at 6; three of four ranks:
    # 1 at 4 and 1 at 6 (the fourth holds no station at 6)
    assert len(runs) == 2 * (3 + 1) + 3 * (1 + 1)
    for params, ef, losses, e_params, e_ef, e_losses in runs:
        assert _equal(params, e_params)
        assert torch.equal(ef, e_ef) and torch.equal(losses, e_losses)
