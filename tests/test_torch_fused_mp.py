"""The port's fused FedAvg rounds across ranks (``run_rounds`` and
``run_rounds_async`` on a mesh over a process group) on a real two-rank
gloo group on the CPU.

On the CPU the fused round runs eagerly (``capture_form``: a CUDA graph,
whole or cut at each collective, exists only on a card), so K fused rounds
must equal K eager ``round``s over the same group bit for bit: params,
server state, losses and every learning stat, and for the async runner
the staleness it carries from round to round. Against the one-process
fused run the dense rounds differ only by the all-reduce's order of
summation: within ``TOL``, the two-rank round's tolerance of
``tests/test_torch_distributed.py``. The compressed rounds all-gather the
payloads and aggregate in the one-process order, so they equal the
one-process fused run bit for bit; there each station's local steps run
on their own in both forms (see ``tests/test_torch_compression_mp.py``).
Rank 0 also runs the one-process forms, in a child of the same kind (one
thread each). One pair of ranks serves the whole file.
"""
import pytest
import torch

from test_torch_distributed import run_ranks

TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_torch_distributed.py's TOL
# Adam divides the mean gradient by its root second moment: where an
# element's gradient is near zero, the all-reduce's last-ulp difference
# moves its step by up to the learning rate (0.01) times the relative
# change. The params of the sharded (Adam) run are held to 1e-3 of a step.
ADAM_TOL = dict(rtol=1e-5, atol=1e-5)

_BODY = """
from vantage6_tpu_torch._tree import tree_leaves
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed.compression import CompressorSpec
from vantage6_tpu_torch.fed.fedavg import AsyncRoundSpec, capture_form
from vantage6_tpu_torch.optim import adam
from vantage6_tpu_torch.utils.datasets import synthetic_image_classes
from vantage6_tpu_torch.workloads import fedavg_mnist as W

K, N, KEY = 3, 4, 5
shards = [synthetic_image_classes(8, seed=1000 + s) for s in range(N)]
counts = torch.tensor([8.0, 6.0, 8.0, 5.0])
masks = torch.ones(K, N)
masks[1, 1] = 0.0
accept = torch.tensor([[1.0, 1.0, 0.0, 1.0], [0.0, 1.0, 1.0, 1.0],
                       [1.0, 0.0, 1.0, 1.0]])
spec = AsyncRoundSpec(quorum=3, staleness_discount=0.5)


class Looped(FederationMesh):  # each station's local steps on their own
    def fed_map(self, fn, *args, replicated_args=(), batched=False):
        return super().fed_map(fn, *args, replicated_args=replicated_args)


CASES = {
    "dense": dict(mesh=FederationMesh, kw={}),
    "sharded": dict(mesh=FederationMesh, kw=dict(
        shard_server_update=True, server_optimizer=adam(0.01))),
    "compressed": dict(mesh=Looped, kw=dict(compressor=CompressorSpec(
        topk_ratio=0.25, int8=True, chunk=64))),
}


def state(opt):  # the server state's tensors (torch.load takes no classes)
    return [t for t in tree_leaves(opt) if isinstance(t, torch.Tensor)]


def stacked(stats):
    return {k: torch.stack([s[k] for s in stats]) for k in stats[0]}


def eager(eng, x, y, asynchronous):
    params = W.init_params(0, device="cpu")
    opt, gen = eng.init(params), torch.Generator().manual_seed(KEY)
    stale, losses, stats = torch.zeros(N), [], []
    for k in range(K):
        if asynchronous:
            params, opt, loss, st = eng.async_round(
                params, opt, x, y, counts, gen, accept[k], stale, spec)
            stale = torch.where(accept[k] != 0, 0.0, stale + 1.0)
        else:
            params, opt, loss, st = eng.round(params, opt, x, y, counts,
                                              key=gen, mask=masks[k])
        losses.append(loss)
        stats.append(st)
    return dict(params=params, opt=state(opt), losses=torch.stack(losses),
                stats=stacked(stats), staleness=stale)


def fused(eng, x, y, asynchronous):
    params = W.init_params(0, device="cpu")
    if asynchronous:
        params, opt, stale, losses, stats = eng.run_rounds_async(
            params, x, y, counts, KEY, K, accept, spec)
    else:
        params, opt, losses, stats = eng.run_rounds(
            params, x, y, counts, KEY, K, mask=masks)
        stale = torch.zeros(N)
    return dict(params=params, opt=state(opt), losses=losses, stats=stats,
                staleness=stale)


group = torch.distributed.group.WORLD
res["form"] = capture_form(torch.device("cpu"), group)
for name, case in CASES.items():
    layouts = {"ranks": case["mesh"](N, device="cpu", group=group)}
    if rank == 0:
        layouts["one"] = case["mesh"](N, device="cpu")
    for layout, mesh in layouts.items():
        rows = slice(mesh.local_stations.start, mesh.local_stations.stop)
        x = torch.stack([torch.from_numpy(s[0]) for s in shards])[rows]
        y = torch.stack([torch.from_numpy(s[1]) for s in shards])[rows]
        eng = W.make_engine(mesh, local_steps=2, batch_size=4, local_lr=0.1,
                            **case["kw"])
        for asynchronous in (False, True):
            res[(name, layout, "fused", asynchronous)] = fused(
                eng, x, y, asynchronous)
            if layout == "ranks":
                res[(name, layout, "eager", asynchronous)] = eager(
                    eng, x, y, asynchronous)
    res[("stations", name)] = list(layouts["ranks"].local_stations)
"""


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("fused"), _BODY, n=2)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def _assert_equal(a, b, what):
    for key in ("params", "opt", "losses", "stats", "staleness"):
        la, lb = _leaves(a[key]), _leaves(b[key])
        # sgd(1.0), the dense server step, keeps no tensor state
        assert (la or key == "opt") and len(la) == len(lb), f"{what}: {key}"
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: {key}"
    assert sorted(a["stats"]) == sorted(b["stats"])


CASES = ("dense", "sharded", "compressed")


def test_the_cpu_runs_the_fused_round_eagerly(two):
    assert [r["form"] for r in two] == ["eager", "eager"]
    assert [r[("stations", "dense")] for r in two] == [[0, 1], [2, 3]]


@pytest.mark.parametrize("asynchronous", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_fused_rounds_equal_eager_rounds_over_the_group(two, case,
                                                        asynchronous):
    for r, ranks in enumerate(two):
        _assert_equal(ranks[(case, "ranks", "fused", asynchronous)],
                      ranks[(case, "ranks", "eager", asynchronous)],
                      f"rank {r}")
    # the replicated model is the same bytes on both ranks
    a, b = (ranks[(case, "ranks", "fused", asynchronous)] for ranks in two)
    for x, y in zip(_leaves(a["params"]), _leaves(b["params"]), strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("asynchronous", [False, True])
@pytest.mark.parametrize("case", ["dense", "sharded"])
def test_dense_fused_rounds_match_the_one_process_run(two, case,
                                                      asynchronous):
    """The all-reduce sums the ranks' partial sums in another order than
    the one-process sum: within TOL, round for round (the Adam run's
    params within ADAM_TOL)."""
    one = two[0][(case, "one", "fused", asynchronous)]
    for ranks in two:
        got = ranks[(case, "ranks", "fused", asynchronous)]
        for key in ("params", "losses", "stats", "staleness"):
            la, lb = _leaves(got[key]), _leaves(one[key])
            assert la and len(la) == len(lb)
            tol = ADAM_TOL if (case, key) == ("sharded", "params") else TOL
            for x, y in zip(la, lb):
                torch.testing.assert_close(x, y, **tol)
        if case == "dense":  # sgd(1.0) keeps no tensor state
            assert _leaves(got["opt"]) == _leaves(one["opt"]) == []


@pytest.mark.parametrize("asynchronous", [False, True])
def test_compressed_fused_rounds_equal_the_one_process_run(two,
                                                           asynchronous):
    """Bit for bit, the error feedback included: each rank's EF rows are
    the one-process EF's rows."""
    one = two[0][("compressed", "one", "fused", asynchronous)]
    for r, ranks in enumerate(two):
        got = ranks[("compressed", "ranks", "fused", asynchronous)]
        ef, ef_one = got["opt"][-1], one["opt"][-1]
        assert ef.shape[0] == 2 and ef_one.shape[0] == 4
        assert torch.equal(ef, ef_one[2 * r:2 * r + 2])
        _assert_equal(dict(got, opt=got["opt"][:-1]),
                      dict(one, opt=one["opt"][:-1]), f"rank {r}")


def test_the_async_runner_carries_the_staleness(two):
    """Accepted stations reset to 0, the others age a round: after the
    three accept masks station 0 is 0, station 1 is 1, stations 2 and 3
    are 0."""
    for ranks in two:
        for case in CASES:
            got = ranks[(case, "ranks", "fused", True)]["staleness"]
            assert got.tolist() == [0.0, 1.0, 0.0, 0.0]
