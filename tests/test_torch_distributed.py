"""The port's multi-process federation (``core/distributed.py``, the
multi-rank mesh, the scattered collectives and the FedAvg round across
ranks) on real two-process gloo groups on the CPU.

The JAX package's own multi-process tests skip here (jaxlib's CPU backend
has no multi-process collectives, ``tests/test_distributed.py``), so every
multi-rank result is held to the one-process form of the same call in the
port, which the other parity files hold to the JAX package. One pair of
ranks runs every multi-rank case of this file: the children are
subprocesses that meet through a ``file://`` rendezvous in ``tmp_path``,
each with its own timeout, killed on expiry.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from vantage6_tpu_torch._tree import tree_leaves
from vantage6_tpu_torch.core import distributed as D
from vantage6_tpu_torch.core.config import FederationConfig
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed.collectives import (
    fed_mean_scattered,
    fed_mean_scattered_tree,
)
from vantage6_tpu_torch.optim import adam
from vantage6_tpu_torch.utils.datasets import synthetic_image_classes
from vantage6_tpu_torch.workloads import fedavg_mnist as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 120  # seconds per child; a stuck rendezvous fails one test
TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_torch_fedavg.py's TOL

_PRELUDE = """
import sys, torch
torch.set_num_threads(1)
from vantage6_tpu_torch.core import distributed as D
rank, world = int(sys.argv[1]), int(sys.argv[2])
assert D.initialize(sys.argv[3], world, rank, device="cpu") == (world > 1)
assert D.backend() == "gloo" and D.process_index() == rank
res = {}
"""

_EPILOGUE = """
torch.save(res, f"{sys.argv[4]}/rank{rank}.pt")
D.shutdown()
"""


def run_ranks(tmp_path, body: str, n: int = 2,
              timeout: float = CHILD_TIMEOUT) -> list[dict]:
    """Run ``body`` in ``n`` fresh Python processes, ranks of one gloo
    group (rendezvous through a file in ``tmp_path``), and return each
    rank's ``res`` dict. Every child gets ``timeout`` seconds; on expiry
    all are killed and the test fails with their stderr."""
    script = tmp_path / "rank_child.py"
    script.write_text(_PRELUDE + textwrap.dedent(body) + _EPILOGUE)
    init = f"file://{tmp_path / 'rendezvous'}"
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    for var in ("V6T_COORDINATOR", "V6T_NUM_PROCESSES", "V6T_PROCESS_ID"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(n), init, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp_path)) for r in range(n)]
    deadline = time.monotonic() + timeout
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(1.0, deadline
                                               - time.monotonic()))
            if p.returncode:
                errs.append(err[-3000:])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"a rank did not finish within {timeout} s")
    assert not errs, "\n".join(errs)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(n)]


# ------------------------------------------------------------ one process
def test_single_process_initialize_is_noop(monkeypatch):
    for var in ("V6T_COORDINATOR", "V6T_NUM_PROCESSES", "V6T_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert D.initialize() is False  # no config -> local mode, no side effect
    assert not D.is_initialized()

    # and the local-mode helpers degenerate correctly
    mesh = D.global_mesh(4, device="cpu")
    assert mesh.group is None
    assert D.local_stations(mesh) == [0, 1, 2, 3]
    sx = D.stack_local_shards(
        mesh, [np.ones(3, np.float32) * i for i in range(4)]
    )
    assert sx.shape == (4, 3)

    with pytest.raises(ValueError, match="exactly its own stations"):
        D.stack_local_shards(mesh, {0: np.ones(3, np.float32)})


def test_stack_local_shards_names_missing_and_foreign_stations():
    mesh = D.global_mesh(3, device="cpu")
    with pytest.raises(ValueError, match=r"missing \[2\], not-local \[5\]"):
        D.stack_local_shards(mesh, {0: [1.0], 1: [2.0], 5: [3.0]})


def test_auto_without_a_launcher_raises(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "V6T_COORDINATOR", "V6T_NUM_PROCESSES", "V6T_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="refusing to run single-process"):
        D.initialize(auto=True, device="cpu")
    assert not D.is_initialized()


def test_mesh_without_group_is_one_slot():
    mesh = FederationMesh(4, device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.station_axis_size,
            mesh.stations_per_slot) == (0, 1, 1, 4)
    assert list(mesh.local_stations) == [0, 1, 2, 3]
    assert mesh.fingerprint() == FederationMesh(4, device="cpu").fingerprint()
    assert mesh.fingerprint() != FederationMesh(2, device="cpu").fingerprint()
    with pytest.raises(ValueError, match="needs a process group"):
        FederationMesh(4, device="cpu", devices_per_station=2)


def test_devices_per_station_needs_a_group():
    """The config accepts a station spanning ranks, as the reference's
    does; the mesh is the one place that checks the world size."""
    cfg = FederationConfig.from_dict({
        "federation": {"devices_per_station": 2},
        "stations": [{"name": "a"}, {"name": "b"}],
    })
    assert cfg.devices_per_station == 2
    with pytest.raises(ValueError, match="needs a process group"):
        D.global_mesh(2, devices_per_station=2, device="cpu")


def test_autopilot_message_names_a_roadmap_entry():
    """The autopilot is ported: a config that enables it gets an Autopilot
    acting on the Federation, which ``close()`` detaches. What a Federation
    still refuses (stations spanning ranks) names an existing ROADMAP
    entry."""
    import re

    from vantage6_tpu_torch.runtime.autopilot import Autopilot
    from vantage6_tpu_torch.runtime.federation import Federation
    from vantage6_tpu_torch.runtime.watchdog import WATCHDOG

    cfg = FederationConfig.from_dict({
        "federation": {"autopilot": {"enabled": True}},
        "stations": [{"name": "a"}],
    })
    fed = Federation(cfg, device="cpu")
    pilot = fed.autopilot
    assert isinstance(pilot, Autopilot) and pilot.actuator is fed
    assert WATCHDOG._listeners.get(pilot._listener_key) == pilot.on_transition
    fed.close()
    assert fed.autopilot is None
    assert pilot._listener_key not in WATCHDOG._listeners
    cfg = FederationConfig.from_dict({
        "federation": {"devices_per_station": 2},
        "stations": [{"name": "a"}, {"name": "b"}],
    })
    with pytest.raises(NotImplementedError) as e:
        Federation(cfg, device="cpu")
    item = re.search(r"item (\d+)\.(\d+)", str(e.value))
    assert item, str(e.value)
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    # the queue entry exists: "11." heads the item, "2." a sub-entry of it
    head = re.search(rf"^{item.group(1)}\. .*?(?=^\d+\. |^#)", roadmap,
                     re.M | re.S)
    assert head, item.group(0)
    assert re.search(rf"^\s+{item.group(2)}\. \*\*", head.group(0), re.M)


# ------------------------------------------------------------- two ranks
# Station s of 4 (2 a rank) holds its own shards, generated locally.
_BODY = """
import numpy as np
from vantage6_tpu_torch.core.config import FederationConfig
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed import collectives as C
from vantage6_tpu_torch.utils.datasets import synthetic_image_classes
from vantage6_tpu_torch.workloads import fedavg_mnist as W
from vantage6_tpu_torch._tree import tree_leaves
from vantage6_tpu_torch.optim import adam

mesh = D.global_mesh(n_stations=4)
mine = D.local_stations(mesh)
res["stations"] = mine
res["layout"] = (mesh.rank, mesh.world_size, mesh.station_axis_size,
                 mesh.stations_per_slot)

# the reference's federated mean: station s holds s..s+3
sx = D.stack_local_shards(
    mesh, {s: np.arange(s, s + 4, dtype=np.float32) for s in mine})
sums = mesh.fed_map(lambda x: torch.stack(
    [torch.sum(x), torch.tensor(float(x.numel()))]), sx)
total = C.fed_sum(sums, mesh=mesh)
res["mean"] = float(total[0] / total[1])

# the scattered mean of a small pytree, weights and a mask over [S]
rng = np.random.default_rng(7)
tree = {"a": rng.standard_normal((4, 5, 3)).astype(np.float32),
        "b": rng.standard_normal((4, 7)).astype(np.float32)}
local = {k: D.stack_local_shards(mesh, {s: v[s] for s in mine})
         for k, v in tree.items()}
weights = torch.tensor([3.0, 1.0, 2.0, 5.0])
mask = torch.tensor([1.0, 1.0, 0.0, 1.0])
for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
    res[f"shard_{name}"] = C.fed_mean_scattered(
        mesh, local, weights=weights, mask=mask, comm_dtype=dtype)
    res[f"tree_{name}"] = C.fed_mean_scattered_tree(
        mesh, local, weights=weights, mask=mask, comm_dtype=dtype)
res["fed_mean"] = C.fed_mean(local, weights=weights, mask=mask, mesh=mesh)

# one FedAvg round, plain (sgd(1.0)) and ZeRO-1 (Adam), from one state
shards = [synthetic_image_classes(8, seed=1000 + s) for s in range(4)]
counts = torch.tensor([8.0, 6.0, 8.0, 5.0])
bidx = np.random.default_rng(3).integers(0, 5, (4, 2, 4))
fx = D.stack_local_shards(mesh, {s: shards[s][0] for s in mine})
fy = D.stack_local_shards(mesh, {s: shards[s][1] for s in mine})
for sharded in (False, True):
    eng = W.make_engine(mesh, local_steps=2, batch_size=4, local_lr=0.1,
                        shard_server_update=sharded,
                        server_optimizer=adam(0.01) if sharded else None)
    params = W.init_params(0, device="cpu")
    opt = eng.init(params)
    out = eng.round(params, opt, fx, fy, counts,
                    batch_idx=torch.from_numpy(bidx[mine]))
    res[f"round_{sharded}"] = out[0], out[2], out[3]
    drawn = eng.round(params, eng.init(params), fx, fy, counts, key=11)
    res[f"round_key_{sharded}"] = drawn[0], drawn[2], drawn[3]
    res[f"state_{sharded}"] = [tuple(t.shape) for t in tree_leaves(out[1])
                               if isinstance(t, torch.Tensor)]
    # two fused rounds across the ranks, and two eager rounds of one key
    # (the server states as their tensors: torch.load takes no classes)
    def tensors(opt):
        return [t for t in tree_leaves(opt) if isinstance(t, torch.Tensor)]

    fused = eng.run_rounds(params, fx, fy, counts, 0, 2)
    res[f"fused_{sharded}"] = fused[0], tensors(fused[1]), *fused[2:]
    p, o, gen, eager = params, eng.init(params), torch.Generator(), []
    gen.manual_seed(0)
    for _ in range(2):
        p, o, loss, st = eng.round(p, o, fx, fy, counts, key=gen)
        eager.append((loss, st))
    res[f"eager_{sharded}"] = p, tensors(o), eager

# a station spanning both ranks: accepted, with a subgroup of its own
cfg = FederationConfig.from_dict({"federation": {"devices_per_station": 2},
                                  "stations": [{"name": "a"}]})
wide = D.global_mesh(n_stations=1,
                     devices_per_station=cfg.devices_per_station)
try:  # more ranks a station than the group has
    D.global_mesh(n_stations=1, devices_per_station=3)
except ValueError as e:
    res["too_wide"] = str(e)
res["wide"] = (wide.station_axis_size, list(wide.local_stations),
               torch.distributed.get_world_size(wide.device_group))
# one station for two ranks of one device each: rank 1 hosts none
narrow = D.global_mesh(n_stations=1)
try:
    D.stack_local_shards(narrow, {0: np.zeros(2)} if rank == 0 else {})
    res["narrow"] = "ok"
except ValueError as e:
    res["narrow"] = str(e)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("ranks"), _BODY)


def _tree_inputs():
    rng = np.random.default_rng(7)
    tree = {"a": rng.standard_normal((4, 5, 3)).astype(np.float32),
            "b": rng.standard_normal((4, 7)).astype(np.float32)}
    return ({k: torch.from_numpy(v) for k, v in tree.items()},
            torch.tensor([3.0, 1.0, 2.0, 5.0]),
            torch.tensor([1.0, 1.0, 0.0, 1.0]))


def test_two_rank_federated_mean(ranks):
    all_vals = np.concatenate(
        [np.arange(s, s + 4, dtype=np.float32) for s in range(4)])
    hosted = sorted(i for r in ranks for i in r["stations"])
    assert hosted == [0, 1, 2, 3]  # exact partition
    assert [r["stations"] for r in ranks] == [[0, 1], [2, 3]]
    assert [r["layout"] for r in ranks] == [(0, 2, 2, 2), (1, 2, 2, 2)]
    for r in ranks:
        np.testing.assert_allclose(r["mean"], all_vals.mean(), rtol=1e-6)
    assert ranks[0]["mean"] == ranks[1]["mean"]


def test_scattered_mean_f32_matches_one_process(ranks):
    stacked, w, m = _tree_inputs()
    mesh = FederationMesh(4, device="cpu")
    whole = fed_mean_scattered(mesh, stacked, weights=w, mask=m)
    tree = fed_mean_scattered_tree(mesh, stacked, weights=w, mask=m)
    n = whole.numel()  # 22 elements: padded to 22, D = 2 shards of 11
    assert [r["shard_f32"].numel() for r in ranks] == [n // 2, n // 2]
    got = torch.cat([r["shard_f32"] for r in ranks])
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=0)
    for r in ranks:
        for k in tree:
            torch.testing.assert_close(r["tree_f32"][k], tree[k], rtol=1e-6,
                                       atol=0)
            torch.testing.assert_close(r["fed_mean"][k], tree[k], rtol=1e-6,
                                       atol=1e-7)
            assert torch.equal(r["tree_f32"][k], ranks[0]["tree_f32"][k])


def test_scattered_mean_bf16_combines_partials_in_bf16(ranks):
    """Across D = 2 slots each slot's f32 partial sum is rounded to bf16
    and the two combine in bf16: three roundings of at most u = 2^-8
    relative (bf16 keeps 8 significant bits), so the mean is off by at
    most 3u (|p0| + |p1|) over the total weight. The one-card form rounds
    the pooled sum once: u |mean|."""
    stacked, w, m = _tree_inputs()
    eff = w * m
    flat = torch.cat([x.reshape(4, -1) for x in stacked.values()], 1)
    partials = [(eff[i:i + 2, None] * flat[i:i + 2]).sum(0)
                for i in (0, 2)]
    exact = (partials[0] + partials[1]) / eff.sum()
    u = 2.0**-8
    bound = 3 * u * (partials[0].abs() + partials[1].abs()) / eff.sum()
    got = torch.cat([r["shard_bf16"] for r in ranks])
    assert torch.all((got - exact).abs() <= bound + 1e-7)
    one_card = fed_mean_scattered(FederationMesh(4, device="cpu"), stacked,
                                  weights=w, mask=m,
                                  comm_dtype=torch.bfloat16)
    assert torch.all((one_card - exact).abs()
                     <= u * exact.abs() + 1e-7)
    for k in ranks[0]["tree_bf16"]:
        assert torch.equal(ranks[0]["tree_bf16"][k], ranks[1]["tree_bf16"][k])


def _one_process_round(sharded, **draw):
    mesh = FederationMesh(4, device="cpu")
    shards = [synthetic_image_classes(8, seed=1000 + s) for s in range(4)]
    sx = torch.from_numpy(np.stack([s[0] for s in shards]))
    sy = torch.from_numpy(np.stack([s[1] for s in shards]))
    counts = torch.tensor([8.0, 6.0, 8.0, 5.0])
    eng = W.make_engine(mesh, local_steps=2, batch_size=4, local_lr=0.1,
                        shard_server_update=sharded,
                        server_optimizer=adam(0.01) if sharded else None)
    params = W.init_params(0, device="cpu")
    return eng.round(params, eng.init(params), sx, sy, counts, **draw)


def _assert_round_matches(outs, ref):
    ref_p, _, ref_loss, ref_stats = ref
    for p, loss, stats in outs:
        for k in ref_p:
            torch.testing.assert_close(p[k], ref_p[k], **TOL)
        torch.testing.assert_close(loss, ref_loss, **TOL)
        for k in ref_stats:
            torch.testing.assert_close(stats[k], ref_stats[k], **TOL)
    # the aggregate is replicated: both ranks hold the identical model
    for a, b in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0]),
                    strict=True):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("sharded", [False, True])
def test_two_rank_fedavg_round_matches_one_process(ranks, sharded):
    bidx = np.random.default_rng(3).integers(0, 5, (4, 2, 4))
    ref = _one_process_round(sharded, batch_idx=torch.from_numpy(bidx))
    _assert_round_matches([r[f"round_{sharded}"] for r in ranks], ref)
    if sharded:  # each slot keeps half the flat Adam state
        n_pad = sum(v.numel() for v in tree_leaves(ref[0]))
        n_pad += n_pad % 2
        for r in ranks:
            assert r["state_True"] == [(), (n_pad // 2,), (n_pad // 2,)]


@pytest.mark.parametrize("sharded", [False, True])
def test_two_rank_fedavg_round_with_a_key_matches_one_process(ranks,
                                                              sharded):
    """Each rank draws the global [S, steps, batch] indices from the key
    and keeps its stations' rows: the one-process round's batches."""
    ref = _one_process_round(sharded, key=11)
    _assert_round_matches([r[f"round_key_{sharded}"] for r in ranks], ref)


@pytest.mark.parametrize("sharded", [False, True])
def test_fused_rounds_across_ranks_raise(ranks, sharded):
    """Named for what it held before ROADMAP item 12.1: the fused run (a
    CUDA graph on the card, eager on the CPU) across ranks raised. It runs
    now, and two fused rounds equal two eager rounds of the same key over
    the same group bit for bit: params, server state, losses and stats."""
    for r in ranks:
        params, opt, losses, stats = r[f"fused_{sharded}"]
        e_params, e_opt, eager = r[f"eager_{sharded}"]
        for a, b in zip(tree_leaves(params), tree_leaves(e_params),
                        strict=True):
            assert torch.equal(a, b)
        assert len(opt) == len(e_opt) == (3 if sharded else 0)
        assert all(torch.equal(a, b) for a, b in zip(opt, e_opt))
        assert torch.equal(losses, torch.stack([loss for loss, _ in eager]))
        for k, v in stats.items():
            assert torch.equal(v, torch.stack([st[k] for _, st in eager]))


def test_devices_per_station_over_two_ranks(ranks):
    for r in ranks:
        assert r["wide"] == (1, [0], 2)
        assert "invalid devices_per_station 3 for a group of 2" in (
            r["too_wide"])
    assert ranks[0]["narrow"] == "ok"
    assert "process 1 hosts NO stations" in ranks[1]["narrow"]
