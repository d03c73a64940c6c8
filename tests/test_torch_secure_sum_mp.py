"""The port's secure sum across ranks (``secure_sum(mesh=)``,
``secure_fed_mean(mesh=)``) on real gloo groups on the CPU.

Each rank quantizes its own stations' values, adds every pairwise mask its
stations add on one card (a pair mask is a function of the key and the two
global station indices), sums its rows in int64 and all-reduces the int64
partials; the one wrap to int32 comes last. The sum is integer arithmetic
throughout, so it is the one-process sum bit for bit whatever the layout:
4 stations on 2 ranks, 6 on 2, 4 on 4, and 6 on 4, where the mesh takes 3
slots of 2 and the fourth rank hosts no station. Station 1 is masked out.
The one-process forms are held to the JAX package by
``tests/test_torch_collectives.py``. One group of each size serves the
whole file.
"""
import inspect

import numpy as np
import pytest
import torch

from test_torch_distributed import run_ranks
from vantage6_tpu_torch.fed import collectives as C

KEY, SCALE = 7, 2.0**16
STATIONS = (4, 6)


def _inputs(n_stations):
    """Station values, a masked station, weights, a pytree, and values
    whose int32 sum wraps (each station's quantized value is 1.31e9)."""
    rng = np.random.default_rng(n_stations)
    mask = np.ones(n_stations, np.float32)
    mask[1] = 0.0
    return dict(
        values=rng.normal(0.0, 3.0, (n_stations, 5, 3)).astype(np.float32),
        mask=mask,
        weights=rng.integers(1, 50, n_stations).astype(np.float32),
        tree={"a": rng.normal(size=(n_stations, 4, 2)).astype(np.float32),
              "b": rng.normal(size=(n_stations, 9)).astype(np.float32)},
        big=np.full((n_stations, 3), 2.0e4, np.float32),
    )


_BODY = (f"""
import numpy as np
from vantage6_tpu_torch.fed import collectives as C
KEY, SCALE, STATIONS = {KEY!r}, {SCALE!r}, {STATIONS!r}
""" + inspect.getsource(_inputs) + """
for n_stations in STATIONS:
    mesh = D.global_mesh(n_stations=n_stations)
    mine = D.local_stations(mesh)
    res[("stations", n_stations)] = mine
    if not mine:  # the mesh left this rank without a station slot
        continue
    x = _inputs(n_stations)
    local = {k: D.stack_local_shards(mesh, {s: v[s] for s in mine})
             for k, v in x.items() if k != "tree" and v.ndim > 1}
    tree = {k: D.stack_local_shards(mesh, {s: v[s] for s in mine})
            for k, v in x["tree"].items()}
    mask = torch.from_numpy(x["mask"])
    res[(n_stations, "sum")] = C.secure_sum(local["values"], KEY, SCALE,
                                            mask=mask, mesh=mesh)
    res[(n_stations, "big")] = C.secure_sum(local["big"], KEY, SCALE,
                                            mesh=mesh)
    res[(n_stations, "mean")] = C.secure_fed_mean(
        tree, torch.from_numpy(x["weights"] * x["mask"]), KEY, SCALE,
        mesh=mesh)
    # the masks alone: zeroed values, masked and summed, give exactly 0
    zeros = torch.zeros((len(mine), 5, 3), dtype=torch.int32)
    masked = C.mask_station_value(KEY, zeros, mesh.local_stations,
                                  n_stations)
    res[(n_stations, "masked")] = masked
    total = torch.sum(masked, dim=0, dtype=torch.int64)
    torch.distributed.all_reduce(total, group=mesh.station_group)
    res[(n_stations, "cancel")] = C._wrap32(total)
    try:  # the whole [S] block where the local one belongs
        C.secure_sum(torch.from_numpy(x["values"]), KEY, SCALE, mesh=mesh)
    except ValueError as e:
        res[(n_stations, "error")] = str(e)
""")


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("two"), _BODY, n=2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("four"), _BODY, n=4)


def _hosting(ranks, n_stations):
    hosting = [r for r in ranks if r[("stations", n_stations)]]
    per = n_stations // len(hosting)
    assert [r[("stations", n_stations)] for r in hosting] == [
        list(range(i * per, (i + 1) * per)) for i in range(len(hosting))]
    return hosting


LAYOUTS = [(world, n) for world in (2, 4) for n in STATIONS]


@pytest.mark.parametrize("world,n_stations", LAYOUTS)
def test_secure_sum_equals_the_one_process_sum(two, four, world,
                                               n_stations):
    x = _inputs(n_stations)
    hosting = _hosting({2: two, 4: four}[world], n_stations)
    assert len(hosting) == (3 if (world, n_stations) == (4, 6) else world)
    one = C.secure_sum(torch.from_numpy(x["values"]), KEY, SCALE,
                       mask=torch.from_numpy(x["mask"]))
    big = C.secure_sum(torch.from_numpy(x["big"]), KEY, SCALE)
    # the int32 sum wraps: 4 or 6 stations of 1.31e9 each
    q = n_stations * int(2.0e4 * SCALE)
    wrapped = ((q + 2**31) % 2**32 - 2**31) / SCALE
    assert torch.equal(big, torch.full((3,), wrapped))
    for r in hosting:
        assert torch.equal(r[(n_stations, "sum")], one)
        assert torch.equal(r[(n_stations, "big")], big)
    # the masked station's values are left out, to the quantum
    plain = (x["values"] * x["mask"][:, None, None]).sum(0)
    np.testing.assert_allclose(one.numpy(), plain,
                               atol=n_stations / (2 * SCALE))


@pytest.mark.parametrize("world,n_stations", LAYOUTS)
def test_secure_fed_mean_equals_the_one_process_mean(two, four, world,
                                                     n_stations):
    x = _inputs(n_stations)
    tree = {k: torch.from_numpy(v) for k, v in x["tree"].items()}
    one = C.secure_fed_mean(tree, torch.from_numpy(x["weights"] * x["mask"]),
                            KEY, SCALE)
    for r in _hosting({2: two, 4: four}[world], n_stations):
        got = r[(n_stations, "mean")]
        assert list(got) == list(one)
        for k in one:
            assert torch.equal(got[k], one[k])


@pytest.mark.parametrize("world,n_stations", LAYOUTS)
def test_masks_cancel_and_match_the_one_process_masks(two, four, world,
                                                      n_stations):
    """Zeroed values, masked on each rank and summed across ranks, give
    exactly 0, and each rank's masked rows are the one-process rows of its
    stations."""
    zeros = torch.zeros((n_stations, 5, 3), dtype=torch.int32)
    one = C.mask_station_value(KEY, zeros)
    for r in _hosting({2: two, 4: four}[world], n_stations):
        stations = r[("stations", n_stations)]
        assert torch.equal(r[(n_stations, "masked")], one[stations])
        assert not torch.equal(r[(n_stations, "masked")],
                               zeros[stations])
        assert torch.equal(r[(n_stations, "cancel")],
                           torch.zeros((5, 3), dtype=torch.int32))


def test_a_whole_block_on_a_rank_is_named(two):
    for r in two:
        for n_stations in STATIONS:
            assert (f"stacked has {n_stations} stations but rank"
                    in r[(n_stations, "error")])
