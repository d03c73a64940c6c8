"""The port's ``Federation`` over the ranks of a process group
(``Federation(..., group=)``) on a real two-rank gloo group on the CPU, at
``devices_per_station`` 1 (a slot a rank, two stations each) and 2 (one
slot of both ranks, all four stations).

Both ranks run the same task program: the flagship ``central_fedavg``
(a host central over device-mode rounds), ``central_average`` (a host
central over host partials), ``central_secure_average_dh`` (a secure sum
whose partials draw on their station's secret and sign with its identity
key), a central that calls ``aggregate_stacked`` from inside its run, the
same central on station 3 (rank 1's at ``devices_per_station`` 1),
started without waiting and followed at once by the next top-level task,
and a device-mode partial aggregated with ``aggregate_stacked`` from the
program. Each rank's task records (names, methods, parents, statuses,
results, participation and the stacked results read through the runs)
are held against those of the one-process ``Federation`` on the same
data, which rank 0 also runs; each host run must execute once over both
ranks, on the first rank of its station's slot; and every event of the
ranks' log is gone from the store at the end.

The device steps run as users run them: ``fed_map(batched=True)``, one
``vmap`` over the rank's ``[S_local, ...]`` block. A batched kernel's
bits can depend on how many stations it batches, so where a rank holds
fewer stations than one process (``devices_per_station`` 1) the device
rows and what derives from them are held at ``DEVICE_TOL``; host records
are held bit for bit. A second pass at ``devices_per_station`` 1 runs each
station's function on its own (``LOOPED``) in both forms, and there every
record is bit for bit the one-process one. One case holds the port's
central_average at ``devices_per_station = 2`` against the JAX
``Federation`` at ``devices_per_station=2`` on conftest's 8 fake CPU
devices.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_distributed import run_ranks

N = 4
AGES = [np.random.default_rng(50 + s).uniform(20, 80, 9 + 3 * s).round(1)
        for s in range(N)]

_BODY = """
import numpy as np
import pandas as pd
from vantage6_tpu_torch.algorithm.decorators import algorithm_client
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.runtime.federation import (
    Federation,
    federation_from_datasets,
)
from vantage6_tpu_torch.utils.datasets import synthetic_image_classes
from vantage6_tpu_torch.workloads import average, secure_average
from vantage6_tpu_torch.workloads import fedavg_mnist as W

N = 4
_fed_map = FederationMesh.fed_map


def looped(self, fn, *args, replicated_args=(), batched=False):
    # fed_map running each station's function on its own
    return _fed_map(self, fn, *args, replicated_args=replicated_args)

# every host run executed in this process: (method, station)
executed = []
_execute = Federation._execute_host


def counting(self, task, fn, run, trace_parent=None):
    if self.mesh.group is not None:
        executed.append((task.method, run.station_index))
    return _execute(self, task, fn, run, trace_parent)


Federation._execute_host = counting


@algorithm_client
def central_aggregate(client, column_index):
    task = client.task.create(
        input_={"method": "partial_average_device",
                "kwargs": {"column_index": column_index}},
        organizations=[o["id"] for o in client.organization.list()])
    weights = torch.tensor([1.0, 2.0, 3.0, 4.0])
    return client.aggregate_stacked(task["id"], weights=weights)


ALGOS = {"fedavg": W, "avg": average, "sec": secure_average,
         "agg": {"central_aggregate": central_aggregate,
                 "partial_average_device": average.partial_average_device}}
shards = [synthetic_image_classes(8, seed=1000 + s) for s in range(N)]
images = [{"x": torch.from_numpy(x), "y": torch.from_numpy(y),
           "count": torch.tensor(float(len(y))),
           "sid": torch.tensor(s)} for s, (x, y) in enumerate(shards)]
ages = [pd.DataFrame({"age": a}) for a in np.load(
    f"{sys.argv[4]}/ages.npy", allow_pickle=True)]


def task_program(fed):
    # a central's subtasks read the "default" database: the images for
    # the CNN's and the aggregations' rounds, the ages for the averages'
    for image, method, kwargs, data in (
        ("fedavg", "central_fedavg", dict(n_rounds=2, local_steps=2,
                                          batch_size=4, lr=0.1, seed=0),
         images),
        ("avg", "central_average", {"column": "age"}, ages),
        ("sec", "central_secure_average_dh", {"column": "age"}, ages),
        ("agg", "central_aggregate", {"column_index": 1}, images),
    ):
        fed.set_datasets("default", data)
        fed.create_task(image, {"method": method, "kwargs": kwargs},
                        organizations=[0])
    # the central on station 3, not waited for: its subtask and its
    # aggregation may come after the next top-level task's event
    late = fed.create_task("agg", {"method": "central_aggregate",
                                   "kwargs": {"column_index": 0}},
                           organizations=[3], wait=False)
    t = fed.create_task("agg", {"method": "partial_average_device",
                                "kwargs": {"column_index": 2}})
    fed.wait_for_results(late.id)
    top_agg = fed.aggregate_stacked(t, weights=torch.tensor([4.0, 3, 2, 1]))
    # the tasks in the program's order, each followed by its subtasks
    # (their ids depend on when the runs create them)
    order = []

    def visit(task):
        order.append(task)
        for c in sorted((c for c in fed.tasks.values()
                         if c.parent_id == task.id), key=lambda c: c.id):
            visit(c)

    for task in sorted(fed.tasks.values(), key=lambda c: c.id):
        if task.parent_id is None:
            visit(task)
    index = {task.id: i for i, task in enumerate(order)}
    records = [dict(
        name=task.name, method=task.method,
        parent=index.get(task.parent_id),
        statuses=[r.status.value for r in task.runs],
        stations=[r.station_index for r in task.runs],
        results=[r.result for r in task.runs],
        participation=task.participation,
        stacked=task.stacked_result) for task in order]
    return records, top_agg


def plain(x):  # what torch.load takes back: numpy as tensors and floats
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


layouts = {dps: dict(group=torch.distributed.group.WORLD,
                     devices_per_station=dps) for dps in (1, 2)}
layouts["1-looped"] = layouts[1]
if rank == 0:
    layouts["one"] = layouts["one-looped"] = {}
for name, kw in layouts.items():
    executed.clear()
    FederationMesh.fed_map = looped if "looped" in str(name) else _fed_map
    fed = federation_from_datasets(images, ALGOS, device="cpu",
                                   executor_workers=4, **kw)
    try:
        records, top_agg = task_program(fed)
    finally:
        fed.close()
        FederationMesh.fed_map = _fed_map
    left = None
    if fed._plane is not None:  # every event applied on both ranks
        torch.distributed.barrier()
        store = fed._plane.store
        left = [i for i in range(1, store.add("log/n", 0) + 1)
                if store.check([f"log/{i}"]) or store.check([f"done/{i}"])]
    res[name] = dict(records=plain(records), top_agg=top_agg,
                     executed=list(executed), events_left=left,
                     owners={s: fed._plane.owner(s) for s in range(N)}
                     if fed._plane is not None else None)
"""


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    d = tmp_path_factory.mktemp("federation")
    np.save(d / "ages.npy", np.array(AGES, dtype=object), allow_pickle=True)
    return run_ranks(d, _BODY, n=2, timeout=180)


# each rank's form, the one-process form it is held against, and whether
# it holds fewer stations a rank than that one does
FORMS = {1: ("one", True), 2: ("one", False),
         "1-looped": ("one-looped", False)}
# an aggregation over two slots all-reduces two partial sums, where one
# process sums the four stations in turn: four ulps of f32
AGG_RTOL = 1e-6
# the device rows where a rank batches fewer stations than one process,
# and what derives from them: tests/test_torch_distributed.py's TOL for a
# two-rank round (on this CPU they were bit for bit)
DEVICE_TOL = dict(rtol=1e-5, atol=1e-6)
# the DH protocol's public keys, signatures and masked uploads derive from
# each federation's own secrets and keys (drawn from ``secrets``), so two
# federations, one process or not, agree on their shape and on the
# average they unmask, not on their bytes
KEYED = {"partial_advertise_mask_key": ("party_index",),
         "partial_secure_average_dh": ()}


def _equal(a, b, rtol=0.0, atol=0.0):
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape
                and bool(torch.all((a - b).abs() <= atol + rtol * b.abs())))
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_equal(a[k], b[k], rtol, atol) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_equal(x, y, rtol, atol) for x, y in zip(a, b)))
    return a == b


def _same_results(got, want, method, tol):
    if method in KEYED:
        return [sorted(r) for r in got] == [sorted(r) for r in want] and all(
            r[k] == w[k] for r, w in zip(got, want) for k in KEYED[method])
    return _equal(got, want, **tol)


def _device_derived(records):
    """Per record: it has device rows, or a subtask of it has."""
    out = [r["stacked"] is not None for r in records]
    for k in reversed(range(len(records))):  # subtasks follow parents
        if out[k] and records[k]["parent"] is not None:
            out[records[k]["parent"]] = True
    return out


def _tol(form, record, derived):
    _, fewer = FORMS[form]
    if fewer and derived:
        return DEVICE_TOL
    two_slots = form in (1, "1-looped")
    if two_slots and record["method"] == "central_aggregate":
        return dict(rtol=AGG_RTOL)
    return {}


@pytest.mark.parametrize("form", list(FORMS))
def test_every_rank_holds_the_one_process_records(two, form):
    """Bit for bit, but for the keyed DH records (KEYED), the aggregations
    a central makes over two slots (AGG_RTOL) and, where a rank batches
    fewer stations, the device rows and what derives from them
    (DEVICE_TOL)."""
    one = two[0][FORMS[form][0]]["records"]
    assert [r["method"] for r in one] == [
        "central_fedavg", "partial_train", "partial_train",
        "central_average", "partial_average",
        "central_secure_average_dh", *["partial_advertise_mask_key"] * 4,
        *["partial_secure_average_dh"] * 4,
        "central_aggregate", "partial_average_device",
        "central_aggregate", "partial_average_device",
        "partial_average_device"]
    assert all(s == "completed" for r in one for s in r["statuses"])
    derived = _device_derived(one)
    for rank, ranks in enumerate(two):
        got = ranks[form]["records"]
        assert len(got) == len(one)
        for k, (a, b) in enumerate(zip(got, one)):
            tol = _tol(form, b, derived[k])
            for key in a:
                if key == "results":
                    assert _same_results(a[key], b[key], b["method"], tol), (
                        rank, k, b["method"])
                elif key == "stacked":
                    assert _equal(a[key], b[key], **tol), (rank, k, key)
                else:
                    assert _equal(a[key], b[key]), (rank, k, b["method"], key)


@pytest.mark.parametrize("form", list(FORMS))
def test_an_aggregation_in_the_program_is_the_one_process_one(two, form):
    """Over one slot the same sums bit for bit, over two within AGG_RTOL
    (and DEVICE_TOL where a rank batches fewer stations); both ranks hold
    the same bytes."""
    tol = (DEVICE_TOL if FORMS[form][1]
           else dict(rtol=AGG_RTOL) if form != 2 else {})
    for ranks in two:
        assert _equal(ranks[form]["top_agg"],
                      two[0][FORMS[form][0]]["top_agg"], **tol)
    assert _equal(two[0][form]["top_agg"], two[1][form]["top_agg"])


@pytest.mark.parametrize("form", list(FORMS))
def test_each_host_run_executes_once_on_its_stations_first_rank(two, form):
    owners = two[0][form]["owners"]
    assert owners == ({0: 0, 1: 0, 2: 1, 3: 1} if form != 2
                      else dict.fromkeys(range(N), 0))
    runs = [(m, s, rank) for rank, ranks in enumerate(two)
            for m, s in ranks[form]["executed"]]
    one = two[0][FORMS[form][0]]["records"]
    want = sorted((r["method"], s) for r in one for s in r["stations"]
                  if r["stacked"] is None)
    assert sorted((m, s) for m, s, _ in runs) == want  # once each
    assert all(owners[s] == rank for _, s, rank in runs)
    if form != 2:  # the central on station 3 ran on rank 1
        assert ("central_aggregate", 3, 1) in runs


@pytest.mark.parametrize("form", list(FORMS))
def test_every_event_leaves_the_store(two, form):
    """The last rank to apply an event deletes it and its count."""
    assert [ranks[form]["events_left"] for ranks in two] == [[], []]


def test_an_unshareable_payload_never_reaches_the_store():
    """A payload ``loads`` would refuse never reaches the store."""
    from vantage6_tpu_torch.runtime import ranks

    blob = ranks.dumps({"x": torch.ones(2), "a": np.arange(3),
                        "f": np.float32(1.5), "t": (1, "s", b"b", None)})
    back = ranks.loads(blob, torch.device("cpu"))
    assert back["a"].tolist() == [0, 1, 2] and back["f"] == np.float32(1.5)
    with pytest.raises(ranks.UnshareableError, match="DataFrame"):
        ranks.dumps({"df": pd.DataFrame({"a": [1]})})


def test_central_average_matches_jax_at_two_devices_a_station(two):
    """The JAX Federation at devices_per_station=2 over conftest's 8
    devices (4 stations of 2 devices), the same data: the same pooled
    average and count as every rank's."""
    from vantage6_tpu.core.config import (
        DatabaseConfig,
        FederationConfig,
        StationConfig,
    )
    from vantage6_tpu.runtime.federation import Federation
    from vantage6_tpu.workloads import average

    cfg = FederationConfig(
        name="mock", devices_per_station=2, executor_workers=0,
        stations=[StationConfig(name=f"station_{i}", organization=f"org_{i}",
                                databases=[DatabaseConfig(label="default",
                                                          type="array")])
                  for i in range(N)])
    fed = Federation(cfg, algorithms={"avg": average})
    try:
        fed.set_datasets("default",
                         [pd.DataFrame({"age": a}) for a in AGES])
        t = fed.create_task("avg", {"method": "central_average",
                                    "kwargs": {"column": "age"}},
                            organizations=[0])
        (want,) = fed.wait_for_results(t.id)
    finally:
        fed.close()
    for ranks in two:
        (got,) = next(r for r in ranks[2]["records"]
                      if r["method"] == "central_average")["results"]
        assert got == want
