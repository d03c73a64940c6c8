"""The port's task plane against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``vantage6_tpu``'s Federation and
``vantage6_tpu_torch``'s (``device="cpu"``): config parsing and its errors,
task and run statuses under policies, offline stations, drains and kills,
the executor pool at 0 and N workers, v6-average in host and device mode,
``aggregate_stacked``'s three modes, the reference-shaped ``central_fedavg``
and ``run_fused_rounds``, and the span names of one device-mode task.
Sizes are small (2-4 stations, tens of rows, 2 local steps, 2 rounds).
"""
import importlib
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from vantage6_tpu_torch._tree import tree_leaves
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed import fedavg as tfedavg
from vantage6_tpu_torch.models.cnn import CNN
from vantage6_tpu_torch.utils.datasets import synthetic_image_classes
from vantage6_tpu_torch.workloads import fedavg_mnist as W


def _pkg(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        name=root,
        config=m("core.config"),
        federation=m("runtime.federation"),
        deco=m("algorithm.decorators"),
        mock=m("algorithm.mock_client"),
        enums=m("common.enums"),
        average=m("workloads.average"),
        fedavg_mnist=m("workloads.fedavg_mnist"),
        tracing=m("runtime.tracing"),
    )


JAX = _pkg("vantage6_tpu")
TORCH = _pkg("vantage6_tpu_torch")
BOTH = (JAX, TORCH)

# f32 on both sides, params after 2 rounds of 2 local SGD steps (the
# tolerance of tests/test_torch_fedavg.py)
TOL = dict(rtol=1e-5, atol=1e-6)


def _fed_kw(p) -> dict:
    return {"device": "cpu"} if p is TORCH else {}


def _algos(p) -> dict:
    """Host-mode algorithms written against package ``p``'s decorators."""

    @p.deco.data(1)
    def count_rows(df):
        return {"n": len(df)}

    @p.deco.data(1)
    def col_sum(df, pad=0.0):
        time.sleep(pad)
        return {"sum": float(df["x"].sum()), "n": int(len(df))}

    @p.deco.data(1)
    def boom(df):
        raise ValueError("boom at the station")

    @p.deco.algorithm_client
    def central_fanout(client, pad=0.0):
        orgs = [o["id"] for o in client.organization.list()]
        task = client.task.create(
            input_={"method": "col_sum", "kwargs": {"pad": pad}},
            organizations=orgs, wait=False,
        )
        parts = client.wait_for_results(task_id=task["id"], interval=0.01)
        return {"total": sum(r["sum"] for r in parts)}

    return {"count_rows": count_rows, "col_sum": col_sum, "boom": boom,
            "central_fanout": central_fanout}


def _frames(n=3, rows=5):
    rng = np.random.default_rng(3)
    return [pd.DataFrame({"x": rng.normal(size=rows + i)}) for i in range(n)]


def _host_fed(p, policies0=None, workers=0, n=3):
    c = p.config
    cfg = c.FederationConfig(
        name="t", executor_workers=workers,
        stations=[
            c.StationConfig(
                name=f"s{i}", organization=f"org_{i}",
                policies=(policies0 or {}) if i == 0 else {},
                databases=[c.DatabaseConfig(label="default", type="array")],
            )
            for i in range(n)
        ],
    )
    fed = p.federation.Federation(cfg, algorithms={"img": _algos(p)},
                                  **_fed_kw(p))
    fed.set_datasets("default", _frames(n))
    return fed


def _statuses(task) -> list[str]:
    return [r.status.value for r in task.runs]


# ------------------------------------------------------------------ config
RAW = {
    "federation": {"name": "demo", "encrypted": True, "executor_workers": 2,
                   "devices_per_station": 1},
    "server": {"port": 5000},
    "stations": [
        {"name": "a", "organization": "org_a", "api_key": "k",
         "databases": [{"label": "default", "type": "csv",
                        "uri": "${HOME}/a.csv", "options": {"sep": ";"}}],
         "policies": {"allowed_algorithms": ["img*"]}},
        {"name": "b", "databases": [{"label": "default", "type": "array"}]},
    ],
}

BAD = {
    "no stations": {"stations": []},
    "unknown db type": {"stations": [
        {"name": "a", "databases": [{"label": "d", "type": "mongo"}]}]},
    "duplicate stations": {"stations": [{"name": "a"}, {"name": "a"}]},
    "duplicate labels": {"stations": [{"name": "a", "databases": [
        {"label": "d", "type": "csv"}, {"label": "d", "type": "csv"}]}]},
    "unnamed station": {"stations": [{"organization": "x"}]},
    "negative workers": {"federation": {"executor_workers": -1},
                         "stations": [{"name": "a"}]},
    "compression typo": {"federation": {"compression": {"topk": 0.1}},
                         "stations": [{"name": "a"}]},
    "compression ratio": {"federation": {"compression": {"topk_ratio": 2.0}},
                          "stations": [{"name": "a"}]},
    "autopilot key": {"federation": {"autopilot": {"enabled": True,
                                                   "bogus": 1}},
                      "stations": [{"name": "a"}]},
}


def test_config_from_dict_round_trips_as_the_jax_packages():
    ours = TORCH.config.FederationConfig.from_dict(RAW)
    theirs = JAX.config.FederationConfig.from_dict(RAW)
    assert ours.to_dict() == theirs.to_dict()
    assert TORCH.config.FederationConfig.from_dict(
        ours.to_dict()).to_dict() == ours.to_dict()
    assert ours.n_stations == 2 and ours.resolved_executor_workers() == 2
    assert ours.stations[0].database().options == {"sep": ";"}
    assert "${HOME}" not in ours.stations[0].databases[0].uri


@pytest.mark.parametrize("case", list(BAD))
def test_config_errors_match_the_jax_packages(case):
    with pytest.raises(JAX.config.ConfigurationError) as theirs:
        JAX.config.FederationConfig.from_dict(BAD[case])
    with pytest.raises(TORCH.config.ConfigurationError) as ours:
        TORCH.config.FederationConfig.from_dict(BAD[case])
    assert str(ours.value) == str(theirs.value)


def test_config_yaml_file_round_trip(tmp_path):
    cfg = TORCH.config.FederationConfig.from_dict(RAW)
    cfg.save(tmp_path / "fed.yaml")
    again = TORCH.config.FederationConfig.load(tmp_path / "fed.yaml")
    assert again.to_dict() == cfg.to_dict()
    theirs = JAX.config.FederationConfig.load(tmp_path / "fed.yaml")
    assert theirs.to_dict() == cfg.to_dict()


def test_one_card_refuses_devices_per_station():
    raw = dict(RAW, federation={"devices_per_station": 2})
    assert JAX.config.FederationConfig.from_dict(raw).devices_per_station == 2
    # as in the reference, the config accepts it and the mesh checks it
    cfg = TORCH.config.FederationConfig.from_dict(raw)
    assert cfg.devices_per_station == 2
    with pytest.raises(NotImplementedError, match="item 12.5"):
        TORCH.federation.Federation(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs a process group"):
        FederationMesh(2, device="cpu", devices_per_station=2)


@pytest.mark.parametrize("fed_raw, item", [
    ({"compression": {"topk_ratio": 0.1, "int8": True}}, r"9\.2 \(1\)"),
    ({"autopilot": {"enabled": True}}, r"11\.2"),
])
def test_unported_planes_raise_rather_than_being_ignored(fed_raw, item):
    """A plane the port lacks raises; compression (item 9.2 (1)) is
    ported, so its config arms the federation's compressor instead."""
    raw = {"federation": fed_raw, "stations": [{"name": "a"}]}
    cfg = TORCH.config.FederationConfig.from_dict(raw)
    if "compression" in fed_raw:
        fed = TORCH.federation.Federation(cfg, device="cpu")
        assert fed._delta_compressor.spec == cfg.compressor
        fed.close()
        return
    with pytest.raises(NotImplementedError, match=item):
        TORCH.federation.Federation(cfg, device="cpu")


# ----------------------------------------------------- statuses and policies
SCENARIOS = {
    "not allowed": (dict(policies0={"allowed_algorithms": ["trusted/*"]}),
                    "img", {}),
    "glob allows": (dict(policies0={"allowed_algorithms": ["im*"]}),
                    "img", {}),
    "anonymous vs allow-list": (dict(policies0={"allowed_users": ["alice"]}),
                                "img", {}),
    "allowed user": (dict(policies0={"allowed_users": ["alice"]}), "img",
                     {"init_user": "alice"}),
    "no image": ({}, "ghost", {}),
}


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("case", list(SCENARIOS))
def test_policy_statuses_match_the_jax_packages(case, workers):
    fed_kw, image, task_kw = SCENARIOS[case]
    out = []
    for p in BOTH:
        fed = _host_fed(p, workers=workers, **fed_kw)
        try:
            task = fed.create_task(image, {"method": "count_rows"}, **task_kw)
            out.append((task.status.value, _statuses(task),
                        [r.result for r in task.runs]))
        finally:
            fed.close()
    assert out[0] == out[1]


def test_missing_method_and_crash_match_the_jax_packages():
    out = []
    for p in BOTH:
        fed = _host_fed(p)
        missing = fed.create_task("img", {"method": "nope"})
        crashed = fed.create_task("img", {"method": "boom"})
        with pytest.raises(RuntimeError, match="boom at the station"):
            fed.wait_for_results(crashed.id)
        out.append((_statuses(missing), missing.runs[0].log,
                    _statuses(crashed)))
        with pytest.raises(ValueError, match="method"):
            fed.create_task("img", {"args": []})
        with pytest.raises(ValueError, match="unknown organization"):
            fed.create_task("img", {"method": "count_rows"},
                            organizations=[7])
    assert out[0] == out[1]


@pytest.mark.parametrize("workers", [0, 2])
def test_offline_queue_drain_and_kill_match_the_jax_packages(workers):
    out = []
    for p in BOTH:
        fed = _host_fed(p, workers=workers)
        try:
            fed.set_station_online(1, False)
            task = fed.create_task("img", {"method": "col_sum"})
            seq = [_statuses(task)]
            with pytest.raises(RuntimeError, match="offline"):
                fed.wait_for_results(task.id)
            fed.set_station_online(1, True)  # drains the owed run
            seq.append(_statuses(task))
            results = fed.wait_for_results(task.id)
            fed.set_station_online(2, False)
            killed = fed.create_task("img", {"method": "col_sum"})
            fed.kill_task(killed.id)
            seq.append(_statuses(killed))
            fed.set_station_online(2, True)  # a killed run is not owed
            seq.append(_statuses(killed))
            fed.set_admission_limited(True)  # host runs queue PENDING
            held = fed.create_task("img", {"method": "col_sum"})
            seq.append(_statuses(held))
            fed.set_admission_limited(False)  # lifting the limit drains
            fed.wait_for_results(held.id, interval=0.01)
            seq.append(_statuses(held))
            out.append((seq, results, killed.status.value))
        finally:
            fed.close()
    assert out[0] == out[1]
    assert out[1][0][0] == ["completed", "pending", "completed"]
    assert out[1][0][2] == ["completed", "completed", "killed by user"]


@pytest.mark.parametrize("workers", [0, 3])
def test_executor_pool_results_and_timing(workers):
    """Pooled (3 workers) and synchronous dispatch give the JAX package's
    results; ``task_timing`` reports the straggler view either way."""
    out = []
    for p in BOTH:
        fed = _host_fed(p, workers=workers)
        try:
            task = fed.create_task("img", {"method": "central_fanout",
                                           "kwargs": {"pad": 0.01}},
                                   organizations=[0])
            (res,) = fed.wait_for_results(task.id)
            sub = next(t for t in fed.tasks.values()
                       if t.parent_id == task.id)
            timing = fed.task_timing(sub.id)
            assert timing["n_runs_timed"] == 3
            assert 0 <= timing["straggler_station"] < 3
            assert timing["sum_exec_s"] >= timing["max_exec_s"] > 0
            assert timing["wire"]["wire_bytes_in"] > 0
            out.append((res, _statuses(sub), sorted(timing)))
        finally:
            fed.close()
    assert out[0] == out[1]
    np.testing.assert_allclose(
        out[1][0]["total"], sum(float(f["x"].sum()) for f in _frames()))


def test_wait_false_and_timeout_under_the_pool():
    fed = _host_fed(TORCH, workers=2)
    try:
        task = fed.create_task("img", {"method": "col_sum",
                                       "kwargs": {"pad": 0.3}}, wait=False)
        assert not task.is_finished
        with pytest.raises(TimeoutError):
            fed.wait_for_results(task.id, timeout=0.05, interval=0.01)
        assert len(fed.wait_for_results(task.id, interval=0.01)) == 3
    finally:
        fed.close()


def test_run_buffered_accepts_the_quorum_and_credits_staleness():
    """A station that sleeps past the quorum is killed; the accepted
    stations and the staleness credit are the JAX package's."""
    out = []
    for p in BOTH:
        fed = _host_fed(p, workers=3, n=4)
        spec = importlib.import_module(f"{p.name}.fed.fedavg").AsyncRoundSpec(
            quorum=3, over_select=1, deadline_s=5.0)
        try:
            @p.deco.data(1)
            def slow0(df):
                if float(df["x"].iloc[0]) == float(_frames(4)[0]["x"][0]):
                    time.sleep(0.5)
                return {"n": len(df)}

            fed.register_algorithm("slow", {"slow0": slow0})
            r = fed.run_buffered("slow", {"method": "slow0"}, spec,
                                 rng=np.random.default_rng(0))
            out.append((r["accepted"], r["killed"], r["staleness"].tolist(),
                        fed.station_staleness(), r["accept_mask"].tolist()))
        finally:
            fed.close()
    assert out[0] == out[1]
    assert out[1][:2] == ([1, 2, 3], [0])


def test_select_stations_is_the_jax_packages():
    picks = []
    for p in BOTH:
        fed = _host_fed(p, n=4)
        fed.mask_station(2)
        fed.set_selection_weight(1, 0.01)
        picks.append([fed.select_stations(2, rng=np.random.default_rng(s))
                      for s in range(5)])
        assert fed.participation_mask().tolist() == [1.0, 1.0, 0.0, 1.0]
    assert picks[0] == picks[1]


def test_sessions_store_and_compute_match_the_jax_packages():
    out = []
    for p in BOTH:

        @p.deco.data(1)
        def extract(df):
            return df.assign(y=df["x"] * 2)

        @p.deco.data(1)
        def total_y(df):
            return {"y": float(df["y"].sum())}

        fed = _host_fed(p)
        fed.register_algorithm("s", {"extract": extract, "total_y": total_y})
        sid = fed.create_session("work")
        fed.create_task("s", {"method": "extract"}, session=sid,
                        store_as="doubled")
        book = fed.session_dataframes(sid)["doubled"]
        t = fed.create_task("s", {"method": "total_y"}, session=sid,
                            databases=[{"type": "session",
                                        "dataframe": "doubled"}])
        out.append((book["ready"], [c["name"] for c in book["columns"]],
                    fed.wait_for_results(t.id)))
        fed.delete_session(sid)
    assert out[0] == out[1]


# --------------------------------------------------- v6-average end to end
def _average_client(p, host: bool):
    rng = np.random.default_rng(0)
    if host:
        datasets = [[{"database": pd.DataFrame({"age": rng.normal(size=30)})}]
                    for _ in range(3)]
    else:
        datasets = [[{"database": {"x": rng.normal(size=(24, 3))
                                   .astype(np.float32)}}] for _ in range(4)]
    return p.mock.MockAlgorithmClient(datasets=datasets, module=p.average,
                                      **_fed_kw(p))


def test_central_average_host_mode_is_exact():
    out = []
    for p in BOTH:
        client = _average_client(p, host=True)
        task = client.task.create(
            input_={"method": "central_average", "kwargs": {"column": "age"}},
            organizations=[0])
        assert task["status"] == "completed"
        out.append(client.result.get(task["id"]))
        runs = client.run.from_task(task["id"])
        assert [r["organization"] for r in runs] == ["org_0"]
    assert out[0] == out[1]


@pytest.mark.parametrize("orgs", [None, [0, 2]])
def test_central_average_device_mode(orgs):
    out = []
    for p in BOTH:
        client = _average_client(p, host=False)
        task = client.task.create(
            input_={"method": "central_average_device",
                    "kwargs": {"column_index": 1, "organizations": orgs}},
            organizations=[0])
        (res,) = client.result.get(task["id"])
        out.append(res)
    assert out[0]["count"] == out[1]["count"] == 24 * (2 if orgs else 4)
    np.testing.assert_allclose(out[1]["average"], out[0]["average"],
                               rtol=1e-6)


def test_device_step_results_live_on_the_mesh():
    client = _average_client(TORCH, host=False)
    fed = client.federation
    fed.set_station_online(3, False)
    task = fed.create_task("mock", {"method": "partial_average_device",
                                    "kwargs": {"column_index": 0}})
    assert _statuses(task) == ["completed"] * 3 + ["pending"]
    stacked, mask = task.stacked_result, task.participation
    assert mask.dtype == torch.float32 and mask.tolist() == [1, 1, 1, 0]
    assert stacked["sum"].shape == (4,)
    assert torch.equal(task.runs[1].result["sum"], stacked["sum"][1])
    fed.set_station_online(3, True)  # the drain runs station 3 alone
    assert task.participation.tolist() == [1, 1, 1, 1]
    assert client.wait_for_stacked_result(task.id)[1].tolist() == [1] * 4


def test_device_step_that_cannot_vmap_crashes_its_runs():
    @TORCH.deco.device_step
    def data_dependent(d):
        return {"s": d.sum() if d.sum().item() > 0 else -d.sum()}

    fed = TORCH.federation.federation_from_datasets(
        [np.ones((3, 2), np.float32)] * 2, {"dev": {"f": data_dependent}},
        device="cpu")
    task = fed.create_task("dev", {"method": "f"})
    assert _statuses(task) == ["crashed", "crashed"]
    assert "Traceback" in task.runs[0].log
    with pytest.raises(ValueError, match="no stacked"):
        fed.aggregate_stacked(task.id)


# ------------------------------------------------------- aggregate_stacked
def test_aggregate_stacked_modes_match_the_jax_packages():
    """Replicated, scattered and scattered_bf16 with station 1 offline,
    weighted, against the JAX package's (its own tolerances: 1e-5 between
    f32 modes, 0.25 for bf16 at this size)."""
    rng = np.random.default_rng(4)
    data_ = [rng.normal(size=(6, 3)).astype(np.float32) * (i + 1)
             for i in range(4)]
    weights = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    res = {}
    for p in BOTH:
        @p.deco.device_step
        def local(d):
            return {"s": d.sum(0), "m": d.mean(0)}

        fed = p.federation.federation_from_datasets(
            data_, {"dev": {"local": local}}, **_fed_kw(p))
        fed.set_station_online(1, False)
        task = fed.create_task("dev", {"method": "local"})
        res[p.name] = {
            mode: fed.aggregate_stacked(task.id, weights=weights,
                                        agg_mode=mode)
            for mode in ("replicated", "scattered", "scattered_bf16")}
        with pytest.raises(ValueError, match="agg_mode"):
            fed.aggregate_stacked(task.id, agg_mode="bogus")
    ours, theirs = res["vantage6_tpu_torch"], res["vantage6_tpu"]
    w = weights * np.asarray([1, 0, 1, 1], np.float32)
    oracle = sum(w[i] * data_[i].sum(0) for i in range(4)) / w.sum()
    for mode, tol in (("replicated", 1e-5), ("scattered", 1e-5)):
        for k in ("s", "m"):
            np.testing.assert_allclose(ours[mode][k].numpy(),
                                       np.asarray(theirs[mode][k]),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ours[mode]["s"].numpy(), oracle,
                                   rtol=1e-5, atol=tol)
    # the bf16 rounding of an f32 sum whose order differs (the JAX mesh
    # reduce-scatters over 8 devices): one bf16 ulp of the largest mean
    for k in ("s", "m"):
        ulp = 2.0**-7 * np.abs(ours["replicated"][k].numpy()).max()
        np.testing.assert_allclose(ours["scattered_bf16"][k].numpy(),
                                   np.asarray(theirs["scattered_bf16"][k]),
                                   rtol=0, atol=ulp)
        np.testing.assert_allclose(ours["scattered_bf16"][k].numpy(),
                                   ours["replicated"][k].numpy(), atol=0.25)


# --------------------------------------------------- reference-shaped FedAvg
N_ST, PER, STEPS, BATCH, ROUNDS, SEED = 4, 48, 2, 16, 2, 3


def _fedavg_datasets():
    x, y = synthetic_image_classes(N_ST * PER, seed=5)
    return [[{"database": {"x": x[i * PER:(i + 1) * PER],
                           "y": y[i * PER:(i + 1) * PER],
                           "count": np.float32(PER), "sid": np.int32(i)}}]
            for i in range(N_ST)]


def _jax_draws(seed, r, counts):
    """The JAX partial's draws for round r: fold_in(key(round_seed), sid)
    -> split(local_steps) -> randint(0, max(count, 1))."""
    rk = jax.random.key(seed * 100003 + r)
    return np.asarray([
        [np.asarray(jax.random.randint(k, (BATCH,), 0, max(int(c), 1)))
         for k in jax.random.split(jax.random.fold_in(rk, sid), STEPS)]
        for sid, c in enumerate(counts)])


def test_central_fedavg_matches_the_jax_central_fedavg(monkeypatch):
    """Both packages' central_fedavg in f32 compute, from the JAX init, the
    JAX draws injected into the port: params and losses after 2 rounds."""
    jcnn = importlib.import_module("vantage6_tpu.models.cnn")
    monkeypatch.setattr(JAX.fedavg_mnist, "MODEL",
                        jcnn.CNN(compute_dtype=jnp.float32))
    monkeypatch.setattr(W, "MODEL", CNN(compute_dtype=torch.float32))
    kw = {"n_rounds": ROUNDS, "local_steps": STEPS, "batch_size": BATCH,
          "seed": SEED}
    jclient = JAX.mock.MockAlgorithmClient(datasets=_fedavg_datasets(),
                                           module=JAX.fedavg_mnist)
    task = jclient.task.create(input_={"method": "central_fedavg",
                                       "kwargs": kw}, organizations=[0])
    (theirs,) = jclient.result.get(task["id"])
    init = JAX.fedavg_mnist.init_params(jax.random.key(SEED))
    idx = np.stack([_jax_draws(SEED, r, [PER] * N_ST) for r in range(ROUNDS)])
    client = TORCH.mock.MockAlgorithmClient(
        datasets=_fedavg_datasets(), module=W, device="cpu")
    task = client.task.create(
        input_={"method": "central_fedavg",
                "kwargs": dict(kw, init_params=W.params_to_numpy(
                    W.params_from_jax(init, "cpu")), batch_idx=idx)},
        organizations=[0])
    (ours,) = client.result.get(task["id"])
    np.testing.assert_allclose(ours["losses"], theirs["losses"], **TOL)
    a, b = tree_leaves(ours["params"]), jax.tree.leaves(theirs["params"])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)


def test_central_fedavg_round_is_an_eager_engine_round():
    """With its own draws, 2 rounds of the port's central_fedavg are 2
    eager ``FedAvg.round`` calls under sgd(1.0) from the same init, each
    round's generator seeded ``seed * 100003 + r``: bit for bit."""
    client = TORCH.mock.MockAlgorithmClient(
        datasets=_fedavg_datasets(), module=W, device="cpu")
    task = client.task.create(
        input_={"method": "central_fedavg",
                "kwargs": {"n_rounds": ROUNDS, "local_steps": STEPS,
                           "batch_size": BATCH, "seed": SEED}},
        organizations=[0])
    (ours,) = client.result.get(task["id"])
    eng = W.make_engine(n_stations=N_ST, local_steps=STEPS, batch_size=BATCH,
                        device="cpu", learning_stats=False)
    ds = [d[0]["database"] for d in _fedavg_datasets()]
    sx = torch.from_numpy(np.stack([d["x"] for d in ds]))
    sy = torch.from_numpy(np.stack([d["y"] for d in ds]))
    counts = torch.full((N_ST,), float(PER))
    params = W.init_params(SEED, device="cpu")
    state, losses = eng.init(params), []
    for r in range(ROUNDS):
        params, state, loss, _ = eng.round(params, state, sx, sy, counts,
                                           key=SEED * 100003 + r)
        losses.append(float(loss))
    assert ours["losses"] == losses
    for a, b in zip(tree_leaves(ours["params"]), tree_leaves(params)):
        assert torch.equal(a, b)


def test_run_fused_rounds_is_engine_run_rounds():
    """run_fused_rounds with station 2 masked == engine.run_rounds with
    that mask (port, exact), and == the JAX Federation's run_fused_rounds
    given the JAX draws (f32 tolerance)."""
    jfed_mod = importlib.import_module("vantage6_tpu.fed.fedavg")
    ds = [d[0]["database"] for d in _fedavg_datasets()]
    sx = np.stack([d["x"] for d in ds])
    sy = np.stack([d["y"] for d in ds])
    counts = np.full(N_ST, float(PER), np.float32)
    fed = TORCH.federation.federation_from_datasets(
        ds, {}, device="cpu")
    fed.set_station_online(2, False)
    eng = W.make_engine(n_stations=N_ST, local_steps=STEPS, batch_size=BATCH,
                        device="cpu", learning_stats=False)
    params = W.init_params(SEED, device="cpu")
    out = fed.run_fused_rounds(eng, params, sx, sy, counts, 11, ROUNDS)
    assert out["mask"].tolist() == [1.0, 1.0, 0.0, 1.0]
    assert out["rounds_per_sec"] > 0 and out["losses"].shape == (ROUNDS,)
    p, _, losses, _ = eng.run_rounds(params, sx, sy, counts, 11, ROUNDS,
                                     mask=[1.0, 1.0, 0.0, 1.0])
    assert torch.equal(losses, out["losses"])
    for a, b in zip(tree_leaves(p), tree_leaves(out["params"])):
        assert torch.equal(a, b)

    # against the JAX Federation, both engines in f32 compute
    jcnn = importlib.import_module("vantage6_tpu.models.cnn")
    jm, tm = jcnn.CNN(compute_dtype=jnp.float32), CNN(
        compute_dtype=torch.float32)

    def jloss(q, bx, by, w):
        logp = jax.nn.log_softmax(jm.apply({"params": q}, bx))
        nll = -jnp.take_along_axis(logp, by[:, None], axis=1)[:, 0]
        return jnp.sum(nll * w) / jnp.maximum(jnp.sum(w), 1.0)

    def tloss(q, bx, by, w):
        logp = torch.log_softmax(tm(q, bx), dim=-1)
        nll = -torch.gather(logp, 1, by.long()[:, None])[:, 0]
        return torch.sum(nll * w) / torch.clamp_min(torch.sum(w), 1.0)

    jfed = JAX.federation.federation_from_datasets(ds, {})
    jfed.set_station_online(2, False)
    jeng = jfed_mod.FedAvg(jfed.mesh, jfed_mod.FedAvgSpec(
        loss_fn=jloss, local_steps=STEPS, batch_size=BATCH, local_lr=0.05,
        learning_stats=False))
    init = JAX.fedavg_mnist.init_params(jax.random.key(SEED))
    key = jax.random.key(13)
    theirs = jfed.run_fused_rounds(jeng, init, jnp.asarray(sx),
                                   jnp.asarray(sy), jnp.asarray(counts), key,
                                   ROUNDS, donate=False)
    round_keys = jax.random.split(key, ROUNDS)
    idx = np.stack([
        [[np.asarray(jax.random.randint(k, (BATCH,), 0, PER))
          for k in jax.random.split(jax.random.fold_in(rk, sid), STEPS)]
         for sid in range(N_ST)] for rk in round_keys])
    teng = tfedavg.FedAvg(fed.mesh, tfedavg.FedAvgSpec(
        loss_fn=tloss, local_steps=STEPS, batch_size=BATCH, local_lr=0.05,
        learning_stats=False))
    ours = fed.run_fused_rounds(teng, W.params_from_jax(init, "cpu"), sx, sy,
                                counts, None, ROUNDS, batch_idx=idx)
    np.testing.assert_allclose(ours["losses"].numpy(),
                               np.asarray(theirs["losses"]), **TOL)
    for a, b in zip(tree_leaves(ours["params"]),
                    jax.tree.leaves(theirs["params"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ------------------------------------------------------------------ tracing
def test_device_task_span_names_match_the_jax_packages():
    """One central_average_device task and an aggregate_stacked, traced on
    both: the same span names under one trace. The JAX Federation's
    learning-plane record is off (the port has none yet)."""
    names = []
    for p in BOTH:
        tracer = p.tracing.TRACER
        tracer.configure(enabled=True, sample=1.0)
        tracer.clear()
        try:
            client = _average_client(p, host=False)
            fed = client.federation
            fed.config.learning_stats = False
            with tracer.span("test.root", kind="client", service="test"):
                task = client.task.create(
                    input_={"method": "central_average_device",
                            "kwargs": {"column_index": 0}},
                    organizations=[0])
                sub = next(t for t in fed.tasks.values()
                           if t.parent_id == task["id"])
                fed.aggregate_stacked(sub.id)
            spans = tracer.drain()
        finally:
            tracer.configure(enabled=True, sample=1.0)
            tracer.clear()
        assert len({s["trace_id"] for s in spans}) == 1
        names.append(sorted(s["name"] for s in spans))
    assert names[0] == names[1]
    assert names[1] == sorted(["test.root", "server.dispatch", "runner.exec",
                               "server.dispatch", "device.step",
                               "aggregate"])
