"""The port's fault harness, buffered-async rounds and autopilot, on the CPU.

Copies of ``tests/test_autopilot.py``'s ``TestFaultPlan``,
``TestAsyncRoundSpec`` (its mask-seam case on the port's engine),
``TestSelectStations``, ``TestRunBuffered`` (the stations' data as dicts
of arrays: the port needs no pandas), ``TestAutopilotEngine`` and
``TestAutopilotWatchdogLoop`` with their imports switched to the port.
Then the cross-package cases: one ``V6T_FAULTS`` spec parses to the same
rules, snapshot and probability stream in both packages, and
``poison_labels`` flips the same indices of a numpy array and of a torch
tensor; the reference benchmark's closed loop (8 stations x 32 rows x 16
features, linear least squares, station 5 label-flipped) on the CPU with
the JAX engine's draws injected masks the same station in both packages,
and the masked run's params match the JAX engine's (rtol 1e-5, atol
1e-6). And the port's own wiring: ``ArrayActuator.participation_mask()``
(numpy) as ``FedAvg``'s mask, and a ``Federation`` built with
``autopilot: {enabled: true}`` shrinking and restoring a straggler's
selection weight through ``WATCHDOG``.
"""
import gc
import importlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vantage6_tpu_torch._tree import tree_leaves
from vantage6_tpu_torch.algorithm import data
from vantage6_tpu_torch.common.enums import TaskStatus
from vantage6_tpu_torch.common.faults import FAULTS, FaultPlan, _parse_rule
from vantage6_tpu_torch.common.flight import FLIGHT
from vantage6_tpu_torch.common.rest import RestError, RestSession
from vantage6_tpu_torch.common.telemetry import REGISTRY
from vantage6_tpu_torch.core.config import FederationConfig
from vantage6_tpu_torch.core.mesh import FederationMesh
from vantage6_tpu_torch.fed.fedavg import AsyncRoundSpec, FedAvg, FedAvgSpec
from vantage6_tpu_torch.runtime.autopilot import (
    DEFAULT_POLICIES,
    ArrayActuator,
    Autopilot,
)
from vantage6_tpu_torch.runtime.federation import (
    Federation,
    federation_from_datasets,
)
from vantage6_tpu_torch.runtime.learning import LEARNING
from vantage6_tpu_torch.runtime.tracing import TRACER
from vantage6_tpu_torch.runtime.watchdog import (
    RULE_CATALOG,
    WATCHDOG,
    Alert,
    Watchdog,
)

JFAULTS = importlib.import_module("vantage6_tpu.common.faults")


def _clean_faults():
    FAULTS.clear()
    yield
    FAULTS.clear()


def mk_alert(rule, labels=None, traceparent=None):
    now = time.time()
    return Alert(
        rule=rule, severity="warning", message=f"test {rule}",
        labels=labels or {}, traceparent=traceparent,
        raised_at=now, last_seen_at=now,
    )


# ------------------------------------------------------------ fault harness
class TestFaultPlan:
    def test_parse_grammar_and_defaults(self):
        plan = FaultPlan.parse(
            "delay:station=0,seconds=0.3; rest500:count=2,endpoint=task;"
            "crash:; flip:station=2,fraction=0.5; drop:station=*,prob=0.5",
            seed=7,
        )
        by_kind = {r.kind: r for r in plan.rules}
        assert by_kind["delay"].station == "0"
        assert by_kind["delay"].seconds == 0.3
        # `count` is the rest500-friendly alias for limit
        assert by_kind["rest500"].limit == 2
        assert by_kind["rest500"].endpoint == "task"
        assert by_kind["rest500"].status == 500
        assert by_kind["crash"].limit == 1   # crash once by default
        assert by_kind["flip"].fraction == 0.5
        assert by_kind["drop"].prob == 0.5
        # rest500 without an explicit count is a burst of 3, not an outage
        assert FaultPlan.parse("rest500:").rules[0].limit == 3

    def test_parse_is_fail_loud(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            FaultPlan.parse("melt:station=0")
        with pytest.raises(ValueError, match="bad fault key"):
            FaultPlan.parse("delay:station=0,speed=9")
        with pytest.raises(ValueError, match="bad fault value"):
            FaultPlan.parse("delay:station=0,seconds=soon")
        with pytest.raises(ValueError, match="seconds>0"):
            FaultPlan.parse("delay:station=0")

    def test_after_and_limit_gates(self):
        rule = _parse_rule("drop:station=1,after=2,limit=1", 0)
        # non-matching opportunities never advance the counters
        assert not rule.fires(station=0)
        assert rule.seen == 0
        # matched: skip the first `after`, then fire `limit` times, then dry
        seq = [rule.fires(station=1) for _ in range(5)]
        assert seq == [False, False, True, False, False]
        assert (rule.seen, rule.fired) == (5, 1)

    def test_prob_stream_is_seed_deterministic(self):
        def stream(seed):
            plan = FaultPlan.parse("drop:prob=0.5", seed=seed)
            return [plan.drop_result(0) for _ in range(64)]

        assert stream(3) == stream(3)
        assert any(stream(3)) and not all(stream(3))

    def test_injector_probes_and_snapshot(self):
        plan = FAULTS.configure("rest500:status=503,count=2")
        assert FAULTS.active
        assert FAULTS.rest_status("run/1") == 503
        assert FAULTS.rest_status("run/2") == 503
        assert FAULTS.rest_status("run/3") is None  # burst exhausted
        (snap,) = plan.snapshot()
        assert (snap["kind"], snap["fired"]) == ("rest500", 2)
        FAULTS.clear()
        assert not FAULTS.active
        assert FAULTS.rest_status("run/4") is None

    def test_poison_labels_deterministic_and_scoped(self):
        FAULTS.configure("flip:station=3,fraction=0.5")
        y = np.ones(10, np.float32)
        flipped = FAULTS.poison_labels(y, 3)
        again = FAULTS.poison_labels(y, 3)
        assert (flipped == -1).sum() == 5
        np.testing.assert_array_equal(flipped, again)  # seeded index choice
        np.testing.assert_array_equal(y, np.ones(10, np.float32))  # copy
        # a non-matching station's labels pass through untouched
        np.testing.assert_array_equal(FAULTS.poison_labels(y, 4), y)

    def test_rest500_injected_before_the_wire(self):
        # nothing listens on this URL: an answer proves injection happens
        # before the socket, exactly where a flaky control plane would be
        session = RestSession("http://127.0.0.1:9")
        FAULTS.configure("rest500:status=503,count=1")
        with pytest.raises(RestError) as ei:
            session.request("GET", "health")
        assert ei.value.status == 503
        assert "injected" in ei.value.msg


# ------------------------------------------------------- buffered-async math
@pytest.fixture(scope="module")
def mesh():
    return FederationMesh(8, device="cpu")


@pytest.fixture(scope="module")
def engine(mesh):
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    return W.make_engine(mesh, local_steps=2, batch_size=8, local_lr=0.1)


@pytest.fixture(scope="module")
def fed_data(mesh):
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    return W.make_federated_data(8, n_per_station=32, seed=3, mesh=mesh)


class TestAsyncRoundSpec:
    def test_validate(self):
        AsyncRoundSpec(quorum=1).validate()
        with pytest.raises(ValueError, match="quorum"):
            AsyncRoundSpec(quorum=0).validate()
        with pytest.raises(ValueError, match="over_select"):
            AsyncRoundSpec(quorum=1, over_select=-1).validate()
        with pytest.raises(ValueError, match="staleness_discount"):
            AsyncRoundSpec(quorum=1, staleness_discount=0.0).validate()
        with pytest.raises(ValueError, match="deadline_s"):
            AsyncRoundSpec(quorum=1, deadline_s=0.0).validate()

    def test_n_select_and_staleness_weights(self):
        spec = AsyncRoundSpec(quorum=3, over_select=2, staleness_discount=0.5)
        assert spec.n_select == 5
        w = np.asarray(spec.staleness_weights(np.array([0.0, 1.0, 2.0])))
        np.testing.assert_allclose(w, [1.0, 0.5, 0.25])

    def test_async_round_is_round_at_the_mask_seam(self, engine, fed_data):
        """FedBuff weighting must be EXACTLY the synchronous round with
        mask = accept * discount**staleness: same jitted program, no new
        traced signature — compression EF and stats compose unchanged."""
        from vantage6_tpu_torch.workloads import fedavg_mnist as W

        sx, sy, counts = fed_data
        key = 5
        params = W.init_params(6, device="cpu")
        opt0 = engine.init(params)
        spec = AsyncRoundSpec(quorum=6, over_select=2, staleness_discount=0.5)
        accept = np.ones(8, np.float32)
        accept[2] = 0.0  # straggler killed this round
        stale = np.arange(8, dtype=np.float32) % 3
        out_async = engine.async_round(
            params, opt0, sx, sy, counts, key,
            torch.from_numpy(accept), torch.from_numpy(stale), spec,
        )
        effective = accept * (spec.staleness_discount ** stale)
        out_sync = engine.round(
            params, opt0, sx, sy, counts, key,
            mask=torch.as_tensor(effective, dtype=torch.float32),
        )
        for la, lb in zip(
            tree_leaves(out_async[0]), tree_leaves(out_sync[0])
        ):
            np.testing.assert_allclose(
                np.asarray(la), np.asarray(lb), rtol=1e-6
            )


# ------------------------------------------------- federation buffered rounds
@data(1)
def _mean_partial(df):
    return {"sum": float(df["x"].sum()), "n": int(len(df["x"]))}


def make_fed(n=4, workers=4):
    frames = [
        {"x": np.arange(8, dtype=float) + 100.0 * i}
        for i in range(n)
    ]
    return federation_from_datasets(
        frames, {"img": {"mean_partial": _mean_partial}},
        executor_workers=workers, device="cpu",
    )


@pytest.fixture()
def fed4():
    fed = make_fed(4)
    yield fed
    fed.close()


class TestSelectStations:
    def test_masked_station_is_never_selected(self, fed4):
        fed4.mask_station(2)
        assert fed4.select_stations(4) == [0, 1, 3]
        fed4.mask_station(2, False)
        assert fed4.select_stations(4) == [0, 1, 2, 3]

    def test_no_eligible_stations_raises(self, fed4):
        for s in range(4):
            fed4.mask_station(s)
        with pytest.raises(RuntimeError, match="no eligible stations"):
            fed4.select_stations(1)

    def test_weighted_sampling_respects_shrunken_weight(self, fed4):
        # station 0's weight shrunk to (floored) zero: over 32 seeded
        # single-station draws from {0, 1} it must essentially never win
        fed4.set_selection_weight(0, 0.0)
        rng = np.random.default_rng(11)
        draws = [
            fed4.select_stations(1, rng=rng, pool=[0, 1])[0]
            for _ in range(32)
        ]
        assert draws.count(1) == 32
        with pytest.raises(ValueError):
            fed4.set_selection_weight(1, -0.5)


class TestRunBuffered:
    def test_first_k_accept_kill_and_staleness_credit(self, fed4):
        FAULTS.configure("delay:station=0,seconds=0.6")
        spec = AsyncRoundSpec(quorum=3, over_select=1, deadline_s=10.0)
        res = fed4.run_buffered(
            "img", {"method": "mean_partial"}, spec,
            rng=np.random.default_rng(0),
        )
        assert res["selected"] == [0, 1, 2, 3]
        assert res["accepted"] == [1, 2, 3]
        assert res["killed"] == [0]
        np.testing.assert_array_equal(
            res["accept_mask"], np.array([0, 1, 1, 1], np.float32)
        )
        # the returned snapshot is PRE-credit (this round's discount
        # inputs); the credit itself lands in the federation state
        np.testing.assert_array_equal(res["staleness"], np.zeros(4))
        assert fed4.station_staleness() == [1, 0, 0, 0]
        # accepted runs completed, the straggler was killed mid-flight
        statuses = {
            r.station_index: r.status for r in res["task"].runs
        }
        assert statuses[0] == TaskStatus.KILLED
        assert all(
            statuses[s] == TaskStatus.COMPLETED for s in res["accepted"]
        )
        # round 2: the still-slow station stays absent and its staleness
        # keeps climbing; the snapshot now shows round 1's credit
        res2 = fed4.run_buffered(
            "img", {"method": "mean_partial"}, spec,
            rng=np.random.default_rng(1),
        )
        np.testing.assert_array_equal(res2["staleness"], [1, 0, 0, 0])
        assert fed4.station_staleness() == [2, 0, 0, 0]

    def test_deadline_expiry_accepts_what_finished(self, fed4):
        FAULTS.configure("delay:station=0,seconds=0.5")
        spec = AsyncRoundSpec(quorum=4, over_select=0, deadline_s=0.15)
        res = fed4.run_buffered(
            "img", {"method": "mean_partial"}, spec,
            rng=np.random.default_rng(0),
        )
        # quorum of 4 was unreachable inside the deadline: the round
        # closes with the three finishers, the straggler killed
        assert res["accepted"] == [1, 2, 3]
        assert res["killed"] == [0]
        assert res["round_s"] < 0.5

    def test_counters_and_flight_note(self, fed4):
        before = REGISTRY.snapshot().get("v6t_async_rounds_total", 0)
        FAULTS.configure("delay:station=0,seconds=0.6")
        fed4.run_buffered(
            "img", {"method": "mean_partial"},
            AsyncRoundSpec(quorum=3, over_select=1, deadline_s=10.0),
            rng=np.random.default_rng(0),
        )
        snap = REGISTRY.snapshot()
        assert snap["v6t_async_rounds_total"] == before + 1
        assert snap.get("v6t_async_stragglers_killed_total", 0) >= 1
        notes = [
            n for n in list(FLIGHT._notes) if n["kind"] == "async_round"
        ]
        assert notes and notes[-1]["killed"] == [0]
        assert notes[-1]["accepted"] == [1, 2, 3]


# ----------------------------------------------------------- autopilot engine
class TestAutopilotEngine:
    def test_every_default_policy_rule_is_cataloged(self):
        for policy in DEFAULT_POLICIES:
            assert policy.rule in RULE_CATALOG

    def test_mask_apply_and_revert(self):
        act = ArrayActuator(4)
        pilot = Autopilot(act, dry_run=False)
        alert = mk_alert("anomalous_station", {"station": 2, "task": "t1"})
        pilot.on_transition("raised", alert)
        assert act.masked[2] and not act.masked[[0, 1, 3]].any()
        np.testing.assert_array_equal(
            act.participation_mask(), [1.0, 1.0, 0.0, 1.0]
        )
        d = pilot.digest()
        assert (d["applied"], d["reverted"]) == (1, 0)
        assert d["engaged"][0]["action"] == "mask_station"
        pilot.on_transition("cleared", alert)
        assert not act.masked.any()
        d = pilot.digest()
        assert (d["applied"], d["reverted"]) == (1, 1)
        assert d["engaged"] == []

    def test_duplicate_raise_applies_once(self):
        act = ArrayActuator(4)
        pilot = Autopilot(act, dry_run=False)
        for _ in range(3):
            pilot.on_transition(
                "raised", mk_alert("anomalous_station", {"station": 1})
            )
        assert pilot.digest()["applied"] == 1

    def test_clear_without_apply_is_a_noop(self):
        act = ArrayActuator(4)
        pilot = Autopilot(act, dry_run=False)
        pilot.on_transition(
            "cleared", mk_alert("anomalous_station", {"station": 1})
        )
        assert pilot.digest() == {
            "applied": 0, "reverted": 0, "suppressed": 0,
            "engaged": [], "dry_run": False, "disabled": [],
        }

    def test_dry_run_narrates_without_actuating(self):
        act = ArrayActuator(4)
        pilot = Autopilot(act, dry_run=True)
        alert = mk_alert("anomalous_station", {"station": 2})
        pilot.on_transition("raised", alert)
        assert not act.masked.any()
        d = pilot.digest()
        assert (d["applied"], d["suppressed"]) == (0, 1)
        notes = [
            n for n in list(FLIGHT._notes)
            if n["kind"] == "autopilot_action" and n.get("dry_run")
        ]
        assert notes and notes[-1]["action"] == "mask_station"
        # the clear finds nothing engaged: no phantom revert
        pilot.on_transition("cleared", alert)
        assert pilot.digest()["reverted"] == 0

    def test_per_rule_disable(self):
        act = ArrayActuator(4)
        pilot = Autopilot(act, dry_run=False, disable={"anomalous_station"})
        pilot.on_transition(
            "raised", mk_alert("anomalous_station", {"station": 2})
        )
        assert not act.masked.any()
        d = pilot.digest()
        assert d["applied"] == 0 and d["disabled"] == ["anomalous_station"]

    def test_capability_self_suppression(self):
        # an actuator without the needed method: quietly suppressed, no
        # exception, no engagement — the server-side engine meeting a
        # federation-only policy
        pilot = Autopilot(object(), dry_run=False)
        pilot.on_transition(
            "raised", mk_alert("straggler_station", {"station": 1})
        )
        d = pilot.digest()
        assert (d["applied"], d["suppressed"], d["engaged"]) == (0, 1, [])

    def test_straggler_weight_config_and_revert(self):
        act = ArrayActuator(4)
        pilot = Autopilot(
            act, dry_run=False, config={"straggler_weight": 0.5}
        )
        alert = mk_alert("straggler_station", {"station": 3})
        pilot.on_transition("raised", alert)
        assert act.selection_weights[3] == 0.5
        pilot.on_transition("cleared", alert)
        assert act.selection_weights[3] == 1.0

    def test_queue_buildup_admission_toggle(self):
        act = ArrayActuator(2)
        pilot = Autopilot(act, dry_run=False)
        alert = mk_alert("queue_buildup", {})
        pilot.on_transition("raised", alert)
        assert act.admission_limited
        pilot.on_transition("cleared", alert)
        assert not act.admission_limited

    def test_requeue_policies_are_one_shot(self):
        calls = []

        class NodeActuator:
            def requeue_node_runs(self, node_id):
                calls.append(node_id)
                return 3

        pilot = Autopilot(NodeActuator(), dry_run=False)
        alert = mk_alert("daemon_lapsed", {"node_id": 7})
        pilot.on_transition("raised", alert)
        assert calls == [7]
        assert pilot.digest()["engaged"][0]["detail"]["requeued"] == 3
        pilot.on_transition("cleared", alert)
        d = pilot.digest()
        # nothing to undo: a requeue already happened, the runs moved on
        assert d["reverted"] == 0 and d["engaged"] == []

    def test_emits_span_on_alert_trace_and_flight_note(self):
        TRACER.configure(enabled=True, sample=1.0, sink=None)
        TRACER.clear()
        trace_id = "ab" * 16
        tp = f"00-{trace_id}-{'cd' * 8}-01"
        act = ArrayActuator(4)
        pilot = Autopilot(act, dry_run=False)
        alert = mk_alert(
            "anomalous_station", {"station": 2}, traceparent=tp
        )
        pilot.on_transition("raised", alert)
        pilot.on_transition("cleared", alert)
        spans = {s["name"]: s for s in TRACER.drain(trace_id=trace_id)}
        assert "autopilot.mask_station" in spans
        assert "autopilot.unmask_station" in spans
        sp = spans["autopilot.mask_station"]
        assert sp["attrs"]["rule"] == "anomalous_station"
        assert sp["attrs"]["station"] == 2
        kinds = [
            n["kind"] for n in list(FLIGHT._notes)
            if n["kind"].startswith("autopilot_")
            and n.get("traceparent") == tp
        ]
        assert kinds == ["autopilot_action", "autopilot_revert"]


class TestAutopilotWatchdogLoop:
    def test_daemon_lapsed_drives_requeue_end_to_end(self):
        """The full closed loop on a private watchdog: feed shows a
        lapsed-but-online node -> evaluate() raises daemon_lapsed ->
        the attached autopilot requeues synchronously; a later healthy
        feed clears the alert and the one-shot policy disengages."""
        wd = Watchdog(interval=60.0)
        state = {"nodes": [{
            "node_id": 7, "name": "n7", "status": "online",
            "last_seen_at": time.time() - 600.0,
        }]}
        wd.register_feed("t", lambda: state)
        calls = []

        class NodeActuator:
            def requeue_node_runs(self, node_id):
                calls.append(node_id)
                return 2

        pilot = Autopilot(
            NodeActuator(), watchdog=wd, dry_run=False,
            listener_key="test-autopilot",
        ).attach()
        try:
            active = wd.evaluate()
            assert any(a["rule"] == "daemon_lapsed" for a in active)
            assert calls == [7]
            d = pilot.digest()
            assert d["applied"] == 1
            assert d["engaged"][0]["detail"]["requeued"] == 2
            # the alert holding across evaluations must not re-fire it
            wd.evaluate()
            assert calls == [7]
            # node pings again: alert clears, one-shot leaves no revert
            state["nodes"][0]["last_seen_at"] = time.time()
            for _ in range(3):
                if not wd.evaluate():
                    break
            d = pilot.digest()
            assert d["engaged"] == [] and d["reverted"] == 0
        finally:
            pilot.detach()

    def test_detach_stops_the_loop(self):
        wd = Watchdog(interval=60.0)
        state = {"nodes": [{
            "node_id": 9, "name": "n9", "status": "online",
            "last_seen_at": time.time() - 600.0,
        }]}
        wd.register_feed("t", lambda: state)
        calls = []

        class NodeActuator:
            def requeue_node_runs(self, node_id):
                calls.append(node_id)
                return 0

        pilot = Autopilot(
            NodeActuator(), watchdog=wd, dry_run=False,
            listener_key="test-autopilot-2",
        ).attach()
        pilot.detach()
        wd.evaluate()
        assert calls == []


# ------------------------------------------------ the two packages' faults
SPEC = ("delay:station=0,seconds=0.3; rest500:count=2,endpoint=task;"
        "crash:; flip:station=2,fraction=0.5; drop:station=*,prob=0.5;"
        "wedge:op=probe,seconds=1.5")


def test_fault_plan_parses_and_fires_as_the_jax_packages():
    ours, theirs = FaultPlan.parse(SPEC, seed=7), JFAULTS.FaultPlan.parse(
        SPEC, seed=7)
    fields = ("kind", "station", "seconds", "status", "endpoint", "op",
              "fraction", "prob", "limit", "after", "seed")
    assert ([[getattr(r, f) for f in fields] for r in ours.rules]
            == [[getattr(r, f) for f in fields] for r in theirs.rules])
    fired = [
        [(plan.drop_result(i % 3), plan.rest_status(f"task/{i}"),
          plan.station_delay(i % 2), plan.daemon_crash(),
          plan.wedge_seconds("probe"), plan.flip_fraction(2))
         for i in range(64)]
        for plan in (ours, theirs)
    ]
    assert fired[0] == fired[1]
    drops = [d for d, *_ in fired[0]]
    assert any(drops) and not all(drops)
    assert ours.snapshot() == theirs.snapshot()


@pytest.mark.parametrize("fraction", [0.3, 1.0])
def test_poison_labels_flips_the_jax_packages_indices(fraction):
    spec = f"flip:station=5,fraction={fraction}"
    y = np.random.default_rng(1).normal(size=37).astype(np.float32)
    FAULTS.configure(spec)
    JFAULTS.FAULTS.configure(spec)
    try:
        theirs = JFAULTS.FAULTS.poison_labels(y, 5)
        ours = FAULTS.poison_labels(y, 5)
        t = torch.from_numpy(y)
        ours_t = FAULTS.poison_labels(t, 5)
        untouched = FAULTS.poison_labels(t, 4)
    finally:
        JFAULTS.FAULTS.clear()
    np.testing.assert_array_equal(ours, theirs)
    assert isinstance(ours_t, torch.Tensor) and ours_t.device == t.device
    np.testing.assert_array_equal(ours_t.numpy(), theirs)
    assert untouched is t and torch.equal(t, torch.from_numpy(y))  # a copy
    assert (theirs != y).sum() == max(1, round(fraction * 37))


# ------------------------------------- the benchmark's closed loop, in both
LOOP = dict(stations=8, rows=32, features=16, seeded=5, rounds=6,
            local_steps=2, batch=16, lr=0.02)


def _loop_data():
    c = LOOP
    rng = np.random.default_rng(7)
    x = rng.standard_normal(
        (c["stations"], c["rows"], c["features"])).astype(np.float32)
    beta = rng.standard_normal(c["features"]).astype(np.float32)
    y = (x @ beta + 0.05 * rng.standard_normal(
        (c["stations"], c["rows"]))).astype(np.float32)
    return x, y


def _jax_draws(key, counts):
    """The JAX engine's batch indices of ``run_rounds``: [K, S, L, B]."""
    out = []
    for round_key in jax.random.split(key, LOOP["rounds"]):
        out.append([[np.asarray(jax.random.randint(
            k, (LOOP["batch"],), 0, max(int(n), 1)))
            for k in jax.random.split(jax.random.fold_in(round_key, sid),
                                      LOOP["local_steps"])]
            for sid, n in enumerate(counts)])
    return np.asarray(out)


def _closed_loop(pkg, x, y, run):
    """Poison station 5 through ``FAULTS``, record the poisoned run into
    the learning plane, let a private watchdog's ``anomalous_station``
    drive an ``ArrayActuator`` through the autopilot, run again under its
    mask, then clear the history and watch the mask revert."""
    faults = importlib.import_module(f"{pkg}.common.faults").FAULTS
    learning = importlib.import_module(f"{pkg}.runtime.learning").LEARNING
    ap = importlib.import_module(f"{pkg}.runtime.autopilot")
    wdm = importlib.import_module(f"{pkg}.runtime.watchdog")
    s = LOOP["seeded"]
    faults.configure(f"flip:station={s},fraction=1.0")
    try:
        y = y.copy() if isinstance(y, np.ndarray) else y.clone()
        y[s] = faults.poison_labels(y[s], s)
    finally:
        faults.clear()
    learning.clear()
    out = {"y": np.asarray(y)}
    _, _, out["losses_poisoned"], stats = run(y, None)
    wd = wdm.Watchdog(interval=60.0)
    wd.register_feed("learning", learning.feed)
    act = ap.ArrayActuator(LOOP["stations"])
    pilot = ap.Autopilot(act, watchdog=wd, dry_run=False,
                         listener_key="test-closed-loop").attach()
    try:
        learning.history("closed-loop").record_engine(
            out["losses_poisoned"], stats)
        wd.evaluate()
        out["masked"] = act.masked.copy()
        out["params"], _, out["losses_masked"], _ = run(
            y, act.participation_mask())
        learning.clear()
        wd.evaluate()
        out["reverted"] = not act.masked.any()
        out["digest"] = pilot.digest()
    finally:
        pilot.detach()
        learning.clear()
    return out


def test_closed_loop_masks_the_jax_packages_station():
    from vantage6_tpu.core.mesh import FederationMesh as JaxMesh
    from vantage6_tpu.fed import fedavg as jf

    x, y = _loop_data()
    counts = np.full(LOOP["stations"], float(LOOP["rows"]), np.float32)
    key = jax.random.key(3)
    kw = dict(local_steps=LOOP["local_steps"], batch_size=LOOP["batch"],
              local_lr=LOOP["lr"])

    def jax_loss(p, bx, by, w):
        return jnp.sum(w * (bx @ p - by) ** 2) / jnp.maximum(jnp.sum(w), 1.0)

    def loss(p, bx, by, w):
        return torch.sum(w * (bx @ p - by) ** 2) / torch.clamp_min(
            torch.sum(w), 1.0)

    jeng = jf.FedAvg(JaxMesh(LOOP["stations"], devices=jax.devices()[:1]),
                     jf.FedAvgSpec(loss_fn=jax_loss, local_unroll=True, **kw))
    eng = FedAvg(FederationMesh(LOOP["stations"], device="cpu"),
                 FedAvgSpec(loss_fn=loss, **kw))
    idx = _jax_draws(key, counts)

    def jax_run(y_, mask):
        return jeng.run_rounds(
            jnp.zeros(LOOP["features"]), jnp.asarray(x), jnp.asarray(y_),
            jnp.asarray(counts), key, LOOP["rounds"], donate=False,
            unroll=True, mask=None if mask is None else jnp.asarray(mask))

    def run(y_, mask):
        return eng.run_rounds(
            torch.zeros(LOOP["features"]), torch.from_numpy(x), y_,
            torch.from_numpy(counts), None, LOOP["rounds"], mask=mask,
            batch_idx=idx)

    theirs = _closed_loop("vantage6_tpu", x, y, jax_run)
    ours = _closed_loop("vantage6_tpu_torch", x, torch.from_numpy(y), run)
    np.testing.assert_array_equal(ours["y"], theirs["y"])
    expect = np.arange(LOOP["stations"]) == LOOP["seeded"]
    np.testing.assert_array_equal(theirs["masked"], expect)
    np.testing.assert_array_equal(ours["masked"], expect)
    np.testing.assert_allclose(ours["params"].numpy(),
                               np.asarray(theirs["params"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours["losses_masked"].numpy(),
                               np.asarray(theirs["losses_masked"]),
                               rtol=1e-5, atol=1e-6)
    poisoned = float(ours["losses_poisoned"][-1])
    masked = float(ours["losses_masked"][-1])
    assert masked < poisoned
    assert ours["reverted"] and theirs["reverted"]
    assert (ours["digest"]["applied"], ours["digest"]["reverted"]) == (1, 1)


def test_participation_mask_is_fedavgs_mask():
    """``ArrayActuator.participation_mask()`` is numpy; ``round`` and
    ``run_rounds`` take it as they take the tensor."""
    x, y = _loop_data()
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    counts = torch.full((LOOP["stations"],), float(LOOP["rows"]))

    def loss(p, bx, by, w):
        return torch.sum(w * (bx @ p - by) ** 2) / torch.clamp_min(
            torch.sum(w), 1.0)

    eng = FedAvg(FederationMesh(LOOP["stations"], device="cpu"),
                 FedAvgSpec(loss_fn=loss, local_steps=2, batch_size=8))
    act = ArrayActuator(LOOP["stations"])
    act.mask_station(3, True)
    mask = act.participation_mask()
    assert isinstance(mask, np.ndarray) and mask.dtype == np.float32
    p0 = torch.zeros(LOOP["features"])
    a = eng.round(p0, eng.init(p0), xs, ys, counts, 4, mask=mask)
    b = eng.round(p0, eng.init(p0), xs, ys, counts, 4,
                  mask=torch.from_numpy(mask))
    assert torch.equal(a[0], b[0])
    c = eng.run_rounds(p0, xs, ys, counts, 4, 2, mask=mask)
    d = eng.run_rounds(p0, xs, ys, counts, 4, 2, mask=torch.from_numpy(mask))
    assert torch.equal(c[0], d[0])
    assert float(c[3]["station_weight"][0][3]) == 0.0


# --------------------------------------------- the Federation as actuator
@data(1)
def _timed_partial(df):
    time.sleep(0.005)  # a station's local work
    return {"sum": float(df["x"].sum()), "n": int(len(df["x"]))}


def test_federation_autopilot_shrinks_and_restores_a_straggler():
    """``autopilot: {enabled: true}``: a delayed station raises
    ``straggler_station`` through ``WATCHDOG``; the Federation, as its own
    actuator, shrinks the station's selection weight to the policy's 0.25
    and restores 1.0 once the fault is gone and the alert clears."""
    gc.collect()
    n = 8
    cfg = FederationConfig.from_dict({
        "federation": {"autopilot": {"enabled": True},
                       "executor_workers": n},
        "stations": [{"name": f"s{i}"} for i in range(n)],
    })
    fed = Federation(cfg, device="cpu",
                     algorithms={"img": {"timed": _timed_partial}})
    fed.set_datasets("default", [{"x": np.arange(8.0) + i}
                                 for i in range(n)])
    try:
        FAULTS.configure("delay:station=0,seconds=0.1")
        for _ in range(3):
            fed.create_task("img", {"method": "timed"})
        FAULTS.clear()
        WATCHDOG.evaluate()
        mine = [a for a in WATCHDOG.active_alerts()
                if a["rule"] == "straggler_station"
                and a["labels"] == {"station": 0}]
        assert mine and "station 0 was the straggler" in mine[0]["message"]
        assert fed.selection_weights()[0] == 0.25
        for _ in range(8):
            fed.create_task("img", {"method": "timed"})
        WATCHDOG.evaluate()
        assert fed.selection_weights()[0] == 1.0
        digest = fed.autopilot.digest()
        assert digest["applied"] >= 1 and digest["reverted"] >= 1
    finally:
        FAULTS.clear()
        fed.close()
        WATCHDOG.evaluate()
