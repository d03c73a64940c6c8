"""The port's fleet push, on the CPU.

Copies of ``tests/test_fleet.py``'s ``TestPushWire``, ``TestSloBurnRate``
and ``TestCapabilityPin`` with their imports switched to the port (the
server-side cases wait for the port's server). Then: a push that one
package encodes, the other decodes, both ways; and a ``Federation`` with
``attach_fleet_push`` pushes once per round boundary
(``wait_for_results``, ``run_buffered``, ``run_fused_rounds``) to an
in-process recorder, each push decoding to a snapshot of the port's
registry.
"""
import importlib
import time

import numpy as np
import pytest
import torch

from vantage6_tpu_torch.common.fleet import (
    FleetPusher,
    build_snapshot,
    compact_metrics,
    decode_push,
    encode_push,
)
from vantage6_tpu_torch.common.rest import RestError
from vantage6_tpu_torch.common.telemetry import REGISTRY
from vantage6_tpu_torch.runtime.watchdog import (
    RULE_CATALOG,
    RuleContext,
    Watchdog,
    default_slos,
)

JFLEET = importlib.import_module("vantage6_tpu.common.fleet")


def _payload(source: str, metrics: dict, notes=(), service="daemon",
             seq=0, ts=None):
    return {
        "source": source,
        "service": service,
        "seq": seq,
        "ts": ts if ts is not None else time.time(),
        "metrics": metrics,
        "notes": list(notes),
    }


# ------------------------------------------------------------ wire + ingest
class TestPushWire:
    def test_encode_decode_round_trip(self):
        payload = _payload("daemon:x", {"v6t_rest_calls_total": 7.0},
                           notes=[{"kind": "fleet_test", "ts": 1.0}])
        back = decode_push(encode_push(payload))
        assert back["source"] == "daemon:x"
        assert back["metrics"]["v6t_rest_calls_total"] == 7.0
        assert back["notes"][0]["kind"] == "fleet_test"

    def test_decode_rejects_garbage(self):
        with pytest.raises(ValueError):
            decode_push({"blob": "not base64!!", "encoding": "wire+b64"})
        with pytest.raises(ValueError):
            decode_push({"encoding": "wire+b64"})
        with pytest.raises(ValueError):
            # decodes, but carries no source stamp
            decode_push(encode_push({"metrics": {}}))

    def test_build_snapshot_folds_histograms(self):
        REGISTRY.histogram("v6t_run_dispatch_seconds").observe(0.25)
        snap = build_snapshot("daemon:y", "daemon", seq=3)
        assert snap["source"] == "daemon:y" and snap["seq"] == 3
        m = snap["metrics"]
        # histograms ship as _sum/_count scalars, never bucket dicts
        assert "v6t_run_dispatch_seconds_sum" in m
        assert "v6t_run_dispatch_seconds_count" in m
        assert all(isinstance(v, float) for v in m.values())
        folded = compact_metrics()
        assert "v6t_run_dispatch_seconds" not in folded



# --------------------------------------------------------------- SLO engine
def _ctx(feeds=None, config=None, now=None):
    w = Watchdog(interval=60.0)
    cfg = dict(w.config)
    cfg.update(config or {})
    return RuleContext(
        {}, {}, feeds or {}, cfg, now if now is not None else time.time()
    )


def _slo_rule(name):
    return next(s for s in default_slos() if s.name == name).to_alert_rule()


def _dispatch_samples(now, ages_values, source="daemon:slow"):
    return [
        {"metric": "v6t_run_dispatch_seconds", "source": source,
         "ts": now - age, "value": v}
        for age, v in ages_values
    ]


class TestSloBurnRate:
    CFG = {
        "slo_dispatch_target_s": 0.5,
        "slo_error_budget": 0.25,
        "slo_burn_threshold": 2.0,
        "slo_fast_window_s": 60.0,
        "slo_slow_window_s": 600.0,
        "slo_min_samples": 4,
    }

    def test_fast_burn_fires_naming_objective_and_window(self):
        now = time.time()
        bad = _dispatch_samples(now, [(i + 1.0, 5.0) for i in range(6)])
        c = _ctx(feeds={"srv": {"slo_dispatch": bad}},
                 config=self.CFG, now=now)
        found = _slo_rule("slo_dispatch_latency").check(c)
        assert len(found) == 1
        msg = found[0]["message"]
        assert "99% of run dispatches" in msg       # names the objective
        assert "fast 60s window" in msg             # names the window
        assert "slow 600s window" in msg
        assert "worst source daemon:slow" in msg    # names the offender
        assert found[0]["labels"] == {"slo": "slo_dispatch_latency"}

    def test_slow_noise_stays_quiet(self):
        """Sporadic over-target samples inside the fast window burn fast
        but not slow — the multi-window AND keeps the alert quiet."""
        now = time.time()
        noise = _dispatch_samples(now, [(i + 1.0, 5.0) for i in range(4)])
        healthy = _dispatch_samples(
            now, [(120.0 + i, 0.01) for i in range(28)],
            source="daemon:fine",
        )
        c = _ctx(feeds={"srv": {"slo_dispatch": noise + healthy}},
                 config=self.CFG, now=now)
        assert _slo_rule("slo_dispatch_latency").check(c) == []

    def test_replica_duplicate_samples_do_not_double_count(self):
        """Two replicas feed the same shared store: identical samples
        arriving through both feeds must dedupe, or every burn rate
        doubles on a 2-replica deployment."""
        now = time.time()
        bad = _dispatch_samples(now, [(i + 1.0, 5.0) for i in range(6)])
        c = _ctx(
            feeds={"replica-a": {"slo_dispatch": bad},
                   "replica-b": {"slo_dispatch": list(bad)}},
            config=self.CFG, now=now,
        )
        found = _slo_rule("slo_dispatch_latency").check(c)
        assert len(found) == 1
        assert "(6 samples)" in found[0]["message"]

    def test_no_feed_proposes_nothing(self):
        # a daemon-side watchdog has no fleet feed: SLO rules must stay
        # silent, not crash or alert on emptiness
        c = _ctx(config=self.CFG)
        for slo in default_slos():
            assert slo.to_alert_rule().check(c) == []

    def test_throughput_collapse_fires_only_with_baseline(self):
        now = time.time()
        cfg = dict(self.CFG, slo_throughput_floor_pct=50.0)
        # cumulative counter: +1 round/s for 10 min, then flatlines for
        # the whole fast window
        hist = [
            {"metric": "v6t_round_updates_total", "source": "srv",
             "ts": now - age, "value": 600.0 - age}
            for age in (590.0, 400.0, 200.0, 70.0)
        ]
        flat = [
            {"metric": "v6t_round_updates_total", "source": "srv",
             "ts": now - age, "value": 530.0}
            for age in (50.0, 5.0)
        ]
        rule = _slo_rule("slo_round_throughput")
        c = _ctx(feeds={"f": {"slo_rounds": hist + flat}},
                 config=cfg, now=now)
        found = rule.check(c)
        assert len(found) == 1
        assert "round throughput" in found[0]["message"]
        assert "below 50%" in found[0]["message"]
        # without an established slow-window baseline: quiet, whatever
        # the fast window does
        c2 = _ctx(feeds={"f": {"slo_rounds": flat}}, config=cfg, now=now)
        assert rule.check(c2) == []

    def test_liveness_grace_separates_restart_from_outage(self):
        cfg = dict(self.CFG, slo_liveness_ratio=0.75,
                   slo_liveness_slow_grace_s=120.0)
        rule = _slo_rule("slo_daemon_liveness")

        def census(age):
            return [
                {"source": "daemon:ok", "service": "daemon",
                 "age_s": 1.0, "stale": False},
                {"source": "daemon:gone", "service": "daemon",
                 "age_s": age, "stale": True},
            ]

        # stale past the grace: a real outage, burn in BOTH windows
        c = _ctx(feeds={"f": {"fleet_sources": census(500.0)}}, config=cfg)
        found = rule.check(c)
        assert len(found) == 1
        assert "most lagging: daemon:gone" in found[0]["message"]
        # stale but within the grace (a restart): fast burn only -> quiet
        c2 = _ctx(feeds={"f": {"fleet_sources": census(60.0)}}, config=cfg)
        assert rule.check(c2) == []

    def test_default_slos_are_cataloged(self):
        for slo in default_slos():
            assert slo.name in RULE_CATALOG
            assert slo.name.startswith("slo_")




# -------------------------------------------------- pre-fleet server interop
class TestCapabilityPin:
    def test_404_pins_the_pusher_off(self):
        calls = []

        def request(method, endpoint, json_body=None, **kw):
            calls.append(endpoint)
            raise RestError(404, "no such route")

        p = FleetPusher("daemon:old", "daemon", request, interval=0.05)
        before = REGISTRY.counter("v6t_fleet_push_unsupported_total").value
        assert p.push() is False
        assert p.supported is False
        assert "pinned off" in p.last_error
        after = REGISTRY.counter("v6t_fleet_push_unsupported_total").value
        assert after == before + 1
        time.sleep(0.06)
        # pinned: due() says no, maybe_push() never touches the wire again
        assert p.due() is False
        assert p.maybe_push() is False
        assert calls == ["telemetry"]

    def test_transient_error_retries_after_interval(self):
        boom = [True]
        accepted = []

        def request(method, endpoint, json_body=None, **kw):
            if boom[0]:
                raise RestError(503, "try later")
            accepted.append(decode_push(json_body)["source"])

        p = FleetPusher("daemon:new", "daemon", request, interval=0.05)
        assert p.push() is False
        assert p.supported is None  # transient, NOT pinned
        boom[0] = False
        time.sleep(0.06)
        assert p.maybe_push() is True
        assert p.supported is True
        assert accepted == ["daemon:new"]
        # seq advances only on accepted pushes
        assert p._seq == 1


# --------------------------------------------------- the two packages' wire
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_push_reads_back_in_the_other_package(direction):
    payload = _payload("federation:x", {"v6t_rest_calls_total": 7.0,
                                        "v6t_device_mem_bytes_in_use": 3e9},
                       notes=[{"kind": "async_round", "ts": 1.5,
                               "accepted": [1, 2]}], seq=4, ts=12.25)
    enc, dec = ((encode_push, JFLEET.decode_push)
                if direction == "port_to_jax"
                else (JFLEET.encode_push, decode_push))
    body = enc(payload)
    assert body["encoding"] == "wire+b64"
    assert dec(body) == payload
    assert body == (JFLEET.encode_push if enc is encode_push
                    else encode_push)(payload)  # the same bytes


# ----------------------------------------------- the Federation's pushes
def test_federation_pushes_at_round_boundaries():
    from vantage6_tpu_torch.algorithm import data
    from vantage6_tpu_torch.fed.fedavg import AsyncRoundSpec
    from vantage6_tpu_torch.runtime.federation import federation_from_datasets

    @data(1)
    def part(d):
        return {"sum": float(np.sum(d["x"]))}

    fed = federation_from_datasets(
        [{"x": np.arange(4.0) + i} for i in range(3)],
        {"img": {"part": part}}, executor_workers=3, device="cpu")
    pushes = []

    def request(method, endpoint, json_body=None, **kw):
        assert (method, endpoint) == ("post", "telemetry")
        pushes.append(decode_push(json_body))

    pusher = fed.attach_fleet_push(request, interval=0.05)
    assert pusher.source == "federation:mock"
    try:
        t = fed.create_task("img", {"method": "part"})
        fed.wait_for_results(t.id)
        assert len(pushes) == 1
        # rate-limited to the interval: an immediate second boundary waits
        fed.wait_for_results(t.id)
        assert len(pushes) == 1
        time.sleep(0.06)
        fed.run_buffered("img", {"method": "part"},
                         AsyncRoundSpec(quorum=2, over_select=1),
                         rng=np.random.default_rng(0))
        assert len(pushes) == 2
        assert any(n["kind"] == "async_round" for n in pushes[1]["notes"])
    finally:
        fed.close()
    assert [p["seq"] for p in pushes] == [0, 1]
    assert all(p["service"] == "federation" for p in pushes)
    assert all("v6t_async_rounds_total" in p["metrics"] or i == 0
               for i, p in enumerate(pushes))


def test_federation_pushes_after_a_fused_dispatch():
    from vantage6_tpu_torch.runtime.federation import federation_from_datasets
    from vantage6_tpu_torch.workloads import fedavg_mnist as W

    fed = federation_from_datasets([{"x": np.zeros(2)}] * 2, {},
                                   executor_workers=0, device="cpu")
    eng = W.make_engine(fed.mesh, local_steps=1, batch_size=4)
    x, y, counts = W.make_federated_data(2, n_per_station=8, mesh=fed.mesh)
    params = W.init_params(0, device="cpu")
    pushes = []
    fed.attach_fleet_push(
        lambda m, e, json_body=None, **kw: pushes.append(
            decode_push(json_body)), interval=0.05)
    try:
        out = fed.run_fused_rounds(eng, params, x, y, counts, 1, 2)
    finally:
        fed.close()
    assert len(out["losses"]) == 2
    assert len(pushes) == 1 and pushes[0]["metrics"]
