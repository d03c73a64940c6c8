"""Autopilot: closed-loop remediation driven by watchdog alerts.

The watchdog rules, trace spans, flight notes and learning stats give
the system senses, but every runbook still ends with a human "mask it /
kill it / requeue it". This module closes the loop: it
subscribes to the watchdog's raise/clear transitions
(:meth:`Watchdog.add_listener`) and maps each alert rule to one
remediation **policy** applied against an **actuator**:

=================== ============================== =====================
alert rule          action (on raise)              revert (on clear)
=================== ============================== =====================
straggler_station   shrink the station's selection restore weight to 1.0
                    weight (``straggler_weight``,
                    default 0.25)
anomalous_station   mask the station out of the    unmask
                    aggregate
daemon_lapsed       requeue the node's ACTIVE runs one-shot (no revert)
replica_lapsed      requeue runs the dead replica  one-shot (no revert)
                    stranded ACTIVE
queue_buildup       admission control: new host    lift + drain queued
                    runs queue instead of          runs
                    dispatching
=================== ============================== =====================

Every action and revert emits the full observability triple: a span
``autopilot.<action>`` parented on the alert's traceparent (so it lands
on the affected task's own trace, right after the watchdog's
``alert.<rule>`` span), a flight note (``autopilot_action`` /
``autopilot_revert`` — `tools/doctor.py` renders these as its autopilot
digest), and ``v6t_autopilot_*`` counters.

**Actuators are duck-typed.** A policy probes the actuator for the one
method it needs (``set_selection_weight``, ``mask_station``,
``requeue_node_runs``, ``requeue_replica_runs``,
``set_admission_limited``) and skips — counted as suppressed — when the
capability is absent. `runtime.federation.Federation` implements the
station-shaped capabilities; the server's actuator (`server.app`)
implements the requeue capabilities, CAS-guarded so concurrent
remediation on two replicas requeues each run exactly once.
:class:`ArrayActuator` is the dependency-free implementation for
engine-level loops (bench legs, tests) that drive ``FedAvg`` masks
directly.

Safety rails: **dry-run mode** (``V6T_AUTOPILOT_DRY_RUN=1`` or
``dry_run=True``) logs/notes/counts every decision without touching the
actuator, and **per-rule disable** (``V6T_AUTOPILOT_DISABLE=rule1,rule2``
or ``disable={...}``) turns individual policies off. Policies are
audited by ``tools/check_collect.py``: every policy must name a rule in
``RULE_CATALOG`` and declare its ``v6t_autopilot_*`` series in
``KNOWN_METRICS``.

The port's copy of ``vantage6_tpu/runtime/autopilot.py``: the same
policies, spans, flight notes and series. The port's ``Federation`` is
the station-shaped actuator (``autopilot: {enabled: true}``), and
``ArrayActuator.participation_mask()`` is numpy, which the port's
``FedAvg.round``/``run_rounds(mask=)`` take as they take a tensor. The
server's requeue actuator comes with the server.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Callable

from vantage6_tpu_torch.common.log import setup_logging
from vantage6_tpu_torch.common.telemetry import REGISTRY
from vantage6_tpu_torch.runtime.tracing import TRACER
from vantage6_tpu_torch.runtime.watchdog import WATCHDOG, Alert, Watchdog

log = setup_logging("vantage6_tpu_torch/autopilot")

# the shared series every default policy emits through the engine;
# declared once here, referenced by each policy, audited by check_collect
_SHARED_METRICS: tuple[str, ...] = (
    "v6t_autopilot_actions_total",
    "v6t_autopilot_reverts_total",
    "v6t_autopilot_suppressed_total",
    "v6t_autopilot_engaged",
)


@dataclasses.dataclass(frozen=True)
class AutopilotPolicy:
    """One rule -> remediation mapping.

    ``apply(actuator, alert, config)`` performs the action and returns a
    detail dict for the span/note, or **None when the actuator lacks the
    capability** (the policy is inapplicable on this topology — skipped,
    counted as suppressed). ``revert`` is None for one-shot actions
    (requeues): there is nothing to undo on clear.
    """

    rule: str
    action: str
    revert_action: str | None
    summary: str
    metrics: tuple[str, ...]
    apply: Callable[[Any, Alert, dict[str, Any]], dict[str, Any] | None]
    revert: Callable[[Any, Alert, dict[str, Any]], dict[str, Any] | None] | None = None

    def validate(self) -> None:
        from vantage6_tpu_torch.runtime.watchdog import RULE_CATALOG

        if self.rule not in RULE_CATALOG:
            raise ValueError(
                f"autopilot policy {self.action!r} names unknown alert "
                f"rule {self.rule!r}"
            )
        for name in self.metrics:
            if not name.startswith("v6t_autopilot_"):
                raise ValueError(
                    f"autopilot policy {self.action!r} metric {name!r} "
                    "must be v6t_autopilot_*"
                )


def _station_of(alert: Alert) -> int | None:
    st = alert.labels.get("station")
    try:
        return int(st)
    except (TypeError, ValueError):
        return None


def _apply_shrink_selection(
    actuator: Any, alert: Alert, config: dict[str, Any]
) -> dict[str, Any] | None:
    fn = getattr(actuator, "set_selection_weight", None)
    station = _station_of(alert)
    if fn is None or station is None:
        return None
    weight = float(config.get("straggler_weight", 0.25))
    fn(station, weight)
    return {"station": station, "weight": weight}


def _revert_shrink_selection(
    actuator: Any, alert: Alert, config: dict[str, Any]
) -> dict[str, Any] | None:
    fn = getattr(actuator, "set_selection_weight", None)
    station = _station_of(alert)
    if fn is None or station is None:
        return None
    fn(station, 1.0)
    return {"station": station, "weight": 1.0}


def _apply_mask_station(
    actuator: Any, alert: Alert, config: dict[str, Any]
) -> dict[str, Any] | None:
    fn = getattr(actuator, "mask_station", None)
    station = _station_of(alert)
    if fn is None or station is None:
        return None
    fn(station, True)
    return {"station": station, "task": alert.labels.get("task")}


def _revert_mask_station(
    actuator: Any, alert: Alert, config: dict[str, Any]
) -> dict[str, Any] | None:
    fn = getattr(actuator, "mask_station", None)
    station = _station_of(alert)
    if fn is None or station is None:
        return None
    fn(station, False)
    return {"station": station, "task": alert.labels.get("task")}


def _apply_requeue_node(
    actuator: Any, alert: Alert, config: dict[str, Any]
) -> dict[str, Any] | None:
    fn = getattr(actuator, "requeue_node_runs", None)
    node_id = alert.labels.get("node_id")
    if fn is None or node_id is None:
        return None
    n = fn(int(node_id))
    return {"node_id": node_id, "requeued": int(n)}


def _apply_requeue_replica(
    actuator: Any, alert: Alert, config: dict[str, Any]
) -> dict[str, Any] | None:
    fn = getattr(actuator, "requeue_replica_runs", None)
    replica_id = alert.labels.get("replica_id")
    if fn is None or replica_id is None:
        return None
    n = fn(str(replica_id))
    return {"replica_id": replica_id, "requeued": int(n)}


def _apply_limit_admission(
    actuator: Any, alert: Alert, config: dict[str, Any]
) -> dict[str, Any] | None:
    fn = getattr(actuator, "set_admission_limited", None)
    if fn is None:
        return None
    fn(True)
    return {"limited": True}


def _revert_limit_admission(
    actuator: Any, alert: Alert, config: dict[str, Any]
) -> dict[str, Any] | None:
    fn = getattr(actuator, "set_admission_limited", None)
    if fn is None:
        return None
    fn(False)
    return {"limited": False}


def default_policies() -> list[AutopilotPolicy]:
    return [
        AutopilotPolicy(
            rule="straggler_station",
            action="shrink_selection",
            revert_action="restore_selection",
            summary=(
                "shrink the straggler's selection weight so buffered-async "
                "rounds over-select around it; restore 1.0 on clear"
            ),
            metrics=_SHARED_METRICS,
            apply=_apply_shrink_selection,
            revert=_revert_shrink_selection,
        ),
        AutopilotPolicy(
            rule="anomalous_station",
            action="mask_station",
            revert_action="unmask_station",
            summary=(
                "mask the anomalous station out of the aggregate (FedAvg "
                "masks + participation-aware stats); unmask on clear"
            ),
            metrics=_SHARED_METRICS,
            apply=_apply_mask_station,
            revert=_revert_mask_station,
        ),
        AutopilotPolicy(
            rule="daemon_lapsed",
            action="requeue_node_runs",
            revert_action=None,
            summary=(
                "requeue the lapsed node's ACTIVE runs (CAS-guarded: "
                "exactly once across replicas); one-shot"
            ),
            metrics=_SHARED_METRICS,
            apply=_apply_requeue_node,
        ),
        AutopilotPolicy(
            rule="replica_lapsed",
            action="requeue_replica_runs",
            revert_action=None,
            summary=(
                "requeue runs stranded ACTIVE by the dead replica's lost "
                "reports (CAS-guarded); one-shot"
            ),
            metrics=_SHARED_METRICS,
            apply=_apply_requeue_replica,
        ),
        AutopilotPolicy(
            rule="queue_buildup",
            action="limit_admission",
            revert_action="restore_admission",
            summary=(
                "admission control: new host runs queue instead of "
                "dispatching until the backlog drains; lift on clear"
            ),
            metrics=_SHARED_METRICS,
            apply=_apply_limit_admission,
            revert=_revert_limit_admission,
        ),
    ]


DEFAULT_POLICIES = default_policies()


class ArrayActuator:
    """Dependency-free actuator for engine-level loops: a numpy-friendly
    participation mask + per-station selection weights + an admission
    flag, for callers that drive ``FedAvg.round(mask=...)`` themselves
    (bench legs, tests, simulators without a Federation)."""

    def __init__(self, n_stations: int):
        import numpy as np

        self.n_stations = int(n_stations)
        self.masked = np.zeros(self.n_stations, dtype=bool)
        self.selection_weights = np.ones(self.n_stations, dtype=np.float64)
        self.admission_limited = False

    def mask_station(self, station: int, masked: bool) -> None:
        self.masked[int(station)] = bool(masked)

    def set_selection_weight(self, station: int, weight: float) -> None:
        self.selection_weights[int(station)] = float(weight)

    def set_admission_limited(self, limited: bool) -> None:
        self.admission_limited = bool(limited)

    def participation_mask(self) -> Any:
        """1.0 for unmasked stations, 0.0 for masked — ready to pass as
        ``FedAvg.round(mask=...)``."""
        import numpy as np

        return (~self.masked).astype(np.float32)


def _alert_key(alert: Alert) -> tuple[str, tuple[tuple[str, str], ...]]:
    # the watchdog's own alert identity, so engaged-action bookkeeping
    # matches raise/clear pairing exactly
    return (
        alert.rule,
        tuple(sorted((k, str(v)) for k, v in alert.labels.items())),
    )


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes", "on")


class Autopilot:
    """The policy engine: one actuator, one policy per rule, engaged-
    action bookkeeping so every applied action reverts on alert clear.

    Construct with the actuator, then :meth:`attach` to subscribe to the
    watchdog (and :meth:`detach` on close). ``listener_key`` must be
    unique per engine — the watchdog's keyed-replacement semantics would
    otherwise let a second engine evict the first.
    """

    def __init__(
        self,
        actuator: Any,
        policies: list[AutopilotPolicy] | None = None,
        watchdog: Watchdog | None = None,
        dry_run: bool | None = None,
        disable: set[str] | frozenset[str] | None = None,
        config: dict[str, Any] | None = None,
        listener_key: str = "autopilot",
    ):
        self.actuator = actuator
        self.policies: dict[str, AutopilotPolicy] = {}
        for policy in policies if policies is not None else default_policies():
            policy.validate()
            if policy.rule in self.policies:
                raise ValueError(
                    f"duplicate autopilot policy for rule {policy.rule!r}"
                )
            self.policies[policy.rule] = policy
        self.watchdog = watchdog if watchdog is not None else WATCHDOG
        self.dry_run = (
            bool(dry_run) if dry_run is not None
            else _env_flag("V6T_AUTOPILOT_DRY_RUN")
        )
        env_disable = os.environ.get("V6T_AUTOPILOT_DISABLE", "")
        self.disabled: set[str] = set(disable or ()) | {
            s.strip() for s in env_disable.split(",") if s.strip()
        }
        self.config: dict[str, Any] = dict(config or {})
        self._listener_key = listener_key
        self._lock = threading.Lock()
        self._engaged: dict[Any, dict[str, Any]] = {}  # guarded-by: _lock
        self._stats = {  # guarded-by: _lock
            "applied": 0, "reverted": 0, "suppressed": 0,
        }

    # ------------------------------------------------------------ lifecycle
    def attach(self) -> "Autopilot":
        self.watchdog.add_listener(self._listener_key, self.on_transition)
        return self

    def detach(self) -> None:
        self.watchdog.remove_listener(self._listener_key, self.on_transition)

    def reconcile(self) -> None:
        """Apply policies to alerts ALREADY active at attach time — an
        engine started mid-incident must not wait for the next raise."""
        for alert_dict in self.watchdog.active_alerts():
            self.on_transition("raised", Alert(
                rule=alert_dict["rule"],
                severity=alert_dict["severity"],
                message=alert_dict["message"],
                labels=alert_dict.get("labels") or {},
                traceparent=alert_dict.get("traceparent"),
                raised_at=alert_dict.get("raised_at") or 0.0,
                last_seen_at=alert_dict.get("last_seen_at") or 0.0,
            ))

    # ------------------------------------------------------------- engine
    def on_transition(self, event: str, alert: Alert) -> None:
        """The watchdog listener: decide and act (or revert)."""
        policy = self.policies.get(alert.rule)
        if policy is None:
            return
        if event == "raised":
            self._apply(policy, alert)
        elif event == "cleared":
            self._revert(policy, alert)

    def _apply(self, policy: AutopilotPolicy, alert: Alert) -> None:
        key = _alert_key(alert)
        with self._lock:
            if key in self._engaged:
                return  # already acted on this alert
        if policy.rule in self.disabled:
            log.info(
                "autopilot: policy %s disabled, ignoring %s alert",
                policy.action, alert.rule,
            )
            return
        if self.dry_run:
            self._emit(
                "autopilot_action", policy.action, alert,
                {"summary": policy.summary}, dry_run=True,
            )
            with self._lock:
                self._stats["suppressed"] += 1
            REGISTRY.counter("v6t_autopilot_suppressed_total").inc()
            log.warning(
                "autopilot DRY-RUN: would %s for %s alert %s",
                policy.action, alert.rule, alert.labels,
            )
            return
        try:
            detail = policy.apply(self.actuator, alert, self.config)
        except Exception as e:
            log.warning(
                "autopilot action %s failed for %s %s: %s",
                policy.action, alert.rule, alert.labels, e,
            )
            return
        if detail is None:
            # actuator lacks the capability on this topology — suppressed,
            # but quietly: no span/note spam for every server-side alert a
            # federation-shaped engine can't act on
            with self._lock:
                self._stats["suppressed"] += 1
            REGISTRY.counter("v6t_autopilot_suppressed_total").inc()
            log.debug(
                "autopilot: actuator %s lacks capability for %s, skipped",
                type(self.actuator).__name__, policy.action,
            )
            return
        self._emit("autopilot_action", policy.action, alert, detail)
        with self._lock:
            self._stats["applied"] += 1
            self._engaged[key] = {
                "policy": policy, "alert": alert, "detail": detail,
            }
            n_engaged = len(self._engaged)
        REGISTRY.counter("v6t_autopilot_actions_total").inc()
        REGISTRY.gauge("v6t_autopilot_engaged").set(n_engaged)
        log.warning(
            "autopilot ACTED: %s for %s alert (%s)",
            policy.action, alert.rule, detail,
        )

    def _revert(self, policy: AutopilotPolicy, alert: Alert) -> None:
        key = _alert_key(alert)
        with self._lock:
            engaged = self._engaged.pop(key, None)
            n_engaged = len(self._engaged)
        if engaged is None:
            return  # never applied (dry-run, disabled, or pre-attach)
        REGISTRY.gauge("v6t_autopilot_engaged").set(n_engaged)
        if policy.revert is None or policy.revert_action is None:
            return  # one-shot action: nothing to undo
        try:
            detail = policy.revert(self.actuator, alert, self.config)
        except Exception as e:
            log.warning(
                "autopilot revert %s failed for %s %s: %s",
                policy.revert_action, alert.rule, alert.labels, e,
            )
            return
        if detail is None:
            return
        self._emit("autopilot_revert", policy.revert_action, alert, detail)
        with self._lock:
            self._stats["reverted"] += 1
        REGISTRY.counter("v6t_autopilot_reverts_total").inc()
        log.warning(
            "autopilot REVERTED: %s after %s cleared (%s)",
            policy.revert_action, alert.rule, detail,
        )

    def _emit(
        self,
        kind: str,
        action: str,
        alert: Alert,
        detail: dict[str, Any],
        dry_run: bool = False,
    ) -> None:
        """The observability triple minus metrics (callers own those): a
        span on the alert's trace + a flight note for doctor's digest."""
        attrs = {
            "rule": alert.rule,
            "dry_run": dry_run,
            **{f"label_{k}": v for k, v in alert.labels.items()},
            **{k: v for k, v in detail.items() if k not in ("summary",)},
        }
        with TRACER.span(
            f"autopilot.{action}", kind="autopilot", service="autopilot",
            parent=alert.traceparent,  # None -> fresh root trace
            attrs=attrs,
        ) as sp:
            sp.add_event(kind, rule=alert.rule, action=action)
        try:
            from vantage6_tpu_torch.common.flight import FLIGHT

            FLIGHT.note(
                kind, rule=alert.rule, action=action, labels=alert.labels,
                detail=detail, dry_run=dry_run,
                traceparent=alert.traceparent,
            )
        except Exception:  # pragma: no cover
            pass

    # ------------------------------------------------------------- queries
    def digest(self) -> dict[str, Any]:
        """Actions taken / reverted / suppressed + what is engaged now —
        the same census doctor renders from flight notes, for callers
        holding the live engine."""
        with self._lock:
            return {
                **self._stats,
                "engaged": [
                    {
                        "rule": e["alert"].rule,
                        "action": e["policy"].action,
                        "labels": e["alert"].labels,
                        "detail": e["detail"],
                    }
                    for e in self._engaged.values()
                ],
                "dry_run": self.dry_run,
                "disabled": sorted(self.disabled),
            }
