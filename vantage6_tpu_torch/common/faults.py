"""Deterministic fault-injection harness (``V6T_FAULTS=`` spec).

The robustness loop (watchdog -> autopilot -> actuator) is only credible
if the failures it handles can be produced on demand, repeatably. This
module is that switchboard: a seedable plan of fault rules, parsed from
the ``V6T_FAULTS`` environment variable (or installed programmatically by
tests/bench), probed from a handful of fixed injection points:

- ``station_delay`` / ``drop_result`` — `Federation._run_host`: delay a
  station's host-mode execution, or swallow its result so the run wedges
  ACTIVE (the stuck_run / straggler food groups).
- ``daemon_crash``      — `node.daemon`: die mid-round WITHOUT the
  offline handshake (daemon_lapsed food group).
- ``rest_status``       — `common.rest.RestSession.request`: answer a
  burst of requests with an injected 5xx before touching the wire.
- ``poison_labels``     — label-flip poisoning for a station's targets
  (anomalous_station food group); callers opt in at data-prep time.
- ``wedge_seconds``     — `bench._run_worker`: wedge a named bench
  operation (e.g. the TPU probe) so the per-leg budget/checkpoint
  machinery can be exercised without real broken hardware.

Spec grammar — semicolon-separated rules, ``kind:key=value,...``::

    V6T_FAULTS="delay:station=0,seconds=0.3;rest500:count=3,seed=7"

kinds and their keys (all keys optional unless noted):

=========  ==============================================================
delay      station (int or ``*``), seconds (float, required), prob,
           limit, after
drop       station (int or ``*``), prob, limit, after
crash      prob, limit (default 1), after
rest500    status (default 500), endpoint (substring filter), count
           (alias for limit, default 3), prob, after
flip       station (int or ``*``), fraction (default 1.0)
wedge      op (substring filter on the operation name, e.g. ``probe``),
           seconds (float, required — how long the op hangs), prob,
           limit (default 1), after
=========  ==============================================================

``prob`` gates each opportunity through the rule's own ``random.Random``
seeded from ``seed`` (key or plan-level), so a given spec produces the
same firing sequence every run. ``limit`` caps total firings; ``after``
skips the first N opportunities (e.g. let two clean rounds pass first).

Everything is fail-soft at probe time: an empty plan answers every probe
with "no fault" at the cost of one attribute read, and a malformed env
spec logs and disables injection rather than taking the process down.
`FaultPlan.parse` itself is fail-loud (ValueError) so tests catch typos.

The port's copy of ``vantage6_tpu/common/faults.py``: the same grammar,
seeds and firing streams (one spec fires the same opportunities in both
packages), and ``poison_labels`` flips the same indices of a numpy array
or a torch tensor, returning a tensor on the tensor's device. The port
probes ``station_delay``/``drop_result`` in ``Federation._run_host`` and
``rest_status`` in ``RestSession.request``; the daemon's ``crash`` point
and the bench's ``wedge`` point come with the node and the benchmark.
"""
from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any

log = logging.getLogger(__name__)

ENV_VAR = "V6T_FAULTS"

_KINDS = ("delay", "drop", "crash", "rest500", "flip", "wedge")

# per-kind key coercions; unknown keys are a parse error
_KEY_TYPES: dict[str, Any] = {
    "station": str,  # int index or "*"
    "seconds": float,
    "status": int,
    "endpoint": str,
    "fraction": float,
    "op": str,  # wedge: substring filter on the operation name
    "prob": float,
    "limit": int,
    "count": int,  # rest500 alias for limit
    "after": int,
    "seed": int,
}


@dataclass
class FaultRule:
    """One parsed rule plus its private RNG and firing counters."""

    kind: str
    station: str = "*"
    seconds: float = 0.0
    status: int = 500
    endpoint: str = ""
    op: str = ""
    fraction: float = 1.0
    prob: float = 1.0
    limit: int | None = None
    after: int = 0
    seed: int = 0
    seen: int = 0
    fired: int = 0
    _rng: random.Random = field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        # kind folded into the seed so two rules sharing a plan seed
        # still draw independent streams; a STRING seed, not a tuple —
        # str seeding is deterministic across processes (tuple seeding
        # rides the salted hash() and is deprecated)
        self._rng = random.Random(f"{self.seed}:{self.kind}:{self.station}")

    def matches_station(self, station: int | None) -> bool:
        if self.station == "*":
            return True
        return station is not None and str(station) == self.station

    def fires(
        self, *, station: int | None = None, endpoint: str = "",
        op: str = "",
    ) -> bool:
        """One opportunity: match filters, then after/limit/prob gates.
        Counters advance only on matched opportunities so `after` means
        'skip the first N times this rule COULD have fired'."""
        if not self.matches_station(station):
            return False
        if self.endpoint and self.endpoint not in endpoint:
            return False
        if self.op and self.op not in op:
            return False
        self.seen += 1
        if self.seen <= self.after:
            return False
        if self.limit is not None and self.fired >= self.limit:
            return False
        if self.prob < 1.0 and self._rng.random() >= self.prob:
            return False
        self.fired += 1
        return True


def _parse_rule(chunk: str, plan_seed: int) -> FaultRule:
    head, _, tail = chunk.partition(":")
    kind = head.strip()
    if kind not in _KINDS:
        raise ValueError(
            f"unknown fault kind {kind!r} (expected one of {_KINDS})"
        )
    kw: dict[str, Any] = {"kind": kind, "seed": plan_seed}
    for part in filter(None, (p.strip() for p in tail.split(","))):
        key, eq, raw = part.partition("=")
        key = key.strip()
        if not eq or key not in _KEY_TYPES:
            raise ValueError(f"bad fault key {part!r} in {chunk!r}")
        try:
            value = _KEY_TYPES[key](raw.strip())
        except ValueError as e:
            raise ValueError(f"bad fault value {part!r} in {chunk!r}") from e
        if key == "count":  # rest500-friendly alias
            key = "limit"
        kw[key] = value
    if kind == "delay" and kw.get("seconds", 0.0) <= 0.0:
        raise ValueError(f"delay rule needs seconds>0: {chunk!r}")
    if kind == "rest500" and "limit" not in kw:
        kw["limit"] = 3  # a *burst*, not a permanent outage
    if kind == "crash" and "limit" not in kw:
        kw["limit"] = 1  # crash once by default
    if kind == "wedge":
        if kw.get("seconds", 0.0) <= 0.0:
            raise ValueError(f"wedge rule needs seconds>0: {chunk!r}")
        kw.setdefault("limit", 1)  # wedge once by default
    return FaultRule(**kw)


class FaultPlan:
    """A parsed set of rules; every probe is thread-safe."""

    def __init__(self, rules: list[FaultRule] | tuple[FaultRule, ...] = ()):
        self.rules = list(rules)
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        rules = [
            _parse_rule(chunk, seed)
            for chunk in filter(None, (c.strip() for c in spec.split(";")))
        ]
        return cls(rules)

    def _fire(self, kind: str, **match: Any) -> FaultRule | None:
        with self._lock:
            for rule in self.rules:
                if rule.kind == kind and rule.fires(**match):
                    return rule
        return None

    # ------------------------------------------------------------- probes
    def station_delay(self, station: int | None) -> float:
        rule = self._fire("delay", station=station)
        return rule.seconds if rule else 0.0

    def drop_result(self, station: int | None) -> bool:
        return self._fire("drop", station=station) is not None

    def daemon_crash(self) -> bool:
        return self._fire("crash") is not None

    def rest_status(self, endpoint: str) -> int | None:
        rule = self._fire("rest500", endpoint=endpoint)
        return rule.status if rule else None

    def wedge_seconds(self, op: str) -> float:
        """Seconds the named bench operation should hang (0.0 = no
        wedge). `op` is matched as a substring against the rule's
        ``op`` filter — an empty filter wedges every probed op."""
        rule = self._fire("wedge", op=op)
        return rule.seconds if rule else 0.0

    def flip_fraction(self, station: int | None) -> float:
        with self._lock:
            for rule in self.rules:
                if rule.kind == "flip" and rule.matches_station(station):
                    return rule.fraction
        return 0.0

    def snapshot(self) -> list[dict[str, Any]]:
        """Firing counts per rule — for assertions and flight notes."""
        with self._lock:
            return [
                {
                    "kind": r.kind,
                    "station": r.station,
                    "seen": r.seen,
                    "fired": r.fired,
                }
                for r in self.rules
            ]


class FaultInjector:
    """Process-global holder with a stable identity, so every injection
    point can ``from vantage6_tpu_torch.common.faults import FAULTS`` once and
    see reconfigurations. Empty plan == injection disabled."""

    def __init__(self):
        self._plan = FaultPlan()

    @property
    def active(self) -> bool:
        return bool(self._plan.rules)

    def configure(self, spec: str | None, seed: int = 0) -> FaultPlan:
        """Install a plan from a spec string (None/"" clears). Returns
        the installed plan so tests can inspect firing counters."""
        self._plan = FaultPlan.parse(spec, seed=seed) if spec else FaultPlan()
        if self._plan.rules:
            log.warning(
                "fault injection ARMED: %d rule(s) from spec %r",
                len(self._plan.rules), spec,
            )
        return self._plan

    def clear(self) -> None:
        self._plan = FaultPlan()

    # --------------------------------------------- probes (all fail-soft)
    def sleep_station_delay(self, station: int | None) -> float:
        """Probe + perform a station delay; returns seconds slept."""
        if not self.active:
            return 0.0
        seconds = self._plan.station_delay(station)
        if seconds > 0.0:
            log.info("fault: delaying station %s by %.2fs", station, seconds)
            time.sleep(seconds)
        return seconds

    def drop_result(self, station: int | None) -> bool:
        return self.active and self._plan.drop_result(station)

    def daemon_crash(self) -> bool:
        return self.active and self._plan.daemon_crash()

    def rest_status(self, endpoint: str) -> int | None:
        if not self.active:
            return None
        return self._plan.rest_status(endpoint)

    def wedge_seconds(self, op: str) -> float:
        """How long the named bench operation should hang (0.0 = run
        normally). The CALLER sleeps — usually inside the wedged worker
        subprocess — so the parent's per-leg timeout machinery sees a
        realistic hang, not an instant failure."""
        if not self.active:
            return 0.0
        return self._plan.wedge_seconds(op)

    def poison_labels(self, y: Any, station: int | None) -> Any:
        """Sign-flip a deterministic `fraction` of labels when a ``flip``
        rule matches `station`; otherwise return `y` untouched. Works on
        anything numpy-like with fancy indexing, and on a torch tensor,
        whose copy stays on its device."""
        if not self.active:
            return y
        fraction = self._plan.flip_fraction(station)
        if fraction <= 0.0:
            return y
        import numpy as np
        import torch

        n = int(y.shape[0])
        k = max(1, int(round(fraction * n)))
        idx = random.Random(f"flip:{station}:{n}").sample(range(n), k)
        if isinstance(y, torch.Tensor):
            y = y.clone()
            sel = torch.tensor(idx, dtype=torch.long, device=y.device)
            y[sel] = -y[sel]
        else:
            y = np.array(y, copy=True)
            y[idx] = -y[idx]
        log.info("fault: label-flipped %d/%d targets on station %s", k, n, station)
        return y

    def snapshot(self) -> list[dict[str, Any]]:
        return self._plan.snapshot()


FAULTS = FaultInjector()

_env_spec = os.environ.get(ENV_VAR)
if _env_spec:
    try:
        FAULTS.configure(_env_spec, seed=int(os.environ.get("V6T_FAULTS_SEED", "0")))
    except Exception:
        log.exception(
            "ignoring malformed %s=%r (fault injection disabled)",
            ENV_VAR, _env_spec,
        )
