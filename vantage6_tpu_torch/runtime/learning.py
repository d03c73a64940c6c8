"""Learning-plane observatory: per-station update telemetry + convergence.

PRs 5/8/9 made the task plane, ops plane and device plane observable; the
LEARNING plane — is the model converging, is a station feeding it garbage
— was still a black box: a round that "succeeds" can carry a diverging
model or a poisoned/label-flipped station and nothing notices until
accuracy is inspected by hand. This module is the host side of that
fourth plane (docs/observability.md "learning plane"):

- **Statistics** come from ``fed.collectives.station_update_stats`` — one
  fused pass over the flat-packed ``[S, N]`` per-station deltas inside
  the jitted FedAvg round (per-station L2 norms, cosine-to-pooled-delta,
  per-station error-feedback mass, global update norm), fp32-identical
  between the replicated and scattered (ZeRO-1) update paths.
  :func:`update_stats_host` is the numpy twin for host-plane callers
  (Federation device-mode aggregations, the REST client side).
- **RoundHistory** is the bounded per-task record of those stats. Each
  :meth:`RoundHistory.record` feeds the ``v6t_round_*`` /
  ``v6t_station_*`` telemetry series, drops a ``learning_round`` flight
  note, and emits a ``learning.round`` span (with a ``round_recorded``
  event) on the ambient trace — so a round's learning stats land inside
  the round's own distributed trace for `tools/trace_view.py` /
  `tools/doctor.py` to merge. History state round-trips through
  :meth:`RoundHistory.state_arrays` so a checkpoint/restore keeps the
  norm-decay trajectory CONTINUOUS (no spurious ``non_convergence`` /
  ``model_divergence`` raise after a resume — ``runtime.checkpoint``'s
  ``TrainState.history`` carries it).
- **LEARNING** is the process-wide registry (same stance as
  ``TRACER``/``REGISTRY``/``WATCHDOG``): keyed histories, a watchdog feed
  (``learning_rounds`` + ``learning_tasks`` items the
  ``anomalous_station`` / ``non_convergence`` / ``model_divergence``
  rules read), and the state behind the server's ``GET /api/rounds``.

This is the per-client signal substrate the FedBuff-style async
aggregation PR (ROADMAP item 2) will consume to accept/down-weight
updates — the exact per-client problem PAPERS.md's CLIP paper targets.

The port's copy of ``vantage6_tpu/runtime/learning.py``: numpy on the
host, the same records, summaries, series and spans. Two differences:
:meth:`RoundHistory.record_engine` takes the port engine's torch stats
(on the card or the CPU) and pulls each dispatch's stats to the host in
one copy; and the watchdog's ``learning`` feed is not registered (the port
has no watchdog yet), though :meth:`LearningRegistry.feed` is here.
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import OrderedDict, deque
from typing import Any

import numpy as np
import torch

from vantage6_tpu_torch.common.telemetry import REGISTRY
from vantage6_tpu_torch.runtime.tracing import TRACER

# how many recent round items each history contributes to the watchdog
# feed / API summaries; the anomalous-station window (default 8) and the
# non-convergence window (default 16) must both fit inside it
_FEED_ROUNDS = 24


def update_stats_host(
    flat: Any,
    weights: Any = None,
    mask: Any = None,
    ef: Any = None,
) -> dict[str, Any]:
    """Numpy twin of ``fed.collectives.station_update_stats`` for host
    planes (Federation device-mode aggregations, REST clients): same
    weighting/nan-isolation semantics, plain float outputs, no device
    dispatch. ``flat`` is the ``[S, N]`` per-station flat-pack."""
    x = np.asarray(flat, np.float32).reshape(len(flat), -1)
    s = x.shape[0]
    w = (
        np.ones((s,), np.float32)
        if weights is None
        else np.asarray(weights, np.float32)
    )
    if mask is not None:
        w = w * np.asarray(mask, np.float32)
    norms = np.sqrt(np.sum(x * x, axis=1))
    total = float(np.sum(w))
    denom = total if total > 0 else 1.0
    ww = w.reshape(-1, 1)
    safe = np.where(ww != 0, x, np.float32(0.0))
    pooled = np.sum(safe * ww, axis=0) / np.float32(denom)
    update_norm = float(np.sqrt(np.sum(pooled * pooled)))
    cos = (x @ pooled) / np.maximum(norms * update_norm, 1e-12)
    out: dict[str, Any] = {
        "station_norm": norms,
        "station_cos": cos,
        "update_norm": update_norm,
        "station_weight": w,
    }
    if ef is not None:
        e = np.asarray(ef, np.float32).reshape(s, -1)
        out["station_ef_norm"] = np.sqrt(np.sum(e * e, axis=1))
    return out


def stats_to_host(values: dict[str, Any]) -> dict[str, np.ndarray]:
    """The entries of ``values`` (tensors on one device, arrays, numbers
    or None) as numpy arrays, the tensors pulled to the host in ONE copy:
    flattened into one f32 vector (f64 when one of them is f64), copied,
    and split back. None entries are dropped, and numpy arrays are kept
    as they are: a dict this function returned passes through without a
    copy or a conversion."""
    tensors = {k: v.detach() for k, v in values.items()
               if isinstance(v, torch.Tensor)}
    out = {k: v if isinstance(v, np.ndarray) else np.asarray(v)
           for k, v in values.items() if v is not None and k not in tensors}
    if tensors:
        dtype = (torch.float64 if any(t.dtype == torch.float64
                                      for t in tensors.values())
                 else torch.float32)
        flat = torch.cat([t.reshape(-1).to(dtype)
                          for t in tensors.values()]).cpu().numpy()
        offset = 0
        for k, t in tensors.items():
            out[k] = flat[offset:offset + t.numel()].reshape(tuple(t.shape))
            offset += t.numel()
    return out


def _finite(v: Any) -> float:
    f = float(v)
    return f if math.isfinite(f) else 0.0


class RoundHistory:
    """Bounded per-task trajectory of learning-plane round records.

    One record per federated round: loss, global update norm, per-station
    norms/cosines (+ EF mass when compression is armed). ``rounds_total``
    and ``peak_norm`` survive ring eviction, so the convergence summary
    stays truthful for runs longer than the ring.
    """

    def __init__(self, key: Any, maxlen: int = 256):
        self.key = key
        # set by LearningRegistry.history(): lets record() reach the
        # registry's shared store (if one is attached) without a cycle at
        # construction time. Standalone histories never persist.
        self._registry: "LearningRegistry | None" = None
        self._lock = threading.Lock()
        self._records: deque[dict[str, Any]] = deque(  # guarded-by: _lock
            maxlen=max(8, maxlen)
        )
        # watchdog-feed round items, PREBUILT at record time: records are
        # immutable once stored, so rebuilding station dicts + medians on
        # every evaluation tick would be repeated wasted work
        self._feed_rounds: deque[dict[str, Any]] = deque(  # guarded-by: _lock
            maxlen=_FEED_ROUNDS
        )
        self.rounds_total = 0  # guarded-by: _lock (survives eviction)
        self.peak_norm = 0.0  # guarded-by: _lock
        self.first_norm: float | None = None  # guarded-by: _lock

    # ---------------------------------------------------------------- record
    def record(
        self,
        update_norm: float,
        station_norms: Any,
        station_cos: Any,
        loss: float | None = None,
        station_ef_norms: Any = None,
        station_weights: Any = None,
        round_index: int | None = None,
        ts: float | None = None,
        rounds_per_dispatch: int = 1,
    ) -> dict[str, Any]:
        """Record one round. Emits telemetry (``v6t_round_*`` /
        ``v6t_station_*``), a ``learning_round`` flight note, and a
        ``learning.round`` span on the ambient trace (no-op outside one).
        ``station_weights`` is the round's effective weight vector
        (``station_update_stats``'s ``station_weight``): a zero-weight
        station was masked out of the pooled update, and its (fictional,
        SPMD-computed) stats are recorded but EXCLUDED from the station
        gauges, the feed medians, and the anomaly evidence — an alert
        must never name a station the operator already dropped. Returns
        the stored record."""
        norms = [_finite(v) for v in np.asarray(station_norms).ravel()]
        cosines = [_finite(v) for v in np.asarray(station_cos).ravel()]
        efs = (
            None
            if station_ef_norms is None
            else [_finite(v) for v in np.asarray(station_ef_norms).ravel()]
        )
        weights = (
            None
            if station_weights is None
            else [_finite(v) for v in np.asarray(station_weights).ravel()]
        )
        participating = [
            weights is None or (s < len(weights) and weights[s] > 0)
            for s in range(len(norms))
        ]
        gnorm = _finite(update_norm)
        # shared-store path (N server replicas, docs/control_plane.md):
        # the round index is allocated ATOMICALLY from the learning_round
        # table, so round trajectories whose per-round subtasks land on
        # different replicas still interleave into one (task, round)-keyed
        # history instead of each replica counting 0,1,2... on its own
        store = (
            self._registry.store() if self._registry is not None else None
        )
        allocated: int | None = None
        if store is not None and round_index is None:
            try:
                allocated = store.allocate(self.key)
            except Exception:  # keep recording locally — store is additive
                allocated = None
        with self._lock:
            if round_index is not None:
                idx = int(round_index)
            elif allocated is not None:
                idx = allocated
            else:
                idx = self.rounds_total
            rec: dict[str, Any] = {
                "round": idx,
                "ts": float(ts) if ts is not None else time.time(),
                "loss": None if loss is None else _finite(loss),
                "update_norm": gnorm,
                "station_norms": norms,
                "station_cos": cosines,
            }
            if rounds_per_dispatch != 1:
                # this logical round arrived inside a fused K-round
                # dispatch (FedAvg.run_rounds) — K rounds, one host pull
                rec["rounds_per_dispatch"] = int(rounds_per_dispatch)
            if efs is not None:
                rec["station_ef_norms"] = efs
            if weights is not None:
                rec["station_weights"] = weights
            self._records.append(rec)
            self._feed_rounds.append(
                self._build_feed_item(rec, participating)
            )
            self.rounds_total += 1
            if self.first_norm is None:
                self.first_norm = gnorm
            self.peak_norm = max(self.peak_norm, gnorm)
            peak = self.peak_norm
        if store is not None:
            try:  # idempotent per (task, round): replays overwrite equal
                store.save(self.key, rec)
            except Exception:
                pass
        self._emit(rec, peak, participating)
        return rec

    def _build_feed_item(
        self, rec: dict[str, Any], participating: list[bool]
    ) -> dict[str, Any]:
        """One watchdog-feed round item, built once at record time (the
        record is immutable after). Medians and anomaly evidence cover
        PARTICIPATING stations only."""
        norms = rec["station_norms"]
        live_norms = [
            norms[s] for s in range(len(norms)) if participating[s]
        ]
        stations = [
            {
                "station": s,
                "norm": norms[s],
                "cos": rec["station_cos"][s]
                if s < len(rec["station_cos"]) else None,
                "participating": participating[s],
            }
            for s in range(len(norms))
        ]
        return {
            "task": self.key,
            "round": rec["round"],
            "ts": rec["ts"],
            "update_norm": rec["update_norm"],
            "median_norm": (
                float(np.median(live_norms)) if live_norms else 0.0
            ),
            "stations": stations,
        }

    def record_stats(
        self,
        stats: dict[str, Any],
        loss: float | None = None,
        round_index: int | None = None,
    ) -> dict[str, Any]:
        """Record one ``station_update_stats`` dict (device or host) —
        the shape the FedAvg engine and ``update_stats_host`` produce."""
        return self.record(
            update_norm=stats["update_norm"],
            station_norms=stats["station_norm"],
            station_cos=stats["station_cos"],
            station_ef_norms=stats.get("station_ef_norm"),
            station_weights=stats.get("station_weight"),
            loss=loss,
            round_index=round_index,
        )

    def record_engine(
        self, losses: Any, stats: dict[str, Any],
        start_round: int | None = None,
        rounds_per_dispatch: int | None = None,
    ) -> list[dict[str, Any]]:
        """Host-record a FedAvg ``round()`` (scalar stats) or
        ``run_rounds()`` (scan-stacked ``[n, ...]`` stats) result. Pulls
        the [S]-sized stat vectors to host in one copy — blocks on the
        device work; stats already pulled (numpy arrays, as
        :func:`stats_to_host` returns them) are taken as they are.
        ``rounds_per_dispatch`` attributes each logical round to its host
        dispatch (the fused program's K); by default it is inferred from
        the stacked stats — a run_rounds result of n rounds IS one
        n-round dispatch."""
        if not stats:
            return []
        host = stats_to_host({"losses": losses, **stats})
        gnorm = host["update_norm"]
        norms = host["station_norm"]
        cosines = host["station_cos"]
        efs = host.get("station_ef_norm")
        weights = host.get("station_weight")
        loss_arr = host.get("losses")
        with self._lock:
            base = self.rounds_total if start_round is None else start_round
        if gnorm.ndim == 0:  # a single round()
            return [self.record(
                update_norm=gnorm,
                station_norms=norms,
                station_cos=cosines,
                station_ef_norms=efs,
                station_weights=weights,
                loss=None if loss_arr is None else loss_arr,
                round_index=base,
                rounds_per_dispatch=(
                    1 if rounds_per_dispatch is None
                    else int(rounds_per_dispatch)
                ),
            )]
        rpd = (
            int(gnorm.shape[0]) if rounds_per_dispatch is None
            else int(rounds_per_dispatch)
        )
        return [
            self.record(
                update_norm=gnorm[r],
                station_norms=norms[r],
                station_cos=cosines[r],
                station_ef_norms=None if efs is None else efs[r],
                station_weights=None if weights is None else weights[r],
                loss=None if loss_arr is None else loss_arr[r],
                round_index=base + r,
                rounds_per_dispatch=rpd,
            )
            for r in range(gnorm.shape[0])
        ]

    def _emit(
        self, rec: dict[str, Any], peak: float, participating: list[bool]
    ) -> None:
        REGISTRY.counter("v6t_round_updates_total").inc()
        REGISTRY.gauge("v6t_round_update_norm").set(rec["update_norm"])
        if rec["loss"] is not None:
            REGISTRY.gauge("v6t_round_loss").set(rec["loss"])
        # <= 1 while the norm shrinks below its peak; 1.0 = stalled at (or
        # returned to) the peak — the non_convergence rule's quick gauge
        REGISTRY.gauge("v6t_round_norm_decay").set(
            rec["update_norm"] / peak if peak > 0 else 1.0
        )
        # the station gauges summarize PARTICIPATING stations only — a
        # masked-out station's fictional stats must not pin cos_min
        live = [s for s in range(len(rec["station_norms"]))
                if participating[s]]
        if live:
            REGISTRY.gauge("v6t_station_update_norm_max").set(
                max(rec["station_norms"][s] for s in live)
            )
        live_cos = [s for s in live if s < len(rec["station_cos"])]
        if live_cos:
            REGISTRY.gauge("v6t_station_cos_min").set(
                min(rec["station_cos"][s] for s in live_cos)
            )
        efs = rec.get("station_ef_norms")
        if efs:
            live_ef = [s for s in live if s < len(efs)]
            if live_ef:
                REGISTRY.gauge("v6t_station_ef_norm_max").set(
                    max(efs[s] for s in live_ef)
                )
        attrs: dict[str, Any] = {
            "task": self.key,
            "round": rec["round"],
            "update_norm": rec["update_norm"],
            "n_stations": len(rec["station_norms"]),
        }
        if rec["loss"] is not None:
            attrs["loss"] = rec["loss"]
        if live_cos:
            worst = min(live_cos, key=rec["station_cos"].__getitem__)
            attrs["min_cos"] = rec["station_cos"][worst]
            attrs["min_cos_station"] = worst
        # the span is how the learning stats land INSIDE the round's own
        # distributed trace (require_parent: an untraced training loop
        # must not mint a root trace per round)
        with TRACER.span(
            "learning.round", kind="learning", service="learning",
            attrs=attrs, require_parent=True,
        ) as sp:
            sp.add_event("round_recorded", round=rec["round"])
        from vantage6_tpu_torch.common.flight import FLIGHT

        FLIGHT.note("learning_round", task=self.key, **{
            k: v for k, v in rec.items() if k != "ts"
        })

    # --------------------------------------------------------------- queries
    def rounds(self, limit: int | None = None) -> list[dict[str, Any]]:
        with self._lock:
            out = list(self._records)
        return out[-limit:] if limit else out

    def summary(self) -> dict[str, Any]:
        """Convergence view: first/last/peak norm, overall decay, and a
        per-station contribution table (mean norm/cos, min cos) over the
        retained window — what the doctor's learning digest renders."""
        with self._lock:
            recs = list(self._records)
            total = self.rounds_total
            peak = self.peak_norm
            first = self.first_norm
        if not recs:
            return {"task": self.key, "rounds": 0}
        last = recs[-1]
        decay_pct = (
            100.0 * (1.0 - last["update_norm"] / first)
            if first else None
        )
        n_stations = len(last["station_norms"])
        stations = []
        for s in range(n_stations):
            norms = [
                r["station_norms"][s] for r in recs
                if s < len(r["station_norms"])
            ]
            cosines = [
                r["station_cos"][s] for r in recs
                if s < len(r["station_cos"])
            ]
            stations.append({
                "station": s,
                "mean_norm": sum(norms) / len(norms) if norms else None,
                "mean_cos": sum(cosines) / len(cosines) if cosines else None,
                "min_cos": min(cosines) if cosines else None,
            })
        return {
            "task": self.key,
            "rounds": total,
            "first_update_norm": first,
            "last_update_norm": last["update_norm"],
            "peak_update_norm": peak,
            "decay_pct": None if decay_pct is None else round(decay_pct, 2),
            "last_loss": last["loss"],
            "last_round": last["round"],
            "stations": stations,
        }

    # ------------------------------------------------------------ checkpoint
    def state_arrays(self) -> dict[str, Any]:
        """Array-packed state for checkpoints
        (``runtime.checkpoint.TrainState.history``): the retained records
        as dense numpy arrays plus the eviction-surviving scalars. Only
        records matching the newest record's station count are packed —
        a reshaped federation starts a fresh trajectory."""
        with self._lock:
            recs = list(self._records)
            total = self.rounds_total
            peak = self.peak_norm
            first = self.first_norm
        if recs:
            s = len(recs[-1]["station_norms"])
            recs = [r for r in recs if len(r["station_norms"]) == s]
        has_ef = bool(recs) and all(
            r.get("station_ef_norms") is not None for r in recs
        )
        has_w = bool(recs) and all(
            r.get("station_weights") is not None for r in recs
        )
        out: dict[str, Any] = {
            "round_index": np.asarray(
                [r["round"] for r in recs], np.int64
            ),
            "ts": np.asarray([r["ts"] for r in recs], np.float64),
            "loss": np.asarray(
                [math.nan if r["loss"] is None else r["loss"] for r in recs],
                np.float64,
            ),
            "update_norm": np.asarray(
                [r["update_norm"] for r in recs], np.float64
            ),
            "station_norms": np.asarray(
                [r["station_norms"] for r in recs], np.float32
            ),
            "station_cos": np.asarray(
                [r["station_cos"] for r in recs], np.float32
            ),
            "rounds_total": np.asarray(total, np.int64),
            "peak_norm": np.asarray(peak, np.float64),
            "first_norm": np.asarray(
                math.nan if first is None else first, np.float64
            ),
        }
        if has_ef:
            out["station_ef_norms"] = np.asarray(
                [r["station_ef_norms"] for r in recs], np.float32
            )
        if has_w:
            out["station_weights"] = np.asarray(
                [r["station_weights"] for r in recs], np.float32
            )
        return out

    def load_state(self, state: dict[str, Any]) -> "RoundHistory":
        """Restore from :meth:`state_arrays` — the records re-populate and
        the telemetry gauges re-anchor to the LAST restored round (no
        counter increments, no spans/notes: a restore is not new rounds),
        so the norm-decay trajectory continues instead of restarting and
        the trend rules see no spurious step."""
        rounds = np.asarray(state["round_index"])
        efs = state.get("station_ef_norms")
        wts = state.get("station_weights")
        recs = []
        for i in range(rounds.shape[0]):
            loss = float(np.asarray(state["loss"])[i])
            rec: dict[str, Any] = {
                "round": int(rounds[i]),
                "ts": float(np.asarray(state["ts"])[i]),
                "loss": None if math.isnan(loss) else loss,
                "update_norm": float(np.asarray(state["update_norm"])[i]),
                "station_norms": [
                    float(v) for v in np.asarray(state["station_norms"])[i]
                ],
                "station_cos": [
                    float(v) for v in np.asarray(state["station_cos"])[i]
                ],
            }
            if efs is not None:
                rec["station_ef_norms"] = [
                    float(v) for v in np.asarray(efs)[i]
                ]
            if wts is not None:
                rec["station_weights"] = [
                    float(v) for v in np.asarray(wts)[i]
                ]
            recs.append(rec)
        first = float(np.asarray(state["first_norm"]))
        with self._lock:
            self._records.clear()
            self._records.extend(recs)
            # rebuild the prebuilt feed cache for the restored tail, so
            # the rules' evidence window is continuous across the resume
            self._feed_rounds.clear()
            for rec in recs[-_FEED_ROUNDS:]:
                w = rec.get("station_weights")
                participating = [
                    w is None or (s < len(w) and w[s] > 0)
                    for s in range(len(rec["station_norms"]))
                ]
                self._feed_rounds.append(
                    self._build_feed_item(rec, participating)
                )
            self.rounds_total = int(np.asarray(state["rounds_total"]))
            self.peak_norm = float(np.asarray(state["peak_norm"]))
            self.first_norm = None if math.isnan(first) else first
            peak = self.peak_norm
        if recs:
            last = recs[-1]
            REGISTRY.gauge("v6t_round_update_norm").set(last["update_norm"])
            REGISTRY.gauge("v6t_round_norm_decay").set(
                last["update_norm"] / peak if peak > 0 else 1.0
            )
            if last["loss"] is not None:
                REGISTRY.gauge("v6t_round_loss").set(last["loss"])
        return self

    # ---------------------------------------------------------- watchdog feed
    def feed_items(self) -> tuple[list[dict[str, Any]], dict[str, Any]]:
        """(recent round items, one task item) for the watchdog feed.
        Round items are the PREBUILT cache (one dict per record, built at
        record time — immutable, so every evaluation tick reuses them
        instead of rebuilding station dicts + medians)."""
        with self._lock:
            round_items = list(self._feed_rounds)
            total = self.rounds_total
            peak = self.peak_norm
        task_item = {
            "task": self.key,
            "rounds": total,
            "peak_norm": peak,
            "recent_norms": [r["update_norm"] for r in round_items],
        }
        return round_items, task_item


class LearningStore:
    """(task, round)-keyed persistence over a shared storage backend.

    Backed by the ``learning_round`` table (server migration v7); ``db``
    is duck-typed (``execute``/``query`` with a rowcount/lastrowid-bearing
    cursor) so this module never imports sqlite3 or the server's backend
    directly. Round allocation is one atomic INSERT..SELECT MAX+1 — two
    replicas recording concurrently get DISTINCT round indices for the
    same task, which is the whole point."""

    def __init__(self, db: Any):
        self.db = db

    def allocate(self, key: Any) -> int:
        """Claim the next round index for ``key`` (atomic, cross-replica)."""
        cur = self.db.execute(
            "INSERT INTO learning_round (task_key, round, data, ts) "
            "SELECT ?, COALESCE(MAX(round) + 1, 0), '{}', ? "
            "FROM learning_round WHERE task_key = ?",
            [str(key), time.time(), str(key)],
        )
        row = self.db.query(
            "SELECT round FROM learning_round WHERE rowid = ?",
            [cur.lastrowid],
        )
        return int(row[0]["round"])

    def save(self, key: Any, rec: dict[str, Any]) -> None:
        self.db.execute(
            "INSERT OR REPLACE INTO learning_round "
            "(task_key, round, data, ts) VALUES (?, ?, ?, ?)",
            [str(key), int(rec["round"]), json.dumps(rec),
             rec.get("ts") or time.time()],
        )

    def load(self, key: Any) -> list[dict[str, Any]]:
        """Every recorded round for ``key``, ordered. Unfilled allocation
        placeholders ('{}') are skipped — an allocate whose record never
        landed (crashed replica) leaves a gap, not a phantom round."""
        return [
            json.loads(r["data"])
            for r in self.db.query(
                "SELECT data FROM learning_round "
                "WHERE task_key = ? AND data != '{}' ORDER BY round",
                [str(key)],
            )
        ]

    def task_keys(self) -> list[Any]:
        out: list[Any] = []
        for r in self.db.query(
            "SELECT DISTINCT task_key FROM learning_round ORDER BY task_key"
        ):
            k = r["task_key"]
            try:
                out.append(int(k))
            except ValueError:
                out.append(k)
        return out


def history_from_rounds(key: Any, recs: list[dict[str, Any]]) -> RoundHistory:
    """Rebuild a RoundHistory from persisted round records (no telemetry
    or span re-emission — the recording replica already emitted them)."""
    hist = RoundHistory(key, maxlen=max(8, len(recs)))
    for rec in recs:
        norms = rec.get("station_norms") or []
        weights = rec.get("station_weights")
        participating = [
            weights is None or (s < len(weights) and weights[s] > 0)
            for s in range(len(norms))
        ]
        gnorm = float(rec.get("update_norm") or 0.0)
        with hist._lock:
            hist._records.append(rec)
            hist._feed_rounds.append(
                hist._build_feed_item(rec, participating)
            )
            hist.rounds_total += 1
            if hist.first_norm is None:
                hist.first_norm = gnorm
            hist.peak_norm = max(hist.peak_norm, gnorm)
    return hist


class LearningRegistry:
    """Keyed RoundHistory registry (process-wide singleton ``LEARNING``).

    Keys are task ids (ints on the server path) or caller-chosen strings
    (engine runs). Bounded FIFO: a long-lived server tracking thousands
    of tasks keeps the newest ``max_histories``.

    With a shared store attached (`attach_store` — a server over a
    ``sqlite+wal`` backend does this), every record also persists keyed
    (task, round) and the read paths (`merged`, `summaries`) serve the
    UNION of this process's records and every other replica's.
    """

    def __init__(self, max_histories: int = 512):
        self._lock = threading.Lock()
        self._histories: "OrderedDict[Any, RoundHistory]" = (
            OrderedDict()
        )  # guarded-by: _lock
        self.max_histories = max(8, max_histories)
        self._store: LearningStore | None = None  # guarded-by: _lock

    # -------------------------------------------------------- shared store
    def attach_store(self, store: LearningStore) -> None:
        """Route future records through a shared (task, round) store and
        serve reads merged with it (see class docstring)."""
        with self._lock:
            self._store = store

    def detach_store(self, store: LearningStore | None = None) -> None:
        """Drop the store — but only if it is still OURS (identity check):
        with two in-process replicas the second attach replaced the
        first's store, and the first replica's close must not yank the
        survivor's persistence out from under it."""
        with self._lock:
            if store is None or self._store is store:
                self._store = None

    def store(self) -> LearningStore | None:
        with self._lock:
            return self._store

    def merged(self, key: Any) -> RoundHistory | None:
        """The FULL history for ``key``: the shared store's view when one
        is attached and has records (covers rounds recorded by other
        replicas), this process's in-memory history otherwise."""
        store = self.store()
        if store is not None:
            try:
                recs = store.load(key)
            except Exception:
                recs = []
            if recs:
                return history_from_rounds(key, recs)
        return self.get(key)

    def history(self, key: Any, maxlen: int = 256) -> RoundHistory:
        """Get-or-create the history for ``key``."""
        with self._lock:
            hist = self._histories.get(key)
            if hist is None:
                hist = self._histories[key] = RoundHistory(
                    key, maxlen=maxlen
                )
                hist._registry = self
                while len(self._histories) > self.max_histories:
                    self._histories.popitem(last=False)
            return hist

    def get(self, key: Any) -> RoundHistory | None:
        with self._lock:
            return self._histories.get(key)

    def keys(self) -> list[Any]:
        with self._lock:
            return list(self._histories)

    def summaries(self) -> list[dict[str, Any]]:
        store = self.store()
        with self._lock:
            hists = OrderedDict(self._histories)
        if store is not None:
            # the union of every replica's tasks, each served from the
            # merged view — a task whose rounds landed on another replica
            # still shows its full trajectory here
            try:
                store_keys = store.task_keys()
            except Exception:
                store_keys = []
            for key in store_keys:
                merged = self.merged(key)
                if merged is not None:
                    hists[key] = merged
        return [h.summary() for h in hists.values()]

    def clear(self) -> None:
        with self._lock:
            self._histories.clear()

    def feed(self) -> dict[str, Any]:
        """The watchdog's learning-plane feed: recent round items across
        every tracked history (``learning_rounds`` — the
        ``anomalous_station`` rule's evidence) plus one per-task
        convergence item (``learning_tasks`` — ``non_convergence`` /
        ``model_divergence``). Fail-soft by construction: pure reads of
        bounded state."""
        with self._lock:
            hists = list(self._histories.values())
        rounds: list[dict[str, Any]] = []
        tasks: list[dict[str, Any]] = []
        for h in hists:
            r, t = h.feed_items()
            rounds.extend(r)
            tasks.append(t)
        rounds.sort(key=lambda r: r.get("ts") or 0.0)
        return {"learning_rounds": rounds, "learning_tasks": tasks}


LEARNING = LearningRegistry()
