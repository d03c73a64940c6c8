"""Device performance observatory: signature/retrace telemetry, CUDA-graph
capture events, engine-cache counters, device memory and on-demand
profiling windows.

Counterpart of ``vantage6_tpu/runtime/profiling.py``, with the same public
surface (``observed_jit``, ``ObservedFunction``, ``DEVICE_OBS``,
``engine_cache_event``, ``RunnerCache``, ``profile_window``,
``ProfileBusyError``), span names (``device.compile``,
``device.profile``), flight-note kinds (``retrace``, ``profile_window``)
and ``v6t_jit_*`` / ``v6t_engine_cache_*`` / ``v6t_device_mem_*`` series,
so the reference's dashboards and ``tools/`` readers read both packages.

**What a compile is here.** Eager PyTorch compiles nothing per call, so
the port's one compile event is the fused runner's CUDA-graph capture
(``fed.fedavg``): the engine captures one round per input signature and
replays it. Each runner built through a :class:`CaptureCache` is one
``device.compile`` span carrying its warm-up and capture seconds
(``warmup_ms``, ``capture_ms``) and the device memory it took
(``capture_allocated_bytes``/``capture_reserved_bytes``: the
``torch.cuda.memory_allocated``/``memory_reserved`` growth across the
build, i.e. the runner's static buffers and the graph's private pool),
counted in ``v6t_jit_compiles_total``, ``v6t_jit_lower_seconds_total``
(warm-up) and ``v6t_jit_compile_seconds_total`` (capture). On the CPU the
runner is built without a capture: the span is recorded without seconds
or memory. JAX's ``cost_analysis``/``memory_analysis`` have no eager
counterpart, so the span carries no flops or temp/argument/output bytes
and ``v6t_jit_compile_temp_bytes``/``v6t_jit_compile_flops`` are never
set.

**Signatures and retraces.** An :class:`ObservedFunction` keys each call
on its abstract signature: the shape, dtype and device of each tensor
leaf, the shape and dtype of each numpy leaf, the type of each other leaf
(a Python scalar, a ``torch.Generator`` with its device), the tree
structure, and the values of the statics, as the JAX package keys on its
avals. Every call is a counted dispatch. A call with a signature the
function has never seen, on a function that has seen one, is a *retrace*:
counted, named (the first differing leaf, shape before -> after) in a
flight-recorder note of kind ``retrace`` and in :meth:`DeviceObservatory.
recent_retraces`, and carried on the ``device.compile`` span of any
capture the call makes. A miss that differs from a seen signature only in
a declared sweep static (the fused runs' ``n_rounds``) is a static sweep,
and a signature seen before but dropped from the bounded registry is an
``evicted_recompile``; neither is a retrace. A runner that the
:class:`CaptureCache` evicted and that is captured again is marked
``evicted_recompile`` on its span, and each eviction counts in
``v6t_jit_cache_evictions_total``.

``v6t_jit_fallbacks_total`` stays 0: the JAX package falls back to the
plain jitted callable when its ahead-of-time path cannot express a call,
and the port has no such second path (an observed function always calls
the function itself).

**Port only.** :func:`profile_window` takes a keyword ``run=``: a
callable the window covers exactly, once, in place of sleeping (the JAX
window samples whatever other threads do for ``seconds``), and it
returns the Chrome trace's path as ``"trace"`` beside the reference's
keys; :func:`trace_kernel_events` counts the device kernels in such a
trace. The JAX package has neither.

Not ported yet: the watchdog's ``device_plane`` feed registration (the
port has no watchdog); :meth:`DeviceObservatory.watchdog_feed` itself is
here. Disable the layer with ``V6T_DEVICE_OBS=0`` (calls forward
untouched).
"""
from __future__ import annotations

import contextlib
import inspect
import json
import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Callable, Iterator

import numpy as np
import torch

from vantage6_tpu_torch.common.env import env_int
from vantage6_tpu_torch.common.telemetry import REGISTRY
from vantage6_tpu_torch.runtime.tracing import TRACER

__all__ = [
    "DEVICE_OBS",
    "CaptureCache",
    "ObservedFunction",
    "ProfileBusyError",
    "RunnerCache",
    "engine_cache_event",
    "observed_jit",
    "profile_window",
]

# keys only, per function: how far back an evicted signature is still
# recognised as one seen before
_SEEN_MAX = 1024


# ------------------------------------------------------------- signatures
def _abstract_leaf(leaf: Any) -> tuple:
    """Hashable abstract signature of one leaf (module doc)."""
    if isinstance(leaf, torch.Tensor):
        return ("tensor", tuple(leaf.shape), str(leaf.dtype).replace(
            "torch.", ""), str(leaf.device))
    if isinstance(leaf, np.ndarray):
        return ("ndarray", leaf.shape, str(leaf.dtype))
    if isinstance(leaf, (bool, int, float, complex)):
        return ("scalar", type(leaf).__name__)
    if isinstance(leaf, torch.Generator):
        return ("generator", str(leaf.device))
    return ("opaque", type(leaf).__name__)


def _abstract(tree: Any, path: str, paths: list[str],
              avals: list[tuple]) -> Any:
    """The structure of ``tree`` (hashable), appending each leaf's path
    (written as ``jax.tree_util.keystr`` writes it) and abstract
    signature. Dict keys are visited sorted, as ``jax.tree.flatten``
    visits them."""
    if isinstance(tree, dict):
        try:
            keys = sorted(tree)
        except TypeError:
            keys = list(tree)
        return ("dict", tuple(
            (k, _abstract(tree[k], f"{path}[{k!r}]", paths, avals))
            for k in keys))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(
            _abstract(x, f"{path}[{i}]", paths, avals)
            for i, x in enumerate(tree)))
    if tree is None:
        return None
    paths.append(path)
    avals.append(_abstract_leaf(tree))
    return "*"


def _leaf_str(aval: tuple, device: bool = False) -> str:
    """``float32[8,4]`` for a tensor or array leaf (``@cuda:0`` appended
    with ``device``), the type tag otherwise."""
    kind = aval[0]
    if kind in ("tensor", "ndarray"):
        s = f"{aval[2]}[{','.join(str(d) for d in aval[1])}]"
        return f"{s}@{aval[3]}" if device and kind == "tensor" else s
    return f"{kind}:{aval[1]}"


def _signature_diff(
    old_avals: tuple, new_paths: list[str], new_avals: tuple,
    old_statics: tuple = (), new_statics: tuple = (),
) -> str:
    """Name what changed between two abstract signatures: the one string
    an operator needs to find the shape-perturbing call site."""
    if len(old_avals) != len(new_avals):
        return f"arity changed: {len(old_avals)} -> {len(new_avals)} leaves"
    for path, a, b in zip(new_paths, old_avals, new_avals):
        if a != b:
            dev = _leaf_str(a) == _leaf_str(b)
            return (f"{path or 'arg'}: {_leaf_str(a, dev)} -> "
                    f"{_leaf_str(b, dev)}")
    olds = dict(old_statics)
    for k, v in new_statics:
        if k not in olds:
            return f"static {k} added: {v!r}"
        if olds[k] != v:
            return f"static {k}: {olds[k]!r} -> {v!r}"
    return "signature changed (tree structure)"


def _hashable(v: Any) -> Any:
    try:
        hash(v)
        return v
    except TypeError:
        return ("repr", repr(v))


class ObservedFunction:
    """One entry point under observation (module doc): counts dispatches,
    signatures, retraces and static sweeps, and attributes the captures
    its calls make. Statics follow jit's contract (``static_argnums``
    positionally, ``static_argnames`` by keyword): their values join the
    signature. A bound method is held weakly, so an engine that stores
    its own observed methods makes no reference cycle."""

    def __init__(
        self,
        name: str,
        fun: Callable[..., Any],
        *,
        static_argnums: tuple[int, ...] = (),
        static_argnames: tuple[str, ...] = (),
        sweep_statics: tuple[str, ...] = (),
    ):
        self.name = name
        if inspect.ismethod(fun):
            self._fun_ref = weakref.WeakMethod(fun)
        else:
            self._fun_ref = lambda: fun
        self._static_argnums = tuple(static_argnums)
        self._static_argnames = tuple(static_argnames)
        # statics a caller legitimately SWEEPS (the fused runs' n_rounds):
        # a new signature that differs from a seen one only in these is a
        # static sweep, not a retrace
        self._sweep_statics = frozenset(sweep_statics)
        self._lock = threading.Lock()
        # guarded-by: _lock — live signatures, insertion-ordered (FIFO)
        self._sigs: "OrderedDict[tuple, None]" = OrderedDict()
        # guarded-by: _lock — every signature ever seen (bounded, keys
        # only): a true retrace is a signature never seen
        self._seen_sigs: "OrderedDict[tuple, None]" = OrderedDict()
        # guarded-by: _lock — seen signatures with the sweep statics removed
        self._seen_swept: "OrderedDict[tuple, None]" = OrderedDict()
        self._last_sig: tuple | None = None
        self._last_avals: tuple = ()
        self._last_statics: tuple = ()
        self.compiles = 0
        self.retraces = 0
        self.static_sweeps = 0
        self.dispatches = 0
        self.fallbacks = 0
        self.evictions = 0
        self.last_compile: dict[str, Any] = {}

    def _fun(self) -> Callable[..., Any]:
        fun = self._fun_ref()
        if fun is None:
            raise ReferenceError(
                f"{self.name}: the object that owns this function is gone")
        return fun

    def _split(self, args: tuple, kwargs: dict) -> tuple[tuple, dict, tuple]:
        """(dynamic args, dynamic kwargs, hashable statics key)."""
        statics: list[tuple[str, Any]] = []
        dyn_args = []
        for i, a in enumerate(args):
            if i in self._static_argnums:
                statics.append((f"arg{i}", _hashable(a)))
            else:
                dyn_args.append(a)
        dyn_kwargs = {}
        for k, v in kwargs.items():
            if k in self._static_argnames:
                statics.append((k, _hashable(v)))
            else:
                dyn_kwargs[k] = v
        return tuple(dyn_args), dyn_kwargs, tuple(sorted(
            statics, key=lambda kv: kv[0]))

    def _swept_key(self, key: tuple) -> tuple | None:
        if not self._sweep_statics:
            return None
        reduced = tuple(kv for kv in key[2]
                        if kv[0] not in self._sweep_statics)
        if reduced == key[2]:
            return None
        return (key[0], key[1], reduced)

    # ------------------------------------------------------------ dispatch
    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        obs = DEVICE_OBS
        if not obs.enabled:
            return self._fun()(*args, **kwargs)
        dyn_args, dyn_kwargs, statics = self._split(args, kwargs)
        paths: list[str] = []
        avals: list[tuple] = []
        struct = _abstract((dyn_args, dyn_kwargs), "", paths, avals)
        key = (tuple(avals), struct, statics)
        self.dispatches += 1
        REGISTRY.counter("v6t_jit_dispatches_total").inc()
        with self._lock:
            known = key in self._sigs
        attrs = None if known else self._new_signature(key, paths)
        with obs._call(self, attrs):
            return self._fun()(*args, **kwargs)

    def _new_signature(self, key: tuple, paths: list[str]) -> dict[str, Any]:
        """Register a signature this function does not hold: classify it
        (retrace, static sweep, evicted), name what changed, count it.
        Returns the attributes a capture made by this call carries."""
        swept_key = self._swept_key(key)
        with self._lock:
            warm = bool(self._sigs) or self._last_sig is not None
            seen_before = key in self._seen_sigs
            swept_before = (swept_key is not None
                            and swept_key in self._seen_swept)
            old_avals, old_statics = self._last_avals, self._last_statics
        retrace = warm and not seen_before
        static_sweep = retrace and swept_before
        if static_sweep:
            retrace = False
        changed = (
            _signature_diff(old_avals, paths, key[0], old_statics, key[2])
            if (retrace or static_sweep) else None
        )
        attrs: dict[str, Any] = {"retrace": retrace}
        if static_sweep:
            attrs["static_sweep"] = True
        if seen_before:
            attrs["evicted_recompile"] = True
        if changed:
            attrs["changed"] = changed
        if retrace:
            self.retraces += 1
            REGISTRY.counter("v6t_jit_retraces_total").inc()
            DEVICE_OBS.record_retrace(self.name, changed or "?")
        if static_sweep:
            self.static_sweeps += 1
            REGISTRY.counter("v6t_jit_static_sweeps_total").inc()
        with self._lock:
            self._sigs[key] = None
            self._seen_sigs[key] = None
            self._seen_sigs.move_to_end(key)
            while len(self._seen_sigs) > _SEEN_MAX:
                self._seen_sigs.popitem(last=False)
            if swept_key is not None:
                self._seen_swept[swept_key] = None
                self._seen_swept.move_to_end(swept_key)
                while len(self._seen_swept) > _SEEN_MAX:
                    self._seen_swept.popitem(last=False)
            self._last_sig = key
            self._last_avals, self._last_statics = key[0], key[2]
            while len(self._sigs) > DEVICE_OBS.max_signatures:
                self._sigs.popitem(last=False)
        return attrs

    # ------------------------------------------------------------- queries
    def n_signatures(self) -> int:
        with self._lock:
            return len(self._sigs)

    def clear(self) -> None:
        with self._lock:
            self._sigs.clear()
            self._seen_sigs.clear()
            self._seen_swept.clear()
            self._last_sig = None
            self._last_avals, self._last_statics = (), ()

    def stats(self) -> dict[str, Any]:
        return {
            "function": self.name,
            "signatures": self.n_signatures(),
            "compiles": self.compiles,
            "retraces": self.retraces,
            "static_sweeps": self.static_sweeps,
            "dispatches": self.dispatches,
            "fallbacks": self.fallbacks,
            "evictions": self.evictions,
            "last_compile": dict(self.last_compile),
        }


class _Call:
    """One observed call in progress: its function and, when its
    signature was new, the attributes a capture it makes carries."""

    __slots__ = ("fn", "attrs")

    def __init__(self, fn: ObservedFunction, attrs: dict[str, Any] | None):
        self.fn = fn
        self.attrs = attrs


def _device_memory(device: Any) -> tuple[int, int] | None:
    """(allocated, reserved) bytes on a CUDA ``device``; None elsewhere."""
    if device is None or torch.device(device).type != "cuda":
        return None
    return (int(torch.cuda.memory_allocated(device)),
            int(torch.cuda.memory_reserved(device)))


class DeviceObservatory:
    """Process-wide registry of observed functions + the device-plane
    state tools read. Env knobs (read once; ``configure()`` overrides
    live): ``V6T_DEVICE_OBS=0`` disables, ``V6T_DEVICE_OBS_SIGS`` caps the
    live signatures each function registers."""

    def __init__(self):
        self._lock = threading.Lock()
        # weak refs: an observed function lives as long as its owner (an
        # engine's self._run); a set, so two live engines sharing a name
        # are both tracked
        self._functions: "weakref.WeakSet[ObservedFunction]" = \
            weakref.WeakSet()
        self._retraces: deque[dict[str, Any]] = deque(maxlen=64)
        self._engine_caches: dict[str, dict[str, int]] = {}
        self._tls = threading.local()
        self.enabled = os.environ.get("V6T_DEVICE_OBS", "1") != "0"
        self.max_signatures = max(1, env_int("V6T_DEVICE_OBS_SIGS", 32))

    def configure(
        self, enabled: bool | None = None, max_signatures: int | None = None
    ) -> "DeviceObservatory":
        if enabled is not None:
            self.enabled = bool(enabled)
        if max_signatures is not None:
            self.max_signatures = max(1, int(max_signatures))
        return self

    # ------------------------------------------------------------ registry
    def register(self, fn: ObservedFunction) -> ObservedFunction:
        with self._lock:
            self._functions.add(fn)
        return fn

    def functions(self) -> list[ObservedFunction]:
        with self._lock:
            return list(self._functions)

    def record_retrace(self, function: str, changed: str) -> None:
        rec = {"ts": time.time(), "function": function, "changed": changed}
        with self._lock:
            self._retraces.append(rec)
        from vantage6_tpu_torch.common.flight import FLIGHT

        FLIGHT.note("retrace", function=function, changed=changed)

    def recent_retraces(self, limit: int = 16) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._retraces)[-limit:]

    # ------------------------------------------------------ call context
    @contextlib.contextmanager
    def _call(self, fn: ObservedFunction,
              attrs: dict[str, Any] | None) -> Iterator[None]:
        stack = getattr(self._tls, "calls", None)
        if stack is None:
            stack = self._tls.calls = []
        stack.append(_Call(fn, attrs))
        try:
            yield
        finally:
            stack.pop()

    def current_call(self) -> _Call | None:
        """The innermost observed call on this thread, or None."""
        stack = getattr(self._tls, "calls", None)
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def compile_event(
        self, function: str | None = None, evicted_recompile: bool = False,
        device: Any = None,
    ) -> Iterator[dict[str, Any]]:
        """One compile event of the port (module doc): a ``device.compile``
        span around the body, attributed to the observed call in progress
        (its name, and its retrace/sweep attributes when its signature is
        new). The body fills the yielded dict with ``warmup_s`` and
        ``capture_s`` when it captured; the device memory taken across the
        body is measured on a CUDA ``device``."""
        call = self.current_call() if self.enabled else None
        attrs: dict[str, Any] = {
            "function": function or (call.fn.name if call else "?"),
            "retrace": False,
        }
        if call is not None and call.attrs:
            attrs.update(call.attrs)
        if evicted_recompile:
            attrs["evicted_recompile"] = True
            attrs["retrace"] = False
        mem0 = _device_memory(device)
        seconds: dict[str, Any] = {}
        with TRACER.span("device.compile", kind="device", attrs=attrs) as sp:
            yield seconds
            extra: dict[str, Any] = {}
            if "warmup_s" in seconds:
                extra["warmup_ms"] = round(seconds["warmup_s"] * 1e3, 3)
            if "capture_s" in seconds:
                extra["capture_ms"] = round(seconds["capture_s"] * 1e3, 3)
            mem1 = _device_memory(device)
            if mem0 is not None and mem1 is not None:
                extra["capture_allocated_bytes"] = mem1[0] - mem0[0]
                extra["capture_reserved_bytes"] = mem1[1] - mem0[1]
            sp.set_attr(**extra)
        REGISTRY.counter("v6t_jit_compiles_total").inc()
        REGISTRY.counter("v6t_jit_lower_seconds_total").inc(
            seconds.get("warmup_s", 0.0))
        REGISTRY.counter("v6t_jit_compile_seconds_total").inc(
            seconds.get("capture_s", 0.0))
        if call is not None:
            call.fn.compiles += 1
            call.fn.last_compile = {"ts": time.time(), **attrs, **extra}

    def record_eviction(self) -> None:
        """A captured runner evicted from a bounded cache."""
        REGISTRY.counter("v6t_jit_cache_evictions_total").inc()
        call = self.current_call()
        if call is not None:
            call.fn.evictions += 1

    # -------------------------------------------------------- engine caches
    def engine_cache_event(
        self, cache: str, hit: bool, entries: int | None = None
    ) -> None:
        """One lookup against a keyed runner cache: counted process-wide
        AND per cache."""
        if not self.enabled:
            return
        with self._lock:
            st = self._engine_caches.setdefault(
                cache, {"hits": 0, "misses": 0, "entries": 0}
            )
            st["hits" if hit else "misses"] += 1
            if entries is not None:
                st["entries"] = int(entries)
            total_entries = sum(
                c["entries"] for c in self._engine_caches.values()
            )
        REGISTRY.counter(
            "v6t_engine_cache_hits_total" if hit
            else "v6t_engine_cache_misses_total"
        ).inc()
        REGISTRY.gauge("v6t_engine_cache_entries").set(total_entries)

    def engine_cache_stats(self) -> dict[str, dict[str, int]]:
        with self._lock:
            return {k: dict(v) for k, v in self._engine_caches.items()}

    # --------------------------------------------------------------- output
    def stats(self) -> dict[str, Any]:
        return {
            "enabled": self.enabled,
            "functions": [f.stats() for f in self.functions()],
            "engine_caches": self.engine_cache_stats(),
            "recent_retraces": self.recent_retraces(),
        }

    def clear(self) -> None:
        """Forget the signatures and the retrace/engine-cache history (test
        isolation; captured runners stay with their engines)."""
        for fn in self.functions():
            fn.clear()
        with self._lock:
            self._retraces.clear()
            self._engine_caches.clear()

    def watchdog_feed(self) -> dict[str, Any]:
        """The ``recompile_storm`` rule's evidence: recent retrace events
        as feed items, newest last."""
        return {"retraces": self.recent_retraces()}


DEVICE_OBS = DeviceObservatory()
# reported, and 0 for good: the port has no fallback path (module doc)
REGISTRY.counter("v6t_jit_fallbacks_total")


def observed_jit(
    name: str,
    fun: Callable[..., Any],
    *,
    static_argnums: tuple[int, ...] = (),
    static_argnames: tuple[str, ...] = (),
    sweep_statics: tuple[str, ...] = (),
) -> ObservedFunction:
    """``fun`` with the device observatory attached (module doc); the name
    is the JAX package's. ``name`` is the low-cardinality label every
    compile span and retrace note uses: name the OPERATION
    (``fedavg.round``). ``sweep_statics`` names statics the caller
    legitimately sweeps (the fused runs' ``n_rounds``)."""
    return DEVICE_OBS.register(ObservedFunction(
        name, fun, static_argnums=static_argnums,
        static_argnames=static_argnames, sweep_statics=sweep_statics,
    ))


# ------------------------------------------------------------ module-level
def engine_cache_event(
    cache: str, hit: bool, entries: int | None = None
) -> None:
    """Forwarder to :meth:`DeviceObservatory.engine_cache_event`."""
    DEVICE_OBS.engine_cache_event(cache, hit, entries=entries)


class RunnerCache:
    """FIFO-bounded get-or-create cache of keyed runners; every lookup is
    reported through :func:`engine_cache_event` under the cache's name.
    The bound matters because keys legitimately carry sweepable values,
    and an unbounded runner cache would be a leak."""

    def __init__(self, name: str, max_entries: int = 32):
        self.name = name
        self.max_entries = max_entries
        self._lock = threading.Lock()
        # guarded-by: _lock — insertion-ordered for FIFO eviction
        self._runners: "OrderedDict[Any, Any]" = OrderedDict()

    def get_or_create(self, key: Any, factory: Callable[[], Any]) -> Any:
        with self._lock:
            fn = self._runners.get(key)
        hit = fn is not None
        if not hit:
            # factory() runs unlocked; a rare duplicate build is benign
            fn = factory()
            with self._lock:
                self._runners[key] = fn
                while len(self._runners) > self.max_entries:
                    self._runners.popitem(last=False)
        engine_cache_event(self.name, hit, entries=len(self._runners))
        return fn

    def __len__(self) -> int:
        with self._lock:
            return len(self._runners)

    def clear(self) -> None:
        with self._lock:
            self._runners.clear()


class CaptureCache:
    """The port's executable cache: FIFO-bounded runners (the fused
    round's captured CUDA graphs), keyed on their input signature. Each
    build is one :meth:`DeviceObservatory.compile_event`; a key built
    before and evicted since is marked ``evicted_recompile``; each
    eviction closes the runner (``runner.close()``) and is counted in
    ``v6t_jit_cache_evictions_total``. A runner reports its warm-up and
    capture seconds as ``runner.seconds`` (None when nothing was
    captured)."""

    def __init__(self, max_entries: int = 32):
        self.max_entries = max_entries
        self._runners: "OrderedDict[Any, Any]" = OrderedDict()
        self._seen: "OrderedDict[Any, None]" = OrderedDict()
        self.evictions = 0

    def get(self, key: Any) -> Any:
        return self._runners.get(key)

    def build(self, key: Any, factory: Callable[[], Any],
              device: Any = None) -> Any:
        """Build the runner for ``key`` with ``factory()``, evicting the
        oldest first when the cache is full."""
        if len(self._runners) >= self.max_entries:
            _, old = self._runners.popitem(last=False)
            old.close()
            self.evictions += 1
            DEVICE_OBS.record_eviction()
        with DEVICE_OBS.compile_event(evicted_recompile=key in self._seen,
                                      device=device) as seconds:
            runner = factory()
            seconds.update(getattr(runner, "seconds", None) or {})
        self._runners[key] = runner
        self._seen[key] = None
        self._seen.move_to_end(key)
        while len(self._seen) > _SEEN_MAX:
            self._seen.popitem(last=False)
        return runner

    def values(self) -> list[Any]:
        return list(self._runners.values())

    def __len__(self) -> int:
        return len(self._runners)


# ----------------------------------------------------------- device memory
def _device_mem_collector() -> dict[str, float]:
    """Per-card memory as telemetry gauges: bytes in use summed over all
    visible cards, worst-card peak, card count. Empty without CUDA (an
    absent series, never a fake zero)."""
    from vantage6_tpu_torch.runtime.metrics import device_memory_all

    per = device_memory_all()
    if not per:
        return {}
    out = {
        "v6t_device_count": float(len(per)),
        "v6t_device_mem_bytes_in_use": float(
            sum(d.get("bytes_in_use") or 0 for d in per)
        ),
    }
    peaks = [d.get("peak_bytes") for d in per if d.get("peak_bytes")]
    if peaks:
        out["v6t_device_mem_peak_bytes"] = float(max(peaks))
    return out


REGISTRY.register_collector("device_mem", _device_mem_collector)


# ---------------------------------------------------------- profile windows
class ProfileBusyError(RuntimeError):
    """A profiling window is already open (profiler sessions cannot
    nest); retry after it closes."""


_PROFILE_LOCK = threading.Lock()

PROFILE_MAX_SECONDS = 30.0


def profile_window(
    seconds: float = 1.0, log_dir: str | None = None, *,
    run: Callable[[], Any] | None = None,
) -> dict[str, Any]:
    """Run one bounded ``torch.profiler`` window NOW and return ``{"path",
    "trace", "seconds", "trace_id"}``: ``path`` is the window's directory,
    ``trace`` the Chrome trace JSON written into it (CPU activity, and the
    card's kernels when CUDA is available).

    The window sleeps ``seconds`` (clamped to ``(0.05,
    PROFILE_MAX_SECONDS)``) while other threads work, or, with ``run``
    (port only), covers one call of ``run`` (synchronised on the card)
    and ``seconds`` is how long that took. It is recorded as a ``device.profile`` span
    (parented on the caller's trace when there is one), and the artifact
    path is noted in the flight recorder (kind ``profile_window``). One
    window at a time per process (:class:`ProfileBusyError` otherwise).
    """
    from torch.profiler import ProfilerActivity, profile

    if run is None:
        seconds = min(PROFILE_MAX_SECONDS, max(0.05, float(seconds)))
    if log_dir is None:
        base = os.environ.get("V6T_PROFILE_DIR") or None
        if base is None:
            import tempfile

            base = tempfile.gettempdir()
        log_dir = os.path.join(
            base, f"v6t-profile-{os.getpid()}-{int(time.time() * 1000)}"
        )
    if not _PROFILE_LOCK.acquire(blocking=False):
        raise ProfileBusyError(
            "a profiling window is already open in this process"
        )
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    trace = os.path.join(str(log_dir), "trace.json")
    try:
        os.makedirs(str(log_dir), exist_ok=True)
        with TRACER.span(
            "device.profile", kind="device",
            attrs={"log_dir": str(log_dir), "seconds": seconds,
                   "source": "profile_window"},
        ) as sp:
            ctx = getattr(sp, "context", None)
            trace_id = ctx.trace_id if ctx is not None else None
            prof = profile(activities=activities)
            prof.start()
            try:
                if run is None:
                    time.sleep(seconds)
                else:
                    t0 = time.perf_counter()
                    run()
                    if cuda:
                        torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
            finally:
                prof.stop()
            prof.export_chrome_trace(trace)
            sp.set_attr(seconds=seconds, trace=trace)
    finally:
        _PROFILE_LOCK.release()
    from vantage6_tpu_torch.common.flight import FLIGHT

    FLIGHT.note("profile_window", path=str(log_dir), trace=trace,
                seconds=seconds, trace_id=trace_id)
    return {"path": str(log_dir), "trace": trace, "seconds": seconds,
            "trace_id": trace_id}


def trace_kernel_events(trace: str) -> int:
    """Device-kernel events (``"cat": "kernel"``) in a Chrome trace that
    :func:`profile_window` wrote."""
    with open(trace) as fh:
        events = json.load(fh).get("traceEvents", [])
    return sum(1 for e in events if e.get("cat") == "kernel")


# --------------------------------------------------------------- telemetry
def _observatory_collector() -> dict[str, float]:
    """The v6t_jit_functions / v6t_jit_signatures gauges, computed at
    snapshot time from the LIVE registry."""
    fns = DEVICE_OBS.functions()
    return {
        "v6t_jit_functions": float(len(fns)),
        "v6t_jit_signatures": float(sum(f.n_signatures() for f in fns)),
    }


REGISTRY.register_collector("device_obs", _observatory_collector)
