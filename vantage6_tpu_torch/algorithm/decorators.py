"""Algorithm decorators — the algorithm-facing ABI.

Parity: vantage6-algorithm-tools decorators (SURVEY.md §2 item 18):

- ``@data(n)`` injects this station's first n DataFrames as leading args;
- ``@algorithm_client`` injects an `AlgorithmClient` as the first arg;
- ``@metadata`` injects a `RunMetadata` as the first arg.

Stacking order matches the reference: ``@data`` listed first (outermost),
``@algorithm_client`` under it, so the injected signature is
``(client, df1, df2, ...)`` — each decorator prepends its injection at call
time, so the innermost decorator's value lands first::

    @data(2)
    @algorithm_client
    def partial(client, df1, df2, *args, **kwargs): ...

The injected values come from the active `AlgorithmEnvironment` (set by the
orchestrator per run) instead of container env-files. Functions additionally
get marker attributes so the executor knows what they need, and a
``.plain(...)`` escape hatch to call the undecorated function in tests.

The port's copy of ``vantage6_tpu/algorithm/decorators.py``.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

from vantage6_tpu_torch.algorithm.context import current_environment


def data(number_of_databases: int = 1) -> Callable:
    """Inject ``number_of_databases`` of this station's DataFrames.

    Like the reference, the decorated function receives the frames as its
    first positional arguments, in the order the task's ``databases`` listed
    them.
    """
    if callable(number_of_databases):  # used bare: @data
        fn = number_of_databases
        return data(1)(fn)
    n = int(number_of_databases)

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            env = current_environment()
            if len(env.dataframes) < n:
                raise RuntimeError(
                    f"{fn.__name__} requests {n} database(s); run has "
                    f"{len(env.dataframes)} (check the task's `databases` "
                    "argument and the station config)"
                )
            return wrapper.__wrapped__(*env.dataframes[:n], *args, **kwargs)

        wrapper.__v6t_n_dataframes__ = n
        _copy_markers(fn, wrapper)
        wrapper.plain = getattr(fn, "plain", fn)
        return wrapper

    return deco


def algorithm_client(fn: Callable) -> Callable:
    """Inject the AlgorithmClient (subtask creation, result fetch) as arg 0."""

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        env = current_environment()
        if env.client is None:
            raise RuntimeError(
                f"{fn.__name__} needs an algorithm client but none is active "
                "(central functions must run through the orchestrator)"
            )
        return wrapper.__wrapped__(env.client, *args, **kwargs)

    wrapper.__v6t_needs_client__ = True
    _copy_markers(fn, wrapper)
    wrapper.plain = getattr(fn, "plain", fn)
    return wrapper


def metadata(fn: Callable) -> Callable:
    """Inject RunMetadata (task/run/node ids, org, collaboration) as arg 0."""

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        env = current_environment()
        return wrapper.__wrapped__(env.metadata, *args, **kwargs)

    wrapper.__v6t_needs_metadata__ = True
    _copy_markers(fn, wrapper)
    wrapper.plain = getattr(fn, "plain", fn)
    return wrapper


def device_step(fn: Callable) -> Callable:
    """Mark a partial as a device step: the card's fast path.

    A ``@device_step`` partial has signature ``fn(data, *args, **kwargs)``
    where ``data`` is this station's tensor pytree; the orchestrator runs
    all stations' calls as ONE batched program (``FederationMesh.fed_map``
    with ``batched=True``, i.e. ``torch.func.vmap`` over the station axis)
    instead of a per-station Python loop, and aggregation of its results
    can stay on the card. The partial must therefore be vmap-able: no
    data-dependent Python control flow, no ``.item()``, no random draws,
    no in-place writes to its inputs. This marker has no reference
    equivalent — it is the opt-in that turns a vantage6-shaped algorithm
    into one batched device program.
    """
    fn.__v6t_device_step__ = True
    return fn


_MARKERS = (
    "__v6t_n_dataframes__",
    "__v6t_needs_client__",
    "__v6t_needs_metadata__",
    "__v6t_device_step__",
)


def _copy_markers(src: Callable, dst: Callable) -> None:
    for m in _MARKERS:
        if getattr(src, m, None):
            setattr(dst, m, getattr(src, m))


def is_v6t_function(fn: Any) -> bool:
    """True if ``fn`` was wrapped by one of this module's decorators.

    Used by algorithm registration to recognise dispatchable functions even
    when they were attached to a dynamically assembled module (their
    ``__module__`` then names the defining file, not the module object).
    """
    return callable(fn) and any(getattr(fn, m, None) for m in _MARKERS)
