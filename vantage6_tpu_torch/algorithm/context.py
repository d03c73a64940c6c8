"""Per-run execution environment for algorithm functions.

The reference passes an algorithm its world through the container boundary:
env vars (INPUT_FILE, TOKEN_FILE, OUTPUT_FILE, DATABASE_URI...), mounted data
files, and a proxy URL (SURVEY.md §2 item 18). Here a run's world is an
`AlgorithmEnvironment` bound to a context variable while the function
executes — the decorators read from it. The env-file ABI is still supported
for container-parity via ``wrap.py``, which the port gains with the node.

The port's copy of ``vantage6_tpu/algorithm/context.py`` (framework-free).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Iterator


@dataclasses.dataclass
class RunMetadata:
    """Injected by @metadata (reference: algorithm tools' RunMetaData)."""

    task_id: int | None = None
    run_id: int | None = None
    node_id: int | None = None
    organization: str = ""
    collaboration: str = ""
    temporary_directory: str | None = None


@dataclasses.dataclass
class AlgorithmEnvironment:
    """Everything an algorithm function may have injected."""

    dataframes: list[Any] = dataclasses.field(default_factory=list)
    client: Any = None  # AlgorithmClient
    metadata: RunMetadata = dataclasses.field(default_factory=RunMetadata)
    # station-LOCAL secret (node config / federation-provisioned); basis for
    # per-pair DH mask agreement (common.secureagg_dh) — never leaves the
    # station, never crosses the task payload boundary
    station_secret: bytes | None = None
    # this station's organization RSA identity (encryption.RSACryptor) —
    # signs secure-aggregation adverts (secureagg_dh.sign_advert). May be
    # the cryptor itself OR a zero-arg factory returning it (accessors in
    # secureagg_dh resolve either) so second-scale RSA keygen only happens
    # for algorithms that sign.
    identity: Any = None
    # trust registry: station index -> base64 PEM RSA public identity key,
    # distributed at onboarding (NOT through the task relay). When present,
    # secure-aggregation workloads verify peer adverts against it and fail
    # closed on mismatch (active-MitM resistance). Same value-or-factory
    # convention as `identity`.
    org_identities: Any = None


_current: contextvars.ContextVar[AlgorithmEnvironment | None] = (
    contextvars.ContextVar("v6t_algorithm_env", default=None)
)


def current_environment() -> AlgorithmEnvironment:
    env = _current.get()
    if env is None:
        raise RuntimeError(
            "no algorithm environment active — algorithm functions decorated "
            "with @data/@algorithm_client/@metadata must be invoked through a "
            "Federation / MockAlgorithmClient / wrap_algorithm, not called "
            "directly (pass data explicitly to call them standalone)"
        )
    return env


@contextlib.contextmanager
def algorithm_environment(env: AlgorithmEnvironment) -> Iterator[None]:
    token = _current.set(env)
    try:
        yield
    finally:
        _current.reset(token)
