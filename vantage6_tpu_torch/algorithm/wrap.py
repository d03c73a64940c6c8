"""wrap_algorithm — the container-ABI entrypoint, kept for parity.

Parity: vantage6-algorithm-tools `wrap.py` (SURVEY.md §2 item 18). In the
reference every algorithm image's entrypoint calls ``wrap_algorithm()``,
which reads env vars (INPUT_FILE, OUTPUT_FILE, TOKEN_FILE, database URIs),
deserializes ``{"method", "args", "kwargs"}``, dispatches the named function
from the algorithm module, and writes the serialized result to OUTPUT_FILE.

The env-var names are reconstructed ([M] in SURVEY.md — empty reference
mount): ``INPUT_FILE``, ``OUTPUT_FILE``, ``TOKEN_FILE``,
``USER_REQUESTED_DATABASE_LABELS`` (comma-separated) and per label
``DATABASE_<LABEL>_URI`` / ``DATABASE_<LABEL>_TYPE``.

INPUT_FILE/OUTPUT_FILE payloads ride the wire format of
``common.serialization``: reads auto-detect v1 JSON vs the v2 binary frame,
writes follow ``V6T_WIRE_FORMAT`` (the node's TaskRunner forwards its
``wire_format`` policy through this env var, so both sides of the ABI agree
— docs/wire_format.md).

On-pod execution does NOT go through this file — the Federation binds an
`AlgorithmEnvironment` directly (no serialization boundary in the hot loop).
This entrypoint exists so an algorithm written for this framework can still
be shipped as a standalone container against a remote control plane, and so
the ABI is testable. A client is injected only when ``V6T_SERVER_URL`` names
a control-plane REST server (see vantage6_tpu_torch.server); otherwise
client-needing functions fail with a clear error.
"""
from __future__ import annotations

import os
import sys
from types import ModuleType
from typing import Any

from vantage6_tpu_torch.algorithm.context import (
    AlgorithmEnvironment,
    RunMetadata,
    algorithm_environment,
)
from vantage6_tpu_torch.algorithm.data_loading import load_data
from vantage6_tpu_torch.common.serialization import deserialize, serialize
from vantage6_tpu_torch.core.config import DatabaseConfig


def wrap_algorithm(module: ModuleType | str | None = None) -> None:
    """Run one algorithm method per the env-file ABI and exit.

    ``module`` defaults to the main module (the reference resolves the
    algorithm package the same way).
    """
    if module is None:
        module = sys.modules["__main__"]
    elif isinstance(module, str):
        import importlib

        module = importlib.import_module(module)

    input_path = _require_env("INPUT_FILE")
    output_path = _require_env("OUTPUT_FILE")
    with open(input_path, "rb") as f:
        # writable: algorithm code may mutate its input arrays in place
        # (v1 np.load semantics — the v2 zero-copy view is read-only)
        payload = deserialize(f.read(), writable=True)
    method = payload.get("method")
    if not method:
        raise ValueError("input payload needs a 'method'")
    fn = getattr(module, method, None)
    if fn is None:
        raise AttributeError(
            f"method {method!r} not found in {module.__name__}"
        )

    secret_hex = os.environ.get("V6T_STATION_SECRET", "")
    # org identity ABI (advert signing): V6T_IDENTITY_KEY = path to this
    # org's RSA PEM (node config); V6T_ORG_IDENTITIES = JSON
    # {station index: base64 PEM public key} trust roster
    identity = None
    identity_path = os.environ.get("V6T_IDENTITY_KEY", "")
    if identity_path:
        # zero-arg factory, per the AlgorithmEnvironment convention: loading
        # (and on first start GENERATING, seconds of 4096-bit keygen) the
        # key must only happen for algorithms that actually sign
        def identity(path=identity_path):
            from vantage6_tpu_torch.common.encryption import RSACryptor

            return RSACryptor(path)
    org_identities = None
    idents_json = os.environ.get("V6T_ORG_IDENTITIES", "")
    if idents_json:
        import json as _json

        org_identities = {
            int(k): v for k, v in _json.loads(idents_json).items()
        }
    env = AlgorithmEnvironment(
        dataframes=_load_env_databases(),
        client=_maybe_rest_client(),
        station_secret=bytes.fromhex(secret_hex) if secret_hex else None,
        identity=identity,
        org_identities=org_identities,
        metadata=RunMetadata(
            task_id=_int_env("TASK_ID"),
            run_id=_int_env("RUN_ID"),
            node_id=_int_env("NODE_ID"),
            organization=os.environ.get("ORGANIZATION_NAME", ""),
            collaboration=os.environ.get("COLLABORATION_NAME", ""),
            temporary_directory=os.environ.get("TEMPORARY_FOLDER"),
        ),
    )
    args = payload.get("args", []) or []
    kwargs = payload.get("kwargs", {}) or {}
    # distributed tracing across the container ABI: the node's TaskRunner
    # forwards the run's trace context as V6T_TRACEPARENT; executing under
    # a joined span gives THIS process a current context, so every REST
    # hop the algorithm makes (subtask fan-out through the proxy) carries
    # the task's trace onward — nested central→partial rounds stay ONE
    # trace even in sandbox mode. No-op when untraced.
    from vantage6_tpu_torch.runtime.tracing import TRACER

    with TRACER.span(
        "algorithm.run", kind="algorithm",
        parent=os.environ.get("V6T_TRACEPARENT"),
        attrs={"method": method}, require_parent=True,
    ):
        with algorithm_environment(env):
            result = fn(*args, **kwargs)
    with open(output_path, "wb") as f:
        f.write(serialize(result))


def _require_env(name: str) -> str:
    v = os.environ.get(name)
    if not v:
        raise EnvironmentError(f"required env var {name} not set")
    return v


def _int_env(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def _env_gates() -> tuple[Any, Any]:
    """Rebuild the node's network gates from the sandbox ABI env (set by
    TaskRunner): the sandboxed loader enforces the same egress whitelist and
    ssh-tunnel resolution as the inline path."""
    import json

    from vantage6_tpu_torch.node.gates import OutboundWhitelist, SSHTunnelManager

    whitelist = None
    raw = os.environ.get("V6T_EGRESS")
    if raw:
        whitelist = OutboundWhitelist(**json.loads(raw))
    tunnels = None
    raw = os.environ.get("V6T_SSH_TUNNELS")
    if raw:
        tunnels = SSHTunnelManager.from_config(json.loads(raw))
    return whitelist, tunnels


def _load_env_databases() -> list[Any]:
    labels = [
        l.strip()
        for l in os.environ.get("USER_REQUESTED_DATABASE_LABELS", "").split(",")
        if l.strip()
    ]
    import json

    whitelist, tunnels = _env_gates()
    frames = []
    for label in labels:
        key = label.upper()
        uri = os.environ.get(f"DATABASE_{key}_URI", "")
        typ = os.environ.get(f"DATABASE_{key}_TYPE", "csv")
        opts = json.loads(os.environ.get(f"DATABASE_{key}_OPTIONS", "") or "{}")
        frames.append(
            load_data(
                DatabaseConfig(label=label, type=typ, uri=uri, options=opts),
                whitelist=whitelist,
                ssh_tunnels=tunnels,
            )
        )
    return frames


def _maybe_rest_client() -> Any:
    url = os.environ.get("V6T_SERVER_URL")
    if not url:
        return None
    try:
        from vantage6_tpu_torch.client.rest import RestAlgorithmClient
    except ImportError as e:
        raise NotImplementedError(
            "V6T_SERVER_URL is set but this build has no REST control-plane "
            "client yet (vantage6_tpu_torch.client.rest); run on-pod via the "
            "Federation runtime instead"
        ) from e
    return RestAlgorithmClient(
        url, token_file=os.environ.get("TOKEN_FILE", "")
    )
