"""TaskRunner — the DockerManager/DockerTaskManager equivalent.

Parity: SURVEY.md §2 item 11. The reference pulls the algorithm image,
verifies it against node policy, creates a container with data mounts + env
ABI, and harvests the exit code + OUTPUT_FILE. Here an "image" names a
registered Python algorithm module (see common.artifact); execution is
either **inline** (imported module, same process — the on-pod fast path) or
**sandboxed** (a subprocess speaking the identical env-file ABI that a real
container would — `wrap_algorithm` on the other side), chosen per node
config. Policy gates (allowed algorithms, basics) match the reference's.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from vantage6_tpu_torch.common.artifact import parse_ref
from vantage6_tpu_torch.common.log import setup_logging
from vantage6_tpu_torch.common.serialization import deserialize, serialize
from vantage6_tpu_torch.node.gates import OutboundWhitelist, SSHTunnelManager

log = setup_logging("vantage6_tpu_torch/node.runner")


import threading

# One lock per PROCESS: the global device mesh is a process-wide singleton,
# and two concurrent collective programs would interleave their rendezvous
# and deadlock — device-engine runs execute strictly one at a time.
_DEVICE_ENGINE_LOCK = threading.Lock()


class PolicyViolation(Exception):
    """Algorithm/image refused by node policy (reference: NOT_ALLOWED)."""


class UnknownAlgorithm(Exception):
    """Image not registered at this node (reference: NO_DOCKER_IMAGE)."""


@dataclass
class RunSpec:
    """Everything the runner needs for one run."""

    run_id: int
    task_id: int
    image: str
    method: str
    input_payload: dict[str, Any]  # decrypted {"method","args","kwargs"}
    databases: list[dict[str, Any]] = field(default_factory=list)
    token: str = ""  # container token for subtask creation
    server_url: str = ""  # proxy URL the algorithm should talk to
    metadata: dict[str, Any] = field(default_factory=dict)
    # sessions (reference v4.7+): this run executes inside a session
    # workspace; store_as persists the returned dataframe locally
    session_id: int | None = None
    store_as: str | None = None
    # "process" (sandbox/inline per node config) or "device": the run is one
    # collective SPMD program over the federation's global device mesh
    engine: str = "process"


class TaskRunner:
    def __init__(
        self,
        algorithms: dict[str, str] | None = None,
        databases: list[dict[str, Any]] | None = None,
        policies: dict[str, Any] | None = None,
        mode: str = "sandbox",
        work_dir: str | Path | None = None,
        station_secret: str | bytes | None = None,
        identity_key_path: str | None = None,
        org_identities: dict[int, str] | None = None,
        device_engine: bool = False,
        engine_device: Any = None,
    ):
        """``algorithms`` maps image name -> importable module path.

        ``databases`` is the node-config list ({label, type, uri}).
        ``mode``: "sandbox" (subprocess ABI, default — container parity) or
        "inline" (same process — fast, used by tests and trusted setups).
        ``station_secret`` (hex str or bytes) is this station's local secret
        for DH mask agreement (common.secureagg_dh); it is handed only to
        the algorithm's own run environment, never uploaded.
        ``identity_key_path`` / ``org_identities`` (node config) provision
        the org RSA identity key and the trusted identity-pubkey roster for
        secure-aggregation advert signing/verification (wrap.py ABI).
        """
        self.algorithms = dict(algorithms or {})
        self.databases = {d["label"]: d for d in (databases or [])}
        self.policies = dict(policies or {})
        if isinstance(station_secret, str):
            station_secret = bytes.fromhex(station_secret)
        self.station_secret = station_secret
        self.identity_key_path = identity_key_path
        self.org_identities = dict(org_identities or {}) or None
        # network gates (reference items 14/15): egress whitelist consulted
        # on every remote data-loading URI; ssh tunnel endpoints resolved for
        # databases that address them by name
        self.egress = OutboundWhitelist(**(self.policies.get("egress") or {}))
        self.ssh_tunnels = SSHTunnelManager.from_config(
            self.policies.get("ssh_tunnels")
        )
        if mode not in ("sandbox", "inline"):
            raise ValueError(f"unknown runner mode {mode!r}")
        self.mode = mode
        # a typo'd wire_format policy must fail NODE STARTUP, not turn
        # every later run into a CRASHED serialize() error
        wire_format = self.policies.get("wire_format")
        if wire_format is not None:
            from vantage6_tpu_torch.common.serialization import normalize_format

            self.policies["wire_format"] = normalize_format(str(wire_format))
        # device_engine: this node's daemon owns (a slice of) the federation
        # device mesh — it joined the process group at start — and accepts
        # engine="device" tasks. Off by default: a device task arriving at an
        # unconfigured node is refused, not silently run on the wrong mesh.
        # ``engine_device`` is the device those runs execute on: it is passed
        # as ``device=`` to a device-engine method that takes one.
        self.device_engine = bool(device_engine)
        self.engine_device = engine_device
        self._marker_cache: dict[str, bool] = {}
        self.work_dir = Path(work_dir or tempfile.mkdtemp(prefix="v6t_node_"))
        self.work_dir.mkdir(parents=True, exist_ok=True)

    # ---------------------------------------------------------------- policy
    def check_policy(self, image: str, init_user: str | None = None) -> None:
        """Reference DockerManager policy gate: allowed algorithms and
        (optionally) allowed initiating users."""
        ref = parse_ref(image)  # raises on malformed refs
        allowed = self.policies.get("allowed_algorithms")
        if allowed and not any(
            fnmatch.fnmatch(image, pat) or fnmatch.fnmatch(ref.without_digest, pat)
            for pat in allowed
        ):
            raise PolicyViolation(f"algorithm {image!r} not in allow-list")
        users = self.policies.get("allowed_users")
        if users:
            # configs write ids as ints, the wire carries strings — compare
            # normalized so [1] and ["1"] behave identically
            allowed_users = {str(u) for u in users}
            if init_user is None or str(init_user) not in allowed_users:
                raise PolicyViolation(
                    f"user {init_user!r} may not run tasks on this node"
                )

    def resolve(self, image: str) -> str:
        module = self.algorithms.get(image) or self.algorithms.get(
            parse_ref(image).without_digest
        )
        if module is None:
            raise UnknownAlgorithm(f"no algorithm registered for {image!r}")
        return module

    def has_device_marker(self, module: str) -> bool:
        """Whether ``module`` declares ``DEVICE_ENGINE = True`` — WITHOUT
        importing it (importing would execute its top-level code in the
        daemon process, the very bypass the marker check exists to refuse).
        Already-imported modules are probed live; otherwise the source is
        parsed statically, memoized per module name (the run path checks the
        marker both before ACTIVE and inside run(); one disk read + AST
        parse covers the daemon's lifetime). (find_spec imports parent
        PACKAGES — acceptable: the marker gate is about the algorithm
        module's own code.)
        """
        import ast
        import importlib.util

        mod = sys.modules.get(module)
        if mod is not None:
            return bool(getattr(mod, "DEVICE_ENGINE", False))
        if module in self._marker_cache:
            return self._marker_cache[module]
        marked = False
        try:
            spec = importlib.util.find_spec(module)
        except (ImportError, ValueError):
            spec = None
        if spec is not None and spec.origin and spec.origin.endswith(".py"):
            try:
                tree = ast.parse(Path(spec.origin).read_text())
            except (OSError, SyntaxError):
                tree = None
            for node in tree.body if tree else []:
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets = [node.target]
                if any(
                    isinstance(t, ast.Name) and t.id == "DEVICE_ENGINE"
                    for t in targets
                ):
                    marked = bool(getattr(node.value, "value", False))
        self._marker_cache[module] = marked
        return marked

    def preflight_device(self, image: str, init_user: str | None = None) -> None:
        """All DETERMINISTIC refusals for an engine="device" run, checkable
        before the daemon goes ACTIVE. Peers treat ACTIVE as "this node WILL
        enter the collective program" — any refusal discovered after ACTIVE
        leaves them blocked inside the collectives until the comm backend
        times out, so everything that can fail locally must fail here first.
        Raises PolicyViolation / UnknownAlgorithm.
        """
        self.check_policy(image, init_user)
        module = self.resolve(image)
        if not self.device_engine:
            raise PolicyViolation(
                "this node is not configured as a device-engine mesh "
                "member (node config: device_engine)"
            )
        if not self.has_device_marker(module):
            raise PolicyViolation(
                f"algorithm {image!r} is not a device-engine module "
                "(no DEVICE_ENGINE marker): refusing to run it inline in "
                "the daemon process"
            )

    def algorithm_ports(self, image: str) -> list[int]:
        """Ports the algorithm declares for cross-station traffic — module
        attribute ``EXPOSED_PORTS`` (reference: docker image EXPOSE labels
        read by the VPN manager). Empty when undeclared/unresolvable."""
        import importlib

        try:
            mod = importlib.import_module(self.resolve(image))
        except (UnknownAlgorithm, ImportError):
            return []
        return [int(p) for p in getattr(mod, "EXPOSED_PORTS", []) or []]

    # ------------------------------------------------------------- sessions
    def session_dir(self, session_id: int) -> Path:
        """This node's LOCAL store for one session's dataframes (reference
        v4.7 'sessions': dataframes persist at the station between tasks
        and never travel)."""
        d = self.work_dir / f"session_{int(session_id)}"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def session_file(self, session_id: int, handle: str) -> Path:
        safe = "".join(c for c in handle if c.isalnum() or c in "-_")
        if safe != handle or not safe:
            raise PolicyViolation(f"invalid session dataframe handle {handle!r}")
        return self.session_dir(session_id) / f"{safe}.pkl"

    def drop_session(self, session_id: int) -> None:
        """Delete the whole local store (server session deleted)."""
        import shutil

        d = self.work_dir / f"session_{int(session_id)}"
        if d.exists():
            shutil.rmtree(d, ignore_errors=True)

    def _store_session_result(self, spec: RunSpec, result: Any) -> Any:
        """Persist a store_as run's dataframe locally; upload METADATA only."""
        import pandas as pd

        df = result
        if isinstance(df, dict) and "dataframe" in df:
            df = df["dataframe"]
        if not isinstance(df, pd.DataFrame):
            raise RuntimeError(
                f"task stores dataframe {spec.store_as!r} but the algorithm "
                f"returned {type(result).__name__}, not a DataFrame"
            )
        path = self.session_file(spec.session_id, spec.store_as)
        df.to_pickle(path)
        return {
            "stored": spec.store_as,
            "session_id": spec.session_id,
            "rows": int(len(df)),
            "columns": [
                {"name": str(c), "dtype": str(t)}
                for c, t in df.dtypes.items()
            ],
        }

    # ----------------------------------------------------------------- run
    def run(self, spec: RunSpec) -> Any:
        """Execute one run; returns the (plaintext) result object.

        Raises PolicyViolation/UnknownAlgorithm for gate failures and
        RuntimeError (with the log tail) when the algorithm itself crashes.
        """
        self.check_policy(spec.image, spec.metadata.get("init_user"))
        module = self.resolve(spec.image)
        if spec.store_as and spec.session_id is None:
            raise RuntimeError("store_as requires a session_id")
        if spec.engine == "device":
            # device-engine run: the collective program must execute IN the
            # daemon process (the subprocess sandbox cannot reach the device
            # the daemon's process-group membership owns), one task at a time
            # (collective programs cannot interleave on one mesh). The same
            # refusals run in preflight_device (before the daemon patches
            # ACTIVE); re-checked here so direct runner callers can't bypass.
            self.preflight_device(spec.image, spec.metadata.get("init_user"))
            with _DEVICE_ENGINE_LOCK:
                result = self._run_inline(module, spec,
                                          device=self.engine_device)
        elif self.mode == "inline":
            result = self._run_inline(module, spec)
        else:
            result = self._run_sandbox(module, spec)
        if spec.store_as:
            return self._store_session_result(spec, result)
        return result

    # ------------------------------------------------------------ inline
    def _run_inline(self, module: str, spec: RunSpec,
                    device: Any = None) -> Any:
        import importlib
        import inspect

        from vantage6_tpu_torch.algorithm.context import (
            AlgorithmEnvironment,
            RunMetadata,
            algorithm_environment,
        )
        from vantage6_tpu_torch.algorithm.data_loading import load_data
        from vantage6_tpu_torch.client.rest import RestAlgorithmClient
        from vantage6_tpu_torch.core.config import DatabaseConfig

        mod = importlib.import_module(module)
        fn = getattr(mod, spec.method, None)
        if fn is None:
            raise UnknownAlgorithm(
                f"method {spec.method!r} not found in {module}"
            )
        frames = [
            load_data(
                DatabaseConfig(**self._db_config(d, spec.session_id)),
                whitelist=self.egress,
                ssh_tunnels=self.ssh_tunnels,
            )
            for d in (spec.databases or [{"label": "default"}])
        ]
        client = (
            RestAlgorithmClient(spec.server_url, token=spec.token)
            if spec.server_url
            else None
        )
        env = AlgorithmEnvironment(
            dataframes=frames,
            client=client,
            metadata=RunMetadata(
                task_id=spec.task_id,
                run_id=spec.run_id,
                node_id=spec.metadata.get("node_id"),
                organization=spec.metadata.get("organization", ""),
                collaboration=spec.metadata.get("collaboration", ""),
            ),
            station_secret=self.station_secret,
            identity=(
                self._load_identity if self.identity_key_path else None
            ),
            org_identities=self.org_identities,
        )
        args = spec.input_payload.get("args", []) or []
        kwargs = spec.input_payload.get("kwargs", {}) or {}
        if device is not None and "device" not in kwargs \
                and "device" in inspect.signature(fn).parameters:
            kwargs = {**kwargs, "device": str(device)}
        with algorithm_environment(env):
            return fn(*args, **kwargs)

    def _load_identity(self):
        """Lazy org-identity cryptor (zero-arg factory for the run env)."""
        from vantage6_tpu_torch.common.encryption import RSACryptor

        return RSACryptor(self.identity_key_path)

    # ----------------------------------------------------------- sandbox
    def _run_sandbox(self, module: str, spec: RunSpec) -> Any:
        """Subprocess speaking the container ABI (reference: docker run)."""
        run_dir = self.work_dir / f"run_{spec.run_id}"
        run_dir.mkdir(parents=True, exist_ok=True)
        input_file = run_dir / "input"
        output_file = run_dir / "output"
        token_file = run_dir / "token"
        # INPUT_FILE rides the v2 binary wire by default (raw aligned array
        # buffers, no base64 — docs/wire_format.md); node policy
        # `wire_format: v1` pins the legacy JSON ABI for old algorithm
        # containers. wrap_algorithm auto-detects on read either way.
        wire_format = self.policies.get("wire_format")
        input_file.write_bytes(serialize(spec.input_payload, format=wire_format))
        token_file.write_text(spec.token)

        # the child must be able to import vantage6_tpu_torch regardless of the
        # node's cwd or whether the package is pip-installed: pin the
        # directory that contains this very package onto its PYTHONPATH
        import vantage6_tpu_torch

        pkg_root = str(Path(vantage6_tpu_torch.__file__).resolve().parent.parent)
        env = {
            **os.environ,
            "PYTHONPATH": os.pathsep.join(
                p for p in (pkg_root, os.environ.get("PYTHONPATH")) if p
            ),
            "INPUT_FILE": str(input_file),
            "OUTPUT_FILE": str(output_file),
            "TOKEN_FILE": str(token_file),
            "TASK_ID": str(spec.task_id),
            "RUN_ID": str(spec.run_id),
            "TEMPORARY_FOLDER": str(run_dir),
        }
        if wire_format:
            # the child's OUTPUT_FILE serialize follows the same node policy
            env["V6T_WIRE_FORMAT"] = str(wire_format)
        # trace context crosses the ABI: the subprocess executes under a
        # span joined on this (wrap_algorithm reads it), so the child's
        # subtask fan-out stays in the task's trace (docs/observability.md)
        from vantage6_tpu_torch.runtime.tracing import TRACER

        traceparent = TRACER.current_traceparent()
        if traceparent:
            env["V6T_TRACEPARENT"] = traceparent
        if not self.policies.get("accelerator", False):
            # sandboxed algorithms see no card, like the reference's
            # containers: faster startup and no contention for the host's
            # accelerator; opt in via policies: {accelerator: true}. A child
            # that calls a device entry point without device="cpu" raises.
            env["CUDA_VISIBLE_DEVICES"] = ""
        if spec.server_url:
            env["V6T_SERVER_URL"] = spec.server_url
        if self.station_secret:
            env["V6T_STATION_SECRET"] = self.station_secret.hex()
        if self.identity_key_path:
            env["V6T_IDENTITY_KEY"] = str(self.identity_key_path)
        if self.org_identities:
            env["V6T_ORG_IDENTITIES"] = json.dumps(
                {str(k): v for k, v in self.org_identities.items()}
            )
        # network gates cross the ABI as JSON so the sandboxed loader
        # enforces the same egress policy the inline path does
        if self.egress.enabled:
            env["V6T_EGRESS"] = json.dumps(dataclasses.asdict(self.egress))
        if self.ssh_tunnels.tunnels:
            env["V6T_SSH_TUNNELS"] = json.dumps(
                list(self.ssh_tunnels.tunnels.values())
            )
        requested = spec.databases or [{"label": "default"}]
        env["USER_REQUESTED_DATABASE_LABELS"] = ",".join(
            d.get("label", "default") for d in requested
        )
        for d in requested:
            label = d.get("label", "default")
            cfg = self._db_config(d, spec.session_id)
            env[f"DATABASE_{label.upper()}_URI"] = str(cfg.get("uri", ""))
            env[f"DATABASE_{label.upper()}_TYPE"] = str(cfg.get("type", "csv"))
            env[f"DATABASE_{label.upper()}_OPTIONS"] = json.dumps(
                cfg.get("options", {}) or {}
            )
        for k, v in spec.metadata.items():
            if k in ("node_id",):
                env["NODE_ID"] = str(v)
            elif k == "organization":
                env["ORGANIZATION_NAME"] = str(v)
            elif k == "collaboration":
                env["COLLABORATION_NAME"] = str(v)

        # child of the daemon's runner.exec span: separates subprocess
        # spawn+ABI overhead from the run's total (inline mode has none,
        # which is exactly what this makes visible in the per-hop table)
        from vantage6_tpu_torch.runtime.tracing import TRACER

        with TRACER.span(
            "runner.sandbox", kind="sandbox",
            attrs={"run_id": spec.run_id, "image": spec.image},
            require_parent=True,
        ):
            proc = subprocess.run(
                [
                    sys.executable,
                    "-c",
                    "from vantage6_tpu_torch.algorithm.wrap import wrap_algorithm; "
                    f"wrap_algorithm({module!r})",
                ],
                env=env,
                capture_output=True,
                text=True,
                timeout=self.policies.get("task_timeout", 600),
            )
        (run_dir / "log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"algorithm exited {proc.returncode}:\n"
                + (proc.stderr or proc.stdout)[-2000:]
            )
        if not output_file.exists():
            raise RuntimeError("algorithm wrote no OUTPUT_FILE")
        # writable: harvested results are handed onward to caller code
        # that may mutate them (v1 semantics)
        return deserialize(output_file.read_bytes(), writable=True)

    # ----------------------------------------------------------------- util
    def _db_config(
        self, requested: dict[str, Any], session_id: int | None = None
    ) -> dict[str, Any]:
        label = requested.get("label", "default")
        if requested.get("type") == "session":
            # session dataframe reference: resolve to this node's LOCAL
            # session store (materialized by an earlier store_as task)
            handle = requested.get("dataframe") or label
            if session_id is None:
                raise KeyError(
                    f"database {label!r} references session dataframe "
                    f"{handle!r} but the task carries no session"
                )
            path = self.session_file(session_id, handle)
            if not path.exists():
                raise KeyError(
                    f"session {session_id} has no materialized dataframe "
                    f"{handle!r} at this node (did its extraction task run?)"
                )
            return {
                "label": label,
                "type": "session",
                "uri": str(path),
                "options": {},
            }
        cfg = self.databases.get(label)
        if cfg is None:
            raise KeyError(
                f"node has no database labeled {label!r} "
                f"(configured: {sorted(self.databases)})"
            )
        return {
            "label": label,
            "type": cfg.get("type", "csv"),
            "uri": cfg.get("uri", ""),
            "options": cfg.get("options", {}) or {},
        }
