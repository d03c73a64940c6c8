"""UserClient: the researcher-facing SDK.

Parity: vantage6-client `UserClient` (SURVEY.md §2 item 16) — subclients per
entity (`.task`, `.run`, `.organization`, `.collaboration`, `.node`,
`.user`, `.role`, `.rule`, `.study`), JWT auth with optional MFA,
`wait_for_results`, and client-side end-to-end encryption: task inputs are
encrypted per destination organization's public key; results are decrypted
with the researcher's own private key.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any

from vantage6_tpu_torch.common.encryption import CryptorBase, DummyCryptor, RSACryptor
from vantage6_tpu_torch.common.log import setup_logging
from vantage6_tpu_torch.common.rest import RestError, RestSession
from vantage6_tpu_torch.common.serialization import deserialize, serialize
from vantage6_tpu_torch.runtime.tracing import TRACER

log = setup_logging("vantage6_tpu_torch/client")

# public alias: callers catch ClientError
ClientError = RestError


class UserClient:
    """``UserClient("http://localhost", 7601)`` or ``UserClient(url)``."""

    def __init__(
        self,
        host: str,
        port: int | None = None,
        path: str = "",
        verbose: bool = False,
    ):
        base = host if port is None else f"{host}:{port}"
        self.base_url = base.rstrip("/") + path
        self.verbose = verbose
        self._access_token: str | None = None
        self._refresh_token: str | None = None
        self.whoami: dict[str, Any] | None = None
        self.cryptor: CryptorBase = DummyCryptor()
        self._encryption_configured = False
        # event long-poll capability (None until probed; see
        # common.rest.await_task_finished)
        self._event_push: bool | None = None
        # task_id -> SpanContext of the client-side root span that created
        # it: wait_for_results and caller-side aggregation spans attach
        # here so a whole federated round stays ONE trace. Bounded FIFO —
        # a long-lived client must not grow it forever.
        self._task_traces: dict[int, Any] = {}
        self._rest = RestSession(
            self.base_url,
            token_getter=lambda: self._access_token,
            refresh=self._refresh,
        )

        self.task = TaskSubClient(self)
        self.run = RunSubClient(self)
        self.result = self.run  # reference alias (Run né Result)
        self.organization = SubClient(self, "organization")
        self.collaboration = SubClient(self, "collaboration")
        self.node = SubClient(self, "node")
        self.user = SubClient(self, "user")
        self.role = SubClient(self, "role")
        self.rule = SubClient(self, "rule")
        self.study = SubClient(self, "study")
        self.session = SessionSubClient(self)
        self.store = StoreSubClient(self)
        self.util = UtilSubClient(self)

    # ------------------------------------------------------------------ http
    def request(
        self,
        method: str,
        endpoint: str,
        json_body: Any = None,
        params: dict[str, Any] | None = None,
        timeout: float | None = None,
        raw: bool = False,
    ) -> Any:
        return self._rest.request(
            method, endpoint, json_body, params, timeout=timeout, raw=raw
        )

    def paginate(
        self, endpoint: str, params: dict[str, Any] | None = None
    ) -> list[dict[str, Any]]:
        return self._rest.paginate(endpoint, params)

    def _refresh(self) -> bool:
        if not self._refresh_token:
            return False
        try:
            data = RestSession(self.base_url).request(
                "POST",
                "token/refresh",
                {"refresh_token": self._refresh_token},
            )
        except RestError:
            self._access_token = None
            return False
        self._access_token = data["access_token"]
        self._refresh_token = data.get("refresh_token", self._refresh_token)
        return True

    # ------------------------------------------------------------------ auth
    def authenticate(
        self, username: str, password: str, mfa_code: str | None = None
    ) -> dict[str, Any]:
        data = self.request(
            "POST",
            "token/user",
            {"username": username, "password": password, "mfa_code": mfa_code},
        )
        self._access_token = data["access_token"]
        self._refresh_token = data["refresh_token"]
        self.whoami = data["user"]
        return data["user"]

    def change_password(self, current_password: str, new_password: str) -> None:
        """Self-service password change (requires the current password).

        Every outstanding session — including THIS client's tokens — is
        invalidated by the change; call authenticate() again after."""
        self.request(
            "POST",
            "password/change",
            {
                "current_password": current_password,
                "new_password": new_password,
            },
        )

    # ------------------------------------------------------------ encryption
    def setup_encryption(self, private_key: str | Path | None) -> None:
        """Enable E2E crypto (None -> explicit opt-out, DummyCryptor).

        Registers our public key at our organization if it differs
        (reference does the same on node start / client setup).
        """
        self._encryption_configured = True
        if private_key is None:
            self.cryptor = DummyCryptor()
            return
        self.cryptor = RSACryptor(private_key)
        if self.whoami:
            org_id = self.whoami["organization"]["id"]
            org = self.organization.get(org_id)
            if org.get("public_key") != self.cryptor.public_key_str:
                self.request(
                    "PATCH",
                    f"organization/{org_id}",
                    {"public_key": self.cryptor.public_key_str},
                )

    # ----------------------------------------------------------- tracing
    def trace_context(self, task_id: int) -> Any:
        """The trace context (SpanContext) of `task.create(task_id)`, or
        None — parent caller-side spans (e.g. an aggregation step) on it
        so they land in the task's own trace:

            with TRACER.span("aggregate", kind="aggregate",
                             parent=client.trace_context(tid)): ...
        """
        return self._task_traces.get(task_id)

    def _remember_trace(self, task_id: int, ctx: Any) -> None:
        if ctx is None:
            return
        self._task_traces[task_id] = ctx
        while len(self._task_traces) > 256:
            self._task_traces.pop(next(iter(self._task_traces)))

    # --------------------------------------------------------------- results
    def wait_for_results(
        self, task_id: int, interval: float = 0.5, timeout: float = 300.0
    ) -> list[Any]:
        """Wait until the task finishes; return decrypted, deserialized
        results (reference: UserClient.wait_for_results).

        Event-driven against a long-poll-capable server: blocks on the
        event stream and wakes the moment a `status-update` reports the
        task finished, re-checking the task itself each cycle as the
        anti-entropy backstop (events can be evicted, and the user's
        rooms may not cover the task's collaboration). Falls back to
        fixed-`interval` polling against an older server.
        """
        from vantage6_tpu_torch.common.rest import await_task_finished

        # joins the trace task.create started (no-op for untraced tasks);
        # the decrypt+deserialize collection loop is inside the span too —
        # that is the client-decode leg of the per-hop table
        with TRACER.span(
            "client.wait_results", kind="client", service="client",
            parent=self.trace_context(task_id),
            attrs={"task_id": task_id}, require_parent=True,
        ):
            status = await_task_finished(self, task_id, interval, timeout)
            if status.has_failed:
                runs = self.paginate(f"task/{task_id}/run")
                logs = {r["organization"]["id"]: r["log"] for r in runs}
                raise ClientError(
                    500, f"task {task_id} {status.value}: {logs}"
                )
            runs = self.paginate(f"task/{task_id}/run")
            out = []
            for run in sorted(runs, key=lambda r: r["id"]):
                blob = run.get("result")
                if not blob:
                    out.append(None)
                    continue
                # writable: researchers get arrays they can mutate
                # (v1 parity)
                out.append(deserialize(
                    self.cryptor.decrypt_str_to_bytes(blob), writable=True
                ))
            return out


class SubClient:
    """Generic CRUD subclient (`client.organization.list()` etc.)."""

    def __init__(self, parent: UserClient, resource: str):
        self.parent = parent
        self.resource = resource

    def list(self, **params: Any) -> list[dict[str, Any]]:
        """All rows (drains every page; pass page/per_page to get one)."""
        if "page" in params:
            return self.parent.request(
                "GET", self.resource, params=params
            )["data"]
        return self.parent.paginate(self.resource, params)

    def get(self, id_: int) -> dict[str, Any]:
        return self.parent.request("GET", f"{self.resource}/{id_}")

    def create(self, **fields: Any) -> dict[str, Any]:
        return self.parent.request("POST", self.resource, fields)

    def update(self, id_: int, **fields: Any) -> dict[str, Any]:
        return self.parent.request("PATCH", f"{self.resource}/{id_}", fields)

    def delete(self, id_: int) -> None:
        self.parent.request("DELETE", f"{self.resource}/{id_}")


class TaskSubClient(SubClient):
    def __init__(self, parent: UserClient):
        super().__init__(parent, "task")

    def create(
        self,
        collaboration: int,
        organizations: list[int],
        name: str = "task",
        image: str = "",
        description: str = "",
        input_: dict[str, Any] | None = None,
        databases: list[dict[str, Any]] | None = None,
        study: int | None = None,
        session: int | None = None,
        store_as: str | None = None,
        engine: str | None = None,
    ) -> dict[str, Any]:
        """Create a task; `input_` is the reference wire shape
        ``{"method", "args", "kwargs"}``, serialized then encrypted per
        destination organization's public key when E2E crypto is on.

        ``engine="device"`` submits a device-engine task: every targeted
        node executes the SAME run as one collective SPMD program over the
        federation's global device mesh (the nodes must be configured with
        ``device_engine`` so their daemons joined the mesh at start)."""
        # ROOT span of the task's distributed trace: encode+encrypt+POST
        # here, server dispatch / daemon claim+exec / result upload attach
        # underneath via the traceparent the POST carries (tracing.py)
        with TRACER.span(
            "client.task_create", kind="client", service="client",
            attrs={"image": image, "n_orgs": len(organizations)},
        ) as span:
            task = self._create_traced(
                collaboration=collaboration,
                organizations=organizations,
                name=name,
                image=image,
                description=description,
                input_=input_,
                databases=databases,
                study=study,
                session=session,
                store_as=store_as,
                engine=engine,
            )
            span.set_attr(task_id=task.get("id"))
            self.parent._remember_trace(task.get("id"), span.context)
            return task

    def _create_traced(
        self,
        collaboration: int,
        organizations: list[int],
        name: str,
        image: str,
        description: str,
        input_: dict[str, Any] | None,
        databases: list[dict[str, Any]] | None,
        study: int | None,
        session: int | None,
        store_as: str | None,
        engine: str | None,
    ) -> dict[str, Any]:
        input_ = input_ or {}
        blob = serialize(input_)
        # the COLLABORATION decides whether payloads are encrypted (the
        # reference refuses mismatches at submit time, not at the node)
        collab = self.parent.collaboration.get(collaboration)
        encrypting = bool(collab.get("encrypted"))
        if encrypting and isinstance(self.parent.cryptor, DummyCryptor):
            raise ClientError(
                400,
                f"collaboration {collaboration} is encrypted: call "
                "setup_encryption(<private key path>) before creating tasks",
            )
        # an unencrypted collaboration always rides plain base64, even when
        # the researcher holds a key (nodes there have no cryptor)
        cryptor = self.parent.cryptor if encrypting else DummyCryptor()
        pubkeys = []
        for org_id in organizations:
            if encrypting:
                org = self.parent.organization.get(org_id)
                pubkey = org.get("public_key")
                if not pubkey:
                    raise ClientError(
                        400,
                        f"organization {org_id} has no public key registered; "
                        "cannot E2E-encrypt the task input for it",
                    )
            else:
                pubkey = ""
            pubkeys.append(pubkey)
        # single-pass broadcast encryption: one AES pass over the payload +
        # one RSA key seal per organization (encrypt_bytes_broadcast), not
        # one full encrypt per destination
        wires = cryptor.encrypt_bytes_to_str_broadcast(blob, pubkeys)
        org_specs = [
            {"id": org_id, "input": wire}
            for org_id, wire in zip(organizations, wires)
        ]
        body = {
            "name": name,
            "description": description,
            "image": image,
            "method": input_.get("method", ""),
            "collaboration_id": collaboration,
            "organizations": org_specs,
            "databases": databases or [],
        }
        if study is not None:
            body["study_id"] = study
        if session is not None:
            body["session_id"] = session
        if store_as is not None:
            body["store_as"] = store_as
        if engine is not None:
            body["engine"] = engine
        return self.parent.request("POST", "task", body)

    def kill(self, task_id: int) -> dict[str, Any]:
        return self.parent.request("POST", "kill/task", {"task_id": task_id})


class SessionSubClient(SubClient):
    """Session workspaces (reference v4.7+): named dataframes persisted AT
    THE NODES between tasks — create a session, run an extraction task with
    ``store_as``, then point later tasks' databases at
    ``{"label": ..., "type": "session", "dataframe": <handle>}``."""

    def __init__(self, parent: UserClient):
        super().__init__(parent, "session")

    def dataframes(self, session_id: int) -> list[dict[str, Any]]:
        return self.parent.paginate(f"session/{session_id}/dataframe")


class RunSubClient(SubClient):
    def __init__(self, parent: UserClient):
        super().__init__(parent, "run")

    def from_task(self, task_id: int) -> list[dict[str, Any]]:
        return self.parent.paginate(f"task/{task_id}/run")


class StoreSubClient:
    """Browse the algorithm store LINKED to this server (reference: the
    UserClient's store surface): the server proxies the store's public
    listing, so researchers discover approved algorithms — including full
    function/argument metadata, the same payload the web UI's task wizard
    consumes — without talking to the store directly."""

    def __init__(self, parent: "UserClient"):
        self.parent = parent

    def info(self) -> dict[str, Any]:
        """{"url": <store url or None>} — whether a store is linked."""
        return self.parent.request("GET", "store")

    def algorithms(self) -> list[dict[str, Any]]:
        """Approved algorithms with functions/arguments metadata; empty
        when no store is linked (the server 404s that case itself)."""
        try:
            return self.parent.request(
                "GET", "store/algorithm"
            ).get("data", [])
        except ClientError as e:
            if e.status == 404:
                return []
            raise


class UtilSubClient:
    def __init__(self, parent: UserClient):
        self.parent = parent

    def health(self) -> dict[str, Any]:
        return self.parent.request("GET", "health")

    def metrics(self) -> str:
        """The server's unified telemetry as Prometheus text (wire, REST,
        HTTP, executor, event-hub, cache and tracing series)."""
        return self.parent.request("GET", "metrics", raw=True)

    def alerts(self) -> dict[str, Any]:
        """The server watchdog's alert state (GET /api/alerts): active +
        recently resolved alerts and the rule catalog explaining each."""
        return self.parent.request("GET", "alerts")

    def fleet(self) -> dict[str, Any]:
        """The store-backed fleet view (GET /api/fleet): per-source
        freshness, the merged counter/gauge census, top fast-window
        deltas, recent fleet events and the daemon-liveness ratio —
        the same view `tools/doctor.py --live` renders."""
        return self.parent.request("GET", "fleet")

    def debug_dump(self) -> dict[str, Any]:
        """Trigger a server-side flight-recorder dump (POST
        /api/debug/dump); returns the bundle path + record census. Feed
        the path to `tools/doctor.py` for the merged timeline."""
        return self.parent.request("POST", "debug/dump")

    def rounds(self, task_id: int | None = None) -> dict[str, Any]:
        """The server's learning-plane observatory (GET /api/rounds):
        with a ``task_id``, that task's per-round history — loss, pooled
        update norm (the convergence trajectory) and per-station
        norms/cosines, the evidence behind `anomalous_station` /
        `non_convergence` / `model_divergence` alerts; without one, the
        index of tracked tasks with their convergence summaries."""
        if task_id is None:
            return self.parent.request("GET", "rounds")
        return self.parent.request("GET", f"rounds/{task_id}")

    def debug_profile(self, seconds: float = 1.0) -> dict[str, Any]:
        """Open an on-demand torch.profiler window on the server (POST
        /api/debug/profile); returns ``{"path", "trace", "seconds",
        "trace_id"}`` — the Chrome trace lands at ``trace`` on server disk
        and is linked to this request's trace. One window at a time (409 while
        one is open)."""
        return self.parent.request(
            "POST", "debug/profile", {"seconds": seconds}
        )

    def version(self) -> dict[str, Any]:
        return self.parent.request("GET", "version")

    def events(self, since: int = 0) -> dict[str, Any]:
        return self.parent.request("GET", "event", params={"since": since})
