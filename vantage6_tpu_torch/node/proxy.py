"""The node's proxy server — algorithm containers' window to the world.

Parity: vantage6-node `proxy_server.py` (SURVEY.md §2 item 12). Algorithm
containers never reach the control plane directly: they talk to this little
server on the node-local network, which (a) relays requests with the
container's JWT, (b) encrypts subtask inputs per destination organization's
public key, and (c) decrypts incoming results with the node's (org's)
private key — so containers never touch key material.
"""
from __future__ import annotations

import base64
from typing import Any

from vantage6_tpu_torch.common.encryption import CryptorBase
from vantage6_tpu_torch.common.rest import pooled_request
from vantage6_tpu_torch.common.log import setup_logging
from vantage6_tpu_torch.server.web import App, AppServer, HTTPError, Request

log = setup_logging("vantage6_tpu_torch/node.proxy")


class NodeProxy:
    """Builds the proxy App for one node."""

    def __init__(
        self,
        server_url: str,
        cryptor: CryptorBase,
        collaboration_id: int,
        encrypted: bool,
    ):
        self.server_url = server_url.rstrip("/")
        self.cryptor = cryptor
        self.collaboration_id = collaboration_id
        self.encrypted = encrypted
        self._org_pubkeys: dict[int, str] = {}
        self.app = App("v6t-node-proxy")
        self._register()

    # ------------------------------------------------------------- helpers
    def _forward(
        self,
        req: Request,
        method: str,
        endpoint: str,
        json_body: Any = None,
    ) -> Any:
        token = req.bearer_token
        if not token:
            raise HTTPError(401, "container token required")
        # shared keep-alive pool: every relayed call rides a warm socket;
        # the timeout outlasts the server's 25 s long-poll cap so a
        # forwarded event wait completes but a dead server can't wedge a
        # relay thread forever
        resp = pooled_request(
            method,
            f"{self.server_url}/api/{endpoint.lstrip('/')}",
            json_body=json_body,
            params={k: v[0] for k, v in req.query.items()},
            headers={"Authorization": f"Bearer {token}"},
            timeout=60.0,
        )
        body = resp.json() if resp.content else {}
        if resp.status_code >= 400:
            raise HTTPError(resp.status_code, body.get("msg", "upstream error"))
        return body

    def _pubkey(self, req: Request, org_id: int) -> str:
        if org_id not in self._org_pubkeys:
            org = self._forward(req, "GET", f"organization/{org_id}")
            key = org.get("public_key") or ""
            if not key:
                raise HTTPError(
                    400,
                    f"organization {org_id} has no public key; cannot "
                    "encrypt the subtask input",
                )
            self._org_pubkeys[org_id] = key
        return self._org_pubkeys[org_id]

    def _decrypt_result(self, blob: str | None) -> str | None:
        """Encrypted-toward-our-org blob -> base64(plaintext serialized).

        ``decrypt_bytes`` auto-detects the wire framing, so v1 '$'-joined
        strings and base64'd v2 binary frames both decrypt."""
        if not blob:
            return blob
        try:
            plain = self.cryptor.decrypt_bytes(blob)
        except Exception:
            # result was encrypted toward a different org (not our task
            # tree) — pass the ciphertext through rather than failing
            return blob
        return base64.b64encode(plain).decode("ascii")

    # -------------------------------------------------------------- routes
    def _register(self) -> None:
        app = self.app

        @app.route("/api/task", methods=("POST",))
        def create_task(req: Request):
            body = req.json or {}
            orgs = body.get("organizations") or []
            if not orgs:
                raise HTTPError(400, "organizations required")
            try:
                input_plain = base64.b64decode(body.get("input", ""))
            except Exception:
                raise HTTPError(400, "input must be base64") from None
            # single-pass broadcast: the payload is AES-encrypted ONCE and
            # only the key seal differs per destination organization — an
            # N-org subtask fan-out no longer pays N full encrypt passes
            pubkeys = [
                self._pubkey(req, int(o)) if self.encrypted else ""
                for o in orgs
            ]
            wires = self.cryptor.encrypt_bytes_to_str_broadcast(
                input_plain, pubkeys
            )
            org_specs = [
                {"id": int(o), "input": w} for o, w in zip(orgs, wires)
            ]
            method = ""
            try:
                # wire-format-aware metadata peek: reads the structure
                # header only, never materializes the (possibly many-MB)
                # array buffers just to learn one string
                from vantage6_tpu_torch.common.serialization import peek_structure

                decoded = peek_structure(input_plain)
                if isinstance(decoded, dict):
                    m = decoded.get("method", "")
                    if isinstance(m, str):
                        method = m
            except Exception:
                pass
            upstream = {
                "name": body.get("name", "subtask"),
                "image": body.get("image", ""),
                "method": method,
                "collaboration_id": self.collaboration_id,
                "organizations": org_specs,
                "databases": body.get("databases") or [],
            }
            # the server derives the true image from the container token's
            # parent task; containers cannot spoof it (resources._create_task)
            if not upstream["image"]:
                task_id = self._token_task_id(req)
                parent = self._forward(req, "GET", f"task/{task_id}")
                upstream["image"] = parent["image"]
            return self._forward(req, "POST", "task", upstream), 201

        @app.route("/api/task/<int:id>", methods=("GET",))
        def get_task(req: Request, id: int):
            return self._forward(req, "GET", f"task/{id}")

        @app.route("/api/task/<int:id>/run", methods=("GET",))
        def get_task_runs(req: Request, id: int):
            body = self._forward(req, "GET", f"task/{id}/run")
            for run in body.get("data", []):
                run["result"] = self._decrypt_result(run.get("result"))
                run.pop("input", None)  # containers never see others' inputs
            return body

        @app.route("/api/run", methods=("GET",))
        def get_runs(req: Request):
            body = self._forward(req, "GET", "run")
            for run in body.get("data", []):
                run["result"] = self._decrypt_result(run.get("result"))
                run.pop("input", None)
            return body

        @app.route("/api/organization", methods=("GET",))
        def organizations(req: Request):
            return self._forward(req, "GET", "organization")

        # untimed: relayed long polls block for the upstream wait window
        @app.route("/api/event", methods=("GET",), untimed=True)
        def events(req: Request):
            # event long-poll relay: a central algorithm's
            # wait_for_results blocks HERE (query params — since/wait —
            # pass through) and wakes on its subtasks' status events
            return self._forward(req, "GET", "event")

        @app.route("/api/health", methods=("GET",))
        def health(req: Request):
            return {"status": "ok", "proxy": True}

        @app.route("/api/metrics", methods=("GET",))
        def metrics(req: Request):
            """NODE-process telemetry (Prometheus text): the daemon's
            wire/REST/tracing counters live in this process, not the
            server's — operators scrape each node here. Trace context
            relays transparently: the container's `traceparent` header
            joins the proxy's server span, and `pooled_request` forwards
            the continuation upstream on every relayed call."""
            from vantage6_tpu_torch.common.telemetry import (
                PROMETHEUS_CONTENT_TYPE,
                REGISTRY,
            )
            from vantage6_tpu_torch.server.web import Response

            return Response(
                REGISTRY.render_prometheus(),
                headers={"Content-Type": PROMETHEUS_CONTENT_TYPE},
            )

    def _token_task_id(self, req: Request) -> int:
        """Best-effort read of the container token's task id (unverified
        here — the server re-verifies; the proxy just needs routing info)."""
        import json as _json

        token = req.bearer_token or ""
        try:
            payload = token.split(".")[1]
            payload += "=" * (-len(payload) % 4)
            claims = _json.loads(base64.urlsafe_b64decode(payload))
            return int(claims["sub"]["task_id"])
        except Exception:
            raise HTTPError(401, "malformed container token") from None

    # ---------------------------------------------------------------- serve
    def serve(self, host: str = "127.0.0.1", port: int = 0) -> AppServer:
        server = AppServer(self.app, host, port)
        server.start_background()
        log.info("node proxy on %s", server.url)
        return server
