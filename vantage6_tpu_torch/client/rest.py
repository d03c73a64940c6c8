"""RestAlgorithmClient — the in-container SDK over HTTP.

Parity: vantage6-algorithm-tools AlgorithmClient (SURVEY.md §2 item 17) in
its *real* deployment shape: a containerized algorithm talks to its node's
proxy server with the container JWT from TOKEN_FILE; the proxy relays to the
control plane and handles org-key encryption. Method surface matches the
in-process `AlgorithmClient` so algorithm code is identical on-pod and
containerized (the reference's central fns run unchanged too).
"""
from __future__ import annotations

from typing import Any

from vantage6_tpu_torch.common.rest import RestSession
from vantage6_tpu_torch.common.serialization import deserialize, serialize


class RestAlgorithmClient:
    def __init__(self, url: str, token_file: str = "", token: str = ""):
        self.base_url = url.rstrip("/")
        if not token and token_file:
            with open(token_file) as f:
                token = f.read().strip()
        self.token = token
        self._rest = RestSession(self.base_url, token_getter=lambda: self.token)
        # event long-poll capability through the node proxy (None until
        # probed; see common.rest.await_task_finished) — an old proxy
        # without the /api/event forward demotes this client to polling
        self._event_push: bool | None = None
        # gradient compression for containerized algorithm code: armed by
        # the node operator via V6T_COMPRESS (docs/compression.md); lazy —
        # the fed/torch import only happens when compression is armed
        self._compressor: Any = None
        self.task = _TaskSub(self)
        self.result = _ResultSub(self)
        self.run = _RunSub(self)
        self.organization = _OrgSub(self)

    def _delta_compressor(self):
        if self._compressor is None:
            from vantage6_tpu_torch.fed.compression import (
                DeltaCompressor,
                spec_from_env,
            )

            spec = spec_from_env()
            self._compressor = (
                DeltaCompressor(spec) if spec is not None else False
            )
        return self._compressor or None

    # ------------------------------------------------- gradient compression
    # Surface parity with the in-process AlgorithmClient: same two calls,
    # pass-throughs unless the node armed V6T_COMPRESS. NOTE: under
    # mode="sandbox" each run is a fresh subprocess, so error-feedback
    # accumulators only persist for inline/persistent algorithm processes.
    def compress_update(self, tree: Any, name: str = "update") -> Any:
        comp = self._delta_compressor()
        return comp.compress(tree, name) if comp is not None else tree

    def decompress_update(self, payload: Any) -> Any:
        # pass-throughs must not pull in fed/: test the wire tag
        # inline (compression.WIRE_TAG — pinned by
        # tests/test_compression.py::test_rest_client_tag_literal_in_sync)
        if not (isinstance(payload, dict) and "v6t.compressed" in payload):
            return payload
        from vantage6_tpu_torch.fed.compression import decompress_wire_tree

        return decompress_wire_tree(payload)

    # ------------------------------------------------------------------ http
    def request(
        self,
        method: str,
        endpoint: str,
        json_body: Any = None,
        params: dict[str, Any] | None = None,
        timeout: float | None = None,
    ) -> Any:
        return self._rest.request(
            method, endpoint, json_body, params, timeout=timeout
        )

    def paginate(
        self, endpoint: str, params: dict[str, Any] | None = None
    ) -> list[dict[str, Any]]:
        return self._rest.paginate(endpoint, params)

    # --------------------------------------------------------------- results
    def wait_for_results(
        self, task_id: int, interval: float = 1.0, timeout: float = 600.0
    ) -> list[Any]:
        """Wait for a subtask fan-out — event-driven when the node proxy
        forwards the server's long-poll event stream (a central algorithm
        then wakes on its partials' completion events instead of paying up
        to `interval` of dead time per wave); fixed-interval polling
        against an older proxy."""
        from vantage6_tpu_torch.common.rest import await_task_finished

        status = await_task_finished(self, task_id, interval, timeout)
        if status.has_failed:
            raise RuntimeError(f"subtask {task_id} {status.value}")
        runs = self.paginate(f"task/{task_id}/run")
        out = []
        for run in sorted(runs, key=lambda r: r["id"]):
            blob = run.get("result")
            # the proxy has already decrypted: blob is base64 of the
            # serialized payload
            # writable: results land in algorithm code (may mutate, v1
            # semantics — the v2 zero-copy view is read-only)
            out.append(
                deserialize(_unb64(blob), writable=True) if blob else None
            )
        return out


def _unb64(data: str) -> bytes:
    import base64

    return base64.b64decode(data)


class _TaskSub:
    def __init__(self, parent: RestAlgorithmClient):
        self.parent = parent

    def create(
        self,
        input_: dict[str, Any],
        organizations: list[int],
        name: str = "subtask",
        **kw: Any,
    ) -> dict[str, Any]:
        """POST to the node proxy, which encrypts the input per org and
        fills in image/collaboration from the container's context."""
        import base64

        return self.parent.request(
            "POST",
            "task",
            {
                "name": name,
                "organizations": list(organizations),
                "input": base64.b64encode(serialize(input_)).decode(),
                "databases": kw.get("databases", []),
            },
        )

    def get(self, task_id: int) -> dict[str, Any]:
        return self.parent.request("GET", f"task/{task_id}")


class _ResultSub:
    def __init__(self, parent: RestAlgorithmClient):
        self.parent = parent

    def get(self, task_id: int) -> list[Any]:
        return self.parent.wait_for_results(task_id)


class _RunSub:
    def __init__(self, parent: RestAlgorithmClient):
        self.parent = parent

    def from_task(self, task_id: int) -> list[dict[str, Any]]:
        return self.parent.paginate(f"task/{task_id}/run")


class _OrgSub:
    def __init__(self, parent: RestAlgorithmClient):
        self.parent = parent

    def list(self) -> list[dict[str, Any]]:
        return self.parent.request("GET", "organization")["data"]
