"""Minimal WSGI web framework for the control-plane services.

Parity: the reference's servers are Flask apps (SURVEY.md §2 items 1, 3);
Flask is not in this image, so this module supplies the slice of it the
control plane needs: routing with typed path params, JSON request/response,
auth hooks, error handling, a threaded dev server, and an in-process test
client (Flask's `app.test_client()` equivalent — SURVEY.md §4 test strategy).
"""
from __future__ import annotations

import io
import json
import re
import threading
import time
import traceback
from typing import Any, Callable
from urllib.parse import parse_qs
from socketserver import ThreadingMixIn
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

from vantage6_tpu_torch.common.log import setup_logging
from vantage6_tpu_torch.common.telemetry import REGISTRY
from vantage6_tpu_torch.runtime.tracing import TRACER, parse_traceparent

log = setup_logging("vantage6_tpu_torch/web")

# process-wide HTTP telemetry (covers every App in the process: the
# control-plane server AND the node proxy relay)
_HTTP_REQUESTS = REGISTRY.counter("v6t_http_requests_total")
_HTTP_ERRORS = REGISTRY.counter("v6t_http_errors_total")
_HTTP_SECONDS = REGISTRY.histogram("v6t_http_request_seconds")


_UNPARSED = object()


class HTTPError(Exception):
    def __init__(self, status: int, msg: str = ""):
        super().__init__(msg)
        self.status = status
        self.msg = msg or {
            400: "bad request",
            401: "unauthorized",
            403: "forbidden",
            404: "not found",
            409: "conflict",
        }.get(status, "error")


class Request:
    def __init__(
        self,
        method: str,
        path: str,
        query: dict[str, list[str]],
        headers: dict[str, str],
        body: bytes,
    ):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body
        self.identity: dict[str, Any] | None = None  # set by auth middleware
        self._json: Any = _UNPARSED

    @property
    def json(self) -> Any:
        if self._json is _UNPARSED:
            if not self.body:
                self._json = {}
            else:
                try:
                    self._json = json.loads(self.body)
                except json.JSONDecodeError:
                    raise HTTPError(400, "invalid JSON body") from None
        return self._json

    def arg(self, name: str, default: str | None = None) -> str | None:
        vals = self.query.get(name)
        return vals[0] if vals else default

    def int_arg(self, name: str, default: int | None = None) -> int | None:
        v = self.arg(name)
        if v is None:
            return default
        try:
            return int(v)
        except ValueError:
            raise HTTPError(400, f"query param {name!r} must be an int") from None

    @property
    def bearer_token(self) -> str | None:
        h = self.headers.get("authorization", "")
        return h[7:] if h.lower().startswith("bearer ") else None

    @property
    def page(self) -> int:
        return max(1, self.int_arg("page", 1))

    @property
    def per_page(self) -> int:
        return min(250, max(1, self.int_arg("per_page", 50)))


class Response:
    def __init__(
        self,
        data: Any = None,
        status: int = 200,
        headers: dict[str, str] | None = None,
    ):
        self.status = status
        self.headers = headers or {}
        if isinstance(data, (bytes, str)):
            self.body = data.encode() if isinstance(data, str) else data
            self.headers.setdefault("Content-Type", "text/plain")
        else:
            self.body = json.dumps(data if data is not None else {}).encode()
            self.headers.setdefault("Content-Type", "application/json")


_PARAM_RE = re.compile(r"<(?:(int|str):)?(\w+)>")
# replica-local: code-derived constant, identical on every replica
_STATUS_TEXT = {
    200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request",
    401: "Unauthorized", 403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 409: "Conflict", 500: "Internal Server Error",
}

Handler = Callable[..., Any]


class App:
    """Route registry + WSGI callable."""

    def __init__(self, name: str = "app", replica_id: str | None = None):
        self.name = name
        # stamped on every request span: with N replicas over one store,
        # trace_view attributes per-hop latency to the replica that served
        # it (empty for single-purpose apps like the store service)
        self.replica_id = replica_id
        # (regex, {method: handler}, original pattern — the low-cardinality
        # span/metric label: "/api/run/<int:id>" instead of "/api/run/17")
        # replica-local: route table built from code at startup
        self._routes: list[
            tuple[re.Pattern[str], dict[str, Handler], str]
        ] = []
        # route patterns excluded from the latency histogram: long-poll
        # endpoints block by DESIGN (up to 25 s) and would otherwise
        # dominate the p95 the metric exists to report. Declared at
        # registration (`untimed=True`) — route semantics belong to the
        # route, not to query-param sniffing in the shared request path.
        # replica-local: declared from code at route registration
        self._untimed: set[str] = set()
        self._auth_hook: Callable[[Request], None] | None = None

    def route(
        self,
        pattern: str,
        methods: tuple[str, ...] = ("GET",),
        untimed: bool = False,
    ):
        regex = self._compile(pattern)
        if untimed:
            self._untimed.add(pattern)
        def deco(fn: Handler) -> Handler:
            for existing, table, _pat in self._routes:
                if existing.pattern == regex.pattern:
                    for m in methods:
                        table[m] = fn
                    return fn
            self._routes.append((regex, {m: fn for m in methods}, pattern))
            return fn
        return deco

    @staticmethod
    def _compile(pattern: str) -> re.Pattern[str]:
        out = []
        pos = 0
        for m in _PARAM_RE.finditer(pattern):
            out.append(re.escape(pattern[pos : m.start()]))
            typ = m.group(1) or "str"
            name = m.group(2)
            out.append(
                f"(?P<{name}>\\d+)" if typ == "int" else f"(?P<{name}>[^/]+)"
            )
            pos = m.end()
        out.append(re.escape(pattern[pos:]))
        return re.compile("^" + "".join(out) + "$")

    def set_auth_hook(self, hook: Callable[[Request], None]) -> None:
        """Runs before every handler; sets request.identity or raises 401."""
        self._auth_hook = hook

    # ---------------------------------------------------------------- serve
    def handle(self, request: Request) -> Response:
        for regex, table, pattern in self._routes:
            m = regex.match(request.path)
            if not m:
                continue
            handler = table.get(request.method)
            if handler is None:
                return Response({"msg": "method not allowed"}, 405)
            kwargs = {
                k: int(v) if v.isdigit() else v
                for k, v in m.groupdict().items()
            }
            t0 = time.perf_counter()
            _HTTP_REQUESTS.inc()
            # long-poll routes are counted but not timed (see _untimed)
            observe = pattern not in self._untimed
            # join the caller's trace when the request carries one
            # (require_parent: a bare poll must not mint a root trace per
            # request); the span stays current for the handler's own
            # child spans and any onward pooled_request relays
            parent = parse_traceparent(
                request.headers.get("traceparent")
            )
            with TRACER.span(
                f"http {request.method} {pattern}", kind="server",
                parent=parent, service=self.name, require_parent=True,
            ) as span:
                if self.replica_id:
                    span.set_attr(replica=self.replica_id)
                try:
                    if self._auth_hook is not None:
                        self._auth_hook(request)
                    out = handler(request, **kwargs)
                except HTTPError as e:
                    span.set_attr(status_code=e.status)
                    if e.status >= 500:
                        span.set_status("error")
                        _HTTP_ERRORS.inc()
                    if observe:
                        _HTTP_SECONDS.observe(time.perf_counter() - t0)
                    return Response({"msg": e.msg}, e.status)
                except Exception:
                    # the log record carries trace_id/span_id (the handler
                    # span is current here — TraceContextFilter), so this
                    # 500 is joinable to the request's trace in a dump
                    log.error(
                        "500 on %s %s\n%s",
                        request.method,
                        request.path,
                        traceback.format_exc(limit=8),
                    )
                    try:
                        from vantage6_tpu_torch.common.flight import FLIGHT

                        FLIGHT.note(
                            "http_500", method=request.method,
                            path=request.path, route=pattern,
                        )
                    except Exception:  # pragma: no cover
                        pass
                    span.set_status("error")
                    _HTTP_ERRORS.inc()
                    if observe:
                        _HTTP_SECONDS.observe(time.perf_counter() - t0)
                    return Response({"msg": "internal server error"}, 500)
            if observe:
                _HTTP_SECONDS.observe(time.perf_counter() - t0)
            if isinstance(out, Response):
                return out
            if isinstance(out, tuple):
                return Response(out[0], out[1])
            return Response(out)
        return Response({"msg": "not found"}, 404)

    def __call__(self, environ: dict[str, Any], start_response: Callable):
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        body = environ["wsgi.input"].read(length) if length else b""
        headers = {
            k[5:].replace("_", "-").lower(): v
            for k, v in environ.items()
            if k.startswith("HTTP_")
        }
        if environ.get("CONTENT_TYPE"):
            headers["content-type"] = environ["CONTENT_TYPE"]
        request = Request(
            method=environ["REQUEST_METHOD"],
            path=environ.get("PATH_INFO", "/"),
            query=parse_qs(environ.get("QUERY_STRING", "")),
            headers=headers,
            body=body,
        )
        resp = self.handle(request)
        status_line = f"{resp.status} {_STATUS_TEXT.get(resp.status, 'Status')}"
        start_response(status_line, list(resp.headers.items()))
        return [resp.body]


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, fmt: str, *args: Any) -> None:  # noqa: A003
        log.debug("%s %s", self.address_string(), fmt % args)


class _ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    """Thread-per-request WSGI server. REQUIRED, not an optimization: the
    server's store proxy calls the store, which calls back into this same
    server's /api/whoami for the trust handshake — on a serial server that
    re-entrancy is a deadlock. The db layer keeps one sqlite connection per
    thread for exactly this server model (server/db.py)."""

    daemon_threads = True
    # federation-scale accept queue: 32+ nodes polling plus a researcher
    # burst overflows the wsgiref default of 5 and resets connections
    request_queue_size = 128


class AppServer:
    """Threaded HTTP server wrapper with background start/stop (used by the
    node daemon's proxy and by `v6t server start`)."""

    def __init__(self, app: App, host: str = "127.0.0.1", port: int = 0):
        self._server = make_server(
            host, port, app,
            server_class=_ThreadingWSGIServer, handler_class=_QuietHandler,
        )
        self.host, self.port = self._server.server_address[:2]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start_background(self) -> "AppServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)


class TestClient:
    """In-process client calling the WSGI app directly (no sockets)."""

    def __init__(self, app: App):
        self.app = app
        self.token: str | None = None

    def open(
        self,
        method: str,
        path: str,
        json_body: Any = None,
        headers: dict[str, str] | None = None,
        token: str | None = None,
    ) -> "TestResponse":
        query: dict[str, list[str]] = {}
        if "?" in path:
            path, _, qs = path.partition("?")
            query = parse_qs(qs)
        hdrs = {k.lower(): v for k, v in (headers or {}).items()}
        tok = token or self.token
        if tok:
            hdrs.setdefault("authorization", f"Bearer {tok}")
        body = b""
        if json_body is not None:
            body = json.dumps(json_body).encode()
            hdrs.setdefault("content-type", "application/json")
        req = Request(method, path, query, hdrs, body)
        resp = self.app.handle(req)
        return TestResponse(resp)

    def get(self, path: str, **kw: Any) -> "TestResponse":
        return self.open("GET", path, **kw)

    def post(self, path: str, json_body: Any = None, **kw: Any) -> "TestResponse":
        return self.open("POST", path, json_body, **kw)

    def patch(self, path: str, json_body: Any = None, **kw: Any) -> "TestResponse":
        return self.open("PATCH", path, json_body, **kw)

    def delete(self, path: str, **kw: Any) -> "TestResponse":
        return self.open("DELETE", path, **kw)


class TestResponse:
    def __init__(self, resp: Response):
        self.status = resp.status
        self.body = resp.body
        self.headers = resp.headers

    @property
    def json(self) -> Any:
        return json.loads(self.body) if self.body else None

    def __repr__(self) -> str:
        return f"<TestResponse {self.status} {self.body[:200]!r}>"
