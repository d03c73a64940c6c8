"""Shared REST transport: bearer auth, error mapping, refresh, pagination,
and a process-wide keep-alive connection pool.

One HTTP wrapper for every client in the stack (UserClient, NodeDaemon,
RestAlgorithmClient) so wire behavior — bearer header, JSON-or-empty bodies,
>=400 error mapping, 401 refresh retry, page draining — lives in one place.
(The node proxy is a *relay*, not a client: it forwards foreign tokens
verbatim and keeps its own thin forwarding code — but it relays over the
same pooled transport via `pooled_request`.)

Connection pooling: `requests.Session` objects are checked out of a
per-host pool (`_SessionPool`) for the duration of one HTTP request and
returned afterwards, so every daemon/client call rides an already-open
keep-alive socket instead of paying TCP (+TLS) setup per call. Sessions
are never shared between threads concurrently — checkout IS the thread
ownership — and a request that dies on a stale keep-alive socket (the
server closed an idle persistent connection) is retried exactly once on a
fresh session; the stale one is discarded, not repooled.

Accounting: every request feeds `REST_STATS` (calls, request/response
bytes, seconds, stale-socket retries) — `runtime.metrics.rest_stats_snapshot`
exposes it to the bench/observability consumers; diff two snapshots to
scope the counters to one round or bench arm.

The port's copy of ``vantage6_tpu/common/rest.py``, with one difference:
``requests`` is imported by the functions that send (``_requests``), not
by the module, so the module imports where the package is missing and
the first request there raises naming it.
"""
from __future__ import annotations

import re
import threading
import time
from typing import Any, Callable
from urllib.parse import urlsplit

from vantage6_tpu_torch.runtime.tracing import TRACER

# low-cardinality span names: /api/run/17 and /api/run/99 are the same hop
_ID_SEGMENT = re.compile(r"/\d+")


def _requests():
    """The ``requests`` package, imported on first use."""
    try:
        import requests
    except ImportError as e:
        raise RuntimeError(
            "the 'requests' package is required for REST calls but is not "
            "installed"
        ) from e
    return requests


class RestError(RuntimeError):
    """Server returned an error status."""

    def __init__(self, status: int, msg: str):
        super().__init__(f"HTTP {status}: {msg}")
        self.status = status
        self.msg = msg


class RestStats:
    """Thread-safe process-wide REST accounting (shape mirrors
    serialization.WireStats so consumers diff snapshots the same way)."""

    _FIELDS = (
        "calls", "errors", "stale_retries",
        "bytes_sent", "bytes_received", "seconds",
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            for f in self._FIELDS:
                setattr(self, f, 0.0 if f == "seconds" else 0)

    def record(
        self, sent: int, received: int, seconds: float,
        error: bool = False, stale_retry: bool = False,
    ) -> None:
        with self._lock:
            self.calls += 1
            self.errors += int(error)
            self.stale_retries += int(stale_retry)
            self.bytes_sent += int(sent)
            self.bytes_received += int(received)
            self.seconds += float(seconds)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {f: getattr(self, f) for f in self._FIELDS}


REST_STATS = RestStats()


class _SessionPool:
    """Per-host pool of `requests.Session` objects.

    `acquire` pops an idle session (or creates one); `release` repools it
    up to `max_idle` per host — beyond that the session is closed, so a
    burst of threads doesn't pin sockets forever. A session is owned by
    exactly one thread between acquire and release, which is what makes
    `requests.Session` reuse thread-safe here.
    """

    def __init__(self, max_idle: int = 8):
        self.max_idle = max_idle
        self._lock = threading.Lock()
        self._idle: dict[str, list[Any]] = {}  # guarded-by: _lock

    @staticmethod
    def _key(url: str) -> str:
        parts = urlsplit(url)
        return f"{parts.scheme}://{parts.netloc}"

    def acquire(self, url: str) -> Any:
        key = self._key(url)
        with self._lock:
            stack = self._idle.get(key)
            if stack:
                return stack.pop()
        return _requests().Session()

    def release(self, url: str, session: Any) -> None:
        key = self._key(url)
        with self._lock:
            stack = self._idle.setdefault(key, [])
            if len(stack) < self.max_idle:
                stack.append(session)
                return
        session.close()

    def discard(self, session: Any) -> None:
        """A session whose socket went stale: close, never repool."""
        try:
            session.close()
        except Exception:
            pass

    def clear(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, {}
        for stack in idle.values():
            for s in stack:
                s.close()


POOL = _SessionPool()


def pooled_request(
    method: str,
    url: str,
    *,
    json_body: Any = None,
    params: dict[str, Any] | None = None,
    headers: dict[str, str] | None = None,
    timeout: float | None = None,
) -> Any:
    """One HTTP request over the shared keep-alive pool.

    IDEMPOTENT requests (GET/HEAD/OPTIONS) retry exactly once on a stale
    keep-alive socket (ConnectionError): the server closing an idle
    persistent connection is an expected hazard of pooling, and the
    retried request rides a fresh socket. A second failure propagates —
    that is a *down* server, not a stale socket. POST/PATCH/DELETE never
    retry here: a connection that died mid-response may have been
    PROCESSED (ECONNRESET after commit is indistinguishable from a stale
    socket), and a silent re-send would duplicate the side effect — e.g.
    create a task fan-out twice.

    Tracing: when the calling thread is inside a sampled trace, the
    request carries a `traceparent` header (the server joins the trace)
    and the hop itself is recorded as a `rest` span — that is the
    client-encode→REST-hop attribution of docs/observability.md. Outside
    a trace this adds one thread-local read and nothing else.
    """
    ctx = TRACER.current_context()
    if ctx is not None:
        if ctx.sampled:
            path = _ID_SEGMENT.sub("/<id>", urlsplit(url).path)
            with TRACER.span(
                f"rest {method.upper()} {path}", kind="rest",
                attrs={"url_path": path},
            ):
                # inject INSIDE the span: the server's handler span must
                # parent on this REST hop (hop minus nested server span =
                # network/transport overhead), not on the outer caller
                hdrs = dict(headers or {})
                hdrs.setdefault(
                    "traceparent", TRACER.current_traceparent()
                )
                return _pooled_request_impl(
                    method, url, json_body=json_body, params=params,
                    headers=hdrs, timeout=timeout,
                )
        headers = dict(headers or {})
        headers.setdefault("traceparent", ctx.to_traceparent())
    return _pooled_request_impl(
        method, url, json_body=json_body, params=params,
        headers=headers, timeout=timeout,
    )


def _pooled_request_impl(
    method: str,
    url: str,
    *,
    json_body: Any = None,
    params: dict[str, Any] | None = None,
    headers: dict[str, str] | None = None,
    timeout: float | None = None,
) -> Any:
    requests = _requests()
    t0 = time.perf_counter()
    stale_retry = False
    session = POOL.acquire(url)
    try:
        try:
            resp = session.request(
                method, url, json=json_body, params=params,
                headers=headers, timeout=timeout,
            )
        except requests.exceptions.ConnectionError:
            POOL.discard(session)
            if method.upper() not in ("GET", "HEAD", "OPTIONS"):
                raise
            stale_retry = True
            session = POOL.acquire(url)
            resp = session.request(
                method, url, json=json_body, params=params,
                headers=headers, timeout=timeout,
            )
    except Exception:
        POOL.discard(session)
        REST_STATS.record(
            0, 0, time.perf_counter() - t0,
            error=True, stale_retry=stale_retry,
        )
        raise
    POOL.release(url, session)
    req_bytes = len(resp.request.body or b"") if resp.request is not None else 0
    REST_STATS.record(
        req_bytes, len(resp.content or b""), time.perf_counter() - t0,
        error=resp.status_code >= 400, stale_retry=stale_retry,
    )
    return resp


class RestSession:
    """``request()`` + ``paginate()`` against one base URL.

    ``refresh`` (optional) is called on a 401; returning True retries the
    request once with whatever new token ``token_getter`` now yields.

    The underlying sockets come from the process-wide pool, so two
    `RestSession` objects against the same host share warm connections —
    a daemon's short-lived re-auth sessions no longer pay TCP setup.
    """

    def __init__(
        self,
        base_url: str,
        token_getter: Callable[[], str | None] = lambda: None,
        refresh: Callable[[], bool] | None = None,
    ):
        self.base_url = base_url.rstrip("/")
        self._token_getter = token_getter
        self._refresh = refresh

    def request(
        self,
        method: str,
        endpoint: str,
        json_body: Any = None,
        params: dict[str, Any] | None = None,
        _retry: bool = True,
        timeout: float | None = None,
        raw: bool = False,
    ) -> Any:
        """JSON request/response; ``raw=True`` returns the response body
        as text instead (non-JSON endpoints: /api/metrics Prometheus
        exposition)."""
        # fault injection (V6T_FAULTS rest500): fail the request before it
        # touches the wire, so retry/rotation paths see a real RestError
        from vantage6_tpu_torch.common.faults import FAULTS

        injected = FAULTS.rest_status(endpoint)
        if injected:
            raise RestError(
                injected, f"injected fault (V6T_FAULTS rest500) on {endpoint}"
            )
        headers = {}
        token = self._token_getter()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        resp = pooled_request(
            method,
            f"{self.base_url}/api/{endpoint.lstrip('/')}",
            json_body=json_body,
            params=params,
            headers=headers,
            timeout=timeout,
        )
        if (
            resp.status_code == 401
            and _retry
            and self._refresh is not None
            and self._refresh()
        ):
            return self.request(
                method, endpoint, json_body, params, False, timeout, raw
            )
        if raw:
            if resp.status_code >= 400:
                raise RestError(resp.status_code, resp.text[:200])
            return resp.text
        body = resp.json() if resp.content else {}
        if resp.status_code >= 400:
            raise RestError(resp.status_code, body.get("msg", resp.text))
        return body

    def paginate(
        self, endpoint: str, params: dict[str, Any] | None = None
    ) -> list[dict[str, Any]]:
        """Drain ALL pages of a `{"data": [...], "pagination": {...}}`
        endpoint — silent first-page truncation loses runs/nodes."""
        return _paginate_impl(self, endpoint, params)


def await_task_finished(
    client: Any,
    task_id: int,
    interval: float,
    timeout: float,
    wait_cap: float = 10.0,
) -> Any:
    """Block until `task_id` reaches a terminal status; returns the
    TaskStatus. Shared by UserClient and RestAlgorithmClient.

    Event-driven against a long-poll-capable server (or node proxy): each
    cycle re-checks the task (the anti-entropy truth — events can be
    evicted, and the caller's rooms may not cover the task's
    collaboration), then blocks on `GET event?since=<cursor>&wait=S`,
    waking the moment anything lands in the caller's rooms. Capability is
    probed once per client (`client._event_push`: None=unknown) via the
    response's `long_poll` flag; servers without it — or any event-fetch
    error — demote the client to fixed-`interval` sleeps, the previous
    behavior, permanently for that client object.
    """
    from vantage6_tpu_torch.common.enums import TaskStatus

    deadline = time.time() + timeout
    cursor: int | None = None
    # empty-wait window: starts near `interval` and doubles per EMPTY
    # long poll up to wait_cap. When the caller's rooms cover the task
    # this never matters (the poll wakes on the event); when they DON'T
    # (an event-less finish is possible — e.g. rooms not covering the
    # collaboration), the window bounds the detection latency for short
    # tasks while still decaying the request rate for long ones.
    wait_base = max(0.2, min(interval, wait_cap))
    wait_cur = wait_base
    while True:
        task = client.request("GET", f"task/{task_id}")
        status = TaskStatus(task["status"])
        if status.is_finished:
            return status
        now = time.time()
        if now > deadline:
            raise TimeoutError(
                f"task {task_id} still {status.value} after {timeout}s"
            )
        if getattr(client, "_event_push", None) is False:
            time.sleep(max(0.05, min(interval, deadline - now)))
            continue
        try:
            if cursor is None:
                # cursor probe: tail from NOW, don't replay the buffer
                batch = client.request(
                    "GET", "event", params={"since": -1}, timeout=30.0
                )
            else:
                wait_s = max(0.2, min(wait_cur, wait_cap, deadline - now))
                batch = client.request(
                    "GET", "event",
                    # only run-status traffic should wake a result waiter
                    params={"since": cursor, "wait": wait_s,
                            "names": "status-update"},
                    timeout=wait_s + 30.0,
                )
            wait_cur = (
                wait_base if batch.get("data")
                else min(wait_cur * 2, wait_cap)
            )
        except Exception:
            client._event_push = False  # old server/proxy: poll instead
            continue
        if not batch.get("long_poll"):
            client._event_push = False
            continue
        client._event_push = True
        # adopt the server's cursor either way — a regression means a
        # restarted server (fresh sequence space), and the task GET at the
        # top of the loop is the ground truth regardless of event loss
        cursor = int(batch.get("cursor", 0))


def _paginate_impl(
    session: "RestSession", endpoint: str, params: dict[str, Any] | None
) -> list[dict[str, Any]]:
    params = dict(params or {})
    params.setdefault("per_page", 250)
    out: list[dict[str, Any]] = []
    page = 1
    while True:
        params["page"] = page
        body = session.request("GET", endpoint, params=params)
        data = body.get("data", [])
        out.extend(data)
        total = body.get("pagination", {}).get("total", len(out))
        if len(out) >= total or not data:
            return out
        page += 1
