"""WebSocket push bridge for the event hub.

Parity: the reference's SocketIO websocket (SURVEY.md §2 item 6) — nodes
and UIs get events PUSHED instead of polling the REST cursor. The cursor
endpoint remains the reconnect/catch-up path (exactly the reference's
`sync_task_queue_with_server` split: socket for liveness, sync for gaps).

Protocol (JSON messages over one websocket):

    client -> {"token": "<jwt>", "since": <cursor|0>}
    server -> {"connected": true, "cursor": N}
    server -> {"event": {seq, name, room, data, ts}}   (pushed, incl. any
               events after `since` replayed first)
    client -> {"ping": t}     server -> {"pong": t}
"""
from __future__ import annotations

import json
import queue
import threading
from typing import TYPE_CHECKING, Any

# `websockets` is OPTIONAL: the REST cursor remains the full-fidelity event
# path, so servers without the package simply run pull-only. Import errors
# surface on bridge construction, not module import.
try:
    from websockets.sync.server import serve
except ModuleNotFoundError as _e:  # pragma: no cover - exercised in CI env
    serve = None
    _WEBSOCKETS_ERROR: Exception | None = _e
else:
    _WEBSOCKETS_ERROR = None

from vantage6_tpu_torch.common.log import setup_logging
from vantage6_tpu_torch.server.resources import _rooms_for, identity_from_token
from vantage6_tpu_torch.server.web import HTTPError

if TYPE_CHECKING:  # pragma: no cover
    from vantage6_tpu_torch.server.app import ServerApp

log = setup_logging("vantage6_tpu_torch/server.ws")


class WebSocketBridge:
    def __init__(self, srv: "ServerApp", host: str = "127.0.0.1", port: int = 0):
        if _WEBSOCKETS_ERROR is not None:
            raise RuntimeError(
                "the 'websockets' package is required for the event push "
                "bridge but is not installed; nodes fall back to the REST "
                "event cursor"
            ) from _WEBSOCKETS_ERROR
        self.srv = srv
        self._server = serve(self._handler, host, port)
        self.host, self.port = self._server.socket.getsockname()[:2]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"ws://{self.host}:{self.port}"

    def start_background(self) -> "WebSocketBridge":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        self.srv.ws_url = self.url
        log.info("event websocket on %s", self.url)
        return self

    def stop(self) -> None:
        self._server.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        if getattr(self.srv, "ws_url", None) == self.url:
            self.srv.ws_url = None

    # ---------------------------------------------------------------- serve
    def _handler(self, ws: Any) -> None:
        try:
            hello = json.loads(ws.recv(timeout=10))
        except Exception:
            ws.close(1002, "expected auth message")
            return
        try:
            kind, principal = identity_from_token(self.srv, hello.get("token"))
        except HTTPError as e:
            ws.send(json.dumps({"error": e.msg}))
            ws.close(1008, "unauthorized")
            return
        rooms = _rooms_for(self.srv, kind, principal)
        q: queue.Queue = queue.Queue(maxsize=1024)
        overflowed = threading.Event()

        def push(event: Any) -> None:
            try:
                q.put_nowait(event)
            except queue.Full:
                # a silently dropped event on a HEALTHY socket would never
                # be re-delivered — flag it so the handler closes the
                # connection, forcing the client onto its cursor catch-up
                overflowed.set()

        sid = self.srv.hub.subscribe(push, rooms)
        try:
            ws.send(
                json.dumps({"connected": True, "cursor": self.srv.hub.cursor})
            )
            # replay anything after the client's cursor BEFORE live events
            for ev in self.srv.hub.fetch(int(hello.get("since", 0)), rooms):
                ws.send(json.dumps({"event": ev.to_dict()}))
            while True:
                if overflowed.is_set():
                    ws.close(1013, "event overflow; re-sync via cursor")
                    break
                # interleave pushes with (optional) client pings
                try:
                    ev = q.get(timeout=0.25)
                    ws.send(json.dumps({"event": ev.to_dict()}))
                except queue.Empty:
                    pass
                try:
                    msg = ws.recv(timeout=0)
                    data = json.loads(msg)
                    if "ping" in data:
                        ws.send(json.dumps({"pong": data["ping"]}))
                except TimeoutError:
                    continue
                except Exception:
                    break  # closed / bad frame
        except Exception:
            pass  # connection ended
        finally:
            self.srv.hub.unsubscribe(sid)
