"""Logging setup: colored console + rotating file logs + trace correlation.

Parity: vantage6-common logging (SURVEY.md §2 item 24) — every long-running
instance (server, node, store) logs to its own rotating file under the
instance's log dir plus a colored console stream.

On top of the parity layer, every logger configured here is part of the
ops plane (docs/observability.md):

- **Trace correlation** — a `TraceContextFilter` stamps `trace_id` /
  `span_id` from the active tracer span (`runtime.tracing`) onto every
  record, so a log line emitted inside a federated round carries the key
  that joins it to the round's spans. Console/file output appends a
  short `[trace=...]` suffix when present; the structured sinks carry
  the full ids.
- **Structured JSONL sink** — `V6T_LOG_JSON=path` (or
  `enable_json_sink(path)` at runtime) appends one JSON object per
  record: `{ts, level, logger, msg, trace_id, span_id, thread}`. This is
  the machine-readable stream `tools/doctor.py` interleaves with spans.
- **Flight-recorder tap** — every record is mirrored (cheap bounded-ring
  append) into `common.flight.FLIGHT`, so a crash dump always contains
  the last few thousand log records even when no JSON sink was on.

The port's copy of ``vantage6_tpu/common/log.py``: framework-free, the
same handlers, record shape and ``V6T_LOG_JSON`` sink, tapping the port's
tracer and flight recorder.
"""
from __future__ import annotations

import json
import logging
import logging.handlers
import sys
import threading
from pathlib import Path

_COLORS = {
    logging.DEBUG: "\033[36m",     # cyan
    logging.INFO: "\033[32m",      # green
    logging.WARNING: "\033[33m",   # yellow
    logging.ERROR: "\033[31m",     # red
    logging.CRITICAL: "\033[35m",  # magenta
}
_RESET = "\033[0m"

FORMAT = "%(asctime)s %(levelname)-8s %(name)s | %(message)s"
DATEFMT = "%H:%M:%S"


class TraceContextFilter(logging.Filter):
    """Stamp the active tracer context onto every record.

    `record.trace_id` / `record.span_id` are always set (empty string
    outside a span) so formatters may reference them unconditionally.
    The tracer import is lazy and cached: configuring a logger must not
    pull the tracing module into processes that never trace, and a
    missing/broken tracer degrades to empty ids, never to a log failure.
    """

    _provider = None
    _provider_failed = False

    def filter(self, record: logging.LogRecord) -> bool:
        ids = None
        cls = TraceContextFilter
        if cls._provider is None and not cls._provider_failed:
            try:
                from vantage6_tpu_torch.runtime.tracing import current_trace_ids

                cls._provider = staticmethod(current_trace_ids)
            except Exception:  # pragma: no cover - broken install
                cls._provider_failed = True
        if cls._provider is not None:
            try:
                ids = cls._provider()
            except Exception:  # pragma: no cover - tracer must not break logs
                ids = None
        record.trace_id = ids[0] if ids else ""
        record.span_id = ids[1] if ids else ""
        return True


class TraceFormatter(logging.Formatter):
    """Plain formatter + a `[trace=<id8>]` suffix when the record carries
    trace correlation (full ids stay in the structured sinks)."""

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        trace_id = getattr(record, "trace_id", "")
        if trace_id:
            msg = f"{msg} [trace={trace_id[:8]}]"
        return msg


class ColorFormatter(TraceFormatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        color = _COLORS.get(record.levelno)
        if color and sys.stderr.isatty():
            return f"{color}{msg}{_RESET}"
        return msg


def logger_name(special_char: str = "/") -> str:
    """Module-derived logger name, as the reference's helper does."""
    import inspect

    frame = inspect.stack()[1]
    mod = inspect.getmodule(frame[0])
    return (mod.__name__ if mod else "vantage6_tpu_torch").replace(".", special_char)


class _StderrHandler(logging.StreamHandler):
    """StreamHandler resolving ``sys.stderr`` at EMIT time.

    Module-level loggers are configured at import time, which may happen
    while a test harness (pytest capture, click's CliRunner) has swapped
    ``sys.stderr`` for a temporary buffer; binding that object would write
    every later log record into a stale — possibly closed — stream. Looking
    the stream up per record keeps logs on whatever stderr currently is.
    """

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):  # base-class ctor compatibility; ignored
        pass


def record_to_dict(record: logging.LogRecord) -> dict:
    """The one structured shape of a log record, shared by the JSONL sink
    and the flight recorder so `tools/doctor.py` parses a single schema."""
    try:
        msg = record.getMessage()
    except Exception:  # malformed %-args must not kill the sink
        msg = str(record.msg)
    out = {
        "ts": record.created,
        "level": record.levelname,
        "logger": record.name,
        "msg": msg,
        "trace_id": getattr(record, "trace_id", ""),
        "span_id": getattr(record, "span_id", ""),
        "thread": record.thread,
    }
    if record.exc_info and record.exc_info[0] is not None:
        out["exc"] = logging.Formatter().formatException(record.exc_info)
    return out


class JsonlLogHandler(logging.Handler):
    """Append-only structured JSONL log sink (`V6T_LOG_JSON`).

    Same failure stance as the tracer's span sink: a full/unwritable disk
    disables the sink (counted, logged once to stderr) instead of taking
    the process down — console/file/flight logging continue.
    """

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._fh = None
        self._dead = False
        self.write_errors = 0
        self._fh_lock = threading.Lock()

    def emit(self, record: logging.LogRecord) -> None:
        if self._dead:
            return
        try:
            line = json.dumps(record_to_dict(record), default=str) + "\n"
            with self._fh_lock:
                if self._dead:
                    return
                if self._fh is None:
                    self._fh = open(self.path, "a", buffering=1)
                self._fh.write(line)
        except Exception as e:
            with self._fh_lock:
                self.write_errors += 1
                self._dead = True
                if self._fh is not None:
                    try:
                        self._fh.close()
                    except Exception:
                        pass
                    self._fh = None
            sys.stderr.write(
                f"JSON log sink {self.path} disabled after write "
                f"failure: {e}\n"
            )

    def close(self) -> None:
        with self._fh_lock:
            # dead, not merely closed: an emit() racing past the unlocked
            # _dead check must not reopen the finalized path under the
            # lock (it would strand a record — and a file handle — in a
            # file the caller believes complete)
            self._dead = True
            if self._fh is not None:
                try:
                    self._fh.close()
                except Exception:
                    pass
                self._fh = None
        super().close()


class _FlightTapHandler(logging.Handler):
    """Mirror every record into the process flight recorder's bounded log
    ring (`common.flight`). Lazy import: the first record pulls flight in
    (which also registers the tracer span tap); a broken import disables
    the tap rather than the logger."""

    _recorder = None
    _dead = False

    def emit(self, record: logging.LogRecord) -> None:
        cls = _FlightTapHandler
        if cls._dead:
            return
        if cls._recorder is None:
            try:
                from vantage6_tpu_torch.common.flight import FLIGHT

                cls._recorder = FLIGHT
            except Exception:  # pragma: no cover - broken install
                cls._dead = True
                return
        try:
            cls._recorder.record_log(record_to_dict(record))
        except Exception:  # pragma: no cover - recorder must not break logs
            pass


# every logger configured by setup_logging, so sinks enabled later
# (enable_json_sink at bench/ops time) attach to all of them
_CONFIGURED: dict[str, logging.Logger] = {}
_JSON_HANDLER: JsonlLogHandler | None = None
# set by disable_json_sink, cleared by enable_json_sink: keeps a later
# first-time setup_logging from re-arming the V6T_LOG_JSON env sink the
# caller explicitly switched off
_JSON_DISABLED = False
_REGISTRY_LOCK = threading.Lock()


def enable_json_sink(path: str) -> JsonlLogHandler:
    """Attach (or re-point) the structured JSONL sink on every configured
    logger. Equivalent to launching with `V6T_LOG_JSON=path`; callable at
    runtime so a bench arm or an operator session can switch structured
    logging on without a restart. Returns the handler (see
    `disable_json_sink`)."""
    global _JSON_HANDLER, _JSON_DISABLED
    with _REGISTRY_LOCK:
        _JSON_DISABLED = False
        # replace on re-point AND on a handler its write failure killed:
        # "enable again after freeing disk space" must actually re-enable,
        # not hand back the permanently-dead instance
        if _JSON_HANDLER is not None and (
            _JSON_HANDLER.path != str(path) or _JSON_HANDLER._dead
        ):
            for logger in _CONFIGURED.values():
                logger.removeHandler(_JSON_HANDLER)
            _JSON_HANDLER.close()
            _JSON_HANDLER = None
        if _JSON_HANDLER is None:
            _JSON_HANDLER = JsonlLogHandler(str(path))
        for logger in _CONFIGURED.values():
            if _JSON_HANDLER not in logger.handlers:
                logger.addHandler(_JSON_HANDLER)
        return _JSON_HANDLER


def disable_json_sink() -> None:
    global _JSON_HANDLER, _JSON_DISABLED
    with _REGISTRY_LOCK:
        # sticky even when no handler is armed yet: the caller's intent
        # is "no structured sink", and a later first-time setup_logging
        # must not re-arm the V6T_LOG_JSON env path behind their back
        _JSON_DISABLED = True
        if _JSON_HANDLER is None:
            return
        for logger in _CONFIGURED.values():
            logger.removeHandler(_JSON_HANDLER)
        _JSON_HANDLER.close()
        _JSON_HANDLER = None


def setup_logging(
    name: str = "vantage6_tpu_torch",
    level: int | str = logging.INFO,
    log_dir: str | Path | None = None,
    max_bytes: int = 5 * 1024 * 1024,
    backup_count: int = 3,
) -> logging.Logger:
    """Configure and return the instance logger (idempotent)."""
    import os

    logger = logging.getLogger(name)
    if getattr(logger, "_v6t_configured", False):
        return logger
    logger.setLevel(level)
    # our handler is the single console sink — without this, a root handler
    # installed by any other library (absl via jax, basicConfig in an app)
    # would print every record a second time
    logger.propagate = False
    logger.addFilter(TraceContextFilter())
    console = _StderrHandler()
    console.setFormatter(ColorFormatter(FORMAT, DATEFMT))
    logger.addHandler(console)
    # flight tap: records from this logger land in the bounded in-memory
    # ring a crash dump serializes — always on, append-to-deque cheap
    logger.addHandler(_FlightTapHandler())
    if log_dir is not None:
        path = Path(log_dir)
        path.mkdir(parents=True, exist_ok=True)
        fileh = logging.handlers.RotatingFileHandler(
            path / f"{name.replace('/', '_')}.log",
            maxBytes=max_bytes,
            backupCount=backup_count,
        )
        fileh.setFormatter(TraceFormatter(FORMAT))
        logger.addHandler(fileh)
    with _REGISTRY_LOCK:
        _CONFIGURED[name] = logger
        if _JSON_HANDLER is not None:
            logger.addHandler(_JSON_HANDLER)
    logger._v6t_configured = True  # type: ignore[attr-defined]
    json_path = os.environ.get("V6T_LOG_JSON")
    if json_path and _JSON_HANDLER is None and not _JSON_DISABLED:
        # honor an explicit disable_json_sink(): a later first-time
        # setup_logging from a lazily-imported module must not resurrect
        # the env sink the operator (or a bare bench arm) switched off
        enable_json_sink(json_path)
    return logger
