"""Structured JSON logging: one line, one event, grep-able by trace id
(``cgnn_tpu/observe/log.py``).

The serve and resilience layers log through injectable ``log_fn``
callables that default to ``print`` — fine for a laptop, useless for an
incident bundle holding five processes' interleaved stdouts. This
module is the one formatter they all route through when ``--log-json``
is on:

    {"t": 1754300000.12, "role": "replica", "pid": 4242,
     "trace_id": "flt-ab12-000003", "msg": "serve: batch failed ..."}

- :func:`bind_trace` sets the CURRENT trace id (a contextvar, so
  concurrent request threads don't stomp each other); the HTTP handler
  (serve/http.py) binds it around ``predict``, so lines logged ON THOSE THREADS while a request is
  being worked carry its id. Scope honesty: logs from OTHER threads
  (a flush failure on the dispatch worker, the reload watcher) carry
  the id only where the message itself includes it.
- :func:`json_log_fn` returns a drop-in ``log_fn`` (same call shape as
  ``print``) for the existing injection points — no call site changes,
  just a different sink.
- :func:`setup_json_logging` additionally routes a stdlib
  ``logging.Logger`` through the same formatter for code that prefers
  the logging API.

Host-side and allocation-light; the JSON body rides the same
non-finite-safe serialization as every other telemetry file.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import sys
import time
from typing import Callable, Iterator

from cgnn_tpu_torch.observe.metrics_io import jsonfinite

# the current request's trace id, per execution context: bound by the
# layer that knows it (router dispatch, HTTP handler), read by every
# log line emitted underneath
_current_trace: contextvars.ContextVar = contextvars.ContextVar(
    "cgnn_trace_id", default="")


def current_trace_id() -> str:
    return _current_trace.get()


@contextlib.contextmanager
def bind_trace(trace_id: str) -> Iterator[None]:
    """Scope ``trace_id`` as the current trace for this context."""
    token = _current_trace.set(str(trace_id))
    try:
        yield
    finally:
        _current_trace.reset(token)


def format_record(msg: str, role: str, pid: int,
                  trace_id: str | None = None, **extra) -> str:
    rec = {
        "t": round(time.time(), 3),
        "role": role,
        "pid": pid,
        "trace_id": (current_trace_id() if trace_id is None
                     else str(trace_id)),
        "msg": str(msg),
    }
    rec.update(extra)
    try:
        return json.dumps(rec, allow_nan=False)
    except ValueError:
        return json.dumps(jsonfinite(rec))


def json_log_fn(role: str, stream=None) -> Callable:
    """A ``print``-compatible ``log_fn`` emitting one JSON line per
    call — the drop-in for every ``log_fn=print`` injection point in
    serve and resilience. Multiple positional args join like print's
    would; ``file=`` is accepted and ignored (the sink is fixed)."""
    import os

    pid = os.getpid()

    def log(*args, **kw) -> None:  # noqa: ARG001 — print-compatible
        out = stream or sys.stderr
        msg = " ".join(str(a) for a in args)
        out.write(format_record(msg, role, pid) + "\n")
        out.flush()

    return log


class JsonLineFormatter(logging.Formatter):
    """Stdlib-logging twin of :func:`json_log_fn` (same line schema)."""

    def __init__(self, role: str):
        super().__init__()
        self.role = role

    def format(self, record: logging.LogRecord) -> str:
        return format_record(record.getMessage(), self.role,
                             record.process or 0,
                             level=record.levelname.lower())


def setup_json_logging(role: str, stream=None,
                       level: int = logging.INFO) -> logging.Logger:
    """Route the ``cgnn_tpu_torch`` stdlib logger through the JSON formatter;
    returns it. Idempotent: re-setup replaces the handler rather than
    stacking a second one (every line would otherwise print twice)."""
    logger = logging.getLogger("cgnn_tpu_torch")
    for h in list(logger.handlers):
        if getattr(h, "_cgnn_json", False):
            logger.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JsonLineFormatter(role))
    handler._cgnn_json = True
    logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    return logger
