"""The ``X-Trace-Parent`` wire (``cgnn_tpu/observe/tracectx.py``): a
span id names one span instance within one process (``mint_span_id``: a
process-unique prefix and a counter); a trace parent is
``"<trace_id>/<span_id>"``, carried to the next process as a header (or
the ``trace_parent`` body field). The receiver adopts the trace id and
records the span id as its request's parent."""

from __future__ import annotations

import itertools
import os
import threading

TRACE_PARENT_HEADER = "X-Trace-Parent"

# ids must differ across the processes one joiner merges, and a pid
# recycles: two random bytes minted once a process
_SPAN_PREFIX = f"{os.getpid():x}-{os.urandom(2).hex()}"
_SPAN_SEQ = itertools.count(1)
_SEQ_LOCK = threading.Lock()


def mint_span_id(kind: str = "span") -> str:
    """A process-unique span id, e.g. ``att-1f03-9a2c-000007``."""
    with _SEQ_LOCK:
        n = next(_SPAN_SEQ)
    return f"{kind}-{_SPAN_PREFIX}-{n:06x}"


def format_parent(trace_id: str, span_id: str) -> str:
    """The ``X-Trace-Parent`` value for a downstream hop."""
    return f"{trace_id}/{span_id}"


def parse_parent(value: str | None) -> tuple[str, str]:
    """Header/body value -> ``(trace_id, parent_span_id)``; a missing or
    malformed value parses to ``("", "")``."""
    if not value or not isinstance(value, str):
        return "", ""
    value = value.strip()
    # the span id never contains '/', so split from the right: trace ids
    # are client-controlled (X-Request-Id) and may contain '/'
    trace_id, sep, span_id = value.rpartition("/")
    if not sep or not trace_id or not span_id:
        return "", ""
    return trace_id[:128], span_id[:128]
