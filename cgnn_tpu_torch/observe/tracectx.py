"""The ``X-Trace-Parent`` wire (``cgnn_tpu/observe/tracectx.py``): a
trace parent is ``"<trace_id>/<span_id>"``, carried to the next process
as a header (or the ``trace_parent`` body field). The receiver adopts the
trace id and records the span id as its request's parent."""

from __future__ import annotations

TRACE_PARENT_HEADER = "X-Trace-Parent"


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
