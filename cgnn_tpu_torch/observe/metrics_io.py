"""Strict-JSON serialization help (``cgnn_tpu/observe/metrics_io.py``
``jsonfinite``)."""

from __future__ import annotations


def jsonfinite(obj):
    """Non-finite floats -> None, recursively: ``json.dumps`` would emit
    bare ``NaN``/``Infinity`` tokens, which no strict JSON parser
    accepts."""
    if isinstance(obj, dict):
        return {k: jsonfinite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonfinite(v) for v in obj]
    if isinstance(obj, float) and (obj != obj or obj in
                                   (float("inf"), float("-inf"))):
        return None
    return obj
