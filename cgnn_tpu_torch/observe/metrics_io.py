"""The ``metrics.jsonl`` writer and strict-JSON help
(``cgnn_tpu/observe/metrics_io.py``).

``MetricsLogger`` is the one sink every telemetry record flows through:
epoch aggregates (``write``) and tagged events, such as step records,
gauges and counters (``event``), one JSON object a line, thread-safe
(the step stream's drain thread writes beside the training thread).
The JAX logger mirrors scalars to TensorBoard through ``clu`` when it
can import it; the port accepts ``use_clu`` and writes JSONL only, as
the JAX logger does where ``clu`` is missing. ``profile_trace`` is not
ported (ROADMAP Queue 1, item 11, part 3).
"""

from __future__ import annotations

import json
import os
import threading
import time


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


class MetricsLogger:
    """Epoch and event records -> ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir: str, use_clu: bool = True):
        del use_clu  # JSONL only (module docstring)
        self.log_dir = log_dir = log_dir or "."
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._jsonl = open(self.path, "a", buffering=1)
        self._lock = threading.Lock()

    def write(self, step: int, values: dict, prefix: str = "") -> None:
        """One epoch-level record: {"step", "time", "<prefix>/<k>": v};
        NaN values are left out."""
        scalars = {
            (f"{prefix}/{k}" if prefix else k): float(v)
            for k, v in values.items()
            if isinstance(v, (int, float)) and v == v
        }
        rec = {"step": int(step), "time": time.time(), **scalars}
        with self._lock:
            self._jsonl.write(json.dumps(jsonfinite(rec)) + "\n")

    def event(self, event: str, record: dict) -> None:
        """One tagged record: {"event": <tag>, "time", **record};
        callable from any thread."""
        rec = {"event": event, "time": time.time(), **record}
        with self._lock:
            self._jsonl.write(json.dumps(jsonfinite(rec)) + "\n")

    def close(self) -> None:
        with self._lock:
            self._jsonl.close()


def read_jsonl(path: str) -> list[dict]:
    """Every record of a metrics.jsonl."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
