"""The ``metrics.jsonl`` writer and strict-JSON help
(``cgnn_tpu/observe/metrics_io.py``).

``MetricsLogger`` is the one sink every telemetry record flows through:
epoch aggregates (``write``) and tagged events, such as step records,
gauges and counters (``event``), one JSON object a line, thread-safe
(the step stream's drain thread writes beside the training thread).
The JAX logger mirrors scalars to TensorBoard through ``clu`` when it
can import it; the port accepts ``use_clu`` and writes JSONL only, as
the JAX logger does where ``clu`` is missing. ``profile_trace`` is the
``torch.profiler`` window of train's ``--profile N``
(observe/profile.py).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Iterator


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


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """A ``torch.profiler`` session over the body, written as
    ``profile-<stamp>-p<pid>.json`` (Chrome trace) under ``log_dir`` (the
    pid: ranks of one run share the dir).

    Tolerant of a session already running (observe/profile.py: one a
    process; an on-demand SIGUSR2 capture may hold it): a lost launch-
    time trace must not kill the training run, so the window is skipped
    with a log line."""
    if not enabled:
        yield
        return
    from cgnn_tpu_torch.observe.profile import (
        session,
        start_profiler,
        stop_profiler,
    )

    os.makedirs(log_dir, exist_ok=True)
    with contextlib.ExitStack() as stack:
        try:
            stack.enter_context(session())
            prof = start_profiler()
        except Exception as e:  # noqa: BLE001 — busy, or cannot start
            print(f"profile_trace: skipped ({e!r}); is another capture "
                  f"holding the profiler?")
            prof = None
        try:
            yield
        finally:
            if prof is not None:
                stop_profiler(prof, os.path.join(
                    log_dir, f"profile-{time.strftime('%Y%m%d-%H%M%S')}"
                             f"-p{os.getpid()}.json"))


def enable_debug_nans() -> None:
    """Fail fast with a traceback at the first NaN an autograd op
    produces (the JAX ``jax_debug_nans``)."""
    import torch

    torch.autograd.set_detect_anomaly(True, check_nan=True)
