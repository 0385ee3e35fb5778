"""On-demand device profiling from a live process
(``cgnn_tpu/observe/profile.py``), through ``torch.profiler``.

``ProfileCapture.capture()`` (``POST /profile`` on the server, SIGUSR2 on
both entry points) runs one ``torch.profiler.profile`` session with the
CPU activity of every thread and, on a CUDA build with a card, the CUDA
activity (CUPTI: every kernel the card runs in the window, a replayed
graph's too, from whatever thread launched it). It holds the session for
a bounded window (clamped to [0.05, ``max_duration_s``]), stops it, and
writes it with ``export_chrome_trace`` as ``device_trace.json`` into a
fresh ``profile-<stamp>-<nnn>/`` under ``out_dir``, beside the span
tracer's ``host_trace.json`` when one is attached. It returns the JAX
record ``{"dir", "duration_s", "files", "bytes", "host_trace"}``.

A process has one profiler session at a time (two ``torch.profiler``
sessions in one process corrupt each other without an error), so every
session the port starts holds the module's session lock
(``session()``): ``capture``, ``profile_trace`` (observe/metrics_io.py,
train's ``--profile N``) and any harness that traces a whole run. The
capture's own gate is non-blocking: a capture asked for while another
capture or any other session runs is REJECTED (``ProfileBusy``), never
stacked or nested; ``wait_idle`` waits an in-flight one out (every exit
path calls it).

The session starts and stops inside ``train.graphs.CAPTURE_GATE.quiet()``
(no CUDA graph capture runs on another thread meanwhile: CUPTI switching
on mid-capture can break it) and synchronizes the card before each, so
the window holds every kernel launched inside it and none from before.
Host-side only: nothing a step computes changes, so served answers and
the trajectory are bit-equal with a capture or without.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable

# the process's one profiler session (module docstring)
_SESSION = threading.Lock()


class ProfileBusy(RuntimeError):
    """A capture was asked for while a profiler session runs."""


@contextlib.contextmanager
def session():
    """Hold the process's profiler session for the body; raises
    ``ProfileBusy`` at once when another holds it."""
    if not _SESSION.acquire(blocking=False):
        raise ProfileBusy("a profiler session is already running in this "
                          "process (one at a time)")
    try:
        yield
    finally:
        _SESSION.release()


def session_busy() -> bool:
    """Whether a profiler session runs in this process."""
    if _SESSION.acquire(blocking=False):
        _SESSION.release()
        return False
    return True


def _sync_card() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def start_profiler():
    """A started ``torch.profiler.profile`` (CPU, and CUDA where a card
    is): after the card drains, with no graph capture in flight. The
    caller holds ``session()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cgnn_tpu_torch.train.graphs import CAPTURE_GATE

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:
        # the CPU ops of every thread (the server's dispatch threads, the
        # train loop), not only the starting thread's
        config = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):  # a torch without the option
        config = None
    prof = profile(activities=acts, experimental_config=config)
    with CAPTURE_GATE.quiet():
        _sync_card()
        prof.start()
    return prof


def stop_profiler(prof, path: str) -> None:
    """Stop ``prof`` after the card drains (no capture in flight) and
    write its Chrome trace to ``path``."""
    from cgnn_tpu_torch.train.graphs import CAPTURE_GATE

    with CAPTURE_GATE.quiet():
        _sync_card()
        prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)


def _dir_stats(root: str) -> tuple[int, int]:
    """(file count, total bytes) under ``root``."""
    files = total = 0
    for dirpath, _, names in os.walk(root):
        for name in names:
            files += 1
            try:
                total += os.path.getsize(os.path.join(dirpath, name))
            except OSError:
                pass
    return files, total


class ProfileCapture:
    """One-at-a-time bounded profiler captures into ``out_dir``."""

    def __init__(self, out_dir: str, *, spans=None,
                 default_duration_s: float = 1.0,
                 max_duration_s: float = 10.0,
                 log_fn: Callable = print):
        self.out_dir = out_dir
        self.spans = spans  # an observe.spans.SpanTracer, or None
        self.default_duration_s = float(default_duration_s)
        self.max_duration_s = float(max_duration_s)
        self._log = log_fn
        self._gate = threading.Lock()
        self.captures = 0
        self.rejected = 0
        self.recording = False  # the session is on (between start and stop)
        self.last: dict | None = None

    @property
    def busy(self) -> bool:
        if self._gate.acquire(blocking=False):
            self._gate.release()
            return False
        return True

    def wait_idle(self, timeout_s: float = 60.0) -> bool:
        """Block until no capture runs (or the timeout passes); True
        when idle. Exit paths call it: a process that exits mid-capture
        leaves its trace unwritten."""
        if self._gate.acquire(timeout=timeout_s):
            self._gate.release()
            return True
        return False

    def capture(self, duration_s: float | None = None) -> dict:
        """One bounded capture -> ``{"dir", "duration_s", "files",
        "bytes", "host_trace"}``. Raises ``ProfileBusy`` while another
        capture or profiler session runs; a profiler that fails to start
        raises its error after the gates are released."""
        duration = (self.default_duration_s if duration_s is None
                    else float(duration_s))
        duration = max(0.05, min(duration, self.max_duration_s))
        if not self._gate.acquire(blocking=False):
            self.rejected += 1
            raise ProfileBusy(
                "a profile capture is already running; retry when it "
                "finishes (captures are rejected, never stacked)")
        try:
            with contextlib.ExitStack() as stack:
                try:
                    stack.enter_context(session())
                except ProfileBusy:
                    self.rejected += 1
                    raise
                stamp = time.strftime("%Y%m%d-%H%M%S")
                target = os.path.join(
                    self.out_dir, f"profile-{stamp}-{self.captures:03d}")
                os.makedirs(target, exist_ok=True)
                t0 = time.perf_counter()
                prof = start_profiler()
                self.recording = True
                try:
                    # the window: whatever the process runs meanwhile
                    # (dispatch threads, the train loop) is recorded
                    time.sleep(duration)
                finally:
                    self.recording = False
                    stop_profiler(prof, os.path.join(target,
                                                     "device_trace.json"))
            record = {"dir": target,
                      "duration_s": round(time.perf_counter() - t0, 3)}
            if self.spans is not None:
                # the host window beside it (the span buffer as of now)
                record["host_trace"] = self.spans.export(
                    os.path.join(target, "host_trace.json"))
            files, total = _dir_stats(target)
            record["files"], record["bytes"] = files, total
            self.captures += 1
            self.last = record
            self._log(f"profile: captured {record['duration_s']:.2f}s "
                      f"device trace -> {target} ({files} files, {total} "
                      f"bytes)")
            return record
        finally:
            self._gate.release()


def install_sigusr2(capture: ProfileCapture,
                    log_fn: Callable = print) -> bool:
    """SIGUSR2 -> one default-duration capture on a background thread.

    The handler only starts the thread; a signal that lands mid-capture
    is logged and dropped by the gate. Returns False (installing
    nothing) off the main thread or without SIGUSR2."""
    import signal

    if not hasattr(signal, "SIGUSR2"):
        return False

    def _run() -> None:
        try:
            capture.capture()
        except ProfileBusy as e:
            log_fn(f"profile: SIGUSR2 ignored ({e})")
        except Exception as e:  # noqa: BLE001 — a failed capture must not kill the run
            log_fn(f"profile: capture failed: {e!r}")

    def _handler(signum, frame):  # noqa: ARG001 — the signal API
        threading.Thread(target=_run, daemon=True,
                         name="cgnn-profile-sigusr2").start()

    try:
        signal.signal(signal.SIGUSR2, _handler)
    except ValueError:  # not the main thread
        return False
    return True
