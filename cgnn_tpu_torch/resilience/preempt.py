"""Preemption handling (``cgnn_tpu/resilience/preempt.py``): SIGTERM or
SIGINT -> a checkpoint at the next safe point -> a resumable exit.

Schedulers (Kubernetes eviction, slurm, spot reclaims) deliver SIGTERM
with a grace window. The handler turns the signal into a *request* flag
that the training loops poll at safe points: the epoch boundary in the
per-step loop, the chunk boundary inside ``ScanEpochDriver._drive`` (an
epoch can outlast the grace window; a chunk cannot). The loop then saves
a resumable checkpoint, and ``python -m cgnn_tpu_torch.train`` exits
with ``RESUMABLE_EXIT_CODE``, so the scheduler can tell "requeue me with
--resume auto" from a real failure.

A second signal restores the default disposition and raises it again: a
stuck save must not make the process unkillable (and a double Ctrl-C
still interrupts at once).
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Callable

# EX_TEMPFAIL, "temporary failure, retry": the sysexits code closest to
# "preempted; resume me", distinct from success (0) and from the
# argument and data errors the train entry point returns (2)
RESUMABLE_EXIT_CODE = 75

_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionHandler:
    """Latches termination signals into a pollable checkpoint request."""

    def __init__(self, log_fn: Callable = print):
        self._event = threading.Event()
        self._log = log_fn
        self._installed: dict[int, object] = {}
        self._callbacks: list[Callable] = []

    @property
    def requested(self) -> bool:
        """The flag the training loops poll."""
        return self._event.is_set()

    def add_callback(self, fn: Callable) -> None:
        """Run ``fn()`` once when a request latches, from the latching
        thread (usually the signal handler on the main thread): it must
        be quick and must not raise."""
        self._callbacks.append(fn)

    def request(self) -> None:
        """Latch a checkpoint-and-exit request (the signal handler calls
        this; tests may call it directly)."""
        if not self._event.is_set():
            self._event.set()
            for fn in self._callbacks:
                try:
                    fn()
                except Exception as e:  # noqa: BLE001 — never mask the latch
                    self._log(f"preemption callback failed: {e!r}")

    def _on_signal(self, signum, frame):  # noqa: ARG002 — signal API
        if self._event.is_set():
            # the second signal: stop being graceful, restore the default
            # disposition and deliver it again so the process dies now
            self._log(
                f"second signal {signal.Signals(signum).name}: exiting "
                f"immediately (graceful checkpoint abandoned)")
            self.uninstall()
            signal.raise_signal(signum)
            return
        self._log(f"{signal.Signals(signum).name} received: checkpoint "
                  f"requested at the next epoch/chunk boundary (send again "
                  f"to exit now)")
        self.request()

    def install(self, signals=_DEFAULT_SIGNALS) -> "PreemptionHandler":
        """Install the handlers (main thread only: the signal module's
        rule); ``uninstall`` puts the previous ones back."""
        for sig in signals:
            self._installed[sig] = signal.signal(sig, self._on_signal)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._installed.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # a non-main thread, teardown
                pass
        self._installed.clear()

    @classmethod
    def installed(cls, log_fn: Callable = print) -> "PreemptionHandler":
        return cls(log_fn=log_fn).install()


def resumable_exit(log_fn: Callable = print) -> int:
    """Log the resume instructions -> the resumable exit code."""
    log_fn(f"preempted: resumable checkpoint saved — rerun with --resume "
           f"auto (exit code {RESUMABLE_EXIT_CODE}, pid {os.getpid()})")
    return RESUMABLE_EXIT_CODE
