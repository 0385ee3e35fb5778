"""Hot checkpoint reload: serve newly trained weights without a restart
(``cgnn_tpu/serve/reload.py``).

A trainer keeps committing versioned saves (``ckpt-%08d``,
train/checkpoint.py) into the directory the server watches. The watcher
polls for a newer committed save (its manifest is the commit marker),
restores it through the verifying chain (``restore_for_inference`` on the
save's name: held to its manifest, never a blind load) and hands it to
the server.

Where the design differs from the JAX package: JAX publishes a new
immutable parameter tree and lets flushes in flight keep the old one by
reference. The port's predict graphs read one set of tensors by address,
so a swap cannot publish new tensors. Instead:

- the watcher restores on its own thread into staging tensors (a model
  and normalizer of their own on the serving device), and records an
  event on its stream after the copies;
- it stages them in the :class:`ParamStore` and calls the server's hook,
  which takes the dispatch lock: the worker holds that lock across each
  flush's replay and fetch, so the swap lands between two flushes;
- under the lock the staged parameters, buffers and normalizer are
  copied into the live ones in place, behind that event, on the stream
  the replays use, and only then is the version bumped
  (``ParamStore.apply_pending``).

Every flush then runs wholly on one version, the version it reports is
the version that computed it, and no graph is captured after a swap.

A save that fails verification is skipped with the restore chain's
report and remembered, so a corrupt upload neither takes the server down
nor is retried in a loop; the next good save supersedes it. ``set_pin``
and ``set_gate`` (``POST /reload-control``) hold the watcher to an exact
save, or cap what it may swap to, as in the JAX package.
"""

from __future__ import annotations

import sys
import threading
from typing import Callable

import torch


class ParamStore:
    """The live serving state and its version, plus at most one staged
    swap. ``state`` (an InferenceState) holds the tensors the predict
    graphs read; it is never replaced, only written in place."""

    def __init__(self, state, version: str = "init"):
        self.state = state
        self._version = version
        self._pending = None  # (staged state, version, event or None)
        self._lock = threading.Lock()

    @property
    def version(self) -> str:
        with self._lock:
            return self._version

    @property
    def pending(self) -> str | None:
        """The staged version not yet applied, or None."""
        with self._lock:
            return None if self._pending is None else self._pending[1]

    def stage(self, staged, version: str) -> None:
        """Hand over a restored state (a newer stage replaces an older
        one not yet applied). On CUDA an event recorded on this thread's
        stream marks the end of the copies that filled ``staged``."""
        event = None
        dev = staged.normalizer.mean.device
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        with self._lock:
            self._pending = (staged, version, event)

    @torch.no_grad()
    def apply_pending(self) -> str | None:
        """Copy a staged state into the live tensors, in place, on the
        caller's stream, then publish its version -> that version, or
        None when nothing was staged. The caller guarantees no flush is
        running (the server's dispatch lock)."""
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return None
        staged, version, event = pending
        live = self.state
        if event is not None:
            torch.cuda.current_stream(
                live.normalizer.mean.device).wait_event(event)
        src = staged.model.state_dict()
        for k, t in live.model.state_dict().items():
            t.copy_(src[k])
        live.normalizer.mean.copy_(staged.normalizer.mean)
        live.normalizer.std.copy_(staged.normalizer.std)
        with self._lock:
            self._version = version
        return version


class CheckpointWatcher:
    """Polls a checkpoint directory and stages verified saves.

    ``poll_once`` is the synchronous unit; ``start`` runs it on a daemon
    thread every ``poll_interval_s``. ``make_staging()`` builds a fresh
    state of the serving model on the serving device, which a restore
    fills; ``on_stage(version)`` is the server's hook that gets the swap
    applied between two flushes."""

    def __init__(
        self,
        manager,
        store: ParamStore,
        make_staging: Callable,
        *,
        poll_interval_s: float = 2.0,
        on_stage: Callable | None = None,
        log_fn: Callable | None = None,
        gate: str | None = None,
        pin: str | None = None,
    ):
        self._mgr = manager
        self._store = store
        self._make_staging = make_staging
        self.poll_interval = poll_interval_s
        self._on_stage = on_stage
        self._log = log_fn or (lambda m: print(m, file=sys.stderr))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # verified-bad saves: never retried (a corrupt file stays corrupt)
        self._skipped: set[str] = set()
        # the promotion guard: ``gate`` caps what the watcher may swap
        # to; ``pin`` overrides everything (up or down). Set from the
        # HTTP control thread while the watcher thread reads them.
        self._ctl_lock = threading.Lock()
        self._gate = gate
        self._pin = pin
        self.swaps = 0
        self.skips = 0
        self.gate_holds = 0

    # ---- promotion-guard control ----

    def set_pin(self, name: str | None) -> None:
        """Pin to exactly ``name`` (a committed ``ckpt-%08d`` save);
        None clears the pin."""
        with self._ctl_lock:
            self._pin = name

    def set_gate(self, name: str | None) -> None:
        """The newest save this watcher may swap to; None = chase the
        newest committed save."""
        with self._ctl_lock:
            self._gate = name

    def control(self) -> dict:
        """The guard state and the live version (``/reload-control``)."""
        with self._ctl_lock:
            pin, gate = self._pin, self._gate
            swaps, gate_holds = self.swaps, self.gate_holds
        return {"pin": pin, "gate": gate, "version": self._store.version,
                "swaps": swaps, "gate_holds": gate_holds}

    @property
    def skipped(self) -> list[str]:
        with self._ctl_lock:
            return sorted(self._skipped)

    # ---- the synchronous unit ----

    def _target(self) -> str | None:
        """The save to swap to now, or None."""
        with self._ctl_lock:
            pin, gate = self._pin, self._gate
        current = self._store.pending or self._store.version
        if pin is not None:
            # an uncommitted pin is retried next poll (mid-commit)
            if (pin == current or pin in self._skipped
                    or not self._mgr.is_committed(pin)):
                return None
            return pin
        newest = self._mgr.newest_committed()
        if newest is None or newest == current or newest in self._skipped:
            return None
        if gate is not None and newest > gate:
            # ckpt-%08d names compare lexically in version order: hold at
            # the gate, or converge on it when it is newer than what runs
            if (gate == current or gate in self._skipped
                    or (current.startswith("ckpt-") and gate < current)
                    or not self._mgr.is_committed(gate)):
                with self._ctl_lock:
                    self.gate_holds += 1
                return None
            return gate
        return newest

    def poll_once(self) -> bool:
        """Stage a newer committed save if it verifies -> True iff one
        was staged. A save that fails verification is logged with the
        chain's report, counted and never retried; the server keeps
        serving what it has."""
        target = self._target()
        if target is None:
            return False
        try:
            staged = self._mgr.restore_for_inference(self._make_staging(),
                                                     target)
        except Exception as e:  # noqa: BLE001 — skip, keep serving
            with self._ctl_lock:
                self.skips += 1
                self._skipped.add(target)
            report = "; ".join(self._mgr.last_restore_report) or repr(e)
            self._log(f"hot reload: SKIPPING {target} (integrity/restore "
                      f"failure: {report}); still serving "
                      f"{self._store.version}")
            return False
        self._store.stage(staged, target)
        with self._ctl_lock:
            self.swaps += 1
        self._log(f"hot reload: staged {target} (serving "
                  f"{self._store.version} until the next flush boundary)")
        if self._on_stage is not None:
            self._on_stage(target)
        return True

    # ---- the background thread ----

    def start(self) -> "CheckpointWatcher":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="cgnn-torch-reload")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the watcher survives
                self._log(f"hot reload: poll error (will retry): {e!r}")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
