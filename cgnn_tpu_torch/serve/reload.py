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
  and normalizer of their own on the serving device); ``ParamStore.stage``
  derives there, outside every lock, all the swap needs: the staged
  tensors on each device of the set and each precision tier's payload
  (the int8 tier's q and scales, serve/quantize.py), then records an
  event after the copies;
- the server's hook takes every entry's dispatch lock: a flush holds its
  entry's lock (every entry's, under the mesh engine) across its replay
  and fetch, so the swap lands between flushes on every entry;
- under the locks ``ParamStore.apply_pending`` copies the staged tensors
  into each entry's live parameters, buffers and normalizer in place
  (the bf16 and int8 tiers share those), and each tier's payload into its
  own tensors, waits for the copies, and only then bumps the version.

Every flush then runs wholly on one version, the version it reports is
the version that computed it, and no graph is captured after a swap.

A save that fails verification is skipped with the restore chain's
report and remembered, so a corrupt upload neither takes the server down
nor is retried in a loop; the next good save supersedes it. ``set_pin``
and ``set_gate`` (``POST /reload-control``) hold the watcher to an exact
save, or cap what it may swap to, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
from typing import Callable

import torch


class ParamStore:
    """The live serving states, one per (entry, tier), their one version,
    and at most one staged swap. The states hold the tensors the predict
    graphs read; they are never replaced, only written in place.

    ``devices`` replicates ``state`` once per entry
    (``serve.devices.replicate_state``); the server passes it under every
    engine, since a replicated state is placed alike under both.
    ``placer`` (the JAX package's signature: a callable mapping ``state``
    to one state per entry) is for a caller that places the entries its
    own way; not both (the JAX package's rule). ``tier_specs``
    (serve/quantize.py) derives each tier's state from its entry's native
    one, once: a bf16 or int8 tier shares the native parameters and
    normalizer, and the int8 tier holds its own q and scales.
    ``get(i, tier)`` -> (state, version)."""

    def __init__(self, state, version: str = "init", devices=None,
                 tier_specs=None, placer=None):
        if placer is not None and devices is not None:
            raise ValueError(
                "ParamStore takes devices (per-replica mode) OR placer "
                "(one sharded tree), not both")
        from cgnn_tpu_torch.serve.devices import replicate_state

        self._specs = {t: spec for t, spec in (tier_specs or {}).items()
                       if t != "f32"}
        if placer is not None:
            replicas = list(placer(state))
        elif devices:
            replicas = replicate_state(state, devices)
        else:
            replicas = [state]
        self._states = [
            {"f32": r, **{t: spec.state_for(r)
                          for t, spec in self._specs.items()}}
            for r in replicas]
        self._version = version
        self._pending = None  # (sources by device, payloads, version, events)
        self._lock = threading.Lock()

    @property
    def state(self):
        """Entry 0's native state."""
        return self._states[0]["f32"]

    @property
    def tiers(self) -> tuple:
        return tuple(self._states[0])

    def __len__(self) -> int:
        return len(self._states)

    def get(self, device_index: int = 0, tier: str = "f32"):
        """-> (the state of entry ``device_index`` and ``tier``, the live
        version)."""
        with self._lock:
            return self._states[device_index][tier], self._version

    @property
    def version(self) -> str:
        with self._lock:
            return self._version

    @property
    def pending(self) -> str | None:
        """The staged version not yet applied, or None."""
        with self._lock:
            return None if self._pending is None else self._pending[2]

    def _devices(self) -> list:
        from cgnn_tpu_torch.serve.devices import state_device

        return list(dict.fromkeys(state_device(t["f32"])
                                  for t in self._states))

    @torch.no_grad()
    def stage(self, staged, version: str) -> None:
        """Hand over a restored state (a newer stage replaces an older one
        not yet applied). Everything a swap needs is derived here, on the
        caller's thread and outside every lock: the staged tensors on each
        device of the set, and each tier's payload (the int8 tier's q and
        scales). On CUDA an event recorded on each device's stream marks
        the end of the copies."""
        from cgnn_tpu_torch.serve.devices import state_device

        src_dev = state_device(staged)
        host = {t: spec.payload(staged) for t, spec in self._specs.items()}
        sources, payloads, events = {}, {}, []
        for dev in self._devices():
            if dev == src_dev:
                sd = staged.model.state_dict()
                norm = (staged.normalizer.mean, staged.normalizer.std)
            else:
                sd = {k: v.to(dev, copy=True)
                      for k, v in staged.model.state_dict().items()}
                norm = (staged.normalizer.mean.to(dev, copy=True),
                        staged.normalizer.std.to(dev, copy=True))
            sources[dev] = (sd, norm)
            payloads[dev] = {t: None if p is None else {
                k: dataclasses.replace(q, q=q.q.to(dev),
                                       scale=q.scale.to(dev))
                for k, q in p.items()} for t, p in host.items()}
        for dev in {src_dev, *sources}:
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                events.append((dev, ev))
        with self._lock:
            self._pending = (sources, payloads, version, events)

    @torch.no_grad()
    def apply_pending(self) -> str | None:
        """Copy a staged swap into every entry's and tier's live tensors,
        in place, then publish its version -> that version, or None when
        nothing was staged. The caller guarantees no flush is running on
        any entry (the server holds every entry's dispatch lock); the
        copies finish before this returns, so the next replay on any
        entry's stream reads the new tensors."""
        from cgnn_tpu_torch.serve.devices import state_device

        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return None
        sources, payloads, version, events = pending
        for dev, ev in events:
            torch.cuda.current_stream(dev).wait_event(ev)
        for tiers in self._states:
            live = tiers["f32"]
            dev = state_device(live)
            sd, (mean, std) = sources[dev]
            for k, t in live.model.state_dict().items():
                t.copy_(sd[k])
            live.normalizer.mean.copy_(mean)
            live.normalizer.std.copy_(std)
            for t, spec in self._specs.items():
                spec.load(tiers[t], payloads[dev][t])
        for dev in sources:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
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
