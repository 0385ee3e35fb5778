"""The device set and its dispatch accounting (``cgnn_tpu/serve/devices.py``).

A device set is a list of entries, each a ``torch.device``. Predict and
serve run over it with one of two engines (parallel/executor.py for the
mesh engine; the threads engine is the server's router and per-entry
dispatch threads, and bulk predict's round-robin):

- every entry holds its own copy of the serving state
  (``replicate_state``), its own predict graphs, its own CUDA stream and
  its own dispatch accounting. An explicit list is taken as given,
  repeats included: ``[cuda:0, cuda:0]`` is two entries on one card,
  which is how one card holds the multi-entry paths, and ``[cpu, cpu]``
  how the CPU tests do;
- ``DeviceSet`` is the inventory and the accounting: ``pick`` chooses the
  entry with the fewest flushes in flight (round-robin tie-break), and
  ``stats``/``flush_gauges`` report per-entry dispatches, busy time and
  window depth under the JAX package's keys and gauge names. Under the
  mesh engine its rows are the mesh shards.

``resolve_devices('auto', device)`` is every visible card when the caller
runs on CUDA and the one CPU device when it asked for the CPU (the JAX
package's rule: host "devices" share the same cores). An int N is the
first N cards, and raises when fewer exist: a silent clamp would fake the
distribution a run is meant to prove.
"""

from __future__ import annotations

import contextlib
import copy
import threading
import time
from typing import Sequence

import torch

from cgnn_tpu_torch.device import resolve_device


def resolve_devices(spec="auto", device="cuda") -> list[torch.device]:
    """``spec`` -> a list of devices of the caller's ``device`` type.

    - ``'auto'`` (or None): every visible card on CUDA
      (``torch.cuda.device_count()``), ``[cpu]`` on the CPU;
    - an int (or numeric string) N: the first N cards; raises when fewer
      exist. On the CPU only N = 1 resolves: torch has one CPU device, so
      a CPU run holds the multi-entry paths with an explicit list
      (``[cpu, cpu]``), never through this function.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        local = [torch.device("cpu")]
    if spec is None or spec == "auto":
        return local
    n = int(spec)
    if n < 1:
        raise ValueError(f"--devices must be >= 1, got {n}")
    if n > len(local):
        raise ValueError(
            f"--devices {n} requested but only {len(local)} local "
            f"device(s) exist ({dev.type}; torch has one CPU device: an "
            f"explicit list such as [cpu, cpu] holds the multi-entry paths "
            f"on the CPU)")
    return local[:n]


def canonical(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def state_device(state) -> torch.device:
    """The device an InferenceState's model lives on."""
    return next(state.model.parameters()).device


def replicate_state(state, devices: Sequence) -> list:
    """One copy of the serving ``state`` (an InferenceState) per entry,
    the model in eval mode. Entry 0 is ``state`` itself when it already
    lives on ``devices[0]``; every other entry, a repeat of a device
    included, gets tensors of its own, since each entry's predict graphs
    read its state by address."""
    from cgnn_tpu_torch.train.step import InferenceState

    out = []
    for i, d in enumerate(devices):
        d = canonical(d)
        if i == 0 and state_device(state) == d:
            out.append(state)
            continue
        # the dropout generator (training only) is shared, not copied
        gen = getattr(state.model, "_generator", None)
        memo = {} if gen is None else {id(gen): gen}
        model = copy.deepcopy(state.model, memo).to(d).eval()
        norm = state.normalizer
        out.append(InferenceState(model, type(norm)(
            norm.mean.to(d, copy=True), norm.std.to(d, copy=True))))
    return out


class DeviceSet:
    """The entries of one forward path and their dispatch accounting.

    Thread-safe: the threads engine runs a router and one dispatch thread
    an entry; every mutation here is under one lock."""

    def __init__(self, devices: Sequence | None = None, *, window: int = 16):
        if devices is None:
            devices = resolve_devices("auto")
        devices = [canonical(d) for d in devices]
        if not devices:
            raise ValueError("a DeviceSet needs at least one device")
        self.devices = tuple(devices)
        self.window = max(1, int(window))
        self._lock = threading.Lock()
        n = len(self.devices)
        self._inflight = [0] * n  # routed or dispatched, not yet fetched
        self._dispatches = [0] * n
        self._busy_s = [0.0] * n  # dispatch -> fetch wall, per entry
        self._max_depth = [0] * n
        self._rr = 0
        self._t0 = time.perf_counter()

    def __len__(self) -> int:
        return len(self.devices)

    def pick(self) -> int:
        """The entry with the fewest flushes in flight; ties go
        round-robin, so an idle set rotates instead of pinning entry 0."""
        with self._lock:
            n = len(self.devices)
            best = min((self._inflight[(self._rr + off) % n], off)
                       for off in range(n))[1]
            best = (self._rr + best) % n
            self._rr = (best + 1) % n
            return best

    def note_enqueue(self, i: int) -> None:
        with self._lock:
            self._inflight[i] += 1
            self._max_depth[i] = max(self._max_depth[i], self._inflight[i])

    def note_complete(self, i: int, busy_s: float, ok: bool = True) -> None:
        """Retire one flush: the in-flight count always drops; dispatches
        and busy time accrue only for a flush that ran (``ok``), so an
        entry whose flushes all failed reads as idle."""
        with self._lock:
            self._inflight[i] = max(0, self._inflight[i] - 1)
            if ok:
                self._dispatches[i] += 1
                self._busy_s[i] += float(busy_s)

    def inflight(self, i: int) -> int:
        with self._lock:
            return self._inflight[i]

    def inflight_depths(self) -> list[int]:
        """Every entry's flushes in flight, in one lock acquisition."""
        with self._lock:
            return list(self._inflight)

    def stats(self) -> list[dict]:
        """One record per entry (the JAX package's keys)."""
        wall = max(time.perf_counter() - self._t0, 1e-9)
        with self._lock:
            return [
                {
                    "device_id": i,
                    "device": str(d),
                    "dispatches": self._dispatches[i],
                    "busy_s": round(self._busy_s[i], 4),
                    "occupancy": min(1.0, self._busy_s[i] / wall),
                    "inflight": self._inflight[i],
                    "max_window_depth": self._max_depth[i],
                }
                for i, d in enumerate(self.devices)
            ]

    def flush_gauges(self, telemetry) -> None:
        """Per-entry gauges into ``telemetry`` (anything with
        ``set_gauge(name, value)``) under the JAX package's
        ``device{i}_*`` names; repeated calls overwrite."""
        if telemetry is None:
            return
        for rec in self.stats():
            i = rec["device_id"]
            telemetry.set_gauge(f"device{i}_dispatches",
                                float(rec["dispatches"]))
            telemetry.set_gauge(f"device{i}_occupancy", rec["occupancy"])
            telemetry.set_gauge(f"device{i}_window_depth",
                                float(rec["max_window_depth"]))
        telemetry.set_gauge("device_count", float(len(self.devices)))


def entry_streams(devices: Sequence) -> list:
    """One CUDA stream per entry (None for a CPU entry): two entries on
    one card dispatch on streams of their own. They come from the
    high-priority pool, which no capture stream comes from
    (train/graphs.py ``capture_stream``): a pool stream is handed out
    again after 32, and an entry's replays must never land on a stream
    another thread captures on."""
    return [torch.cuda.Stream(d, priority=-1)
            if torch.device(d).type == "cuda" else None for d in devices]


def on_stream(stream):
    """``torch.cuda.stream(stream)``, or a no-op for None (the CPU)."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


__all__ = ["DeviceSet", "canonical", "entry_streams", "on_stream", "replicate_state",
           "resolve_devices", "state_device"]
