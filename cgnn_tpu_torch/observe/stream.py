"""Per-step metric streaming out of replayed step graphs
(``cgnn_tpu/observe/stream.py``'s ``StepStream``, as a device ring).

The JAX tap is a ``jax.debug.callback`` staged inside the scan body; a
replayed CUDA graph calls back to no Python, so the port's tap is a ring
on the device. ``tap`` (called inside a step body, so a captured graph
holds it) packs the step's scalar metric sums into one f32 row and
writes it, with the step number, into a static ``[R, K]`` ring at slot
``i % R``, where ``i`` is the ring's write count, kept and advanced on
the device. Nothing is read back inside a step.

The host knows how many rows it queued: a tap counts one on its eager
run, and a graph that holds taps counts one at each replay
(train/graphs.py ``on_each_run``); warm-up runs before a capture write
nothing (``graphs.warming``). The drivers call ``mark(phase, device)``
at chunk boundaries (the per-step loop after each step): a mark records
a CUDA event (a host clock on the CPU) beside the queued count, and once
``R // 2`` rows are pending the ring is snapshotted: copied without
blocking into page-locked host memory (a set a ring, reused once
drained) behind an event, on the stream the steps run on, and handed to
a drain thread that polls the event and turns each row into a record.
So the steps never wait for the host, nor the host for the drain.

A record has the JAX record's keys: ``phase``, ``step`` (the optimizer's
device count after the update for a train row; a sequence number a phase
for eval rows), the per-step means of the row's (sum, count) pairs, and
``steps_per_s``. Rows reach the host a snapshot at a time, so the rate
is not taken from arrival times: it is the steps between two marks over
the device time between their events (the marks that span at most
``rate_window`` steps before the row's chunk ends, in one epoch of the
phase), left out where no earlier mark exists. Records go to
``metrics.jsonl`` as ``{"event": "step"}`` and into a bounded in-process
ring (``records(phase)``).

A row overwritten before a snapshot read it (more than R rows queued
between two snapshots: a chunk longer than R / 2) is counted in
``dropped``, never lost silently; ``reserve(steps)`` sizes R above the
largest chunk a driver queues. Rows queued inside ``muted()`` (warm-up
or capture runs the caller does not want as records) are dropped at the
drain, as the JAX ``muted()`` drops them. Eager steps (the CPU, the
per-step loop) write the same ring through the same code.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np
import torch

from cgnn_tpu_torch.train import graphs as _graphs
from cgnn_tpu_torch.train.metrics import wait_event


def _derive_means(sums: dict) -> dict:
    """Per-step means from one step's '<name>_sum' totals (each divided
    by its matching '<name>_count' when present, else the global
    'count')."""
    count = max(sums.get("count", 1.0), 1.0)
    out = {
        k[: -len("_sum")]: v
        / max(sums.get(k[: -len("_sum")] + "_count", count), 1.0)
        for k, v in sums.items()
        if k.endswith("_sum")
    }
    out["count"] = sums.get("count", 0.0)
    return out


class _Ring:
    """One phase's device ring: rows, step numbers, the write count, and
    the host buffers its snapshots go to (reused once drained)."""

    def __init__(self, keys: tuple, slots: int, device):
        self.keys = keys
        self.slots = slots
        self.vals = torch.zeros((slots, len(keys)), dtype=torch.float32,
                                device=device)
        self.steps = torch.zeros(slots, dtype=torch.int64, device=device)
        self.widx = torch.zeros(1, dtype=torch.int64, device=device)
        self.no_step = torch.full((1,), -1, dtype=torch.int64, device=device)
        self.free: collections.deque = collections.deque()

    def host_buffers(self) -> list:
        """Host copies' destinations: a drained set, or a new page-locked
        one (pageable off a card)."""
        if self.free:
            return self.free.popleft()
        cuda = self.vals.is_cuda
        return [torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
                for t in (self.vals, self.steps, self.widx)]

    def write(self, packed: torch.Tensor, step) -> None:
        slot = torch.remainder(self.widx, self.slots)
        self.vals.index_copy_(0, slot, packed.view(1, -1))
        self.steps.index_copy_(0, slot, self.no_step if step is None
                               else step.detach().reshape(1).to(torch.int64))
        self.widx.add_(1)


class _Phase:
    """Host bookkeeping of one phase's ring."""

    def __init__(self, name: str):
        self.name = name
        self.ring: _Ring | None = None
        self.queued = 0  # rows the host queued (taps run or replayed)
        self.snapped = 0  # queued at the last snapshot
        self.drained = 0  # rows turned into records (or dropped)
        self.seq = 0
        # (queued count, clock, starts an epoch) at each mark
        self.marks: list = []
        self.muted: list = []  # [start, end) row ranges; end None: open

    def count_one(self) -> None:
        self.queued += 1


class StepStream:
    """Per-step metric tap: step bodies -> device ring -> ring buffer of
    records + metrics.jsonl (module docstring)."""

    def __init__(self, logger=None, ring_size: int = 4096,
                 rate_window: int = 32, slots: int = 256):
        self._logger = logger
        self.ring: collections.deque = collections.deque(maxlen=ring_size)
        self._lock = threading.Lock()
        self._phases: dict[str, _Phase] = {}
        self._rate_window = rate_window
        self.slots = int(slots)
        self.dropped = 0  # rows overwritten unread, or failed to decode
        self._q: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None

    # ---- inside the step body ----

    def _phase(self, phase: str) -> _Phase:
        with self._lock:
            ph = self._phases.get(phase)
            if ph is None:
                ph = self._phases[phase] = _Phase(phase)
            return ph

    def tap(self, metrics: dict, phase: str, step=None) -> None:
        """Write this step's scalar metric sums (and ``step``, a 0-d
        device tensor, the optimizer's count; None for eval) into the
        phase's ring. Device ops only: a captured graph holds them."""
        scalars = {k: v for k, v in metrics.items()
                   if isinstance(v, torch.Tensor) and v.dim() == 0}
        if not scalars:
            return
        keys = tuple(sorted(scalars))
        ph = self._phase(phase)
        if ph.ring is None:
            dev = scalars[keys[0]].device
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"step stream {phase!r}: first tap "
                                   f"inside a capture")
            ph.ring = _Ring(keys, self.slots, dev)
        if ph.ring.keys != keys:
            raise ValueError(f"step stream {phase!r}: metric keys {keys} "
                             f"differ from the ring's {ph.ring.keys}")
        if _graphs.warming():
            return  # a warm-up run before a capture: not a step
        with torch.no_grad():
            packed = torch.stack([scalars[k].detach().to(torch.float32)
                                  for k in keys])
            ph.ring.write(packed, step)
        _graphs.on_each_run(ph.count_one)

    def wrap_train(self, body: Callable, phase: str = "train") -> Callable:
        """(state, batch) -> metrics body with the tap after it; the step
        number is the optimizer's device count after the update."""

        def wrapped(state, batch):
            metrics = body(state, batch)
            self.tap(metrics, phase, step=state.optimizer.device_count)
            return metrics

        return wrapped

    def wrap_eval(self, body: Callable, phase: str = "eval") -> Callable:
        """(state, batch) -> metrics body with the tap after it."""

        def wrapped(state, batch):
            metrics = body(state, batch)
            self.tap(metrics, phase)
            return metrics

        return wrapped

    # ---- the host side ----

    def reserve(self, steps: int) -> None:
        """Size rings made from now on so that ``steps`` rows queued
        between two marks never overwrite an unread row."""
        self.slots = max(self.slots, 4 * int(steps))

    def mark(self, phase: str, device, start: bool = False) -> None:
        """A chunk boundary of ``phase`` on ``device`` (``start``: the
        first of an epoch): its clock, and a snapshot once ``R // 2``
        rows are pending."""
        ph = self._phase(phase)
        device = torch.device(device)
        if device.type == "cuda":
            clock = torch.cuda.Event(enable_timing=True)
            clock.record(torch.cuda.current_stream(device))
        else:
            clock = time.perf_counter()
        ph.marks.append((ph.queued, clock, start))
        if ph.ring is not None and ph.queued - ph.snapped >= ph.ring.slots // 2:
            self._snapshot(ph)

    def _snapshot(self, ph: _Phase) -> None:
        ring = ph.ring
        cuda = ring.vals.is_cuda
        host = ring.host_buffers()
        for h, t in zip(host, (ring.vals, ring.steps, ring.widx)):
            h.copy_(t, non_blocking=cuda)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(ring.vals.device))
        marks = list(ph.marks)
        # what a later row's rate can still reach back to
        keep = ph.queued - self._rate_window - 1
        ph.marks = [m for m in ph.marks if m[0] >= keep] or ph.marks[-1:]
        muted = [tuple(r) for r in ph.muted]
        ph.muted = [r for r in ph.muted if r[1] is None]
        ph.snapped = ph.queued
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._drain_loop, daemon=True,
                name="cgnn-step-stream")
            self._thread.start()
        self._q.put((ph, host, done, marks, muted))

    def _drain_loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                try:
                    self._decode(*item)
                except Exception:  # noqa: BLE001 — never kill training
                    with self._lock:
                        self.dropped += 1
            finally:
                self._q.task_done()

    def _rate(self, i: int, marks: list) -> float:
        """Steps per second around row ``i`` (module docstring)."""
        j = next((j for j, m in enumerate(marks) if m[0] > i), None)
        if j is None:
            return float("nan")
        m = j
        while (m > 0 and not marks[m][2]
               and marks[j][0] - marks[m - 1][0] <= self._rate_window):
            m -= 1
        if m == j:
            return float("nan")
        steps = marks[j][0] - marks[m][0]
        a, b = marks[m][1], marks[j][1]
        secs = (a.elapsed_time(b) / 1e3 if isinstance(a, torch.cuda.Event)
                else b - a)
        return steps / secs if secs > 0 else float("nan")

    def _decode(self, ph: _Phase, host: list, done, marks: list,
                muted: list) -> None:
        if done is not None:
            wait_event(done)
        vals, steps, widx = (h.numpy().copy() for h in host)
        ph.ring.free.append(host)
        widx = int(widx[0])
        slots = len(steps)
        lo = max(ph.drained, widx - slots)
        with self._lock:
            self.dropped += lo - ph.drained
        keys = ph.ring.keys
        for i in range(lo, widx):
            if any(a <= i and (b is None or i < b) for a, b in muted):
                continue
            row = vals[i % slots].astype(np.float64)
            step_no = int(steps[i % slots])
            if step_no < 0:
                step_no = ph.seq
                ph.seq += 1
            rec = {"phase": ph.name, "step": step_no,
                   **_derive_means(dict(zip(keys, map(float, row))))}
            rate = self._rate(i, marks)
            if rate == rate:
                rec["steps_per_s"] = rate
            with self._lock:
                self.ring.append(rec)
            if self._logger is not None:
                self._logger.event("step", rec)
        ph.drained = max(ph.drained, widx)

    def flush(self, wait: bool = True) -> None:
        """Snapshot every ring with rows pending now; with ``wait``, also
        wait until the drain thread has turned every row into a record (a
        sync with the device: for run ends and tests, not for a step)."""
        with self._lock:
            phases = list(self._phases.values())
        for ph in phases:
            if ph.ring is not None and ph.queued > ph.snapped:
                self._snapshot(ph)
        if wait:
            self._q.join()

    def close(self) -> None:
        self.flush()
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
            self._thread.join(5.0)

    @contextlib.contextmanager
    def muted(self) -> Iterator[None]:
        """Drop the rows queued inside the context (warm-up and capture
        runs are not training signal)."""
        with self._lock:
            phases = list(self._phases.values())
        opened = [(ph, [ph.queued, None]) for ph in phases]
        for ph, r in opened:
            ph.muted.append(r)
        try:
            yield
        finally:
            for ph, r in opened:
                r[1] = ph.queued
            # a phase first tapped inside the context: all of it so far
            with self._lock:
                fresh = [ph for ph in self._phases.values()
                         if all(ph is not o for o, _ in opened)]
            for ph in fresh:
                ph.muted.append([0, ph.queued])

    def records(self, phase: str | None = None) -> list[dict]:
        with self._lock:
            recs = list(self.ring)
        return recs if phase is None else [
            r for r in recs if r["phase"] == phase
        ]
