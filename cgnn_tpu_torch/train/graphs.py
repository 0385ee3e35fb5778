"""Captured steps: the port's form of ``jax.jit`` (CUDA graphs).

A ``StepGraph`` is one step body captured for one batch shape
(``data.graph.batch_shape_key``) on a CUDA device:

- static input tensors, copies of an example batch's on the device;
- warm-up runs of the body on a side stream before capture (PyTorch's
  whole-network capture recipe: lazy initialization, the kernels' first
  build and launch, the autograd engine's set-up happen there); one side
  stream a thread and device (``capture_stream``), since cuBLAS keeps a
  workspace for every stream it has run on;
- capture on that stream (``CUDAGraph.capture_begin``/``capture_end``:
  ``torch.cuda.graph`` would also synchronize and empty the allocator's
  cache each time), in thread-local mode (a loader thread's copies on
  their own stream do not break it; that stream comes from another
  stream pool, so it is never the capture stream);
- ``run(batch)``: ``copy_`` into the static inputs on the current
  stream, then ``replay()``; the outputs are static tensors, written
  again by the next replay.

``eager_runs`` defers the capture: the first ``eager_runs`` runs step
eagerly on a copy of their batch on the device, and the next run
captures from its batch, so a shape met no more than ``eager_runs``
times costs what eager steps cost (bulk predict).

On the CPU ``run`` calls the body eagerly on the batch it is given: the
tests run that path. A graph's pool and static tensors go back to the
allocator when its ``StepGraph`` is dropped: nothing here holds its
owner (``GraphCache`` keeps a bound method weakly), so reference counts
free them without a ``gc.collect()``. On CUDA a capture that fails raises
``GraphCaptureError``; there is no eager fallback.

A train body updates parameters, running statistics and the optimizer
in its warm-up runs: ``guard`` (``state_guard``) snapshots what a step
writes before them and copies it back after the capture, or after its
failure, in place, so a capture leaves the state as it found it and the
graph holds the same addresses. The optimizer's host count is raised
once a replay (``on_replay``).

A step that draws random numbers (a classifier's dropout) draws them
from generators of its own (``state_generators``), never the global one.
``generators`` registers each with the graph before the capture
(``CUDAGraph.register_generator_state``), so every replay draws from the
generator's current seed and offset and advances it, as an eager step
does: a replay draws a fresh mask, and a replay and an eager step from
the same generator state draw the same bits. ``state_guard`` snapshots
and restores the generators' states with the rest, so a capture leaves
them as it found them.

The data-parallel train step is two graphs around a collective, which
a graph cannot hold (gloo runs on the host; NCCL's capture is later
work): graph A (kind ``train``, one a batch shape) runs the forward and
backward and writes the gradients, the new BatchNorm statistics and the
metric sums into one flat bucket; the host all-reduces the bucket; graph
B (kind ``train_apply``, one for every shape: it reads only the bucket)
averages the gradient and statistics regions, runs the optimizer and the
guard's select and adds the summed metrics up (parallel/data_parallel.py
``ParallelTrainStep``, train/loop.py ``SplitStepRunner``).

A body's host callbacks (``on_each_run``: the step stream counting its
rows, observe/stream.py) run once for each run of the step: at once on
an eager run, at every replay when registered inside the capture, never
on a warm-up run (``warming``).

``COUNTS`` holds, for each kind of step (``train``, ``eval``,
``predict``, ``predict_raw``, the raw wire's step with its neighbor
search, and ``train_apply``), ``<kind>_runs`` (calls of ``run``: replays and eager steps),
``<kind>_replays``, ``<kind>_captures`` and ``<kind>_warm_runs`` (the
warm-up runs before the captures: ``WARMUP_RUNS[kind]`` a capture). A
kernel wrapper counts the launches it makes
(``ops/_build.counted``): those of eager steps and warm-up runs, not a
replay's. A ``GraphCache`` (one graph per key) counts
``captures_after_warm``, the captures after its owner declared it warm
(``mark_warm``): the counterpart of the JAX
``serve_recompiles_after_warm``.
"""

from __future__ import annotations

import dataclasses
import gc
import inspect
import threading
import weakref
from typing import Callable, Sequence

import torch

COUNTS: dict = {}
KINDS = ("train", "eval", "predict", "predict_raw", "train_apply")
# warm-up runs before a capture: two for a train step (the autograd
# engine and the optimizer set up on the first), one for a forward-only
# step, whose first run initializes all it needs, and one for the
# data-parallel step's update (plain tensor ops on static buffers)
WARMUP_RUNS = {"train": 2, "eval": 1, "predict": 1, "predict_raw": 1,
               "train_apply": 1}


# serving's threads engine runs steps on one thread an entry
_COUNTS_LOCK = threading.Lock()


def reset_counts() -> None:
    with _COUNTS_LOCK:
        COUNTS.clear()
        for kind in KINDS:
            for what in ("runs", "replays", "captures", "warm_runs"):
                COUNTS[f"{kind}_{what}"] = 0


def _bump(key: str) -> None:
    with _COUNTS_LOCK:
        COUNTS[key] += 1


reset_counts()


class GraphCaptureError(RuntimeError):
    """A step could not be captured as a CUDA graph."""


# this thread's capture state: set while a StepGraph runs its warm-ups
# (``warming``) and while it captures (the hooks its body registers)
_tls = threading.local()


def warming() -> bool:
    """True inside a StepGraph's warm-up runs before its capture."""
    return getattr(_tls, "warming", False)


def on_each_run(fn: Callable) -> None:
    """Run ``fn`` (a host callback) once for each run of the step being
    traced: now on an eager run; at every replay when called inside a
    capture (the graph keeps it); never on a warm-up run."""
    hooks = getattr(_tls, "hooks", None)
    if hooks is not None:
        hooks.append(fn)
    elif not warming():
        fn()


_capture_streams = threading.local()


def capture_stream(device, replay_stream=None) -> torch.cuda.Stream:
    """This thread's side stream on ``device`` for warm-up runs and
    captures of graphs that replay on ``replay_stream`` (None: the
    default stream), made once. cuBLAS keeps a workspace (32 MiB and 1
    MiB on an H100) for every stream it runs on, for the life of the
    process, so a new stream a graph would leave ~33 MiB behind each
    capture. A graph bakes its capture stream's workspace in, so graphs
    that replay at once on different streams (two entries of a device
    set) must capture on different side streams: sharing one workspace
    between concurrent replays races on it and has hung the card. It
    comes from the normal-priority pool, which the prefetch loader's
    side streams and the entries' streams do not (data/loader.py
    ``staging_stream``, serve/devices.py ``entry_streams``)."""
    streams = getattr(_capture_streams, "by_device", None)
    if streams is None:
        streams = _capture_streams.by_device = {}
    key = (device, replay_stream)
    stream = streams.get(key)
    if stream is None:
        stream = streams[key] = torch.cuda.Stream(device)
    return stream


def batch_tensors(batch) -> dict:
    """{field: tensor} of a batch dataclass (None fields left out)."""
    return {f.name: v for f in dataclasses.fields(batch)
            if (v := getattr(batch, f.name)) is not None}


def _static_copy(batch, device):
    """A batch of fresh tensors on ``device`` with ``batch``'s fields."""
    return dataclasses.replace(batch, **{
        k: v.to(device, copy=True) for k, v in batch_tensors(batch).items()})


def tensor_guard(tensors: Callable[[], list] = list,
                 sums: Sequence = ()) -> Callable:
    """-> a guard: called, it snapshots ``tensors()`` and the
    accumulators of each ``metrics.DeviceSums`` in ``sums``, and returns
    the restore, which copies them back in place (an accumulator made
    after the snapshot is zeroed)."""

    def guard():
        ts = list(tensors())
        saved = [t.detach().clone() for t in ts]
        sums_saved = [{k: v.clone() for k, v in s.sums.items()}
                      for s in sums]

        @torch.no_grad()
        def restore():
            for t, v in zip(ts, saved):
                t.copy_(v)
            for s, was in zip(sums, sums_saved):
                for k, v in s.sums.items():
                    if k in was:
                        v.copy_(was[k])
                    else:
                        v.zero_()

        return restore

    return guard


def state_generators(state) -> list:
    """The generators a train step of ``state`` draws from: the model's
    dropout generator where its train-mode forward draws a mask."""
    model = getattr(state, "model", None)
    draws = getattr(model, "draws_dropout", None)
    return [model.dropout_generator()] if draws is not None and draws() \
        else []


def state_guard(state, extra: Callable[[], list] = list,
                sums: Sequence = ()) -> Callable:
    """``tensor_guard`` over every tensor a train step of ``state``
    writes (parameters, buffers, optimizer buffers and device count),
    ``extra()`` and ``sums``; its restore also resets the host count,
    the generators' states (``state_generators``) and drops the
    gradients."""
    inner = tensor_guard(lambda: (list(state.model.parameters())
                                  + list(state.model.buffers())
                                  + state.optimizer.tensors()
                                  + list(extra())), sums)

    def guard():
        restore_tensors = inner()
        count = state.optimizer.count
        gens = state_generators(state)
        gen_states = [g.get_state() for g in gens]

        def restore():
            restore_tensors()
            for g, st in zip(gens, gen_states):
                g.set_state(st)
            state.optimizer._count = count
            state.optimizer.zero_grad()

        return restore

    return guard


class StepGraph:
    """One step body captured for one batch shape (module docstring).

    ``fn(batch)`` is the body; ``example`` a batch whose fields give the
    static inputs (None: the body reads no batch, e.g. the epoch
    driver's, which indexes its staged stacks itself). ``guard``
    (``state_guard``) restores the state after the warm-up runs;
    ``on_replay`` runs on the host after each replay; ``eager_runs``
    eager steps come before the capture. ``capture=False`` steps eagerly
    on any device. ``generators``: those the body draws from, registered
    with the graph (module docstring). ``replay_stream``: the stream the
    graph replays on (None: the default), which picks its capture
    stream (``capture_stream``)."""

    def __init__(self, fn: Callable, example=None, *, device,
                 kind: str = "predict", label: str = "step",
                 guard: Callable | None = None,
                 on_replay: Callable | None = None, capture: bool = True,
                 eager_runs: int = 0, generators: Sequence = (),
                 replay_stream=None):
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        self.fn = fn
        self.generators = tuple(generators)
        self.replay_stream = replay_stream
        self.device = torch.device(device)
        self.kind = kind
        self.label = label
        self.on_replay = on_replay
        self.replays = 0
        self.graph = None
        self.static = None
        self.out = None
        self.hooks: tuple = ()  # on_each_run callbacks of the capture
        # None: eager (the CPU, or capture=False); else eager steps left
        # before the capture
        self._eager_left = None
        if self.device.type != "cuda" or not capture:
            return
        self._guard = guard
        self._eager_left = eager_runs
        if eager_runs == 0:
            self._capture(example)

    def _body(self):
        return self.fn(self.static) if self.static is not None else self.fn()

    def _capture(self, example) -> None:
        """Static inputs from ``example``, warm-up runs on a side stream,
        then the capture there."""
        kind = self.kind
        dev = self.device
        self.static = None if example is None else _static_copy(example,
                                                                dev)
        restore = self._guard() if self._guard is not None else None
        self._side = capture_stream(dev, self.replay_stream)
        self._side.wait_stream(torch.cuda.current_stream(dev))
        _tls.warming = True
        try:
            with torch.cuda.stream(self._side):
                for _ in range(WARMUP_RUNS[kind]):
                    self._body()
                    _bump(f"{kind}_warm_runs")
        finally:
            _tls.warming = False
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            # before capture_begin: each replay then reads the generator's
            # seed and offset and advances it
            graph.register_generator_state(gen)
        # ``torch.cuda.graph`` would synchronize and empty the allocator's
        # cache first; the capture API alone does neither. A graph freed
        # by the garbage collector mid-capture (an old StepGraph in a
        # reference cycle) would destroy its executable, which a
        # capturing thread may not: the collector waits until the end
        collecting = gc.isenabled()
        gc.disable()
        _tls.hooks = hooks = []
        try:
            with torch.cuda.stream(self._side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.out = self._body()
                finally:
                    graph.capture_end()
        except Exception as e:
            if restore is not None:
                restore()
            raise GraphCaptureError(
                f"{self.label}: CUDA graph capture failed: {e!r}") from e
        finally:
            _tls.hooks = None
            if collecting:
                gc.enable()
        torch.cuda.current_stream(dev).wait_stream(self._side)
        if restore is not None:
            restore()
        self.graph = graph
        self.hooks = tuple(hooks)
        _bump(f"{kind}_captures")

    def run(self, batch=None):
        """One step: on CUDA, ``batch``'s tensors into the static inputs
        (when the graph has inputs) and a replay -> the static outputs
        (an eager step before the capture -> its own outputs); on the
        CPU the body on ``batch``."""
        _bump(f"{self.kind}_runs")
        if self._eager_left is None:
            return self.fn(batch) if batch is not None else self.fn()
        if self._eager_left > 0:
            self._eager_left -= 1
            if batch is None:
                return self.fn()
            return self.fn(batch.to(self.device, non_blocking=True))
        if self.graph is None:
            self._capture(batch)
        if batch is not None:
            static = batch_tensors(self.static)
            given = batch_tensors(batch)
            if static.keys() != given.keys():
                raise ValueError(
                    f"{self.label}: batch fields {sorted(given)} differ "
                    f"from the captured {sorted(static)}")
            for k, t in static.items():
                t.copy_(given[k], non_blocking=True)
        self.graph.replay()
        self.replays += 1
        _bump(f"{self.kind}_replays")
        for hook in self.hooks:
            hook()
        if self.on_replay is not None:
            self.on_replay()
        return self.out


class GraphCache:
    """One ``StepGraph`` per key, made on first use by ``make(key,
    *args)``; ``run`` steps a key's graph. ``captures_after_warm``
    counts the captures after ``mark_warm``, and ``log_fn`` says so
    loudly when one happens.

    A bound method as ``make`` is held by a weak reference: its owner
    keeps the cache, and a strong reference back would make a cycle
    that holds every graph, its memory pool and the owner's staged
    tensors until a ``gc.collect()`` (the graphs' closures must not
    reference the owner either)."""

    def __init__(self, make: Callable, log_fn: Callable | None = None,
                 label: str = "step"):
        self._make = (weakref.WeakMethod(make) if inspect.ismethod(make)
                      else lambda: make)
        self._log = log_fn
        self.label = label
        self.graphs: dict = {}
        self.warm = False
        self.captures_after_warm = 0

    def get(self, key, *args) -> StepGraph:
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._make()(key, *args)
            if g.graph is not None:
                self._captured(key)
        return g

    def run(self, key, batch=None, *args):
        """One step of ``key``'s graph (made from ``batch`` and ``args``
        on first use) on ``batch``."""
        g = self.get(key, batch, *args)
        pending = g.graph is None
        out = g.run(batch)
        if pending and g.graph is not None:
            self._captured(key)
        return out

    def _captured(self, key) -> None:
        if not self.warm:
            return
        self.captures_after_warm += 1
        if self._log is not None:
            self._log(f"{self.label}: CAPTURE AFTER WARM-UP for shape {key} "
                      f"(captures_after_warm={self.captures_after_warm})")

    def mark_warm(self) -> None:
        self.warm = True

    def replays(self) -> int:
        return sum(g.replays for g in self.graphs.values())

    def captures(self) -> int:
        return sum(g.graph is not None for g in self.graphs.values())
