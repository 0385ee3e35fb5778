"""Bulk forward-only inference: the predict entry point's path
(``cgnn_tpu/train/infer.py``).

- ``run_fast_inference`` predicts featurized graphs, packed either into a
  serving shape ladder (``shape_set``: greedy fill of the largest rung in
  input order, the ragged tail in the smallest rung that fits) or, with
  ``buckets``, into per-size-class snug capacities derived from the data
  (``assign_size_buckets``, ``plan_batches``);
- ``run_raw_inference`` predicts wire-form ``RawStructure``s through the
  raw expander, whose neighbor search (kernel 8 on the card) builds each
  graph on the device. A structure the device flags for cap overflow is
  re-served through ``raw_fallback`` (RawStructure -> CrystalGraph) on
  the featurized path, never answered from its truncated graph.

Both return ``([n, T] predictions in input order, end-to-end
structures/s including packing)``. Each batch runs its shape's predict
graph (train/graphs.py; one a rung and form on the shape-set path, one a
bucket shape on the buckets path): a shape's first two batches step
eagerly, its third captures the graph, and from then on the host batch
is copied into the graph's static inputs and the graph replayed; all
eager on the CPU. Each batch's output is copied out of the
graph's static output and stays on the device; the host fetches once
per ``_WINDOW`` batches, with one ``torch.cat(...).cpu()``, and never
syncs once per batch.

``run_fast_inference`` also stages compactly (``compact``, or a compact
shape set): batches pack into pooled staging buffers (data/compact.py;
pinned for a card) and the predict step's expander rebuilds them on the
device. The copy to the card is asynchronous, so a buffer goes back to
its pool only once a CUDA event recorded after its step (which follows
its copy) has completed (``_Fence``): before that, the next pack would
overwrite bytes the copy still reads. ``pack_workers > 0`` packs on that many threads
(data/pipeline.py), in order.

The buckets path packs snug (fill-to-capacity) batches, or with
``snug=False`` the ladder's (``capacities_for(snug=False)``: at most
``batch_size`` graphs a batch). Under ``--check-invariants``
(``data.invariants.enable``) every packer checks the batch it packs, on
its own thread, before the batch is staged.

Not ported yet, and refused with a ``ValueError`` naming the ROADMAP
item (Queue 1) when asked for: multi-device dispatch (``devices``,
``engine``: items 9 and 11).
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Sequence

import numpy as np
import torch

from cgnn_tpu_torch.data import invariants
from cgnn_tpu_torch.data.compact import (
    alloc_compact_buffers,
    compact_buffer_key,
    make_expander,
    pack_compact,
)
from cgnn_tpu_torch.data.graph import (
    assign_size_buckets,
    capacities_for,
    graph_cap_for,
    pack_graphs,
    plan_batches,
)
from cgnn_tpu_torch.data.pipeline import BufferPool, PipelineStats, parallel_pack
from cgnn_tpu_torch.train.graphs import GraphCache, StepGraph, batch_tensors
from cgnn_tpu_torch.train.step import make_predict_step, model_task

# batches in flight before the host fetches their outputs (the JAX
# package's dispatch window): one fetch per window, never one per batch
_WINDOW = 16


def _refuse_unported(devices=None, engine: str = "auto") -> None:
    if devices is not None or engine != "auto":
        raise ValueError("multi-device dispatch (devices, engine) is not "
                         "ported yet (ROADMAP Queue 1, items 9 and 11)")


def _state_device(state) -> torch.device:
    return next(state.model.parameters()).device


class _Fence:
    """Pooled staging buffers in dispatch order, each with the CUDA event
    recorded on the current stream right after its copy to the device
    (None on the CPU, where the step has read the buffer when it returns).
    A buffer goes back to its pool once its event has completed; the
    stream runs in order, so the oldest entry completes first."""

    def __init__(self, pool: BufferPool, dev: torch.device):
        self.pool = pool
        self.cuda = dev.type == "cuda"
        self._pending: collections.deque = collections.deque()

    def add(self, buf) -> None:
        ev = None
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
        self._pending.append((ev, buf))

    def release_done(self, wait: bool = False) -> None:
        while self._pending:
            ev, buf = self._pending[0]
            if ev is not None and not ev.query():
                if not wait:
                    return
                ev.synchronize()
            self._pending.popleft()
            self.pool.release(*buf)


class _Window:
    """Outputs kept on the device, fetched to the host ``_WINDOW`` batches
    at a time, each row written back to its input position."""

    def __init__(self, n: int):
        self.n = n
        self.preds: np.ndarray | None = None
        self.flags: list[int] = []  # input positions flagged for overflow
        self._pending: list = []  # (span, preds [G, T], overflow [G] | None)

    def add(self, span, out, overflow=None) -> None:
        self._pending.append((span, out, overflow))
        if len(self._pending) == _WINDOW:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        host = torch.cat([o for _, o, _ in self._pending]).cpu().numpy()
        ovf = None
        if self._pending[0][2] is not None:
            ovf = torch.cat([f for _, _, f in self._pending]).cpu().numpy()
        if self.preds is None:
            self.preds = np.zeros((self.n, host.shape[-1]), np.float32)
        off = 0
        for span, out, _ in self._pending:
            self.preds[span] = host[off: off + len(span)]
            if ovf is not None:
                self.flags += [int(span[k]) for k in
                               np.nonzero(ovf[off: off + len(span)])[0]]
            off += out.shape[0]
        self._pending = []


def _predict_graphs(state, step, dev) -> GraphCache:
    """One predict graph per batch shape: a shape's first two batches
    step eagerly and its third captures, so a shape met once or twice
    costs no capture."""

    def make(key, batch):
        return StepGraph(lambda b: step(state, b), batch,
                         device=dev, kind="predict_raw"
                         if key[0] == "RawBatch" else "predict",
                         label=f"predict graph {key}", eager_runs=2)

    return GraphCache(make, label="predict graph")


def _shape_key(batch) -> tuple:
    return (type(batch).__name__,) + tuple(
        (k, tuple(v.shape)) for k, v in batch_tensors(batch).items())


def _run(graphs: GraphCache, batch):
    """The batch's graph run -> its outputs, copied out of a captured
    graph's static outputs (the next replay writes them again)."""
    key = _shape_key(batch)
    out = graphs.run(key, batch)
    if graphs.graphs[key].graph is None:
        return out
    if isinstance(out, tuple):
        return tuple(o.clone() for o in out)
    return out.clone()


def _shape_set_plan(graphs: Sequence, shape_set):
    """Yield (index span, graph sublist, shape): greedy fill to the
    LARGEST rung in input order; the ragged tail takes the smallest rung
    that fits it. Spans are contiguous, so input order is kept."""
    big = shape_set.largest
    start = 0
    cur: list = []
    n = e = 0
    for i, g in enumerate(graphs):
        if not shape_set.admits(g):
            raise ValueError(
                f"graph {getattr(g, 'cif_id', i)!r} exceeds the shape set: "
                f"{shape_set.oversize_detail(g)}")
        gn, ge = shape_set.graph_counts(g)
        if cur and not big.fits(len(cur) + 1, n + gn, e + ge):
            yield np.arange(start, i), cur, big
            start, cur, n, e = i, [], 0, 0
        cur.append(g)
        n += gn
        e += ge
    if cur:
        yield (np.arange(start, len(graphs)), cur,
               shape_set.shape_for(len(cur), n, e))


def run_fast_inference(
    state,
    graphs: Sequence,
    batch_size: int,
    *,
    buckets: int = 1,
    dense_m: int | None = None,
    snug: bool = True,
    shape_set=None,
    compact=None,
    pack_workers: int = 0,
    devices=None,
    engine: str = "auto",
    stats: dict | None = None,
) -> tuple[np.ndarray, float]:
    """Predict featurized ``graphs`` with ``state`` (an InferenceState on
    its device) -> ([n, T] predictions in input order, end-to-end
    structures/s including host packing).

    With ``shape_set`` the batches pack into its fixed rungs and
    ``buckets``/``dense_m`` are ignored (the set carries the layout).
    Without, graphs are split into ``buckets`` node-count classes, each
    packed at its own capacities in input order: snug (fill-to-capacity),
    or the ladder's with ``snug=False``.

    ``compact`` (a ``data.compact.CompactSpec``; a compact ``shape_set``
    implies it) stages the compact form into pooled buffers (module
    docstring). ``pack_workers > 0`` packs on that many threads; 0 packs
    on this thread, with the same outputs. ``stats``, when given, is
    filled with the batches run, the packers' counters (``wait_s``,
    ``pack_s``, ``jobs``) and the pool's (``buffers_allocated``,
    ``buffers_reused``).
    """
    _refuse_unported(devices, engine)
    if not len(graphs):
        raise ValueError("no graphs to predict")
    if shape_set is not None and shape_set.compact is not None:
        if compact is not None and compact is not shape_set.compact:
            raise ValueError("shape_set already carries a compact spec")
        compact = shape_set.compact
    dev = _state_device(state)
    state.model.eval()
    # the edge features' storage type is the model's (a shape set and a
    # compact spec carry the same one)
    _, edge_dtype = model_task(state.model)
    step = make_predict_step(
        expander=None if compact is None else make_expander(compact, dev))
    pin = dev.type == "cuda"
    pool = BufferPool() if compact is not None else None
    fence = None if pool is None else _Fence(pool, dev)

    def acquire(key, factory):
        return key, pool.acquire(key, factory)

    n = len(graphs)
    t0 = time.perf_counter()
    if shape_set is not None:
        def pack_job(job):
            span, sub, shape = job
            buf = None
            if pool is not None:
                buf = acquire(shape_set.buffer_key(shape),
                              shape_set.buffer_factory(shape, pin))
            batch = shape_set.pack(sub, shape=shape,
                                   out=None if buf is None else buf[1])
            return span, invariants.maybe_check(batch, shape_set.dense_m), \
                buf

        jobs = _shape_set_plan(graphs, shape_set)
    else:
        tdim = int(np.atleast_1d(graphs[0].target).shape[0])

        def pack_job(job):
            span, sub, nc, ec, graph_cap = job
            buf = None
            if compact is None:
                batch = pack_graphs(sub, nc, ec, graph_cap, dense_m=dense_m,
                                    edge_dtype=edge_dtype)
            else:
                buf = acquire(compact_buffer_key(nc, dense_m, graph_cap,
                                                 tdim),
                              lambda: alloc_compact_buffers(
                                  nc, dense_m, graph_cap, tdim, pin=pin))
                batch = pack_compact(sub, nc, ec, graph_cap, compact,
                                     num_targets=tdim, dense_m=dense_m,
                                     out=buf[1])
            return span, invariants.maybe_check(batch, dense_m), buf

        jobs = _bucket_jobs(graphs, batch_size, buckets, dense_m, snug)
    pipe = PipelineStats()
    packed = (parallel_pack(jobs, pack_job, workers=pack_workers,
                            stats=pipe)
              if pack_workers > 0 else map(pack_job, jobs))
    window = _Window(n)
    cache = _predict_graphs(state, step, dev)
    batches = 0
    for span, batch, buf in packed:
        batches += 1
        out = _run(cache, batch)
        if buf is not None:
            fence.add(buf)
        window.add(span, out)
        if fence is not None:
            fence.release_done()
    window.flush()
    if fence is not None:
        fence.release_done(wait=True)
    rate = n / (time.perf_counter() - t0)
    if stats is not None:
        stats.update(batches=batches, wait_s=pipe.wait_s,
                     pack_s=pipe.pack_s, jobs=pipe.jobs,
                     buffers_allocated=0 if pool is None else pool.allocated,
                     buffers_reused=0 if pool is None else pool.reused,
                     graph_captures=cache.captures(),
                     graph_replays=cache.replays())
    return window.preds, rate


def _bucket_jobs(graphs, batch_size, buckets, dense_m, snug=True):
    """(index span, graphs, node_cap, edge_cap, graph_cap) per batch of
    each size class in turn, in input order within a class."""
    bucket_of = assign_size_buckets(graphs, buckets)
    graph_cap = graph_cap_for(batch_size) if snug else batch_size
    for b in range(int(bucket_of.max()) + 1):
        idxs = np.nonzero(bucket_of == b)[0]
        if len(idxs) == 0:
            continue
        sub = [graphs[int(i)] for i in idxs]
        nc, ec = capacities_for(sub, batch_size, dense_m=dense_m, snug=snug)
        for s, e in plan_batches(sub, batch_size, nc, ec, snug=snug):
            yield idxs[s:e], sub[s:e], nc, ec, graph_cap


def run_raw_inference(
    state,
    items: Sequence,
    shape_set,
    *,
    devices=None,
    engine: str = "auto",
    raw_fallback: Callable | None = None,
) -> tuple[np.ndarray, float]:
    """Predict wire-form ``RawStructure`` items through the device
    neighbor search -> ([n, T] predictions in input order, end-to-end
    structures/s).

    ``shape_set`` must carry a raw spec and admit every item
    (``admits_raw``; callers route the rest through the featurized path).
    Batches fill the largest rung's graph slots in input order; the tail
    takes the smallest rung whose slots fit it. Structures the device
    flags for cap overflow are re-served through ``raw_fallback``
    (RawStructure -> CrystalGraph) when given, else raise.
    """
    from cgnn_tpu_torch.data.rawbatch import RawStructure

    _refuse_unported(devices=devices, engine=engine)
    if shape_set is None or shape_set.raw is None:
        raise ValueError("run_raw_inference needs a shape set with a raw "
                         "spec (plan_shape_set(raw=...))")
    if not len(items):
        raise ValueError("no structures to predict")
    for it in items:
        if not isinstance(it, RawStructure):
            raise ValueError("run_raw_inference takes RawStructure items")
        if not shape_set.admits_raw(it):
            raise ValueError(
                f"structure {it.cif_id!r} exceeds the raw rung caps: "
                f"{shape_set.raw.oversize_detail(it)} — route it through "
                f"the featurized path")
    dev = _state_device(state)
    state.model.eval()
    step = make_predict_step(raw_expander=shape_set.raw_expander(device=dev))
    n = len(items)
    t0 = time.perf_counter()
    big = shape_set.largest
    window = _Window(n)
    cache = _predict_graphs(state, step, dev)
    for start in range(0, n, big.graph_cap):
        end = min(start + big.graph_cap, n)
        shape = next(s for s in shape_set.shapes
                     if s.graph_cap >= end - start)
        batch = shape_set.pack_raw(items[start:end], shape=shape)
        preds, overflow, _ = _run(cache, batch)
        window.add(np.arange(start, end), preds, overflow)
    window.flush()
    preds = window.preds
    if window.flags:
        # the device's cap-overflow flag fired: never serve a truncated
        # graph; re-serve those rows host-featurized
        if raw_fallback is None:
            bad = [items[i].cif_id or str(i) for i in window.flags]
            raise RuntimeError(
                f"in-program cap-overflow flag on {bad}; pass raw_fallback= "
                f"to re-serve them host-featurized")
        fgraphs = [raw_fallback(items[i]) for i in window.flags]
        fpreds, _ = run_fast_inference(state, fgraphs, max(1, len(fgraphs)),
                                       shape_set=shape_set)
        preds[window.flags] = fpreds
    return preds, n / (time.perf_counter() - t0)
