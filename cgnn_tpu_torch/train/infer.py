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

Both run over a device set (``devices``, serve/devices.py; None: the
state's own device) with the JAX package's two engines (``engine``):

- ``'mesh'`` (``'auto'`` with more than one entry; parallel/executor.py):
  consecutive same-shape batches are grouped N at a time (a short group,
  at a shape change or the end, is padded with its last batch, whose rows
  are never read), stacked, each entry staged its own slice, and one
  sharded dispatch runs every entry's graph; outputs come back restacked
  on the caller's stream, into one window fetched there;
- ``'threads'``: batch k runs on entry k % N, on that entry's stream,
  against its replica; each entry has its own ``_WINDOW`` fence, its own
  buffer pool and its own ``_Fence``, so a pooled buffer goes back only
  once the entry that read it has passed its event.

Every entry holds its own state copy, graphs and stream; the answers are
bit-equal to one entry's on the same packed batches.
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
from cgnn_tpu_torch.serve.devices import (
    on_stream,
    replicate_state,
    state_device,
)
from cgnn_tpu_torch.train.graphs import GraphCache, StepGraph, batch_tensors
from cgnn_tpu_torch.train.step import make_predict_step, model_task

# batches in flight before the host fetches their outputs (the JAX
# package's dispatch window): one fetch per window, never one per batch
_WINDOW = 16


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
    at a time, each row written back to its input position (in ``sink``'s
    arrays: the windows of a set's entries share one)."""

    def __init__(self, n: int, sink: "_Window | None" = None):
        self.n = n
        self.sink = self if sink is None else sink
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
        sink = self.sink
        if sink.preds is None:
            sink.preds = np.zeros((self.n, host.shape[-1]), np.float32)
        off = 0
        for span, out, _ in self._pending:
            sink.preds[span] = host[off: off + len(span)]
            if ovf is not None:
                sink.flags += [int(span[k]) for k in
                               np.nonzero(ovf[off: off + len(span)])[0]]
            off += out.shape[0]
        self._pending = []


class _Entries:
    """A forward path's device set (module docstring), opened by
    ``parallel.executor.open_entries`` as the server's is: the engine
    that runs, each entry's stream and step, under the mesh engine its
    ``MeshExecutor``; here also each entry's state copy and predict
    graphs. ``make_step(device)`` builds the predict step for one
    device."""

    def __init__(self, state, devices, engine: str, make_step: Callable):
        from cgnn_tpu_torch.parallel.executor import open_entries

        ents = open_entries(devices or [state_device(state)], engine,
                            make_step)
        self.devices, self.engine = ents.devices, ents.engine
        self.mesh, self.streams = ents.mesh, ents.streams
        self.states = replicate_state(state, self.devices)
        self.caches = [_predict_graphs(*e) for e in zip(
            self.states, ents.steps, self.devices, self.streams)]

    def __len__(self) -> int:
        return len(self.devices)

    def run(self, i: int, batch):
        """Entry ``i``'s predict graph on ``batch`` (on the caller's
        stream: enter the entry's first)."""
        return _run(self.caches[i], batch)

    def sharded(self, batches: list):
        """One mesh dispatch of up to N same-shape batches (padded with
        the last) -> outputs [N, G, ...], restacked on the caller's
        stream."""
        mesh = self.mesh
        batches = batches + [batches[-1]] * (len(mesh) - len(batches))
        return mesh.shard_predict(self.run)(mesh.stage(mesh.stack(batches)))

    def flush(self, windows: list) -> None:
        """Fetch every window's rest. A threads window flushes on its
        entry's stream, which made its outputs; the mesh engine restacks
        on the caller's stream, so its window flushes there (entry 0's
        stream never waits for the restack)."""
        streams = ([None] * len(windows) if self.mesh is not None
                   else self.streams)
        for w, stream in zip(windows, streams):
            with on_stream(stream):
                w.flush()

    def stats(self) -> dict:
        replays = [c.replays() for c in self.caches]
        out = {"engine": self.engine, "entries": len(self),
               "graph_captures": sum(c.captures() for c in self.caches),
               "graph_replays": sum(replays), "entry_replays": replays}
        if self.mesh is not None:
            out["staged_bytes"] = list(self.mesh.staged_bytes)
        return out


def _predict_graphs(state, step, dev, stream=None) -> GraphCache:
    """One predict graph per batch shape, replayed on ``stream`` (the
    entry's): a shape's first two batches step eagerly and its third
    captures, so a shape met once or twice costs no capture."""

    def make(key, batch):
        return StepGraph(lambda b: step(state, b), batch,
                         device=dev, kind="predict_raw"
                         if key[0] == "RawBatch" else "predict",
                         label=f"predict graph {key}", eager_runs=2,
                         replay_stream=stream)

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
    on this thread, with the same outputs. ``devices`` (a list of
    devices, repeats included; None: the state's device) and ``engine``
    ('auto', 'mesh', 'threads'): the module docstring. ``stats``, when
    given, is filled with the batches packed, the dispatches (a mesh
    group is one), the packers' counters (``wait_s``, ``pack_s``,
    ``jobs``), the pools' (``buffers_allocated``, ``buffers_reused``),
    the engine, entries and graph counters (``entry_replays``: each
    entry's graph replays), and under the mesh engine
    each entry's ``staged_bytes``.
    """
    if not len(graphs):
        raise ValueError("no graphs to predict")
    if shape_set is not None and shape_set.compact is not None:
        if compact is not None and compact is not shape_set.compact:
            raise ValueError("shape_set already carries a compact spec")
        compact = shape_set.compact
    state.model.eval()
    # the edge features' storage type is the model's (a shape set and a
    # compact spec carry the same one)
    _, edge_dtype = model_task(state.model)
    ents = _Entries(state, devices, engine, lambda d: make_predict_step(
        expander=None if compact is None else make_expander(compact, d)))
    n_ent = len(ents)
    pin = any(d.type == "cuda" for d in ents.devices)
    # the threads engine's pools, one an entry; the mesh engine stacks
    # (copies) every batch at once and packs fresh
    pools = fences = None
    if compact is not None and ents.mesh is None:
        pools = [BufferPool() for _ in range(n_ent)]
        fences = [_Fence(p, d) for p, d in zip(pools, ents.devices)]

    def acquire(k, key, factory):
        # batch k runs on entry k % N: its buffer comes from that pool
        return None if pools is None else (
            key, pools[k % n_ent].acquire(key, factory))

    n = len(graphs)
    t0 = time.perf_counter()
    if shape_set is not None:
        def pack_job(job):
            k, (span, sub, shape) = job
            buf = None
            if compact is not None:
                buf = acquire(k, shape_set.buffer_key(shape),
                              shape_set.buffer_factory(shape, pin))
            batch = shape_set.pack(sub, shape=shape,
                                   out=None if buf is None else buf[1])
            return span, invariants.maybe_check(batch, shape_set.dense_m), \
                buf

        jobs = enumerate(_shape_set_plan(graphs, shape_set))
    else:
        tdim = int(np.atleast_1d(graphs[0].target).shape[0])

        def pack_job(job):
            k, (span, sub, nc, ec, graph_cap) = job
            buf = None
            if compact is None:
                batch = pack_graphs(sub, nc, ec, graph_cap, dense_m=dense_m,
                                    edge_dtype=edge_dtype)
            else:
                buf = acquire(k, compact_buffer_key(nc, dense_m, graph_cap,
                                                    tdim),
                              lambda: alloc_compact_buffers(
                                  nc, dense_m, graph_cap, tdim, pin=pin))
                batch = pack_compact(sub, nc, ec, graph_cap, compact,
                                     num_targets=tdim, dense_m=dense_m,
                                     out=None if buf is None else buf[1])
            return span, invariants.maybe_check(batch, dense_m), buf

        jobs = enumerate(_bucket_jobs(graphs, batch_size, buckets, dense_m,
                                      snug))
    pipe = PipelineStats()
    packed = (parallel_pack(jobs, pack_job, workers=pack_workers,
                            stats=pipe)
              if pack_workers > 0 else map(pack_job, jobs))
    windows = [_Window(n)]
    windows += [_Window(n, windows[0]) for _ in range(1, n_ent)]
    batches = dispatches = 0
    if ents.mesh is not None:
        group: list = []  # [(span, batch)] of one shape
        group_key = None
        for span, batch, _ in packed:
            batches += 1
            key = _shape_key(batch)
            if group and (key != group_key or len(group) == n_ent):
                dispatches += _mesh_group(ents, group, windows[0])
            group_key = key
            group.append((span, batch))
        if group:
            dispatches += _mesh_group(ents, group, windows[0])
    else:
        for k, (span, batch, buf) in enumerate(packed):
            i = k % n_ent
            batches += 1
            dispatches += 1
            with on_stream(ents.streams[i]):
                out = ents.run(i, batch)
                if buf is not None:
                    fences[i].add(buf)
                windows[i].add(span, out)
                if fences is not None:
                    fences[i].release_done()
    ents.flush(windows)
    for fence in fences or ():
        fence.release_done(wait=True)
    rate = n / (time.perf_counter() - t0)
    if stats is not None:
        stats.update(batches=batches, dispatches=dispatches,
                     wait_s=pipe.wait_s, pack_s=pipe.pack_s, jobs=pipe.jobs,
                     buffers_allocated=sum(p.allocated for p in pools or ()),
                     buffers_reused=sum(p.reused for p in pools or ()),
                     **ents.stats())
    return windows[0].preds, rate


def _mesh_group(ents: _Entries, group: list, window: _Window) -> int:
    """Dispatch a mesh group (``_Entries.sharded``), its real shards'
    outputs into ``window``, and empty it -> 1 (the dispatch)."""
    out = ents.sharded([b for _, b in group])
    if isinstance(out, tuple):
        for j, (span, _) in enumerate(group):
            window.add(span, out[0][j], out[1][j])
    else:
        for j, (span, _) in enumerate(group):
            window.add(span, out[j])
    group.clear()
    return 1


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
    stats: dict | None = None,
) -> tuple[np.ndarray, float]:
    """Predict wire-form ``RawStructure`` items through the device
    neighbor search -> ([n, T] predictions in input order, end-to-end
    structures/s).

    ``shape_set`` must carry a raw spec and admit every item
    (``admits_raw``; callers route the rest through the featurized path).
    Batches fill the largest rung's graph slots in input order; the tail
    takes the smallest rung whose slots fit it. Structures the device
    flags for cap overflow are re-served through ``raw_fallback``
    (RawStructure -> CrystalGraph) when given, else raise. ``devices``
    and ``engine``: as ``run_fast_inference``; ``stats`` gets the batches,
    dispatches and the device set's counters.
    """
    from cgnn_tpu_torch.data.rawbatch import RawStructure

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
    state.model.eval()
    ents = _Entries(state, devices, engine, lambda d: make_predict_step(
        raw_expander=shape_set.raw_expander(device=d)))
    n_ent = len(ents)
    n = len(items)
    t0 = time.perf_counter()
    big = shape_set.largest
    windows = [_Window(n)]
    windows += [_Window(n, windows[0]) for _ in range(1, n_ent)]
    group: list = []  # the mesh engine's [(span, batch)] of one rung
    batches = dispatches = 0
    for k, start in enumerate(range(0, n, big.graph_cap)):
        end = min(start + big.graph_cap, n)
        shape = next(s for s in shape_set.shapes
                     if s.graph_cap >= end - start)
        batch = shape_set.pack_raw(items[start:end], shape=shape)
        span = np.arange(start, end)
        batches += 1
        if ents.mesh is not None:
            if group and (_shape_key(group[0][1]) != _shape_key(batch)
                          or len(group) == n_ent):
                dispatches += _mesh_group(ents, group, windows[0])
            group.append((span, batch))
            continue
        i = k % n_ent
        dispatches += 1
        with on_stream(ents.streams[i]):
            preds, overflow, _ = ents.run(i, batch)
            windows[i].add(span, preds, overflow)
    if group:
        dispatches += _mesh_group(ents, group, windows[0])
    ents.flush(windows)
    window = windows[0]
    if stats is not None:
        stats.update(batches=batches, dispatches=dispatches, **ents.stats())
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
