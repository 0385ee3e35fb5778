"""The in-process online inference server (``cgnn_tpu/serve/server.py``).

``InferenceServer`` is socket-free: ``submit()`` -> future -> result,
driven by one named worker thread::

    submit(CrystalGraph, RawStructure or Structure)
      -> admission checks (malformed / oversize / queue-full / draining);
         a wire-form structure (a Structure becomes a RawStructure) is
         staged 'raw' when it fits the raw caps, else 'feat' (deferred)
      -> batcher.offer (a change of form cuts a flush)
    worker "cgnn-torch-serve":
      batcher.next_flush() -> expired requests fail with TIMEOUT
        raw flush:  ShapeSet.pack_raw -> the rung's raw predict graph (the
                    device neighbor search builds the graph) -> rows;
                    a structure flagged for cap overflow is re-offered as
                    a featurized request with the same future
        feat flush: deferred structures are featurized HERE, on the
                    worker, never on the caller's thread (a failure fails
                    that request alone) -> ShapeSet.pack_full -> the
                    rung's full predict graph; with a compact spec, a
                    flush whose every graph is compactable (probed here,
                    on the worker, in one vectorized pass) packs
                    ShapeSet.pack into a pooled staging buffer and
                    replays the compact graph instead (the expander
                    rebuilds the batch on the device), counted
                    ``pack_compact``, else ``pack_full``
        -> resolve each future with its row

Each (staging form, rung) has one predict graph (train/graphs.py): the
step captured as a CUDA graph at ``warm()`` (full, compact where the
template stages compactly, raw with a raw spec). A flush copies its host
batch into the graph's static inputs and replays it; it never captures.
``stats()["counts"]["captures_after_warm"]`` counts captures after
``warm()`` (the JAX ``serve_recompiles_after_warm``): 0 by construction,
and a rise is logged loudly. On the CPU the step runs eagerly.

In the flat COO layout (``ShapeSet.dense_m`` None) there is no raw wire,
and a wire-form structure is featurized at admission, on the caller's
thread: a flush's edge budget needs its true edge count, which only
featurization knows. A featurization failure rejects it alone (400).

``drain()`` is the stop path: it closes admission, lets the worker answer
what was accepted, and joins it. ``counts["batches"]`` counts the flushes
that ran, ``counts["pack_raw"]`` the raw ones, so a caller can tie kernel
launches to flushes. A pooled compact buffer goes back to its pool after
the flush's answers are fetched, which waits for the device. The JAX
package probes compactability at admission, on the caller's thread; the
port probes on the worker, because callers running numpy under the GIL
beside the worker's eager dispatch cut a burst's requests/s 4x (measured
on an H100 host). Not ported yet: hot reload, the result cache, precision
tiers, multi-device engines, the background packer thread, the
edge-occupancy gauges and the observability plane.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from cgnn_tpu_torch.config import DataConfig, ModelConfig
from cgnn_tpu_torch.convert import from_flax_variables, load_params
from cgnn_tpu_torch.data.compact import CompactSpec, CompactUnsupported
from cgnn_tpu_torch.data.elements import MAX_Z
from cgnn_tpu_torch.data.graph import CrystalGraph
from cgnn_tpu_torch.data.pipeline import BufferPool
from cgnn_tpu_torch.data.rawbatch import (
    RawStructure,
    RawUnsupported,
    plan_raw_spec,
)
from cgnn_tpu_torch.data.structure import Structure
from cgnn_tpu_torch.device import resolve_device
from cgnn_tpu_torch.serve.batcher import (
    MALFORMED,
    OVERSIZE,
    TIMEOUT,
    Flush,
    MicroBatcher,
    Request,
    RequestFuture,
    ServeRejection,
)
from cgnn_tpu_torch.serve.shapes import ShapeSet, plan_shape_set
from cgnn_tpu_torch.train.checkpoint import inference_state, load_for_inference
from cgnn_tpu_torch.train.graphs import GraphCache, StepGraph
from cgnn_tpu_torch.train.normalizer import Normalizer
from cgnn_tpu_torch.train.step import InferenceState, make_predict_step


@dataclasses.dataclass
class ServeResult:
    """One answered request."""

    prediction: np.ndarray  # [T] denormalized
    param_version: str
    latency_ms: float
    batch_occupancy: float = 0.0  # real graphs / graph slots of its batch
    flush_id: str = ""
    wire: str = "featurized"  # 'raw' (device-built graph) | 'featurized'


class InferenceServer:
    """Micro-batching online inference over a shape ladder on one device.

    ``state`` holds the eval model and normalizer; both move to
    ``device`` (default CUDA, which raises when absent). With a raw spec
    on the shape set, the raw expander runs the neighbor search as kernel
    8 on a CUDA device and as its plain version on the CPU; a kernel that
    fails to build or launch raises. ``raw_precheck=False`` skips
    the host image-cap check at admission and leaves the decision to the
    device's overflow flag.
    """

    def __init__(
        self,
        state: InferenceState,
        shape_set: ShapeSet,
        *,
        version: str = "init",
        max_queue: int = 256,
        max_wait_ms: float = 5.0,
        default_timeout_ms: float | None = 1000.0,
        featurizer: Callable[[RawStructure], CrystalGraph] | None = None,
        device="cuda",
        log_fn: Callable = print,
        raw_precheck: bool = True,
    ):
        self.device = resolve_device(device)
        self.state = InferenceState(state.model.to(self.device).eval(),
                                    state.normalizer.to(self.device))
        self.shape_set = shape_set
        self.version = version
        self.predict_step = make_predict_step(
            raw_expander=shape_set.raw_expander(device=self.device),
            expander=shape_set.expander(device=self.device))
        self.graphs = GraphCache(self._make_graph, log_fn=log_fn,
                                 label="serve: predict graph")
        self._pool = None if shape_set.compact is None else BufferPool()
        self._raw_precheck = bool(raw_precheck)
        self.batcher = MicroBatcher(shape_set, max_queue=max_queue,
                                    max_wait_ms=max_wait_ms)
        self.default_timeout = (
            None if default_timeout_ms is None else default_timeout_ms / 1000.0
        )
        self.featurizer = featurizer
        self._log = log_fn
        self._worker: threading.Thread | None = None
        self._lock = threading.Lock()
        self.counts: dict[str, int] = {
            "requests": 0, "responses": 0, "batches": 0,
            "batch_failures": 0, "reject_queue_full": 0,
            "reject_oversize": 0, "reject_timeout": 0,
            "reject_shutdown": 0, "reject_malformed": 0,
            "pack_raw": 0, "responses_raw": 0, "ingest_cap_overflow": 0,
            "pack_compact": 0, "pack_full": 0,
        }
        self._latencies: list[float] = []
        # (atom feature width, edge feature width) learned at warm(): the
        # admission gate that keeps a malformed request from failing a
        # whole co-batched flush
        self._feature_dims: tuple[int, int] | None = None

    # ---- lifecycle ----

    def warm(self, template: CrystalGraph) -> int:
        """Capture every rung's predict graph with one copy of
        ``template`` (in both staging forms with a compact spec, and,
        with a raw spec, the raw form with ``spec.template()``), each run
        once: builds the kernels and initializes the device libraries
        before traffic. -> the number of rungs."""
        self._feature_dims = (template.atom_fea.shape[1],
                              template.edge_fea.shape[1])
        raw = self.shape_set.raw
        for shape in self.shape_set:
            batch = self.shape_set.pack_full([template], shape=shape)
            self._predict("full", shape, batch).cpu()
            if self.shape_set.compactable(template):
                # through a pooled staging buffer: its pinned allocation
                # is paid here, not by the rung's first flush
                key = self.shape_set.buffer_key(shape)
                buf = self._pool.acquire(key, self.shape_set.buffer_factory(
                    shape, pin=self.device.type == "cuda"))
                cb = self.shape_set.pack([template], shape=shape, out=buf)
                self._predict("compact", shape, cb).cpu()
                self._pool.release(key, buf)
            if raw is not None:
                rb = self.shape_set.pack_raw([raw.template()], shape=shape)
                self._predict("raw", shape, rb)[0].cpu()
        self.graphs.mark_warm()
        self._log(f"serve: warmed {len(self.shape_set)} shapes on "
                  f"{self.device} ({self.graphs.captures()} predict graphs "
                  f"captured)")
        return len(self.shape_set)

    def _make_graph(self, key, batch) -> StepGraph:
        return StepGraph(lambda b: self.predict_step(self.state, b),
                         batch, device=self.device,
                         kind="predict_raw" if key[0] == "raw"
                         else "predict", label=f"serve: predict graph {key}")

    def _predict(self, form: str, shape, batch):
        """The predict step on a host ``batch`` of ``form`` ('full',
        'compact', 'raw') at rung ``shape``: its graph's replay on CUDA
        (outputs static: fetch them before the next flush), eagerly on
        the CPU."""
        return self.graphs.run((form, shape), batch)

    def start(self) -> "InferenceServer":
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._serve_loop, daemon=True, name="cgnn-torch-serve")
            self._worker.start()
        return self

    def begin_drain(self) -> None:
        """Stop admitting; already-queued requests still get answers."""
        self.batcher.close()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """begin_drain + wait for the worker to answer the queue and exit.
        True when it exited within the timeout."""
        self.begin_drain()
        if self._worker is None:
            self._serve_loop()  # never started: answer accepted work here
            return True
        self._worker.join(timeout=timeout_s)
        return not self._worker.is_alive()

    # ---- request path ----

    def _check_wellformed(self, graph: CrystalGraph) -> None:
        """A malformed graph fails ALONE at admission (400): packed, it
        would fail every innocent co-batched request."""
        problems = []
        if self._feature_dims is not None:
            nd, ed = self._feature_dims
            if np.ndim(graph.atom_fea) != 2 or graph.atom_fea.shape[1] != nd:
                problems.append(f"atom_fea must be [N, {nd}], got "
                                f"{np.shape(graph.atom_fea)}")
            if np.ndim(graph.edge_fea) != 2 or graph.edge_fea.shape[1] != ed:
                problems.append(f"edge_fea must be [E, {ed}], got "
                                f"{np.shape(graph.edge_fea)}")
        n, e = graph.num_nodes, graph.num_edges
        if n < 1:
            problems.append("structure has no atoms")
        if len(graph.edge_fea) != e:
            problems.append(
                f"{e} edges but {len(graph.edge_fea)} edge feature rows")
        for name in ("centers", "neighbors"):
            idx = np.asarray(getattr(graph, name))
            if len(idx) and (idx.min() < 0 or idx.max() >= n):
                problems.append(
                    f"{name} indices outside [0, {n}) "
                    f"(min {idx.min()}, max {idx.max()})")
        if problems:
            raise ServeRejection(MALFORMED, "; ".join(problems))

    def _check_wellformed_raw(self, rs: RawStructure) -> None:
        """A wire-form structure the device search (or the featurizer)
        would choke on fails ALONE at admission (400): no atoms, species
        outside the element table, non-finite geometry, a singular
        lattice."""
        problems = []
        if rs.num_nodes < 1:
            problems.append("structure has no atoms")
        z = rs.numbers
        if len(z) and (z.min() < 1 or z.max() > MAX_Z):
            problems.append(
                f"species outside the element table [1, {MAX_Z}] "
                f"(min {z.min()}, max {z.max()})")
        if not (np.isfinite(rs.frac_coords).all()
                and np.isfinite(rs.lattice).all()):
            problems.append("non-finite coordinates or lattice")
        elif abs(float(np.linalg.det(rs.lattice))) < 1e-6:
            problems.append("degenerate lattice (volume ~ 0)")
        if problems:
            raise ServeRejection(MALFORMED, "; ".join(problems))

    def _admit_form(self, rs: RawStructure) -> str:
        """'raw' when the structure fits the raw caps (the host f64
        pre-check, or with ``raw_precheck=False`` only the atom-slot cap,
        leaving the image decision to the device's overflow flag), else
        'feat': featurized on the worker at pack time."""
        spec = self.shape_set.raw
        if spec is not None:
            if self._raw_precheck:
                if spec.admits(rs):
                    return "raw"
            elif 1 <= rs.num_nodes <= spec.snode_cap:
                return "raw"
        if self.featurizer is None:
            raise ServeRejection(
                MALFORMED,
                "wire-form structure cannot be served: "
                + (spec.oversize_detail(rs) if spec is not None
                   else "raw wire is not enabled")
                + " and no featurizer is configured")
        return "feat"

    def submit(self, graph: CrystalGraph | RawStructure | Structure,
               timeout_ms: float | None = None) -> RequestFuture:
        """Admit one structure; returns its future (raises ServeRejection
        on malformed / oversize / queue-full / draining). A wire-form
        structure (a ``Structure`` becomes a ``RawStructure``) is staged
        raw when it fits the raw caps; otherwise the worker featurizes it
        at pack time, never this thread."""
        now = time.monotonic()
        self._count("requests")
        try:
            form = "feat"
            if isinstance(graph, Structure):
                graph = RawStructure.from_structure(graph)
            if isinstance(graph, RawStructure):
                self._check_wellformed_raw(graph)
                form = self._admit_form(graph)
                if form == "feat" and self.shape_set.dense_m is None:
                    graph = self._featurize_at_admission(graph)
            else:
                self._check_wellformed(graph)
            timeout = (timeout_ms / 1000.0 if timeout_ms is not None
                       else self.default_timeout)
            req = Request(graph=graph, enqueued=now,
                          deadline=None if timeout is None else now + timeout,
                          form=form)
            self.batcher.offer(req)
        except ServeRejection as e:
            self._count(f"reject_{e.reason}")
            raise
        return req.future

    def _featurize_at_admission(self, rs: RawStructure) -> CrystalGraph:
        """The COO layout's admission: featurize on the caller's thread
        (module docstring); a failure rejects this structure alone."""
        try:
            graph = self.featurizer(rs)
        except Exception as e:  # noqa: BLE001 — reject this request alone
            raise ServeRejection(
                MALFORMED, f"structure featurization failed: {e}") from None
        self._check_wellformed(graph)
        return graph

    def predict(self, graph: CrystalGraph | RawStructure | Structure,
                timeout_ms: float | None = None) -> ServeResult:
        """Blocking convenience: submit + wait."""
        fut = self.submit(graph, timeout_ms=timeout_ms)
        timeout = (timeout_ms / 1000.0 if timeout_ms is not None
                   else self.default_timeout)
        return fut.result(None if timeout is None else timeout + 30.0)

    # ---- the worker ----

    def _serve_loop(self) -> None:
        while True:
            flush = self.batcher.next_flush()
            if flush is None:
                return
            self._process(flush)

    def _process(self, flush: Flush) -> None:
        for r in flush.expired:
            self._count("reject_timeout")
            r.future.set_error(ServeRejection(
                TIMEOUT, f"deadline exceeded after "
                f"{(time.monotonic() - r.enqueued) * 1e3:.1f} ms in queue"))
        raw = flush.form == "raw"
        if not raw:
            self._featurize_pending(flush)
        reqs = flush.requests
        if not reqs:
            return
        overflow = buf = None
        try:
            if raw:
                self._count("pack_raw")
                batch = self.shape_set.pack_raw([r.graph for r in reqs],
                                                shape=flush.shape)
                preds, overflow, _ = self._predict("raw", flush.shape,
                                                   batch)
                out = preds.cpu().numpy()
                overflow = overflow.cpu().numpy()
            else:
                batch, buf = self._pack_featurized(flush)
                out = self._predict("full" if buf is None else "compact",
                                    flush.shape, batch).cpu().numpy()
        except Exception as e:  # noqa: BLE001 — fail the flush, not the server
            self._log(f"serve: batch {flush.flush_id} failed: {e!r}")
            self._count("batch_failures")
            for r in reqs:
                r.future.set_error(e)
            return
        finally:
            if buf is not None:
                if self.device.type == "cuda":
                    # the fetch above has waited for the copy that reads
                    # the buffer; a failed flush may have left it running
                    torch.cuda.current_stream(self.device).synchronize()
                self._pool.release(*buf)
        now = time.monotonic()
        occupancy = len(reqs) / flush.shape.graph_cap
        wire = "raw" if raw else "featurized"
        for i, r in enumerate(reqs):
            if overflow is not None and overflow[i]:
                # the device's cap-overflow flag: this row came from a
                # truncated graph and is never served
                self._fallback_overflow(r)
                continue
            latency_ms = (now - r.enqueued) * 1e3
            r.future.set_result(ServeResult(
                prediction=out[i].copy(), param_version=self.version,
                latency_ms=latency_ms, batch_occupancy=occupancy,
                flush_id=flush.flush_id, wire=wire))
            self._record_latency(latency_ms)
            self._count("responses")
            if raw:
                self._count("responses_raw")
        self._count("batches")

    def _pack_featurized(self, flush: Flush):
        """-> (batch, pooled buffer or None): the compact form into a
        pooled staging buffer when the set has a compact spec and every
        graph of the flush is compactable, else the full form."""
        graphs = [r.graph for r in flush.requests]
        if self.shape_set.compact is None:
            return self.shape_set.pack_full(graphs, shape=flush.shape), None
        if not all(self.shape_set.compact.compactable_many(graphs)):
            self._count("pack_full")
            return self.shape_set.pack_full(graphs, shape=flush.shape), None
        key = self.shape_set.buffer_key(flush.shape)
        buf = (key, self._pool.acquire(key, self.shape_set.buffer_factory(
            flush.shape, pin=self.device.type == "cuda")))
        try:
            batch = self.shape_set.pack(graphs, shape=flush.shape, out=buf[1])
        except Exception:
            self._pool.release(*buf)
            raise
        self._count("pack_compact")
        return batch, buf

    def _featurize_pending(self, flush: Flush) -> None:
        """Featurize the flush's deferred wire-form structures here, on
        the worker, never on the admission thread. A structure the
        featurizer rejects fails alone (400); the rest of the flush goes
        on."""
        keep = []
        for r in flush.requests:
            if isinstance(r.graph, RawStructure):
                try:
                    if self.featurizer is None:
                        raise ValueError("no featurizer configured")
                    g = self.featurizer(r.graph)
                    self._check_wellformed(g)
                except Exception as e:  # noqa: BLE001 — fail this request only
                    self._count("reject_malformed")
                    r.future.set_error(ServeRejection(
                        MALFORMED, f"structure featurization failed: {e}"))
                    continue
                r.graph = g
            keep.append(r)
        flush.requests = keep

    def _fallback_overflow(self, r: Request) -> None:
        """Re-offer an overflow-flagged raw request as a featurized one
        with the same future and deadline (the worker featurizes it, a
        featurized flush answers it)."""
        self._count("ingest_cap_overflow")
        if self.featurizer is None:
            r.future.set_error(ServeRejection(
                OVERSIZE, self.shape_set.raw.oversize_detail(r.graph)
                + " (device cap-overflow flag; no featurizer configured)"))
            return
        try:
            self.batcher.offer(Request(graph=r.graph, enqueued=r.enqueued,
                                       deadline=r.deadline, future=r.future,
                                       form="feat"))
        except ServeRejection as e:
            self._count(f"reject_{e.reason}")
            r.future.set_error(e)

    # ---- bookkeeping ----

    def _count(self, key: str) -> None:
        with self._lock:
            self.counts[key] = self.counts.get(key, 0) + 1

    def _record_latency(self, latency_ms: float) -> None:
        with self._lock:
            self._latencies.append(latency_ms)
            del self._latencies[:-8192]

    def latency_quantiles(self) -> dict:
        """{p50, p95, p99, mean, count} over recent responses (ms)."""
        with self._lock:
            vals = list(self._latencies)
        if not vals:
            return {}
        arr = np.asarray(vals)
        p50, p95, p99 = np.percentile(arr, [50, 95, 99])
        return {"p50": float(p50), "p95": float(p95), "p99": float(p99),
                "mean": float(arr.mean()), "count": len(vals)}

    def stats(self) -> dict:
        with self._lock:
            counts = dict(self.counts)
        counts.update(graph_captures=self.graphs.captures(),
                      graph_replays=self.graphs.replays(),
                      captures_after_warm=self.graphs.captures_after_warm)
        return {
            "counts": counts,
            "queue_depth": self.batcher.depth,
            "param_version": self.version,
            "device": str(self.device),
            "latency_ms": self.latency_quantiles(),
            "shapes": [s.to_meta() for s in self.shape_set],
            "raw": (None if self.shape_set.raw is None
                    else self.shape_set.raw.to_meta()),
            "compact": self.shape_set.compact is not None,
        }


def structure_featurizer(data_cfg: DataConfig) -> Callable:
    """RawStructure (or Structure) -> CrystalGraph with the checkpoint's
    featurization config, so online requests are featurized like the
    training data (the deferred featurize and the cap-overflow
    fallback)."""
    from cgnn_tpu_torch.data.dataset import featurize_structure

    cfg = data_cfg.featurize_config()
    gdf = cfg.gdf()

    def featurize(rs: RawStructure | Structure) -> CrystalGraph:
        s = Structure(rs.lattice, rs.frac_coords, rs.numbers)
        target = getattr(rs, "target", None)
        return featurize_structure(
            s, np.zeros(1, np.float32) if target is None else target, cfg,
            getattr(rs, "cif_id", ""), gdf,
            target_mask=getattr(rs, "target_mask", None))

    return featurize


def _load_weight_file(params_npz: str, meta_json: str, dev):
    """(InferenceState, meta) from convert.save_params' two files."""
    variables, meta = load_params(params_npz, meta_json)
    state = inference_state(meta, dev)
    state.model.load_state_dict(from_flax_variables(variables))
    t = state.normalizer.mean.numel()
    norm = meta.get("normalizer") or {}
    state.normalizer = Normalizer.from_arrays(
        norm.get("mean", [0.0] * t), norm.get("std", [1.0] * t), device=dev)
    return state, meta


def load_server(
    path: str,
    meta_json: str | None = None,
    *,
    tag: str = "latest",
    batch_size: int = 64,
    rungs: int = 3,
    calibration: Sequence[CrystalGraph] | None = None,
    calibration_n: int = 256,
    max_queue: int = 256,
    max_wait_ms: float = 5.0,
    default_timeout_ms: float | None = 1000.0,
    device="cuda",
    log_fn: Callable = print,
    wire: str = "auto",
    raw_precheck: bool = True,
    compact: str = "auto",
):
    """Boot an InferenceServer from a saved model at ``path``: a parameter
    file and its meta (``load_server(npz, meta_json)``,
    convert.save_params), or a checkpoint directory
    (``load_server(ckpt_dir, tag=...)``,
    train/checkpoint.py; ``tag`` 'latest' or 'best', the fallback chain's
    choice naming the version). Rebuild the model from the meta's
    configs, plan the shape ladder from ``calibration`` (default:
    synthetic structures drawn with the checkpoint's own featurization
    config, geometry kept), warm every rung, start the worker.

    ``wire``: 'raw' also serves wire-form structures through the device
    neighbor search (a raw spec planned from the calibration's lattices),
    'featurized' featurizes them on the host, 'auto' is 'raw' on a CUDA
    device and 'featurized' on the CPU. A COO weight file (``dense_m``
    0) serves the featurized wire only, whatever ``wire`` asks, and says
    so in the log. ``raw_precheck``: see InferenceServer.

    ``compact``: 'on' stages featurized flushes compactly (a
    ``CompactSpec`` built from the calibration), 'off' never, 'auto' on a
    CUDA device with the dense layout. Where the calibration cannot stage
    compactly (``CompactUnsupported``) the log says why and flushes pack
    full.

    -> (server, dict of what callers reuse: meta, configs, template graph,
    the calibration sample).
    """
    if wire not in ("auto", "raw", "featurized"):
        raise ValueError(
            f"wire must be 'auto', 'raw' or 'featurized', got {wire!r}")
    if compact not in ("auto", "on", "off"):
        raise ValueError(
            f"compact must be 'auto', 'on' or 'off', got {compact!r}")
    dev = resolve_device(device)
    if meta_json is None:
        state, meta, version = load_for_inference(path, tag, dev)
    else:
        state, meta = _load_weight_file(path, meta_json, dev)
        version = os.path.basename(path)
    model_cfg = ModelConfig.from_meta(meta["model"]).for_arbitrary_inputs()
    data_cfg = DataConfig.from_meta(meta["data"])
    if calibration is None:
        from cgnn_tpu_torch.data.dataset import load_synthetic

        calibration = load_synthetic(calibration_n,
                                     data_cfg.featurize_config(), seed=0,
                                     keep_geometry=True)
    dense_m = model_cfg.dense_m or None
    raw_spec = None
    want_raw = wire == "raw" or (wire == "auto" and dev.type == "cuda")
    if want_raw and dense_m is None:
        log_fn("serve: raw wire requires the dense layout; featurized wire "
               "only")
    elif want_raw:
        fcfg = data_cfg.featurize_config()
        try:
            raw_spec = plan_raw_spec(list(calibration), fcfg.gdf(),
                                     fcfg.radius, dense_m)
        except RawUnsupported as e:
            log_fn(f"serve: raw wire unavailable ({e}); featurized wire "
                   f"only")
    compact_spec = None
    want_compact = compact == "on" or (compact == "auto"
                                       and dev.type == "cuda")
    if want_compact and dense_m is None:
        log_fn("serve: compact staging requires the dense layout; full "
               "packing")
    elif want_compact:
        try:
            compact_spec = CompactSpec.build(
                list(calibration), data_cfg.featurize_config().gdf(),
                dense_m=dense_m)
        except CompactUnsupported as e:
            log_fn(f"serve: compact staging unavailable ({e}); full "
                   f"packing")
    shape_set = plan_shape_set(
        calibration, batch_size, rungs=rungs, dense_m=dense_m,
        num_targets=model_cfg.num_targets, compact=compact_spec,
        raw=raw_spec,
    )
    template = calibration[0]
    server = InferenceServer(
        state, shape_set, version=version, max_queue=max_queue,
        max_wait_ms=max_wait_ms, default_timeout_ms=default_timeout_ms,
        featurizer=structure_featurizer(data_cfg), device=dev,
        log_fn=log_fn, raw_precheck=raw_precheck,
    )
    server.warm(template)
    server.start()
    return server, {"meta": meta, "model_cfg": model_cfg,
                    "data_cfg": data_cfg, "template": template,
                    "calibration": calibration}
