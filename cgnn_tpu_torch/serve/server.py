"""The in-process online inference server (``cgnn_tpu/serve/server.py``).

``InferenceServer`` is socket-free: ``submit()`` -> future -> result. The
HTTP front end (serve/http.py) and the entry point (``python -m
cgnn_tpu_torch.serve``) are thin layers on top::

    submit(CrystalGraph, RawStructure or Structure, class, tenant, ...)
      -> admission checks (malformed / unknown class / oversize /
         queue-full / draining); a wire-form structure (a Structure
         becomes a RawStructure) is staged 'raw' when it fits the raw
         caps, else 'feat' (featurized later, on a packer)
      -> result cache: a hit whose version is live answers at once
      -> single-flight: a miss for a fingerprint already in flight waits
         on that leader's future instead of entering the batcher
      -> batcher.offer (priority classes, WFQ, backfill; serve/batcher.py)
    the flush stream (_flushes): batcher.next_flush(); expired requests
      fail with TIMEOUT here, before the pack stage
    pack stage (_pack_flush), on ``pack_workers`` packer threads
      (data/pipeline.py parallel_pack, in flush order) or in line:
        raw flush:  ShapeSet.pack_raw
        feat flush: deferred structures featurized (a failure fails that
                    request alone); with a compact spec, a flush whose
                    every graph is compactable (one vectorized probe)
                    packs ShapeSet.pack into a pooled pinned buffer,
                    counted ``pack_compact``, else ShapeSet.pack_full
    the worker "cgnn-torch-serve" (_run_flush), in flush order:
      under the dispatch lock: the fault point, copy into the rung's
      predict graph's static inputs, replay, fetch; then each future gets
      its row (a raw row the device flagged for cap overflow is
      re-offered as a featurized request with the same future), and the
      cache its (row, version)
    the reload watcher (serve/reload.py), on its own thread: a verified
      save goes live under the same dispatch lock, so between two flushes

So while the worker replays flush N, flush N+1 packs and the batcher
coalesces N+2; ``pack_workers=0`` runs the same stages on the worker.
Only the worker touches a ``StepGraph``. A pooled buffer goes back to its
pool after the flush's fetch (which waits for the device); a failed flush
synchronizes the stream first. Answers leave in flush order, and a pack
error fails its own flush only.

Each (staging form, rung) has one predict graph (train/graphs.py): the
step captured as a CUDA graph at ``warm()`` (full, compact where the
template stages compactly, raw with a raw spec). A flush never captures:
``stats()["counts"]["captures_after_warm"]`` counts captures after
``warm()`` (the JAX ``serve_recompiles_after_warm``), 0 by construction,
and a rise is logged loudly. A hot reload copies new weights into the
tensors the graphs read (serve/reload.py), so it captures nothing either.
On the CPU the step runs eagerly.

In the flat COO layout (``ShapeSet.dense_m`` None) there is no raw wire,
and a wire-form structure is featurized at admission, on the caller's
thread: a flush's edge budget needs its true edge count, which only
featurization knows.

``drain()`` is the stop path: admission closes (503), the worker answers
what was accepted and exits. ``install_signal_handlers()`` turns SIGTERM
and SIGINT into that drain.

A model serves in the dtype it was trained in: a bf16 model's flushes stage
bf16 edge features on every wire (``ShapeSet.edge_dtype``, from the
meta's ``dtype``) and run the bf16 kernel instances; a classifier answers
its ``num_classes`` log-probs, a multi-task model its T targets.

Not ported yet: precision tiers other than the model's own (the
``quantize.py`` tiers, ROADMAP Queue 1, item 11), multi-device engines (items 9 and 11), the edge-occupancy gauges, the
telemetry, span, SLO, time-series and flight-recorder plane (item 11), the
label journal and peer cache fill (item 12).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
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
from cgnn_tpu_torch.data.pipeline import BufferPool, PipelineStats, parallel_pack
from cgnn_tpu_torch.data.rawbatch import (
    RawStructure,
    RawUnsupported,
    plan_raw_spec,
    raw_fingerprint,
)
from cgnn_tpu_torch.data.structure import Structure
from cgnn_tpu_torch.device import resolve_device
from cgnn_tpu_torch.resilience import faultinject
from cgnn_tpu_torch.serve.batcher import (
    CLASSES,
    DEFAULT_CLASS,
    MALFORMED,
    OVERSIZE,
    TIMEOUT,
    Flush,
    MicroBatcher,
    Request,
    RequestFuture,
    ServeRejection,
)
from cgnn_tpu_torch.serve.cache import ResultCache, structure_fingerprint
from cgnn_tpu_torch.serve.reload import CheckpointWatcher, ParamStore
from cgnn_tpu_torch.serve.shapes import ShapeSet, plan_shape_set
from cgnn_tpu_torch.train.checkpoint import (
    CheckpointManager,
    inference_state,
    load_for_inference,
)
from cgnn_tpu_torch.train.graphs import GraphCache, StepGraph
from cgnn_tpu_torch.train.normalizer import Normalizer
from cgnn_tpu_torch.train.step import InferenceState, make_predict_step

# the precision tiers this server warms: the model's own, named f32 (the
# quantized tiers are ROADMAP Queue 1, item 11)
PRECISIONS = ("f32",)


@dataclasses.dataclass
class ServeResult:
    """One answered request."""

    prediction: np.ndarray  # [T] denormalized
    param_version: str
    latency_ms: float
    cached: bool = False
    precision: str = "f32"
    batch_occupancy: float = 0.0  # real graphs / graph slots of its batch
    device_id: int = 0  # -1 for a cache hit: no device computed it
    trace_id: str = ""
    flush_id: str = ""
    # monotonic stage stamps (perf_counter s): queued, packed,
    # dispatched, fetched, replied; a hit carries queued and replied
    stamps: dict = dataclasses.field(default_factory=dict)
    wire: str = "featurized"  # 'raw' (device-built graph) | 'featurized'
    klass: str = DEFAULT_CLASS
    backfilled: bool = False  # rode a higher-class flush's padding slack
    coalesced: bool = False  # copied from an identical request in flight


class InferenceServer:
    """Micro-batching online inference over a shape ladder on one device.

    ``state`` holds the eval model and normalizer; both move to
    ``device`` (default CUDA, which raises when absent). With a raw spec
    on the shape set, the raw expander runs the neighbor search as kernel
    8 on a CUDA device and as its plain version on the CPU; a kernel that
    fails to build or launch fails its flush. ``raw_precheck=False``
    skips the host image-cap check at admission and leaves the decision
    to the device's overflow flag. ``pack_workers`` packer threads pack
    flushes while the worker replays (0: the worker packs).
    ``cache_size`` 0 disables the result cache."""

    def __init__(
        self,
        state: InferenceState,
        shape_set: ShapeSet,
        *,
        version: str = "init",
        max_queue: int = 256,
        max_wait_ms: float = 5.0,
        class_max_wait_ms: dict | None = None,
        backfill: bool = True,
        wfq_weights: dict | None = None,
        default_timeout_ms: float | None = 1000.0,
        cache_size: int = 1024,
        pack_workers: int = 1,
        featurizer: Callable[[RawStructure], CrystalGraph] | None = None,
        device="cuda",
        log_fn: Callable = print,
        raw_precheck: bool = True,
    ):
        self.device = resolve_device(device)
        self.state = InferenceState(state.model.to(self.device).eval(),
                                    state.normalizer.to(self.device))
        self.param_store = ParamStore(self.state, version)
        self.shape_set = shape_set
        self.precisions = PRECISIONS
        self.predict_step = make_predict_step(
            raw_expander=shape_set.raw_expander(device=self.device),
            expander=shape_set.expander(device=self.device))
        self.graphs = GraphCache(self._make_graph, log_fn=log_fn,
                                 label="serve: predict graph")
        self._pool = None if shape_set.compact is None else BufferPool()
        self._pack_workers = max(0, int(pack_workers))
        self._raw_precheck = bool(raw_precheck)
        self.batcher = MicroBatcher(
            shape_set, max_queue=max_queue, max_wait_ms=max_wait_ms,
            class_max_wait_ms=class_max_wait_ms, backfill=backfill,
            wfq_weights=wfq_weights)
        self.default_timeout = (
            None if default_timeout_ms is None else default_timeout_ms / 1000.0
        )
        self.cache = ResultCache(cache_size) if cache_size else None
        # single flight: one leader per fingerprint in flight
        self._sf_lock = threading.Lock()
        self._inflight: dict[str, dict] = {}
        self.featurizer = featurizer
        self._log = log_fn
        self._worker: threading.Thread | None = None
        self._watcher: CheckpointWatcher | None = None
        # held by the worker across a flush's swap, replay and fetch, so
        # a hot reload lands only between two flushes
        self._dispatch_lock = threading.Lock()
        self._lock = threading.Lock()
        self._draining = False
        self.warmed = False
        self.counts: dict[str, int] = {
            "requests": 0, "responses": 0, "batches": 0,
            "batch_failures": 0, "cache_hits": 0, "cache_coalesced": 0,
            "reject_queue_full": 0,
            "reject_oversize": 0, "reject_timeout": 0,
            "reject_shutdown": 0, "reject_malformed": 0,
            "pack_raw": 0, "responses_raw": 0, "ingest_cap_overflow": 0,
            "pack_compact": 0, "pack_full": 0, "reloads": 0,
        }
        self._latencies: list[float] = []
        self._occupancies: list[float] = []
        # where the worker's time goes (s): packing on the worker (the
        # in-line path), waiting on the pack stage, and dispatch (copy,
        # replay, fetch, answers); the packers' own time is in _pipe
        self._timing = {"pack_s": 0.0, "wait_s": 0.0, "dispatch_s": 0.0}
        self._pipe = PipelineStats()
        self._trace_prefix = os.urandom(3).hex()
        self._trace_seq = itertools.count(1)
        # (atom feature width, edge feature width) learned at warm(): the
        # admission gate that keeps a malformed request from failing a
        # whole co-batched flush
        self._feature_dims: tuple[int, int] | None = None

    @property
    def version(self) -> str:
        """The live parameter version."""
        return self.param_store.version

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
        with self._dispatch_lock:
            for shape in self.shape_set:
                batch = self.shape_set.pack_full([template], shape=shape)
                self._predict("full", shape, batch).cpu()
                if self.shape_set.compactable(template):
                    # through a pooled staging buffer: its pinned
                    # allocation is paid here, not by the first flush
                    key = self.shape_set.buffer_key(shape)
                    buf = self._pool.acquire(key, self._buffer_factory(shape))
                    cb = self.shape_set.pack([template], shape=shape, out=buf)
                    self._predict("compact", shape, cb).cpu()
                    self._pool.release(key, buf)
                if raw is not None:
                    rb = self.shape_set.pack_raw([raw.template()],
                                                 shape=shape)
                    self._predict("raw", shape, rb)[0].cpu()
        self.graphs.mark_warm()
        self.warmed = True
        self._log(f"serve: warmed {len(self.shape_set)} shapes on "
                  f"{self.device} ({self.graphs.captures()} predict graphs "
                  f"captured)")
        return len(self.shape_set)

    def _buffer_factory(self, shape):
        return self.shape_set.buffer_factory(
            shape, pin=self.device.type == "cuda")

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
        if self._watcher is not None:
            self._watcher.start()
        return self

    def attach_watcher(self, manager: CheckpointManager, make_staging,
                       poll_interval_s: float = 2.0,
                       log_fn: Callable | None = None) -> CheckpointWatcher:
        """Hot reload from ``manager``'s directory (serve/reload.py):
        ``make_staging()`` builds a fresh state of the serving model on
        the serving device for each restore."""
        self._watcher = CheckpointWatcher(
            manager, self.param_store, make_staging,
            poll_interval_s=poll_interval_s, on_stage=self._on_stage,
            log_fn=log_fn or self._log)
        if self._worker is not None and self._worker.is_alive():
            self._watcher.start()
        return self._watcher

    @property
    def watcher(self) -> CheckpointWatcher | None:
        return self._watcher

    def _on_stage(self, version: str) -> None:  # noqa: ARG002 — the watcher's hook
        """A reload was staged (the watcher's thread): it goes live under
        the dispatch lock, which the worker holds across each flush's
        replay and fetch, so between two flushes and on the stream the
        replays use; the cache's rows of the old version go."""
        with self._dispatch_lock:
            old = self.param_store.version
            new = self.param_store.apply_pending()
            if new is None:
                return
            if self.cache is not None:
                self.cache.clear()
        self._count("reloads")
        self._log(f"hot reload: swapped params {old} -> {new}")

    def install_signal_handlers(self):
        """SIGTERM/SIGINT -> graceful drain (resilience/preempt.py).
        Returns the PreemptionHandler; the caller decides what follows
        the drain (the entry point shuts its listener and exits)."""
        from cgnn_tpu_torch.resilience.preempt import PreemptionHandler

        handler = PreemptionHandler(
            log_fn=self._log,
            action="draining the serving queue (accepted requests will be "
                   "answered; new ones rejected 503)")
        handler.add_callback(self.begin_drain)
        return handler.install()

    def begin_drain(self) -> None:
        """Stop admitting; already-queued requests still get answers.
        Quick and thread-safe (called from signal handlers)."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
        self.batcher.close()
        self._log("serve: draining (no new requests; flushing queue)")

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def drain(self, timeout_s: float = 30.0) -> bool:
        """begin_drain + wait for the worker to answer the queue and exit.
        True when it exited within the timeout."""
        self.begin_drain()
        if self._watcher is not None:
            self._watcher.stop()
        if self._worker is None:
            self._serve_loop()  # never started: answer accepted work here
            return True
        self._worker.join(timeout=timeout_s)
        return not self._worker.is_alive()

    # ---- request path ----

    def _mint_trace(self, requested: str | None = None) -> str:
        """The inbound X-Request-Id (printable, at most 128 characters)
        when the client sent one, else a fresh ``req-<prefix>-<seq>``."""
        if requested:
            rid = "".join(c if c.isprintable() and c not in '\\"'
                          else "_" for c in str(requested).strip())
            if rid:
                return rid[:128]
        return f"req-{self._trace_prefix}-{next(self._trace_seq):06x}"

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
        'feat': featurized on a packer at pack time."""
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
               timeout_ms: float | None = None,
               trace_id: str | None = None,
               precision: str | None = None,
               trace_parent: str | None = None,
               klass: str | None = None,
               tenant: str | None = None,
               fingerprint: str | None = None) -> RequestFuture:
        """Admit one structure; returns its future (raises ServeRejection
        on malformed / unknown class or precision / oversize / queue-full
        / draining). A wire-form structure (a ``Structure`` becomes a
        ``RawStructure``) is staged raw when it fits the raw caps; else a
        packer featurizes it at pack time, never this thread.
        ``trace_id`` carries an inbound X-Request-Id (minted when absent),
        ``trace_parent`` an inbound X-Trace-Parent span; ``klass`` the
        priority class (default 'interactive') and ``tenant`` the WFQ
        tenant; ``fingerprint`` a hash computed upstream, used only when
        its form matches the admitted one ('raw:' for raw-wire requests,
        a bare digest for featurized ones)."""
        now = time.monotonic()
        queued = time.perf_counter()
        tid = self._mint_trace(trace_id)
        tier = precision or "f32"
        kl = klass or DEFAULT_CLASS
        form = "feat"
        self._count("requests")
        try:
            if tier not in self.precisions:
                raise ServeRejection(
                    MALFORMED, f"precision {tier!r} not in this server's "
                               f"warmed tiers {list(self.precisions)}")
            if kl not in CLASSES:
                raise ServeRejection(
                    MALFORMED,
                    f"unknown priority class {kl!r} (have: {list(CLASSES)})")
            if isinstance(graph, Structure):
                graph = RawStructure.from_structure(graph)
            if isinstance(graph, RawStructure):
                self._check_wellformed_raw(graph)
                form = self._admit_form(graph)
                if form == "feat" and self.shape_set.dense_m is None:
                    graph = self._featurize_at_admission(graph)
            else:
                self._check_wellformed(graph)
        except ServeRejection as e:
            self._count(f"reject_{e.reason}")
            raise
        is_raw_wire = isinstance(graph, RawStructure)
        fp = self._cache_key(graph, is_raw_wire, form, fingerprint)
        if fp is not None:
            hit = self.cache.get(fp)
            if hit is not None:
                row, version = hit
                # served only while its version is live: a flush in
                # flight across a swap writes its rows after the clear
                if version == self.param_store.version:
                    return self._answer_hit(row, version, tid, queued, now,
                                            form, kl)
        timeout = (timeout_ms / 1000.0 if timeout_ms is not None
                   else self.default_timeout)
        req = Request(graph=graph, enqueued=now,
                      deadline=None if timeout is None else now + timeout,
                      fingerprint=fp, trace_id=tid,
                      stamps={"queued": queued}, precision=tier, form=form,
                      trace_parent=str(trace_parent or ""), klass=kl,
                      tenant=str(tenant or ""))
        if fp is not None:
            follower = None
            with self._sf_lock:
                entry = self._inflight.get(fp)
                if entry is None:
                    self._inflight[fp] = {"req": req, "followers": []}
                else:
                    follower = {"future": RequestFuture(), "trace_id": tid,
                                "queued": queued, "t0": now, "klass": kl,
                                "tier": tier}
                    entry["followers"].append(follower)
            if follower is not None:
                self._count("cache_coalesced")
                return follower["future"]
            # the leader's completion (answer, error or expiry, on
            # whichever thread) answers every follower
            req.future.add_done_callback(
                lambda f, _fp=fp: self._singleflight_done(_fp, f))
        try:
            self.batcher.offer(req)
        except ServeRejection as e:
            if fp is not None:
                # the leader never entered the batcher: relay its
                # rejection to followers that attached meanwhile
                with self._sf_lock:
                    cur = self._inflight.get(fp)
                    waiters = ()
                    if cur is not None and cur.get("req") is req:
                        waiters = self._inflight.pop(fp)["followers"]
                for w in waiters:
                    w["future"].set_error(e)
            self._count(f"reject_{e.reason}")
            raise
        return req.future

    def _cache_key(self, graph, is_raw_wire: bool, form: str,
                   fingerprint: str | None) -> str | None:
        """The request's cache key, or None without a cache. A raw-wire
        request's ``raw:`` key becomes ``fs:`` when the host featurizes
        it: the two programs agree only to f32 round-off, and a cached
        row is determined by (parameters, structure, program)."""
        if self.cache is None:
            return None
        fp = None
        if fingerprint:
            cand = str(fingerprint)
            if is_raw_wire and cand.startswith("raw:"):
                fp = cand
            elif not is_raw_wire and ":" not in cand:
                fp = cand
        if fp is None:
            fp = (raw_fingerprint(graph) if is_raw_wire
                  else structure_fingerprint(graph))
        if is_raw_wire and form != "raw":
            fp = "fs:" + fp[len("raw:"):]
        return fp

    def _answer_hit(self, row, version, tid, queued, t0, form,
                    kl) -> RequestFuture:
        self._count("cache_hits")
        fut = RequestFuture()
        latency_ms = (time.monotonic() - t0) * 1e3
        fut.set_result(ServeResult(
            prediction=row, param_version=version, latency_ms=latency_ms,
            cached=True, device_id=-1, trace_id=tid,
            stamps={"queued": queued, "replied": time.perf_counter()},
            wire="raw" if form == "raw" else "featurized", klass=kl))
        self._record_latency(latency_ms)
        self._count(f"responses_class_{kl}")
        return fut

    def _singleflight_done(self, fp: str, fut) -> None:
        """Leader completion: drop ``fp``'s waiter entry and answer each
        coalesced follower from the leader's outcome."""
        with self._sf_lock:
            entry = self._inflight.pop(fp, None)
        if not entry or not entry["followers"]:
            return
        try:
            res, err = fut.result(0), None
        except BaseException as e:  # noqa: BLE001 — relayed verbatim
            res, err = None, e
        for w in entry["followers"]:
            if err is not None:
                self._count("cache_coalesced_errors")
                w["future"].set_error(err)
                continue
            latency_ms = (time.monotonic() - w["t0"]) * 1e3
            w["future"].set_result(ServeResult(
                prediction=res.prediction, param_version=res.param_version,
                latency_ms=latency_ms, cached=res.cached,
                device_id=res.device_id, trace_id=w["trace_id"],
                precision=w["tier"],
                stamps={"queued": w["queued"],
                        "replied": time.perf_counter()},
                wire=res.wire, klass=w["klass"], coalesced=True))
            self._record_latency(latency_ms)
            self._count("responses")
            self._count(f"responses_class_{w['klass']}")

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

    def predict(self, graph, timeout_ms: float | None = None,
                **kw) -> ServeResult:
        """Blocking convenience: submit + wait (``kw``: submit's)."""
        fut = self.submit(graph, timeout_ms=timeout_ms, **kw)
        # past the serving deadline: the worker delivers the expiry
        timeout = (timeout_ms / 1000.0 if timeout_ms is not None
                   else self.default_timeout)
        return fut.result(None if timeout is None else timeout + 30.0)

    # ---- the flush stream, the pack stage and the worker ----

    def _serve_loop(self) -> None:
        if self._pack_workers > 0:
            stream = iter(parallel_pack(
                self._flushes(), self._pack_one, workers=self._pack_workers,
                stats=self._pipe, raise_on_error=False,
                name="cgnn-torch-serve-pack"))
        else:
            stream = map(self._pack_one, self._flushes())
        while True:
            t0 = time.perf_counter()
            packed0 = self._timing["pack_s"]
            try:
                item = next(stream)
            except StopIteration:
                return
            except Exception as e:  # noqa: BLE001 — a stream error: keep serving
                self._log(f"serve: pack pipeline error: {e!r}")
                continue
            # the wait for the next flush, less packing done in line
            self._timing["wait_s"] += (time.perf_counter() - t0
                                       - (self._timing["pack_s"] - packed0))
            self._run_flush(*item)

    def _flushes(self):
        """The flush stream: expiries are answered here, before the pack
        stage, so a timed-out client hears at once."""
        while True:
            flush = self.batcher.next_flush()
            if flush is None:
                return
            self._fail_expired(flush)
            if flush.requests:
                yield flush

    def _fail_expired(self, flush: Flush) -> None:
        for r in flush.expired:
            self._count("reject_timeout")
            r.future.set_error(ServeRejection(
                TIMEOUT, f"deadline exceeded after "
                f"{(time.monotonic() - r.enqueued) * 1e3:.1f} ms in queue"))

    def _pack_one(self, flush: Flush):
        """The pack stage of one flush -> (flush, batch, pooled buffer,
        error): on a packer thread, or on the worker with no packers."""
        t0 = time.perf_counter()
        try:
            batch, buf = self._pack_flush(flush)
            err = None
        except Exception as e:  # noqa: BLE001 — fail the flush, not the stream
            batch = buf = None
            err = e
        t1 = time.perf_counter()
        flush.stamps["packed"] = t1
        if self._pack_workers == 0:
            self._timing["pack_s"] += t1 - t0
        return flush, batch, buf, err

    def _pack_flush(self, flush: Flush):
        """-> (batch, (key, pooled buffer) or None) for ``flush``: a raw
        flush's RawBatch; else its deferred structures featurized, then
        the compact form into a pooled staging buffer when the set has a
        compact spec and every graph of the flush is compactable, else
        the full form."""
        if flush.form == "raw":
            self._count("pack_raw")
            return self.shape_set.pack_raw([r.graph for r in flush.requests],
                                           shape=flush.shape), None
        self._featurize_pending(flush)
        if not flush.requests:
            raise ValueError("every request in the flush failed "
                             "featurization")
        graphs = [r.graph for r in flush.requests]
        if self.shape_set.compact is None:
            return self.shape_set.pack_full(graphs, shape=flush.shape), None
        if not all(self.shape_set.compact.compactable_many(graphs)):
            self._count("pack_full")
            return self.shape_set.pack_full(graphs, shape=flush.shape), None
        key = self.shape_set.buffer_key(flush.shape)
        buf = (key, self._pool.acquire(key,
                                       self._buffer_factory(flush.shape)))
        try:
            batch = self.shape_set.pack(graphs, shape=flush.shape, out=buf[1])
        except Exception:
            self._pool.release(*buf)
            raise
        self._count("pack_compact")
        return batch, buf

    def _featurize_pending(self, flush: Flush) -> None:
        """Featurize the flush's deferred wire-form structures (on a
        packer, never the admission thread). A structure the featurizer
        rejects fails alone (400); the rest of the flush goes on."""
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

    def _run_flush(self, flush: Flush, batch, buf, err) -> None:
        """Dispatch one packed flush (the worker): the replay and its
        fetch under the dispatch lock; a failed flush fails alone. A
        pooled buffer goes back after the fetch, or after a stream
        synchronize when the flush failed."""
        t0 = time.perf_counter()
        try:
            if err is not None:
                raise err
            self._dispatch_flush(flush, batch, buf)
        except Exception as e:  # noqa: BLE001 — fail the flush, not the server
            self._log(f"serve: batch {flush.flush_id} failed: {e!r}")
            self._count("batch_failures")
            for r in flush.requests:
                if not r.future.done():
                    r.future.set_error(e)
            if buf is not None and self.device.type == "cuda":
                # a failed flush may have left the copy that reads the
                # buffer running
                torch.cuda.current_stream(self.device).synchronize()
        finally:
            if buf is not None:
                self._pool.release(*buf)
            self._timing["dispatch_s"] += time.perf_counter() - t0

    def _dispatch_flush(self, flush: Flush, batch, buf) -> None:
        reqs = flush.requests
        raw = flush.form == "raw"
        overflow = None
        with self._dispatch_lock:
            faultinject.dispatch_point()
            version = self.param_store.version
            flush.stamps["dispatched"] = time.perf_counter()
            if raw:
                preds, overflow, _ = self._predict("raw", flush.shape, batch)
                out = preds.cpu().numpy()
                overflow = overflow.cpu().numpy()
            else:
                out = self._predict("full" if buf is None else "compact",
                                    flush.shape, batch).cpu().numpy()
            flush.stamps["fetched"] = time.perf_counter()
        now = time.monotonic()
        occupancy = len(reqs) / flush.shape.graph_cap
        wire = "raw" if raw else "featurized"
        for i, r in enumerate(reqs):
            if overflow is not None and overflow[i]:
                # the device's cap-overflow flag: this row came from a
                # truncated graph and is never served
                self._fallback_overflow(r)
                continue
            row = out[i].copy()
            latency_ms = (now - r.enqueued) * 1e3
            if self.cache is not None and r.fingerprint is not None:
                self.cache.put(r.fingerprint, (row, version))
            r.future.set_result(ServeResult(
                prediction=row, param_version=version, latency_ms=latency_ms,
                batch_occupancy=occupancy, trace_id=r.trace_id,
                flush_id=flush.flush_id,
                stamps={**r.stamps, **flush.stamps,
                        "replied": time.perf_counter()},
                wire=wire, klass=r.klass, backfilled=r.backfilled))
            self._record_latency(latency_ms)
            self._count("responses")
            self._count(f"responses_class_{r.klass}")
            if r.backfilled:
                self._count("responses_backfilled")
            if raw:
                self._count("responses_raw")
        self._count("batches")
        with self._lock:
            self._occupancies.append(occupancy)
            del self._occupancies[:-4096]

    def _fallback_overflow(self, r: Request) -> None:
        """Re-offer an overflow-flagged raw request as a featurized one
        with the same future, deadline, class and tenant (a packer
        featurizes it, a featurized flush answers it)."""
        self._count("ingest_cap_overflow")
        if self.featurizer is None:
            r.future.set_error(ServeRejection(
                OVERSIZE, self.shape_set.raw.oversize_detail(r.graph)
                + " (device cap-overflow flag; no featurizer configured)"))
            return
        try:
            self.batcher.offer(Request(
                graph=r.graph, enqueued=r.enqueued, deadline=r.deadline,
                future=r.future, trace_id=r.trace_id, stamps=r.stamps,
                precision=r.precision, form="feat",
                trace_parent=r.trace_parent, klass=r.klass,
                tenant=r.tenant))
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
            occ = list(self._occupancies)
            draining = self._draining
        filled = self.batcher.backfilled_total
        slack = self.batcher.slack_total
        counts.update(graph_captures=self.graphs.captures(),
                      graph_replays=self.graphs.replays(),
                      captures_after_warm=self.graphs.captures_after_warm)
        captured: dict[str, int] = {}
        for (form, _), g in list(self.graphs.graphs.items()):
            captured[form] = captured.get(form, 0) + (g.graph is not None)
        out = {
            "counts": counts,
            "captures_by_form": captured,
            "queue_depth": self.batcher.depth,
            "param_version": self.param_store.version,
            "engine": "single",
            "device": str(self.device),
            "draining": draining,
            "warmed": self.warmed,
            "latency_ms": self.latency_quantiles(),
            "batch_occupancy_mean": float(np.mean(occ)) if occ else 0.0,
            "shapes": [s.to_meta() for s in self.shape_set],
            "precisions": list(self.precisions),
            "raw": (None if self.shape_set.raw is None
                    else self.shape_set.raw.to_meta()),
            "compact": self.shape_set.compact is not None,
            "priority": {
                "backfill": self.batcher.backfill,
                "class_wait_ms": {c: round(w * 1e3, 3) for c, w in
                                  self.batcher.class_wait.items()},
                "responses_by_class": {
                    c: counts.get(f"responses_class_{c}", 0)
                    for c in CLASSES},
                "backfilled_responses": counts.get("responses_backfilled",
                                                   0),
                "backfilled_total": filled,
                "padding_fill_share": filled / slack if slack else 0.0,
                "slack_slots": slack,
            },
            "ingest": {
                "pack_workers": self._pack_workers,
                # the worker's own time, and the packers' (pipelined)
                "worker_pack_s": self._timing["pack_s"],
                "worker_dispatch_s": self._timing["dispatch_s"],
                "pipeline_wait_s": self._timing["wait_s"],
                "packers_pack_s": self._pipe.pack_s,
                "packed_flushes": self._pipe.jobs,
            },
        }
        if self.cache is not None:
            cstats = self.cache.stats()
            with self._sf_lock:
                inflight = len(self._inflight)
            cstats.update(inflight_keys=inflight,
                          coalesced=counts.get("cache_coalesced", 0))
            out["cache"] = cstats
        if self._watcher is not None:
            out["reload"] = {"swaps": self._watcher.swaps,
                             "skips": self._watcher.skips,
                             "skipped": self._watcher.skipped,
                             "pending": self.param_store.pending,
                             **self._watcher.control()}
        return out


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


# the JAX server's refusal (cgnn_tpu/serve/server.py), word for word
FORCE_SERVE_REFUSAL = (
    "online serving covers property prediction; the force task's per-atom "
    "output extraction is offline-only (predict.py)")


def _refuse_force(path: str, meta_json: str | None, tag: str) -> None:
    """Raise NotImplementedError for a force-field checkpoint or weight
    file, before anything is built (the JAX ``load_server``'s rule)."""
    if meta_json is not None:
        with open(meta_json) as f:
            meta = json.load(f)
    else:
        mgr = CheckpointManager(path)
        try:
            if not mgr.exists(tag):
                return  # load_for_inference names what is missing
            meta = mgr.read_meta(tag)
        finally:
            mgr.close()
    if meta.get("task") == "force":
        raise NotImplementedError(FORCE_SERVE_REFUSAL)


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
    class_max_wait_ms: dict | None = None,
    backfill: bool = True,
    wfq_weights: dict | None = None,
    default_timeout_ms: float | None = 1000.0,
    cache_size: int = 1024,
    pack_workers: int | None = None,
    device="cuda",
    log_fn: Callable = print,
    wire: str = "auto",
    raw_precheck: bool = True,
    compact: str = "auto",
    watch: bool = True,
    poll_interval_s: float = 2.0,
    warm: bool = True,
):
    """Boot an InferenceServer from a saved model at ``path``: a parameter
    file and its meta (``load_server(npz, meta_json)``,
    convert.save_params), or a checkpoint directory
    (``load_server(ckpt_dir, tag=...)``, train/checkpoint.py; ``tag``
    'latest' or 'best', the fallback chain's choice naming the version).
    Rebuild the model from the meta's configs, plan the shape ladder from
    ``calibration`` (default: synthetic structures drawn with the
    checkpoint's own featurization config, geometry kept), and, with
    ``warm`` (the default), warm every rung and start the worker; with
    ``warm=False`` the caller does both (the entry point binds its
    listener first). A checkpoint directory is watched for newer saves
    with ``watch`` (serve/reload.py), every ``poll_interval_s``.

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

    ``pack_workers``: packer threads beside the worker; None follows the
    JAX package's rule, 1 on a card (packing overlaps the replay) and 0 on
    the CPU (a packer would take the cores the step runs on).

    -> (server, dict of what callers reuse: manager (None for a weight
    file), meta, configs, template graph, the calibration sample).
    """
    if wire not in ("auto", "raw", "featurized"):
        raise ValueError(
            f"wire must be 'auto', 'raw' or 'featurized', got {wire!r}")
    if compact not in ("auto", "on", "off"):
        raise ValueError(
            f"compact must be 'auto', 'on' or 'off', got {compact!r}")
    dev = resolve_device(device)
    _refuse_force(path, meta_json, tag)
    mgr = None
    if meta_json is None:
        state, meta, version = load_for_inference(path, tag, dev)
        mgr = CheckpointManager(path)
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
                dense_m=dense_m, edge_dtype=model_cfg.torch_dtype)
        except CompactUnsupported as e:
            log_fn(f"serve: compact staging unavailable ({e}); full "
                   f"packing")
    shape_set = plan_shape_set(
        calibration, batch_size, rungs=rungs, dense_m=dense_m,
        num_targets=model_cfg.num_targets, compact=compact_spec,
        raw=raw_spec, edge_dtype=model_cfg.torch_dtype,
    )
    if pack_workers is None:
        pack_workers = 1 if dev.type == "cuda" else 0
    template = calibration[0]
    server = InferenceServer(
        state, shape_set, version=version, max_queue=max_queue,
        max_wait_ms=max_wait_ms, class_max_wait_ms=class_max_wait_ms,
        backfill=backfill, wfq_weights=wfq_weights,
        default_timeout_ms=default_timeout_ms, cache_size=cache_size,
        pack_workers=pack_workers,
        featurizer=structure_featurizer(data_cfg), device=dev,
        log_fn=log_fn, raw_precheck=raw_precheck,
    )
    if mgr is not None and watch:
        server.attach_watcher(mgr, lambda: inference_state(meta, dev),
                              poll_interval_s=poll_interval_s, log_fn=log_fn)
    if warm:
        server.warm(template)
        server.start()
    return server, {"manager": mgr, "meta": meta, "model_cfg": model_cfg,
                    "data_cfg": data_cfg, "template": template,
                    "calibration": calibration}
