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
      under the entry's dispatch lock: the fault point, copy into the
      predict graph's static inputs of the flush's (entry, tier, form,
      rung), replay, fetch; then each future gets its row (a raw row the
      device flagged for cap overflow is re-offered as a featurized
      request with the same future), and the cache its (row, version)
    the reload watcher (serve/reload.py), on its own thread: a verified
      save goes live under every entry's dispatch lock, so between flushes

So while the worker replays flush N, flush N+1 packs and the batcher
coalesces N+2; ``pack_workers=0`` runs the same stages on the worker.
A pooled buffer goes back to its pool after the flush's fetch (which
waits for the device); a failed flush synchronizes its stream first.
Answers leave in flush order, and a pack error fails its own flush only.

The device set (serve/devices.py; ``devices``, default the one
``device``) and its engine (``engine``):

- one entry: the loop above ("single", whatever was asked);
- ``'mesh'`` (``'auto'`` with more than one entry; parallel/executor.py):
  each packed flush is split round-robin over the entries, every shard
  packed at one common rung and stacked; the worker stages each entry's
  slice and runs every entry's graph on its own stream from its one
  thread, holding every entry's lock: one dispatch covers the set;
- ``'threads'``: a router (the worker) hands each packed flush to the
  entry with the fewest flushes in flight, over a bounded queue, to that
  entry's dispatch thread, which replays on the entry's stream and
  fetches before it takes the next flush, so a pooled buffer goes back
  only after the entry that read it has finished with it.

Every entry holds its own copy of the state, its own graphs and its own
stream; two entries may share a card. Precision tiers (serve/quantize.py;
``precisions``): each (entry, tier, form, rung) has one predict graph,
all captured at ``warm()``; a request picks its tier at admission
(``submit(precision=)``, refused when the tier was not warmed), the
batcher cuts a flush where the tier changes, and the result cache keys a
tier's rows apart (``<tier>:<fingerprint>`` for tiers other than f32).

Each predict graph is the step captured as a CUDA graph at ``warm()``
(full, compact where the template stages compactly, raw with a raw spec).
A flush never captures: ``stats()["counts"]["captures_after_warm"]``
counts captures after ``warm()`` (the JAX ``serve_recompiles_after_warm``),
0 by construction, and a rise is logged loudly. A hot reload copies new
weights into the tensors the graphs read (serve/reload.py), so it captures
nothing either. On the CPU the step runs eagerly.

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

Observability (the JAX server's, cgnn_tpu_torch/observe): ``registry``
(a ``MetricsRegistry`` with the ``serve`` provider, ``_registry_snapshot``)
is the scrape point behind ``GET /metrics`` and ``stats()["rolling"]``:
the request counters, the queue, drain, warm and device gauges, each
rung's edge-slot occupancy (``ingest_rung{i}_edge_occupancy``: a raw
flush's true edge count from the device over its slots, a featurized
flush's host-known edges over the rung's), the 60 s rolling latency and
occupancy series, and the mergeable histograms (``hists``: latency,
queue wait, flush occupancy; the labelled families
``serve_version_latency_ms_hist``, ``serve_class_latency_ms_hist`` and
``serve_cache_lookup_ms_hist`` by tier, form and outcome). ``telemetry``
(an ``observe.Telemetry``; the entry point's ``--telemetry-dir``)
mirrors the counters as ``serve_*``, keeps the value series, records the
``serve.request``, ``serve.pack`` and ``serve.dispatch`` spans, and takes
the per-entry device gauges at the drain. The planes the JAX server runs
beside it:

- the trace ring (``trace_ring`` events, default 65536; 0 off): a
  ``SpanTracer`` of its own that the serving spans land in whatever the
  telemetry level, behind ``GET /trace`` (``trace_window``) and the
  flight recorder's bundles;
- the flight recorder (``attach_flight_recorder``; observe/flightrec.py):
  every finished request in its ring, the HTTP statuses into its
  ``5xx_burst`` trigger (``note_http_status``), an SLO alert into
  ``slo_burn_<objective>``;
- the SLO engine and time-series store (``slo_layer``, default on; off
  also drops the histograms): every answer a good or bad event, every
  failed or expired request a bad one; a collector thread appends the
  registry's snapshot to the store every ``tsdb_interval_s`` and
  advances the alerts on the same tick (``GET /timeseries``,
  ``stats()["slo"]``, ``stats()["tsdb"]``);
- on-demand profiling (``enable_profiling``; observe/profile.py):
  ``POST /profile`` and SIGUSR2 captures, waited out by the drain.

Not ported yet: the label journal and peer cache fill (ROADMAP Queue 1,
item 12) and the racecheck watchdog's trigger (item 13).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import queue
import threading
import time
from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np
import torch

from cgnn_tpu_torch.config import DataConfig, ModelConfig
from cgnn_tpu_torch.convert import from_flax_variables, load_params
from cgnn_tpu_torch.data.compact import CompactSpec, CompactUnsupported
from cgnn_tpu_torch.data.elements import MAX_Z
from cgnn_tpu_torch.data.graph import CrystalGraph, GraphBatch
from cgnn_tpu_torch.data.pipeline import BufferPool, PipelineStats, parallel_pack
from cgnn_tpu_torch.data.rawbatch import (
    RawStructure,
    RawUnsupported,
    plan_raw_spec,
    raw_fingerprint,
)
from cgnn_tpu_torch.data.structure import Structure
from cgnn_tpu_torch.device import resolve_device
from cgnn_tpu_torch.observe.export import MetricsRegistry, RollingSeries
from cgnn_tpu_torch.observe.gauges import cache_gauges
from cgnn_tpu_torch.observe.hist import (
    LATENCY_MS_BOUNDS,
    OCCUPANCY_BOUNDS,
    QUEUE_WAIT_MS_BOUNDS,
    Histogram,
    format_labels,
)
from cgnn_tpu_torch.observe.slo import SLOEngine, SLOObjective
from cgnn_tpu_torch.observe.spans import SpanTracer
from cgnn_tpu_torch.observe.telemetry import Telemetry
from cgnn_tpu_torch.observe.tsdb import TimeSeriesStore, TsdbCollector
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
from cgnn_tpu_torch.parallel.executor import open_entries
from cgnn_tpu_torch.serve.cache import ResultCache, structure_fingerprint
from cgnn_tpu_torch.serve.devices import (
    DeviceSet,
    canonical,
    on_stream,
    resolve_devices,
)
from cgnn_tpu_torch.serve.quantize import build_tier_specs, parse_precisions
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
    """Micro-batching online inference over a shape ladder on a device set.

    ``state`` holds the eval model and normalizer. ``devices`` lists the
    entries (default: the one ``device``, CUDA by default, which raises
    when absent; repeats make several entries on one card); ``engine``
    'auto', 'mesh' or 'threads' drives a set of more than one (module
    docstring); ``precisions`` the tiers warmed beside f32
    (serve/quantize.py). With a raw spec on the shape set, the raw
    expander runs the neighbor search as kernel 8 on a CUDA device and as
    its plain version on the CPU; a kernel that fails to build or launch
    fails its flush. ``raw_precheck=False`` skips the host image-cap check
    at admission and leaves the decision to the device's overflow flag.
    ``pack_workers`` packer threads pack flushes while the worker replays
    (0: the worker packs). ``cache_size`` 0 disables the result cache.
    ``telemetry``, ``trace_ring``, ``slo_layer`` (with ``slo_objectives``,
    ``slo_rules`` and ``tsdb_interval_s``): module docstring (telemetry
    None: off; the default objectives are the JAX server's, availability
    0.999 and 95% within 1000 ms over 300 s)."""

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
        devices: Sequence | None = None,
        engine: str = "auto",
        precisions: Sequence[str] = ("f32",),
        log_fn: Callable = print,
        raw_precheck: bool = True,
        telemetry: Telemetry | None = None,
        trace_ring: int = 65536,
        slo_layer: bool = True,
        slo_objectives=None,
        slo_rules=None,
        tsdb_interval_s: float = 2.0,
    ):
        entries = [canonical(resolve_device(d)) for d in
                   (devices if devices is not None else [device])]
        # one predict step a device: the expanders' constants live there
        ents = open_entries(entries, engine, lambda d: make_predict_step(
            raw_expander=shape_set.raw_expander(device=d),
            expander=shape_set.expander(device=d)))
        self.device_set = DeviceSet(entries)
        self.device = entries[0]
        self.mesh_exec = ents.mesh
        # what runs, not what was asked: one entry takes the single loop
        self.engine = ents.engine
        self._streams = ents.streams
        self._steps = ents.steps
        self.predict_step = self._steps[0]
        self.precisions = tuple(dict.fromkeys(("f32", *precisions)))
        tier_specs = (None if self.precisions == ("f32",)
                      else build_tier_specs(self.precisions))
        state = InferenceState(state.model.to(self.device).eval(),
                               state.normalizer.to(self.device))
        self.param_store = ParamStore(state, version, devices=entries,
                                      tier_specs=tier_specs)
        self.state = self.param_store.state
        self.shape_set = shape_set
        self.graphs = GraphCache(self._make_graph, log_fn=log_fn,
                                 label="serve: predict graph")
        self._pool = None if shape_set.compact is None else BufferPool()
        self._pack_workers = max(0, int(pack_workers))
        self._raw_precheck = bool(raw_precheck)
        self.telemetry = telemetry or Telemetry.disabled()
        # mergeable fixed-bucket histograms beside the rolling quantiles
        # (observe/hist.py): integer bucket counts add across processes.
        # They, the SLO engine and the time-series store ride slo_layer
        self.hists: dict[str, Histogram] = {}
        self.slo = None
        self.tsdb = None
        self._tsdb_collector = None
        if slo_layer:
            self.hists = {
                "serve_latency_ms_hist": Histogram(LATENCY_MS_BOUNDS),
                "serve_queue_wait_ms_hist": Histogram(QUEUE_WAIT_MS_BOUNDS),
                "serve_flush_occupancy_hist": Histogram(OCCUPANCY_BOUNDS),
            }
            objectives = (tuple(slo_objectives) if slo_objectives else (
                SLOObjective("availability", target=0.999, window_s=300.0),
                SLOObjective("latency", target=0.95,
                             latency_threshold_ms=1000.0, window_s=300.0),
            ))
            # the fire hook reads self.flightrec when it fires, so a
            # recorder attached later still gets the alerts
            self.slo = SLOEngine(objectives, rules=slo_rules,
                                 on_fire=self._on_slo_fire,
                                 on_resolve=self._on_slo_resolve)
            self.tsdb = TimeSeriesStore()
        # labelled latency families (a bounded map of the latest param
        # versions; one a class) and cache-lookup families, made lazily
        self._version_hists: OrderedDict = OrderedDict()
        self._version_hists_cap = 8
        self._class_hists: dict[str, Histogram] = {}
        self._cache_hists: dict[tuple, Histogram] = {}
        self.batcher = MicroBatcher(
            shape_set, max_queue=max_queue, max_wait_ms=max_wait_ms,
            class_max_wait_ms=class_max_wait_ms, backfill=backfill,
            wfq_weights=wfq_weights,
            queue_wait_hist=self.hists.get("serve_queue_wait_ms_hist"))
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
        # one dispatch lock an entry, held across a flush's copy, replay
        # and fetch (every entry's under the mesh engine, always taken in
        # entry order), so a hot reload, which takes them all, lands only
        # between flushes
        self._locks = [threading.Lock() for _ in entries]
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
        # each rung's last edge-slot occupancy (the cap-calibration
        # signal, /metrics and stats())
        self._rung_edge_occ: dict[int, float] = {}
        # what the last 60 s looked like, whatever the telemetry level:
        # stats()["rolling"] and the /metrics scrape
        self.rolling_window_s = 60.0
        self._lat_rolling = RollingSeries(window_s=self.rolling_window_s)
        self._occ_rolling = RollingSeries(window_s=self.rolling_window_s)
        self.registry = MetricsRegistry(window_s=self.rolling_window_s)
        self.registry.attach_telemetry(self.telemetry)
        self.registry.add_provider("serve", self._registry_snapshot)
        if self.tsdb is not None:
            # one heartbeat: registry snapshots into the store, and the
            # alerts advance on the same tick (they resolve with no
            # traffic too)
            self._tsdb_collector = TsdbCollector(
                self.registry, self.tsdb, interval_s=tsdb_interval_s)
            self._tsdb_collector.add_on_tick(self._slo_tick)
        # the trace ring: serving spans whatever the telemetry level
        self.tracer = (SpanTracer(process_name=f"serve-{os.getpid()}",
                                  max_events=int(trace_ring))
                       if trace_ring else None)
        # attached by the entry point (None: every hook a no-op)
        self.flightrec = None
        self.profiler = None
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

    @contextlib.contextmanager
    def _locked(self, entries=None):
        """Hold the dispatch locks of ``entries`` (default: all), taken in
        entry order."""
        with contextlib.ExitStack() as stack:
            for i in range(len(self._locks)) if entries is None else entries:
                stack.enter_context(self._locks[i])
            yield

    # ---- lifecycle ----

    def warm(self, template: CrystalGraph) -> int:
        """Capture every predict graph: each rung x staging form x tier x
        entry, with one copy of ``template`` (both staging forms with a
        compact spec; with a raw spec, the raw form with
        ``spec.template()``), each run once (under the mesh engine, through
        the sharded dispatch): builds the kernels and initializes the
        device libraries before traffic. -> the number of rungs."""
        self._feature_dims = (template.atom_fea.shape[1],
                              template.edge_fea.shape[1])
        raw = self.shape_set.raw
        n = len(self.device_set)
        with self._locked(), self.telemetry.warmup():
            for shape in self.shape_set:
                forms = {"full": self.shape_set.pack_full([template],
                                                          shape=shape)}
                if self.shape_set.compactable(template):
                    forms["compact"] = None  # packed per use: pooled
                if raw is not None:
                    forms["raw"] = self.shape_set.pack_raw([raw.template()],
                                                           shape=shape)
                for form, batch in forms.items():
                    for tier in self.precisions:
                        if self.mesh_exec is not None:
                            b = batch if batch is not None else \
                                self.shape_set.pack([template], shape=shape)
                            staged = self.mesh_exec.stage(
                                self.mesh_exec.stack([b] * n))
                            self._mesh_predict(tier, form, shape, staged)
                            continue
                        for i in range(n):
                            self._warm_one(i, tier, form, shape, batch,
                                           template)
        self.graphs.mark_warm()
        self.warmed = True
        self._log(f"serve: warmed {len(self.shape_set)} shapes x "
                  f"{len(self.precisions)} tier(s) {list(self.precisions)} "
                  f"on {n} entr{'y' if n == 1 else 'ies'} [{self.engine} "
                  f"engine] ({self.graphs.captures()} predict graphs "
                  f"captured)")
        return len(self.shape_set)

    def _warm_one(self, i, tier, form, shape, batch, template) -> None:
        """One warm-up run of entry ``i``'s graph; a compact batch goes
        through a pooled staging buffer, so its pinned allocation is paid
        here, not by the first flush."""
        with on_stream(self._streams[i]):
            if batch is not None:
                out = self._predict(form, shape, batch, i, tier)
                (out[0] if form == "raw" else out).cpu()
                return
            key = self.shape_set.buffer_key(shape)
            buf = self._pool.acquire(key, self._buffer_factory(shape))
            cb = self.shape_set.pack([template], shape=shape, out=buf)
            self._predict(form, shape, cb, i, tier).cpu()
            self._pool.release(key, buf)

    def _buffer_factory(self, shape):
        return self.shape_set.buffer_factory(
            shape, pin=self.device.type == "cuda")

    def _make_graph(self, key, batch) -> StepGraph:
        # over the step and the state, not the server: a graph that held
        # the server would keep it, and every graph's pool, in a cycle
        i, tier, form, _ = key
        step = self._steps[i]
        state = self.param_store.get(i, tier)[0]
        return StepGraph(lambda b: step(state, b),
                         batch, device=self.device_set.devices[i],
                         kind="predict_raw" if form == "raw" else "predict",
                         label=f"serve: predict graph {key}",
                         replay_stream=self._streams[i])

    def _predict(self, form: str, shape, batch, entry: int = 0,
                 tier: str = "f32"):
        """The predict step of entry ``entry`` and ``tier`` on a host
        ``batch`` of ``form`` ('full', 'compact', 'raw') at rung
        ``shape``: its graph's replay on CUDA, on the caller's stream
        (outputs static: fetch them before the next flush), eagerly on
        the CPU."""
        return self.graphs.run((entry, tier, form, shape), batch)

    def _mesh_predict(self, tier, form, shape, staged):
        """One sharded dispatch (parallel/executor.py) of (tier, form,
        rung) over every entry's staged slice -> outputs [N, G, ...]."""
        return self.mesh_exec.shard_predict(
            lambda i, b: self._predict(form, shape, b, i, tier))(staged)

    def start(self) -> "InferenceServer":
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._serve_loop, daemon=True, name="cgnn-torch-serve")
            self._worker.start()
        if self._watcher is not None:
            self._watcher.start()
        if self._tsdb_collector is not None:
            self._tsdb_collector.start()
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
        every entry's dispatch lock, so between flushes on every entry;
        the cache's rows of the old version go."""
        with self._locked():
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
        if self._tsdb_collector is not None:
            self._tsdb_collector.stop()
        if self._worker is None:
            self._serve_loop()  # never started: answer accepted work here
            done = True
        else:
            self._worker.join(timeout=timeout_s)
            done = not self._worker.is_alive()
        if self.profiler is not None:
            # a capture in flight is written before the process goes
            # (bounded: a capture lasts at most max_duration_s)
            self.profiler.wait_idle()
        self.telemetry.set_gauge("serve_drained_clean", float(done))
        # the per-entry dispatch gauges into the run summary
        self.device_set.flush_gauges(self.telemetry)
        return done

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
        lookup_t0 = time.monotonic()
        fp = self._cache_key(graph, is_raw_wire, form, fingerprint, tier)
        if fp is not None:
            hit = self.cache.get(fp)
            lookup_ms = (time.monotonic() - lookup_t0) * 1e3
            if hit is not None:
                row, version = hit
                # served only while its version is live: a flush in
                # flight across a swap writes its rows after the clear
                if version == self.param_store.version:
                    self._observe_cache_lookup(tier, form, "hit", lookup_ms)
                    return self._answer_hit(row, version, tid, queued, now,
                                            form, kl, tier, trace_parent)
            # a stale-version hit is a miss: a forward pass answers it
            self._observe_cache_lookup(tier, form, "miss", lookup_ms)
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
                   fingerprint: str | None, tier: str = "f32") -> str | None:
        """The request's cache key, or None without a cache. A raw-wire
        request's ``raw:`` key becomes ``fs:`` when the host featurizes
        it: the two programs agree only to f32 round-off, and a cached
        row is determined by (parameters, structure, program). A tier
        other than f32 prefixes the key (``<tier>:``), so an f32 row never
        answers an int8 request, nor the reverse."""
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
        return fp if tier == "f32" else f"{tier}:{fp}"

    def _answer_hit(self, row, version, tid, queued, t0, form,
                    kl, tier, trace_parent=None) -> RequestFuture:
        self._count("cache_hits")
        fut = RequestFuture()
        latency_ms = (time.monotonic() - t0) * 1e3
        replied = time.perf_counter()
        wire = "raw" if form == "raw" else "featurized"
        fut.set_result(ServeResult(
            prediction=row, param_version=version, latency_ms=latency_ms,
            cached=True, precision=tier, device_id=-1, trace_id=tid,
            stamps={"queued": queued, "replied": replied},
            wire=wire, klass=kl))
        if self._spans_on:
            args = {"trace_id": tid, "cached": True}
            if trace_parent:
                args["parent"] = trace_parent
            self._span("serve.request", queued, replied, **args)
        self._note_request(trace_id=tid, status="ok", cached=True,
                           param_version=version, precision=tier, wire=wire,
                           latency_ms=latency_ms)
        self._record_latency(latency_ms, version, kl)
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
            replied = time.perf_counter()
            w["future"].set_result(ServeResult(
                prediction=res.prediction, param_version=res.param_version,
                latency_ms=latency_ms, cached=res.cached,
                device_id=res.device_id, trace_id=w["trace_id"],
                precision=w["tier"],
                stamps={"queued": w["queued"], "replied": replied},
                wire=res.wire, klass=w["klass"], coalesced=True))
            if self._spans_on:
                self._span("serve.request", w["queued"], replied,
                           trace_id=w["trace_id"], coalesced=True)
            self._note_request(trace_id=w["trace_id"], status="ok",
                               cached=bool(res.cached),
                               param_version=res.param_version,
                               precision=w["tier"], wire=res.wire,
                               latency_ms=latency_ms)
            self._record_latency(latency_ms, res.param_version, w["klass"])
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
        if self.mesh_exec is not None:
            return self._serve_loop_mesh()
        if len(self.device_set) > 1:
            return self._serve_loop_multidev()
        for item in self._packed_stream():
            self._run_flush(*item)

    def _packed_stream(self):
        """(flush, batch, pooled buffer, error) in flush order, through
        the packer threads or in line; the worker's wait on the pack stage
        is timed here."""
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
            wait = (time.perf_counter() - t0
                    - (self._timing["pack_s"] - packed0))
            self._timing["wait_s"] += wait
            if self._pack_workers > 0:
                # the worker's stall on the packers (the JAX series)
                self.telemetry.observe_value("pipeline_wait_s", wait)
            yield item

    def _serve_loop_multidev(self) -> None:
        """The threads engine: the worker routes each packed flush to the
        entry with the fewest flushes in flight (``DeviceSet.pick``) over
        that entry's bounded queue; the entry's dispatch thread replays on
        the entry's stream and fetches before it takes its next flush, so
        a pooled buffer returns to the pool only after the entry that read
        it is done with it. Answers are in order per entry."""
        n = len(self.device_set)
        qs = [queue.Queue(maxsize=self.device_set.window) for _ in range(n)]

        def entry_worker(i: int) -> None:
            with on_stream(self._streams[i]):
                while True:
                    item = qs[i].get()
                    if item is None:
                        return
                    self._run_flush(*item, entry=i, routed=True)

        workers = [threading.Thread(target=entry_worker, args=(i,),
                                    daemon=True,
                                    name=f"cgnn-torch-serve-dispatch-{i}")
                   for i in range(n)]
        for t in workers:
            t.start()
        try:
            for item in self._packed_stream():
                i = self.device_set.pick()
                # counted before the put, so pick() sees routed load
                self.device_set.note_enqueue(i)
                qs[i].put(item)
        finally:
            for q in qs:
                q.put(None)
            for t in workers:
                t.join()

    def _serve_loop_mesh(self) -> None:
        """The mesh engine: each packed flush (already split over the
        entries, ``_pack_flush``) is ONE sharded dispatch from this thread
        (``_run_flush_mesh``); answers leave in flush order."""
        for item in self._packed_stream():
            self._run_flush_mesh(*item)

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
            self._record_slo_bad(r.klass)
            self._count("reject_timeout")
            self._note_request(trace_id=r.trace_id, status="timeout",
                               precision=r.precision)
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
        if self._spans_on:
            self._span("serve.pack", t0, t1, flush_id=flush.flush_id,
                       n=len(flush.requests), trace_ids=flush.trace_ids(),
                       error=repr(err) if err is not None else "")
        self.telemetry.observe_value("serve_pack_s", t1 - t0)
        return flush, batch, buf, err

    def _pack_flush(self, flush: Flush):
        """-> (batch, (key, pooled buffer) or None) for ``flush``: a raw
        flush's RawBatch; else its deferred structures featurized, then
        the compact form into a pooled staging buffer when the set has a
        compact spec and every graph of the flush is compactable, else
        the full form. Under the mesh engine the batch is the split one:
        ``(stack of per-shard batches at one rung, real graphs a shard,
        rung)``, packed fresh (the stack copies every byte at once)."""
        if flush.form != "raw":
            self._featurize_pending(flush)
            if not flush.requests:
                raise ValueError("every request in the flush failed "
                                 "featurization")
        graphs = [r.graph for r in flush.requests]
        ss = self.shape_set
        if flush.form == "raw":
            self._count("pack_raw")
            pack = ss.pack_raw
        elif ss.compact is None:
            pack = ss.pack_full
        elif not all(ss.compact.compactable_many(graphs)):
            self._count("pack_full")
            pack = ss.pack_full
        else:
            self._count("pack_compact")
            pack = ss.pack
            if self.mesh_exec is None:
                key = ss.buffer_key(flush.shape)
                buf = (key, self._pool.acquire(
                    key, self._buffer_factory(flush.shape)))
                try:
                    return ss.pack(graphs, shape=flush.shape,
                                   out=buf[1]), buf
                except Exception:
                    self._pool.release(*buf)
                    raise
        if self.mesh_exec is not None:
            groups, shape, counts = self.mesh_exec.plan_flush(graphs, ss)
            stacked = self.mesh_exec.stack([pack(g, shape=shape)
                                            for g in groups])
            return (stacked, counts, shape), None
        return pack(graphs, shape=flush.shape), None

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

    def _fail_flush(self, flush: Flush, e: Exception, where: str) -> None:
        self._log(f"serve: batch {flush.flush_id} failed ({where}): {e!r}")
        self._count("batch_failures")
        for r in flush.requests:
            if not r.future.done():
                r.future.set_error(e)
                self._record_slo_bad(r.klass)
                self._note_request(trace_id=r.trace_id,
                                   status="dispatch_failed", error=repr(e),
                                   precision=r.precision,
                                   flush_id=flush.flush_id)

    def _run_flush(self, flush: Flush, batch, buf, err, *, entry: int = 0,
                   routed: bool = False) -> None:
        """Dispatch one packed flush on ``entry`` (the worker, or the
        entry's dispatch thread): the replay and its fetch under the
        entry's dispatch lock; a failed flush fails alone. The entry's
        in-flight count and busy time move once a flush (``routed``: the
        router counted the enqueue). A pooled buffer goes back after the
        fetch, or after a stream synchronize when the flush failed."""
        if not routed:
            self.device_set.note_enqueue(entry)
        t0 = time.perf_counter()
        ok = False
        try:
            if err is not None:
                raise err
            self._dispatch_flush(flush, batch, buf, entry)
            ok = True
        except Exception as e:  # noqa: BLE001 — fail the flush, not the server
            self._fail_flush(flush, e, f"entry {entry}")
            dev = self.device_set.devices[entry]
            if buf is not None and dev.type == "cuda":
                # a failed flush may have left the copy that reads the
                # buffer running
                torch.cuda.current_stream(dev).synchronize()
        finally:
            if buf is not None:
                self._pool.release(*buf)
            busy = time.perf_counter() - t0
            self.device_set.note_complete(entry, busy, ok=ok)
            with self._lock:
                self._timing["dispatch_s"] += busy

    def _dispatch_flush(self, flush: Flush, batch, buf, entry: int) -> None:
        raw = flush.form == "raw"
        tier = flush.precision
        with self._locked([entry]):
            faultinject.dispatch_point()
            version = self.param_store.version
            flush.stamps["dispatched"] = time.perf_counter()
            form = "raw" if raw else "full" if buf is None else "compact"
            out = self._predict(form, flush.shape, batch, entry, tier)
            if raw:
                out = tuple(o.cpu().numpy() for o in out)
            else:
                out = out.cpu().numpy()
            flush.stamps["fetched"] = time.perf_counter()
        if self._spans_on:
            self._span("serve.dispatch", flush.stamps["dispatched"],
                       flush.stamps["fetched"], flush_id=flush.flush_id,
                       device=entry, shape=str(flush.shape),
                       trace_ids=flush.trace_ids())
        self._count(f"batches_device{entry}")
        self._note_edge_occupancy(flush, out[2] if raw else None)
        self._answer(flush, version, out, entry,
                     len(flush.requests) / flush.shape.graph_cap)

    def _run_flush_mesh(self, flush: Flush, packed, buf, err) -> None:
        """The mesh engine's ``_run_flush``: one dispatch serves every
        shard, so the accounting covers each shard the split populated;
        a failed flush fails alone."""
        counts = packed[1] if packed is not None else []
        shards = [i for i, c in enumerate(counts) if c > 0]
        for i in shards:
            self.device_set.note_enqueue(i)
        t0 = time.perf_counter()
        ok = False
        try:
            if err is not None:
                raise err
            self._dispatch_flush_mesh(flush, packed)
            ok = True
        except Exception as e:  # noqa: BLE001 — fail the flush, not the server
            self._fail_flush(flush, e, "mesh")
        finally:
            # the shards ran at once under one dispatch: each was busy for
            # the flush's wall time
            busy = time.perf_counter() - t0
            for i in shards:
                self.device_set.note_complete(i, busy, ok=ok)
            self._timing["dispatch_s"] += busy

    def _dispatch_flush_mesh(self, flush: Flush, packed) -> None:
        stacked, counts, shape = packed
        n = len(self.mesh_exec)
        with self._locked():
            faultinject.dispatch_point()
            version = self.param_store.version
            flush.stamps["dispatched"] = time.perf_counter()
            form = ("raw" if flush.form == "raw" else "full"
                    if isinstance(stacked, GraphBatch) else "compact")
            out = self._mesh_predict(flush.precision, form, shape,
                                     self.mesh_exec.stage(stacked))
            if form == "raw":
                out = tuple(o.cpu().numpy() for o in out)
            else:
                out = out.cpu().numpy()
            flush.stamps["fetched"] = time.perf_counter()
        if self._spans_on:
            self._span("serve.dispatch", flush.stamps["dispatched"],
                       flush.stamps["fetched"], flush_id=flush.flush_id,
                       engine="mesh", shards=n, shape=str(shape),
                       trace_ids=flush.trace_ids())
        for i, c in enumerate(counts):
            if c > 0:
                self._count(f"batches_device{i}")
        # one accounting with the other engines, over the n shards the
        # dispatch spanned (n_edges comes back [n, G])
        self._note_edge_occupancy(flush, out[2] if form == "raw" else None,
                                  shape=shape, n_shards=n)
        # request j sat at shard j % N, row j // N (split_round_robin)
        self._answer(flush, version, out, None,
                     len(flush.requests) / (n * shape.graph_cap),
                     rows=[(j % n, j // n)
                           for j in range(len(flush.requests))])

    def _answer(self, flush: Flush, version: str, out, entry, occupancy,
                rows=None) -> None:
        """Each request of a fetched flush gets its row: ``out`` is the
        host [G, T] (a raw flush's (preds, overflow, n_edges)) of one
        entry, or with ``rows`` the mesh's [N, G, ...] indexed by each
        request's (shard, row), the shard its ``device_id``."""
        reqs = flush.requests
        raw = flush.form == "raw"
        tier = flush.precision
        preds, overflow = (out[0], out[1]) if raw else (out, None)
        now = time.monotonic()
        wire = "raw" if raw else "featurized"
        for j, r in enumerate(reqs):
            at, dev_id = (j, entry) if rows is None else (rows[j],
                                                          rows[j][0])
            if overflow is not None and overflow[at]:
                # the device's cap-overflow flag: this row came from a
                # truncated graph and is never served
                self._fallback_overflow(r)
                continue
            row = preds[at].copy()
            latency_ms = (now - r.enqueued) * 1e3
            if self.cache is not None and r.fingerprint is not None:
                self.cache.put(r.fingerprint, (row, version))
            stamps = {**r.stamps, **flush.stamps,
                      "replied": time.perf_counter()}
            r.future.set_result(ServeResult(
                prediction=row, param_version=version, latency_ms=latency_ms,
                precision=tier, batch_occupancy=occupancy,
                device_id=dev_id, trace_id=r.trace_id,
                flush_id=flush.flush_id, stamps=stamps,
                wire=wire, klass=r.klass, backfilled=r.backfilled))
            if self._spans_on:
                args = {"trace_id": r.trace_id, "flush_id": flush.flush_id,
                        "device": dev_id,
                        "queue_ms": round((stamps["packed"]
                                           - stamps["queued"]) * 1e3, 3),
                        "dispatch_ms": round((stamps["fetched"]
                                              - stamps["dispatched"]) * 1e3,
                                             3)}
                if r.trace_parent:
                    args["parent"] = r.trace_parent
                self._span("serve.request", stamps["queued"],
                           stamps["replied"], **args)
            self._note_request(trace_id=r.trace_id, status="ok",
                               param_version=version, precision=tier,
                               wire=wire, flush_id=flush.flush_id,
                               device=dev_id, latency_ms=latency_ms,
                               stamps=stamps)
            self._record_latency(latency_ms, version, r.klass)
            self._count("responses")
            self._count(f"responses_class_{r.klass}")
            if r.backfilled:
                self._count("responses_backfilled")
            if raw:
                self._count("responses_raw")
            if tier != "f32":
                self._count(f"responses_{tier}")
        self._count("batches")
        self._count(f"batches_{tier}" + ("_raw" if raw else ""))
        with self._lock:
            self._occupancies.append(occupancy)
            del self._occupancies[:-4096]
        self._occ_rolling.add(occupancy)
        oh = self.hists.get("serve_flush_occupancy_hist")
        if oh is not None:
            oh.observe(occupancy)
        self.telemetry.observe_value("serve_batch_occupancy", occupancy)
        self.telemetry.set_gauge("serve_queue_depth", self.batcher.depth)

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
        self.telemetry.counter_add(f"serve_{key}", 1)

    def _record_latency(self, latency_ms: float, version: str | None = None,
                        klass: str | None = None) -> None:
        """One answered request (a cache hit too: a client got its
        answer) into the recent list, the rolling series, the telemetry's
        series, the latency histograms (its param version's and its
        class's labelled members too) and the SLO engine as a good
        event."""
        with self._lock:
            self._latencies.append(latency_ms)
            del self._latencies[:-8192]
        self._lat_rolling.add(latency_ms)
        self.telemetry.observe_value("serve_latency_ms", latency_ms)
        h = self.hists.get("serve_latency_ms_hist")
        if h is not None:
            h.observe(latency_ms)
            if version is not None:
                with self._lock:
                    vh = self._version_hists.get(version)
                    if vh is None:
                        vh = self._version_hists[version] = Histogram(
                            LATENCY_MS_BOUNDS)
                        while len(self._version_hists) > \
                                self._version_hists_cap:
                            self._version_hists.popitem(last=False)
                vh.observe(latency_ms)
            if klass is not None:
                ch = self._class_hists.get(klass)
                if ch is None:
                    with self._lock:
                        ch = self._class_hists.setdefault(
                            klass, Histogram(LATENCY_MS_BOUNDS))
                ch.observe(latency_ms)
        if self.slo is not None:
            self.slo.record(True, latency_ms, klass=klass)

    def _observe_cache_lookup(self, tier: str, form: str, outcome: str,
                              lookup_ms: float) -> None:
        """One cache probe into its (tier, form, outcome) member of
        ``serve_cache_lookup_ms_hist``: the counts give mergeable hit
        ratios, the values the probe's cost (ms)."""
        if not self.hists:
            return
        key = (str(tier), str(form), str(outcome))
        h = self._cache_hists.get(key)
        if h is None:
            with self._lock:
                h = self._cache_hists.setdefault(
                    key, Histogram(LATENCY_MS_BOUNDS))
        h.observe(lookup_ms)

    def _record_slo_bad(self, klass: str | None = None) -> None:
        """One failed request (a failed flush, an expired deadline) into
        the error budget. Admission rejections are not: they are the
        server protecting itself or the client's fault."""
        if self.slo is not None:
            self.slo.record(False, 0.0, klass=klass)

    def _slo_tick(self) -> None:
        """The collector's heartbeat: pending -> firing and firing ->
        resolved happen on the clock, not only when traffic comes."""
        if self.slo is not None:
            self.slo.evaluate()

    def _on_slo_fire(self, tr: dict) -> None:
        """A burn-rate alert fires: the flight recorder's
        ``slo_burn_<objective>`` trigger, so the bundle's manifest names
        the alert."""
        self._log(f"serve: SLO ALERT firing: objective={tr['objective']} "
                  f"rule={tr['rule']} burn_fast={tr['burn_fast']:.2f} "
                  f"burn_slow={tr['burn_slow']:.2f} "
                  f"(factor {tr['factor']:g})")
        fr = self.flightrec
        if fr is not None:
            fr.trigger(f"slo_burn_{tr['objective']}",
                       detail=(f"rule={tr['rule']} "
                               f"burn_fast={tr['burn_fast']:.3f} "
                               f"burn_slow={tr['burn_slow']:.3f} "
                               f"factor={tr['factor']:g}"))

    def _on_slo_resolve(self, tr: dict) -> None:
        self._log(f"serve: SLO alert resolved: objective={tr['objective']} "
                  f"rule={tr['rule']}")

    def _note_request(self, **record) -> None:
        """A finished request into the flight recorder's ring (a no-op
        without one)."""
        fr = self.flightrec
        if fr is not None:
            fr.note_request(record)

    def note_http_status(self, status: int) -> None:
        """The HTTP front end's hook: each /predict status into the
        recorder's 5xx burst trigger."""
        fr = self.flightrec
        if fr is not None:
            fr.note_status(int(status))

    def attach_flight_recorder(self, recorder) -> None:
        """Wire an ``observe.flightrec.FlightRecorder`` into the serving
        path (module docstring)."""
        self.flightrec = recorder

    def trace_window(self, since_s: float | None = None) -> dict | None:
        """The ``GET /trace`` body: the trace ring (else the telemetry's
        spans) as a joinable window (observe/trace_join.py), or None
        when neither exists."""
        tracer = self.tracer or self.telemetry.spans
        if tracer is None:
            return None
        w = tracer.window(since_s=since_s)
        w["role"] = "replica"
        return w

    def enable_profiling(self, out_dir: str, *,
                         default_duration_s: float = 1.0,
                         max_duration_s: float = 10.0):
        """On-demand profiling (``POST /profile``, SIGUSR2) into
        ``out_dir`` -> the ``ProfileCapture`` (one capture at a time:
        another is rejected, never stacked)."""
        from cgnn_tpu_torch.observe.profile import ProfileCapture

        self.profiler = ProfileCapture(
            out_dir, spans=self.telemetry.spans,
            default_duration_s=default_duration_s,
            max_duration_s=max_duration_s, log_fn=self._log)
        return self.profiler

    @property
    def _spans_on(self) -> bool:
        return self.telemetry.spans is not None or self.tracer is not None

    def _span(self, name: str, start_s: float, end_s: float,
              **args) -> None:
        """One retro-stamped hop span into every live sink: the
        telemetry's tracer (trace.json at close) and the trace ring."""
        spans = self.telemetry.spans
        if spans is not None:
            spans.complete(name, start_s, end_s, **args)
        if self.tracer is not None:
            self.tracer.complete(name, start_s, end_s, **args)

    def _note_edge_occupancy(self, flush: Flush, raw_edges,
                             shape=None, n_shards: int = 1) -> None:
        """A rung's edge-slot occupancy (observe/gauges.py
        ``ingest_gauges``; /metrics): a raw flush's true edge count from
        the device (``n_edges``) over its edge slots, a featurized
        flush's host-known edges over the rung's; the mesh engine passes
        its common rung and shard count (the dispatch spanned
        ``n_shards`` copies of the rung's slots)."""
        shape = shape or flush.shape
        try:
            rung = self.shape_set.shapes.index(shape)
        except ValueError:
            return
        if flush.form == "raw":
            if raw_edges is None:
                return
            spec = self.shape_set.raw
            slots = (n_shards * shape.graph_cap * spec.snode_cap
                     * spec.dense_m)
            occ = float(np.asarray(raw_edges).sum()) / max(slots, 1)
        else:
            occ = sum(r.graph.num_edges for r in flush.requests) \
                / max(n_shards * shape.edge_cap, 1)
        with self._lock:
            self._rung_edge_occ[rung] = occ
        self.telemetry.set_gauge(f"ingest_rung{rung}_edge_occupancy", occ)

    def _registry_snapshot(self) -> dict:
        """The ``serve`` provider of ``self.registry``: request counters,
        live queue, drain and device gauges, each rung's edge occupancy,
        the trace ring's, flight recorder's, profiler's, SLO engine's and
        time-series store's gauges, the rolling-window series and the
        histograms, all readable with telemetry off (the JAX provider's
        names)."""
        with self._lock:
            counts = dict(self.counts)
            draining = self._draining
            rung_occ = dict(self._rung_edge_occ)
        counters = {f"serve_{k}": float(v) for k, v in counts.items()}
        counters["pipeline_jobs"] = float(self._pipe.jobs)
        counters["pipeline_pack_s"] = float(self._pipe.pack_s)
        counters["pipeline_wait_s"] = float(self._timing["wait_s"])
        # under its own (unprefixed) name: ingest_cap_overflow_total
        counters["ingest_cap_overflow"] = float(
            counts.get("ingest_cap_overflow", 0))
        filled = self.batcher.backfilled_total
        slack = self.batcher.slack_total
        gauges = {
            "serve_queue_depth": float(self.batcher.depth),
            "serve_draining": float(draining),
            "serve_warmed": float(self.warmed),
            "serve_recompiles_after_warm":
                float(self.graphs.captures_after_warm),
            "serve_rolling_window_s": self.rolling_window_s,
            "pipeline_pack_workers": float(self._pack_workers),
            "device_count": float(len(self.device_set)),
            "serve_engine_mesh": float(self.mesh_exec is not None),
            "ingest_raw_wire": float(self.shape_set.raw is not None),
        }
        for rung, occ in sorted(rung_occ.items()):
            gauges[f"ingest_rung{rung}_edge_occupancy"] = float(occ)
        gauges["serve_backfill_enabled"] = float(self.batcher.backfill)
        gauges["serve_padding_fill_share"] = filled / slack if slack else 0.0
        counters["serve_backfill_filled_slots"] = float(filled)
        counters["serve_backfill_slack_slots"] = float(slack)
        if self.cache is not None:
            hits, misses, size, capacity = self.cache.snapshot()
            counters["serve_cache_lookup_hits"] = float(hits)
            counters["serve_cache_lookup_misses"] = float(misses)
            gauges["serve_cache_size"] = float(size)
            gauges["serve_cache_capacity"] = float(capacity)
        # single flight rides the cache: a miss with a fingerprint
        gauges["serve_single_flight"] = float(self.cache is not None)
        gauges.update(cache_gauges(counters, gauges))
        gauges["observe_trace_ring"] = float(self.tracer is not None)
        if self.tracer is not None:
            gauges["observe_trace_dropped"] = float(self.tracer.dropped)
        fr = self.flightrec
        if fr is not None:
            frs = fr.stats()
            gauges["flightrec_bundles"] = float(frs["bundles"])
            gauges["flightrec_suppressed"] = float(frs["suppressed"])
        for i, depth in enumerate(self.device_set.inflight_depths()):
            gauges[f"device{i}_inflight"] = float(depth)
        if self.profiler is not None:
            gauges["profile_captures"] = float(self.profiler.captures)
            gauges["profile_busy"] = float(self.profiler.busy)
        series = {}
        for name, roll in (("serve_latency_ms", self._lat_rolling),
                           ("serve_batch_occupancy", self._occ_rolling)):
            q = roll.quantiles()
            if q:
                series[name] = q
        out = {"counters": counters, "gauges": gauges, "series": series}
        if self.hists:
            hists = {name: h.snapshot() for name, h in self.hists.items()}
            with self._lock:
                labelled = (
                    [("serve_version_latency_ms_hist",
                      {"param_version": str(v)}, h)
                     for v, h in self._version_hists.items()]
                    + [("serve_class_latency_ms_hist", {"class": str(k)}, h)
                       for k, h in sorted(self._class_hists.items())]
                    + [("serve_cache_lookup_ms_hist",
                        {"tier": t, "form": f, "outcome": o}, h)
                       for (t, f, o), h in sorted(self._cache_hists.items())])
            for family, labels, h in labelled:
                hists[family + format_labels(labels)] = h.snapshot()
            out["histograms"] = hists
        if self.slo is not None:
            gauges.update(self.slo.gauges())
        if self.tsdb is not None:
            ts = self.tsdb.stats()
            gauges["tsdb_series"] = float(ts["series"])
            gauges["tsdb_points"] = float(ts["points"])
            gauges["tsdb_dropped_series"] = float(ts["dropped_series"])
        return out

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
            rung_occ = dict(self._rung_edge_occ)
        filled = self.batcher.backfilled_total
        slack = self.batcher.slack_total
        counts.update(graph_captures=self.graphs.captures(),
                      graph_replays=self.graphs.replays(),
                      captures_after_warm=self.graphs.captures_after_warm)
        captured: dict[str, int] = {}
        by_tier: dict[str, dict[str, int]] = {}
        for (_, tier, form, _), g in list(self.graphs.graphs.items()):
            got = g.graph is not None
            captured[form] = captured.get(form, 0) + got
            tiers = by_tier.setdefault(tier, {})
            tiers[form] = tiers.get(form, 0) + got
        out = {
            "counts": counts,
            "captures_by_form": captured,
            "captures_by_tier": by_tier,
            "queue_depth": self.batcher.depth,
            "param_version": self.param_store.version,
            # what drives the entries: 'single', 'mesh' or 'threads'
            "engine": self.engine,
            "devices": self.device_set.stats(),
            "device_inflight": self.device_set.inflight_depths(),
            "device": str(self.device),
            "draining": draining,
            "warmed": self.warmed,
            "latency_ms": self.latency_quantiles(),
            # the last rolling_window_s seconds, not the whole run
            "rolling": {
                "window_s": self.rolling_window_s,
                "latency_ms": self._lat_rolling.quantiles(),
                "batch_occupancy": self._occ_rolling.quantiles(),
                "device_inflight": self.device_set.inflight_depths(),
            },
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
                "rung_edge_occupancy": {str(k): v for k, v in
                                        sorted(rung_occ.items())},
            },
        }
        if self.mesh_exec is not None:
            out["staged_bytes"] = list(self.mesh_exec.staged_bytes)
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
        if self.slo is not None:
            out["slo"] = self.slo.state()
        if self.tsdb is not None:
            out["tsdb"] = self.tsdb.stats()
        if self.flightrec is not None:
            out["flightrec"] = self.flightrec.stats()
        if self.profiler is not None:
            out["profile"] = {"captures": self.profiler.captures,
                              "rejected": self.profiler.rejected,
                              "busy": self.profiler.busy,
                              "recording": self.profiler.recording,
                              "last": self.profiler.last}
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
    devices="auto",
    engine: str = "auto",
    precision="f32",
    log_fn: Callable = print,
    wire: str = "auto",
    raw_precheck: bool = True,
    compact: str = "auto",
    watch: bool = True,
    poll_interval_s: float = 2.0,
    warm: bool = True,
    telemetry: Telemetry | None = None,
    trace_ring: int = 65536,
    slo_layer: bool = True,
    slo_objectives=None,
    slo_rules=None,
    profile_dir: str = "",
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
    JAX package's rule, 1 on a card (packing overlaps the replay) or over
    more than one entry, else 0 (on the CPU a packer would take the cores
    the step runs on).

    ``devices``: 'auto' (every visible card on CUDA, the one CPU device on
    the CPU), an int N (the first N cards; more than exist raises), or an
    explicit list of devices, taken as given (``[cuda:0, cuda:0]``: two
    entries on one card). ``engine``: 'auto' (mesh over more than one
    entry), 'mesh' or 'threads' (serve/devices.py, parallel/executor.py).
    ``precision``: the tiers to warm, 'f32,bf16,int8' or a sequence
    (serve/quantize.py; f32 always). ``telemetry``, ``trace_ring``,
    ``slo_layer``, ``slo_objectives``, ``slo_rules``: the server's
    (InferenceServer). ``profile_dir`` (non-empty) enables on-demand
    profiling into it (``enable_profiling``).

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
    device_list = (list(devices) if isinstance(devices, (list, tuple))
                   else resolve_devices(devices, dev))
    precisions = (parse_precisions(precision) if isinstance(precision, str)
                  else parse_precisions(",".join(precision)))
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
        pack_workers = 1 if dev.type == "cuda" or len(device_list) > 1 else 0
    template = calibration[0]
    server = InferenceServer(
        state, shape_set, version=version, max_queue=max_queue,
        max_wait_ms=max_wait_ms, class_max_wait_ms=class_max_wait_ms,
        backfill=backfill, wfq_weights=wfq_weights,
        default_timeout_ms=default_timeout_ms, cache_size=cache_size,
        pack_workers=pack_workers,
        featurizer=structure_featurizer(data_cfg), devices=device_list,
        engine=engine, precisions=precisions, log_fn=log_fn,
        raw_precheck=raw_precheck, telemetry=telemetry,
        trace_ring=trace_ring, slo_layer=slo_layer,
        slo_objectives=slo_objectives, slo_rules=slo_rules,
    )
    if profile_dir:
        server.enable_profiling(profile_dir)
    if mgr is not None and watch:
        server.attach_watcher(mgr, lambda: inference_state(meta, dev),
                              poll_interval_s=poll_interval_s, log_fn=log_fn)
    if warm:
        server.warm(template)
        server.start()
    return server, {"manager": mgr, "meta": meta, "model_cfg": model_cfg,
                    "data_cfg": data_cfg, "template": template,
                    "calibration": calibration}
