"""Priority-class continuous micro-batcher (``cgnn_tpu/serve/batcher.py``):
coalesce single-structure requests into batches of the shape ladder under
per-class wait budgets, backfilling padding slack with lower-class work.

Requests carry a priority class (``CLASSES``: ``interactive``, ``batch``,
``scavenger``) and wait in one bounded queue. A flush is cut for the head
class: the highest-priority class present, unless a class has waited past
its own budget, in which case the most overdue class wins (a scavenger
request cannot sit forever behind a saturated interactive stream). Within
the head class, requests are taken in weighted-fair-queuing order across
tenants (per-tenant virtual finish times), and the flush fires when the
head prefix would overflow the largest shape ("shape_full"), when its
oldest request has waited its class budget ("deadline"), when it meets a
request of another (precision, staging form) ("tier_boundary": a flush
runs one program), or when the batcher is closed and draining ("drain").
Once the rung is chosen for the head prefix, backfill fills its remaining
graph, node and edge slack with lower-class requests of the same
(precision, form): padding becomes answers without delaying the head and
without leaving the warm shape set.

Admission at ``offer``:

- bounded queue: a full queue rejects (``queue_full``, HTTP 429) instead
  of buffering without bound;
- a structure that does not fit the largest shape alone is rejected
  (``oversize``, HTTP 413): queueing it would wedge the head;
- an unknown priority class is malformed (HTTP 400): mapping it to a
  default would change the request's scheduling contract;
- a closed (draining) batcher rejects new work (``shutdown``, HTTP 503)
  but keeps flushing what it accepted.

A request whose own deadline passed while queued is returned in
``Flush.expired`` and never packed (``timeout``, HTTP 504).

The decision core, ``poll(now)``, takes its clock from the caller, so it
is testable without threads; ``next_flush``
adds the blocking loop the server's worker runs. ``queue_wait_hist`` (an
``observe.hist.Histogram``) takes each fired request's enqueue-to-flush
wait in ms at the flush decision. Not ported: the racecheck
instrumentation (ROADMAP Queue 1, item 13).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

from cgnn_tpu_torch.serve.shapes import BatchShape, ShapeSet

# rejection reasons: the JAX package's strings, and their HTTP statuses
QUEUE_FULL = "queue_full"
OVERSIZE = "oversize"
TIMEOUT = "timeout"
SHUTDOWN = "shutdown"
MALFORMED = "malformed"
HTTP_STATUS = {QUEUE_FULL: 429, OVERSIZE: 413, TIMEOUT: 504, SHUTDOWN: 503,
               MALFORMED: 400}

# priority classes, in scheduling order (stable strings: they ride the
# HTTP payloads and the per-class counters)
CLASSES = ("interactive", "batch", "scavenger")
DEFAULT_CLASS = CLASSES[0]
_CLASS_RANK = {c: i for i, c in enumerate(CLASSES)}

# each class's wait budget as a multiple of max_wait, where no
# class_max_wait_ms entry gives one
_DEFAULT_WAIT_MULT = {"interactive": 1.0, "batch": 4.0, "scavenger": 16.0}


def parse_kv_spec(spec: str) -> dict[str, float]:
    """``"key=float,key=float"`` -> dict (class waits, tenant weights);
    empty -> {}."""
    out: dict[str, float] = {}
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"malformed spec entry {part!r} (want key=value)")
        k, v = part.split("=", 1)
        out[k.strip()] = float(v)
    return out


class ServeRejection(RuntimeError):
    """A request the server declines to process; ``reason`` is one of the
    module-level rejection constants."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(detail or reason)

    @property
    def http_status(self) -> int:
        return HTTP_STATUS[self.reason]


class RequestFuture:
    """One request's pending result. ``add_done_callback`` serves miss
    coalescing (serve/server.py): followers of an in-flight fingerprint
    are answered from the leader's future on whichever thread resolves
    it, success, error or expiry alike, exactly once."""

    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._error: BaseException | None = None
        self._cb_lock = threading.Lock()
        self._callbacks: list = []

    def set_result(self, result) -> None:
        self._result = result
        self._done.set()
        self._fire_callbacks()

    def set_error(self, error: BaseException) -> None:
        self._error = error
        self._done.set()
        self._fire_callbacks()

    def add_done_callback(self, fn) -> None:
        """``fn(self)`` once this future resolves (at once if it has);
        callbacks run on the resolving thread."""
        with self._cb_lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _fire_callbacks(self) -> None:
        with self._cb_lock:
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            fn(self)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None):
        if not self._done.wait(timeout):
            raise TimeoutError("request still pending")
        if self._error is not None:
            raise self._error
        return self._result


@dataclasses.dataclass
class Request:
    """A queued single-structure prediction request."""

    graph: Any  # CrystalGraph, or a RawStructure (raw, or featurized later)
    enqueued: float  # monotonic seconds
    deadline: float | None  # absolute monotonic; None = no deadline
    future: RequestFuture = dataclasses.field(default_factory=RequestFuture)
    fingerprint: str | None = None  # the result cache's key
    # slot budget under the shape set's layout, computed at admission
    nodes: int = 0
    edges: int = 0
    # the trace id (minted at admission, or an inbound X-Request-Id), the
    # monotonic stage stamps and the inbound X-Trace-Parent span
    trace_id: str = ""
    stamps: dict = dataclasses.field(default_factory=dict)
    trace_parent: str = ""
    # a flush runs one program, so co-batched requests share the
    # precision tier and the staging form: 'feat' = a featurized
    # CrystalGraph (or a wire-form structure the packers featurize),
    # 'raw' = staged as a RawBatch for the device neighbor search
    precision: str = "f32"
    form: str = "feat"
    klass: str = DEFAULT_CLASS
    tenant: str = ""  # the WFQ tenant ("" = the shared anonymous one)
    backfilled: bool = False  # rode a higher-class flush's slack
    vft: float = 0.0  # WFQ virtual finish time, stamped at offer()


@dataclasses.dataclass
class Flush:
    """One batcher decision: requests to pack (into ``shape``) plus any
    requests whose deadline expired while queued."""

    requests: list
    shape: BatchShape | None
    expired: list
    # 'shape_full' | 'tier_boundary' | 'deadline' | 'drain' | '' (only
    # expiries)
    reason: str = ""
    flush_id: str = ""
    stamps: dict = dataclasses.field(default_factory=dict)
    precision: str = "f32"
    form: str = "feat"  # the staging form every member shares
    klass: str = DEFAULT_CLASS  # the class the flush was cut for
    # backfill accounting: members that rode padding slack, and the
    # graph-slot slack the rung had before backfill ran
    n_backfilled: int = 0
    slack_slots: int = 0

    def __bool__(self) -> bool:
        return bool(self.requests or self.expired)

    def trace_ids(self) -> list:
        """The members' trace ids (a span's join keys)."""
        return [r.trace_id for r in self.requests]


class MicroBatcher:
    """Bounded priority queue + the flush policy of the module
    docstring."""

    def __init__(
        self,
        shape_set: ShapeSet,
        *,
        max_queue: int = 256,
        max_wait_ms: float = 5.0,
        class_max_wait_ms: dict | None = None,
        backfill: bool = True,
        wfq_weights: dict | None = None,
        queue_wait_hist=None,
    ):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.shape_set = shape_set
        self.max_queue = max_queue
        self.max_wait = max_wait_ms / 1000.0
        # each fired request's enqueue -> flush wait (ms), at the flush
        # decision; None keeps the hot path untouched
        self.queue_wait_hist = queue_wait_hist
        self.class_wait = {c: self.max_wait * _DEFAULT_WAIT_MULT[c]
                           for c in CLASSES}
        for c, ms in (class_max_wait_ms or {}).items():
            if c not in _CLASS_RANK:
                raise ValueError(
                    f"unknown priority class {c!r} in class_max_wait_ms "
                    f"(have: {list(CLASSES)})")
            self.class_wait[c] = float(ms) / 1000.0
        self.backfill = bool(backfill)
        self.wfq_weights: dict[str, float] = {}
        for t, w in (wfq_weights or {}).items():
            if float(w) <= 0:
                raise ValueError(
                    f"wfq weight for tenant {t!r} must be > 0, got {w}")
            self.wfq_weights[str(t)] = float(w)
        self._queue: list[Request] = []
        self._cond = threading.Condition()
        self._closed = False
        self._flush_seq = 0
        # WFQ virtual time: the largest finish time served so far; a
        # tenant arriving after an idle spell starts here, so idling
        # banks no credit
        self._vtime = 0.0
        self._tenant_vft: dict[str, float] = {}
        self._backfilled_total = 0
        self._slack_total = 0

    # ---- admission ----

    def offer(self, request: Request) -> None:
        """Admit or reject (raises ServeRejection; never blocks)."""
        if request.klass not in _CLASS_RANK:
            raise ServeRejection(
                MALFORMED, f"unknown priority class {request.klass!r} "
                           f"(have: {list(CLASSES)})")
        n, e = self.shape_set.graph_counts(request.graph)
        request.nodes, request.edges = n, e
        if not self.shape_set.largest.fits(1, n, e):
            raise ServeRejection(
                OVERSIZE, self.shape_set.oversize_detail(request.graph))
        with self._cond:
            if self._closed:
                raise ServeRejection(SHUTDOWN, "server is draining")
            if len(self._queue) >= self.max_queue:
                raise ServeRejection(
                    QUEUE_FULL,
                    f"request queue at capacity ({self.max_queue})")
            # finish time = max(virtual time, the tenant's last finish)
            # + 1/weight: one tenant's arrivals chain, so single-tenant
            # traffic is strict FIFO
            w = self.wfq_weights.get(request.tenant, 1.0)
            base = max(self._vtime,
                       self._tenant_vft.get(request.tenant, 0.0))
            request.vft = base + 1.0 / w
            self._tenant_vft[request.tenant] = request.vft
            self._queue.append(request)
            self._cond.notify_all()

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    @property
    def backfilled_total(self) -> int:
        """Requests that rode a higher-class flush's padding slack."""
        with self._cond:
            return self._backfilled_total

    @property
    def slack_total(self) -> int:
        """Graph-slot slack offered to backfill across all flushes."""
        with self._cond:
            return self._slack_total

    # ---- flush policy ----

    def _head_class_locked(self, live: list, now: float) -> str:
        """The class the next flush is cut for: the highest-priority
        class present, unless some class has aged past its own budget,
        in which case the most overdue (ties toward the higher class).
        Callers hold ``_cond``."""
        oldest: dict[str, float] = {}
        for r in live:
            if r.klass not in oldest or r.enqueued < oldest[r.klass]:
                oldest[r.klass] = r.enqueued

        def urgency(c: str) -> float:
            return (now - oldest[c]) / max(self.class_wait[c], 1e-9)

        overdue = [c for c in oldest if urgency(c) >= 1.0]
        if overdue:
            return max(overdue,
                       key=lambda c: (urgency(c), -_CLASS_RANK[c]))
        return min(oldest, key=lambda c: _CLASS_RANK[c])

    def _take_locked(self, now: float) -> tuple[list, list, bool, bool]:
        """(head-class batch prefix, expired, shape-full, hit-boundary);
        callers hold ``_cond``. The head class's requests are walked in
        WFQ order; a (precision, form) change ends the prefix like a full
        shape does."""
        big = self.shape_set.largest
        expired = [r for r in self._queue
                   if r.deadline is not None and now >= r.deadline]
        dead = set(map(id, expired))
        live = [r for r in self._queue if id(r) not in dead]
        if not live:
            return [], expired, False, False
        head = self._head_class_locked(live, now)
        # stable sort: equal finish times keep arrival order
        cand = sorted((r for r in live if r.klass == head),
                      key=lambda r: r.vft)
        take: list[Request] = []
        n_nodes = n_edges = 0
        full = boundary = False
        key: tuple | None = None
        for req in cand:
            if key is None:
                key = (req.precision, req.form)
            elif (req.precision, req.form) != key:
                boundary = True
                break
            if not big.fits(len(take) + 1, n_nodes + req.nodes,
                            n_edges + req.edges):
                full = True
                break
            take.append(req)
            n_nodes += req.nodes
            n_edges += req.edges
        # graph slots saturated = full even with nothing else queued
        return (take, expired, full or len(take) >= big.graph_cap,
                boundary)

    def _backfill_locked(self, fired: list, shape: BatchShape,
                         now: float) -> tuple[int, int]:
        """Fill the chosen rung's remaining graph, node and edge slack
        with lower-class queued requests of the head's (precision, form),
        highest class first, WFQ order within; one that does not fit
        stays queued. -> (backfilled count, graph-slot slack offered).
        Callers hold ``_cond``."""
        head = fired[0]
        head_rank = _CLASS_RANK[head.klass]
        key = (head.precision, head.form)
        n = len(fired)
        slack = shape.graph_cap - n
        if slack <= 0:
            return 0, 0
        n_nodes = sum(r.nodes for r in fired)
        n_edges = sum(r.edges for r in fired)
        taken = set(map(id, fired))
        cand = [r for r in self._queue
                if id(r) not in taken
                and _CLASS_RANK[r.klass] > head_rank
                and (r.precision, r.form) == key
                and not (r.deadline is not None and now >= r.deadline)]
        cand.sort(key=lambda r: (_CLASS_RANK[r.klass], r.vft))
        backfilled = 0
        for r in cand:
            if not shape.fits(n + 1, n_nodes + r.nodes, n_edges + r.edges):
                continue
            r.backfilled = True
            fired.append(r)
            n += 1
            n_nodes += r.nodes
            n_edges += r.edges
            backfilled += 1
            if n >= shape.graph_cap:
                break
        return backfilled, slack

    def poll(self, now: float | None = None) -> Flush | None:
        """Non-blocking flush decision at time ``now``: a Flush when the
        policy fires or expiries need delivering, else None."""
        now = time.monotonic() if now is None else now
        with self._cond:
            take, expired, full, boundary = self._take_locked(now)
            head_wait = (self.class_wait[take[0].klass] if take
                         else self.max_wait)
            waited = take and now - min(r.enqueued for r in take) >= head_wait
            if full or boundary or waited or (self._closed and take):
                reason = ("shape_full" if full
                          else "tier_boundary" if boundary
                          else "deadline" if waited else "drain")
                fired = take
            elif expired:
                # nothing to pack yet, but expiries are delivered now
                reason, fired = "", []
            else:
                return None
            shape = None
            n_back = slack = 0
            if fired:
                # the rung is chosen for the head prefix; backfill only
                # fills its slack, never upgrades it
                shape = self.shape_set.shape_for(
                    len(fired), sum(r.nodes for r in fired),
                    sum(r.edges for r in fired))
                if self.backfill and shape is not None:
                    n_back, slack = self._backfill_locked(fired, shape, now)
                    self._backfilled_total += n_back
                    self._slack_total += slack
            drop = set(map(id, fired)) | set(map(id, expired))
            self._queue = [r for r in self._queue if id(r) not in drop]
            if self.queue_wait_hist is not None:
                for r in fired:
                    self.queue_wait_hist.observe((now - r.enqueued) * 1e3)
            if fired:
                self._vtime = max(self._vtime, max(r.vft for r in fired))
            self._flush_seq += 1
            return Flush(fired, shape, expired, reason,
                         flush_id=f"flush-{self._flush_seq:06d}",
                         precision=fired[0].precision if fired else "f32",
                         form=fired[0].form if fired else "feat",
                         klass=fired[0].klass if fired else DEFAULT_CLASS,
                         n_backfilled=n_back, slack_slots=slack)

    def next_flush(self) -> Flush | None:
        """Block until the policy fires (the worker's API). Returns None
        exactly once the batcher is closed AND empty: the worker's
        signal to exit after the drain."""
        while True:
            with self._cond:
                if self._closed and not self._queue:
                    return None
                if not self._queue:
                    self._cond.wait(timeout=self.max_wait)
                    continue
                # sleep until a class budget elapses or a deadline
                # passes; an arrival that fills a shape wakes us early
                next_at = min(r.enqueued + self.class_wait[r.klass]
                              for r in self._queue)
                dl = min((r.deadline for r in self._queue
                          if r.deadline is not None), default=None)
                if dl is not None:
                    next_at = min(next_at, dl)
                remaining = next_at - time.monotonic()
                if remaining > 0 and not self._closed:
                    self._cond.wait(timeout=remaining)
            flush = self.poll()
            if flush is not None:
                return flush

    # ---- drain ----

    def close(self) -> None:
        """Stop admitting; queued work still flushes (graceful drain)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
