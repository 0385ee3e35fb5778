"""FIFO micro-batcher: coalesce single-structure requests into batches of
the shape ladder (the FIFO core of ``cgnn_tpu/serve/batcher.py``).

A flush fires when the queued prefix would overflow the LARGEST shape
("shape_full"), when the prefix meets a request of the other staging form
("tier_boundary": a flush runs one program, featurized or raw wire), when
the oldest request has waited ``max_wait_ms`` ("deadline"), or when the
batcher is closed and draining ("drain").
Admission at ``offer``:

- bounded queue: a full queue rejects (``queue_full``, HTTP 429) instead
  of buffering without bound;
- a structure that does not fit the largest shape alone is rejected
  (``oversize``, HTTP 413) — queueing it would wedge the FIFO head;
- a closed (draining) batcher rejects new work (``shutdown``, HTTP 503)
  but keeps flushing what it accepted.

A request whose own deadline passed while queued is returned in
``Flush.expired`` and never packed (``timeout``, HTTP 504). Priority
classes, fair queuing and backfill are not ported yet.
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
    """One request's pending result."""

    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._error: BaseException | None = None

    def set_result(self, result) -> None:
        self._result = result
        self._done.set()

    def set_error(self, error: BaseException) -> None:
        self._error = error
        self._done.set()

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
    # slot budget under the shape set's layout, computed at admission
    nodes: int = 0
    edges: int = 0
    # staging form: 'feat' = a featurized CrystalGraph (or a wire-form
    # structure the worker featurizes at pack time), 'raw' = staged as a
    # RawBatch for the device neighbor search
    form: str = "feat"


@dataclasses.dataclass
class Flush:
    """One batcher decision: requests to pack (into ``shape``) plus any
    requests whose deadline expired while queued."""

    requests: list
    shape: BatchShape | None
    expired: list
    reason: str = ""  # 'shape_full' | 'tier_boundary' | 'deadline' | 'drain' | ''
    flush_id: str = ""
    form: str = "feat"  # the staging form every member shares

    def __bool__(self) -> bool:
        return bool(self.requests or self.expired)


class MicroBatcher:
    """Bounded FIFO queue + the flush policy of the module docstring."""

    def __init__(
        self,
        shape_set: ShapeSet,
        *,
        max_queue: int = 256,
        max_wait_ms: float = 5.0,
    ):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.shape_set = shape_set
        self.max_queue = max_queue
        self.max_wait = max_wait_ms / 1000.0
        self._queue: list[Request] = []
        self._cond = threading.Condition()
        self._closed = False
        self._flush_seq = 0

    def offer(self, request: Request) -> None:
        """Admit or reject (raises ServeRejection; never blocks)."""
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
            self._queue.append(request)
            self._cond.notify_all()

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def _take_locked(self, now: float) -> tuple[list, list, bool, bool]:
        """(FIFO batch prefix, expired, shape-full, form boundary); callers
        hold _cond. The prefix stops at the first request of another
        staging form."""
        big = self.shape_set.largest
        expired = [r for r in self._queue
                   if r.deadline is not None and now >= r.deadline]
        dead = set(map(id, expired))
        take: list[Request] = []
        n_nodes = n_edges = 0
        full = boundary = False
        for req in self._queue:
            if id(req) in dead:
                continue
            if take and req.form != take[0].form:
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
        return take, expired, full or len(take) >= big.graph_cap, boundary

    def poll(self, now: float | None = None) -> Flush | None:
        """Non-blocking flush decision at time ``now`` (the unit-testable
        core): a Flush when the policy fires or expiries need delivering,
        else None."""
        now = time.monotonic() if now is None else now
        with self._cond:
            take, expired, full, boundary = self._take_locked(now)
            waited = take and now - take[0].enqueued >= self.max_wait
            if full or boundary or waited or (self._closed and take):
                reason = ("shape_full" if full
                          else "tier_boundary" if boundary
                          else "deadline" if waited else "drain")
                fired = take
            elif expired:
                reason, fired = "", []
            else:
                return None
            shape = None
            if fired:
                shape = self.shape_set.shape_for(
                    len(fired), sum(r.nodes for r in fired),
                    sum(r.edges for r in fired))
            drop = set(map(id, fired)) | set(map(id, expired))
            self._queue = [r for r in self._queue if id(r) not in drop]
            self._flush_seq += 1
            return Flush(fired, shape, expired, reason,
                         flush_id=f"flush-{self._flush_seq:06d}",
                         form=fired[0].form if fired else "feat")

    def next_flush(self) -> Flush | None:
        """Block until the policy fires (worker-thread API). Returns None
        exactly once the batcher is closed AND empty — the worker's signal
        to exit after the drain."""
        while True:
            with self._cond:
                if self._closed and not self._queue:
                    return None
                if not self._queue:
                    self._cond.wait(timeout=self.max_wait)
                    continue
                # sleep until the oldest request's wait budget or the
                # soonest per-request deadline; an arrival that makes the
                # batch shape-full wakes us early via notify
                next_at = self._queue[0].enqueued + self.max_wait
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

    def close(self) -> None:
        """Stop admitting; queued work still flushes (graceful drain)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
