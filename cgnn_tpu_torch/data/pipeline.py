"""Parallel host packing: a pool of packer threads feeding one consumer
(``cgnn_tpu/data/pipeline.py``).

    jobs --feeder--> in-queue --N workers (pack_fn)--> reassembly --> consumer
                                                       (in job order)

- Bounded: at most ``depth`` jobs are in flight (queued, packing, or
  packed and not yet consumed), so staged batches hold flat host memory
  however far the packers outrun the consumer.
- In order: results come out in job order whichever worker finishes
  first, so the caller's span bookkeeping survives.
- Shutdown: every blocking queue operation is bounded by a stop event the
  consumer generator's ``finally`` sets, so a consumer that abandons the
  iterator releases feeder and workers within one tick.
- Per-job errors: a ``pack_fn`` exception comes out in order as a
  :class:`PackError` (``raise_on_error=True`` re-raises it at the
  consumer), so one bad batch fails its own slot, not the stream.

Packing is numpy, whose large copies release the GIL. ``PipelineStats``
holds the counters: the consumer's wait, the workers' pack time, the jobs
done. ``BufferPool`` keeps staging buffers for reuse; a buffer goes back
only once the device has read it (train/infer.py, serve/server.py).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Hashable, Iterable, Iterator

_STOP = object()
_TICK = 0.05  # seconds; the shutdown-latency bound of every blocking op


@dataclasses.dataclass
class PackError:
    """The in-order stand-in for a job whose ``pack_fn`` raised."""

    error: BaseException


@dataclasses.dataclass
class PipelineStats:
    """``parallel_pack``'s counters, filled as it runs: ``wait_s`` the
    consumer's time blocked on the next in-order result (the packers not
    keeping ahead), ``pack_s`` the workers' summed time in ``pack_fn``,
    ``jobs`` the jobs packed, ``workers`` the pool size."""

    wait_s: float = 0.0
    pack_s: float = 0.0
    jobs: int = 0
    workers: int = 0


class BufferPool:
    """Reusable host staging buffers, keyed by (hashable) geometry.

    ``acquire`` pops a free buffer for ``key`` or builds one with
    ``factory``; ``release`` returns it. Never blocks; ``limit_per_key``
    only caps a flood of releases (extras go to the garbage collector).
    Thread-safe: packers acquire on worker threads, the consumer releases.
    """

    def __init__(self, limit_per_key: int = 16):
        self._free: dict[Hashable, list] = {}
        self._lock = threading.Lock()
        self.limit_per_key = limit_per_key
        self.allocated = 0  # fresh factory builds
        self.reused = 0

    def acquire(self, key: Hashable, factory: Callable[[], Any]):
        with self._lock:
            free = self._free.get(key)
            if free:
                self.reused += 1
                return free.pop()
            self.allocated += 1
        return factory()

    def release(self, key: Hashable, buf: Any) -> None:
        with self._lock:
            free = self._free.setdefault(key, [])
            if len(free) < self.limit_per_key:
                free.append(buf)


def parallel_pack(
    jobs: Iterable,
    pack_fn: Callable[[Any], Any],
    *,
    workers: int = 2,
    depth: int | None = None,
    stats: PipelineStats | None = None,
    raise_on_error: bool = True,
    name: str = "cgnn-torch-pack",
    join_timeout: float = 5.0,
) -> Iterator[Any]:
    """Yield ``pack_fn(job)`` for each job, in job order, packed by
    ``workers`` threads (module docstring). A feeder thread consumes
    ``jobs``, so a blocking jobs iterator overlaps with packing too.
    ``depth`` bounds the jobs in flight (default ``2 * workers``). An
    exception raised by ``jobs`` itself is re-raised at the consumer after
    the results before it."""
    workers = max(1, int(workers))
    depth = depth or 2 * workers
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    stats = stats if stats is not None else PipelineStats()
    stats.workers = workers
    in_q: queue.Queue = queue.Queue()
    stop = threading.Event()
    slots = threading.BoundedSemaphore(depth)
    cond = threading.Condition()
    results: dict[int, Any] = {}
    feed_err: list[BaseException] = []
    n_jobs = [-1]  # the job count, known once the feeder exhausts jobs

    def feeder() -> None:
        seq = 0
        try:
            for payload in jobs:
                while not stop.is_set():
                    if slots.acquire(timeout=_TICK):
                        break
                else:
                    return  # the consumer is gone
                if stop.is_set():
                    slots.release()
                    return
                in_q.put((seq, payload))
                seq += 1
        except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
            feed_err.append(e)
        finally:
            with cond:
                n_jobs[0] = seq
                cond.notify_all()
            in_q.put(_STOP)

    def worker() -> None:
        while not stop.is_set():
            try:
                item = in_q.get(timeout=_TICK)
            except queue.Empty:
                continue
            if item is _STOP:
                in_q.put(_STOP)  # wake the sibling workers too
                return
            seq, payload = item
            t0 = time.perf_counter()
            try:
                res = pack_fn(payload)
            except BaseException as e:  # noqa: BLE001 — delivered in order
                res = PackError(e)
            dt = time.perf_counter() - t0
            with cond:
                stats.pack_s += dt
                stats.jobs += 1
                results[seq] = res
                cond.notify_all()

    feed_t = threading.Thread(target=feeder, daemon=True,
                              name=f"{name}-feeder")
    work_ts = [threading.Thread(target=worker, daemon=True,
                                name=f"{name}-worker-{i}")
               for i in range(workers)]
    feed_t.start()
    for t in work_ts:
        t.start()
    try:
        seq = 0
        while True:
            t0 = time.perf_counter()
            with cond:
                while seq not in results:
                    if 0 <= n_jobs[0] <= seq:
                        break
                    cond.wait(timeout=_TICK)
                if seq not in results:
                    break
                res = results.pop(seq)
            stats.wait_s += time.perf_counter() - t0
            seq += 1
            slots.release()
            if isinstance(res, PackError) and raise_on_error:
                raise res.error
            yield res
    finally:
        # on exhaustion and on generator close alike: release feeder and
        # workers (every blocking op above is bounded by _TICK), then join
        stop.set()
        feed_t.join(join_timeout)
        for t in work_ts:
            t.join(join_timeout)
    if feed_err:
        raise feed_err[0]
