"""Prefetching device loader (``cgnn_tpu/data/loader.py``).

A producer thread takes host batches from an iterator (packing them, as
the iterator does) and copies each to the device ahead of the consumer,
keeping up to ``size`` staged batches in a queue. On a CUDA device the
copy runs with ``non_blocking=True`` on a side stream, then records an
event. It overlaps the step only from page-locked memory, so the packer
packs into it (data/graph.py ``pack_graphs(pin=True)``, as train/loop.py
``fit`` asks on a card); from pageable memory the CUDA runtime copies
synchronously through a bounce buffer of its own. Before the consumer
reads a batch, its current stream waits on that event and every tensor
of the batch is marked used on that stream (``record_stream``), so the
caching allocator does not hand the memory out again while the step
still reads it. On the CPU the put is the identity.

Every queue put is bounded by a stop event that the consumer generator's
``finally`` sets, so a consumer that abandons the iterator releases the
producer within one tick. ``LoaderStats`` holds the counters:
``loader_wait_s``, the consumer's time blocked on an empty queue (the
loader not hiding host work), and ``loader_put_s``, the producer's time
packing and staging.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterable, Iterator

import torch

_SENTINEL = object()
_TICK = 0.05  # seconds; the shutdown-latency bound of every blocking put


@dataclasses.dataclass
class LoaderStats:
    """``prefetch_to_device``'s counters (module docstring)."""

    loader_wait_s: float = 0.0
    loader_put_s: float = 0.0
    batches: int = 0


def _tensors(batch) -> list[torch.Tensor]:
    return [v for f in dataclasses.fields(batch)
            if isinstance(v := getattr(batch, f.name), torch.Tensor)]


def prefetch_to_device(
    batches: Iterable,
    device,
    size: int = 2,
    stats: LoaderStats | None = None,
    join_timeout: float = 5.0,
) -> Iterator:
    """Wrap a host batch iterator (GraphBatch, CompactBatch or RawBatch:
    dataclasses of tensors with ``.to``) with a ``size``-deep queue of
    batches staged on ``device``, in the iterator's order. An exception
    of the producer is re-raised at the consumer after the batches before
    it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        # the producer thread sets its device: name the caller's current one
        dev = torch.device("cuda", torch.cuda.current_device())
    stats = stats if stats is not None else LoaderStats()
    q: queue.Queue = queue.Queue(maxsize=size)
    err: list[BaseException] = []
    stop = threading.Event()

    def bounded_put(item) -> bool:
        """A put that gives up when the consumer is gone -> False."""
        while not stop.is_set():
            try:
                q.put(item, timeout=_TICK)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            side = None
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
                side = torch.cuda.Stream(dev)
            it = iter(batches)
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    break
                done = None
                if side is None:
                    staged = b.to(dev)
                else:
                    with torch.cuda.stream(side):
                        staged = b.to(dev, non_blocking=True)
                        done = torch.cuda.Event()
                        done.record(side)
                stats.loader_put_s += time.perf_counter() - t0
                if not bounded_put((staged, done)):
                    return  # the consumer abandoned the iterator
        except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
            err.append(e)
        finally:
            bounded_put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True,
                         name="cgnn-torch-prefetch")
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            stats.loader_wait_s += time.perf_counter() - t0
            if item is _SENTINEL:
                break
            staged, done = item
            if done is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(done)
                for v in _tensors(staged):
                    v.record_stream(cur)
            stats.batches += 1
            yield staged
    finally:
        # on exhaustion and on generator close alike: release the
        # producer, then join (its puts are bounded by _TICK)
        stop.set()
        t.join(join_timeout)
    if err:
        raise err[0]
