"""The port's host pipeline on the CPU: ``parallel_pack`` (in-order
results, in-order ``PackError``s, errors of the jobs iterator, threads
released when the consumer abandons it, a stress run with more threads
than cores), ``BufferPool``'s limits, and ``prefetch_to_device`` (the same
batches in the same order, the producer's errors, an abandoned consumer);
``fit`` through the loader gives bit-equal weights to ``fit`` without it.
The CUDA side-stream loader and the event-gated pool release run in
``tests/test_torch_cuda.py``."""

import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

from cgnn_tpu_torch.config import DataConfig, ModelConfig
from cgnn_tpu_torch.data.dataset import load_synthetic
from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
from cgnn_tpu_torch.data.loader import LoaderStats, prefetch_to_device
from cgnn_tpu_torch.data.pipeline import (
    BufferPool,
    PackError,
    PipelineStats,
    parallel_pack,
)
from cgnn_tpu_torch.train.loop import fit
from cgnn_tpu_torch.train.state import init_train_state


def _threads(prefix):
    return [t for t in threading.enumerate() if t.name.startswith(prefix)]


def _wait_gone(prefix, timeout=5.0):
    end = time.monotonic() + timeout
    while _threads(prefix) and time.monotonic() < end:
        time.sleep(0.01)
    return _threads(prefix)


def _slow_square(x):
    time.sleep(random.Random(x).uniform(0, 0.01))
    return x * x


@pytest.mark.parametrize("workers", [1, 3, 8])
def test_parallel_pack_keeps_job_order(workers):
    stats = PipelineStats()
    got = list(parallel_pack(range(40), _slow_square, workers=workers,
                             stats=stats, name=f"t-order{workers}"))
    assert got == [x * x for x in range(40)]
    assert stats.jobs == 40 and stats.workers == workers
    assert stats.pack_s > 0 and stats.wait_s >= 0
    assert not _wait_gone(f"t-order{workers}")


def test_pack_errors_come_out_in_order():
    def pack(x):
        if x % 4 == 1:
            raise ValueError(f"bad {x}")
        return x

    got = list(parallel_pack(range(10), pack, workers=3,
                             raise_on_error=False, name="t-errs"))
    assert [type(r) for r in got] == [PackError if x % 4 == 1 else int
                                      for x in range(10)]
    assert [str(r.error) for r in got if isinstance(r, PackError)] == [
        "bad 1", "bad 5", "bad 9"]
    seen = []
    with pytest.raises(ValueError, match="bad 1"):
        for r in parallel_pack(range(10), pack, workers=3, name="t-raise"):
            seen.append(r)
    assert seen == [0]
    assert not _wait_gone("t-raise")


def test_error_of_the_jobs_iterator_comes_after_its_results():
    def jobs():
        yield from range(5)
        raise RuntimeError("feed failed")

    seen = []
    with pytest.raises(RuntimeError, match="feed failed"):
        for r in parallel_pack(jobs(), lambda x: x, workers=2, name="t-feed"):
            seen.append(r)
    assert seen == list(range(5))


def test_abandoned_consumer_releases_the_threads():
    gen = parallel_pack(iter(range(10_000)), _slow_square, workers=4,
                        depth=3, name="t-abandon")
    assert [next(gen) for _ in range(3)] == [0, 1, 4]
    assert len(_threads("t-abandon")) == 5  # feeder + 4 workers
    gen.close()
    assert not _wait_gone("t-abandon", timeout=2.0)


def test_depth_bounds_the_jobs_in_flight():
    started = []
    lock = threading.Lock()

    def pack(x):
        with lock:
            started.append(x)
        return x

    gen = parallel_pack(range(100), pack, workers=2, depth=3, name="t-depth")
    assert next(gen) == 0
    time.sleep(0.3)
    with lock:
        assert len(started) <= 4  # the consumed one + depth in flight
    gen.close()
    with pytest.raises(ValueError, match="depth"):
        next(parallel_pack(range(3), pack, depth=-1))


def test_stress_more_threads_than_cores():
    """16 packers on a short switch interval: every result, once, in
    order (a lost update or a reordering breaks the equality)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        stats = PipelineStats()
        n = 600
        got = list(parallel_pack(range(n), lambda x: (x, x * 3), workers=16,
                                 depth=24, stats=stats, name="t-stress"))
    finally:
        sys.setswitchinterval(old)
    assert got == [(x, x * 3) for x in range(n)]
    assert stats.jobs == n
    assert not _wait_gone("t-stress")


def test_buffer_pool_limits():
    pool = BufferPool(limit_per_key=2)
    made = []

    def factory():
        made.append(object())
        return made[-1]

    a, b, c = (pool.acquire("k", factory) for _ in range(3))
    assert pool.allocated == 3 and pool.reused == 0 and len({a, b, c}) == 3
    for buf in (a, b, c):
        pool.release("k", buf)  # the third is over the limit: dropped
    assert pool.acquire("k", factory) is b
    assert pool.acquire("k", factory) is a
    assert pool.reused == 2
    assert pool.acquire("k", factory) is made[-1] and pool.allocated == 4
    assert pool.acquire("other", factory) is made[-1]  # its own free list
    assert pool.allocated == 5


def _graphs(n=24, seed=3):
    return load_synthetic(n, DataConfig(radius=5.0, max_num_nbr=8)
                          .featurize_config(), seed=seed)


def _host_batches(graphs, seed=0):
    nc, ec = capacities_for(graphs, 6, dense_m=8)
    return batch_iterator(graphs, 6, nc, ec, shuffle=True,
                          rng=np.random.default_rng(seed), dense_m=8,
                          snug=True)


def test_prefetch_on_cpu_yields_the_same_batches():
    graphs = _graphs()
    want = list(_host_batches(graphs))
    stats = LoaderStats()
    got = list(prefetch_to_device(_host_batches(graphs), "cpu", size=2,
                                  stats=stats))
    assert len(got) == len(want) == stats.batches > 2
    for a, b in zip(got, want):
        for name in ("nodes", "edges", "neighbors", "targets", "in_slots",
                     "over_slots"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        assert a.nodes.device.type == "cpu"
    assert stats.loader_put_s > 0 and stats.loader_wait_s >= 0


def test_prefetch_reraises_the_producers_error_after_its_batches():
    def batches():
        yield from _host_batches(_graphs(12))
        raise RuntimeError("pack failed")

    n_good = len(list(_host_batches(_graphs(12))))
    seen = []
    with pytest.raises(RuntimeError, match="pack failed"):
        for b in prefetch_to_device(batches(), "cpu"):
            seen.append(b)
    assert len(seen) == n_good


def test_prefetch_abandoned_consumer_releases_the_producer():
    def endless():
        graphs = _graphs(12)
        while True:
            yield from _host_batches(graphs)

    gen = prefetch_to_device(endless(), "cpu", size=2)
    next(gen)
    assert _threads("cgnn-torch-prefetch")
    gen.close()
    assert not _wait_gone("cgnn-torch-prefetch", timeout=2.0)


def test_fit_through_the_loader_is_bit_equal_to_fit_without():
    train_g, val_g = _graphs(30, seed=5), _graphs(10, seed=6)
    cfg = ModelConfig(atom_fea_len=16, n_conv=2, h_fea_len=24, dense_m=8)
    runs = []
    for prefetch in (2, 0):
        state, node_cap, _ = init_train_state(
            cfg, DataConfig(radius=5.0, max_num_nbr=8), train_g,
            batch_size=8, device="cpu", seed=1)
        stats = LoaderStats()
        state, result = fit(state, train_g, val_g, epochs=2, batch_size=8,
                            dense_m=8, device="cpu", node_cap=node_cap,
                            seed=4, log_fn=lambda *a: None,
                            prefetch=prefetch, loader_stats=stats)
        runs.append(({k: v.clone() for k, v in
                      state.model.state_dict().items()},
                     [(h["train"]["loss"], h["val"]["mae"])
                      for h in result["history"]], stats.batches))
    (sd_a, hist_a, n_a), (sd_b, hist_b, n_b) = runs
    assert hist_a == hist_b
    assert n_a == 2 * (4 + 2) and n_b == 0  # 4 train + 2 val batches an epoch
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
