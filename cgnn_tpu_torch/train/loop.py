"""The per-step training loop (``cgnn_tpu/train/loop.py`` ``fit``,
``run_epoch``, ``evaluate``).

Each epoch packs its batches on the host (``batch_iterator``, snug
fill-to-capacity packing) and stages them on the device through the
prefetch loader (data/loader.py: a producer thread packs and copies
``prefetch`` batches ahead of the step; 0 stages each batch on this
thread), then runs one step on each. One ``np.random.default_rng(seed)``
shuffles every epoch's training
batches; training batches carry the two-tier transpose mapping for the
scatter-free backward, validation batches none (``in_cap=0``). Metric
sums accumulate on the device and are fetched once per epoch
(train/metrics.py). The loop keeps the best validation MAE and calls
``on_epoch_end`` after each epoch's validation (the checkpoint hook;
``start_epoch`` resumes). ``dense_m`` 0 or None trains on the flat COO
layout, whose batches carry no transpose mapping.

Not ported yet: the whole-epoch scan loop, pack-once and
device-resident staging, compact staging (which the JAX package allows
only under its scan loop), size buckets, telemetry, the divergence guard
and preemption.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from cgnn_tpu_torch.data.graph import (
    CrystalGraph,
    GraphBatch,
    batch_iterator,
    capacities_for,
)
from cgnn_tpu_torch.data.loader import LoaderStats, prefetch_to_device
from cgnn_tpu_torch.train.metrics import (
    accumulate_on_device,
    fetch_device_sums,
    means_from_sums,
)
from cgnn_tpu_torch.train.step import make_eval_step, make_train_step


def stage(batches: Iterable[GraphBatch], device, prefetch: int = 2,
          stats: LoaderStats | None = None) -> Iterable[GraphBatch]:
    """Host batches -> the same batches on ``device``, in order: through
    the prefetch loader ``prefetch`` deep, or (0) each copied on this
    thread as it is taken."""
    if prefetch > 0:
        return prefetch_to_device(batches, device, size=prefetch, stats=stats)
    return (b.to(device) for b in batches)


def run_epoch(step_fn: Callable, state, batches: Iterable[GraphBatch], *,
              train: bool = True, print_freq: int = 0, epoch: int = 0,
              log_fn: Callable = print) -> dict:
    """Drive one epoch of ``step_fn`` over batches on the device (``stage``)
    -> metric means."""
    sums = None
    steps = 0
    for it, batch in enumerate(batches):
        sums = accumulate_on_device(sums, step_fn(state, batch))
        steps += 1
        if print_freq and it % print_freq == 0:
            host = fetch_device_sums(sums)
            count = max(host.get("count", 1.0), 1.0)
            log_fn(f"{'Epoch' if train else 'Val'}: [{epoch}][{it}]  "
                   f"Loss {host['loss_sum'] / count:.4f}  "
                   f"MAE {host['mae_sum'] / count:.4f}")
    return means_from_sums(fetch_device_sums(sums), steps)


def batch_caps(graphs: Sequence[CrystalGraph], batch_size: int,
               dense_m: int | None, node_cap: int | None = None,
               edge_cap: int | None = None) -> tuple[int, int]:
    """(node_cap, edge_cap) of the batches: the given ones, the rest the
    snug capacities of ``graphs``. Dense (``dense_m`` > 0): the edge
    capacity is ``node_cap * dense_m``; COO (0 or None): its own."""
    if dense_m:
        if node_cap is None:
            node_cap, _ = capacities_for(graphs, batch_size, dense_m=dense_m)
        return node_cap, node_cap * dense_m
    if node_cap is None or edge_cap is None:
        snug_n, snug_e = capacities_for(graphs, batch_size)
        node_cap = snug_n if node_cap is None else node_cap
        edge_cap = snug_e if edge_cap is None else edge_cap
    return node_cap, edge_cap


def fit(
    state,
    train_graphs: Sequence[CrystalGraph],
    val_graphs: Sequence[CrystalGraph],
    *,
    epochs: int,
    batch_size: int,
    dense_m: int | None,
    device,
    node_cap: int | None = None,
    edge_cap: int | None = None,
    seed: int = 0,
    print_freq: int = 0,
    log_fn: Callable = print,
    start_epoch: int = 0,
    on_epoch_end: Callable | None = None,
    prefetch: int = 2,
    loader_stats: LoaderStats | None = None,
) -> tuple:
    """Train/validate epochs ``start_epoch`` .. ``epochs - 1``, tracking
    the best validation MAE.
    -> (state, {"best": best val MAE, "history": [per-epoch metrics]}).
    ``dense_m`` 0 or None packs the flat COO layout. The capacities
    default to the snug ones of the training graphs (``batch_caps``).

    As in the JAX loop, the data order's generator restarts from ``seed``
    at ``start_epoch`` and ``best`` from inf, so the first epoch of a
    resumed run moves the best pointer; ``on_epoch_end(state, epoch,
    val_metrics, is_best)`` runs after each epoch's validation (the
    checkpoint hook). ``prefetch``: the loader's depth (``stage``);
    ``loader_stats`` gathers its counters over the run."""
    dense_m = dense_m or None
    node_cap, edge_cap = batch_caps(train_graphs, batch_size, dense_m,
                                    node_cap, edge_cap)
    train_step, eval_step = make_train_step(), make_eval_step()
    rng = np.random.default_rng(seed)
    best = np.inf
    history = []
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        train_m = run_epoch(
            train_step, state,
            stage(batch_iterator(train_graphs, batch_size, node_cap,
                                 edge_cap, shuffle=True, rng=rng,
                                 dense_m=dense_m, snug=True),
                  device, prefetch, loader_stats),
            train=True, print_freq=print_freq, epoch=epoch, log_fn=log_fn)
        val_m = run_epoch(
            eval_step, state,
            stage(batch_iterator(val_graphs, batch_size, node_cap, edge_cap,
                                 dense_m=dense_m, in_cap=0, snug=True),
                  device, prefetch, loader_stats),
            train=False, epoch=epoch, log_fn=log_fn)
        metric = val_m.get("mae", np.nan)
        is_best = metric < best
        if is_best:
            best = metric
        history.append({"epoch": epoch, "train": train_m, "val": val_m,
                        "seconds": time.perf_counter() - t0})
        log_fn(f"Epoch {epoch}: train loss {train_m.get('loss', np.nan):.4f}"
               f"  val mae {metric:.4f}{' *' if is_best else ''}"
               f"  ({time.perf_counter() - t0:.1f}s)")
        if on_epoch_end is not None:
            on_epoch_end(state, epoch, val_m, is_best)
    return state, {"best": best, "history": history}


def evaluate(state, graphs: Sequence[CrystalGraph], batch_size: int,
             node_cap: int, dense_m: int | None, device,
             edge_cap: int | None = None) -> dict:
    """Metric means of the eval step over ``graphs`` (capacities as in
    ``fit``)."""
    dense_m = dense_m or None
    node_cap, edge_cap = batch_caps(graphs, batch_size, dense_m, node_cap,
                                    edge_cap)
    return run_epoch(
        make_eval_step(), state,
        stage(batch_iterator(graphs, batch_size, node_cap, edge_cap,
                             dense_m=dense_m, in_cap=0, snug=True), device),
        train=False)
