"""The per-step training loop (``cgnn_tpu/train/loop.py`` ``fit``,
``run_epoch``, ``evaluate``).

Each epoch packs its batches on the host (``batch_iterator``, snug
fill-to-capacity packing), moves each to the device and runs one step on
it. One ``np.random.default_rng(seed)`` shuffles every epoch's training
batches; training batches carry the two-tier transpose mapping for the
scatter-free backward, validation batches none (``in_cap=0``). Metric
sums accumulate on the device and are fetched once per epoch. The loop
keeps the best validation MAE.

Not ported yet: the whole-epoch scan loop, pack-once and
device-resident staging, compact staging, size buckets, telemetry, the
divergence guard and preemption.
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
from cgnn_tpu_torch.train.step import make_eval_step, make_train_step


def accumulate(sums: dict | None, metrics: dict) -> dict:
    """Add one step's metric sums into the running sums, on the device."""
    if sums is None:
        return {k: v.detach().clone() for k, v in metrics.items()}
    for k, v in metrics.items():
        sums[k].add_(v)
    return sums


def means_from_sums(sums: dict, steps: int) -> dict:
    """Epoch means from '<name>_sum' totals: each divides by its
    '<name>_count' when there is one, else by the global 'count'."""
    count = max(sums.get("count", 1.0), 1.0)
    out = {
        k[: -len("_sum")]: v / max(sums.get(k[: -len("_sum")] + "_count",
                                            count), 1.0)
        for k, v in sums.items() if k.endswith("_sum")
    }
    out["count"] = sums.get("count", 0.0)
    out["steps"] = steps
    return out


def fetch(sums: dict | None) -> dict:
    """The device sums as Python floats, in ONE device-to-host copy."""
    if not sums:
        return {}
    keys = list(sums)
    values = torch.stack([sums[k].double() for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


def run_epoch(step_fn: Callable, state, batches: Iterable[GraphBatch],
              device, *, train: bool = True, print_freq: int = 0,
              epoch: int = 0, log_fn: Callable = print) -> dict:
    """Drive one epoch of ``step_fn`` over host batches -> metric means."""
    sums = None
    steps = 0
    for it, batch in enumerate(batches):
        sums = accumulate(sums, step_fn(state, batch.to(device)))
        steps += 1
        if print_freq and it % print_freq == 0:
            host = fetch(sums)
            count = max(host.get("count", 1.0), 1.0)
            log_fn(f"{'Epoch' if train else 'Val'}: [{epoch}][{it}]  "
                   f"Loss {host['loss_sum'] / count:.4f}  "
                   f"MAE {host['mae_sum'] / count:.4f}")
    return means_from_sums(fetch(sums), steps)


def fit(
    state,
    train_graphs: Sequence[CrystalGraph],
    val_graphs: Sequence[CrystalGraph],
    *,
    epochs: int,
    batch_size: int,
    dense_m: int,
    device,
    node_cap: int | None = None,
    seed: int = 0,
    print_freq: int = 0,
    log_fn: Callable = print,
) -> tuple:
    """Train/validate per epoch, tracking the best validation MAE.
    -> (state, {"best": best val MAE, "history": [per-epoch metrics]}).
    ``node_cap`` defaults to the snug capacity of the training graphs;
    the edge capacity is ``node_cap * dense_m``."""
    if node_cap is None:
        node_cap, _ = capacities_for(train_graphs, batch_size,
                                     dense_m=dense_m)
    edge_cap = node_cap * dense_m
    train_step, eval_step = make_train_step(), make_eval_step()
    rng = np.random.default_rng(seed)
    best = np.inf
    history = []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        train_m = run_epoch(
            train_step, state,
            batch_iterator(train_graphs, batch_size, node_cap, edge_cap,
                           shuffle=True, rng=rng, dense_m=dense_m,
                           snug=True),
            device, train=True, print_freq=print_freq, epoch=epoch,
            log_fn=log_fn)
        val_m = run_epoch(
            eval_step, state,
            batch_iterator(val_graphs, batch_size, node_cap, edge_cap,
                           dense_m=dense_m, in_cap=0, snug=True),
            device, train=False, epoch=epoch, log_fn=log_fn)
        metric = val_m.get("mae", np.nan)
        is_best = metric < best
        if is_best:
            best = metric
        history.append({"epoch": epoch, "train": train_m, "val": val_m,
                        "seconds": time.perf_counter() - t0})
        log_fn(f"Epoch {epoch}: train loss {train_m.get('loss', np.nan):.4f}"
               f"  val mae {metric:.4f}{' *' if is_best else ''}"
               f"  ({time.perf_counter() - t0:.1f}s)")
    return state, {"best": best, "history": history}


def evaluate(state, graphs: Sequence[CrystalGraph], batch_size: int,
             node_cap: int, dense_m: int, device) -> dict:
    """Metric means of the eval step over ``graphs``."""
    return run_epoch(
        make_eval_step(), state,
        batch_iterator(graphs, batch_size, node_cap, node_cap * dense_m,
                       dense_m=dense_m, in_cap=0, snug=True),
        device, train=False)
