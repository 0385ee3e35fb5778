"""Data-parallel training over ``torch.distributed``, one process a card
(``cgnn_tpu/parallel/data_parallel.py``).

The JAX package runs one SPMD program: per-device batches stacked on a
leading axis, the step under ``shard_map`` over ``Mesh(('data',))``,
``pmean`` on grads and BatchNorm statistics and ``psum`` on the metric
sums. Its multi-process form runs one controller a host, with a strided
host shard, every epoch cut to the shortest host's step count, the
per-step loop only, and commits from process 0 alone. The port follows
that multi-process contract, because its ranks are processes: each rank
packs its own shard, trains on its own card, and its step is the JAX DP
step body (``cgnn_tpu/train/step.py:107-114``):

- the gradients of each rank's mean loss, averaged across ranks BEFORE
  the optimizer, so the clip and the weight decay see the averaged
  gradients (``cgnn_tpu/train/state.py:75-80``): the average of per-rank
  means, as ``pmean`` gives, not a mean over all structures;
- the BatchNorm running statistics averaged (each rank normalizes with
  its own batch statistics: the batch norm runs with ``axis_name=None``);
- the metric sums summed.

``ParallelTrainStep`` does this with ONE collective a step: the grad
part writes the gradients, the floating BatchNorm buffers and the metric
sums into one flat bucket; ``reduce`` SUM-all-reduces it; the apply part
divides the gradient and statistics regions by the world size, writes
them back, runs the optimizer and, with ``guard``, the divergence
guard's select, whose verdict reads the averaged state and the summed
``loss_sum`` (the same on every rank). The integer buffers and the
optimizer's device count are equal on every rank and stay out of the
bucket; ``check_replicated`` holds every tensor of the state to rank
0's bits after each epoch. On a card the two parts are two replayed
graphs around the collective (train/loop.py ``SplitStepRunner``).

Eval sums every validation structure exactly once: a rank with fewer
validation batches runs ``empty_batch_like`` ones up to the longest
rank's count (they add zero), and the epoch's sums are reduced once at
its end, where the JAX step ``psum``s each step's (sums add, so the
totals agree up to the order of the additions). The JAX multi-process
path instead cuts the validation batches to the shortest host's count,
which drops structures (ROADMAP Queue 3).

Under graph sharding (a D x G run, parallel/edge_parallel.py) the G
ranks of a graph group train one data index's batches together: the
sharded grad step leaves the same whole gradients, statistics and metric
sums on each of them, so the step averages and sums over the DATA group
only (the D ranks of one graph index; ``dist.data_group``): a world-wide
sum would count every step G times. The host shards, the shuffles and
the dropout streams follow the data index, so the ranks of a graph group
hold the same node leaves.

The epoch driver (train/loop.py ``ScanEpochDriver``) and pack-once
staging run under a process group on one host: each rank packs its
shard once, and ``agree_batches`` brings every rank's lists to the same
shape groups with the same sizes (the per-rank counterpart of the JAX
per-shape ``drop_last`` of device groups), so one schedule drawn from
process 0's generator (``sync_rng``) drives every rank and each step's
collective meets its peers; ``check_agreed`` fails loudly where the
schedules differ instead of hanging.

The per-step loop is train/loop.py ``fit``, which takes this path under
a live process group. The force task takes it too, its grad part
``train/force_step.py`` ``make_force_grad_step``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Iterable, Sequence

import torch

from cgnn_tpu_torch.data import invariants
from cgnn_tpu_torch.data.graph import GraphBatch, batch_shape_key
from cgnn_tpu_torch.observe.health import step_with_health
from cgnn_tpu_torch.parallel import dist
from cgnn_tpu_torch.resilience.guard import StepGuard


class ReplicaDriftError(RuntimeError):
    """The ranks of a data-parallel run hold different state."""


def stack_batches(batches: Sequence[GraphBatch]) -> GraphBatch:
    """Stack same-shape batches on a new leading axis (a host stack, for
    the invariant checks and for comparisons with the JAX package)."""
    first = batches[0]
    return dataclasses.replace(first, **{
        f.name: torch.stack([getattr(b, f.name) for b in batches])
        for f in dataclasses.fields(first)
        if getattr(first, f.name) is not None})


def empty_batch_like(batch: GraphBatch) -> GraphBatch:
    """An all-padding batch with ``batch``'s capacities (masks zero): it
    pads a rank's eval steps up to the longest rank's count and adds
    exactly zero to the summed metric sums. Never a training batch
    (``invariants.check_any(train=True)`` refuses one): its zero gradients
    would dilute the average. The dense layout keeps the structural
    centers and neighbors (slot k belongs to node k // M; padding is a
    masked self-loop); flat COO padding points at the last node slot, and
    its transpose fields, where present, order those edges as they
    stand."""
    ncap = batch.node_capacity
    dense = batch.edges.dim() == 3

    def last_node(t):
        return torch.full_like(t, ncap - 1)

    centers = batch.centers.clone() if dense else last_node(batch.centers)
    out = {f.name: torch.zeros_like(v) for f in dataclasses.fields(batch)
           if (v := getattr(batch, f.name)) is not None}
    out.update(centers=centers, neighbors=centers.clone())
    if batch.over_nodes is not None:
        out["over_nodes"] = last_node(batch.over_nodes)
    if batch.nbr_order is not None:
        e = batch.nbr_order.shape[0]
        out["nbr_order"] = torch.arange(e, dtype=batch.nbr_order.dtype,
                                        device=batch.nbr_order.device)
        for name in ("nbr_offsets", "center_offsets"):
            offsets = torch.zeros_like(getattr(batch, name))
            offsets[-1] = e
            out[name] = offsets
    return GraphBatch(**out)


def parallel_batches(batches: Iterable[GraphBatch], *, train: bool,
                     dense_m: int | None = None,
                     steps: int | None = None,
                     prep_fn: Callable | None = None) -> list:
    """This rank's batches of one epoch at the step count every rank
    runs: ``steps``, by default the shortest rank's count for training
    (an unmatched all-reduce hangs, so the longer ranks drop their tail,
    the JAX ``_equalized``) and the longest rank's for eval, which the
    shorter ranks pad with ``empty_batch_like`` copies of their last
    batch (every structure scored once). A training epoch with no step
    raises. Under ``--check-invariants`` every batch is checked, and a
    training batch must hold a real graph. ``prep_fn`` then maps each
    batch (graph sharding: ``edge_parallel.rank_view``, which drops an
    eval batch's mapping and keeps this rank's part of the edge
    leaves). The batches come packed (train/loop.py ``fit`` packs them
    with the capacities' ``node_multiple`` and the mapping's
    ``transpose_shards``)."""
    out = list(batches)
    if steps is None:
        steps = (dist.min_over_hosts(len(out)) if train
                 else dist.max_over_hosts(len(out)))
    if train:
        if not steps:
            raise ValueError(
                "no training step: some rank packed no training batch "
                "(fewer training graphs than ranks, or a batch size too "
                "large for its shard)")
        out = out[:steps]
    elif len(out) < steps:
        if not out:
            raise ValueError(
                f"process {dist.process_index()} has no validation batch "
                f"to pad from while another has {steps}: give every rank "
                f"a validation structure (a larger --val-ratio)")
        out += [empty_batch_like(out[-1])] * (steps - len(out))
    if invariants.enabled():
        for b in out:
            invariants.check_any(b, dense_m, train=train)
    return out if prep_fn is None else [prep_fn(b) for b in out]


def shape_counts(batches: Sequence[GraphBatch]) -> dict:
    """{shape key: batches of that shape}, in first-seen order."""
    counts: dict = {}
    for b in batches:
        k = batch_shape_key(b)
        counts[k] = counts.get(k, 0) + 1
    return counts


def agreed_shapes(counts_by_rank: Sequence[dict], train: bool) -> dict:
    """The per-shape step counts every rank runs -> {key: count}, in one
    order on every rank (rank 0's first-seen keys, then each later
    rank's new ones): a training shape at the least count of any rank
    (the JAX per-shape ``drop_last``: absent on one rank, it drops out),
    a validation shape at the largest."""
    order: list = []
    for counts in counts_by_rank:
        order += [k for k in counts if k not in order]
    pick = min if train else max
    out = {k: pick(c.get(k, 0) for c in counts_by_rank) for k in order}
    return {k: n for k, n in out.items() if n}


def cut_and_pad(batches: Sequence[GraphBatch], agreed: dict,
                templates: dict | None = None) -> list:
    """``batches`` cut to ``agreed``'s count of each shape (the first
    ones, in order), then each shape short of its count padded with
    ``empty_batch_like`` copies of its first batch (or of
    ``templates[key]`` where this rank has none), in ``agreed``'s order
    at the end."""
    kept: dict = {k: 0 for k in agreed}
    out, first = [], {}
    for b in batches:
        k = batch_shape_key(b)
        first.setdefault(k, b)
        if k in agreed and kept[k] < agreed[k]:
            kept[k] += 1
            out.append(b)
    for k, n in agreed.items():
        if kept[k] < n:
            like = first.get(k)
            if like is None:
                like = (templates or {})[k]
            out += [empty_batch_like(like)] * (n - kept[k])
    return out


def agree_lists(lists_by_rank: Sequence[list], train: bool) -> list:
    """Every rank's list cut or padded to the agreed per-shape counts
    (``agreed_shapes``, ``cut_and_pad``) in one process: the one-process
    twin of ``agree_batches``, for emulations and tests."""
    agreed = agreed_shapes([shape_counts(b) for b in lists_by_rank], train)
    templates = {}
    for batches in lists_by_rank:
        for b in batches:
            templates.setdefault(batch_shape_key(b), b)
    return [cut_and_pad(b, agreed, templates) for b in lists_by_rank]


def agree_batches(batches: Iterable[GraphBatch], *, train: bool,
                  dense_m: int | None = None) -> tuple[list, list]:
    """This rank's packed batches of one split at the per-shape counts
    every rank runs (the epoch driver's and pack-once's lists: the same
    shape groups, with the same sizes, on every rank) -> (batches, the
    agreed key order). The keys and counts are exchanged once over the
    host group. Training shapes are cut to the least count; validation
    shapes padded to the largest with ``empty_batch_like`` batches, and
    a rank that holds no batch of a shape takes its template from the
    lowest rank that does (one broadcast a shape). Under
    ``--check-invariants`` every kept batch is checked; a training
    split with no step raises, as ``parallel_batches`` does."""
    batches = list(batches)
    mine = shape_counts(batches)
    counts_by_rank = dist.all_gather_object(mine)
    agreed = agreed_shapes(counts_by_rank, train)
    if train and not agreed:
        raise ValueError(
            "no training step: the ranks packed no training batch of a "
            "shape every rank holds (fewer training graphs than ranks, or "
            "a batch size too large for a shard)")
    templates = {}
    for k in agreed:
        holders = [r for r, c in enumerate(counts_by_rank) if k in c]
        if len(holders) < len(counts_by_rank):
            like = next((b for b in batches if batch_shape_key(b) == k),
                        None)
            like = dist.broadcast_object(
                empty_batch_like(like) if like is not None else None,
                src=holders[0])
            if k not in mine:
                templates[k] = like
    out = cut_and_pad(batches, agreed, templates)
    if invariants.enabled():
        for b in out:
            invariants.check_any(b, dense_m, train=train)
    return out, list(agreed)


def sync_rng(rng) -> None:
    """Process 0's generator state into ``rng`` on every process: the
    draws after packing (the epoch driver's schedule, pack-once's batch
    order) are then the same on every rank."""
    rng.bit_generator.state = dist.broadcast_object(rng.bit_generator.state)


class ScheduleDivergedError(RuntimeError):
    """The ranks drew different epoch-driver schedules."""


def check_agreed(value: str, where: str) -> None:
    """Hold ``value`` (a digest) to process 0's on every rank: every
    rank raises ``ScheduleDivergedError`` together, naming the ranks
    that differ, where any does (one host collective)."""
    if not dist.active():
        return
    values = dist.all_gather_object(value)
    bad = [r for r, v in enumerate(values) if v != values[0]]
    if bad:
        raise ScheduleDivergedError(
            f"{where}: process(es) {bad} drew another schedule than "
            f"process 0 ({values[0][:16]}); a collective would hang")


def state_tensors(state) -> list:
    """Every tensor that must be equal on every rank, in a fixed order:
    parameters, buffers, the optimizer's buffers and device count, the
    normalizer."""
    return (list(state.model.parameters()) + list(state.model.buffers())
            + state.optimizer.tensors()
            + [state.normalizer.mean, state.normalizer.std])


def state_digest(state) -> str:
    """sha256 of the bits of ``state_tensors`` (host copies)."""
    h = hashlib.sha256()
    for t in state_tensors(state):
        h.update(t.detach().reshape(-1).cpu().contiguous().view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def check_replicated(state, where: str) -> str:
    """Hold every rank's state to rank 0's bits -> this rank's digest.
    Every rank raises ``ReplicaDriftError`` together when any differs."""
    digest = state_digest(state)
    if not dist.active():
        return digest
    ref = dist.broadcast_str(digest)
    if not dist.min_over_hosts(int(digest == ref)):
        raise ReplicaDriftError(
            f"{where}: the ranks' states differ (process "
            f"{dist.process_index()} holds {digest[:16]}, process 0 "
            f"{ref[:16]})")
    return digest


def replicate_state(state):
    """Rank 0's state on every rank, in place (every tensor of
    ``state_tensors``; the host count follows the device count), then
    ``check_replicated``. A no-op in a single-process run."""
    if not dist.active():
        return state
    dist.broadcast_(state_tensors(state))
    # tensors()[0] is the optimizer's device count: the host mirror too
    state.optimizer.count = int(state.optimizer.tensors()[0])
    check_replicated(state, "replicate_state")
    return state


def seed_rank_dropout(model, seed: int, rank: int, world: int,
                      start_epoch: int = 0) -> None:
    """Give data index ``rank`` (of ``world``; the rank itself without
    graph sharding, ``dist.data_index()`` with it, so the ranks of a
    graph group draw the same masks) a dropout stream of its own (the
    JAX step folds the device index into its key): seed + rank from a
    fresh start. Process 0 alone commits, so a resume restores process
    0's generator; every other index re-seeds with seed + rank + world *
    start_epoch, a seed no other (index, epoch) takes."""
    draws = getattr(model, "draws_dropout", None)
    if draws is None or not draws():
        return
    if start_epoch and rank == 0:
        return
    model.dropout_seed = seed + rank + world * start_epoch
    model.dropout_generator().manual_seed(model.dropout_seed)


class ParallelTrainStep:
    """One rank's data-parallel train step (module docstring):
    ``grad_part(state, batch)``, ``reduce()``, ``apply_part(state) ->
    metric sums``; called, the three in turn. ``grad_step`` is
    train/step.py's ``make_grad_step`` (or the force task's
    ``make_force_grad_step``); ``reducer`` the SUM all-reduce
    (``dist.SumReducer`` over the data group, or any callable that sums
    the bucket over the ranks in place); ``world`` the ranks it averages
    over. The bucket is laid out at the first call: the gradients of the
    parameters that have one, every persistent floating buffer of the
    model (the BatchNorm statistics; a constant such as the force
    field's Gaussian centres is not state and stays out), then the
    metric sums, in the parameters' dtype. ``grad_health`` adds the
    grad-health metrics (observe/health.py) in ``apply_part``, from the
    averaged gradients, so every rank holds the same values."""

    def __init__(self, grad_step: Callable, reducer: Callable, world: int,
                 guard: bool = False, grad_health: bool = False):
        self.grad_step = grad_step
        self.reducer = reducer
        self.world = int(world)
        self.guard = StepGuard() if guard else None
        self.grad_health = grad_health
        self.bucket: torch.Tensor | None = None
        self._params: list = []
        self._buffers: list = []
        self._keys: list = []
        self._sizes: list = []

    def _layout(self, state, metrics: dict) -> None:
        self._params = [p for p in state.optimizer.params
                        if p.grad is not None]
        persistent = state.model.state_dict().keys()
        self._buffers = [b for name, b in state.model.named_buffers()
                         if b.is_floating_point() and name in persistent]
        self._keys = sorted(metrics)
        dtype = self._params[0].dtype
        odd = [t.dtype for t in self._params + self._buffers
               if t.dtype != dtype]
        if odd:
            raise TypeError(f"one bucket dtype: parameters are {dtype}, "
                            f"also found {sorted(set(map(str, odd)))}")
        self._sizes = [t.numel() for t in self._params + self._buffers]
        self.bucket = self._params[0].new_empty(
            sum(self._sizes) + len(self._keys))

    def grad_part(self, state, batch) -> None:
        """Forward and backward on this rank's batch; the gradients, the
        new floating buffers and the metric sums into the bucket."""
        if self.guard is not None:
            self.guard.save(state)
        metrics = self.grad_step(state, batch)
        if self.bucket is None:
            self._layout(state, metrics)
        if sorted(metrics) != self._keys:
            raise ValueError(f"metric keys {sorted(metrics)} differ from "
                             f"the bucket's {self._keys}")
        dtype = self.bucket.dtype
        torch.cat([p.grad.reshape(-1) for p in self._params]
                  + [b.reshape(-1) for b in self._buffers]
                  + [metrics[k].reshape(1).to(dtype) for k in self._keys],
                  out=self.bucket)

    def reduce(self) -> None:
        self.reducer(self.bucket)

    @torch.no_grad()
    def apply_part(self, state) -> dict:
        """The averaged gradients and statistics back into the state, the
        optimizer update and the guard's select -> the summed (and
        guarded) metric sums."""
        n_avg = sum(self._sizes)
        averaged = self.bucket[:n_avg]
        averaged.div_(self.world)
        views = [v.view(t.shape) for v, t in zip(
            averaged.split(self._sizes), self._params + self._buffers)]
        n_p = len(self._params)
        if self._buffers:  # the force field has no statistics
            torch._foreach_copy_(self._buffers, views[n_p:])
        for p, g in zip(self._params, views[:n_p]):
            p.grad = g
        summed = self.bucket[n_avg:].clone()
        metrics = dict(zip(self._keys, summed.unbind()))
        if self.grad_health:
            # from the averaged gradients, so every rank holds the same
            metrics = step_with_health(state, metrics, state.optimizer.step)
        else:
            state.optimizer.step()
        if self.guard is not None:
            metrics = self.guard.select(state, metrics)
        return metrics

    def __call__(self, state, batch) -> dict:
        self.grad_part(state, batch)
        self.reduce()
        return self.apply_part(state)


def make_parallel_train_step(classification: bool = False,
                             guard: bool = False,
                             grad_step: Callable | None = None,
                             grad_health: bool = False
                             ) -> ParallelTrainStep:
    """The data-parallel train step over the live process group's data
    group: ``step(state, batch)`` with this rank's batch -> the metric
    sums summed over the data group, the state updated with the averaged
    gradients and statistics (module docstring). ``grad_step``: the grad
    part (default ``make_grad_step(classification=...)``, which a
    graph-sharded model makes the sharded grad step)."""
    from cgnn_tpu_torch.train.step import make_grad_step

    group = dist.data_group()
    return ParallelTrainStep(
        grad_step or make_grad_step(classification=classification),
        dist.SumReducer(group), group.size if group else 1, guard=guard,
        grad_health=grad_health)


def sum_reducer_for_sums() -> Callable:
    """-> ``reduce(sums)``: a dict of 0-d device sums summed over the
    data group in place, in one collective (sorted keys, one stacked
    tensor)."""
    reducer = dist.SumReducer(dist.data_group())

    def reduce(sums: dict) -> None:
        if not sums:
            return
        keys = sorted(sums)
        flat = torch.stack([sums[k] for k in keys])
        reducer(flat)
        for k, v in zip(keys, flat.unbind()):
            sums[k].copy_(v)

    return reduce


def make_parallel_eval_step(classification: bool = False) -> Callable:
    """``step(state, batch)`` with this rank's batch (an
    ``empty_batch_like`` one where it has none left) -> the metric sums
    summed over the data group: the eval step, then one collective. The
    loop (train/loop.py ``fit``) sums an epoch's steps on each rank and
    reduces once at its end instead."""
    from cgnn_tpu_torch.train.step import make_eval_step

    inner = make_eval_step(classification=classification)
    reduce = sum_reducer_for_sums()

    def eval_step(state, batch) -> dict:
        metrics = {k: v.clone() for k, v in inner(state, batch).items()}
        reduce(metrics)
        return metrics

    return eval_step


class CoordinatedCheckpoint:
    """What ``DivergenceMonitor`` reads of a checkpoint manager, on every
    rank of a data-parallel run: process 0's manager (``ckpt``; None on
    the other ranks) answers, and a rollback restores process 0's save
    there and re-replicates it to every rank (the JAX
    ``monitor.post_restore = replicate_state``). Every call is a
    collective: the monitor's verdict is the same on every rank, since it
    reads summed metrics."""

    def __init__(self, ckpt=None):
        self._ckpt = ckpt

    def wait(self) -> None:
        if self._ckpt is not None:
            self._ckpt.wait()

    def exists(self, tag: str = "latest") -> bool:
        here = self._ckpt is not None and self._ckpt.exists(tag)
        return dist.broadcast_str("1" if here else "") == "1"

    def restore(self, state, tag: str = "latest") -> tuple:
        err, epoch = "", "?"
        if self._ckpt is not None:
            try:
                _, meta = self._ckpt.restore(state, tag)
                epoch = str(meta.get("epoch", "?"))
            except RuntimeError as e:  # CheckpointRestoreError among them
                err = f"{type(e).__name__}: {e}"
        err = dist.broadcast_str(err)
        if err:
            raise RuntimeError(f"process 0 could not restore: {err}")
        replicate_state(state)
        return state, {"epoch": dist.broadcast_str(epoch)}


class AgreedPreemption:
    """A preemption handler's request, agreed across the ranks: a signal
    may reach one rank only, and every rank must stop at the same epoch
    boundary (one collective a read)."""

    def __init__(self, handler):
        self._handler = handler

    @property
    def requested(self) -> bool:
        return bool(dist.max_over_hosts(int(self._handler.requested)))
