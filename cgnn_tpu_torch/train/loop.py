"""The training loops (``cgnn_tpu/train/loop.py`` ``fit``, ``evaluate``,
``PackOncePlan``, ``ScanEpochDriver``).

Two drivers, with ``fit``'s rules from the JAX package:

- the per-step loop: each epoch's batches (packed every epoch, or once
  with ``pack_once``; staged through the prefetch loader, or once with
  ``device_resident``) run one step each;
- the epoch driver (``scan_epochs``, which implies ``device_resident``,
  which implies ``pack_once``): every batch is packed and staged once,
  stacked by shape (``batch_shape_key``) on the device, and each epoch
  runs the JAX ``ScanEpochDriver``'s step sequence from the same seed:
  its schedule (``_build_sched``: chunk lengths from {c/2, c, 2c},
  weighted group picks drawn one epoch ahead, a mixed single-step tail)
  is copied here, numpy for numpy.

On a CUDA device every step is a replayed CUDA graph (train/graphs.py),
one per (shape, train|eval), captured before the first epoch (the
driver) or at a shape's first batch (the per-step loop). The driver's
graph reads its batch as ``stacked[perm[cursor]]`` from its group's
stacks and advances ``cursor`` on the device, so a chunk of length L is
L replays with no host write between them; the host writes each group's
permutation once an epoch. The per-step loop copies each batch into its
graph's static inputs. Metric sums accumulate in static device tensors
(``DeviceSums``) inside the graphs and are fetched once an epoch (the
driver: once an epoch pair, train and eval in one copy). ``graphs=False``
steps eagerly (on the CPU there are no graphs); ``evaluate`` always does.

``compact`` (a ``data.compact.CompactSpec``; needs ``scan_epochs`` and
the dense layout) stages training and validation batches compactly and
rebuilds each inside its step (``make_expander``), as the JAX scan body
does. The staged bytes are checked against the card's free memory
(``check_device_resident_fit``); where they do not fit, the driver falls
back LOUDLY to host pack-once staging through the per-step loop.

The loop keeps the best validation MAE (a classifier's: the highest
accuracy, ``correct``, as the JAX loop does; the force task's: the force
MAE, ``force_mae``) and calls ``on_epoch_end``
after each epoch's validation (the checkpoint hook; ``start_epoch``
resumes). ``dense_m`` 0 or None trains on the flat COO layout. The task
and the edge features' storage type follow the model: a classifier
takes ``classification_loss``, a bf16 model's batches stage bf16 edges
(``pack_graphs(edge_dtype=...)``; a compact spec must carry the same).
The force field (train/force_step.py) takes the composite energy + force
loss in every driver; its validation batches carry the gathers'
transpose (its eval step takes a gradient), and compact staging is
refused for it, as train.py refuses it.

Resilience (``cgnn_tpu_torch/resilience``), the JAX ``fit``'s contract:
``guard`` wraps the train body in both drivers with the in-graph
divergence guard (``guard_step``: the skip is a select inside the
replayed graph), and the host mirror of the optimizer's count is settled
from the epoch's one fetch (``settle_count``); ``monitor`` (a
``DivergenceMonitor``) is consulted at each epoch's end, before the
save, and may roll the state back in place with a cut rate; ``preempt``
(a ``PreemptionHandler``) is polled at epoch boundaries and, by the
driver, between chunks. A driver stopped mid-epoch skips its eval, the
current weights are saved under the last completed epoch, and the result
says ``{"preempted": True}``. The fault plan's batch faults
(``faultinject.poison_batches``) reach the training batches before any
staging takes them.

Not ported: the in-scan telemetry tap and the background pair fetch,
the invariant checks on staged stacks, data-parallel drivers and their
guard, and ``--profile`` (ROADMAP Queue 1).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from cgnn_tpu_torch.data.graph import (
    CrystalGraph,
    GraphBatch,
    batch_iterator,
    batch_shape_key,
    bucketed_batch_iterator,
    capacities_for,
    pack_graphs,
)
from cgnn_tpu_torch.data.loader import LoaderStats, prefetch_to_device
from cgnn_tpu_torch.resilience import faultinject
from cgnn_tpu_torch.resilience.guard import guard_step, skipped_steps
from cgnn_tpu_torch.train.graphs import (
    GraphCache,
    StepGraph,
    batch_tensors,
    state_generators,
    state_guard,
    tensor_guard,
)
from cgnn_tpu_torch.train.metrics import (
    DeviceSums,
    fetch_device_sums,
    means_from_sums,
)
from cgnn_tpu_torch.train.force_step import (
    make_force_eval_step,
    make_force_train_step,
)
from cgnn_tpu_torch.train.step import (
    is_force,
    make_eval_step,
    make_train_step,
    model_task,
)

# share of the card's free memory the staged dataset may claim: the rest
# is parameters, optimizer state, the graphs' pools and workspace
_STAGE_FRACTION = 0.8


def stage(batches: Iterable[GraphBatch], device, prefetch: int = 2,
          stats: LoaderStats | None = None) -> Iterable[GraphBatch]:
    """Host batches -> the same batches on ``device``, in order: through
    the prefetch loader ``prefetch`` deep, or (0) each copied on this
    thread as it is taken."""
    if prefetch > 0:
        return prefetch_to_device(batches, device, size=prefetch, stats=stats)
    return (b.to(device) for b in batches)


def staged_nbytes(batches) -> int:
    """Bytes the batches occupy staged on a device (every tensor of every
    batch): the one count the device-resident fit check reads."""
    return sum(t.nbytes for b in batches for t in batch_tensors(b).values())


def device_hbm_budget(device=None) -> int | None:
    """Staging budget in bytes on ``device``: 80% of the card's free
    memory (``torch.cuda.mem_get_info``); None off a card (unknown)."""
    device = torch.device(device or "cuda")
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return int(free * _STAGE_FRACTION)


def check_device_resident_fit(staged_bytes: int, n_devices: int = 1,
                              log_fn: Callable = print,
                              device=None) -> bool:
    """True when ``staged_bytes`` fits the device-resident budget. False
    (with a LOUD explanation of the fall-back and the knobs that shrink
    staging): the caller keeps batches host-side and restages them each
    epoch (pack-once) instead of dying in an out-of-memory error
    mid-staging. An unknown budget (the CPU) passes."""
    budget = device_hbm_budget(device)
    if budget is None:
        return True
    per_device = staged_bytes / max(n_devices, 1)
    if per_device <= budget:
        return True
    name = torch.cuda.get_device_name(torch.device(device or "cuda"))
    log_fn(
        f"device-resident staging needs {per_device / 1e9:.1f} GB/device "
        f"but only ~{budget / 1e9:.1f} GB of HBM is budgeted for data "
        f"({_STAGE_FRACTION:.0%} of {name} free memory): FALLING BACK to "
        f"host-side pack-once staging (per-step H2D each epoch). To stage "
        f"on-device: --compact-staging (~12x smaller; single-device runs "
        f"today), more data-parallel devices, or a smaller dataset/batch "
        f"capacity.")
    return False


def _log_progress(host: dict, train: bool, epoch: int, it: int,
                  log_fn: Callable) -> None:
    count = max(host.get("count", 1.0), 1.0)
    parts = [f"{'Epoch' if train else 'Val'}: [{epoch}][{it}]",
             f"Loss {host.get('loss_sum', 0.0) / count:.4f}"]
    if "mae_sum" in host:
        parts.append(f"MAE {host['mae_sum'] / count:.4f}")
    if "correct_sum" in host:
        parts.append(f"Acc {host['correct_sum'] / count:.4f}")
    log_fn("  ".join(parts))


def edge_pack_fn(edge_dtype, pin: bool = False):
    """``pack_graphs`` with the edge storage type (and ``pin``), or None
    where the defaults do."""
    if edge_dtype == torch.float32 and not pin:
        return None
    return functools.partial(pack_graphs, pin=pin, edge_dtype=edge_dtype)


def save_preempted_mid_epoch(state, epoch: int, on_epoch_end,
                             log_fn: Callable) -> None:
    """Chunk-boundary preemption: the epoch is partial, so the CURRENT
    weights are saved under the last COMPLETED epoch, and a resume redoes
    this epoch instead of skipping its unseen tail."""
    log_fn(f"preemption: epoch {epoch} stopped at a chunk boundary; saving "
           f"resumable checkpoint (epoch {epoch - 1})")
    if on_epoch_end is not None:
        on_epoch_end(state, epoch - 1, {}, False)


def resilience_epoch_end(state, epoch: int, train_m: dict, val_m: dict,
                         is_best: bool, *, monitor, on_epoch_end, preempt,
                         log_fn: Callable):
    """The epoch-boundary protocol: the divergence check BEFORE the save
    (a diverged epoch never overwrites the last good checkpoint), the
    save, the injected SIGTERM, and the preemption poll -> (state,
    rolled_back, preempted)."""
    rolled_back = False
    if monitor is not None:
        state, rolled_back = monitor.observe(state, epoch, train_m)
    if on_epoch_end is not None and not rolled_back:
        on_epoch_end(state, epoch, val_m, is_best)
    faultinject.maybe_sigterm(epoch)
    preempted = preempt is not None and preempt.requested
    if preempted:
        if rolled_back:
            log_fn(f"preemption: stopping after epoch {epoch} — the epoch "
                   f"diverged and was not saved; resume restarts from the "
                   f"last good checkpoint")
        else:
            log_fn(f"preemption: stopping after epoch {epoch} (checkpoint "
                   f"saved at the epoch boundary)")
    return state, rolled_back, preempted


def settle_count(state, train_m: dict) -> None:
    """Set the optimizer's host count to its device count after an
    epoch: a replay raised the host mirror by one whatever its step did,
    and a step the guard skipped left the device count where it was, so
    the epoch's skips (its fetched ``guard_skipped`` sums) come off."""
    skipped = skipped_steps(train_m)
    if skipped:
        state.optimizer.advance(-skipped)


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


class PackOncePlan:
    """pack_once / device_resident epoch staging: pack every batch on the
    first epoch, reshuffle BATCH order (not graph membership) on later
    epochs from ``rng``, and with ``device_resident`` stage each batch on
    the device once (``stage``), so later epochs copy nothing."""

    def __init__(self, make_train_batches: Callable,
                 make_val_batches: Callable, rng: np.random.Generator,
                 device_resident: bool = False,
                 stage: Callable | None = None):
        self._make_train = make_train_batches
        self._make_val = make_val_batches
        self._rng = rng
        self._device_resident = device_resident
        self._stage = stage
        self._train: list | None = None
        self._val: list | None = None

    def epoch_iterators(self) -> tuple[Iterable, Iterable]:
        if self._train is None:
            self._train = list(self._make_train())
            self._val = list(self._make_val())
            if self._device_resident:
                self._train = [self._stage(b) for b in self._train]
                self._val = [self._stage(b) for b in self._val]
            # packing order first: the first epoch is then the per-epoch
            # packing path's with the same seed
            order = np.arange(len(self._train))
        else:
            order = self._rng.permutation(len(self._train))
        return (self._train[i] for i in order), iter(self._val)


class _Group:
    """One shape's staged batches: each field stacked on a leading axis
    on the device, this epoch's permutation and the cursor into it (both
    on the device, read and advanced inside the captured step), and
    their host mirrors."""

    def __init__(self, batches: list, device):
        self.n = len(batches)
        first = batches[0]
        self.stacked = dataclasses.replace(first, **{
            k: torch.stack([getattr(b, k) for b in batches]).to(device)
            for k in batch_tensors(first)})
        self.perm = torch.arange(self.n, dtype=torch.int64, device=device)
        self.cursor = torch.zeros((), dtype=torch.int64, device=device)
        self.host_perm = np.arange(self.n)
        self.host_cursor = 0

    def take(self):
        """The batch at ``perm[cursor]`` (copied out of the stacks), and
        the cursor advanced: device ops only, so a graph can hold them.
        The cursor is read modulo the group's size: a capture's warm-up
        runs may step past the end of a small group."""
        at = torch.remainder(self.cursor, self.n).view(1)
        idx = self.perm.index_select(0, at)
        self.cursor.add_(1)
        return dataclasses.replace(self.stacked, **{
            k: t.index_select(0, idx).squeeze(0)
            for k, t in batch_tensors(self.stacked).items()})

    def begin(self, perm: np.ndarray | None) -> None:
        """Start an epoch over ``perm`` (None: keep the current one)."""
        if perm is not None and not np.array_equal(perm, self.host_perm):
            self.host_perm = np.asarray(perm)
            self.perm.copy_(torch.from_numpy(
                np.ascontiguousarray(perm, dtype=np.int64)))
        self.cursor.zero_()
        self.host_cursor = 0


class ScanEpochDriver:
    """Whole-epoch driving of device-resident batches, the JAX
    ``ScanEpochDriver``'s schedule with one captured step graph per
    (shape, train|eval) in place of a ``lax.scan`` per (shape, chunk
    length) (module docstring).

    ``train_body(state, batch)`` / ``eval_body(state, batch)`` return a
    step's metric sums (``make_train_step``, with its expander where the
    batches are staged compactly).
    ``warm(state)`` captures every graph before the first epoch and
    leaves ``state`` as it was; unlike the JAX ``warm`` it draws nothing
    from ``rng``, so ``fit`` with the driver walks the JAX ``fit``'s step
    sequence. ``trace``, when a list, receives ``(shape key, batch
    indices)`` for every chunk run, from the host mirrors.

    ``preempt`` (a ``resilience.PreemptionHandler``) is polled before
    every chunk: an epoch can outlast a preemption's grace window, so on
    a request the epoch driver stops at that chunk boundary and sets
    ``aborted`` (``eval_truncated`` where the request landed during the
    eval epoch, whose means then cover only the chunks that ran)."""

    # mean steps a chunk and the mixed tail's cap: the JAX values
    chunk_steps = 2
    mixed_tail = 8

    def __init__(self, train_body: Callable, eval_body: Callable,
                 train_batches: list, val_batches: list,
                 rng: np.random.Generator, *, device,
                 chunk_steps: int | None = None, graphs: bool = True,
                 preempt=None):
        if chunk_steps is not None:
            if chunk_steps < 1:
                raise ValueError(
                    f"chunk_steps must be >= 1, got {chunk_steps}")
            self.chunk_steps = int(chunk_steps)
        self._rng = rng
        self.device = torch.device(device)
        self._capture = graphs
        self._preempt = preempt
        # set when a preemption request stopped the last drive call at a
        # chunk boundary (reset by each public drive call)
        self.aborted = False
        self.eval_truncated = False
        self.timings: dict[str, float] = {}
        t0 = time.perf_counter()
        self._train_groups = self._stack_groups(train_batches)
        self._val_groups = self._stack_groups(val_batches)
        self.timings["init_stack_stage_s"] = time.perf_counter() - t0
        self._train_body, self._eval_body = train_body, eval_body
        self.train_sums, self.eval_sums = DeviceSums(), DeviceSums()
        self.train_graphs = GraphCache(self._make_train_graph,
                                       label="train graph")
        self.eval_graphs = GraphCache(self._make_eval_graph,
                                      label="eval graph")
        self._state = None
        self._sched_cache: dict = {}
        self.trace: list | None = None

    def _stack_groups(self, batches: list) -> dict:
        """Group same-shape batches (first-seen order), stack and stage."""
        groups: dict = {}
        for b in batches:
            groups.setdefault(batch_shape_key(b), []).append(b)
        return {k: _Group(bs, self.device) for k, bs in groups.items()}

    def _cursors(self) -> list:
        return [g.cursor for g in (*self._train_groups.values(),
                                   *self._val_groups.values())]

    def _make_train_graph(self, key, state):
        grp, sums = self._train_groups[key], self.train_sums
        body = self._train_body
        return StepGraph(
            lambda: sums.add(body(state, grp.take())), device=self.device,
            kind="train", label=f"train graph {key}", capture=self._capture,
            guard=state_guard(state, self._cursors, [sums]),
            on_replay=lambda: state.optimizer.advance(1),
            generators=state_generators(state))

    def _make_eval_graph(self, key, state):
        grp, sums = self._val_groups[key], self.eval_sums
        body = self._eval_body
        return StepGraph(lambda: sums.add(body(state, grp.take())),
                         device=self.device, kind="eval",
                         label=f"eval graph {key}", capture=self._capture,
                         guard=tensor_guard(self._cursors, [sums]))

    def warm(self, state) -> None:
        """Capture every (shape, train|eval) graph (on CUDA; on the CPU
        nothing is captured) and declare the driver warm: a capture
        after this counts in ``captures_after_warm``."""
        self._state = state
        for key in self._train_groups:
            self.train_graphs.get(key, state)
        for key in self._val_groups:
            self.eval_graphs.get(key, state)
        for g in self._train_groups.values():
            g.begin(np.arange(g.n))
        for g in self._val_groups.values():
            g.begin(None)
        self.train_graphs.mark_warm()
        self.eval_graphs.mark_warm()

    def captures_after_warm(self) -> int:
        return (self.train_graphs.captures_after_warm
                + self.eval_graphs.captures_after_warm)

    def _tail_for(self, n: int) -> int:
        return min(self.mixed_tail, max(1, n // 4))

    def _build_sched(self, groups: dict, train: bool, first: bool):
        """(queues, tails, steps, pick_order, perms): the JAX
        ``_build_sched``, numpy for numpy and draw for draw (the chunks
        stay host index arrays; ``perms`` is each group's epoch order)."""
        c = self.chunk_steps
        queues, tails = [], []
        steps = 0
        pick_order: list[int] = []
        perms = {}
        multi = train and len(groups) > 1
        for key, grp in groups.items():
            n = grp.n
            tail = self._tail_for(n) if multi else 0
            perm = (np.arange(n) if (first or not train)
                    else self._rng.permutation(n))
            perms[key] = perm
            head, foot = perm[: n - tail], perm[n - tail:]
            if multi:
                chunks, i = [], 0
                sizes = [max(1, c // 2), c, 2 * c]
                while i < len(head):
                    rem = len(head) - i
                    avail = [s for s in sizes if s <= rem]
                    ln = int(self._rng.choice(avail)) if avail else rem
                    chunks.append(head[i: i + ln])
                    i += ln
            else:
                chunks = [head[i: i + c] for i in range(0, len(head), c)]
            if chunks:
                queues.append((key, grp, chunks))
            if len(foot):
                tails.append((key, grp, [foot[i: i + 1]
                                         for i in range(len(foot))]))
            steps += n
        if multi and not first:
            rem = [[len(ch) for ch in entry[2]] for entry in queues]
            alive = list(range(len(queues)))
            while alive:
                if len(alive) > 1:
                    w = np.array([float(sum(rem[i])) for i in alive])
                    gi = alive[int(self._rng.choice(len(alive),
                                                    p=w / w.sum()))]
                else:
                    gi = alive[0]
                pick_order.append(gi)
                rem[gi].pop(0)
                if not rem[gi]:
                    alive.remove(gi)
        return queues, tails, steps, pick_order, perms

    def _run_chunk(self, key, grp: _Group, length: int, train: bool) -> None:
        """``length`` steps of ``key``'s graph, reading ``grp``'s next
        ``length`` permuted batches."""
        if self.trace is not None:
            self.trace.append((key, grp.host_perm[
                grp.host_cursor: grp.host_cursor + length].copy()))
        graphs = self.train_graphs if train else self.eval_graphs
        graph = graphs.get(key, self._state)
        for _ in range(length):
            graph.run()
        grp.host_cursor += length

    def _drive(self, state, groups: dict, train: bool, first: bool,
               prebuild: bool = True) -> int:
        """Run one epoch of ``groups`` (the JAX ``_drive``'s schedule)
        -> steps run; the sums stay on the device."""
        self._state = state
        t0 = time.perf_counter()
        sched_key = (id(groups), train, first)
        if train:
            sched = self._sched_cache.pop(sched_key, None)
            if sched is None:
                sched = self._build_sched(groups, train, first)
        else:
            sched = self._sched_cache.get(sched_key)
            if sched is None:
                sched = self._build_sched(groups, train, first)
                self._sched_cache[sched_key] = sched
        queues, tails, _, pick_order, perms = sched
        for key, grp in groups.items():
            grp.begin(perms[key])
        (self.train_sums if train else self.eval_sums).zero()
        queues = [(k, g, collections.deque(ch)) for k, g, ch in queues]
        tails = [(k, g, collections.deque(ch)) for k, g, ch in tails]
        multi = train and len(groups) > 1
        executed = 0

        def run_queues(qs, weighted):
            nonlocal executed
            rr = 0
            picks = iter(pick_order)
            by_index = list(qs)  # pick_order indexes the build order
            while qs:
                if self._preempt is not None and self._preempt.requested:
                    # a chunk-boundary stop: the caller saves the
                    # mid-epoch state; the means divide by the steps run
                    self.aborted = True
                    return
                if weighted and pick_order:
                    entry = by_index[next(picks)]
                else:
                    entry = qs[rr % len(qs)]
                    rr += 1
                key, grp, chunks = entry
                chunk = chunks.popleft()
                self._run_chunk(key, grp, len(chunk), train)
                executed += len(chunk)
                if not chunks:
                    qs.remove(entry)

        t_sched = time.perf_counter()
        run_queues(queues, weighted=multi and not first)
        run_queues(tails, weighted=False)
        t_run = time.perf_counter()
        if train and prebuild and not self.aborted:
            self._sched_cache[(id(groups), True, False)] = \
                self._build_sched(groups, True, False)
        phase = "train" if train else "eval"
        tm = self.timings
        for name, dt in (("sched_s", t_sched - t0),
                         ("dispatch_s", t_run - t_sched),
                         ("prebuild_s", time.perf_counter() - t_run)):
            tm[f"{phase}_{name}"] = tm.get(f"{phase}_{name}", 0.0) + dt
        tm[f"{phase}_steps"] = tm.get(f"{phase}_steps", 0) + executed
        return executed

    def train_epoch(self, state, first: bool) -> dict:
        self.aborted = False
        steps = self._drive(state, self._train_groups, train=True,
                            first=first)
        return means_from_sums(fetch_device_sums(self.train_sums.sums),
                               steps)

    def eval_epoch(self, state) -> dict:
        self.aborted = False
        steps = self._drive(state, self._val_groups, train=False,
                            first=True)
        return means_from_sums(fetch_device_sums(self.eval_sums.sums),
                               steps)

    def run_epoch_pair(self, state, first: bool) -> tuple:
        """Train epoch + eval epoch with ONE fetch of both epochs' sums
        -> (state, train means, val means). A preempted train epoch
        skips the eval epoch (the grace window is for the checkpoint); a
        request during eval leaves the completed train epoch un-aborted
        and sets ``eval_truncated``."""
        self.aborted = self.eval_truncated = False
        tr_steps = self._drive(state, self._train_groups, train=True,
                               first=first)
        train_aborted = self.aborted
        ev_steps = 0
        if self._val_groups and not train_aborted:
            ev_steps = self._drive(state, self._val_groups, train=False,
                                   first=True)
            self.eval_truncated = self.aborted
            self.aborted = train_aborted
        combined = {f"t:{k}": v for k, v in self.train_sums.sums.items()}
        if ev_steps:
            combined |= {f"e:{k}": v for k, v in self.eval_sums.sums.items()}
        t0 = time.perf_counter()
        fetched = fetch_device_sums(combined or None)
        self.timings["pair_fetch_s"] = self.timings.get(
            "pair_fetch_s", 0.0) + (time.perf_counter() - t0)
        tr = {k[2:]: v for k, v in fetched.items() if k.startswith("t:")}
        ev = {k[2:]: v for k, v in fetched.items() if k.startswith("e:")}
        return state, means_from_sums(tr, tr_steps), means_from_sums(
            ev, ev_steps)


class StepRunner:
    """The per-step loop's steps: one ``StepGraph`` per batch shape, made
    at the shape's first batch (captured on CUDA unless ``graphs`` is
    False), each batch copied into its static inputs; sums accumulate in
    ``sums``."""

    def __init__(self, step: Callable, state, device, *, train: bool,
                 graphs: bool = True, log_fn: Callable | None = None):
        self.state = state
        self.sums = DeviceSums()
        self.train = train
        self._step = step
        self._graphs = graphs
        self.device = device
        self.cache = GraphCache(self._make, log_fn=log_fn,
                                label="train graph" if train
                                else "eval graph")

    def _make(self, key, batch):
        state, sums, step = self.state, self.sums, self._step
        guard = (state_guard(state, sums=[sums]) if self.train
                 else tensor_guard(sums=[sums]))
        return StepGraph(lambda b: sums.add(step(state, b)), batch,
                         device=self.device,
                         kind="train" if self.train else "eval",
                         label=f"{self.cache.label} {key}", guard=guard,
                         capture=self._graphs,
                         on_replay=(lambda: state.optimizer.advance(1))
                         if self.train else None,
                         generators=state_generators(state)
                         if self.train else ())

    def __call__(self, batch) -> None:
        self.cache.run(batch_shape_key(batch), batch)

    def epoch(self, batches: Iterable, *, print_freq: int = 0,
              epoch: int = 0, log_fn: Callable = print) -> dict:
        """One epoch over ``batches`` -> metric means (one fetch)."""
        self.sums.zero()
        steps = 0
        for it, batch in enumerate(batches):
            self(batch)
            steps += 1
            if print_freq and it % print_freq == 0:
                _log_progress(fetch_device_sums(self.sums.sums), self.train,
                              epoch, it, log_fn)
        return means_from_sums(fetch_device_sums(self.sums.sums), steps)


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
    buckets: int = 1,
    pack_once: bool = False,
    device_resident: bool = False,
    scan_epochs: bool = False,
    chunk_steps: int | None = None,
    compact=None,
    graphs: bool = True,
    guard: bool = False,
    monitor=None,
    preempt=None,
    force_weights: tuple = (1.0, 10.0),
) -> tuple:
    """Train/validate epochs ``start_epoch`` .. ``epochs - 1``, tracking
    the best validation MAE (a classifier's highest accuracy).
    -> (state, {"best", "history": [per-epoch metrics], "staging" (the
    driver's: packed and staged bytes, compact or not, the fall-back),
    "graphs": {captures, replays, captures_after_warm}}, and
    "preempted": True when a preemption request stopped the run).

    ``dense_m`` 0 or None packs the flat COO layout. The capacities
    default to the snug ones of the training graphs (``batch_caps``);
    ``buckets > 1`` packs per size class (``bucketed_batch_iterator``).
    ``pack_once``, ``device_resident``, ``scan_epochs``, ``chunk_steps``,
    ``compact``, ``graphs``: module docstring; the JAX rules hold
    (``device_resident`` implies ``pack_once``, ``scan_epochs`` implies
    ``device_resident``; ``compact`` needs ``scan_epochs`` and the dense
    layout, else ValueError).

    As in the JAX loop, the data order's generator restarts from ``seed``
    at ``start_epoch`` and ``best`` from inf; ``on_epoch_end(state,
    epoch, val_metrics, is_best)`` runs after each epoch's validation.
    ``prefetch``: the loader's depth (``stage``; on a card the
    batches it copies are packed page-locked); ``loader_stats`` gathers
    its counters. The state's tensors must not be rebound while
    fit runs (the graphs hold their addresses): restore a checkpoint
    before calling it (a ``monitor``'s rollback restores in place).

    ``guard``, ``monitor``, ``preempt``: the module docstring's
    resilience; with none of them (and no fault plan) nothing changes.
    ``force_weights``: the force task's (w_energy, w_force)."""
    dense_m = dense_m or None
    device_resident = device_resident or scan_epochs
    pack_once = pack_once or device_resident
    if compact is not None and not scan_epochs:
        raise ValueError("compact staging requires scan_epochs (the "
                         "expander runs inside the scan body)")
    if compact is not None and dense_m is None:
        raise ValueError("compact staging requires the dense layout "
                         "(dense_m)")
    node_cap, edge_cap = batch_caps(train_graphs, batch_size, dense_m,
                                    node_cap, edge_cap)
    classification, edge_dtype = model_task(state.model)
    force = is_force(state.model)
    if compact is not None and force:
        raise ValueError("compact staging is refused for the force task "
                         "(train.py's rule): the model recomputes its "
                         "edges from the positions")
    pack_fn = expand = None
    if compact is not None:
        from cgnn_tpu_torch.data.compact import compact_pack_fn, make_expander

        if compact.edge_dtype != edge_dtype:
            raise ValueError(f"compact spec edge_dtype {compact.edge_dtype}"
                             f" != the model's {edge_dtype}")
        pack_fn = compact_pack_fn(compact)
        expand = make_expander(compact, device)
    else:
        # batches copied to the card as the epochs run: packed page-locked,
        # so the copies run asynchronously (data/loader.py)
        pack_fn = edge_pack_fn(edge_dtype, pin=torch.device(
            device).type == "cuda" and not scan_epochs)
    if force:
        train_step = make_force_train_step(*force_weights)
        eval_step = make_force_eval_step(*force_weights)
    else:
        train_step = make_train_step(expander=expand,
                                     classification=classification)
        eval_step = make_eval_step(expander=expand,
                                   classification=classification)
    if guard:
        train_step = guard_step(train_step)
    # validation batches carry the gathers' transpose where the eval step
    # takes a gradient (the forces), so its sums run in a fixed order too
    val_in_cap = None if force else 0

    def train_batches(rng):
        if buckets > 1:
            it = bucketed_batch_iterator(
                train_graphs, batch_size, buckets, shuffle=True, rng=rng,
                dense_m=dense_m, pack_fn=pack_fn)
        else:
            it = batch_iterator(train_graphs, batch_size, node_cap, edge_cap,
                                shuffle=True, rng=rng, dense_m=dense_m,
                                snug=True, pack_fn=pack_fn)
        # the fault plan's NaN batch and loader failure, before pack-once
        # or device-resident staging takes the batches (unwrapped when no
        # plan is active)
        return faultinject.poison_batches(it)

    def val_batches():
        if buckets > 1:
            return bucketed_batch_iterator(val_graphs, batch_size, buckets,
                                           dense_m=dense_m,
                                           in_cap=val_in_cap,
                                           pack_fn=pack_fn)
        return batch_iterator(val_graphs, batch_size, node_cap, edge_cap,
                              dense_m=dense_m, in_cap=val_in_cap, snug=True,
                              pack_fn=pack_fn)

    rng = np.random.default_rng(seed)
    driver = None
    staging: dict = {}
    packed_lists = None
    if scan_epochs:
        if print_freq:
            log_fn("scan_epochs: per-step prints are unavailable inside "
                   "the epoch driver (epoch-level metrics only)")
        t0 = time.perf_counter()
        train_list = list(train_batches(rng))
        val_list = list(val_batches())
        staging["pack_s"] = time.perf_counter() - t0
        staged = staged_nbytes(train_list + val_list)
        staging.update(staged_bytes=staged, compact=compact is not None)
        if check_device_resident_fit(staged, log_fn=log_fn, device=device):
            t0 = time.perf_counter()
            driver = ScanEpochDriver(
                train_step, eval_step, train_list, val_list, rng,
                device=device, chunk_steps=chunk_steps, graphs=graphs,
                preempt=preempt)
            del train_list, val_list
            staging["stage_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            driver.warm(state)
            staging["capture_s"] = time.perf_counter() - t0
        else:
            staging["fallback"] = "host_pack_once"
            scan_epochs = device_resident = False
            packed_lists = (train_list, val_list)
    plan = None
    if pack_once and driver is None:
        plan = PackOncePlan(
            (lambda: packed_lists[0]) if packed_lists is not None
            else (lambda: train_batches(rng)),
            (lambda: packed_lists[1]) if packed_lists is not None
            else val_batches,
            rng, device_resident=device_resident,
            stage=lambda b: b.to(device))
    train_run = StepRunner(train_step, state, device, train=True,
                           graphs=graphs, log_fn=log_fn)
    eval_run = StepRunner(eval_step, state, device, train=False,
                          graphs=graphs, log_fn=log_fn)
    best_key = ("force_mae" if force
                else "correct" if classification else "mae")
    best = -np.inf if classification else np.inf
    history = []
    preempted = False
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        truncated = False
        if driver is not None:
            state, train_m, val_m = driver.run_epoch_pair(
                state, first=epoch == start_epoch)
            settle_count(state, train_m)
            if driver.aborted:
                save_preempted_mid_epoch(state, epoch, on_epoch_end, log_fn)
                preempted = True
                break
            truncated = driver.eval_truncated
        else:
            if plan is not None:
                epoch_train, epoch_val = plan.epoch_iterators()
            else:
                epoch_train, epoch_val = train_batches(rng), val_batches()
            if not device_resident:
                epoch_train = stage(epoch_train, device, prefetch,
                                    loader_stats)
                epoch_val = stage(epoch_val, device, prefetch, loader_stats)
            train_m = train_run.epoch(epoch_train, print_freq=print_freq,
                                      epoch=epoch, log_fn=log_fn)
            val_m = eval_run.epoch(epoch_val, epoch=epoch, log_fn=log_fn)
            settle_count(state, train_m)
            if epoch == start_epoch:
                train_run.cache.mark_warm()
                eval_run.cache.mark_warm()
        metric = val_m.get(best_key, np.nan)
        # a preemption that cut eval short leaves a partial score: it
        # never repoints the best
        is_best = (metric > best if classification
                   else metric < best) and not truncated
        if is_best:
            best = metric
        history.append({"epoch": epoch, "train": train_m, "val": val_m,
                        "seconds": time.perf_counter() - t0})
        log_fn(f"Epoch {epoch}: train loss {train_m.get('loss', np.nan):.4f}"
               f"  val {best_key} {metric:.4f}{' *' if is_best else ''}"
               f"  ({time.perf_counter() - t0:.1f}s)")
        state, _, preempted = resilience_epoch_end(
            state, epoch, train_m, val_m, is_best, monitor=monitor,
            on_epoch_end=on_epoch_end, preempt=preempt, log_fn=log_fn)
        if preempted:
            break
    caches = ([driver.train_graphs, driver.eval_graphs] if driver is not None
              else [train_run.cache, eval_run.cache])
    out = {"best": best, "best_key": best_key, "history": history,
           "graphs": {
        "captures": sum(c.captures() for c in caches),
        "replays": sum(c.replays() for c in caches),
        "captures_after_warm": sum(c.captures_after_warm for c in caches)}}
    if preempted:
        out["preempted"] = True
    if staging:
        if driver is not None:
            staging["timings"] = dict(driver.timings)
        out["staging"] = staging
    return state, out


def evaluate(state, graphs: Sequence[CrystalGraph], batch_size: int,
             node_cap: int, dense_m: int | None, device,
             edge_cap: int | None = None,
             force_weights: tuple = (1.0, 10.0)) -> dict:
    """Metric means of the eval step over ``graphs`` (capacities as in
    ``fit``; the task and edge dtype the model's; ``force_weights`` the
    force task's loss weights), stepped eagerly."""
    dense_m = dense_m or None
    node_cap, edge_cap = batch_caps(graphs, batch_size, dense_m, node_cap,
                                    edge_cap)
    classification, edge_dtype = model_task(state.model)
    force = is_force(state.model)
    step = (make_force_eval_step(*force_weights) if force
            else make_eval_step(classification=classification))
    return StepRunner(step, state, device, train=False, graphs=False).epoch(
        stage(batch_iterator(graphs, batch_size, node_cap, edge_cap,
                             dense_m=dense_m, in_cap=None if force else 0,
                             snug=True, pack_fn=edge_pack_fn(edge_dtype)),
              device))
