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

Packing (``packing``): ``'snug'`` fill-to-capacity batches, or
``'ladder'``, the JAX package's headroom/ladder capacities
(``capacities_for(snug=False)``) with batches closed at ``batch_size``
graphs. ``fit`` counts the training batches' padding (``PaddingStats``)
and logs its summary at the first epoch, as the JAX loop does. Under
``--check-invariants`` (``data.invariants.enable``) the iterators check
each batch they pack, and the epoch driver checks every train
(``train=True``) and validation batch again before it stages them, on
the host copies.

Data parallel (the JAX multi-process contract, parallel/
data_parallel.py): under a live process group (``dist.active()``)
``fit`` trains on this rank's shards. The per-step loop runs
``SplitStepRunner``, whose train step is two graphs around the
collective; each epoch's lists are cut or padded to the step count every
rank runs (``parallel_batches``). Pack-once, device-resident staging and
the epoch driver run too, on one host (the JAX single-process mesh's
counterpart): every batch is packed once and the lists are brought to
the same shape groups with the same sizes on every rank
(``agree_batches``: a training shape cut to the least count, a
validation shape padded to the largest), and the generator takes process
0's state, so every rank draws one schedule (its digest is held across
the ranks each epoch: a diverged schedule fails loudly instead of
hanging). The driver's train step is then graph A a shape
(``step.grad_part`` on the stacked batch), the collective on the host
and one graph B (``step.apply_part``, which adds the summed sums). The
staging check is agreed (``agreed_resident_fit``: ranks that share a card
count each other's bytes), and its fall-back to host pack-once is taken
by every rank or none. In every form the eval sums are reduced once an
epoch, the state is replicated from rank 0 first and held to its bits
after every epoch (``check_replicated``), and the preemption request is
agreed across the ranks (the driver polls it between chunks). The force
task takes the same paths with its own grad part. Compact staging is not
data-parallel (ValueError, as the JAX package refuses it). ``fit_on``
names the graphs the shapes are fitted on (the whole split, where a rank
packs its shard): the capacities, size classes and transpose overflow
then mean the same on every rank.

Graph sharding (parallel/edge_parallel.py; the model's ``graph_group``,
models/cgcnn.py): under a live process group whose model shards its
edge work over a graph group of G ranks, every batch is packed as the
JAX ``fit_data_parallel`` packs it (dense: ``node_cap`` rounded
up to a multiple of 8·G, ``edge_cap = node_cap·M`` and the training
batches' mappings per shard; COO: ``edge_cap`` rounded up to a multiple
of G), each rank takes its view (``rank_view``) after the step counts
and the checks (the driver and pack-once stage only that view: about
1/G of the edge bytes, as the JAX ``shard_scan_stack_2d`` splits the edge
leaves over ``graph``), and the steps average and sum over the data
group only. A sharded step has collectives inside its forward and
backward, so under gloo it runs eagerly: no captured graph (``captures``
0); capture under NCCL is a later candidate. The epoch log carries the
JAX tag, ``[dp xD * graph xG]``.

Telemetry (``telemetry``, an ``observe.Telemetry``; the JAX ``fit``'s):
at ``step`` level the train step computes the grad-health metrics in its
graph and every train and eval step taps its scalar sums into the step
stream's device ring (observe/stream.py; the driver marks each chunk's
end, the per-step loop each step); spans ``pack``, ``stage_scan_stacks``,
``epoch`` and ``eval``; the counters ``scan_steps``,
``scan_{train,eval}_dispatches``, ``per_step_steps``, ``data_wait_s``
and the loader's; the epoch gauges and ``epoch_time_s``. With the driver
the epoch pair's sums are fetched on a thread (``PendingPairMetrics``),
and with no checkpoint hook, divergence monitor, preemption handler or
process group a pair's bookkeeping runs one epoch late, while the next
epoch's steps run; the means, schedules and trajectory are the
synchronous path's, bit for bit.

Profiling (``profile_steps``, ``profile_dir``; train's ``--profile N``):
the per-step loop traces steps [1, 1 + N) of the first epoch in a
``torch.profiler`` session (``profile_wrap``; step 0 captures the
shape's graph), written under ``profile_dir``; the epoch driver has no
steps to wrap, so under ``scan_epochs`` the request is logged and
nothing is traced, as in the JAX loop.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import socket
import threading
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from cgnn_tpu_torch.data import invariants
from cgnn_tpu_torch.data.graph import (
    CrystalGraph,
    GraphBatch,
    PaddingStats,
    batch_iterator,
    batch_shape_key,
    bucketed_batch_iterator,
    capacities_for,
    graph_cap_for,
    overflow_cap,
    pack_graphs,
)
from cgnn_tpu_torch.data.loader import LoaderStats, prefetch_to_device
from cgnn_tpu_torch.observe.metrics_io import profile_trace
from cgnn_tpu_torch.observe.telemetry import Telemetry
from cgnn_tpu_torch.parallel import dist
from cgnn_tpu_torch.parallel.data_parallel import (
    AgreedPreemption,
    agree_batches,
    check_agreed,
    check_replicated,
    make_parallel_train_step,
    parallel_batches,
    replicate_state,
    sum_reducer_for_sums,
    sync_rng,
)
from cgnn_tpu_torch.parallel.edge_parallel import edge_nbytes, rank_view
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
    snapshot_device_sums,
)
from cgnn_tpu_torch.train.force_step import (
    make_force_eval_step,
    make_force_grad_step,
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
          stats: LoaderStats | None = None,
          telemetry: Telemetry | None = None) -> Iterable[GraphBatch]:
    """Host batches -> the same batches on ``device``, in order: through
    the prefetch loader ``prefetch`` deep (its counters also into
    ``telemetry``), or (0) each copied on this thread as it is taken."""
    if prefetch > 0:
        return prefetch_to_device(batches, device, size=prefetch, stats=stats,
                                  telemetry=telemetry)
    return (b.to(device) for b in batches)


def profile_wrap(iterator, profile_steps: int, profile_dir: str,
                 log_fn: Callable = print):
    """Trace steps [1, 1 + profile_steps) of ``iterator`` in a profiler
    session (observe/metrics_io.py ``profile_trace``; step 0 captures the
    step's graph, which would swamp the timeline). The session starts
    before step 1's batch is handed out and stops when the step after
    the window asks for its batch, after the card drains."""
    if not profile_steps:
        yield from iterator
        return
    window = None
    try:
        for i, b in enumerate(iterator):
            if i == 1:
                window = profile_trace(profile_dir or "profile")
                window.__enter__()
            yield b
            if window is not None and i >= profile_steps:
                window.__exit__(None, None, None)
                window = None
                log_fn(f"profiler trace written to {profile_dir}")
    finally:
        if window is not None:
            window.__exit__(None, None, None)


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


def agreed_resident_fit(staged_bytes: int, device,
                        log_fn: Callable = print) -> bool:
    """``check_device_resident_fit`` agreed by the ranks of a process
    group (every rank gets the same answer): the ranks that share a card
    (one host, one device) count their staged bytes together against
    the least budget any of them sees (each sees the others'
    allocations in its free memory), and when any card is short every
    rank falls back to host pack-once staging, LOUDLY."""
    device = torch.device(device)
    card = str(device)
    if device.type == "cuda" and device.index is None:
        card = f"cuda:{torch.cuda.current_device()}"
    records = dist.all_gather_object((socket.gethostname(), card,
                                      int(staged_bytes),
                                      device_hbm_budget(device)))
    cards: dict = {}
    for host, name, need, budget in records:
        c = cards.setdefault((host, name), [0, None])
        c[0] += need
        if budget is not None:
            c[1] = budget if c[1] is None else min(c[1], budget)
    short = {k: c for k, c in cards.items()
             if c[1] is not None and c[0] > c[1]}
    if not short:
        return True
    where = "; ".join(f"{host} {name}: {need / 1e9:.3f} GB staged by its "
                      f"ranks, ~{budget / 1e9:.3f} GB budgeted"
                      for (host, name), (need, budget) in short.items())
    log_fn(f"device-resident staging does not fit ({where}; "
           f"{_STAGE_FRACTION:.0%} of the free memory): FALLING BACK to "
           f"host-side pack-once staging on every rank (per-step H2D each "
           f"epoch). To stage on-device: more data-parallel devices, "
           f"--graph-shards, or a smaller dataset/batch capacity.")
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


def sharded_caps(node_cap: int, edge_cap: int, dense_m: int | None,
                 graph_shards: int) -> tuple[int, int]:
    """(node_cap, edge_cap) rounded for ``graph_shards``-way graph
    sharding, as the JAX ``fit_data_parallel`` rounds them: dense, the
    node capacity up to a multiple of 8·G (each strip whole and
    8-aligned) and the edge capacity ``node_cap * M``; COO, the edge
    capacity up to a multiple of G."""
    if graph_shards <= 1:
        return node_cap, edge_cap
    if dense_m:
        mult = 8 * graph_shards
        node_cap = -(-node_cap // mult) * mult
        return node_cap, node_cap * dense_m
    return node_cap, -(-edge_cap // graph_shards) * graph_shards


def counted_edge_bytes(batches: Iterable, counter: list) -> Iterable:
    """``batches`` as they are, ``edge_nbytes`` of each added into
    ``counter[0]`` as it passes."""
    for b in batches:
        counter[0] += edge_nbytes(b)
        yield b


def batch_caps(graphs: Sequence[CrystalGraph], batch_size: int,
               dense_m: int | None, node_cap: int | None = None,
               edge_cap: int | None = None, snug: bool = True,
               headroom: float = 1.15) -> tuple[int, int]:
    """(node_cap, edge_cap) of the batches: the given ones, the rest
    ``capacities_for(graphs, batch_size, headroom, snug=snug)``. Dense
    (``dense_m`` > 0): the edge capacity is ``node_cap * dense_m``; COO
    (0 or None): its own."""
    if dense_m:
        if node_cap is None:
            node_cap, _ = capacities_for(graphs, batch_size, headroom,
                                         dense_m=dense_m, snug=snug)
        return node_cap, node_cap * dense_m
    if node_cap is None or edge_cap is None:
        cap_n, cap_e = capacities_for(graphs, batch_size, headroom,
                                      snug=snug)
        node_cap = cap_n if node_cap is None else node_cap
        edge_cap = cap_e if edge_cap is None else edge_cap
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


class PendingPairMetrics:
    """An epoch pair's sums fetch running on a background thread (the
    JAX class): ``result()`` joins the thread and returns ``(train
    means, val means)``, the values the synchronous fetch gives, bit for
    bit; an exception of the fetch re-raises at the join. ``done_at``:
    the ``time.perf_counter()`` at which the sums reached the host (the
    card had finished the pair)."""

    def __init__(self, fn: Callable):
        self._fn = fn
        self._out = None
        self._err: BaseException | None = None
        self.done_at: float | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cgnn-pair-fetch")
        self._thread.start()

    def _run(self) -> None:
        try:
            self._out = self._fn()
        except BaseException as e:  # noqa: BLE001 — re-raised at result()
            self._err = e
        self.done_at = time.perf_counter()

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self):
        self._thread.join()
        if self._err is not None:
            raise self._err
        return self._out


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

    Under ``--check-invariants`` every input batch is checked before it
    is staged (``timings["check_s"]``).

    ``preempt`` (a ``resilience.PreemptionHandler``) is polled before
    every chunk: an epoch can outlast a preemption's grace window, so on
    a request the epoch driver stops at that chunk boundary and sets
    ``aborted`` (``eval_truncated`` where the request landed during the
    eval epoch, whose means then cover only the chunks that ran).

    ``split_step`` (a ``ParallelTrainStep``) makes it the data-parallel
    driver (module docstring): a train step is graph A a shape
    (``grad_part``), the collective, then graph B (``apply_part``); the
    eval sums are reduced over the data group once an epoch, each
    epoch's schedule digest is held across the ranks
    (``check_agreed``), and the batches come checked and agreed
    (``agree_batches``; ``key_order``: the agreed (train, val) key
    orders, so every rank's groups are in one order); ``apply_fn(state,
    None)`` is graph B's body (default ``split_step.apply_part``).

    ``telemetry`` (the module docstring's): its step stream is marked at
    each chunk's end and sized above the longest chunk, and the drive
    counts ``scan_steps`` and ``scan_{train,eval}_dispatches``."""

    # mean steps a chunk and the mixed tail's cap: the JAX values
    chunk_steps = 2
    mixed_tail = 8

    def __init__(self, train_body: Callable, eval_body: Callable,
                 train_batches: list, val_batches: list,
                 rng: np.random.Generator, *, device,
                 chunk_steps: int | None = None, graphs: bool = True,
                 preempt=None, split_step=None,
                 key_order: tuple = (None, None),
                 telemetry: Telemetry | None = None,
                 apply_fn: Callable | None = None):
        if chunk_steps is not None:
            if chunk_steps < 1:
                raise ValueError(
                    f"chunk_steps must be >= 1, got {chunk_steps}")
            self.chunk_steps = int(chunk_steps)
        self._telemetry = telemetry or Telemetry.disabled()
        self._stream = self._telemetry.stream
        if self._stream is not None:
            self._stream.reserve(2 * self.chunk_steps)
        self._rng = rng
        self.device = torch.device(device)
        self._capture = graphs
        self._preempt = preempt
        # set when a preemption request stopped the last drive call at a
        # chunk boundary (reset by each public drive call)
        self.aborted = False
        self.eval_truncated = False
        self.timings: dict[str, float] = {}
        # the driver trusts these batches for a whole run: each is checked
        # before it is staged (the host copies; --check-invariants)
        t0 = time.perf_counter()
        # a data-parallel caller checked its batches as the ranks agreed
        # them, before each rank took its view (agree_batches)
        checked = split_step is not None
        for b in () if checked else train_batches:
            invariants.maybe_check_any(b, train=True)
        for b in () if checked else val_batches:
            invariants.maybe_check_any(b)
        self.timings["check_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._train_groups = self._stack_groups(train_batches, key_order[0])
        self._val_groups = self._stack_groups(val_batches, key_order[1])
        groups = (self._train_groups, self._val_groups)
        # every group's cursor, for the graphs' guards: a closure over the
        # groups, not the driver, so no graph holds the driver (a cycle)
        self._cursors = lambda: [g.cursor for d in groups
                                 for g in d.values()]
        self.timings["init_stack_stage_s"] = time.perf_counter() - t0
        self._train_body, self._eval_body = train_body, eval_body
        self._split = split_step
        self._apply_fn = apply_fn or (
            None if split_step is None
            else lambda st, _: split_step.apply_part(st))
        self._reduce_eval = (sum_reducer_for_sums() if split_step is not None
                             else None)
        # the data-parallel step's graph B (one for every shape)
        self.apply_graph: StepGraph | None = None
        self.train_sums, self.eval_sums = DeviceSums(), DeviceSums()
        self.train_graphs = GraphCache(self._make_train_graph,
                                       label="train graph")
        self.eval_graphs = GraphCache(self._make_eval_graph,
                                      label="eval graph")
        self._state = None
        self._sched_cache: dict = {}
        self.trace: list | None = None

    def _stack_groups(self, batches: list, order=None) -> dict:
        """Group same-shape batches (in ``order``, the keys' agreed
        order, else first-seen order), stack and stage."""
        groups: dict = {}
        for b in batches:
            groups.setdefault(batch_shape_key(b), []).append(b)
        order = list(groups) if order is None else order
        return {k: _Group(groups[k], self.device) for k in order
                if k in groups}

    def _make_train_graph(self, key, state):
        grp, sums = self._train_groups[key], self.train_sums
        body, split = self._train_body, self._split
        if split is not None:
            # graph A: the forward and backward into the bucket
            return StepGraph(
                lambda: split.grad_part(state, grp.take()),
                device=self.device, kind="train", label=f"train graph {key}",
                capture=self._capture,
                guard=state_guard(state, self._cursors),
                generators=state_generators(state))
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

    def _apply(self, state) -> StepGraph:
        """The data-parallel step's graph B, made at its first use (after
        a graph A laid the bucket out): the averaged update, the guard's
        select and the summed sums into ``train_sums``. Its warm-up and
        capture overwrite the bucket, so its guard restores the bucket
        with the state (``SplitStepRunner``'s)."""
        if self.apply_graph is None:
            split, sums, apply_fn = self._split, self.train_sums, self._apply_fn
            self.apply_graph = StepGraph(
                lambda: sums.add(apply_fn(state, None)),
                device=self.device, kind="train_apply",
                label="train apply graph", capture=self._capture,
                guard=state_guard(state, lambda: [split.bucket], [sums]),
                on_replay=lambda: state.optimizer.advance(1))
        return self.apply_graph

    def warm(self, state) -> None:
        """Capture every (shape, train|eval) graph (on CUDA; on the CPU
        nothing is captured), and the data-parallel graph B, and declare
        the driver warm: a capture after this counts in
        ``captures_after_warm``."""
        self._state = state
        for key in self._train_groups:
            self.train_graphs.get(key, state)
        if self._split is not None and self._split.bucket is not None:
            self._apply(state)
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
        if train and self._split is not None:
            # graph A, the collective on the host, graph B
            for _ in range(length):
                graph.run()
                self._split.reduce()
                self._apply(self._state).run()
        else:
            for _ in range(length):
                graph.run()
        grp.host_cursor += length
        if self._stream is not None:
            self._stream.mark("train" if train else "eval", self.device)

    def _drive(self, state, groups: dict, train: bool, first: bool) -> int:
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
        if self._split is not None:
            check_agreed(sched_digest(sched),
                         f"{'train' if train else 'eval'} schedule")
        for key, grp in groups.items():
            grp.begin(perms[key])
        (self.train_sums if train else self.eval_sums).zero()
        phase = "train" if train else "eval"
        if self._stream is not None:
            self._stream.mark(phase, self.device, start=True)
        queues = [(k, g, collections.deque(ch)) for k, g, ch in queues]
        tails = [(k, g, collections.deque(ch)) for k, g, ch in tails]
        multi = train and len(groups) > 1
        executed = n_chunks = 0

        def run_queues(qs, weighted):
            nonlocal executed, n_chunks
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
                n_chunks += 1
                if not chunks:
                    qs.remove(entry)

        t_sched = time.perf_counter()
        run_queues(queues, weighted=multi and not first)
        run_queues(tails, weighted=False)
        t_run = time.perf_counter()
        tm = self.timings
        for name, dt in (("sched_s", t_sched - t0),
                         ("dispatch_s", t_run - t_sched)):
            tm[f"{phase}_{name}"] = tm.get(f"{phase}_{name}", 0.0) + dt
        tm[f"{phase}_steps"] = tm.get(f"{phase}_steps", 0) + executed
        self._telemetry.counter_add("scan_steps", executed)
        self._telemetry.counter_add(f"scan_{phase}_dispatches", n_chunks)
        return executed

    def _prebuild(self) -> None:
        """The next train epoch's schedule, built while the card runs
        this one (its draws are the next epoch's, in order)."""
        t0 = time.perf_counter()
        self._sched_cache[(id(self._train_groups), True, False)] = \
            self._build_sched(self._train_groups, True, False)
        self.timings["train_prebuild_s"] = self.timings.get(
            "train_prebuild_s", 0.0) + (time.perf_counter() - t0)

    def train_epoch(self, state, first: bool) -> dict:
        self.aborted = False
        steps = self._drive(state, self._train_groups, train=True,
                            first=first)
        if not self.aborted:
            self._prebuild()
        return means_from_sums(fetch_device_sums(self.train_sums.sums),
                               steps)

    def eval_epoch(self, state) -> dict:
        self.aborted = False
        steps = self._drive(state, self._val_groups, train=False,
                            first=True)
        if self._reduce_eval is not None and steps:
            self._reduce_eval(self.eval_sums.sums)
        return means_from_sums(fetch_device_sums(self.eval_sums.sums),
                               steps)

    def run_epoch_pair(self, state, first: bool,
                       async_fetch: bool = False) -> tuple:
        """Train epoch + eval epoch with ONE fetch of both epochs' sums
        -> (state, train means, val means). A preempted train epoch
        skips the eval epoch (the grace window is for the checkpoint); a
        request during eval leaves the completed train epoch un-aborted
        and sets ``eval_truncated``.

        The sums are copied on the device at once, into a fresh tensor
        (the next epoch zeroes the accumulators in place), then to
        page-locked memory without blocking, and the next train epoch's
        schedule is built while the copy runs (eval draws nothing, so
        the rng draws keep the per-epoch order). ``async_fetch=True``
        returns ``(state, PendingPairMetrics)``, whose thread waits for
        the copy while the caller goes on: schedules, trajectory and
        means are the synchronous return's, bit for bit."""
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
        if self._reduce_eval is not None and ev_steps:
            # once an epoch, over the data group (the ranks stop their
            # eval at the same chunk, so the sums cover the same steps)
            self._reduce_eval(self.eval_sums.sums)
        combined = {f"t:{k}": v for k, v in self.train_sums.sums.items()}
        if ev_steps:
            combined |= {f"e:{k}": v for k, v in self.eval_sums.sums.items()}
        fetch = snapshot_device_sums(combined)

        def fetch_pair():
            t0 = time.perf_counter()
            fetched = fetch()
            self.timings["pair_fetch_s"] = self.timings.get(
                "pair_fetch_s", 0.0) + (time.perf_counter() - t0)
            tr = {k[2:]: v for k, v in fetched.items() if k.startswith("t:")}
            ev = {k[2:]: v for k, v in fetched.items() if k.startswith("e:")}
            return means_from_sums(tr, tr_steps), means_from_sums(ev,
                                                                  ev_steps)

        pending = PendingPairMetrics(fetch_pair) if async_fetch else None
        if not train_aborted:
            self._prebuild()
        if pending is None:
            return (state, *fetch_pair())
        return state, pending


def sched_digest(sched) -> str:
    """sha256 of an epoch schedule (``ScanEpochDriver._build_sched``'s):
    each queue's and tail's shape key and chunks, in order, and the
    weighted pick order: what every rank of a data-parallel driver must
    draw alike."""
    queues, tails, steps, pick_order, _ = sched
    h = hashlib.sha256(f"{steps}:{pick_order}".encode())
    for key, _, chunks in queues + tails:
        h.update(repr(key).encode())
        for ch in chunks:
            h.update(np.asarray(ch, np.int64).tobytes() + b"|")
    return h.hexdigest()


class StepRunner:
    """The per-step loop's steps: one ``StepGraph`` per batch shape, made
    at the shape's first batch (captured on CUDA unless ``graphs`` is
    False), each batch copied into its static inputs; sums accumulate in
    ``sums``. ``apply`` is a split step's second graph
    (``SplitStepRunner``). ``telemetry``: its step stream is marked after
    each step, and an epoch counts ``per_step_steps`` and
    ``data_wait_s`` (the time blocked on the next batch)."""

    def __init__(self, step: Callable, state, device, *, train: bool,
                 graphs: bool = True, log_fn: Callable | None = None,
                 telemetry: Telemetry | None = None):
        self.apply: StepGraph | None = None
        self.state = state
        self.sums = DeviceSums()
        self.train = train
        self._step = step
        self._graphs = graphs
        self.device = device
        self._telemetry = telemetry or Telemetry.disabled()
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
              epoch: int = 0, log_fn: Callable = print,
              reduce: Callable | None = None) -> dict:
        """One epoch over ``batches`` -> metric means (one fetch).
        ``reduce(sums)``, where given, combines the epoch's device sums
        across ranks in place before the fetch (the data-parallel eval)."""
        stream = self._telemetry.stream
        phase = "train" if self.train else "eval"
        self.sums.zero()
        if stream is not None:
            stream.mark(phase, self.device, start=True)
        steps = 0
        wait = 0.0
        it = iter(batches)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            wait += time.perf_counter() - t0
            if batch is None:
                break
            self(batch)
            if stream is not None:
                stream.mark(phase, self.device)
            if print_freq and steps % print_freq == 0:
                _log_progress(fetch_device_sums(self.sums.sums), self.train,
                              epoch, steps, log_fn)
            steps += 1
        if reduce is not None:
            reduce(self.sums.sums)
        self._telemetry.counter_add("per_step_steps", steps)
        self._telemetry.counter_add("data_wait_s", wait)
        return means_from_sums(fetch_device_sums(self.sums.sums), steps)


class SplitStepRunner(StepRunner):
    """The per-step loop's data-parallel train steps: graph A
    (``step.grad_part``) a batch shape, the collective (``step.reduce``)
    on the host, then graph B (``apply_fn(state, None)``, default
    ``step.apply_part``), one for every shape, captured at the first
    step (train/graphs.py; ``step`` a
    ``parallel.data_parallel.ParallelTrainStep``). Graph B's warm-up run
    and capture overwrite the bucket, so its guard restores the bucket
    with the state."""

    def __init__(self, step, state, device, *, graphs: bool = True,
                 log_fn: Callable | None = None,
                 telemetry: Telemetry | None = None,
                 apply_fn: Callable | None = None):
        super().__init__(step, state, device, train=True, graphs=graphs,
                         log_fn=log_fn, telemetry=telemetry)
        self._apply_fn = apply_fn or (lambda st, _: step.apply_part(st))

    def _make(self, key, batch):
        state, step = self.state, self._step
        return StepGraph(lambda b: step.grad_part(state, b), batch,
                         device=self.device, kind="train",
                         label=f"{self.cache.label} {key}",
                         guard=state_guard(state), capture=self._graphs,
                         generators=state_generators(state))

    def _make_apply(self) -> StepGraph:
        state, step, sums = self.state, self._step, self.sums
        apply_fn = self._apply_fn
        return StepGraph(lambda: sums.add(apply_fn(state, None)),
                         device=self.device, kind="train_apply",
                         label="train apply graph",
                         guard=state_guard(state, lambda: [step.bucket],
                                           [sums]),
                         capture=self._graphs,
                         on_replay=lambda: state.optimizer.advance(1))

    def __call__(self, batch) -> None:
        self.cache.run(batch_shape_key(batch), batch)
        self._step.reduce()
        if self.apply is None:
            self.apply = self._make_apply()
        self.apply.run()


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
    packing: str = "snug",
    headroom: float = 1.15,
    fit_on: tuple | None = None,
    telemetry: Telemetry | None = None,
    on_epoch_metrics: Callable | None = None,
    profile_steps: int = 0,
    profile_dir: str = "",
) -> tuple:
    """Train/validate epochs ``start_epoch`` .. ``epochs - 1``, tracking
    the best validation MAE (a classifier's highest accuracy).
    -> (state, {"best", "history": [per-epoch metrics], "staging" (the
    driver's: packed and staged bytes, compact or not, the fall-back),
    "graphs": {captures, replays, captures_after_warm}}, "padding" (the
    first epoch's training batches: ``PaddingStats``' efficiencies, the
    batch count, their (node_cap, edge_cap) shapes, and ``summary``),
    "preempted": True when a preemption request stopped the run,
    "edge_bytes": the first training epoch's edge leaves as this rank
    staged them (``edge_nbytes``; the driver's staged training batches),
    and, data-parallel,
    "dp": rank, world, backend, data index and graph shards, and the
    per-epoch state digests, also kept in each history entry as
    "digest").

    ``dense_m`` 0 or None packs the flat COO layout. ``packing`` is
    ``'snug'`` or ``'ladder'`` (module docstring; ``headroom`` the
    ladder's). The capacities default to those of the training graphs
    under that packing (``batch_caps``); ``buckets > 1`` packs per size
    class (``bucketed_batch_iterator``).
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
    ``force_weights``: the force task's (w_energy, w_force).

    Under a live process group the run is data-parallel (module
    docstring): ``train_graphs`` and ``val_graphs`` are this rank's
    data index's shards (``dist.host_shard``), ``batch_size`` is per data
    index, ``monitor`` must read its checkpoint through
    ``CoordinatedCheckpoint``; a model with a ``graph_group`` shards
    each batch's edge work over it (module docstring). ``fit_on``
    (train graphs, val graphs): what the capacities, the size classes
    and the transpose overflow are fitted on (default the given ones).

    ``telemetry``: the module docstring's (None: off);
    ``on_epoch_metrics(epoch, train means, val means)`` runs at each
    epoch's bookkeeping (the train entry point writes the epoch
    records there). ``profile_steps``, ``profile_dir``: the module
    docstring's profiling."""
    dense_m = dense_m or None
    dp = dist.active()
    if packing not in ("snug", "ladder"):
        raise ValueError(f"packing must be 'snug' or 'ladder', got "
                         f"{packing!r}")
    snug = packing == "snug"
    device_resident = device_resident or scan_epochs
    pack_once = pack_once or device_resident
    if compact is not None and not scan_epochs:
        raise ValueError("compact staging requires scan_epochs (the "
                         "expander runs inside the scan body)")
    if compact is not None and dense_m is None:
        raise ValueError("compact staging requires the dense layout "
                         "(dense_m)")
    fit_train, fit_val = (fit_on if fit_on is not None
                          else (train_graphs, val_graphs))
    node_cap, edge_cap = batch_caps(fit_train, batch_size, dense_m,
                                    node_cap, edge_cap, snug=snug,
                                    headroom=headroom)
    classification, edge_dtype = model_task(state.model)
    force = is_force(state.model)
    if compact is not None and force:
        raise ValueError("compact staging is refused for the force task "
                         "(train.py's rule): the model recomputes its "
                         "edges from the positions")
    if dp and compact is not None:
        raise ValueError("compact staging is not data-parallel (the JAX "
                         "package refuses it under data parallelism)")
    group = getattr(state.model, "graph_group", None)
    shards = group.size if group is not None else 1
    prep = None
    if shards > 1:
        if not dp:
            raise ValueError("a graph-sharded model trains under a live "
                             "process group")
        if buckets > 1 and dense_m is None:
            raise ValueError("--buckets with --graph-shards requires the "
                             "dense layout (per-size-class capacities "
                             "shard by node strips)")
        node_cap, edge_cap = sharded_caps(node_cap, edge_cap, dense_m,
                                          shards)
        # collectives inside the forward and backward: eager steps
        graphs = False
        prep = functools.partial(rank_view, n_shards=shards,
                                 index=group.index)
    node_multiple = 8 * shards if shards > 1 and dense_m else 1
    transpose_shards = shards if dense_m else 1
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
    telemetry = telemetry or Telemetry.disabled()
    stream = telemetry.stream
    # the grad-health metrics in the graph at step level: metric outputs
    # only, the trajectory unchanged
    health = telemetry.step_level
    grad_step = None
    if force:
        train_step = make_force_train_step(*force_weights,
                                           grad_health=health)
        eval_step = make_force_eval_step(*force_weights)
        grad_step = make_force_grad_step(*force_weights)
    else:
        train_step = make_train_step(expander=expand,
                                     classification=classification,
                                     grad_health=health)
        eval_step = make_eval_step(expander=expand,
                                   classification=classification)
    if guard:
        train_step = guard_step(train_step)
    # the step stream's tap after the guard's select, so a record sees
    # the skip flag
    train_step = telemetry.wrap_train_body(train_step)
    eval_step = telemetry.wrap_eval_body(eval_step)
    # validation batches carry the gathers' transpose where the eval step
    # takes a gradient (the forces), so its sums run in a fixed order too
    val_in_cap = None if force else 0
    pad_stats = PaddingStats()
    # shapes fitted on other graphs (a rank's shard packed at the whole
    # split's shapes): the overflow capacity of the two-tier transpose
    # too, which batch_iterator would fit on the graphs it packs
    graph_cap = graph_cap_for(batch_size) if snug else batch_size
    train_over = val_over = None
    if fit_on is not None and dense_m is not None:
        train_over = overflow_cap(fit_train, graph_cap, dense_m)
        if val_in_cap is None:
            val_over = overflow_cap(fit_val, graph_cap, dense_m)
    fit_kw = ({} if fit_on is None else {"fit_graphs": fit_train},
              {} if fit_on is None else {"fit_graphs": fit_val})

    def train_batches(rng):
        if buckets > 1:
            it = bucketed_batch_iterator(
                train_graphs, batch_size, buckets, shuffle=True, rng=rng,
                stats=pad_stats, headroom=headroom, dense_m=dense_m,
                snug=snug, pack_fn=pack_fn, node_multiple=node_multiple,
                transpose_shards=transpose_shards, **fit_kw[0])
        else:
            it = pad_stats.wrap(batch_iterator(
                train_graphs, batch_size, node_cap, edge_cap, shuffle=True,
                rng=rng, dense_m=dense_m, snug=snug, pack_fn=pack_fn,
                transpose_shards=transpose_shards, over_cap=train_over))
        # the fault plan's NaN batch and loader failure, before pack-once
        # or device-resident staging takes the batches (unwrapped when no
        # plan is active)
        return faultinject.poison_batches(it)

    def val_batches():
        if buckets > 1:
            return bucketed_batch_iterator(val_graphs, batch_size, buckets,
                                           headroom=headroom,
                                           dense_m=dense_m,
                                           in_cap=val_in_cap, snug=snug,
                                           pack_fn=pack_fn,
                                           node_multiple=node_multiple,
                                           **fit_kw[1])
        return batch_iterator(val_graphs, batch_size, node_cap, edge_cap,
                              dense_m=dense_m, in_cap=val_in_cap, snug=snug,
                              pack_fn=pack_fn, over_cap=val_over)

    rng = np.random.default_rng(seed)
    reduce_sums = pstep = apply_fn = None
    if dp:
        pstep = make_parallel_train_step(classification, guard, grad_step,
                                         grad_health=health)
        # graph B's body: the update, then the tap
        apply_fn = telemetry.wrap_train_body(
            lambda st, _: pstep.apply_part(st))
        reduce_sums = sum_reducer_for_sums()
        if preempt is not None:
            preempt = AgreedPreemption(preempt)
        state = replicate_state(state)
    staging: dict = {}
    edge_bytes = [0]

    def pack_lists() -> tuple:
        """Every batch packed once -> (train, val, key orders); under a
        process group at the shape counts the ranks agreed on (checked
        there), the generator at process 0's state, each rank's view."""
        t0 = time.perf_counter()
        with telemetry.span("pack"):
            train_list = list(train_batches(rng))
            val_list = list(val_batches())
        staging["pack_s"] = time.perf_counter() - t0
        if not dp:
            return train_list, val_list, (None, None)
        t0 = time.perf_counter()
        train_list, train_keys = agree_batches(train_list, train=True,
                                               dense_m=dense_m)
        val_list, val_keys = agree_batches(val_list, train=False,
                                           dense_m=dense_m)
        sync_rng(rng)
        staging["agree_s"] = time.perf_counter() - t0
        orders = (train_keys, val_keys)
        if prep is not None:
            views = ([prep(b) for b in train_list], [prep(b) for b in val_list])
            # the agreed key order, as the views' keys
            orders = tuple(
                [dict((batch_shape_key(h), batch_shape_key(v))
                      for h, v in zip(host, view))[k] for k in keys]
                for host, view, keys in zip((train_list, val_list), views,
                                            orders))
            train_list, val_list = views
        return train_list, val_list, orders

    driver = None
    packed_lists = None
    if scan_epochs:
        if profile_steps or print_freq:
            log_fn("scan_epochs: --profile and per-step prints are "
                   "unavailable inside the epoch driver (epoch-level "
                   "metrics only)")
        train_list, val_list, orders = pack_lists()
        staged = staged_nbytes(train_list + val_list)
        staging.update(staged_bytes=staged, compact=compact is not None)
        fits = (agreed_resident_fit(staged, device, log_fn) if dp
                else check_device_resident_fit(staged, log_fn=log_fn,
                                               device=device))
        if fits:
            edge_bytes[0] = sum(edge_nbytes(b) for b in train_list)
            t0 = time.perf_counter()
            with telemetry.span("stage_scan_stacks", staged_bytes=staged):
                driver = ScanEpochDriver(
                    train_step, eval_step, train_list, val_list, rng,
                    device=device, chunk_steps=chunk_steps, graphs=graphs,
                    preempt=preempt, split_step=pstep, key_order=orders,
                    telemetry=telemetry, apply_fn=apply_fn)
            del train_list, val_list
            staging["stage_s"] = time.perf_counter() - t0
            telemetry.sample_hbm("post_staging")
            t0 = time.perf_counter()
            with telemetry.warmup():
                driver.warm(state)
            staging["capture_s"] = time.perf_counter() - t0
        else:
            staging["fallback"] = "host_pack_once"
            scan_epochs = device_resident = False
            packed_lists = (train_list, val_list)
    plan = None
    if pack_once and driver is None:
        if packed_lists is None and dp:
            # the lists cut and padded once, to the agreed shape counts
            packed_lists = pack_lists()[:2]
        plan = PackOncePlan(
            (lambda: packed_lists[0]) if packed_lists is not None
            else (lambda: train_batches(rng)),
            (lambda: packed_lists[1]) if packed_lists is not None
            else val_batches,
            rng, device_resident=device_resident,
            stage=lambda b: b.to(device))
    if dp:
        train_run = SplitStepRunner(pstep, state, device, graphs=graphs,
                                    log_fn=log_fn, telemetry=telemetry,
                                    apply_fn=apply_fn)
    else:
        train_run = StepRunner(train_step, state, device, train=True,
                               graphs=graphs, log_fn=log_fn,
                               telemetry=telemetry)
    eval_run = StepRunner(eval_step, state, device, train=False,
                          graphs=graphs, log_fn=log_fn, telemetry=telemetry)
    telemetry.observe_padding(pad_stats)
    best_key = ("force_mae" if force
                else "correct" if classification else "mae")
    best = -np.inf if classification else np.inf
    history, digests = [], []
    padding = None
    preempted = False

    def finish_epoch(epoch, train_m, val_m, truncated, t0,
                     t1=None) -> bool:
        """The epoch's bookkeeping on its fetched means (the best, the
        history, the digest, the log, the gauges) -> is_best: in the
        epoch's iteration, or one epoch late on the deferred path. The
        epoch's seconds run from ``t0`` to ``t1`` (default: now)."""
        nonlocal best, padding
        if epoch == start_epoch:
            log_fn(pad_stats.summary())
            padding = {"node_efficiency": pad_stats.node_efficiency,
                       "edge_efficiency": pad_stats.edge_efficiency,
                       "batches": pad_stats.batches,
                       "shapes": sorted(pad_stats.shapes),
                       "summary": pad_stats.summary()}
        metric = val_m.get(best_key, np.nan)
        # a preemption that cut eval short leaves a partial score: it
        # never repoints the best
        is_best = (metric > best if classification
                   else metric < best) and not truncated
        if is_best:
            best = metric
        epoch_s = (time.perf_counter() if t1 is None else t1) - t0
        history.append({"epoch": epoch, "train": train_m, "val": val_m,
                        "seconds": epoch_s})
        tag = ""
        if dp:
            digest = check_replicated(state, f"epoch {epoch}")
            digests.append(digest)
            history[-1]["digest"] = digest
            log_fn(f"dp: process {dist.process_index()}/"
                   f"{dist.process_count()} epoch {epoch} digest {digest}")
            tag = (f" [dp x{dist.data_count()} * graph x{shards}]"
                   if shards > 1 else f" [dp x{dist.process_count()}]")
        log_fn(f"Epoch {epoch}{tag}: train loss "
               f"{train_m.get('loss', np.nan):.4f}"
               f"  val {best_key} {metric:.4f}{' *' if is_best else ''}"
               f"  ({epoch_s:.1f}s)")
        # live-progress gauges and the epoch-time series: host-side
        # bookkeeping a mid-run scrape reads
        telemetry.set_gauge("train_epoch", float(epoch))
        telemetry.set_gauge("train_loss_last",
                            float(train_m.get("loss", np.nan)))
        telemetry.set_gauge(f"val_{best_key}_last", float(metric))
        telemetry.set_gauge(f"val_{best_key}_best", float(best))
        telemetry.observe_value("epoch_time_s", epoch_s)
        if stream is not None:
            stream.flush(wait=False)
        if on_epoch_metrics is not None:
            on_epoch_metrics(epoch, train_m, val_m)
        return is_best

    # the driver's pair fetch runs on a thread; the pair's bookkeeping
    # moves one epoch late (its fetch overlapping the next epoch's steps)
    # where no checkpoint hook needs the state and the means together at
    # the boundary, no divergence monitor reads the means before going
    # on, no preemption handler polls there, and no process group checks
    # the state's replicas there. A deferred epoch's seconds run from the
    # later of its start and the previous epoch's fetch to its own fetch,
    # so the epochs' windows tile the run.
    defer_pair = (driver is not None and on_epoch_end is None
                  and monitor is None and preempt is None and not dp)
    pending_prev = None  # (epoch, pending, eval truncated, t0)
    last_done = -np.inf
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        truncated = False
        if driver is not None:
            with telemetry.span("epoch", epoch=epoch, driver="scan"):
                state, pending = driver.run_epoch_pair(
                    state, first=epoch == start_epoch, async_fetch=True)
            aborted, truncated = driver.aborted, driver.eval_truncated
            if defer_pair:
                if pending_prev is not None:
                    p_epoch, p_pending, p_trunc, p_t0 = pending_prev
                    p_train, p_val = p_pending.result()
                    settle_count(state, p_train)
                    finish_epoch(p_epoch, p_train, p_val, p_trunc,
                                 max(p_t0, last_done), p_pending.done_at)
                    last_done = p_pending.done_at
                    pending_prev = None
                if aborted:
                    # only a preemption poll aborts, and deferral has
                    # none: the partial epoch's means are dropped
                    save_preempted_mid_epoch(state, epoch, on_epoch_end,
                                             log_fn)
                    preempted = True
                    break
                pending_prev = (epoch, pending, truncated, t0)
                faultinject.maybe_sigterm(epoch)
                continue
            train_m, val_m = pending.result()
            settle_count(state, train_m)
            if aborted:
                save_preempted_mid_epoch(state, epoch, on_epoch_end, log_fn)
                preempted = True
                break
        else:
            if plan is not None:
                epoch_train, epoch_val = plan.epoch_iterators()
            else:
                epoch_train, epoch_val = train_batches(rng), val_batches()
            if dp and plan is None:
                # the whole epoch is packed first: its count is what the
                # ranks agree on
                epoch_train = parallel_batches(epoch_train, train=True,
                                               dense_m=dense_m,
                                               prep_fn=prep)
                epoch_val = parallel_batches(epoch_val, train=False,
                                             dense_m=dense_m, prep_fn=prep)
            if epoch == start_epoch:
                epoch_train = counted_edge_bytes(epoch_train, edge_bytes)
            if not device_resident:
                epoch_train = stage(epoch_train, device, prefetch,
                                    loader_stats, telemetry)
                epoch_val = stage(epoch_val, device, prefetch, loader_stats,
                                  telemetry)
            if epoch == start_epoch:
                epoch_train = profile_wrap(epoch_train, profile_steps,
                                           profile_dir, log_fn)
            with telemetry.span("epoch", epoch=epoch, driver="per_step"):
                train_m = train_run.epoch(epoch_train, print_freq=print_freq,
                                          epoch=epoch, log_fn=log_fn)
            with telemetry.span("eval", epoch=epoch):
                val_m = eval_run.epoch(epoch_val, epoch=epoch, log_fn=log_fn,
                                       reduce=reduce_sums)
            settle_count(state, train_m)
            if epoch == start_epoch:
                train_run.cache.mark_warm()
                eval_run.cache.mark_warm()
        is_best = finish_epoch(epoch, train_m, val_m, truncated, t0)
        state, _, preempted = resilience_epoch_end(
            state, epoch, train_m, val_m, is_best, monitor=monitor,
            on_epoch_end=on_epoch_end, preempt=preempt, log_fn=log_fn)
        if preempted:
            break
    if pending_prev is not None:
        # the deferred path's last epoch: nothing overlaps its fetch
        p_epoch, p_pending, p_trunc, p_t0 = pending_prev
        p_train, p_val = p_pending.result()
        settle_count(state, p_train)
        finish_epoch(p_epoch, p_train, p_val, p_trunc, max(p_t0, last_done),
                     p_pending.done_at)
    if stream is not None:
        # every row of the run in the records before fit returns
        stream.flush()
    if driver is not None:
        caches = [driver.train_graphs, driver.eval_graphs]
        apply = [driver.apply_graph]
    else:
        caches = [train_run.cache, eval_run.cache]
        apply = [train_run.apply]
    apply = [g for g in apply if g is not None]
    out = {"best": best, "best_key": best_key, "history": history,
           "graphs": {
        "captures": (sum(c.captures() for c in caches)
                     + sum(g.graph is not None for g in apply)),
        "replays": (sum(c.replays() for c in caches)
                    + sum(g.replays for g in apply)),
        "captures_after_warm": sum(c.captures_after_warm for c in caches)}}
    out["edge_bytes"] = edge_bytes[0]
    if dp:
        out["dp"] = {"rank": dist.process_index(),
                     "world": dist.process_count(),
                     "backend": dist.backend(),
                     "data_index": dist.data_index(),
                     "graph_shards": shards, "digests": digests}
    if padding is not None:
        out["padding"] = padding
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
             force_weights: tuple = (1.0, 10.0),
             snug: bool = True) -> dict:
    """Metric means of the eval step over ``graphs`` (capacities and
    packing as in ``fit``; the task and edge dtype the model's;
    ``force_weights`` the force task's loss weights), stepped eagerly."""
    dense_m = dense_m or None
    node_cap, edge_cap = batch_caps(graphs, batch_size, dense_m, node_cap,
                                    edge_cap, snug=snug)
    classification, edge_dtype = model_task(state.model)
    force = is_force(state.model)
    step = (make_force_eval_step(*force_weights) if force
            else make_eval_step(classification=classification))
    return StepRunner(step, state, device, train=False, graphs=False).epoch(
        stage(batch_iterator(graphs, batch_size, node_cap, edge_cap,
                             dense_m=dense_m, in_cap=None if force else 0,
                             snug=snug, pack_fn=edge_pack_fn(edge_dtype)),
              device))
