"""MeshExecutor: the mesh engine of the forward paths
(``cgnn_tpu/parallel/executor.py``).

The JAX package runs a flush as ONE ``shard_map`` program over a 1-D
``('data',)`` mesh: per-shard sub-batches stack on a leading device axis,
the stack is placed batch-axis sharded, and one jitted dispatch runs the
unpartitioned single-device body on every device's slice. The port keeps
the contract and drops the compiler:

- **One dispatch from one thread.** ``shard_predict(step)`` returns a
  callable that runs ``step(i, batch_i)``, the per-shard single-device
  predict step of entry i (its captured predict graph of the flush's
  (rung, form, tier)), for every entry from the calling thread, each on
  its entry's stream: no router, no per-entry queue or thread. The
  entries' streams first wait on the caller's stream, and the caller's
  stream waits on all of them before the outputs are restacked to
  ``[N, G, T]`` on entry 0's device; for the raw wire every output leaf
  restacks, the ``(preds, overflow, n_edges)`` tuple as JAX restacks it.
- **Each entry receives only its own slice.** ``stack`` builds the
  ``[N, ...]`` stack on the host (page-locked on CUDA) and ``stage``
  copies slice i, and nothing else, to entry i's device on entry i's
  stream. Copying the whole stack to every device is the failure mode
  the JAX package's GA-SHARD audit guards against; ``staged_bytes``
  counts the bytes staged per entry, so a check can hold each entry to
  its slice.
- **Bit-exact by construction.** A shard runs the same captured graph a
  single-entry dispatch of the same packed sub-batch runs.
- **Compile count.** A CUDA graph is bound to its device and to the
  addresses it read at capture, so the JAX rule "compile count =
  programs, never programs x N" becomes: captures = programs x entries,
  all at warm-up, and ``captures_after_warm`` 0.
- ``place_params`` returns one state per entry (each entry's graphs read
  their own tensors): ``replicate_state``, the same placement the
  threads engine gets, since a replicated state is placed alike under
  both engines here. ``serve.reload.ParamStore(devices=)`` publishes the
  copies under one version.

``open_entries`` is the one place that decides what runs on a device
set: the engine, each entry's stream and each device's predict step.
Bulk predict (train/infer.py) and the server (serve/server.py) both open
their set through it.

``abstract_stacked`` (the JAX audit's lowering surface) has nothing to
lower against here and is left out.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from cgnn_tpu_torch.serve.devices import (
    canonical,
    entry_streams,
    on_stream,
    replicate_state,
    resolve_devices,
)


@dataclasses.dataclass
class EntrySet:
    """What runs on a device set: ``engine`` ('single', 'mesh' or
    'threads': what runs, not what was asked), the entries (``devices``),
    each entry's stream (None on the CPU and for one entry), each
    entry's predict step (one built a distinct device: the expanders'
    constants live there) and, under the mesh engine, its
    ``MeshExecutor``."""

    devices: list
    engine: str
    mesh: "MeshExecutor | None"
    streams: list
    steps: list


def open_entries(devices: Sequence, engine: str,
                 make_step: Callable) -> EntrySet:
    """The device set ``devices`` (repeats included) under ``engine``
    ('auto', 'mesh' or 'threads'): 'auto' is the mesh engine on more than
    one entry, and one entry runs 'single' whatever was asked.
    ``make_step(device)`` builds the predict step for one device."""
    if engine not in ("auto", "mesh", "threads"):
        raise ValueError(f"engine must be 'auto', 'mesh', or 'threads', "
                         f"got {engine!r}")
    devices = [canonical(d) for d in devices]
    if not devices:
        raise ValueError("a device set needs at least one device")
    mesh = None
    if len(devices) > 1 and engine in ("auto", "mesh"):
        mesh = MeshExecutor(devices)
    steps = {}
    for d in devices:
        if d not in steps:
            steps[d] = make_step(d)
    if mesh is not None:
        streams = mesh.streams
    else:
        streams = entry_streams(devices) if len(devices) > 1 else [None]
    return EntrySet(
        devices=devices,
        engine=("single" if len(devices) == 1
                else "mesh" if mesh is not None else "threads"),
        mesh=mesh, streams=streams, steps=[steps[d] for d in devices])


def batch_fields(batch) -> dict:
    """{field: tensor} of a batch dataclass (None fields left out)."""
    return {f.name: v for f in dataclasses.fields(batch)
            if (v := getattr(batch, f.name)) is not None}


class MeshExecutor:
    """The entries, their streams and the sharded-step factory for one
    device set (``devices`` default: ``resolve_devices('auto')``; an
    explicit list forces, repeats included)."""

    def __init__(self, devices: Sequence | None = None):
        if devices is None:
            devices = resolve_devices("auto")
        devices = [canonical(d) for d in devices]
        if not devices:
            raise ValueError("a MeshExecutor needs at least one device")
        self.devices = tuple(devices)
        self.streams = entry_streams(self.devices)
        self.staged_bytes = [0] * len(devices)
        self.stages = 0

    def __len__(self) -> int:
        return len(self.devices)

    # ---- placement ----

    def place_params(self, state) -> list:
        """One copy of ``state`` per entry (``replicate_state``)."""
        return replicate_state(state, self.devices)

    def stack(self, batches: Sequence):
        """Stack exactly N same-shape per-shard batches on a new leading
        axis (host tensors; page-locked when an entry is a card). The
        batch type is kept, so the step still sees a CompactBatch or a
        RawBatch."""
        if len(batches) != len(self):
            raise ValueError(
                f"need exactly {len(self)} per-shard batches (one per "
                f"entry), got {len(batches)}")
        pin = any(d.type == "cuda" for d in self.devices)
        fields = {}
        for k, t in batch_fields(batches[0]).items():
            s = torch.stack([getattr(b, k) for b in batches])
            fields[k] = s.pin_memory() if pin else s
        return dataclasses.replace(batches[0], **fields)

    def stage(self, stacked) -> list:
        """Slice i of the ``[N, ...]`` stack to entry i's device, on its
        stream (asynchronous from page-locked memory) -> one batch per
        entry. Each entry receives its slice alone; ``staged_bytes[i]``
        adds the slice's bytes."""
        out = []
        for i, (dev, stream) in enumerate(zip(self.devices, self.streams)):
            part = {k: t[i] for k, t in batch_fields(stacked).items()}
            with on_stream(stream):
                staged = {k: t.to(dev, non_blocking=True)
                          for k, t in part.items()}
            self.staged_bytes[i] += sum(t.numel() * t.element_size()
                                        for t in part.values())
            out.append(dataclasses.replace(stacked, **staged))
        self.stages += 1
        return out

    # ---- the sharded step ----

    def shard_predict(self, predict_step: Callable) -> Callable:
        """``predict_step(i, batch)`` -> entry i's [G, T] (or the raw
        wire's tuple). Returns ``run(staged)``: every entry's step on its
        own staged batch and stream, from this thread, restacked to
        ``[N, G, T]`` (each output leaf) on entry 0's device."""
        dev0 = self.devices[0]

        def run(staged: Sequence):
            if len(staged) != len(self):
                raise ValueError(f"need {len(self)} staged batches, got "
                                 f"{len(staged)}")
            caller = (torch.cuda.current_stream(dev0)
                      if dev0.type == "cuda" else None)
            outs = []
            for i, (batch, stream) in enumerate(zip(staged, self.streams)):
                if stream is not None:
                    # the previous restack has read this entry's static
                    # outputs before its next replay writes them
                    stream.wait_stream(torch.cuda.current_stream(
                        self.devices[i]))
                with on_stream(stream):
                    outs.append(predict_step(i, batch))
            if caller is not None:
                for stream in self.streams:
                    caller.wait_stream(stream)
                for out in outs:
                    # made on an entry's stream, read on the caller's
                    for t in out if isinstance(out, tuple) else (out,):
                        t.record_stream(caller)
            if isinstance(outs[0], tuple):
                return tuple(torch.stack([o[j].to(dev0) for o in outs])
                             for j in range(len(outs[0])))
            return torch.stack([o.to(dev0) for o in outs])

        return run

    # ---- serving-side shard planning ----

    def split_round_robin(self, items: Sequence) -> list[list]:
        """items[j] -> shard j % N (row j // N): shard loads within one
        item of each other."""
        n = len(self)
        return [list(items[i::n]) for i in range(n)]

    def plan_flush(self, graphs: Sequence, shape_set):
        """Split a flush's graphs over the entries and pick ONE rung for
        every shard -> (groups, rung, counts): the smallest rung that fits
        the largest shard; an empty shard packs a filler copy of the first
        graph, whose rows are never read (``counts``: real graphs a
        shard)."""
        groups = self.split_round_robin(list(graphs))
        counts = [len(g) for g in groups]
        need_g = need_n = need_e = 1
        for g in groups:
            if not g:
                continue
            n = sum(x.num_nodes for x in g)
            e = sum(shape_set.graph_counts(x)[1] for x in g)
            need_g = max(need_g, len(g))
            need_n = max(need_n, n)
            need_e = max(need_e, e)
        shape = shape_set.shape_for(need_g, need_n, need_e)
        if shape is None:
            raise ValueError(
                f"no rung fits the per-shard split ({need_g} graphs / "
                f"{need_n} nodes / {need_e} edge slots): the flush should "
                f"have been admitted smaller")
        filler = [graphs[0]]
        groups = [g if g else filler for g in groups]
        return groups, shape, counts
