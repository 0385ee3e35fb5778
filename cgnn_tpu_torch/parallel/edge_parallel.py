"""Edge-sharded (graph-parallel) message passing
(``cgnn_tpu/parallel/edge_parallel.py``): a batch whose edge work is too
big for one card is split over the G ranks of a graph group.

The JAX package runs one SPMD program under ``shard_map`` and places
each leaf with a ``PartitionSpec`` (``shard_batch``, ``_auto_specs``). The
port's ranks are processes, so each one builds and stages its own view
of every batch (``rank_view``): the node and graph leaves whole, and of
the edge leaves (``EDGE_FIELDS``) and the transpose mapping only its own
part, so a card holds 1/G of the edge bytes:

- dense layout (node strips): rank s owns the nodes ``[s*N/G,
  (s+1)*N/G)`` and their [N/G, M] edge slots; a training batch carries
  one two-tier mapping a shard (``data.graph.shard_transpose_slots``,
  packed by ``pack_graphs(transpose_shards=G)`` or rebuilt by
  ``prepare_dense_sharded``), and the rank keeps its row;
- flat COO (edge chunks): rank s holds the s-th contiguous chunk of the
  center-sorted edge list (``pad_edges_divisible`` makes the capacity
  divide); a training batch's view carries the chunk's own fixed-order
  transpose (``chunk_transpose``: ``center_offsets``, ``nbr_order`` and
  ``nbr_offsets`` of the chunk's edges over all N nodes), which the COO
  gathers' backward reads so a step repeats its bits.

The model (models/cgcnn.py, ``graph_group``) then computes its share of
every conv and combines the shares with the group's collectives; the
gradient rules are the JAX docstring's (``edge_parallel.py:17-23``):
edge-side parameters get partial gradients, summed over the group after
the backward (train/step.py), node-side ones are whole on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cgnn_tpu_torch.data.graph import GraphBatch, csr_transpose

# GraphBatch leaves whose leading axis is the edge axis (the dense
# layout's edges are [N, M, G]: its leading axis is the strip's)
EDGE_FIELDS = ("edges", "centers", "neighbors", "edge_mask", "edge_offsets")
# the dense transpose mapping: one row a shard under graph sharding
MAPPING_FIELDS = ("in_slots", "in_mask", "over_slots", "over_nodes",
                  "over_mask")


def is_dense(batch: GraphBatch) -> bool:
    """The dense slot layout stores its edges [N, M, G]."""
    return batch.edges.dim() == 3


def pad_edges_divisible(batch: GraphBatch, n_shards: int) -> GraphBatch:
    """A COO batch whose edge axis splits evenly into ``n_shards``: the
    padding edges follow ``pack_graphs``' rule (masked, zero features,
    both endpoints the last node slot, so ``centers`` stays sorted); a
    batch that carries the gathers' transpose gets the new edges at the
    end of the last node's runs. Unchanged when it divides already."""
    e = batch.edge_capacity
    pad = -e % n_shards
    if pad == 0:
        return batch
    if is_dense(batch):
        raise ValueError("pad_edges_divisible pads the flat COO layout; a "
                         "dense batch divides by its node capacity")
    last = batch.node_capacity - 1

    def padded(name, t):
        fill = last if name in ("centers", "neighbors") else 0
        tail = t.new_full((pad, *t.shape[1:]), fill)
        return torch.cat([t, tail])

    out = {name: padded(name, getattr(batch, name)) for name in EDGE_FIELDS}
    if batch.nbr_order is not None:
        out["nbr_order"] = torch.cat([batch.nbr_order, torch.arange(
            e, e + pad, dtype=batch.nbr_order.dtype)])
        for name in ("nbr_offsets", "center_offsets"):
            offsets = getattr(batch, name).clone()
            offsets[-1] += pad
            out[name] = offsets
    return dataclasses.replace(batch, **out)


def prepare_dense_sharded(batch: GraphBatch, n_shards: int,
                          train: bool = True) -> GraphBatch:
    """A dense-layout batch ready for node-strip sharding (host side):
    a training batch with its per-shard two-tier mappings (kept when it
    was packed with ``transpose_shards=n_shards``, else rebuilt from its
    flat two-tier mapping), an eval batch with no mapping at all (no
    backward runs). Refused (ValueError): a COO batch, a node capacity
    the shard count does not divide, a mapping stacked for another shard
    count, and the single-tier layout (no overflow capacity to bound a
    shard's overflow by)."""
    if not is_dense(batch):
        raise ValueError(
            "prepare_dense_sharded expects a dense-layout batch "
            "(edges pre-shaped [N, M, G]; pack with dense_m)")
    ncap = batch.node_capacity
    if ncap % n_shards:
        raise ValueError(
            f"node capacity {ncap} not divisible by {n_shards} graph "
            f"shards; round node_cap up to a multiple of the shard count")
    if not train or batch.in_slots is None:
        return dataclasses.replace(batch, **dict.fromkeys(MAPPING_FIELDS))
    if batch.in_mask.dim() == 3:
        # already per shard, but only for the same count: a 4-shard
        # mapping split over 2 ranks would drop half the cotangents
        if batch.in_mask.shape[0] != n_shards:
            raise ValueError(
                f"batch carries a {batch.in_mask.shape[0]}-shard transpose "
                f"mapping but {n_shards} graph shards were requested")
        return batch
    if batch.over_slots is None:
        raise ValueError(
            "graph sharding needs the two-tier transpose layout; pack "
            "with in_cap=None (the default) instead of a single-tier "
            "in_cap")
    from cgnn_tpu_torch.data.graph import shard_transpose_slots

    m = batch.edges.shape[1]
    parts = shard_transpose_slots(
        batch.neighbors.numpy(), batch.edge_mask.numpy() > 0, ncap, m,
        n_shards, len(batch.over_slots))
    return dataclasses.replace(batch, **{
        name: torch.from_numpy(a) for name, a in zip(MAPPING_FIELDS,
                                                      parts)})


def chunk_transpose(centers: torch.Tensor, neighbors: torch.Tensor,
                    num_nodes: int) -> dict:
    """The COO gathers' fixed-order transpose of one edge chunk, over all
    ``num_nodes`` nodes (``data.graph.csr_transpose``, positions local to
    the chunk): ``center_offsets`` (the chunk's centers are sorted),
    ``nbr_order`` and ``nbr_offsets``."""
    order, nbr_offsets = csr_transpose(neighbors.numpy(), num_nodes)
    _, center_offsets = csr_transpose(centers.numpy(), num_nodes,
                                      indices_sorted=True)
    return {"nbr_order": torch.from_numpy(order),
            "nbr_offsets": torch.from_numpy(nbr_offsets),
            "center_offsets": torch.from_numpy(center_offsets)}


def rank_view(batch: GraphBatch, n_shards: int, index: int) -> GraphBatch:
    """Rank ``index``'s part of a host batch under ``n_shards``-way graph
    sharding (module docstring): the node and graph leaves whole, its
    strip (dense) or chunk (COO) of every edge leaf, its row of a dense
    training batch's per-shard mapping (kept [1, ...], which the model
    holds to its group), and a COO training batch's chunk transpose.
    A capacity the shard count does not divide raises."""
    if not 0 <= index < n_shards:
        raise ValueError(f"shard index {index} outside [0, {n_shards})")
    dense = is_dense(batch)
    if dense:
        batch = prepare_dense_sharded(batch, n_shards,
                                      train=batch.in_slots is not None)
    elif batch.edge_capacity % n_shards:
        raise ValueError(
            f"edge capacity {batch.edge_capacity} not divisible by "
            f"{n_shards} graph shards; pack at a multiple of the shard "
            f"count or pad (pad_edges_divisible)")
    out = {}
    for name in EDGE_FIELDS:
        t = getattr(batch, name)
        rows = t.shape[0] // n_shards
        out[name] = t[index * rows:(index + 1) * rows]
    if dense and batch.in_slots is not None:
        for name in MAPPING_FIELDS:
            t = getattr(batch, name)
            out[name] = None if t is None else t[index:index + 1]
    if not dense and batch.nbr_order is not None:
        out.update(chunk_transpose(out["centers"], out["neighbors"],
                                   batch.node_capacity))
    return dataclasses.replace(batch, **out)


def edge_nbytes(batch: GraphBatch) -> int:
    """Bytes of a batch's edge leaves, its transpose mapping and its COO
    transpose: what graph sharding divides among the ranks (of a compact
    batch, the fields of those names it has)."""
    return sum(t.nbytes for name in (*EDGE_FIELDS, *MAPPING_FIELDS,
                                     "nbr_order")
               if (t := getattr(batch, name, None)) is not None)
