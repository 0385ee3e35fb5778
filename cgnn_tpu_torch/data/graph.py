"""Graph containers and static-shape batching (``cgnn_tpu/data/graph.py``).

- ``CrystalGraph``: one featurized crystal, host-side numpy, flat edge list.
- ``GraphBatch``: many crystals packed into fixed-capacity node/edge/graph
  slots with masks — a dataclass of torch tensors with the fields of the
  JAX package's ``GraphBatch`` struct.

Packing is numpy on the host and produces arrays bit-equal to the JAX
package's ``pack_graphs`` for the same graphs and capacities; the batch
then wraps them as CPU tensors without a copy and ``.to(device)`` moves it.
This slice packs the DENSE slot layout only (node slot ``n`` owns edge
slots ``[n*M, (n+1)*M)``), without the transpose slots that only a
backward pass reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass
class CrystalGraph:
    """One featurized crystal (host-side, numpy)."""

    atom_fea: np.ndarray  # [N, D] float32
    edge_fea: np.ndarray  # [E, G] float32 (Gaussian-expanded distances)
    centers: np.ndarray  # [E] int32 — receiving atom i
    neighbors: np.ndarray  # [E] int32 — source atom j
    target: np.ndarray  # [T] float32
    cif_id: str = ""
    distances: np.ndarray | None = None  # [E] raw distances
    target_mask: np.ndarray | None = None  # [T] 1.0 where label present

    @property
    def num_nodes(self) -> int:
        return len(self.atom_fea)

    @property
    def num_edges(self) -> int:
        return len(self.centers)


@dataclasses.dataclass
class GraphBatch:
    """Fixed-capacity packed batch of graphs (tensors on one device)."""

    nodes: torch.Tensor  # [Ncap, D] f32
    edges: torch.Tensor  # [Ncap, M, G] f32 (dense layout)
    centers: torch.Tensor  # [Ecap] i32 (receiving node slot)
    neighbors: torch.Tensor  # [Ecap] i32 (source node slot)
    node_graph: torch.Tensor  # [Ncap] i32 (graph slot of each node)
    node_mask: torch.Tensor  # [Ncap] f32 (1 = real)
    edge_mask: torch.Tensor  # [Ecap] f32
    graph_mask: torch.Tensor  # [Gcap] f32
    targets: torch.Tensor  # [Gcap, T] f32
    target_mask: torch.Tensor  # [Gcap, T] f32
    # geometry and per-atom labels of the force task: zeros here, since
    # the port's graphs carry no geometry yet
    positions: torch.Tensor  # [Ncap, 3] f32
    lattices: torch.Tensor  # [Gcap, 3, 3] f32
    edge_offsets: torch.Tensor  # [Ecap, 3] f32
    node_targets: torch.Tensor  # [Ncap, 3] f32
    # transpose of the neighbor gather: read only by a backward pass, so
    # a forward-only batch leaves them None
    in_slots: torch.Tensor | None = None
    in_mask: torch.Tensor | None = None
    over_slots: torch.Tensor | None = None
    over_nodes: torch.Tensor | None = None
    over_mask: torch.Tensor | None = None

    @property
    def graph_capacity(self) -> int:
        return self.targets.shape[0]

    def to(self, device) -> "GraphBatch":
        """A copy with every tensor on ``device``."""
        return GraphBatch(**{
            f.name: (None if (v := getattr(self, f.name)) is None
                     else v.to(device))
            for f in dataclasses.fields(self)
        })

    def numpy(self) -> dict:
        """{field: numpy array or None} — host copies, for comparisons."""
        return {
            f.name: (None if (v := getattr(self, f.name)) is None
                     else v.detach().cpu().numpy())
            for f in dataclasses.fields(self)
        }


def pack_graphs(
    graphs: Sequence[CrystalGraph],
    node_cap: int,
    edge_cap: int,
    graph_cap: int,
    num_targets: int | None = None,
    dense_m: int | None = None,
    in_cap: int | None = None,
    over_cap: int | None = None,
) -> GraphBatch:
    """Concatenate graphs into one fixed-capacity dense-layout GraphBatch.

    ``dense_m=M`` is required: node slot ``n`` owns edge slots
    ``[n*M, (n+1)*M)`` (its real edges first, masked self-loop padding
    after), so ``edge_cap == node_cap * M``. Padding nodes belong to graph
    slot 0 and are masked. The transpose slots (``in_cap``/``over_cap``)
    feed only a backward pass and are not ported yet.
    """
    if dense_m is None:
        raise NotImplementedError(
            "the flat COO layout is not ported yet; pack with dense_m")
    if in_cap is not None or over_cap is not None:
        raise NotImplementedError(
            "transpose slots (in_cap/over_cap) feed only the backward pass, "
            "which is not ported yet")
    if not graphs:
        raise ValueError("cannot pack an empty graph list")
    if edge_cap != node_cap * dense_m:
        raise ValueError(
            f"dense layout requires edge_cap == node_cap * dense_m "
            f"({node_cap} * {dense_m} != {edge_cap})"
        )
    n_graphs = len(graphs)
    total_nodes = sum(g.num_nodes for g in graphs)
    total_edges = sum(g.num_edges for g in graphs)
    if n_graphs > graph_cap or total_nodes > node_cap:
        raise ValueError(
            f"batch ({n_graphs} graphs, {total_nodes} nodes, {total_edges} edges)"
            f" exceeds capacity ({graph_cap}, {node_cap}, {edge_cap})"
        )
    node_dim = graphs[0].atom_fea.shape[1]
    edge_dim = graphs[0].edge_fea.shape[1]
    tdim = num_targets or int(np.atleast_1d(graphs[0].target).shape[0])

    nodes = np.zeros((node_cap, node_dim), np.float32)
    edges = np.zeros((edge_cap, edge_dim), np.float32)
    # slot k belongs to node k // M; padding slots are masked self-loops on
    # their owning node (centers stay sorted)
    centers = (np.arange(edge_cap, dtype=np.int32) // dense_m).astype(np.int32)
    neighbors = centers.copy()
    node_graph = np.zeros(node_cap, np.int32)
    node_mask = np.zeros(node_cap, np.float32)
    edge_mask = np.zeros(edge_cap, np.float32)
    graph_mask = np.zeros(graph_cap, np.float32)
    targets = np.zeros((graph_cap, tdim), np.float32)
    target_mask = np.zeros((graph_cap, tdim), np.float32)
    positions = np.zeros((node_cap, 3), np.float32)
    lattices = np.zeros((graph_cap, 3, 3), np.float32)
    edge_offsets = np.zeros((edge_cap, 3), np.float32)
    node_targets = np.zeros((node_cap, 3), np.float32)

    nn_arr = np.fromiter((g.num_nodes for g in graphs), np.int64, n_graphs)
    ne_arr = np.fromiter((g.num_edges for g in graphs), np.int64, n_graphs)
    node_offs = np.zeros(n_graphs + 1, np.int64)
    np.cumsum(nn_arr, out=node_offs[1:])

    np.concatenate([g.atom_fea for g in graphs], axis=0,
                   out=nodes[:total_nodes])
    node_graph[:total_nodes] = np.repeat(
        np.arange(n_graphs, dtype=np.int32), nn_arr
    )
    node_mask[:total_nodes] = 1.0

    # global centers with node offsets applied: per-graph ranges are
    # disjoint and increasing, so ONE global stable argsort restores
    # per-graph center order without mixing graphs
    e_node_off = np.repeat(node_offs[:-1], ne_arr)
    gcent = np.concatenate([g.centers for g in graphs]).astype(np.int64)
    gcent += e_node_off
    gnbr = np.concatenate([g.neighbors for g in graphs]).astype(np.int64)
    gnbr += e_node_off
    if np.all(gcent[1:] >= gcent[:-1]):
        order = None  # knn_neighbor_list output is already center-sorted
    else:
        order = np.argsort(gcent, kind="stable")
        gcent, gnbr = gcent[order], gnbr[order]
    efea = np.concatenate([g.edge_fea for g in graphs], axis=0)
    if order is not None:
        efea = efea[order]

    counts = np.bincount(gcent, minlength=node_cap)
    worst = int(counts.max(initial=0))
    if worst > dense_m:
        bad = int(np.argmax(counts))
        gi = int(np.searchsorted(node_offs, bad, side="right")) - 1
        raise ValueError(
            f"graph {graphs[gi].cif_id!r} has a node with {worst} "
            f"edges > dense_m={dense_m}; featurize with "
            f"max_num_nbr <= dense_m"
        )
    # edge k's within-center rank, then slot (center, rank); the grid is
    # filled by gather from the sorted edges plus a sentinel zero row
    within = np.arange(total_edges) - (np.cumsum(counts) - counts)[gcent]
    slots = gcent * dense_m + within
    starts = np.cumsum(counts) - counts
    src = starts[:, None] + np.arange(dense_m)
    grid_valid = np.arange(dense_m) < counts[:, None]
    np.copyto(src, total_edges, where=~grid_valid)
    efea_pad = np.empty((total_edges + 1, edge_dim), np.float32)
    efea_pad[:total_edges] = efea
    efea_pad[total_edges] = 0.0
    np.take(efea_pad, src.ravel(), axis=0, out=edges, mode="clip")
    edge_mask[:] = grid_valid.ravel()
    neighbors[slots] = gnbr.astype(np.int32)

    graph_mask[:n_graphs] = 1.0
    for gi, g in enumerate(graphs):
        t = np.atleast_1d(np.asarray(g.target, np.float32))
        targets[gi, : len(t)] = t
        target_mask[gi, : len(t)] = (
            1.0 if g.target_mask is None
            else np.broadcast_to(np.atleast_1d(g.target_mask), (len(t),)))

    as_t = torch.from_numpy
    return GraphBatch(
        nodes=as_t(nodes),
        edges=as_t(edges.reshape(node_cap, dense_m, edge_dim)),
        centers=as_t(centers),
        neighbors=as_t(neighbors),
        node_graph=as_t(node_graph),
        node_mask=as_t(node_mask),
        edge_mask=as_t(edge_mask),
        graph_mask=as_t(graph_mask),
        targets=as_t(targets),
        target_mask=as_t(target_mask),
        positions=as_t(positions),
        lattices=as_t(lattices),
        edge_offsets=as_t(edge_offsets),
        node_targets=as_t(node_targets),
    )


def capacities_for(
    graphs: Sequence[CrystalGraph],
    batch_size: int,
    dense_m: int | None = None,
) -> tuple[int, int]:
    """Snug (node_cap, edge_cap) for fill-to-capacity packing: exact
    8-aligned capacities at the per-batch share of the total node count
    plus a mean + std packing margin, with NO headroom and NO ladder
    rounding. With ``dense_m`` the edge capacity is ``node_cap * dense_m``.
    This is the JAX package's ``snug=True`` mode; its headroom/ladder mode
    is not ported.
    """
    nodes = np.array([g.num_nodes for g in graphs])
    b_count = max(1, math.ceil(len(graphs) / batch_size))
    margin = nodes.mean() + nodes.std()
    node_cap = _align8(int(max(nodes.sum() / b_count + margin, nodes.max())))
    if dense_m is not None:
        return node_cap, node_cap * dense_m
    edges = np.array([g.num_edges for g in graphs])
    margin_e = edges.mean() + edges.std()
    edge_cap = _align8(int(max(edges.sum() / b_count + margin_e, edges.max())))
    return node_cap, edge_cap


def _align8(n: int) -> int:
    """Round up to a multiple of 8."""
    return max(8, -(-int(n) // 8) * 8)


def graph_cap_for(batch_size: int) -> int:
    """Graph-slot capacity for fill-to-capacity packing: ``batch_size``
    plus ~12% slack (8-aligned) so node capacity — not the graph count —
    is what closes a typical batch."""
    return batch_size + _align8(max(8, batch_size // 8))
