"""Graph containers and static-shape batching (``cgnn_tpu/data/graph.py``).

- ``CrystalGraph``: one featurized crystal, host-side numpy, flat edge list.
- ``GraphBatch``: many crystals packed into fixed-capacity node/edge/graph
  slots with masks — a dataclass of torch tensors with the fields of the
  JAX package's ``GraphBatch`` struct.

Packing is numpy on the host and produces arrays bit-equal to the JAX
package's ``pack_graphs`` for the same graphs and capacities; the batch
then wraps them as CPU tensors without a copy (page-locked ones with
``pin``) and ``.to(device)`` moves it.
Both layouts are ported:

- DENSE slots (``dense_m=M``): node slot ``n`` owns edge slots
  ``[n*M, (n+1)*M)``, with the transpose slots that make the neighbor
  gather's backward scatter-free (``transpose_slots``);
- flat COO (``dense_m=None``): the real edges first, sorted by center,
  then padding edges that point at the last node slot, masked, so
  ``centers`` stays non-decreasing (the sorted segment sum,
  ops/scatter.py, relies on it). A COO training batch carries its
  endpoint gathers' transpose as CSR lists instead (``csr_transpose``),
  which the port adds for its fixed-order backward.

The training batch iterator (``batch_iterator``, ``count_batches``) closes
a batch on its graph, node and edge budgets; ``plan_batches`` gives the
same spans without packing, and ``assign_size_buckets`` the size classes
of bulk inference (train/infer.py) and of ``bucketed_batch_iterator``
(training with one snug capacity per size class). ``batch_shape_key``
names a batch's full shape: the graphs of the training driver
(train/graphs.py, train/loop.py) are keyed on it.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Sequence

import numpy as np
import torch


class TransposeOverflowError(ValueError):
    """A batch's two-tier transpose overflow exceeded ``over_cap``.

    ``over_cap`` is sized statistically (``overflow_cap``), so a shuffled
    tail batch can exceed it; ``batch_iterator`` catches this type and
    splits the batch, direct ``pack_graphs`` callers see the raise.
    """


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
    # geometry, kept by ``featurize_structure(keep_geometry=True)``: the
    # raw wire (data/rawbatch.py) plans its caps from the lattices and
    # turns such a graph back into wire form
    positions: np.ndarray | None = None  # [N, 3] f32 cartesian, wrapped
    lattice: np.ndarray | None = None  # [3, 3] f32 row vectors
    offsets: np.ndarray | None = None  # [E, 3] i32 periodic image of j
    numbers: np.ndarray | None = None  # [N] i32 atomic numbers
    forces: np.ndarray | None = None  # [N, 3] f32 per-atom force labels

    @property
    def num_nodes(self) -> int:
        return len(self.atom_fea)

    @property
    def num_edges(self) -> int:
        return len(self.centers)


_TORCH_DTYPES = {np.float32: torch.float32, np.int32: torch.int32}
# the fields the port adds to the JAX package's batch struct: the COO
# gathers' transpose, which only the port's fixed-order backward reads
PORT_FIELDS = ("nbr_order", "nbr_offsets", "center_offsets")


@dataclasses.dataclass
class GraphBatch:
    """Fixed-capacity packed batch of graphs (tensors on one device)."""

    nodes: torch.Tensor  # [Ncap, D] f32
    edges: torch.Tensor  # [Ncap, M, G] f32 (dense) / [Ecap, G] (COO)
    centers: torch.Tensor  # [Ecap] i32 (receiving node slot)
    neighbors: torch.Tensor  # [Ecap] i32 (source node slot)
    node_graph: torch.Tensor  # [Ncap] i32 (graph slot of each node)
    node_mask: torch.Tensor  # [Ncap] f32 (1 = real)
    edge_mask: torch.Tensor  # [Ecap] f32
    graph_mask: torch.Tensor  # [Gcap] f32
    targets: torch.Tensor  # [Gcap, T] f32
    target_mask: torch.Tensor  # [Gcap, T] f32
    # geometry (from graphs featurized with keep_geometry, else zeros) and
    # the per-atom labels of the force task (zeros where a graph has none)
    positions: torch.Tensor  # [Ncap, 3] f32
    lattices: torch.Tensor  # [Gcap, 3, 3] f32
    edge_offsets: torch.Tensor  # [Ecap, 3] f32
    node_targets: torch.Tensor  # [Ncap, 3] f32
    # transpose of the neighbor gather (``transpose_slots``): read only by
    # a backward pass, so a forward-only batch leaves them None
    in_slots: torch.Tensor | None = None  # [Ncap * In] i32, flat
    in_mask: torch.Tensor | None = None  # [Ncap, In] u8
    over_slots: torch.Tensor | None = None  # [O] i32 overflow edge slots
    over_nodes: torch.Tensor | None = None  # [O] i32, non-decreasing
    over_mask: torch.Tensor | None = None  # [O] u8
    # COO: the endpoint gathers' transpose (``coo_transpose``), read only
    # by a backward pass: the edge slots in stable neighbor order, and
    # each node's first position in that order and in the sorted centers
    nbr_order: torch.Tensor | None = None  # [Ecap] i32
    nbr_offsets: torch.Tensor | None = None  # [Ncap + 1] i32
    center_offsets: torch.Tensor | None = None  # [Ncap + 1] i32

    @property
    def graph_capacity(self) -> int:
        return self.targets.shape[0]

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        """A copy with every tensor on ``device`` (``non_blocking``: an
        asynchronous copy on the current stream where the source allows)."""
        return GraphBatch(**{
            f.name: (None if (v := getattr(self, f.name)) is None
                     else v.to(device, non_blocking=non_blocking))
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
    coo_transpose: bool = False,
    pin: bool = False,
    edge_dtype=torch.float32,
) -> GraphBatch:
    """Concatenate graphs into one fixed-capacity GraphBatch.

    ``dense_m=M`` selects the dense slot layout: node slot ``n`` owns edge
    slots ``[n*M, (n+1)*M)`` (its real edges first, masked self-loop
    padding after), so ``edge_cap == node_cap * M``. ``dense_m=None`` is
    the flat COO layout: ``edges`` stays [edge_cap, G], the real edges
    fill the first slots in center order, and padding edges point at node
    slot ``node_cap - 1`` (``centers = neighbors = node_cap - 1``, mask
    0); then the edge count is a capacity too. Padding nodes belong to
    graph slot 0 and are masked.

    ``in_cap`` additionally fills the single-tier transpose of the
    neighbor gather (``in_slots``/``in_mask`` at width ``in_cap``);
    ``over_cap`` selects the two-tier transpose instead: tier 1 at width
    ``dense_m`` plus a node-sorted overflow list of capacity ``over_cap``,
    whose overrun raises ``TransposeOverflowError`` and never truncates.
    Both need the dense layout. ``coo_transpose`` fills the COO layout's
    counterpart (``nbr_order``, ``nbr_offsets``, ``center_offsets``, from
    ``csr_transpose``), which the endpoint gathers' fixed-order backward
    reads (ops/segment.py ``gather_fixed_order``).

    ``pin`` packs into page-locked host memory (a CUDA build of torch),
    so that a ``non_blocking`` copy to the card runs asynchronously.
    PyTorch's caching host allocator hands a freed block out again only
    once the copies that read it have completed, so a batch needs no pool
    or fence of its own: drop it after its copy is queued.

    ``edge_dtype`` is the edge features' storage type: ``torch.bfloat16``
    for a bf16 model (train.py's ``edge_dtype``). numpy has no bf16 here,
    so the edges are packed in f32 and cast once, at the end, into a bf16
    tensor (page-locked under ``pin``), rounding to nearest even as
    ``astype(bfloat16)`` does.
    """
    if edge_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"edge_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {edge_dtype}")
    cast_edges = edge_dtype != torch.float32
    if in_cap is not None and over_cap is not None:
        raise ValueError("in_cap (single-tier) and over_cap (two-tier) are "
                         "mutually exclusive")
    if (in_cap is not None or over_cap is not None) and dense_m is None:
        raise ValueError("transpose slots require the dense layout "
                         "(dense_m)")
    if coo_transpose and dense_m is not None:
        raise ValueError("coo_transpose requires the COO layout")
    if not graphs:
        raise ValueError("cannot pack an empty graph list")
    if dense_m is not None and edge_cap != node_cap * dense_m:
        raise ValueError(
            f"dense layout requires edge_cap == node_cap * dense_m "
            f"({node_cap} * {dense_m} != {edge_cap})"
        )
    n_graphs = len(graphs)
    total_nodes = sum(g.num_nodes for g in graphs)
    total_edges = sum(g.num_edges for g in graphs)
    if n_graphs > graph_cap or total_nodes > node_cap or (
            dense_m is None and total_edges > edge_cap):
        raise ValueError(
            f"batch ({n_graphs} graphs, {total_nodes} nodes, {total_edges} edges)"
            f" exceeds capacity ({graph_cap}, {node_cap}, {edge_cap})"
        )
    node_dim = graphs[0].atom_fea.shape[1]
    edge_dim = graphs[0].edge_fea.shape[1]
    tdim = num_targets or int(np.atleast_1d(graphs[0].target).shape[0])
    pinned: dict = {}  # id(array) -> the page-locked tensor it views

    def zeros(shape, dtype):
        if not pin:
            return np.zeros(shape, dtype)
        t = torch.zeros(shape, dtype=_TORCH_DTYPES[dtype], pin_memory=True)
        a = t.numpy()
        pinned[id(a)] = t
        return a

    nodes = zeros((node_cap, node_dim), np.float32)
    # f32 edges that are cast at the end need no page-locked memory
    edges = (np.zeros((edge_cap, edge_dim), np.float32) if cast_edges
             else zeros((edge_cap, edge_dim), np.float32))
    centers = zeros(edge_cap, np.int32)
    if dense_m is None:
        # COO: padding edges point at the last node slot, so centers stay
        # sorted and their masked zero messages land on a padding node
        centers[:] = node_cap - 1
    else:
        # slot k belongs to node k // M; padding slots are masked
        # self-loops on their owning node (centers stay sorted)
        np.floor_divide(np.arange(edge_cap, dtype=np.int32), dense_m,
                        out=centers)
    neighbors = zeros(edge_cap, np.int32)
    neighbors[:] = centers
    node_graph = zeros(node_cap, np.int32)
    node_mask = zeros(node_cap, np.float32)
    edge_mask = zeros(edge_cap, np.float32)
    graph_mask = zeros(graph_cap, np.float32)
    targets = zeros((graph_cap, tdim), np.float32)
    target_mask = zeros((graph_cap, tdim), np.float32)
    positions = zeros((node_cap, 3), np.float32)
    lattices = zeros((graph_cap, 3, 3), np.float32)
    edge_offsets = zeros((edge_cap, 3), np.float32)
    node_targets = zeros((node_cap, 3), np.float32)

    nn_arr = np.fromiter((g.num_nodes for g in graphs), np.int64, n_graphs)
    ne_arr = np.fromiter((g.num_edges for g in graphs), np.int64, n_graphs)
    node_offs = np.zeros(n_graphs + 1, np.int64)
    np.cumsum(nn_arr, out=node_offs[1:])
    edge_offs = np.zeros(n_graphs + 1, np.int64)
    np.cumsum(ne_arr, out=edge_offs[1:])

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

    if dense_m is None:
        slots = np.arange(total_edges)
        edges[:total_edges] = efea
        edge_mask[:total_edges] = 1.0
        centers[:total_edges] = gcent.astype(np.int32)
    else:
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
        # edge k's within-center rank, then slot (center, rank); the grid
        # is filled by gather from the sorted edges plus a sentinel zero row
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
        if g.positions is not None:
            positions[node_offs[gi]:node_offs[gi + 1]] = g.positions
        if g.lattice is not None:
            lattices[gi] = g.lattice
        if g.offsets is not None and g.num_edges:
            # this graph's edges in the batch's (center-sorted) order
            o = g.offsets if order is None else g.offsets[
                np.argsort(g.centers, kind="stable")]
            edge_offsets[slots[edge_offs[gi]:edge_offs[gi + 1]]] = o
        if g.forces is not None:
            node_targets[node_offs[gi]:node_offs[gi + 1]] = g.forces
        t = np.atleast_1d(np.asarray(g.target, np.float32))
        targets[gi, : len(t)] = t
        target_mask[gi, : len(t)] = (
            1.0 if g.target_mask is None
            else np.broadcast_to(np.atleast_1d(g.target_mask), (len(t),)))

    in_slots = in_mask = over_slots = over_nodes = over_mask = None
    if in_cap is not None or over_cap is not None:
        in_slots, in_mask, over_slots, over_nodes, over_mask = (
            transpose_slots(neighbors, edge_mask > 0, node_cap, dense_m,
                            in_cap, over_cap))
    nbr_order = nbr_offsets = center_offsets = None
    if coo_transpose:
        nbr_order, nbr_offsets = csr_transpose(neighbors, node_cap)
        _, center_offsets = csr_transpose(centers, node_cap,
                                          indices_sorted=True)

    def as_t(a):
        if a is None:
            return None
        if id(a) in pinned:
            return pinned[id(a)]
        t = torch.from_numpy(a)
        # the mappings made above: small, copied into page-locked memory
        return t.pin_memory() if pin else t

    if cast_edges:
        edges_t = torch.empty((edge_cap, edge_dim), dtype=edge_dtype,
                              pin_memory=pin)
        edges_t.copy_(torch.from_numpy(edges))
    else:
        edges_t = as_t(edges)
    return GraphBatch(
        nodes=as_t(nodes),
        edges=(edges_t if dense_m is None
               else edges_t.view(node_cap, dense_m, edge_dim)),
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
        in_slots=as_t(in_slots),
        in_mask=as_t(in_mask),
        over_slots=as_t(over_slots),
        over_nodes=as_t(over_nodes),
        over_mask=as_t(over_mask),
        nbr_order=as_t(nbr_order),
        nbr_offsets=as_t(nbr_offsets),
        center_offsets=as_t(center_offsets),
    )


def csr_transpose(indices: np.ndarray, num_rows: int,
                  indices_sorted: bool = False) -> tuple:
    """The gather ``values[indices]``'s transpose as a CSR list: (the
    positions of ``indices`` in stable sorted order, i32, or None when
    ``indices_sorted``; the [num_rows + 1] i32 offsets of each row's run
    in that order). Row r's positions are ``order[offsets[r]:offsets[r +
    1]]``, in increasing position."""
    offsets = np.zeros(num_rows + 1, np.int32)
    np.cumsum(np.bincount(indices, minlength=num_rows), out=offsets[1:])
    if indices_sorted:
        return None, offsets
    return np.argsort(indices, kind="stable").astype(np.int32), offsets


def transpose_slots(
    neighbors: np.ndarray,
    edge_real: np.ndarray,
    node_cap: int,
    dense_m: int,
    in_cap: int | None,
    over_cap: int | None,
) -> tuple:
    """Transpose of the neighbor gather: the real edge slots grouped by
    their neighbor node, for a scatter-free backward
    (ops/segment.py ``gather_transpose``).

    ``neighbors`` [Ecap] i32, ``edge_real`` [Ecap] bool. Returns
    ``(in_slots, in_mask, over_slots, over_nodes, over_mask)``, the last
    three ``None`` unless ``over_cap`` selects the two-tier layout. Node
    j's k-th incoming edge (in slot order) sits at ``in_slots[j*In + k]``
    for k below the tier width; padding entries point at slot 0, masked.
    Two-tier: the edges of rank >= ``dense_m`` go to the overflow list in
    neighbor order, padded with masked entries on the last node slot so
    ``over_nodes`` stays non-decreasing.
    """
    real = np.nonzero(edge_real)[0]
    nb = neighbors[real]
    counts = np.bincount(nb, minlength=node_cap)
    order = np.argsort(nb, kind="stable")
    tier = dense_m if over_cap is not None else in_cap
    if over_cap is None and len(real) and counts.max() > tier:
        raise ValueError(
            f"a node has in-degree {counts.max()} > in_cap={in_cap}; "
            f"size in_cap with in_degree_cap(graphs)")
    real_sorted = real[order].astype(np.int32)
    starts = np.cumsum(counts) - counts
    src = starts[:, None] + np.arange(tier)
    tier_valid = np.arange(tier) < counts[:, None]
    np.copyto(src, len(real), where=~tier_valid)
    pad = np.concatenate([real_sorted, np.zeros(1, np.int32)])
    in_slots = np.take(pad, src.ravel(), mode="clip")
    in_mask = tier_valid.astype(np.uint8)
    over_slots = over_nodes = over_mask = None
    if over_cap is not None:
        rank = np.arange(len(real)) - starts.repeat(counts)
        sel = rank >= tier
        k = int(sel.sum())
        if k > over_cap:
            raise TransposeOverflowError(
                f"batch has {k} transpose-overflow edges > over_cap="
                f"{over_cap}; size over_cap with overflow_cap(graphs)")
        over_slots = np.zeros(over_cap, np.int32)
        over_nodes = np.full(over_cap, node_cap - 1, np.int32)
        over_mask = np.zeros(over_cap, np.uint8)
        over_slots[:k] = real_sorted[sel]
        over_nodes[:k] = nb[order][sel]
        over_mask[:k] = 1
    return in_slots, in_mask, over_slots, over_nodes, over_mask


def _in_degrees(g: CrystalGraph) -> np.ndarray:
    return np.bincount(g.neighbors, minlength=g.num_nodes)


def batch_shape_key(batch) -> tuple:
    """Hashable key of a batch's full shape, equal to the JAX package's
    ``batch_shape_key`` for the same batch: nodes', edges' and the
    transpose slots' shapes and the edge dtype's name (a compact batch:
    ``data.compact.compact_shape_key``). Shapes are plain int tuples."""
    if hasattr(batch, "atom_idx"):  # CompactBatch (duck-typed: no cycle)
        from cgnn_tpu_torch.data.compact import compact_shape_key

        return compact_shape_key(batch)

    def shape(t):
        return None if t is None else tuple(int(d) for d in t.shape)

    return (
        shape(batch.nodes),
        shape(batch.edges),
        str(batch.edges.dtype).replace("torch.", ""),
        shape(batch.in_slots),
        shape(batch.over_slots),
    )


def max_in_degree(graphs: Sequence[CrystalGraph]) -> int:
    """Largest per-node incoming-edge count over ``graphs``. In-degree is
    not bounded by ``max_num_nbr``: one atom can be among the nearest of
    many."""
    return max((int(_in_degrees(g).max()) if g.num_edges else 0
                for g in graphs), default=0)


def in_degree_cap(graphs: Sequence[CrystalGraph]) -> int:
    """Single-tier transpose-slot capacity: max in-degree, 8-aligned."""
    return max(8, -(-max_in_degree(graphs) // 8) * 8)


def overflow_cap(graphs: Sequence[CrystalGraph], graph_cap: int,
                 dense_m: int) -> int:
    """Capacity of the two-tier overflow list for batches of up to
    ``graph_cap`` of these graphs: graph_cap x the mean per-graph overflow
    (sum over nodes of max(in-degree - M, 0)) + 3 sigma x sqrt(graph_cap),
    at least the largest single graph's, 8-aligned."""
    per_graph = np.asarray([
        int(np.maximum(_in_degrees(g) - dense_m, 0).sum())
        if g.num_edges else 0
        for g in graphs
    ], np.float64)
    need = (graph_cap * per_graph.mean()
            + 3.0 * per_graph.std() * np.sqrt(graph_cap))
    return _align8(int(max(need, per_graph.max(), 8)))


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


def count_batches(
    graphs: Sequence[CrystalGraph],
    batch_size: int,
    node_cap: int,
    edge_cap: int,
    snug: bool = False,
) -> int:
    """The number of batches ``batch_iterator`` yields, without packing
    (its close condition, mirrored exactly)."""
    graph_cap = graph_cap_for(batch_size) if snug else batch_size
    count, in_bucket, nn, ne = 0, 0, 0, 0
    for g in graphs:
        if in_bucket and (
            in_bucket == graph_cap
            or nn + g.num_nodes > node_cap
            or ne + g.num_edges > edge_cap
        ):
            count += 1
            in_bucket, nn, ne = 0, 0, 0
        in_bucket += 1
        nn += g.num_nodes
        ne += g.num_edges
    return count + (1 if in_bucket else 0)


def assign_size_buckets(graphs: Sequence[CrystalGraph],
                        n_buckets: int) -> np.ndarray:
    """Bucket index per graph by node-count quantiles ([len(graphs)]
    int64)."""
    sizes = np.array([g.num_nodes for g in graphs])
    if n_buckets <= 1:
        return np.zeros(len(graphs), np.int64)
    cuts = np.quantile(sizes, np.linspace(0, 1, n_buckets + 1)[1:-1])
    return np.searchsorted(cuts, sizes, side="left")


def plan_batches(graphs: Sequence[CrystalGraph], batch_size: int,
                 node_cap: int, edge_cap: int, snug: bool = False):
    """Yield ``(start, end)`` index spans over ``graphs`` with
    ``batch_iterator``'s close condition exactly (no shuffle), packing
    nothing; an oversize graph raises as ``batch_iterator`` does."""
    graph_cap = graph_cap_for(batch_size) if snug else batch_size
    start, nn, ne = 0, 0, 0
    for i, g in enumerate(graphs):
        if g.num_nodes > node_cap or g.num_edges > edge_cap:
            raise ValueError(
                f"graph {g.cif_id!r} ({g.num_nodes} nodes, {g.num_edges} "
                f"edges) exceeds batch capacity ({node_cap}, {edge_cap}); "
                f"increase caps or filter the dataset")
        if i > start and (
            i - start == graph_cap
            or nn + g.num_nodes > node_cap
            or ne + g.num_edges > edge_cap
        ):
            yield start, i
            start, nn, ne = i, 0, 0
        nn += g.num_nodes
        ne += g.num_edges
    if start < len(graphs):
        yield start, len(graphs)


def _pack_overflow_safe(bucket, node_cap, edge_cap, graph_cap, dense_m,
                        in_cap, over_cap, pack_fn=None, **kw):
    """``pack_fn`` (default ``pack_graphs``; ``kw``, its further
    keywords), splitting the batch in half (same capacities, so the same
    shapes) when it overruns the two-tier ``over_cap``. A single graph
    that overruns it re-raises."""
    try:
        yield (pack_fn or pack_graphs)(
            bucket, node_cap, edge_cap, graph_cap, dense_m=dense_m,
            in_cap=in_cap, over_cap=over_cap, **kw)
    except TransposeOverflowError:
        if len(bucket) < 2:
            raise
        warnings.warn(
            f"batch of {len(bucket)} graphs exceeded over_cap={over_cap}; "
            f"splitting it in half", stacklevel=2)
        mid = len(bucket) // 2
        for half in (bucket[:mid], bucket[mid:]):
            yield from _pack_overflow_safe(half, node_cap, edge_cap,
                                           graph_cap, dense_m, in_cap,
                                           over_cap, pack_fn, **kw)


def batch_iterator(
    graphs: Sequence[CrystalGraph],
    batch_size: int,
    node_cap: int,
    edge_cap: int,
    shuffle: bool = False,
    rng: np.random.Generator | None = None,
    drop_last: bool = False,
    dense_m: int | None = None,
    in_cap: int | None = None,
    snug: bool = False,
    over_cap: int | None = None,
    pack_fn=None,
):
    """Yield GraphBatches of one shape (node_cap, edge_cap, graph_cap),
    packed on the host (``pack_fn``: another packer with ``pack_graphs``'
    keywords, e.g. ``data.compact.compact_pack_fn``).

    A batch closes when it holds ``graph_cap`` graphs or the next graph
    would overflow a capacity. ``snug=True`` is fill-to-capacity packing:
    ``graph_cap = graph_cap_for(batch_size)``, so capacity, not the graph
    count, closes a batch. ``shuffle`` permutes the graph order with
    ``rng``. ``drop_last`` drops a tail of fewer than ``batch_size``
    graphs.

    Transpose slots (dense layout): ``in_cap=None`` (default) packs the
    two-tier transpose with ``overflow_cap`` (unless ``over_cap`` is
    given), ``in_cap > 0`` the single-tier one, ``in_cap=0`` none (eval
    batches, which run no backward). ``dense_m=None`` packs the flat COO
    layout, with its gathers' transpose (``coo_transpose``) unless
    ``in_cap=0``.
    """
    graph_cap = graph_cap_for(batch_size) if snug else batch_size
    # COO training batches: the gathers' transpose (only then, so another
    # packer, e.g. the dense-only compact one, never sees the keyword)
    kw = ({"coo_transpose": True} if dense_m is None and in_cap is None
          else {})
    if dense_m is not None and in_cap is None and over_cap is None:
        over_cap = overflow_cap(graphs, graph_cap, dense_m)
    if in_cap is not None:
        over_cap = None
    in_cap = in_cap or None
    order = np.arange(len(graphs))
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    bucket: list[CrystalGraph] = []
    nn = ne = 0
    for idx in order:
        g = graphs[int(idx)]
        if g.num_nodes > node_cap or g.num_edges > edge_cap:
            raise ValueError(
                f"graph {g.cif_id!r} ({g.num_nodes} nodes, {g.num_edges} "
                f"edges) exceeds batch capacity ({node_cap}, {edge_cap}); "
                f"increase caps or filter the dataset")
        if bucket and (
            len(bucket) == graph_cap
            or nn + g.num_nodes > node_cap
            or ne + g.num_edges > edge_cap
        ):
            yield from _pack_overflow_safe(bucket, node_cap, edge_cap,
                                           graph_cap, dense_m, in_cap,
                                           over_cap, pack_fn, **kw)
            bucket, nn, ne = [], 0, 0
        bucket.append(g)
        nn += g.num_nodes
        ne += g.num_edges
    if bucket and (not drop_last or len(bucket) >= batch_size):
        yield from _pack_overflow_safe(bucket, node_cap, edge_cap, graph_cap,
                                       dense_m, in_cap, over_cap, pack_fn,
                                       **kw)


def bucketed_batch_iterator(
    graphs: Sequence[CrystalGraph],
    batch_size: int,
    n_buckets: int,
    shuffle: bool = False,
    rng: np.random.Generator | None = None,
    dense_m: int | None = None,
    in_cap: int | None = None,
    snug: bool = True,
    pack_fn=None,
):
    """Batches with one capacity per size class (the JAX
    ``bucketed_batch_iterator``, snug packing): graphs split into
    ``n_buckets`` node-count classes (``assign_size_buckets``), each
    batched at its own snug capacities, so at most ``n_buckets`` batch
    shapes. Under ``shuffle`` the classes interleave by weighted random
    picks (weights: each class's graph count), drawn from ``rng`` in the
    JAX order; else class by class. Dense training batches carry the
    two-tier transpose with ONE overflow capacity, sized by the worst
    class, so equal class shapes stay equal; ``in_cap`` as in
    ``batch_iterator``."""
    if not snug:
        raise NotImplementedError(
            "only snug packing is ported (the headroom/ladder capacities "
            "wait for ROADMAP Queue 1, item 10)")
    rng = rng or np.random.default_rng()
    bucket_of = assign_size_buckets(graphs, n_buckets)
    over_cap = None
    if dense_m is not None and in_cap is None:
        gcap = graph_cap_for(batch_size)
        over_cap = max(
            overflow_cap([graphs[int(i)]
                          for i in np.nonzero(bucket_of == b)[0]],
                         gcap, dense_m)
            for b in range(int(bucket_of.max()) + 1)
            if np.any(bucket_of == b))
    iters, weights = [], []
    for b in range(int(bucket_of.max()) + 1):
        idxs = np.nonzero(bucket_of == b)[0]
        if len(idxs) == 0:
            continue
        sub = [graphs[int(i)] for i in idxs]
        nc, ec = capacities_for(sub, batch_size, dense_m=dense_m)
        iters.append(batch_iterator(sub, batch_size, nc, ec, shuffle=shuffle,
                                    rng=rng, dense_m=dense_m, in_cap=in_cap,
                                    snug=True, over_cap=over_cap,
                                    pack_fn=pack_fn))
        weights.append(float(len(idxs)))
    active = list(range(len(iters)))
    w = np.array(weights)
    while active:
        if shuffle and len(active) > 1:
            p = w[active] / w[active].sum()
            pick = int(rng.choice(active, p=p))
        else:
            pick = active[0]
        try:
            yield next(iters[pick])
        except StopIteration:
            active.remove(pick)
