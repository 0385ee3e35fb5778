"""Batch invariant checks (``cgnn_tpu/data/invariants.py``), plain numpy.

The steps trust invariants that are set at pack time and never checked
again: sorted centers (the sorted segment sums, kernel 6), the dense
slot ownership, the transpose slots' completeness (the scatter-free
backward), and the port's COO transpose (``nbr_order``,
``nbr_offsets``, ``center_offsets``: the fixed-order gathers' backward).
A corrupted batch (a bug in an iterator, a bad cache file) would train
silently wrong; these checks are the loud path. ``enable()`` (the train
entry point's ``--check-invariants``) turns on validation of every
packed batch where the iterators yield it, of the epoch driver's input
batches before they are staged, of bulk predict's packers, and of the
cache on load. ``check_batch`` and the rest can be called directly.

The checks read host copies only (a tensor on the card is refused, so a
check never adds a device sync) and raise ``BatchInvariantError`` (an
AssertionError) on exactly the batches the JAX package's checks raise
on; where those use chex's shape and type assertions, these raise the
same error type with the shape named.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_ENABLED = False


def enable(on: bool = True) -> None:
    """Globally enable per-batch validation (``--check-invariants``)."""
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


class BatchInvariantError(AssertionError):
    pass


def _fail(msg: str):
    raise BatchInvariantError(msg)


def _np(x) -> np.ndarray:
    """A host numpy view of a CPU tensor or array (bf16 read as f32)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError("invariant checks read host copies; got a "
                             f"tensor on {x.device}")
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _shape(x: np.ndarray, shape: tuple, name: str) -> None:
    if x.shape != shape:
        _fail(f"{name} has shape {x.shape}, expected {shape}")


def check_batch(batch, dense_m: int | None = None):
    """Validate one host GraphBatch; raises BatchInvariantError.

    - shape and dtype consistency across fields;
    - masks are exactly {0, 1};
    - ``centers`` is non-decreasing and every real edge's endpoints are
      real, in-range node slots;
    - padding edges carry zero mask AND zero features;
    - ``node_graph`` is non-decreasing with real nodes pointing at real
      graph slots;
    - dense layout: slot ownership centers[k] == k // M (``dense_m`` is
      read off [N, M, G] edges when not given);
    - transpose slots: ``in_slots``/``in_mask`` (+ overflow) list every
      real edge slot exactly once under its neighbor node;
    - COO transpose: ``nbr_order``/``nbr_offsets``/``center_offsets`` are
      the stable CSR transposes of ``neighbors`` and ``centers``.
    """
    if dense_m is None and batch.edges.dim() == 3:
        dense_m = int(batch.edges.shape[1])
    nodes = _np(batch.nodes)
    edges = _np(batch.edges)
    edges = edges.reshape(-1, edges.shape[-1]) if edges.ndim == 3 else edges
    centers = _np(batch.centers)
    neighbors = _np(batch.neighbors)
    node_graph = _np(batch.node_graph)
    node_mask = _np(batch.node_mask)
    edge_mask = _np(batch.edge_mask)
    graph_mask = _np(batch.graph_mask)

    ncap, ecap = nodes.shape[0], edges.shape[0]
    _shape(centers, (ecap,), "centers")
    _shape(neighbors, (ecap,), "neighbors")
    _shape(edge_mask, (ecap,), "edge_mask")
    _shape(node_graph, (ncap,), "node_graph")
    _shape(node_mask, (ncap,), "node_mask")
    for name, x in (("centers", centers), ("neighbors", neighbors),
                    ("node_graph", node_graph)):
        if not np.issubdtype(x.dtype, np.integer):
            _fail(f"{name} has dtype {x.dtype}, expected an integer type")

    for name, m in (("node_mask", node_mask), ("edge_mask", edge_mask),
                    ("graph_mask", graph_mask)):
        if not np.isin(m, (0.0, 1.0)).all():
            _fail(f"{name} contains values outside {{0, 1}}")

    if np.any(np.diff(centers) < 0):
        _fail("centers is not non-decreasing (sorted-scatter promise broken)")
    if centers.min(initial=0) < 0 or centers.max(initial=0) >= ncap:
        _fail("centers out of node-slot range")
    if neighbors.min(initial=0) < 0 or neighbors.max(initial=0) >= ncap:
        _fail("neighbors out of node-slot range")

    real_e = edge_mask > 0
    if real_e.any():
        if not node_mask[centers[real_e]].all():
            _fail("a real edge's center is a padding node")
        if not node_mask[neighbors[real_e]].all():
            _fail("a real edge's neighbor is a padding node")
    if np.any(np.abs(edges[~real_e]) > 0):
        _fail("padding edge slots carry nonzero features")

    real_n = node_mask > 0
    if not np.all(np.diff(node_mask) <= 0):
        _fail("real nodes are not a contiguous prefix of the node slots")
    if np.any(np.diff(node_graph[real_n]) < 0):
        _fail("node_graph is not non-decreasing over real nodes")
    if np.any(node_graph[~real_n] != 0):
        _fail("padding nodes must belong to graph slot 0")
    if real_n.any() and not graph_mask[node_graph[real_n]].all():
        _fail("a real node belongs to a padding graph slot")

    if dense_m is not None:
        owner = np.arange(ecap) // dense_m
        if not np.array_equal(centers, owner.astype(centers.dtype)):
            _fail(f"dense slot ownership broken: centers != slot//{dense_m}")

    if batch.in_slots is not None:
        _check_transpose_mapping(batch, neighbors, real_e, ncap)
    if getattr(batch, "nbr_order", None) is not None:
        _check_coo_transpose(batch, centers, neighbors, ncap)
    return batch


def _check_transpose_mapping(batch, neighbors, real_e, ncap):
    """The transpose slots' completeness (flat ``neighbors`` [E] and
    ``real_e`` [E] bool), shared by GraphBatch and CompactBatch: every
    real edge slot listed exactly once, under its neighbor's row, in the
    tier-1 slots or the node-sorted overflow list. A per-shard stack
    (``in_mask`` [S, N, tier], node-strip graph sharding) is read shard
    by shard, each shard's local slots moved to their global ids: each
    shard lists its own strip's real edges, and the union is held to the
    same rule."""

    def collect(in_slots, in_mask, over, slot_range, offset, tag):
        if in_mask.shape[0] != ncap:
            _fail(f"{tag}in_slots/in_mask row count != node capacity")
        lst = in_slots.reshape(in_mask.shape)[in_mask > 0]
        if lst.size and (lst.min() < 0 or lst.max() >= slot_range):
            _fail(f"{tag}transpose mapping lists a slot outside its range "
                  f"[0, {slot_range})")
        parts = [lst + offset]
        rows = [np.repeat(np.arange(ncap), (in_mask > 0).sum(axis=1))]
        if over is not None:
            osl, ond, omk = over
            _shape(ond, osl.shape, "over_nodes")
            _shape(omk, osl.shape, "over_mask")
            if np.any(np.diff(ond) < 0):
                _fail(f"{tag}over_nodes is not non-decreasing "
                      f"(sorted-scatter promise broken)")
            sel = omk > 0
            if sel.any() and (osl[sel].min() < 0
                              or osl[sel].max() >= slot_range):
                _fail(f"{tag}overflow lists a slot outside its range")
            parts.append(osl[sel] + offset)
            rows.append(ond[sel])
        return parts, rows

    in_mask = _np(batch.in_mask)
    over_all = (None if batch.over_slots is None
                else (_np(batch.over_slots), _np(batch.over_nodes),
                      _np(batch.over_mask)))
    if in_mask.ndim == 3:
        n_sh = in_mask.shape[0]
        if len(real_e) % n_sh:
            _fail("sharded transpose mapping: edge capacity not divisible "
                  "by the shard count")
        e_s = len(real_e) // n_sh
        in_slots = _np(batch.in_slots).reshape(n_sh, -1)
        parts, rows = [], []
        for s in range(n_sh):
            p, r = collect(in_slots[s], in_mask[s],
                           None if over_all is None
                           else tuple(x[s] for x in over_all),
                           e_s, s * e_s, f"shard {s} ")
            parts += p
            rows += r
    else:
        parts, rows = collect(_np(batch.in_slots), in_mask, over_all,
                              len(real_e), 0, "")
    listed = np.concatenate(parts)
    rows = np.concatenate(rows)
    if listed.size != int(real_e.sum()):
        _fail(
            f"transpose mapping lists {listed.size} edges but the batch "
            f"has {int(real_e.sum())} real edges (the scatter-free "
            f"backward would drop/duplicate gradient)")
    if listed.size:
        if np.unique(listed).size != listed.size:
            _fail("transpose mapping lists an edge slot twice")
        if not real_e[listed].all():
            _fail("transpose mapping lists a padding edge slot")
        if not np.array_equal(np.sort(listed), np.nonzero(real_e)[0]):
            _fail("transpose mapping misses a real edge slot")
        if not np.array_equal(neighbors[listed], rows):
            _fail("a transpose row lists an edge of a different neighbor")


def _check_coo_transpose(batch, centers, neighbors, ncap):
    """The port's COO gathers' transpose (``pack_graphs(coo_transpose=
    True)``): ``nbr_order`` the stable sort of every edge slot by its
    neighbor, ``nbr_offsets``/``center_offsets`` each node's first
    position in the neighbor order and in the sorted centers."""
    order = _np(batch.nbr_order)
    _shape(order, neighbors.shape, "nbr_order")
    for name, idx in (("nbr_offsets", neighbors),
                      ("center_offsets", centers)):
        offsets = _np(getattr(batch, name))
        _shape(offsets, (ncap + 1,), name)
        want = np.concatenate(
            [[0], np.cumsum(np.bincount(idx, minlength=ncap))])
        if not np.array_equal(offsets, want):
            _fail(f"{name} disagrees with the edge slots' "
                  f"{'neighbors' if idx is neighbors else 'centers'}")
    if not np.array_equal(order, np.argsort(neighbors, kind="stable")):
        _fail("nbr_order is not the stable neighbor order of the edge "
              "slots (the fixed-order gathers' backward would misroute)")


def check_compact_batch(batch, dense_m: int | None = None):
    """Validate a CompactBatch (data/compact.py): the raw-form analog of
    ``check_batch``, mask and range checks on the raw payload, and the
    transpose slots' completeness check shared verbatim."""
    atom_idx = _np(batch.atom_idx)
    distances = _np(batch.distances)
    neighbors = _np(batch.neighbors)
    node_graph = _np(batch.node_graph)
    node_mask = _np(batch.node_mask)
    edge_mask = _np(batch.edge_mask)
    graph_mask = _np(batch.graph_mask)
    ncap, m = distances.shape
    if dense_m is not None and dense_m != m:
        _fail(f"compact batch packed with M={m} but dense_m={dense_m} "
              f"expected")
    _shape(atom_idx, (ncap,), "atom_idx")
    _shape(neighbors, (ncap * m,), "neighbors")
    _shape(edge_mask, (ncap, m), "edge_mask")
    _shape(node_mask, (ncap,), "node_mask")
    for name, msk in (("node_mask", node_mask), ("edge_mask", edge_mask),
                      ("graph_mask", graph_mask)):
        if not np.isin(msk, (0, 1)).all():
            _fail(f"{name} contains values outside {{0, 1}}")
    if atom_idx.min(initial=0) < 0:
        _fail("negative atom vocabulary index")
    if neighbors.min(initial=0) < 0 or neighbors.max(initial=0) >= ncap:
        _fail("neighbors out of node-slot range")
    real_e = edge_mask > 0
    if not node_mask[neighbors.reshape(ncap, m)[real_e]].all():
        _fail("a real edge's neighbor is a padding node")
    if np.any(real_e & ~(node_mask > 0)[:, None]):
        _fail("a padding node owns a real edge slot")
    if np.any(distances[~real_e] != 0):
        _fail("padding edge slots carry nonzero distances")
    if not np.isfinite(distances).all():
        _fail("non-finite distances")
    real_n = node_mask > 0
    if not np.all(np.diff(node_mask.astype(np.int8)) <= 0):
        _fail("real nodes are not a contiguous prefix of the node slots")
    if np.any(np.diff(node_graph[real_n]) < 0):
        _fail("node_graph is not non-decreasing over real nodes")
    if real_n.any() and not graph_mask[node_graph[real_n]].all():
        _fail("a real node belongs to a padding graph slot")
    if batch.in_slots is not None:
        _check_transpose_mapping(batch, neighbors, real_e.reshape(-1), ncap)
    return batch


def _checker(batch):
    return check_compact_batch if hasattr(batch, "atom_idx") else check_batch


def maybe_check(batch, dense_m: int | None = None):
    """The batch's check when globally enabled, else pass-through."""
    if _ENABLED:
        _checker(batch)(batch, dense_m)
    return batch


def check_stacked_batch(stacked, dense_m: int | None = None,
                        train: bool = False):
    """Validate a stacked batch ([D, ...] tensors, the epoch driver's
    staging) row by row. ``train=True`` also requires every row to carry
    at least one real graph: an all-padding row is eval-only padding,
    and in a training step its zero gradients and degenerate statistics
    would dilute the step."""
    n_rows = int(stacked.node_mask.shape[0])
    checker = _checker(stacked)
    for d in range(n_rows):
        row = dataclasses.replace(stacked, **{
            f.name: v[d] for f in dataclasses.fields(stacked)
            if (v := getattr(stacked, f.name)) is not None})
        checker(row, dense_m)
        if train and float(_np(row.graph_mask).sum()) == 0:
            _fail(
                f"device row {d} of a TRAINING batch has zero real graphs "
                f"(empty rows are eval-only padding; training on one "
                f"dilutes the gradient)")
    return stacked


def check_any(batch, dense_m: int | None = None, train: bool = False):
    """Dispatch on stacking: 1-D node_mask -> one batch, 2-D -> stacked.
    ``train`` adds the training rule: at least one real graph in the
    batch (in every row of a stack). An all-padding batch
    (``parallel.empty_batch_like``) pads eval steps only: in a training
    step its zero gradients would dilute the average and its statistics
    the running ones."""
    if batch.node_mask.dim() != 1:
        return check_stacked_batch(batch, dense_m, train=train)
    _checker(batch)(batch, dense_m)
    if train and float(_np(batch.graph_mask).sum()) == 0:
        _fail("a TRAINING batch has zero real graphs (empty batches are "
              "eval-only padding; training on one dilutes the gradient)")
    return batch


def maybe_check_any(batch, dense_m: int | None = None, train: bool = False):
    if _ENABLED:
        check_any(batch, dense_m, train=train)
    return batch


def spot_check_graphs(graphs, k: int = 16):
    """Sample-validate CrystalGraphs (the cache's reload: a bad or
    truncated file would otherwise surface as silent training
    corruption). Checks ``k`` evenly spaced graphs: index ranges, row
    counts, finite features and labels."""
    if not graphs:
        _fail("empty graph list")
    idx = np.unique(np.linspace(0, len(graphs) - 1, num=min(k, len(graphs)),
                                dtype=np.int64))
    for i in idx:
        g = graphs[int(i)]
        n, e = g.num_nodes, g.num_edges
        if len(g.edge_fea) != e or len(g.neighbors) != e:
            _fail(f"graph {g.cif_id!r}: edge array row counts disagree")
        if e:
            c, nb = np.asarray(g.centers), np.asarray(g.neighbors)
            if c.min() < 0 or c.max() >= n or nb.min() < 0 or nb.max() >= n:
                _fail(f"graph {g.cif_id!r}: edge endpoints out of range")
        if not np.isfinite(np.asarray(g.atom_fea)).all():
            _fail(f"graph {g.cif_id!r}: non-finite atom features")
        if not np.isfinite(np.asarray(g.edge_fea)).all():
            _fail(f"graph {g.cif_id!r}: non-finite edge features")
        if not np.isfinite(np.asarray(g.target, np.float64)).all():
            _fail(f"graph {g.cif_id!r}: non-finite target")
    return graphs


def maybe_spot_check_graphs(graphs, k: int = 16):
    if _ENABLED:
        spot_check_graphs(graphs, k)
    return graphs
