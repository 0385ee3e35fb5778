"""Compact staging: stage atoms and distances, featurize on the device
(``cgnn_tpu/data/compact.py``).

A packed ``GraphBatch`` stages ~2.2 KB a node, mostly the [N, M, G]
Gaussian edge features and the [N, 92] atom rows. Both are functions of
little data: atom rows are rows of a small per-dataset vocabulary table,
and edge features are a fixed radial basis of the scalar distance.
``CompactBatch`` stages that little data (~180 B a node, about 12x less)
and ``make_expander`` rebuilds the ``GraphBatch`` on the batch's device:
a table gather, the masked Gaussian ``exp``, the ``centers`` arange.

Dense slot layout only (``dense_m``). Packing writes numpy views of the
batch's tensors, so a pooled buffer (``alloc_compact_buffers``, pinned
for a CUDA target) is reused without a fresh allocation; the caller hands
it back to its pool only once the device has read it (train/infer.py,
serve/server.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from cgnn_tpu_torch.data.featurize import gaussian_expand
from cgnn_tpu_torch.data.graph import GraphBatch, transpose_slots


class CompactUnsupported(ValueError):
    """The data cannot be staged compactly (continuous atom features, no
    raw distances, or edge features that are not the Gaussian expansion of
    the stored distances)."""


class AtomVocab:
    """Per-dataset vocabulary of distinct atom-feature rows.

    The rows are recovered from the data (hash rows, dedupe), not assumed,
    so any featurizer works; data with more than ``max_size`` distinct rows
    (continuous atom features) raises ``CompactUnsupported``. A row's hash
    is a float dot product whose last bits depend on the graph it is
    computed in, so the table can hold one row twice; the port hashes
    graph by graph exactly as the JAX package does, which keeps its
    indices bit-equal to the JAX package's.
    """

    def __init__(self, table: np.ndarray, hash_vec: np.ndarray,
                 hash_order: np.ndarray):
        self.table = table  # [V, D] f32
        self._hash_vec = hash_vec
        self._sorted_hashes = hash_order  # sorted row hashes, index-aligned

    @classmethod
    def build(cls, graphs: Sequence, max_size: int = 4096) -> "AtomVocab":
        rng = np.random.default_rng(0x5EED)
        dim = graphs[0].atom_fea.shape[1]
        hv = rng.standard_normal(dim)
        seen: dict[float, np.ndarray] = {}
        for g in graphs:
            h = np.asarray(g.atom_fea, np.float64) @ hv
            # cached on the graph: ``indices`` reuses these at pack time
            g._vocab_hashes = h
            for hh in np.unique(h):
                if hh not in seen:
                    seen[float(hh)] = np.asarray(
                        g.atom_fea[np.argmax(h == hh)], np.float32)
                    if len(seen) > max_size:
                        raise CompactUnsupported(
                            f"more than {max_size} distinct atom-feature "
                            f"rows; atom features look continuous — use "
                            f"full-fidelity staging")
        hashes = np.array(sorted(seen))
        table = np.stack([seen[float(h)] for h in hashes])
        return cls(table, hv, hashes)

    @property
    def size(self) -> int:
        return len(self.table)

    def indices(self, g) -> np.ndarray:
        """[N] i32 vocabulary index per atom (cached on the graph, keyed
        to this vocabulary: a graph packed under two vocabularies, as by
        two servers of one process, must not read one's indices into the
        other's table); a row the table does not reproduce exactly (a hash
        collision, another featurizer) raises ``CompactUnsupported``."""
        cached = getattr(g, "_vocab_idx", None)
        if cached is not None and cached[0] is self:
            return cached[1]
        h = getattr(g, "_vocab_hashes", None)
        if h is None:
            h = np.asarray(g.atom_fea, np.float64) @ self._hash_vec
        idx = np.searchsorted(self._sorted_hashes, h).astype(np.int32)
        if (idx.max(initial=0) >= self.size
                or not np.array_equal(
                    self.table[idx], np.asarray(g.atom_fea, np.float32))):
            raise CompactUnsupported(
                f"graph {g.cif_id!r} has atom rows outside the "
                f"vocabulary (hash collision or mixed featurizers)")
        g._vocab_idx = (self, idx)
        if hasattr(g, "_vocab_hashes"):
            del g._vocab_hashes
        return idx


@dataclasses.dataclass(frozen=True)
class CompactSpec:
    """What the expander needs to rebuild GraphBatches on the device."""

    vocab: AtomVocab
    gauss_filter: np.ndarray  # [G] f32 mu grid
    gauss_var: float
    dense_m: int
    # the expanded edge features' type: bf16 for a bf16 model
    edge_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        # identity token for per-graph probe verdicts: a verdict cached
        # under one spec is never read by another
        object.__setattr__(self, "_probe_token", object())

    def compactable_many(self, graphs: Sequence, atol: float = 1e-5,
                         sample_edges: int = 32) -> list[bool]:
        """Can each graph be staged compactly under this spec? Raw
        distances present, atom rows inside the vocabulary, and an evenly
        spaced sample of ``sample_edges`` stored edge-feature rows equal
        (``np.isclose``, ``atol``) to the Gaussian expansion of their
        distances, so a graph whose ``edge_fea`` disagrees with its
        ``distances`` is staged full instead of answered from other edges.
        Verdicts are cached on the graphs, keyed to this spec; the graphs
        not probed before share one vectorized pass. Never raises."""
        out = [None] * len(graphs)
        cand = []
        for i, g in enumerate(graphs):
            cached = getattr(g, "_compact_ok", None)
            if cached is not None and cached[0] is self._probe_token:
                out[i] = cached[1]
                continue
            out[i] = False
            try:
                if (g.distances is not None
                        and len(g.distances) == g.num_edges
                        and np.ndim(g.edge_fea) == 2
                        and g.edge_fea.shape[1] == len(self.gauss_filter)):
                    cand.append(i)
            except (TypeError, ValueError, AttributeError):
                pass
        cand = [i for i in cand if self._in_vocab(graphs[i])]
        if cand:
            d_parts, f_parts, owner, kept = [], [], [], []
            for i in cand:
                g = graphs[i]
                n = len(g.distances)
                pick = np.arange(0, n, max(1, n // sample_edges))[
                    :sample_edges]
                try:
                    d = np.asarray(g.distances, np.float32)[pick]
                    f = np.asarray(g.edge_fea, np.float32)[pick]
                except (TypeError, ValueError, IndexError):
                    continue
                d_parts.append(d)
                f_parts.append(f)
                owner.append(np.full(len(pick), len(kept)))
                kept.append(i)
            cand = kept
        if cand:
            want = gaussian_expand(np.concatenate(d_parts),
                                   self.gauss_filter, self.gauss_var)
            close = np.isclose(np.concatenate(f_parts), want,
                               atol=atol).all(axis=1)
            bad = np.bincount(np.concatenate(owner)[~close],
                              minlength=len(cand))
            for k, i in enumerate(cand):
                out[i] = bool(bad[k] == 0)
        for g, ok in zip(graphs, out):
            try:
                g._compact_ok = (self._probe_token, ok)
            except AttributeError:  # a slotted graph: no cache
                pass
        return out

    def _in_vocab(self, g) -> bool:
        try:
            self.vocab.indices(g)
        except (CompactUnsupported, ValueError, TypeError):
            return False
        return True

    def graph_compactable(self, g, atol: float = 1e-5,
                          sample_edges: int = 32) -> bool:
        """``compactable_many`` for one graph."""
        return self.compactable_many([g], atol, sample_edges)[0]

    @classmethod
    def build(cls, graphs: Sequence, gdf, dense_m: int,
              edge_dtype=torch.float32,
              validate_k: int = 8) -> "CompactSpec":
        """Probe a dataset for compact staging. ``gdf`` is the
        GaussianDistance believed to have featurized it; ``validate_k``
        graphs are re-expanded and compared with their stored edge
        features, so a cache featurized with other parameters raises
        ``CompactUnsupported`` instead of staging other edges."""
        if not graphs:
            raise CompactUnsupported("empty graph list")
        if any(g.distances is None for g in graphs):
            raise CompactUnsupported(
                "graphs carry no raw distances (old cache format?)")
        step = max(1, len(graphs) // validate_k)
        for g in graphs[::step][:validate_k]:
            want = np.asarray(g.edge_fea, np.float32)
            got = gdf.expand(g.distances)
            if want.shape != got.shape or not np.allclose(want, got,
                                                          atol=1e-5):
                raise CompactUnsupported(
                    f"graph {g.cif_id!r}: edge features do not match the "
                    f"Gaussian expansion of stored distances (dataset "
                    f"featurized with different radius/step?)")
        vocab = AtomVocab.build(graphs)
        return cls(vocab, np.asarray(gdf.filter, np.float32),
                   float(gdf.var), int(dense_m), edge_dtype)


@dataclasses.dataclass
class CompactBatch:
    """Raw-form packed batch (dense slot layout): tensors on one device.

    The slot geometry of the GraphBatch ``make_expander`` rebuilds: node
    slot ``n`` owns edge slots ``[n*M, (n+1)*M)``, masks zero on padding,
    transpose slots as ``pack_graphs`` gives them.
    """

    atom_idx: torch.Tensor  # [Ncap] i32 vocabulary row per node
    distances: torch.Tensor  # [Ncap, M] f32 (0 on padding slots)
    neighbors: torch.Tensor  # [Ncap*M] i32 (padding: own node)
    edge_mask: torch.Tensor  # [Ncap, M] u8
    node_graph: torch.Tensor  # [Ncap] i32
    node_mask: torch.Tensor  # [Ncap] u8
    graph_mask: torch.Tensor  # [Gcap] f32
    targets: torch.Tensor  # [Gcap, T] f32
    target_mask: torch.Tensor  # [Gcap, T] f32
    in_slots: torch.Tensor | None = None  # [Ncap*M] i32 (two-tier tier 1)
    in_mask: torch.Tensor | None = None  # [Ncap, M] u8
    over_slots: torch.Tensor | None = None  # [O] i32
    over_nodes: torch.Tensor | None = None  # [O] i32
    over_mask: torch.Tensor | None = None  # [O] u8

    # the GraphBatch interface PaddingStats reads
    @property
    def node_capacity(self) -> int:
        return self.atom_idx.shape[0]

    @property
    def edge_capacity(self) -> int:
        return self.distances.shape[0] * self.distances.shape[1]

    def tensors(self) -> list[torch.Tensor]:
        return [v for f in dataclasses.fields(self)
                if (v := getattr(self, f.name)) is not None]

    def to(self, device, non_blocking: bool = False) -> "CompactBatch":
        """A copy with every tensor on ``device`` (``non_blocking``: an
        asynchronous copy from pinned memory, on the current stream)."""
        return CompactBatch(**{
            f.name: (None if (v := getattr(self, f.name)) is None
                     else v.to(device, non_blocking=non_blocking))
            for f in dataclasses.fields(self)
        })

    def numpy(self) -> dict:
        """{field: host numpy copy or None}, for comparisons."""
        return {f.name: (None if (v := getattr(self, f.name)) is None
                         else v.detach().cpu().numpy())
                for f in dataclasses.fields(self)}


def compact_shape_key(batch: CompactBatch) -> tuple:
    """Hashable full-shape key of a compact batch."""
    return (
        "compact",
        tuple(batch.distances.shape),
        tuple(batch.targets.shape),
        None if batch.in_slots is None else tuple(batch.in_slots.shape),
        None if batch.over_slots is None else tuple(batch.over_slots.shape),
    )


def compact_buffer_key(node_cap: int, dense_m: int, graph_cap: int,
                       tdim: int) -> tuple:
    """Pool key of reusable compact staging buffers (data/pipeline.py
    ``BufferPool``): one free list per buffer geometry."""
    return ("compact", node_cap, dense_m, graph_cap, tdim)


def alloc_compact_buffers(node_cap: int, dense_m: int, graph_cap: int,
                          tdim: int, pin: bool = False) -> CompactBatch:
    """One fresh forward-only (no transpose slots) compact staging buffer
    set, the ``BufferPool`` factory for ``pack_compact(out=...)``.
    ``pin``: page-locked host memory, for asynchronous copies to a CUDA
    device (it needs one: a CPU-only build refuses to pin)."""

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, pin_memory=pin)

    return CompactBatch(
        atom_idx=z(node_cap, torch.int32),
        distances=z((node_cap, dense_m), torch.float32),
        neighbors=z(node_cap * dense_m, torch.int32),
        edge_mask=z((node_cap, dense_m), torch.uint8),
        node_graph=z(node_cap, torch.int32),
        node_mask=z(node_cap, torch.uint8),
        graph_mask=z(graph_cap, torch.float32),
        targets=z((graph_cap, tdim), torch.float32),
        target_mask=z((graph_cap, tdim), torch.float32),
    )


def _base_neighbors(node_cap: int, dense_m: int) -> np.ndarray:
    """The dense self-loop pattern: slot k belongs to node k // M."""
    return (np.arange(node_cap * dense_m, dtype=np.int32)
            // dense_m).astype(np.int32)


def pack_compact(
    graphs: Sequence,
    node_cap: int,
    edge_cap: int,
    graph_cap: int,
    spec: CompactSpec,
    num_targets: int | None = None,
    dense_m: int | None = None,
    in_cap: int | None = None,
    over_cap: int | None = None,
    out: CompactBatch | None = None,
) -> CompactBatch:
    """``pack_graphs``' compact twin: the same slot geometry, the raw-form
    payload, bit-equal to the JAX package's ``pack_compact``. Two-tier
    overflow raises ``TransposeOverflowError``, as ``pack_graphs`` does.

    ``out`` (forward-only batches) is a buffer set from
    ``alloc_compact_buffers`` written in place through numpy views: the
    returned batch ALIASES ``out``'s tensors, so hand the buffer back to
    its pool only after the device has read it. Bit-identical to a fresh
    pack.
    """
    dense_m = dense_m if dense_m is not None else spec.dense_m
    if dense_m is None:
        raise ValueError("compact staging requires the dense layout")
    if edge_cap != node_cap * dense_m:
        raise ValueError(
            f"dense layout requires edge_cap == node_cap * dense_m "
            f"({node_cap} * {dense_m} != {edge_cap})")
    if not graphs:
        raise ValueError("cannot pack an empty graph list")
    if out is not None and (in_cap or over_cap is not None):
        raise ValueError("buffer reuse (out=) is forward-only: transpose "
                         "slots are not pooled")
    n_graphs = len(graphs)
    if n_graphs > graph_cap:
        raise ValueError(f"{n_graphs} graphs exceed graph_cap={graph_cap}")
    nn_arr = np.fromiter((g.num_nodes for g in graphs), np.int64, n_graphs)
    ne_arr = np.fromiter((g.num_edges for g in graphs), np.int64, n_graphs)
    node_offs = np.zeros(n_graphs + 1, np.int64)
    np.cumsum(nn_arr, out=node_offs[1:])
    total_nodes = int(node_offs[-1])
    total_edges = int(ne_arr.sum())
    if total_nodes > node_cap:
        raise ValueError(
            f"batch ({total_nodes} nodes) exceeds node_cap={node_cap}")
    tdim = num_targets or int(np.atleast_1d(graphs[0].target).shape[0])

    if out is not None:
        want = (node_cap, dense_m, graph_cap, tdim)
        got = (out.atom_idx.shape[0], out.distances.shape[1],
               out.targets.shape[0], out.targets.shape[1])
        if want != got:
            raise ValueError(
                f"out buffer geometry {got} does not match the requested "
                f"pack {want} (pool keyed by compact_buffer_key?)")
        # numpy views of the (possibly pinned) host tensors
        o = {f.name: getattr(out, f.name).numpy()
             for f in dataclasses.fields(out)
             if getattr(out, f.name) is not None}
        atom_idx, node_graph, node_mask = (o["atom_idx"], o["node_graph"],
                                           o["node_mask"])
        # only the padding tail needs zeroing: [:total_nodes] is
        # overwritten below
        atom_idx[total_nodes:] = 0
        node_graph[total_nodes:] = 0
        node_mask[total_nodes:] = 0
    else:
        atom_idx = np.zeros(node_cap, np.int32)
        node_graph = np.zeros(node_cap, np.int32)
        node_mask = np.zeros(node_cap, np.uint8)
    np.concatenate([spec.vocab.indices(g) for g in graphs],
                   out=atom_idx[:total_nodes])
    node_graph[:total_nodes] = np.repeat(
        np.arange(n_graphs, dtype=np.int32), nn_arr)
    node_mask[:total_nodes] = 1

    e_node_off = np.repeat(node_offs[:-1], ne_arr)
    gcent = np.concatenate([g.centers for g in graphs]).astype(np.int64)
    gcent += e_node_off
    gnbr = np.concatenate([g.neighbors for g in graphs]).astype(np.int64)
    gnbr += e_node_off
    dist = np.concatenate([g.distances for g in graphs]).astype(np.float32)
    if not np.all(gcent[1:] >= gcent[:-1]):
        order = np.argsort(gcent, kind="stable")
        gcent, gnbr, dist = gcent[order], gnbr[order], dist[order]

    counts = np.bincount(gcent, minlength=node_cap)
    worst = int(counts.max(initial=0))
    if worst > dense_m:
        bad = int(np.argmax(counts))
        gi = int(np.searchsorted(node_offs, bad, side="right")) - 1
        raise ValueError(
            f"graph {graphs[gi].cif_id!r} has a node with {worst} edges "
            f"> dense_m={dense_m}; featurize with max_num_nbr <= dense_m")
    within = np.arange(total_edges) - (np.cumsum(counts) - counts)[gcent]
    slots = gcent * dense_m + within
    starts = np.cumsum(counts) - counts
    src = starts[:, None] + np.arange(dense_m)
    grid_valid = np.arange(dense_m) < counts[:, None]
    np.copyto(src, total_edges, where=~grid_valid)
    dist_pad = np.concatenate([dist, np.zeros(1, np.float32)])
    if out is not None:
        distances, edge_mask, neighbors = (o["distances"], o["edge_mask"],
                                           o["neighbors"])
        # every slot of all three is overwritten: take covers the whole
        # [node_cap, M] grid, the mask copies it, neighbors resets to the
        # base pattern before the real edges are scattered in
        np.take(dist_pad, src, mode="clip", out=distances)
        np.copyto(edge_mask, grid_valid, casting="unsafe")
        np.copyto(neighbors, _base_neighbors(node_cap, dense_m))
    else:
        distances = np.take(dist_pad, src, mode="clip")  # [node_cap, M]
        edge_mask = grid_valid.astype(np.uint8)
        neighbors = _base_neighbors(node_cap, dense_m)
    neighbors[slots] = gnbr.astype(np.int32)

    if out is not None:
        graph_mask, targets, target_mask = (o["graph_mask"], o["targets"],
                                            o["target_mask"])
        graph_mask[n_graphs:] = 0.0
        targets.fill(0.0)  # ragged target widths: no full overwrite below
        target_mask.fill(0.0)
    else:
        graph_mask = np.zeros(graph_cap, np.float32)
        targets = np.zeros((graph_cap, tdim), np.float32)
        target_mask = np.zeros((graph_cap, tdim), np.float32)
    graph_mask[:n_graphs] = 1.0
    tgt = [np.atleast_1d(np.asarray(g.target, np.float32)) for g in graphs]
    if all(len(t) == len(tgt[0]) for t in tgt):
        tw = len(tgt[0])
        targets[:n_graphs, :tw] = np.stack(tgt)
        masks = [g.target_mask for g in graphs]
        if all(m is None for m in masks):
            target_mask[:n_graphs, :tw] = 1.0
        else:
            target_mask[:n_graphs, :tw] = np.stack([
                np.ones(tw, np.float32) if m is None
                else np.broadcast_to(np.atleast_1d(m), (tw,))
                for m in masks
            ])
    else:
        for gi, (g, t) in enumerate(zip(graphs, tgt)):
            targets[gi, : len(t)] = t
            if g.target_mask is not None:
                target_mask[gi, : len(t)] = np.atleast_1d(g.target_mask)
            else:
                target_mask[gi, : len(t)] = 1.0

    in_slots = in_mask = over_slots = over_nodes = over_mask = None
    if in_cap is not None and over_cap is not None:
        raise ValueError("in_cap and over_cap are mutually exclusive")
    if in_cap == 0:  # eval-only batches run no backward
        in_cap = None
    if in_cap is not None or over_cap is not None:
        in_slots, in_mask, over_slots, over_nodes, over_mask = (
            transpose_slots(neighbors, edge_mask.reshape(-1) > 0, node_cap,
                            dense_m, in_cap, over_cap))
    if out is not None:
        return out

    def as_t(a):
        return None if a is None else torch.from_numpy(a)

    return CompactBatch(
        atom_idx=as_t(atom_idx), distances=as_t(distances),
        neighbors=as_t(neighbors), edge_mask=as_t(edge_mask),
        node_graph=as_t(node_graph), node_mask=as_t(node_mask),
        graph_mask=as_t(graph_mask), targets=as_t(targets),
        target_mask=as_t(target_mask), in_slots=as_t(in_slots),
        in_mask=as_t(in_mask), over_slots=as_t(over_slots),
        over_nodes=as_t(over_nodes), over_mask=as_t(over_mask))


def make_expander(spec: CompactSpec, device="cuda"
                  ) -> Callable[[CompactBatch], GraphBatch]:
    """CompactBatch (on ``device``) -> the GraphBatch ``pack_graphs`` gives
    for the same graphs, built on the device: the vocabulary table's rows
    gathered and masked, the Gaussian expansion of the distances masked,
    the dense ``centers`` arange. Plain PyTorch.

    The expansion is ``pack_graphs``' formula, ``exp(-((d - mu)^2) /
    var^2)`` in f32; the device's ``exp`` is not numpy's, so the edge
    features agree within the reference's own bound (atol 2e-6), the rest
    bit for bit. Geometry fields come back None: the model does not read
    them. The features are cast to ``spec.edge_dtype`` last, on the
    device, as the JAX expander casts them (``compact.py:519``).
    """
    dev = torch.device(device)
    table = torch.from_numpy(np.asarray(spec.vocab.table, np.float32)).to(dev)
    mu = torch.from_numpy(np.asarray(spec.gauss_filter, np.float32)).to(dev)
    var2 = float(np.float32(spec.gauss_var) ** 2)
    edge_dtype = spec.edge_dtype

    def expand(cb: CompactBatch) -> GraphBatch:
        n, m = cb.distances.shape
        node_mask = cb.node_mask.to(torch.float32)
        nodes = table[cb.atom_idx] * node_mask[:, None]
        emask = cb.edge_mask.to(torch.float32)
        efea = torch.exp(-((cb.distances[..., None] - mu) ** 2) / var2)
        efea = (efea * emask[..., None]).to(edge_dtype)
        centers = torch.div(torch.arange(n * m, dtype=torch.int32,
                                         device=cb.distances.device),
                            m, rounding_mode="floor")
        return GraphBatch(
            nodes=nodes, edges=efea, centers=centers,
            neighbors=cb.neighbors, node_graph=cb.node_graph,
            node_mask=node_mask, edge_mask=emask.reshape(-1),
            graph_mask=cb.graph_mask, targets=cb.targets,
            target_mask=cb.target_mask, positions=None, lattices=None,
            edge_offsets=None, node_targets=None, in_slots=cb.in_slots,
            in_mask=cb.in_mask, over_slots=cb.over_slots,
            over_nodes=cb.over_nodes, over_mask=cb.over_mask)

    return expand


def compact_pack_fn(spec: CompactSpec) -> Callable:
    """``pack_graphs``' keyword signature over ``pack_compact`` (the
    ``batch_iterator``-style pack function)."""

    def pack(graphs, node_cap, edge_cap, graph_cap, **kw):
        return pack_compact(graphs, node_cap, edge_cap, graph_cap, spec, **kw)

    return pack
