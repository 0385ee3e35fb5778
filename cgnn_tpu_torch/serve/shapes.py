"""The serving shape ladder (``cgnn_tpu/serve/shapes.py``).

A small fixed ladder of (graph_cap, node_cap, edge_cap) rungs is quantized
once from a calibration sample; the micro-batcher packs every flush into
the smallest rung that fits. PyTorch runs eagerly, so the ladder buys no
compile cache here — it bounds the shapes the kernels see and keeps the
rungs equal to the JAX package's for the same calibration sample.

With a ``CompactSpec`` (data/compact.py) ``pack`` stages the compact form
(atoms and distances; the expander rebuilds the batch on the device) and
``pack_full`` the full one, for a request that cannot stage compactly.

With a :class:`RawSpec` the set also stages wire-form structures: a rung's
raw batch holds ``graph_cap`` structure slots of ``snode_cap`` atoms, and
the raw expander (ops/neighbor_search.py) builds the graph on the device.

``dense_m=None`` is the flat COO layout: a graph consumes its true edge
count of a rung's edge capacity, so rungs are picked by edges as well as
nodes, and there is no raw wire (the device search builds dense slots).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from cgnn_tpu_torch.data.compact import (
    CompactBatch,
    CompactSpec,
    alloc_compact_buffers,
    compact_buffer_key,
    make_expander,
    pack_compact,
)
from cgnn_tpu_torch.data.graph import (
    CrystalGraph,
    GraphBatch,
    _align8,
    capacities_for,
    graph_cap_for,
    pack_graphs,
)
from cgnn_tpu_torch.data.rawbatch import (
    RawBatch,
    RawSpec,
    RawStructure,
    pack_raw,
)


@dataclasses.dataclass(frozen=True, order=True)
class BatchShape:
    """One batch shape (capacities, not contents)."""

    graph_cap: int
    node_cap: int
    edge_cap: int

    def fits(self, n_graphs: int, n_nodes: int, n_edges: int) -> bool:
        return (
            n_graphs <= self.graph_cap
            and n_nodes <= self.node_cap
            and n_edges <= self.edge_cap
        )

    def to_meta(self) -> dict:
        return dataclasses.asdict(self)


class ShapeSet:
    """An ascending ladder of :class:`BatchShape` rungs plus the packing
    parameters every rung shares (edge layout, target width, the compact
    and raw specs)."""

    def __init__(self, shapes: Sequence[BatchShape], *,
                 dense_m: int | None = None, num_targets: int = 1,
                 compact: CompactSpec | None = None,
                 raw: RawSpec | None = None):
        if not shapes:
            raise ValueError("a ShapeSet needs at least one shape")
        self.shapes = tuple(sorted(set(shapes)))
        self.dense_m = dense_m
        self.num_targets = num_targets
        self.compact = compact
        if compact is not None and dense_m is None:
            raise ValueError("compact staging requires the dense layout "
                             "(dense_m)")
        self.raw = raw
        if raw is not None:
            if dense_m is None:
                raise ValueError("raw wire requires the dense layout "
                                 "(dense_m)")
            if raw.dense_m != dense_m:
                raise ValueError(
                    f"raw spec max_num_nbr {raw.dense_m} != layout dense_m "
                    f"{dense_m} (the device truncation must match the "
                    f"model's slot layout)")
        for s in self.shapes:
            if dense_m is not None and s.edge_cap != s.node_cap * dense_m:
                raise ValueError(
                    f"dense layout requires edge_cap == node_cap * dense_m "
                    f"for every rung; {s} violates it (dense_m={dense_m})"
                )

    def __len__(self) -> int:
        return len(self.shapes)

    def __iter__(self):
        return iter(self.shapes)

    @property
    def largest(self) -> BatchShape:
        return self.shapes[-1]

    def graph_counts(self, graph: CrystalGraph) -> tuple[int, int]:
        """(nodes, edge slots) one graph consumes: the dense layout takes
        ``nodes * dense_m`` edge slots whatever the true edge count, COO
        its true edges."""
        if self.dense_m is None:
            return graph.num_nodes, graph.num_edges
        return graph.num_nodes, graph.num_nodes * self.dense_m

    def admits(self, graph: CrystalGraph) -> bool:
        """Does one graph fit the largest rung on its own?"""
        n, e = self.graph_counts(graph)
        return self.largest.fits(1, n, e)

    def oversize_detail(self, graph: CrystalGraph) -> str:
        n, e = self.graph_counts(graph)
        big = self.largest
        return (
            f"structure has {n} nodes / {e} edge slots; the largest "
            f"shape holds {big.node_cap} nodes / {big.edge_cap} edge slots"
        )

    def shape_for(self, n_graphs: int, n_nodes: int,
                  n_edges: int) -> BatchShape | None:
        """Smallest rung fitting the given totals (None = nothing fits)."""
        for s in self.shapes:
            if s.fits(n_graphs, n_nodes, n_edges):
                return s
        return None

    def _resolve(self, graphs: Sequence[CrystalGraph],
                 shape: BatchShape | None) -> BatchShape:
        """``shape``, or the smallest rung that fits ``graphs``."""
        if shape is None:
            n = sum(g.num_nodes for g in graphs)
            e = sum(self.graph_counts(g)[1] for g in graphs)
            shape = self.shape_for(len(graphs), n, e)
            if shape is None:
                raise ValueError(
                    f"{len(graphs)} graphs ({n} nodes) fit no shape in "
                    f"{self.shapes}")
        return shape

    def pack(self, graphs: Sequence[CrystalGraph],
             shape: BatchShape | None = None,
             out: CompactBatch | None = None) -> GraphBatch | CompactBatch:
        """Pack into ``shape`` (default: the smallest rung that fits): the
        compact form with a compact spec (``out``: a pooled staging
        buffer, see ``buffer_factory``), else the full one."""
        if self.compact is None:
            return self.pack_full(graphs, shape)
        shape = self._resolve(graphs, shape)
        return pack_compact(list(graphs), shape.node_cap, shape.edge_cap,
                            shape.graph_cap, self.compact,
                            num_targets=self.num_targets,
                            dense_m=self.dense_m, out=out)

    def pack_full(self, graphs: Sequence[CrystalGraph],
                  shape: BatchShape | None = None) -> GraphBatch:
        """Full-fidelity pack into ``shape`` (default: the smallest rung
        that fits), without transpose slots, whatever the compact spec:
        the form of a request that cannot stage compactly."""
        shape = self._resolve(graphs, shape)
        return pack_graphs(
            list(graphs), shape.node_cap, shape.edge_cap, shape.graph_cap,
            num_targets=self.num_targets, dense_m=self.dense_m,
        )

    def compactable(self, graph: CrystalGraph) -> bool:
        """Can this graph stage compactly under the set's spec? False
        without one; never raises (the serving admission probe)."""
        return (self.compact is not None
                and self.compact.graph_compactable(graph))

    def expander(self, device="cuda"):
        """CompactBatch -> GraphBatch on ``device`` for this set's compact
        spec (None without one): hand it to
        ``train.step.make_predict_step(expander=...)``."""
        if self.compact is None:
            return None
        return make_expander(self.compact, device)

    def buffer_key(self, shape: BatchShape) -> tuple:
        """Staging-buffer pool key of one rung (compact sets only)."""
        if self.compact is None:
            raise ValueError("buffer pooling applies to compact staging")
        return compact_buffer_key(shape.node_cap, self.dense_m,
                                  shape.graph_cap, self.num_targets)

    def buffer_factory(self, shape: BatchShape, pin: bool = False):
        """() -> fresh staging buffers for one rung (the BufferPool
        factory); ``pin`` for a CUDA target."""
        if self.compact is None:
            raise ValueError("buffer pooling applies to compact staging")
        return lambda: alloc_compact_buffers(
            shape.node_cap, self.dense_m, shape.graph_cap, self.num_targets,
            pin=pin)

    def raw_expander(self, impl: str = "pallas", device="cuda"):
        """RawBatch -> (GraphBatch, overflow, n_edges) for this set's raw
        spec, its constants on ``device`` (None without a spec): hand it
        to ``train.step.make_predict_step(raw_expander=...)``. ``impl``:
        see ``ops.neighbor_search.neighbor_search``."""
        if self.raw is None:
            return None
        from cgnn_tpu_torch.ops.neighbor_search import make_raw_expander

        return make_raw_expander(self.raw, impl=impl, device=device)

    def admits_raw(self, rs: RawStructure) -> bool:
        """Host pre-check: can this wire-form structure stage raw? False
        without a raw spec; never raises. False routes the request to the
        featurized wire, not to a rejection."""
        return self.raw is not None and self.raw.admits(rs)

    def pack_raw(self, items: Sequence[RawStructure],
                 shape: BatchShape | None = None) -> RawBatch:
        """Stage wire-form structures into one rung's RawBatch (default:
        the smallest rung whose graph slots fit them)."""
        if self.raw is None:
            raise ValueError("this shape set carries no raw spec")
        if shape is None:
            shape = next((s for s in self.shapes
                          if len(items) <= s.graph_cap), None)
            if shape is None:
                raise ValueError(
                    f"{len(items)} structures fit no rung's graph slots")
        return pack_raw(list(items), shape.graph_cap, self.raw,
                        num_targets=self.num_targets)

    def to_meta(self) -> dict:
        return {"shapes": [s.to_meta() for s in self.shapes],
                "dense_m": self.dense_m, "num_targets": self.num_targets,
                "compact": self.compact is not None,
                "raw": None if self.raw is None else self.raw.to_meta()}


def plan_shape_set(
    calibration: Sequence[CrystalGraph],
    batch_size: int,
    *,
    rungs: int = 3,
    dense_m: int | None = None,
    num_targets: int | None = None,
    compact: CompactSpec | None = None,
    raw: RawSpec | None = None,
) -> ShapeSet:
    """Quantize a serving ladder from a calibration sample.

    The top rung is the snug full-batch shape (``capacities_for``
    at ``batch_size`` with ``graph_cap_for`` slack); each lower rung halves
    the graph budget and scales node capacity proportionally (8-aligned),
    floored so that ANY calibration-sized structure fits EVERY rung.
    ``compact`` adds compact staging (``data.compact.CompactSpec.build``),
    ``raw`` the raw wire (``data.rawbatch.plan_raw_spec``).
    """
    if not len(calibration):
        raise ValueError("shape planning needs a calibration sample")
    if rungs < 1:
        raise ValueError(f"rungs must be >= 1, got {rungs}")
    node_cap, edge_cap = capacities_for(calibration, batch_size,
                                        dense_m=dense_m)
    max_nodes = max(g.num_nodes for g in calibration)
    max_edges = max(g.num_edges for g in calibration)
    if num_targets is None:
        num_targets = int(np.atleast_1d(calibration[0].target).shape[0])
    shapes = []
    for r in range(rungs):
        scale = 2**r
        b = max(1, math.ceil(batch_size / scale))
        nc = _align8(max(math.ceil(node_cap / scale), max_nodes))
        if dense_m is not None:
            ec = nc * dense_m
        else:
            ec = _align8(max(math.ceil(edge_cap / scale), max_edges))
        shapes.append(BatchShape(graph_cap_for(b), nc, ec))
    return ShapeSet(shapes, dense_m=dense_m, num_targets=num_targets,
                    compact=compact, raw=raw)
