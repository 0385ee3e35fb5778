"""Raw wire form: structures staged as (positions, lattice, species), with
the graph built on the device (``cgnn_tpu/data/rawbatch.py``).

The wire carries only what a structure is::

    positions [N, 3] f32 (fractional), lattice [3, 3] f32, species [N] i32

(~516 B for a 30-atom cell) and the host only copies slots: the periodic
radius search, the ``max_num_nbr`` truncation and the Gaussian
featurization run on the device (ops/neighbor_search.py), which emits the
dense-layout ``GraphBatch`` the model reads.

A :class:`RawBatch` holds ``graph_cap`` structure slots of ``snode_cap``
atom slots each: the search is per structure, so the block layout makes
it a dense candidate set per structure. The periodic image range is capped
per ladder (``RawSpec.images``), as a fixed lexicographic offset grid
calibrated from data.

Cap overflow: a structure whose lattice needs more periodic images than
the caps would lose true edges. The host pre-checks at admission
(``RawSpec.admits``, f64) and the device re-derives the needed counts from
the staged f32 lattice (``needed_images_f32``'s formula) and flags the
structure; a flagged structure is never answered from the truncated graph.

Parity with the host featurizer: the selected edges, their order (center,
then distance, then source atom, then lexicographic image), the masks and
the atom rows are exact; distances agree to f32 roundoff (the host search
runs in f64). ``raw_neighbor_graph_host`` is the numpy mirror of the
device arithmetic, used by tests only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Sequence

import numpy as np
import torch

from cgnn_tpu_torch.data.elements import MAX_Z


class RawUnsupported(ValueError):
    """The calibration sample cannot plan a raw wire spec: the caller
    serves the featurized wire only (a capability probe, not a failure)."""


@dataclasses.dataclass
class RawStructure:
    """One structure in wire form (host-side, f64; ``pack_raw`` casts to
    the f32 wire types)."""

    frac_coords: np.ndarray  # [N, 3] f64, any range (wrapped at pack)
    lattice: np.ndarray  # [3, 3] f64 row vectors
    numbers: np.ndarray  # [N] i32 atomic numbers
    target: np.ndarray | None = None  # [T] f32 (zeros when serving)
    cif_id: str = ""
    target_mask: np.ndarray | None = None

    def __post_init__(self):
        self.frac_coords = np.asarray(self.frac_coords,
                                      np.float64).reshape(-1, 3)
        self.lattice = np.asarray(self.lattice, np.float64).reshape(3, 3)
        self.numbers = np.asarray(self.numbers, np.int32).ravel()
        if len(self.numbers) != len(self.frac_coords):
            # checked here so every entry point fails this structure alone
            raise ValueError(
                f"{len(self.numbers)} species but "
                f"{len(self.frac_coords)} coordinate rows")

    @property
    def num_nodes(self) -> int:
        return len(self.numbers)

    @classmethod
    def from_structure(cls, s, target=None, cif_id: str = "",
                       target_mask=None) -> "RawStructure":
        return cls(s.frac_coords, s.lattice, s.numbers, target=target,
                   cif_id=cif_id or "", target_mask=target_mask)


def raw_from_graph(g) -> RawStructure | None:
    """A CrystalGraph featurized with ``keep_geometry`` -> wire form, or
    None without geometry. Fractional coordinates come back from the
    stored wrapped f32 cartesians, the fidelity a wire client ships."""
    if (getattr(g, "positions", None) is None
            or getattr(g, "lattice", None) is None
            or getattr(g, "numbers", None) is None):
        return None
    lat = np.asarray(g.lattice, np.float64)
    frac = np.asarray(g.positions, np.float64) @ np.linalg.inv(lat)
    return RawStructure(frac, lat, g.numbers, target=g.target,
                        cif_id=g.cif_id, target_mask=g.target_mask)


def raw_fingerprint(rs: RawStructure) -> str:
    """Content hash of the f32 wire encoding, ``raw:``-prefixed so it
    never collides with a featurized-array key (blake2b, 20 bytes)."""
    h = hashlib.blake2b(digest_size=20)
    for arr, dt in ((rs.frac_coords, np.float32),
                    (rs.lattice, np.float32),
                    (rs.numbers, np.int32)):
        a = np.ascontiguousarray(np.asarray(arr, dt))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return "raw:" + h.hexdigest()


def host_image_counts(lattice: np.ndarray, radius: float) -> tuple:
    """Needed periodic images per axis (f64: the admission pre-check)."""
    inv = np.linalg.inv(np.asarray(lattice, np.float64))
    return tuple(
        int(math.ceil(radius * np.linalg.norm(inv[:, k]) - 1e-12))
        for k in range(3)
    )


@dataclasses.dataclass(frozen=True)
class RawSpec:
    """What the device search needs: the atom slots per structure, the
    periodic image caps, and the featurization constants. Shared by every
    rung of a ladder (any admitted structure fits every rung); rung r
    holds ``graph_cap_r x snode_cap`` atom slots."""

    snode_cap: int  # atom slots per structure (S)
    images: tuple  # (na, nb, nc) periodic image caps per axis
    radius: float
    dense_m: int  # max_num_nbr == the dense layout's M
    gauss_filter: Any  # [G] f32 mu grid
    gauss_var: float

    @property
    def n_images(self) -> int:
        na, nb, nc = self.images
        return (2 * na + 1) * (2 * nb + 1) * (2 * nc + 1)

    def offsets_grid(self) -> np.ndarray:
        """[K, 3] i32 image offsets in lexicographic (ia, ib, ic) order,
        the canonical tie-break order."""
        na, nb, nc = self.images
        return (np.mgrid[-na:na + 1, -nb:nb + 1, -nc:nc + 1]
                .reshape(3, -1).T.astype(np.int32))

    @property
    def home_image(self) -> int:
        na, nb, nc = self.images
        return (na * (2 * nb + 1) + nb) * (2 * nc + 1) + nc

    def admits(self, rs: RawStructure) -> bool:
        """Host pre-check (f64): can this structure stage raw without the
        device search losing true edges? Never raises."""
        try:
            if rs.num_nodes < 1 or rs.num_nodes > self.snode_cap:
                return False
            z = rs.numbers
            if z.min(initial=1) < 1 or z.max(initial=1) > MAX_Z:
                return False
            need = host_image_counts(rs.lattice, self.radius)
        except (ValueError, np.linalg.LinAlgError):
            return False
        return all(n <= c for n, c in zip(need, self.images))

    def oversize_detail(self, rs: RawStructure) -> str:
        try:
            need = host_image_counts(rs.lattice, self.radius)
        except (ValueError, np.linalg.LinAlgError):
            need = ("?",) * 3
        return (
            f"structure has {rs.num_nodes} atoms (cap {self.snode_cap}) "
            f"and needs {need} periodic images (caps {self.images})"
        )

    def template(self) -> RawStructure:
        """A trivially admissible warm-up structure (one H atom, a cubic
        cell sized so one image per axis suffices)."""
        a = max(self.radius * 1.5, 1.0)
        return RawStructure(
            np.zeros((1, 3)), np.eye(3) * a, np.array([1], np.int32),
            target=np.zeros(1, np.float32), cif_id="raw-template",
        )

    def to_meta(self) -> dict:
        return {
            "snode_cap": self.snode_cap,
            "images": list(self.images),
            "radius": self.radius,
            "dense_m": self.dense_m,
            "gauss_len": int(len(self.gauss_filter)),
        }


def plan_raw_spec(
    calibration: Sequence,
    gdf,
    radius: float,
    dense_m: int,
    coverage: float = 0.95,
    image_margin: int = 0,
) -> RawSpec:
    """Calibrate a RawSpec from a sample of graphs or structures.

    The caps are the compute (S x S x K candidates per structure), so they
    cover the ``coverage`` quantile of the calibration, not its maximum:
    ``snode_cap`` the quantile atom count (8-aligned), ``images`` the
    per-axis quantile of the f64 needed-image counts (+``image_margin``,
    at least 1). Structures beyond them are not raw-admitted and ride the
    featurized path. Every item must carry a ``lattice`` (a graph
    featurized with ``keep_geometry``, a Structure or a RawStructure).
    """
    if not len(calibration):
        raise RawUnsupported("raw spec planning needs a calibration sample")
    if dense_m is None or dense_m < 1:
        raise RawUnsupported("raw wire requires the dense layout (dense_m)")
    lattices = [getattr(g, "lattice", None) for g in calibration]
    if any(la is None for la in lattices):
        raise RawUnsupported(
            "calibration sample carries no lattices (featurize with "
            "keep_geometry=True, or calibrate from structures)")
    need = np.stack([host_image_counts(la, radius) for la in lattices])
    q = min(max(float(coverage), 0.0), 1.0)
    caps = np.maximum(
        np.quantile(need, q, axis=0, method="higher"), 1
    ).astype(np.int64) + image_margin
    sizes = np.asarray([int(g.num_nodes) for g in calibration])
    snode = int(np.quantile(sizes, q, method="higher"))
    snode = max(8, -(-snode // 8) * 8)
    return RawSpec(
        snode_cap=snode,
        images=tuple(int(c) for c in caps),
        radius=float(radius),
        dense_m=int(dense_m),
        gauss_filter=np.asarray(gdf.filter, np.float32),
        gauss_var=float(gdf.var),
    )


@dataclasses.dataclass
class RawBatch:
    """Wire-form packed batch. Structure slot g owns atom slots
    ``[g*S, (g+1)*S)`` of the node space the device search emits. Padding
    structures carry an identity lattice and all-zero masks."""

    frac: torch.Tensor  # [Gcap, S, 3] f32, wrapped into [0, 1)
    lattices: torch.Tensor  # [Gcap, 3, 3] f32 (padding: eye)
    species: torch.Tensor  # [Gcap, S] i32 atomic number (padding: 0)
    atom_mask: torch.Tensor  # [Gcap, S] u8
    graph_mask: torch.Tensor  # [Gcap] f32
    targets: torch.Tensor  # [Gcap, T] f32
    target_mask: torch.Tensor  # [Gcap, T] f32

    def to(self, device, non_blocking: bool = False) -> "RawBatch":
        """A copy with every tensor on ``device`` (``non_blocking``: an
        asynchronous copy on the current stream where the source allows)."""
        return RawBatch(**{
            f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
            for f in dataclasses.fields(self)})

    def numpy(self) -> dict:
        """{field: host numpy copy}, for comparisons."""
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)}


def pack_raw(
    items: Sequence[RawStructure],
    graph_cap: int,
    spec: RawSpec,
    num_targets: int = 1,
) -> RawBatch:
    """Stage wire-form structures into one fixed-capacity RawBatch: wrap,
    cast and copy slots, no search and no featurization."""
    if not items:
        raise ValueError("cannot pack an empty structure list")
    if len(items) > graph_cap:
        raise ValueError(
            f"{len(items)} structures exceed graph_cap={graph_cap}")
    s_cap = spec.snode_cap
    frac = np.zeros((graph_cap, s_cap, 3), np.float32)
    lattices = np.zeros((graph_cap, 3, 3), np.float32)
    lattices[:] = np.eye(3, dtype=np.float32)  # padding-safe inverse
    species = np.zeros((graph_cap, s_cap), np.int32)
    atom_mask = np.zeros((graph_cap, s_cap), np.uint8)
    graph_mask = np.zeros(graph_cap, np.float32)
    targets = np.zeros((graph_cap, num_targets), np.float32)
    target_mask = np.zeros((graph_cap, num_targets), np.float32)
    for gi, rs in enumerate(items):
        n = rs.num_nodes
        if n > s_cap:
            raise ValueError(
                f"structure {rs.cif_id!r} has {n} atoms > snode_cap="
                f"{s_cap}; RawSpec.admits routes it to the featurized wire")
        f = rs.frac_coords % 1.0
        # tiny negatives give f == 1.0 exactly under %: enforce [0, 1)
        f = np.where(f >= 1.0, 0.0, f)
        frac[gi, :n] = f.astype(np.float32)
        lattices[gi] = rs.lattice.astype(np.float32)
        species[gi, :n] = rs.numbers
        atom_mask[gi, :n] = 1
        graph_mask[gi] = 1.0
        if rs.target is not None:
            t = np.atleast_1d(np.asarray(rs.target, np.float32))
            targets[gi, : len(t)] = t
            if rs.target_mask is not None:
                target_mask[gi, : len(t)] = np.atleast_1d(rs.target_mask)
            else:
                target_mask[gi, : len(t)] = 1.0
    return RawBatch(*(torch.from_numpy(a) for a in (
        frac, lattices, species, atom_mask, graph_mask, targets,
        target_mask)))


def needed_images_f32(lattice: np.ndarray, radius: float) -> np.ndarray:
    """[3] f32 needed-image counts from the f32 lattice, the formula the
    device re-derives: the plane spacing along axis k is |det| /
    ||a_{k+1} x a_{k+2}||, so needed_k = ceil(radius / spacing_k - 1e-4).
    The 1e-4 slack absorbs f32 roundoff at exact-integer boundaries."""
    a = np.asarray(lattice, np.float32)
    cross = np.stack([
        np.cross(a[1], a[2]), np.cross(a[2], a[0]), np.cross(a[0], a[1]),
    ]).astype(np.float32)
    det = np.abs(np.float32(np.dot(a[0], cross[0])))
    norms = np.sqrt((cross * cross).sum(axis=1))
    return np.ceil(np.float32(radius) * norms / det - np.float32(1e-4))


def raw_neighbor_graph_host(
    frac: np.ndarray,  # [S, 3] f32 wrapped (padding rows 0)
    lattice: np.ndarray,  # [3, 3] f32
    atom_mask: np.ndarray,  # [S] bool/u8
    spec: RawSpec,
) -> tuple:
    """Numpy mirror of ``ops.neighbor_search`` for one structure (tests
    only) -> (neighbors [S, M] i32 local, distances [S, M] f32, edge_mask
    [S, M] u8, n_edges int, overflow bool)."""
    s_cap, m = spec.snode_cap, spec.dense_m
    frac = np.asarray(frac, np.float32)
    lat = np.asarray(lattice, np.float32)
    mask = np.asarray(atom_mask).astype(bool)
    grid = spec.offsets_grid()
    k = len(grid)
    cart = frac @ lat  # [S, 3] f32
    shifts = grid.astype(np.float32) @ lat  # [K, 3]
    pos_j = cart[:, None, :] + shifts[None, :, :]  # [S, K, 3]
    diff = pos_j[None, :, :, :] - cart[:, None, None, :]  # [S, S, K, 3]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    d = np.sqrt(d2).reshape(s_cap, s_cap * k)  # candidate c = j*K + k
    valid = (mask[None, :, None] & mask[:, None, None]
             & np.ones((s_cap, s_cap, k), bool))
    eye = np.eye(s_cap, dtype=bool)[:, :, None] & (
        np.arange(k) == spec.home_image)[None, None, :]
    valid &= ~eye
    valid = valid.reshape(s_cap, s_cap * k)
    valid &= d <= np.float32(spec.radius)
    key = np.where(valid, d, np.float32(np.inf))
    order = np.argsort(key, axis=1, kind="stable")[:, :m]
    sorted_d = np.take_along_axis(d, order, axis=1)
    n_valid = valid.sum(axis=1)
    emask = (np.arange(m)[None, :] < n_valid[:, None]).astype(np.uint8)
    nbr = np.where(emask > 0, (order // k).astype(np.int32),
                   np.arange(s_cap, dtype=np.int32)[:, None])
    dist = np.where(emask > 0, sorted_d, np.float32(0.0))
    n_edges = int(np.minimum(n_valid, m).sum())
    need = needed_images_f32(lat, spec.radius)
    overflow = bool(np.any(need > np.asarray(spec.images, np.float32)))
    return nbr, dist.astype(np.float32), emask, n_edges, overflow
