"""Periodic neighbor lists: the numpy backend of ``cgnn_tpu/data/neighbors.py``.

Edges are returned in flat COO form: for each pair within ``radius``,
``centers[k]`` is the receiving atom i, ``neighbors[k]`` the source atom j,
``offsets[k]`` the integer image of j, and ``distances[k]`` = |r_j + offset@L
- r_i|. Self-pairs are excluded only in the home image.

The JAX package's default backend is a ctypes C++ cell-list search
(``cgnn_tpu/native/neighbors.cpp``); this module carries only the vectorized
numpy search, whose output it reproduces bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np

from cgnn_tpu_torch.data.structure import Structure


@dataclasses.dataclass
class NeighborList:
    centers: np.ndarray  # [E] int32, receiving atom i
    neighbors: np.ndarray  # [E] int32, source atom j
    distances: np.ndarray  # [E] float32
    offsets: np.ndarray  # [E, 3] int32, periodic image of j

    def __len__(self) -> int:
        return len(self.centers)


def _image_counts(lattice: np.ndarray, radius: float) -> tuple[int, int, int]:
    """Images needed per axis: ceil(radius / plane-spacing)."""
    inv = np.linalg.inv(lattice)
    # row-vector convention: spacing along axis k is 1 / ||inv[:, k]||
    return tuple(int(math.ceil(radius * np.linalg.norm(inv[:, k]) - 1e-12))
                 for k in range(3))


def neighbor_list(
    structure: Structure,
    radius: float,
    chunk_elems: int = 8_000_000,
) -> NeighborList:
    """Periodic radius search, vectorized over all periodic images with
    chunking over center atoms to bound memory."""
    if radius <= 0:
        raise ValueError(f"radius must be positive, got {radius}")
    s = structure.wrapped()
    cart = s.cart_coords  # [N, 3]
    n = s.num_atoms
    na, nb, nc = _image_counts(s.lattice, radius)
    grid = np.mgrid[-na : na + 1, -nb : nb + 1, -nc : nc + 1].reshape(3, -1).T
    shifts = grid.astype(np.float64) @ s.lattice  # [K, 3]
    k = len(grid)

    # positions of every image of every atom: [N*K, 3]
    img_pos = (cart[:, None, :] + shifts[None, :, :]).reshape(-1, 3)
    home = np.nonzero((grid == 0).all(axis=1))[0][0]

    centers_out, neighbors_out, dists_out, offs_out = [], [], [], []
    # chunk over center atoms so the [chunk, N*K] matrix stays bounded
    chunk = max(1, int(chunk_elems // max(1, n * k)))
    for start in range(0, n, chunk):
        stop = min(n, start + chunk)
        delta = img_pos[None, :, :] - cart[start:stop, None, :]  # [C, N*K, 3]
        dist = np.sqrt(np.einsum("cpk,cpk->cp", delta, delta))  # [C, N*K]
        ci, p = np.nonzero(dist <= radius)
        j = p // k
        img = p % k
        keep = ~((j == ci + start) & (img == home))  # drop home-image self pairs
        ci, j, img = ci[keep], j[keep], img[keep]
        centers_out.append((ci + start).astype(np.int32))
        neighbors_out.append(j.astype(np.int32))
        dists_out.append(dist[ci, p[keep]].astype(np.float32))
        offs_out.append(grid[img].astype(np.int32))

    return NeighborList(
        np.concatenate(centers_out) if centers_out else np.zeros(0, np.int32),
        np.concatenate(neighbors_out) if neighbors_out else np.zeros(0, np.int32),
        np.concatenate(dists_out) if dists_out else np.zeros(0, np.float32),
        np.concatenate(offs_out) if offs_out else np.zeros((0, 3), np.int32),
    )


def knn_neighbor_list(
    structure: Structure,
    radius: float,
    max_num_nbr: int,
    warn_under_coordinated: bool = True,
) -> NeighborList:
    """Radius search truncated to the ``max_num_nbr`` nearest per center.

    Keeps the nearest M neighbors of each atom (ties broken by the search's
    own order, as the lexsort is stable) and warns when an atom has fewer
    than M within the radius; no padding edges are created here.
    """
    nl = neighbor_list(structure, radius)
    n = structure.num_atoms
    order = np.lexsort((nl.distances, nl.centers))
    centers = nl.centers[order]
    counts = np.bincount(centers, minlength=n)
    if warn_under_coordinated and np.any(counts < max_num_nbr):
        short = int((counts < max_num_nbr).sum())
        warnings.warn(
            f"{short}/{n} atoms have fewer than {max_num_nbr} neighbors within "
            f"radius {radius}; consider increasing the radius",
            stacklevel=2,
        )
    # rank of each edge within its center group (centers are sorted)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(centers)) - np.repeat(starts, counts)
    keep = rank < max_num_nbr
    sel = order[keep]
    return NeighborList(
        nl.centers[sel], nl.neighbors[sel], nl.distances[sel], nl.offsets[sel]
    )
