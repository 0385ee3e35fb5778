"""Periodic neighbor lists (``cgnn_tpu/data/neighbors.py``).

Edges are returned in flat COO form: for each pair within ``radius``,
``centers[k]`` is the receiving atom i, ``neighbors[k]`` the source atom j,
``offsets[k]`` the integer image of j, and ``distances[k]`` = |r_j + offset@L
- r_i|. Self-pairs are excluded only in the home image.

Two backends behind ``neighbor_list(backend=)``, which give the same
arrays bit for bit, order included (pairs by center, then neighbor, then
image in ``np.mgrid`` order: the canonical order whose stable lexsort
breaks the k-nearest cut's distance ties, ``knn_neighbor_list``):

- ``'numpy'``: vectorized over every periodic image of every atom,
  chunked over centers;
- ``'native'``: the C++ cell list (``cgnn_tpu_torch/native``) finds the
  candidate pairs within the radius plus a margin, in that order; their
  distances are then computed by the numpy backend's own arithmetic (its
  image-shift table, ``img_pos - cart[i]``, its einsum and square root)
  and cut at ``dist <= radius``, so no pair at the cut's edge can land on
  the other side. The JAX package's cell list keeps its own order and
  f32 distances; this one does not.

``'auto'`` (the default) is native where g++ is on PATH (native/__init__.py).
``neighbor_list_brute`` is the explicit-loop oracle of the tests.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np

from cgnn_tpu_torch import native
from cgnn_tpu_torch.data.structure import Structure

# the native candidates' radius margin (A): far above the few-ulp gap
# between the cell list's distance formula and the numpy search's
_MARGIN = 1e-6


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


def neighbor_list_brute(structure: Structure, radius: float) -> NeighborList:
    """Explicit-loop reference (tests only; O(N^2 * images))."""
    s = structure.wrapped()
    cart = s.cart_coords
    n = s.num_atoms
    na, nb, nc = _image_counts(s.lattice, radius)
    centers, neighbors, dists, offs = [], [], [], []
    for i in range(n):
        for j in range(n):
            for ia in range(-na, na + 1):
                for ib in range(-nb, nb + 1):
                    for ic in range(-nc, nc + 1):
                        if i == j and ia == 0 and ib == 0 and ic == 0:
                            continue
                        shift = (np.array([ia, ib, ic], dtype=np.float64)
                                 @ s.lattice)
                        d = float(np.linalg.norm(cart[j] + shift - cart[i]))
                        if d <= radius:
                            centers.append(i)
                            neighbors.append(j)
                            dists.append(d)
                            offs.append((ia, ib, ic))
    return NeighborList(
        np.asarray(centers, dtype=np.int32),
        np.asarray(neighbors, dtype=np.int32),
        np.asarray(dists, dtype=np.float32),
        np.asarray(offs, dtype=np.int32).reshape(-1, 3),
    )


def _images(s: Structure, radius: float):
    """(image counts, the image grid [K, 3] in np.mgrid order, its shifts
    [K, 3] f64): the numpy search's table, shared by both backends."""
    na, nb, nc = _image_counts(s.lattice, radius)
    grid = np.mgrid[-na : na + 1, -nb : nb + 1, -nc : nc + 1].reshape(3, -1).T
    return (na, nb, nc), grid, grid.astype(np.float64) @ s.lattice


def neighbor_list(
    structure: Structure,
    radius: float,
    chunk_elems: int = 8_000_000,
    backend: str = "auto",
) -> NeighborList:
    """Periodic radius search on ``backend`` ('auto', 'native' or 'numpy';
    module docstring): the same arrays from either."""
    if radius <= 0:
        raise ValueError(f"radius must be positive, got {radius}")
    ran = native.resolve(backend)
    s = structure.wrapped()
    cart = s.cart_coords  # [N, 3]
    counts, grid, shifts = _images(s, radius)
    nl = (_native_search(s, cart, radius, counts, shifts) if ran == "native"
          else _numpy_search(s, cart, radius, grid, shifts, chunk_elems))
    native.note(ran)
    return nl


def _native_search(s: Structure, cart: np.ndarray, radius: float, counts,
                   shifts: np.ndarray) -> NeighborList:
    """The cell list's candidates, their distances by the numpy search's
    arithmetic, cut at ``radius``."""
    na, nb, nc = counts
    ci, j, off = native.candidates(s.lattice, s.frac_coords, cart,
                                   radius + _MARGIN, counts)
    img = ((off[:, 0] + na) * (2 * nb + 1) + (off[:, 1] + nb)) \
        * (2 * nc + 1) + (off[:, 2] + nc)
    # as the numpy search: (cart[j] + shift) - cart[i], einsum, sqrt
    img_pos = cart[j] + shifts[img]
    delta = (img_pos - cart[ci])[None]  # [1, E, 3]
    dist = np.sqrt(np.einsum("cpk,cpk->cp", delta, delta))[0]
    keep = dist <= radius
    return NeighborList(ci[keep], j[keep], dist[keep].astype(np.float32),
                        off[keep])


def _numpy_search(s: Structure, cart: np.ndarray, radius: float,
                  grid: np.ndarray, shifts: np.ndarray,
                  chunk_elems: int) -> NeighborList:
    """Vectorized over all periodic images, chunked over center atoms to
    bound memory."""
    n = s.num_atoms
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
    backend: str = "auto",
) -> NeighborList:
    """Radius search truncated to the ``max_num_nbr`` nearest per center.

    Keeps the nearest M neighbors of each atom (ties broken by the search's
    own order, as the lexsort is stable) and warns when an atom has fewer
    than M within the radius; no padding edges are created here.
    """
    nl = neighbor_list(structure, radius, backend=backend)
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
