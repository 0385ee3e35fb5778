"""Bond featurization: Gaussian basis expansion of interatomic distance
(a numpy copy of ``cgnn_tpu/data/featurize.py``), and a structure's graph
arrays (``featurize_arrays``).

Replaces the reference's ``GaussianDistance`` (SURVEY.md §2 component 4):
``exp(-(d - mu_k)^2 / sigma^2)`` over a mu grid [dmin, dmax] with spacing
``step``. Default grid (dmin=0, dmax=radius=8, step=0.2) gives 41 features,
matching the lineage's nbr_fea_len.

This module imports numpy and no torch: the featurization worker
processes of data/cache.py import only it, so each starts in a fraction
of torch's import time.
"""

from __future__ import annotations

import numpy as np

from cgnn_tpu_torch.data.elements import atom_features
from cgnn_tpu_torch.data.neighbors import knn_neighbor_list


class GaussianDistance:
    """Expand scalar distances into a Gaussian radial basis."""

    def __init__(self, dmin: float = 0.0, dmax: float = 8.0, step: float = 0.2,
                 var: float | None = None):
        if dmin >= dmax:
            raise ValueError(f"dmin={dmin} must be < dmax={dmax}")
        if step <= 0:
            raise ValueError(f"step={step} must be positive")
        self.filter = np.arange(dmin, dmax + step, step, dtype=np.float32)
        self.var = float(var if var is not None else step)

    @property
    def num_features(self) -> int:
        return len(self.filter)

    def expand(self, distances: np.ndarray) -> np.ndarray:
        """[...] distances -> [..., K] expanded features (float32)."""
        return gaussian_expand(distances, self.filter, self.var)


def gaussian_expand(distances, filter: np.ndarray, var: float) -> np.ndarray:
    """The one radial-basis formula (numpy form), bit-equal to the JAX
    package's ``cgnn_tpu.data.featurize.gaussian_expand``."""
    d = np.asarray(distances, dtype=np.float32)
    return np.exp(
        -((d[..., None] - np.asarray(filter, np.float32)) ** 2)
        / np.float32(var) ** 2
    ).astype(np.float32)


def featurize_arrays(structure, target, radius: float, max_num_nbr: int,
                     gdf: GaussianDistance, cif_id: str = "",
                     target_mask=None, keep_geometry: bool = False) -> dict:
    """Structure + label -> the fields of its flat-COO ``CrystalGraph``
    (``data.dataset.featurize_structure`` wraps them). ``keep_geometry``
    adds the wrapped f32 cartesian positions, the f32 lattice, the
    neighbor image offsets and the atomic numbers."""
    nl = knn_neighbor_list(structure, radius, max_num_nbr,
                           warn_under_coordinated=False)
    if len(nl) == 0:
        raise ValueError(
            f"structure {cif_id!r} has no neighbors within radius {radius}")
    fields = dict(
        atom_fea=atom_features(structure.numbers),
        edge_fea=gdf.expand(nl.distances),
        centers=nl.centers,
        neighbors=nl.neighbors,
        target=np.atleast_1d(np.asarray(target, np.float32)),
        cif_id=cif_id,
        target_mask=(None if target_mask is None
                     else np.atleast_1d(np.asarray(target_mask, np.float32))),
        distances=nl.distances,
    )
    if keep_geometry:
        # the neighbor offsets are against WRAPPED coordinates, so the
        # stored positions are the wrapped ones
        fields.update(
            positions=structure.wrapped().cart_coords.astype(np.float32),
            lattice=structure.lattice.astype(np.float32),
            offsets=nl.offsets.astype(np.int32),
            numbers=structure.numbers.copy())
    return fields


def featurize_cif_job(job):
    """One ``id_prop.csv`` row, ``(cif path, cif_id, target, mask,
    (radius, max_num_nbr, dmin, step), keep_geometry)`` -> its graph
    fields (``featurize_arrays``), or ``(cif_id, message)`` when the file
    does not parse or featurize: the job of a featurization worker."""
    import warnings

    from cgnn_tpu_torch.data.cif import parse_cif_file

    path, cif_id, target, mask, (radius, max_nbr, dmin, step), geom = job
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return featurize_arrays(
                parse_cif_file(path), target, radius, max_nbr,
                GaussianDistance(dmin, radius, step), cif_id,
                target_mask=mask, keep_geometry=geom)
    except Exception as e:  # noqa: BLE001 — reported as a failure, as the reference
        return (cif_id, str(e))
