"""Dataset assembly: structures -> featurized CrystalGraphs, and the
train/val/test split (the synthetic-data part of
``cgnn_tpu/data/dataset.py``)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from cgnn_tpu_torch.data.elements import atom_features
from cgnn_tpu_torch.data.featurize import GaussianDistance
from cgnn_tpu_torch.data.graph import CrystalGraph
from cgnn_tpu_torch.data.neighbors import knn_neighbor_list
from cgnn_tpu_torch.data.structure import Structure
from cgnn_tpu_torch.data.synthetic import synthetic_dataset, synthetic_mp_dataset


@dataclasses.dataclass
class FeaturizeConfig:
    """Featurization hyperparameters (mirror the reference CLI flags)."""

    radius: float = 8.0
    max_num_nbr: int = 12
    dmin: float = 0.0
    step: float = 0.2

    def gdf(self) -> GaussianDistance:
        return GaussianDistance(self.dmin, self.radius, self.step)


def featurize_structure(
    structure: Structure,
    target,
    cfg: FeaturizeConfig,
    cif_id: str = "",
    gdf: GaussianDistance | None = None,
    target_mask=None,
    keep_geometry: bool = False,
) -> CrystalGraph:
    """Structure + label -> flat-COO CrystalGraph (host-side).
    ``keep_geometry`` also stores the wrapped f32 cartesian positions, the
    f32 lattice, the neighbor image offsets and the atomic numbers, which
    the raw wire plans its caps from (data/rawbatch.py)."""
    gdf = gdf or cfg.gdf()
    nl = knn_neighbor_list(
        structure, cfg.radius, cfg.max_num_nbr, warn_under_coordinated=False
    )
    if len(nl) == 0:
        raise ValueError(
            f"structure {cif_id!r} has no neighbors within radius {cfg.radius}"
        )
    graph = CrystalGraph(
        atom_fea=atom_features(structure.numbers),
        edge_fea=gdf.expand(nl.distances),
        centers=nl.centers,
        neighbors=nl.neighbors,
        target=np.atleast_1d(np.asarray(target, np.float32)),
        cif_id=cif_id,
        target_mask=(
            None if target_mask is None
            else np.atleast_1d(np.asarray(target_mask, np.float32))
        ),
        distances=nl.distances,
    )
    if keep_geometry:
        # the neighbor offsets are against WRAPPED coordinates, so the
        # stored positions are the wrapped ones
        graph.positions = structure.wrapped().cart_coords.astype(np.float32)
        graph.lattice = structure.lattice.astype(np.float32)
        graph.offsets = nl.offsets.astype(np.int32)
        graph.numbers = structure.numbers.copy()
    return graph


def load_synthetic(
    num_structures: int,
    cfg: FeaturizeConfig | None = None,
    seed: int = 0,
    keep_geometry: bool = False,
) -> list[CrystalGraph]:
    """Small random cells (2-12 atoms): the default serving calibration."""
    cfg = cfg or FeaturizeConfig()
    gdf = cfg.gdf()
    return [
        featurize_structure(s, t, cfg, sid, gdf, keep_geometry=keep_geometry)
        for sid, s, t in synthetic_dataset(num_structures, seed)
    ]


def load_synthetic_mp(
    num_structures: int,
    cfg: FeaturizeConfig | None = None,
    seed: int = 0,
    keep_geometry: bool = False,
) -> list[CrystalGraph]:
    """MP-like size distribution (lognormal ~30 atoms)."""
    cfg = cfg or FeaturizeConfig()
    gdf = cfg.gdf()
    return [
        featurize_structure(s, t, cfg, sid, gdf, keep_geometry=keep_geometry)
        for sid, s, t in synthetic_mp_dataset(num_structures, seed)
    ]


def train_val_test_split(
    graphs: Sequence[CrystalGraph],
    train_ratio: float = 0.8,
    val_ratio: float = 0.1,
    seed: int = 0,
) -> tuple[list[CrystalGraph], list[CrystalGraph], list[CrystalGraph]]:
    """Deterministic shuffled split: one ``default_rng(seed)``
    permutation, cut at int(n * train_ratio) and int(n * val_ratio)."""
    if train_ratio + val_ratio >= 1.0 + 1e-9:
        raise ValueError("train_ratio + val_ratio must leave room for test")
    idx = np.random.default_rng(seed).permutation(len(graphs))
    n_train = int(len(graphs) * train_ratio)
    n_val = int(len(graphs) * val_ratio)

    def pick(ids):
        return [graphs[int(i)] for i in ids]

    return (pick(idx[:n_train]), pick(idx[n_train:n_train + n_val]),
            pick(idx[n_train + n_val:]))
