"""Dataset assembly: structures -> featurized CrystalGraphs
(the synthetic-data part of ``cgnn_tpu/data/dataset.py``)."""

from __future__ import annotations

import dataclasses

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
) -> CrystalGraph:
    """Structure + label -> flat-COO CrystalGraph (host-side)."""
    gdf = gdf or cfg.gdf()
    nl = knn_neighbor_list(
        structure, cfg.radius, cfg.max_num_nbr, warn_under_coordinated=False
    )
    if len(nl) == 0:
        raise ValueError(
            f"structure {cif_id!r} has no neighbors within radius {cfg.radius}"
        )
    return CrystalGraph(
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


def load_synthetic(
    num_structures: int,
    cfg: FeaturizeConfig | None = None,
    seed: int = 0,
) -> list[CrystalGraph]:
    """Small random cells (2-12 atoms): the default serving calibration."""
    cfg = cfg or FeaturizeConfig()
    gdf = cfg.gdf()
    return [
        featurize_structure(s, t, cfg, sid, gdf)
        for sid, s, t in synthetic_dataset(num_structures, seed)
    ]


def load_synthetic_mp(
    num_structures: int,
    cfg: FeaturizeConfig | None = None,
    seed: int = 0,
) -> list[CrystalGraph]:
    """MP-like size distribution (lognormal ~30 atoms)."""
    cfg = cfg or FeaturizeConfig()
    gdf = cfg.gdf()
    return [
        featurize_structure(s, t, cfg, sid, gdf)
        for sid, s, t in synthetic_mp_dataset(num_structures, seed)
    ]
