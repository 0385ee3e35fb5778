"""Dataset assembly: structures -> featurized CrystalGraphs, and the
train/val/test split (``cgnn_tpu/data/dataset.py``: CIF directories and
the synthetic sets)."""

from __future__ import annotations

import csv
import dataclasses
import os
import warnings
from typing import Sequence

import numpy as np

from cgnn_tpu_torch.data.cif import parse_cif_file
from cgnn_tpu_torch.data.featurize import GaussianDistance, featurize_arrays
from cgnn_tpu_torch.data.graph import CrystalGraph
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
    """Structure + label -> flat-COO CrystalGraph (host-side,
    ``featurize.featurize_arrays``). ``keep_geometry`` also stores the
    wrapped f32 cartesian positions, the f32 lattice, the neighbor image
    offsets and the atomic numbers, which the raw wire plans its caps from
    (data/rawbatch.py)."""
    return CrystalGraph(**featurize_arrays(
        structure, target, cfg.radius, cfg.max_num_nbr, gdf or cfg.gdf(),
        cif_id, target_mask=target_mask, keep_geometry=keep_geometry))


def read_id_prop(root_dir: str, id_prop_file: str = "id_prop.csv"
                 ) -> list[tuple[str, str, np.ndarray, np.ndarray]]:
    """``id_prop.csv`` rows -> [(cif_id, cif path, target [T] f32, mask [T]
    f32)] in file order. A row is ``cif_id, target[, target2, ...]``; an
    empty cell is a masked label (target 0, mask 0)."""
    prop_path = os.path.join(root_dir, id_prop_file)
    if not os.path.exists(prop_path):
        raise FileNotFoundError(f"missing {prop_path}")
    rows = []
    with open(prop_path, newline="") as f:
        for row in csv.reader(f):
            if not row:
                continue
            cif_id = row[0].strip()
            raw = [c.strip() for c in row[1:]]
            target = np.array([float(c) if c else 0.0 for c in raw],
                              np.float32)
            mask = np.array([1.0 if c else 0.0 for c in raw], np.float32)
            rows.append((cif_id, os.path.join(root_dir, cif_id + ".cif"),
                         target, mask))
    return rows


def load_cif_directory(
    root_dir: str,
    cfg: FeaturizeConfig | None = None,
    id_prop_file: str = "id_prop.csv",
    keep_geometry: bool = False,
) -> list[CrystalGraph]:
    """The reference directory layout, ``{root}/{id}.cif`` + id_prop.csv
    (``read_id_prop``), featurized in file order on this thread. A file
    that does not parse or featurize is skipped with a warning; a
    directory with nothing usable raises."""
    cfg = cfg or FeaturizeConfig()
    gdf = cfg.gdf()
    graphs: list[CrystalGraph] = []
    for cif_id, path, target, mask in read_id_prop(root_dir, id_prop_file):
        try:
            structure = parse_cif_file(path)
            graphs.append(featurize_structure(
                structure, target, cfg, cif_id, gdf, target_mask=mask,
                keep_geometry=keep_geometry))
        except Exception as e:  # noqa: BLE001 — warn and skip, as the reference
            warnings.warn(f"skipping {cif_id}: {e}", stacklevel=2)
    if not graphs:
        raise ValueError(f"no usable structures under {root_dir}")
    return graphs


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


def load_synthetic_oc20(
    num_structures: int,
    cfg: FeaturizeConfig | None = None,
    seed: int = 0,
) -> list[CrystalGraph]:
    """OC20 IS2RE stand-in: catalyst-slab graphs of 37-255 atoms (surface
    under-coordination, vacuum gaps, a wide size spread)."""
    from cgnn_tpu_torch.data.synthetic import synthetic_oc20_dataset

    cfg = cfg or FeaturizeConfig()
    gdf = cfg.gdf()
    return [
        featurize_structure(s, t, cfg, sid, gdf)
        for sid, s, t in synthetic_oc20_dataset(num_structures, seed)
    ]


def load_trajectory(
    num_frames: int,
    cfg: FeaturizeConfig | None = None,
    seed: int = 0,
    num_atoms: int = 8,
    jitter: float = 0.08,
) -> list[CrystalGraph]:
    """MD17 stand-in: LJ trajectory frames with energy and force labels.
    The graphs keep their geometry, from which the force model recomputes
    the distances, and carry per-atom ``forces``."""
    from cgnn_tpu_torch.data.synthetic import synthetic_trajectory

    cfg = cfg or FeaturizeConfig()
    gdf = cfg.gdf()
    graphs = []
    for sid, s, energy, forces in synthetic_trajectory(
        num_frames, seed=seed, num_atoms=num_atoms, jitter=jitter
    ):
        g = featurize_structure(s, energy, cfg, sid, gdf, keep_geometry=True)
        g.forces = forces.astype(np.float32)
        graphs.append(g)
    return graphs


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
