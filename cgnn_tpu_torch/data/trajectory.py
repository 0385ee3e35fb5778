"""On-disk trajectory datasets for the force task
(``cgnn_tpu/data/trajectory.py``; BASELINE config #5).

The reference's MD17 config is a file-based trajectory dataset (BASELINE.json
config #5: "per-atom force head on MD17 trajectories"); this module defines
the rebuild's on-disk contract: ONE ``.npz`` FILE PER TRAJECTORY, accepted in
either of two key conventions:

native (written by :func:`save_trajectory_npz`)::

    positions [T, N, 3] float   cartesian coordinates, Å
    numbers   [N]       int     atomic numbers
    energy    [T]       float   total energy per frame
    forces    [T, N, 3] float   per-atom forces
    lattice   [3, 3] or [T, 3, 3] float   OPTIONAL periodic cell; when
              absent a per-frame vacuum box is synthesized (gas-phase
              molecules — the MD17 regime)

MD17/sGDML public convention (so published MD17 ``.npz`` downloads load
unchanged)::

    R [T, N, 3], z [N], E [T] or [T, 1], F [T, N, 3]      (no lattice)

Splitting policy (:func:`split_trajectory_groups`): frames of one MD
trajectory are heavily time-autocorrelated, so shuffling frames across
train/val/test leaks. With >= 3 trajectories the split is BY TRAJECTORY
(whole files per split); below that each trajectory is cut into CONTIGUOUS
time blocks so adjacent frames stay within one split.
"""

from __future__ import annotations

import os
import warnings
from typing import Sequence

import numpy as np

from cgnn_tpu_torch.data.graph import CrystalGraph
from cgnn_tpu_torch.data.structure import Structure


def save_trajectory_npz(
    path: str,
    positions: np.ndarray,
    numbers: np.ndarray,
    energies: np.ndarray,
    forces: np.ndarray,
    lattice: np.ndarray | None = None,
) -> None:
    """Write one trajectory in the native key convention (see module doc)."""
    arrays = {
        "positions": np.asarray(positions, np.float32),
        "numbers": np.asarray(numbers, np.int32),
        "energy": np.asarray(energies, np.float32),
        "forces": np.asarray(forces, np.float32),
    }
    if lattice is not None:
        arrays["lattice"] = np.asarray(lattice, np.float32)
    np.savez_compressed(path, **arrays)


def load_trajectory_npz(path: str) -> dict:
    """Read a trajectory ``.npz`` into canonical keys, validating shapes.

    Returns ``{"positions", "numbers", "energy", "forces", "lattice"}``
    (``lattice`` may be None). Both key conventions are accepted; anything
    else raises ``ValueError`` naming the file and what was found.
    """
    with np.load(path) as z:
        keys = set(z.files)
        if {"positions", "numbers", "energy", "forces"} <= keys:
            pos = np.asarray(z["positions"], np.float64)
            numbers = np.asarray(z["numbers"], np.int32).ravel()
            energy = np.asarray(z["energy"], np.float64).reshape(-1)
            forces = np.asarray(z["forces"], np.float64)
            lattice = (
                np.asarray(z["lattice"], np.float64) if "lattice" in keys
                else None
            )
        elif {"R", "z", "E", "F"} <= keys:  # MD17/sGDML convention
            pos = np.asarray(z["R"], np.float64)
            numbers = np.asarray(z["z"], np.int32).ravel()
            energy = np.asarray(z["E"], np.float64).reshape(-1)
            forces = np.asarray(z["F"], np.float64)
            lattice = None
        else:
            raise ValueError(
                f"{path}: unrecognized trajectory keys {sorted(keys)}; "
                f"expected positions/numbers/energy/forces (native) or "
                f"R/z/E/F (MD17)"
            )
    if pos.ndim != 3 or pos.shape[-1] != 3:
        raise ValueError(f"{path}: positions must be [T, N, 3], got {pos.shape}")
    t, n = pos.shape[:2]
    if len(numbers) != n:
        raise ValueError(
            f"{path}: {len(numbers)} atomic numbers for {n} position columns"
        )
    if len(energy) != t:
        raise ValueError(f"{path}: {len(energy)} energies for {t} frames")
    if forces.shape != pos.shape:
        raise ValueError(
            f"{path}: forces shape {forces.shape} != positions {pos.shape}"
        )
    if lattice is not None:
        if lattice.shape == (3, 3):
            lattice = np.broadcast_to(lattice, (t, 3, 3))
        elif lattice.shape != (t, 3, 3):
            raise ValueError(
                f"{path}: lattice must be [3,3] or [T,3,3], got {lattice.shape}"
            )
    return {
        "positions": pos,
        "numbers": numbers,
        "energy": energy,
        "forces": forces,
        "lattice": lattice,
    }


def _vacuum_box(cart: np.ndarray, margin: float) -> tuple[np.ndarray, np.ndarray]:
    """(lattice [3,3], frac [N,3]) placing a molecule in a diagonal box.

    Each box side is the position extent plus ``2 * margin``, with the
    molecule centered; any periodic image of any atom is therefore at
    least ``2 * margin`` away, so with ``margin >= radius`` the periodic
    neighbor machinery reduces to open boundaries exactly.
    """
    lo = cart.min(axis=0)
    span = cart.max(axis=0) - lo
    side = span + 2.0 * margin
    lattice = np.diag(side)
    frac = (cart - lo + margin) / side
    return lattice, frac


def trajectory_graphs(
    path: str,
    cfg,
    stride: int = 1,
    limit: int | None = None,
) -> list[CrystalGraph]:
    """One trajectory file -> featurized CrystalGraphs with force labels.

    Graphs keep geometry (positions/lattice/offsets) so the differentiable
    force model recomputes distances in-model (models/forcefield.py), and
    carry per-atom ``forces`` for the composite loss. ``cif_id`` is
    ``"{filename-stem}/{frame:05d}"``.
    """
    from cgnn_tpu_torch.data.dataset import featurize_structure

    data = load_trajectory_npz(path)
    gdf = cfg.gdf()
    stem = os.path.splitext(os.path.basename(path))[0]
    graphs: list[CrystalGraph] = []
    frames = range(0, data["positions"].shape[0], max(1, stride))
    for k in frames:
        if limit is not None and len(graphs) >= limit:
            break
        cart = data["positions"][k]
        if data["lattice"] is not None:
            lat = data["lattice"][k]
            frac = cart @ np.linalg.inv(lat)
        else:
            # vacuum box with a >= radius margin: periodic images stay out
            # of neighbor range, so the crystal pipeline handles gas-phase
            # molecules without an open-boundary special case
            lat, frac = _vacuum_box(cart, margin=max(cfg.radius, 4.0))
        s = Structure(lat, frac, data["numbers"])
        g = featurize_structure(
            s, float(data["energy"][k]), cfg, f"{stem}/{k:05d}", gdf,
            keep_geometry=True,
        )
        g.forces = data["forces"][k].astype(np.float32)
        graphs.append(g)
    return graphs


def is_trajectory_path(path: str) -> bool:
    """True when ``path`` is a trajectory ``.npz`` or a directory holding some."""
    if path.endswith(".npz"):
        return os.path.isfile(path)
    if os.path.isdir(path):
        return any(f.endswith(".npz") for f in os.listdir(path))
    return False


def load_trajectory_root(
    root: str, cfg, stride: int = 1
) -> list[list[CrystalGraph]]:
    """Directory of ``*.npz`` (or one file) -> graphs GROUPED BY TRAJECTORY.

    The grouping is the unit of :func:`split_trajectory_groups`; flatten with
    ``[g for grp in groups for g in grp]`` when splits are not needed.
    """
    if os.path.isfile(root):
        paths = [root]
    else:
        paths = sorted(
            os.path.join(root, f)
            for f in os.listdir(root)
            if f.endswith(".npz")
        )
    if not paths:
        raise FileNotFoundError(f"no trajectory .npz files under {root}")
    groups = [trajectory_graphs(p, cfg, stride=stride) for p in paths]
    if not any(groups):
        raise ValueError(f"trajectory files under {root} contain no frames")
    return [g for g in groups if g]


def regroup_by_trajectory(graphs: Sequence) -> list[list] | None:
    """Rebuild trajectory grouping from ``"stem/frame"`` cif_ids.

    Graph caches (data/cache.py) flatten the grouping; the ids keep it.
    Returns None when any id lacks the separator (non-trajectory data) —
    callers then fall back to the generic split.
    """
    if not graphs or not all("/" in g.cif_id for g in graphs):
        return None
    groups: dict[str, list] = {}
    for g in graphs:
        groups.setdefault(g.cif_id.rsplit("/", 1)[0], []).append(g)
    return list(groups.values())


def split_trajectory_groups(
    groups: Sequence[list],
    train_ratio: float = 0.8,
    val_ratio: float = 0.1,
    seed: int = 0,
) -> tuple[list, list, list]:
    """Leak-aware train/val/test split (see module docstring for policy).

    With >= 3 trajectories: whole trajectories per split — each split with
    a nonzero quota is seeded with one trajectory (in seeded shuffle
    order) so none it owes frames to is empty, the rest go greedily to
    the split furthest below its frame-count quota. A zero-ratio split
    (e.g. ``val_ratio=0``) is never seeded and receives nothing.

    Whole-trajectory granularity means the realized frame fractions can
    deviate from the requested ratios by up to one trajectory's worth of
    frames per split — substantial when trajectory lengths are very
    unequal. A UserWarning reports the realized fractions whenever any
    split lands more than 5 points (0.05 absolute) off its quota.

    With 1-2 trajectories: contiguous time blocks within each.
    """
    if train_ratio + val_ratio >= 1.0 + 1e-9:
        raise ValueError("train_ratio + val_ratio must leave room for test")
    if len(groups) < 3:
        train: list = []
        val: list = []
        test: list = []
        for grp in groups:
            n = len(grp)
            n_tr = int(n * train_ratio)
            n_va = int(n * val_ratio)
            train += grp[:n_tr]
            val += grp[n_tr : n_tr + n_va]
            test += grp[n_tr + n_va :]
        return train, val, test
    order = np.random.default_rng(seed).permutation(len(groups))
    total = float(sum(len(g) for g in groups))
    quota = (train_ratio, val_ratio, 1.0 - train_ratio - val_ratio)
    seeds = [j for j in range(3) if quota[j] > 1e-9]
    splits: tuple[list, list, list] = ([], [], [])
    for k, i in enumerate(order):
        grp = groups[int(i)]
        if k < len(seeds):
            j = seeds[k]  # seed each owed split with one trajectory
        else:
            deficits = [
                quota[j] - len(splits[j]) / total
                if quota[j] > 1e-9 else -np.inf
                for j in range(3)
            ]
            j = int(np.argmax(deficits))
        splits[j].extend(grp)
    realized = tuple(len(s) / total for s in splits)
    if any(abs(realized[j] - quota[j]) > 0.05 for j in range(3)):
        warnings.warn(
            "whole-trajectory split deviates from requested ratios: "
            f"realized train/val/test = {realized[0]:.3f}/{realized[1]:.3f}/"
            f"{realized[2]:.3f} vs requested {quota[0]:.3f}/{quota[1]:.3f}/"
            f"{quota[2]:.3f} (granularity is one trajectory)",
            stacklevel=2,
        )
    return splits
