"""Minimal periodic crystal structure container (pymatgen is unavailable).

Holds a 3x3 row-vector lattice, fractional coordinates, and atomic numbers.
This replaces the reference lineage's dependency on pymatgen ``Structure``
(SURVEY.md §1 "Data layer"); only the operations the pipeline needs are
implemented: lattice construction from cell parameters, frac<->cart
conversion, and validation.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def lattice_from_parameters(
    a: float, b: float, c: float, alpha: float, beta: float, gamma: float
) -> np.ndarray:
    """Cell parameters (Å, degrees) -> 3x3 row-vector lattice matrix.

    Standard crystallographic convention: a along x; b in the xy plane.
    """
    alpha_r, beta_r, gamma_r = (math.radians(x) for x in (alpha, beta, gamma))
    cos_a, cos_b, cos_g = math.cos(alpha_r), math.cos(beta_r), math.cos(gamma_r)
    sin_g = math.sin(gamma_r)
    if abs(sin_g) < 1e-12:
        raise ValueError(f"degenerate cell: gamma={gamma}")
    cx = c * cos_b
    cy = c * (cos_a - cos_b * cos_g) / sin_g
    cz_sq = c * c - cx * cx - cy * cy
    if cz_sq <= 0:
        raise ValueError(
            f"invalid cell parameters ({a}, {b}, {c}, {alpha}, {beta}, {gamma})"
        )
    return np.array(
        [
            [a, 0.0, 0.0],
            [b * cos_g, b * sin_g, 0.0],
            [cx, cy, math.sqrt(cz_sq)],
        ],
        dtype=np.float64,
    )


@dataclasses.dataclass
class Structure:
    """A periodic crystal: row-vector lattice [3,3], frac coords [N,3], Z [N]."""

    lattice: np.ndarray
    frac_coords: np.ndarray
    numbers: np.ndarray

    def __post_init__(self):
        self.lattice = np.asarray(self.lattice, dtype=np.float64).reshape(3, 3)
        self.frac_coords = np.asarray(self.frac_coords, dtype=np.float64).reshape(-1, 3)
        self.numbers = np.asarray(self.numbers, dtype=np.int32).ravel()
        if len(self.numbers) != len(self.frac_coords):
            raise ValueError(
                f"{len(self.numbers)} atomic numbers but {len(self.frac_coords)} sites"
            )
        if len(self.numbers) == 0:
            raise ValueError("empty structure")
        vol = abs(np.linalg.det(self.lattice))
        if vol < 1e-6:
            raise ValueError(f"degenerate lattice (volume {vol})")

    @property
    def num_atoms(self) -> int:
        return len(self.numbers)

    @property
    def cart_coords(self) -> np.ndarray:
        """[N,3] Cartesian coordinates (frac @ lattice, row-vector convention)."""
        return self.frac_coords @ self.lattice

    def lattice_parameters(self) -> tuple[float, float, float, float, float,
                                          float]:
        """(a, b, c, alpha, beta, gamma) in Å / degrees."""
        lengths = np.linalg.norm(self.lattice, axis=1)
        a1, a2, a3 = self.lattice

        def angle(u, v):
            cosv = float(np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v)))
            return math.degrees(math.acos(max(-1.0, min(1.0, cosv))))

        return (
            float(lengths[0]), float(lengths[1]), float(lengths[2]),
            angle(a2, a3), angle(a1, a3), angle(a1, a2),
        )

    def wrapped(self) -> "Structure":
        """Copy with fractional coordinates wrapped into [0, 1)."""
        f = self.frac_coords % 1.0
        # tiny negatives give f == 1.0 exactly under %; enforce the half-open
        # interval, which the neighbor-list image-count bound relies on
        f = np.where(f >= 1.0, 0.0, f)
        return Structure(self.lattice, f, self.numbers)
