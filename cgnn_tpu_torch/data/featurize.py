"""Bond featurization: Gaussian basis expansion of interatomic distance
(a numpy copy of ``cgnn_tpu/data/featurize.py``).

Replaces the reference's ``GaussianDistance`` (SURVEY.md §2 component 4):
``exp(-(d - mu_k)^2 / sigma^2)`` over a mu grid [dmin, dmax] with spacing
``step``. Default grid (dmin=0, dmax=radius=8, step=0.2) gives 41 features,
matching the lineage's nbr_fea_len.
"""

from __future__ import annotations

import numpy as np


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
