"""Synthetic crystal generator (the energy task of ``cgnn_tpu/data/synthetic.py``).

Structures are random perturbed lattices with a smooth synthetic target.
Every draw follows the JAX package's generator call for call, so the same
seed gives the same structures and targets on both sides.
"""

from __future__ import annotations

import numpy as np

from cgnn_tpu_torch.data.elements import ELEMENTS
from cgnn_tpu_torch.data.structure import Structure, lattice_from_parameters

# A spread of common elements across blocks (s/p/d) for synthetic crystals.
_SYNTH_ELEMENTS = np.array(
    [1, 3, 6, 7, 8, 9, 11, 12, 13, 14, 15, 16, 17, 19, 20, 22, 24, 26, 27,
     28, 29, 30, 31, 33, 38, 40, 42, 47, 50, 56, 74, 79, 82],
    dtype=np.int32,
)


def random_structure(
    rng: np.random.Generator,
    min_atoms: int = 2,
    max_atoms: int = 12,
    a_range: tuple[float, float] = (3.5, 7.5),
    min_separation: float = 1.2,
) -> Structure:
    """Random near-orthorhombic cell with a minimum-separation rejection pass."""
    n = int(rng.integers(min_atoms, max_atoms + 1))
    abc = rng.uniform(*a_range, size=3) * (1.0 + 0.15 * (n / max_atoms))
    angles = rng.uniform(80.0, 100.0, size=3)
    lattice = lattice_from_parameters(*abc, *angles)
    # one candidate per attempt, rejected when closer than min_separation
    # to an atom already placed (avoids zero-distance edges)
    fracs: list[np.ndarray] = []
    placed = np.empty((0, 3))
    for _ in range(n):
        for _attempt in range(256):
            cand = rng.uniform(0, 1, size=3)
            d = ((cand - placed + 0.5) % 1.0 - 0.5) @ lattice
            if len(placed) == 0 or float(
                np.min(np.einsum("ij,ij->i", d, d))
            ) > min_separation**2:
                break
        fracs.append(cand)
        placed = np.concatenate([placed, cand[None]])
    numbers = rng.choice(_SYNTH_ELEMENTS, size=n)
    return Structure(lattice, np.array(fracs), numbers)


def synthetic_target(structure: Structure, noise: float = 0.0,
                     rng: np.random.Generator | None = None) -> float:
    """Smooth function of composition + geometry (a fake formation energy):
    per-element electronegativity/radius plus a pairwise soft-coordination
    term, so the target depends on both node features and graph structure.
    """
    en = np.array(
        [ELEMENTS[int(z)][4] if ELEMENTS[int(z)][4] == ELEMENTS[int(z)][4] else 1.5
         for z in structure.numbers]
    )
    rad = np.array([ELEMENTS[int(z)][5] for z in structure.numbers]) / 100.0
    comp = float(np.mean(-0.8 * en + 0.3 * rad))
    # soft coordination: pairwise periodic min-image distances under 4.5 Å
    lat = structure.lattice
    coord = 0.0
    n = structure.num_atoms
    for i in range(n):
        d_frac = (structure.frac_coords - structure.frac_coords[i] + 0.5) % 1.0 - 0.5
        d = np.linalg.norm(d_frac @ lat, axis=1)
        d = d[d > 1e-8]
        coord += float(np.sum(np.exp(-((d / 2.5) ** 2))))
    coord /= n
    target = comp - 0.35 * coord
    if noise and rng is not None:
        target += float(rng.normal(0, noise))
    return target


def synthetic_dataset(
    num_structures: int,
    seed: int = 0,
    noise: float = 0.01,
    min_atoms: int = 2,
    max_atoms: int = 12,
) -> list[tuple[str, Structure, float]]:
    """[(id, Structure, target)] — deterministic given the seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num_structures):
        s = random_structure(rng, min_atoms, max_atoms)
        t = synthetic_target(s, noise, rng)
        out.append((f"synth-{i:06d}", s, t))
    return out


def synthetic_mp_dataset(
    num_structures: int,
    seed: int = 0,
    mean_atoms: float = 30.0,
    sigma: float = 0.55,
    max_atoms: int = 120,
) -> list[tuple[str, Structure, float]]:
    """MP-like size distribution: lognormal cell sizes centered near 30
    atoms with a long right tail; cell volume scales at ~16 Å^3/atom so
    density stays physical."""
    rng = np.random.default_rng(seed)
    mu = float(np.log(mean_atoms) - 0.5 * sigma**2)
    out = []
    for i in range(num_structures):
        n = int(np.clip(np.round(rng.lognormal(mu, sigma)), 4, max_atoms))
        a = float((n * 16.0) ** (1.0 / 3.0))
        s = random_structure(
            rng, n, n, a_range=(a * 0.9, a * 1.1), min_separation=1.6
        )
        t = synthetic_target(s, noise=0.01, rng=rng)
        out.append((f"mp-{i:06d}", s, t))
    return out
