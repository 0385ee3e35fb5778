"""Synthetic crystal generator (``cgnn_tpu/data/synthetic.py``).

Structures are random perturbed lattices with a smooth synthetic target;
the force task's MD17 stand-in (``synthetic_trajectory``: one cell
jittered frame by frame, Lennard-Jones energies and forces, the labels
``lj_energy_forces`` computes) and the OC20 stand-in
(``synthetic_oc20_dataset``: catalyst slabs of 37-255 atoms). Every draw
follows the JAX package's generator call for call, so the same seed gives
the same structures and targets on both sides.
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


def lj_energy_forces(
    structure: Structure, epsilon: float = 0.4, sigma: float = 2.2,
    cutoff: float = 6.0,
) -> tuple[float, np.ndarray]:
    """Lennard-Jones energy and analytic forces under periodic boundaries
    (the MD17 stand-in's labels): forces are exactly -dE/dr of a smooth
    pair potential, so a model and its gradient can fit both."""
    from cgnn_tpu_torch.data.neighbors import neighbor_list

    nl = neighbor_list(structure, cutoff)
    cart = structure.cart_coords
    rel = (
        cart[nl.neighbors]
        + nl.offsets.astype(np.float64) @ structure.lattice
        - cart[nl.centers]
    )  # vector from center i to neighbor j
    r = np.linalg.norm(rel, axis=1)
    sr6 = (sigma / r) ** 6
    # each ordered pair appears twice: half the pair energy each
    energy = float(np.sum(2.0 * epsilon * (sr6**2 - sr6)))
    # dE/dr per ordered pair (the pair derivative split symmetrically)
    dEdr = 4.0 * epsilon * (-12.0 * sr6**2 + 6.0 * sr6) / r
    # rel = r_j - r_i, so dr/dr_i = -rel/r and the force on i from the
    # ordered pair (i, j) is +(dE/dr)(rel/r)
    f_pair = (dEdr / r)[:, None] * rel
    forces = np.zeros_like(cart)
    np.add.at(forces, nl.centers, f_pair)
    return energy, forces.astype(np.float32)


def synthetic_trajectory(
    num_frames: int,
    seed: int = 0,
    num_atoms: int = 8,
    jitter: float = 0.08,
) -> list[tuple[str, Structure, float, np.ndarray]]:
    """MD17-like trajectory: one cell, per-frame position jitter, LJ
    labels -> [(id, Structure, energy, forces [N, 3])]. Atoms start near
    the LJ equilibrium distance (2^(1/6) sigma, about 2.47 A) and the
    default jitter keeps pair distances off the repulsive wall, so the
    labels stay O(1) like a real MD trajectory's."""
    rng = np.random.default_rng(seed)
    base = random_structure(
        rng, num_atoms, num_atoms, a_range=(6.0, 7.5), min_separation=2.5
    )
    out = []
    for k in range(num_frames):
        fracs = base.frac_coords + rng.normal(
            0, jitter, base.frac_coords.shape) @ np.linalg.inv(base.lattice)
        s = Structure(base.lattice, fracs, base.numbers)
        e, f = lj_energy_forces(s)
        out.append((f"frame-{k:05d}", s, e, f))
    return out


def synthetic_slab(
    rng: np.random.Generator,
    nx: int = 3,
    ny: int = 3,
    layers: int = 4,
    a0: float = 3.9,
    adsorbate_atoms: int = 2,
) -> Structure:
    """OC20-like catalyst slab: an fcc(100)-like surface, a vacuum gap
    and a small adsorbate (the large-graph regime, 50-200+ atoms)."""
    metal = int(rng.choice([26, 27, 28, 29, 42, 46, 47, 74, 78, 79]))
    ads = rng.choice([1, 6, 7, 8], size=adsorbate_atoms)
    vacuum = 12.0
    lattice = np.diag([nx * a0, ny * a0, layers * a0 / 2 + vacuum])
    fracs, numbers = [], []
    for iz in range(layers):
        for ix in range(nx):
            for iy in range(ny):
                off = 0.5 if iz % 2 else 0.0
                fracs.append([
                    ((ix + off) / nx) % 1.0,
                    ((iy + off) / ny) % 1.0,
                    (iz * a0 / 2) / lattice[2, 2],
                ])
                numbers.append(metal)
    surface_z = (layers - 1) * a0 / 2
    for k, z in enumerate(ads):
        fracs.append([
            rng.uniform(0, 1),
            rng.uniform(0, 1),
            (surface_z + 1.6 + 1.1 * k) / lattice[2, 2],
        ])
        numbers.append(int(z))
    s = Structure(lattice, np.array(fracs), np.array(numbers, np.int32))
    # a small thermal rattle, so the graphs are not perfectly degenerate
    return Structure(
        lattice,
        s.frac_coords + rng.normal(0, 0.01, s.frac_coords.shape),
        s.numbers,
    )


def synthetic_oc20_dataset(
    num_structures: int, seed: int = 0
) -> list[tuple[str, Structure, float]]:
    """[(id, slab Structure, adsorption-energy-like target)]: 3x3x4+1 = 37
    up to 6x6x7+3 = 255 atoms."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num_structures):
        s = synthetic_slab(
            rng,
            nx=int(rng.integers(3, 7)),
            ny=int(rng.integers(3, 7)),
            layers=int(rng.integers(4, 8)),
            adsorbate_atoms=int(rng.integers(1, 4)),
        )
        t = synthetic_target(s, noise=0.02, rng=rng)
        out.append((f"slab-{i:06d}", s, t))
    return out
