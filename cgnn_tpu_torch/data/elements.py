"""Element property table and the 92-dim one-hot atom featurizer.

The reference lineage initializes atom features from an ``atom_init.json``
file mapping atomic number -> 92-dim binary vector built by one-hot
discretizing elemental properties (SURVEY.md §2 component 3). That file is not
on disk and pymatgen is unavailable, so the table is regenerated here from an
in-tree element-property table (approximate literature values: Pauling
electronegativity, Cordero covalent radii, NIST ionization energies /
electron affinities, molar volumes). Properties that are undefined for an
element (e.g. noble-gas electronegativity) produce an all-zero segment,
mirroring the reference lineage's handling of missing values.

Feature layout (total 92):
    group one-hot            18   (1-18; f-block mapped to group 3)
    period one-hot            8   (1-7 used; slot 8 reserved)
    electronegativity bins   10   (Pauling, linear in [0.5, 4.0])
    covalent radius bins     10   (pm, linear in [25, 250])
    valence electrons        12   (1-12, clipped)
    first ionization bins    10   (eV, log in [ln 3, ln 25])
    electron affinity bins   10   (eV, linear in [-3.0, 3.7])
    block one-hot             4   (s, p, d, f)
    atomic volume bins       10   (ln cm^3/mol, linear in [1.5, 4.3])
"""

from __future__ import annotations

import functools
import math

import numpy as np

NAN = float("nan")

# Z: (symbol, group, period, block, electronegativity, covalent_radius_pm,
#     n_valence, first_ionization_eV, electron_affinity_eV, molar_volume_cm3)
# Approximate literature values; NaN where the property is undefined/unknown.
ELEMENTS: dict[int, tuple] = {
    1: ("H", 1, 1, "s", 2.20, 31, 1, 13.60, 0.75, 11.4),
    2: ("He", 18, 1, "s", NAN, 28, 2, 24.59, NAN, 27.2),
    3: ("Li", 1, 2, "s", 0.98, 128, 1, 5.39, 0.62, 13.1),
    4: ("Be", 2, 2, "s", 1.57, 96, 2, 9.32, NAN, 4.9),
    5: ("B", 13, 2, "p", 2.04, 84, 3, 8.30, 0.28, 4.4),
    6: ("C", 14, 2, "p", 2.55, 76, 4, 11.26, 1.26, 5.3),
    7: ("N", 15, 2, "p", 3.04, 71, 5, 14.53, NAN, 13.5),
    8: ("O", 16, 2, "p", 3.44, 66, 6, 13.62, 1.46, 14.0),
    9: ("F", 17, 2, "p", 3.98, 57, 7, 17.42, 3.40, 17.1),
    10: ("Ne", 18, 2, "p", NAN, 58, 8, 21.56, NAN, 16.8),
    11: ("Na", 1, 3, "s", 0.93, 166, 1, 5.14, 0.55, 23.7),
    12: ("Mg", 2, 3, "s", 1.31, 141, 2, 7.65, NAN, 14.0),
    13: ("Al", 13, 3, "p", 1.61, 121, 3, 5.99, 0.44, 10.0),
    14: ("Si", 14, 3, "p", 1.90, 111, 4, 8.15, 1.39, 12.1),
    15: ("P", 15, 3, "p", 2.19, 107, 5, 10.49, 0.75, 17.0),
    16: ("S", 16, 3, "p", 2.58, 105, 6, 10.36, 2.08, 15.5),
    17: ("Cl", 17, 3, "p", 3.16, 102, 7, 12.97, 3.61, 18.7),
    18: ("Ar", 18, 3, "p", NAN, 106, 8, 15.76, NAN, 24.2),
    19: ("K", 1, 4, "s", 0.82, 203, 1, 4.34, 0.50, 45.3),
    20: ("Ca", 2, 4, "s", 1.00, 176, 2, 6.11, 0.02, 26.2),
    21: ("Sc", 3, 4, "d", 1.36, 170, 3, 6.56, 0.19, 15.0),
    22: ("Ti", 4, 4, "d", 1.54, 160, 4, 6.83, 0.08, 10.6),
    23: ("V", 5, 4, "d", 1.63, 153, 5, 6.75, 0.53, 8.3),
    24: ("Cr", 6, 4, "d", 1.66, 139, 6, 6.77, 0.67, 7.2),
    25: ("Mn", 7, 4, "d", 1.55, 139, 7, 7.43, NAN, 7.4),
    26: ("Fe", 8, 4, "d", 1.83, 132, 8, 7.90, 0.15, 7.1),
    27: ("Co", 9, 4, "d", 1.88, 126, 9, 7.88, 0.66, 6.7),
    28: ("Ni", 10, 4, "d", 1.91, 124, 10, 7.64, 1.16, 6.6),
    29: ("Cu", 11, 4, "d", 1.90, 132, 11, 7.73, 1.24, 7.1),
    30: ("Zn", 12, 4, "d", 1.65, 122, 12, 9.39, NAN, 9.2),
    31: ("Ga", 13, 4, "p", 1.81, 122, 3, 6.00, 0.30, 11.8),
    32: ("Ge", 14, 4, "p", 2.01, 120, 4, 7.90, 1.23, 13.6),
    33: ("As", 15, 4, "p", 2.18, 119, 5, 9.79, 0.80, 13.1),
    34: ("Se", 16, 4, "p", 2.55, 120, 6, 9.75, 2.02, 16.4),
    35: ("Br", 17, 4, "p", 2.96, 120, 7, 11.81, 3.36, 23.5),
    36: ("Kr", 18, 4, "p", 3.00, 116, 8, 14.00, NAN, 27.9),
    37: ("Rb", 1, 5, "s", 0.82, 220, 1, 4.18, 0.49, 55.8),
    38: ("Sr", 2, 5, "s", 0.95, 195, 2, 5.69, 0.05, 33.9),
    39: ("Y", 3, 5, "d", 1.22, 190, 3, 6.22, 0.31, 19.9),
    40: ("Zr", 4, 5, "d", 1.33, 175, 4, 6.63, 0.43, 14.0),
    41: ("Nb", 5, 5, "d", 1.60, 164, 5, 6.76, 0.89, 10.8),
    42: ("Mo", 6, 5, "d", 2.16, 154, 6, 7.09, 0.75, 9.4),
    43: ("Tc", 7, 5, "d", 1.90, 147, 7, 7.28, 0.55, 8.5),
    44: ("Ru", 8, 5, "d", 2.20, 146, 8, 7.36, 1.05, 8.3),
    45: ("Rh", 9, 5, "d", 2.28, 142, 9, 7.46, 1.14, 8.3),
    46: ("Pd", 10, 5, "d", 2.20, 139, 10, 8.34, 0.56, 8.9),
    47: ("Ag", 11, 5, "d", 1.93, 145, 11, 7.58, 1.30, 10.3),
    48: ("Cd", 12, 5, "d", 1.69, 144, 12, 8.99, NAN, 13.0),
    49: ("In", 13, 5, "p", 1.78, 142, 3, 5.79, 0.30, 15.7),
    50: ("Sn", 14, 5, "p", 1.96, 139, 4, 7.34, 1.11, 16.3),
    51: ("Sb", 15, 5, "p", 2.05, 139, 5, 8.61, 1.05, 18.2),
    52: ("Te", 16, 5, "p", 2.10, 138, 6, 9.01, 1.97, 20.5),
    53: ("I", 17, 5, "p", 2.66, 139, 7, 10.45, 3.06, 25.7),
    54: ("Xe", 18, 5, "p", 2.60, 140, 8, 12.13, NAN, 35.9),
    55: ("Cs", 1, 6, "s", 0.79, 244, 1, 3.89, 0.47, 70.0),
    56: ("Ba", 2, 6, "s", 0.89, 215, 2, 5.21, 0.14, 38.2),
    57: ("La", 3, 6, "f", 1.10, 207, 3, 5.58, 0.47, 22.5),
    58: ("Ce", 3, 6, "f", 1.12, 204, 4, 5.54, 0.65, 20.7),
    59: ("Pr", 3, 6, "f", 1.13, 203, 5, 5.47, 0.96, 20.8),
    60: ("Nd", 3, 6, "f", 1.14, 201, 6, 5.53, 1.92, 20.6),
    61: ("Pm", 3, 6, "f", 1.13, 199, 7, 5.58, NAN, 20.2),
    62: ("Sm", 3, 6, "f", 1.17, 198, 8, 5.64, NAN, 19.9),
    63: ("Eu", 3, 6, "f", 1.20, 198, 9, 5.67, 0.86, 28.9),
    64: ("Gd", 3, 6, "f", 1.20, 196, 10, 6.15, NAN, 19.9),
    65: ("Tb", 3, 6, "f", 1.20, 194, 11, 5.86, NAN, 19.2),
    66: ("Dy", 3, 6, "f", 1.22, 192, 12, 5.94, NAN, 19.0),
    67: ("Ho", 3, 6, "f", 1.23, 192, 12, 6.02, NAN, 18.7),
    68: ("Er", 3, 6, "f", 1.24, 189, 12, 6.11, NAN, 18.4),
    69: ("Tm", 3, 6, "f", 1.25, 190, 12, 6.18, 1.03, 18.1),
    70: ("Yb", 3, 6, "f", 1.10, 187, 12, 6.25, NAN, 24.8),
    71: ("Lu", 3, 6, "d", 1.27, 187, 3, 5.43, 0.34, 17.8),
    72: ("Hf", 4, 6, "d", 1.30, 175, 4, 6.83, 0.02, 13.6),
    73: ("Ta", 5, 6, "d", 1.50, 170, 5, 7.55, 0.32, 10.9),
    74: ("W", 6, 6, "d", 2.36, 162, 6, 7.86, 0.82, 9.5),
    75: ("Re", 7, 6, "d", 1.90, 151, 7, 7.83, 0.15, 8.9),
    76: ("Os", 8, 6, "d", 2.20, 144, 8, 8.44, 1.10, 8.4),
    77: ("Ir", 9, 6, "d", 2.20, 141, 9, 8.97, 1.57, 8.5),
    78: ("Pt", 10, 6, "d", 2.28, 136, 10, 8.96, 2.13, 9.1),
    79: ("Au", 11, 6, "d", 2.54, 136, 11, 9.23, 2.31, 10.2),
    80: ("Hg", 12, 6, "d", 2.00, 132, 12, 10.44, NAN, 14.8),
    81: ("Tl", 13, 6, "p", 1.62, 145, 3, 6.11, 0.20, 17.2),
    82: ("Pb", 14, 6, "p", 2.33, 146, 4, 7.42, 0.36, 18.3),
    83: ("Bi", 15, 6, "p", 2.02, 148, 5, 7.29, 0.95, 21.3),
    84: ("Po", 16, 6, "p", 2.00, 140, 6, 8.41, 1.90, 22.7),
    85: ("At", 17, 6, "p", 2.20, 150, 7, 9.32, 2.80, NAN),
    86: ("Rn", 18, 6, "p", NAN, 150, 8, 10.75, NAN, 50.5),
    87: ("Fr", 1, 7, "s", 0.70, 260, 1, 4.07, 0.46, NAN),
    88: ("Ra", 2, 7, "s", 0.90, 221, 2, 5.28, 0.10, 41.1),
    89: ("Ac", 3, 7, "f", 1.10, 215, 3, 5.17, 0.35, 37.4),
    90: ("Th", 3, 7, "f", 1.30, 206, 4, 6.31, 0.60, 19.8),
    91: ("Pa", 3, 7, "f", 1.50, 200, 5, 5.89, 0.55, 15.0),
    92: ("U", 3, 7, "f", 1.38, 196, 6, 6.19, 0.53, 12.5),
    93: ("Np", 3, 7, "f", 1.36, 190, 7, 6.27, 0.48, 11.6),
    94: ("Pu", 3, 7, "f", 1.28, 187, 8, 6.03, NAN, 12.3),
    95: ("Am", 3, 7, "f", 1.30, 180, 9, 5.97, NAN, 17.6),
    96: ("Cm", 3, 7, "f", 1.30, 169, 10, 5.99, NAN, 18.1),
    97: ("Bk", 3, 7, "f", 1.30, NAN, 11, 6.20, NAN, NAN),
    98: ("Cf", 3, 7, "f", 1.30, NAN, 12, 6.28, NAN, NAN),
    99: ("Es", 3, 7, "f", 1.30, NAN, 12, 6.42, NAN, NAN),
    100: ("Fm", 3, 7, "f", 1.30, NAN, 12, 6.50, NAN, NAN),
}

SYMBOL_TO_Z: dict[str, int] = {v[0]: z for z, v in ELEMENTS.items()}
# hydrogen-isotope aliases: neutron-diffraction CIFs label deuterium and
# tritium sites 'D'/'T'; chemically they featurize as hydrogen
SYMBOL_TO_Z["D"] = 1
SYMBOL_TO_Z["T"] = 1
Z_TO_SYMBOL: dict[int, str] = {z: v[0] for z, v in ELEMENTS.items()}

MAX_Z = 100
ATOM_FEA_DIM = 92

_BLOCKS = ("s", "p", "d", "f")


def _one_hot(index: int, size: int) -> np.ndarray:
    v = np.zeros(size, dtype=np.float32)
    if 0 <= index < size:
        v[index] = 1.0
    return v


def _binned(value: float, lo: float, hi: float, nbins: int, log: bool = False) -> np.ndarray:
    """One-hot bin of a continuous property; all-zeros when value is NaN."""
    v = np.zeros(nbins, dtype=np.float32)
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return v
    x = math.log(value) if log else value
    lo_t = math.log(lo) if log else lo
    hi_t = math.log(hi) if log else hi
    frac = (x - lo_t) / (hi_t - lo_t)
    idx = min(nbins - 1, max(0, int(frac * nbins)))
    v[idx] = 1.0
    return v


@functools.lru_cache(maxsize=None)
def _feature_row(z: int) -> np.ndarray:
    if z not in ELEMENTS:
        raise KeyError(f"no element data for Z={z} (supported: 1..{MAX_Z})")
    _, group, period, block, en, radius, valence, ie, ea, vol = ELEMENTS[z]
    log_vol = NAN if (isinstance(vol, float) and math.isnan(vol)) else math.log(vol)
    parts = [
        _one_hot(group - 1, 18),
        _one_hot(period - 1, 8),
        _binned(en, 0.5, 4.0, 10),
        _binned(radius, 25.0, 250.0, 10),
        _one_hot(int(np.clip(valence, 1, 12)) - 1, 12),
        _binned(ie, 3.0, 25.0, 10, log=True),
        _binned(ea, -3.0, 3.7, 10),
        _one_hot(_BLOCKS.index(block), 4),
        _binned(log_vol, 1.5, 4.3, 10),
    ]
    row = np.concatenate(parts)
    assert row.shape == (ATOM_FEA_DIM,)
    return row


def atom_features(numbers) -> np.ndarray:
    """[N] atomic numbers -> [N, 92] float32 feature matrix."""
    numbers = np.asarray(numbers, dtype=np.int64).ravel()
    return np.stack([_feature_row(int(z)) for z in numbers]).astype(np.float32)


@functools.lru_cache(maxsize=1)
def full_embedding_table() -> np.ndarray:
    """[MAX_Z + 1, 92] table; row 0 is zeros (no element)."""
    table = np.zeros((MAX_Z + 1, ATOM_FEA_DIM), dtype=np.float32)
    for z in range(1, MAX_Z + 1):
        table[z] = _feature_row(z)
    return table
