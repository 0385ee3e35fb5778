"""Neighbor lists on cells where the M-th neighbor sits on a distance tie.

High-symmetry cells put many neighbors at exactly one distance, so which
of them fill the last of the M slots is decided by the tie-break alone.
The reference's canonical order is atom-major, image-minor (the JAX raw
wire's and its numpy backend's). On cubic SrTiO3, fcc Cu, rock-salt NaCl
and diamond Si, each at 8 A / M=12, 6 A / 12 and 5 A / 8, the port's
featurized graph must be bit-equal to the JAX numpy backend's, and its
neighbors and edge mask bit-equal to the port's own raw-wire graph
(``raw_neighbor_graph_host``, f32 distances) except where f32 breaks the
ties (diamond Si: same shells, other indices). The JAX package's default
host search (its native cell list, where it builds) keeps the candidates
in cell-list order instead; one case names that difference on SrTiO3.
Every cell is built here from its lattice constant."""

import numpy as np
import pytest

from cgnn_tpu.data import dataset as jdataset
from cgnn_tpu.data.structure import Structure as JStructure
from cgnn_tpu_torch.data import dataset as tdataset
from cgnn_tpu_torch.data import rawbatch as tr
from cgnn_tpu_torch.data.structure import Structure

_FCC = [[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]]


def _cell(name):
    """(lattice constant in A, fractional positions, atomic numbers) of a
    conventional cubic cell."""
    if name == "SrTiO3":  # cubic perovskite
        return 3.905, [[0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.5, 0.5, 0.0],
                       [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]], [38, 22, 8, 8, 8]
    if name == "Cu":  # fcc
        return 3.615, _FCC, [29] * 4
    if name == "NaCl":  # rock salt: Na on fcc, Cl on fcc + (1/2, 0, 0)
        cl = [[(x + 0.5) % 1.0, y, z] for x, y, z in _FCC]
        return 5.640, _FCC + cl, [11] * 4 + [17] * 4
    if name == "Si":  # diamond: fcc + fcc shifted by (1/4, 1/4, 1/4)
        return 5.431, _FCC + [[x + 0.25, y + 0.25, z + 0.25]
                              for x, y, z in _FCC], [14] * 8
    raise KeyError(name)


CELLS = ("SrTiO3", "Cu", "NaCl", "Si")
CUTS = ((8.0, 12), (6.0, 12), (5.0, 8))  # (radius A, M)


def _structures(name):
    a, frac, numbers = _cell(name)
    lattice = np.eye(3) * a
    return (Structure(lattice, frac, numbers),
            JStructure(lattice, np.asarray(frac), np.asarray(numbers)))


def _featurize(name, radius, m):
    port, ref = _structures(name)
    tg = tdataset.featurize_structure(
        port, 0.0, tdataset.FeaturizeConfig(radius=radius, max_num_nbr=m),
        name, keep_geometry=True)
    jg = jdataset.featurize_structure(
        ref, 0.0, jdataset.FeaturizeConfig(radius=radius, max_num_nbr=m),
        name)
    return tg, jg


@pytest.fixture
def jax_numpy_backend(monkeypatch):
    """Force the JAX package's neighbor search onto its numpy backend."""
    import cgnn_tpu.native

    monkeypatch.setattr(cgnn_tpu.native, "neighbor_search_native",
                        lambda *a, **k: None)


def _has_ties(graph, m):
    """Whether some center's M-th kept neighbor ties with the next one
    the cut dropped, or with another kept neighbor (the cases the
    tie-break decides)."""
    d = graph.distances
    _, counts = np.unique(graph.centers, return_counts=True)
    return bool((counts == m).any()) and len(np.unique(d)) < len(d)


@pytest.mark.parametrize("radius,m", CUTS)
@pytest.mark.parametrize("name", CELLS)
def test_featurized_graph_bit_equal_to_jax_numpy_backend(
        jax_numpy_backend, name, radius, m):
    tg, jg = _featurize(name, radius, m)
    assert _has_ties(tg, m)
    for key in ("centers", "neighbors", "distances", "edge_fea",
                "atom_fea"):
        got, want = getattr(tg, key), np.asarray(getattr(jg, key))
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


# Cells whose exact f64 ties the wire's f32 distances break: in diamond Si
# the four first-shell bonds come out 1 ulp apart in f32, so the raw wire
# orders (and, at the cut, picks) the tied atoms by that roundoff, as the
# JAX raw wire does, not in the canonical order.
F32_TIE_BREAKS = {"Si"}


@pytest.mark.parametrize("radius,m", CUTS)
@pytest.mark.parametrize("name", CELLS)
def test_featurized_graph_equals_raw_wire_graph(name, radius, m):
    """The featurized graph in the dense layout against the raw wire's,
    the cell shipped as its client would (f32 fractional positions and
    lattice): each center's kept neighbors in order are its raw-wire slots
    (bit-equal indices and edge mask; distances f32 on the wire, to 2e-5
    A). Where f32 breaks the ties (diamond Si), the indices differ and
    each center's shells agree: the same species at the same distances.
    The port's wire graph is bit-equal to the JAX raw wire's either way."""
    from cgnn_tpu.data import rawbatch as jr

    tg, _ = _featurize(name, radius, m)
    raw = tr.RawStructure.from_structure(_structures(name)[0])
    gdf = tdataset.FeaturizeConfig(radius=radius, max_num_nbr=m).gdf()
    images = tr.host_image_counts(raw.lattice, radius)
    spec = tr.RawSpec(snode_cap=raw.num_nodes, images=images, radius=radius,
                      dense_m=m, gauss_filter=gdf.filter, gauss_var=gdf.var)
    assert spec.admits(raw)
    frac = np.asarray(raw.frac_coords, np.float32) % np.float32(1.0)
    n = raw.num_nodes
    got = tr.raw_neighbor_graph_host(frac, raw.lattice, np.ones(n, np.uint8),
                                     spec)
    want = jr.raw_neighbor_graph_host(
        frac, raw.lattice, np.ones(n, np.uint8),
        jr.RawSpec(snode_cap=n, images=images, radius=radius, dense_m=m,
                   gauss_filter=gdf.filter, gauss_var=gdf.var))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    nbr, dist, emask, n_edges, overflow = got
    assert not overflow and n_edges == len(tg.centers)
    counts = np.bincount(tg.centers, minlength=n)
    assert (counts == m).all()  # every cut keeps M: the ties decide
    np.testing.assert_array_equal(emask.sum(axis=1), counts)
    np.testing.assert_allclose(dist.reshape(-1), tg.distances, rtol=0,
                               atol=2e-5)
    if name not in F32_TIE_BREAKS:
        np.testing.assert_array_equal(nbr.reshape(-1), tg.neighbors)
        return
    assert not np.array_equal(nbr.reshape(-1), tg.neighbors)
    numbers = np.asarray(raw.numbers)
    np.testing.assert_array_equal(numbers[nbr.reshape(-1)],
                                  numbers[tg.neighbors])


def _shell_species(graph, numbers):
    """{center's Z: sorted list of (neighbor Z, count)} over the graph."""
    out = {}
    for z in np.unique(numbers):
        nb = graph.neighbors[np.isin(graph.centers, np.flatnonzero(
            numbers == z))]
        zs, cs = np.unique(numbers[nb], return_counts=True)
        out[int(z)] = sorted(zip(zs.tolist(), cs.tolist()))
    return out


def test_jax_default_search_differs_on_srtio3():
    """The JAX package's default host search (backend 'auto': its native
    cell list) keeps an O center's tied twelfth-shell neighbors in
    cell-list order; the canonical order, which the port and the JAX numpy
    backend and raw wire keep, picks others. At 8 A / M=12 each O center
    keeps 2 Ti and 10 of the Sr/O shell at a/sqrt(2): which ten is the
    difference."""
    import cgnn_tpu.native

    if not cgnn_tpu.native.native_available():
        pytest.skip("the JAX package's native neighbor search does not "
                    "build here (no C++ compiler), so its default path is "
                    "the numpy backend")
    tg, jg = _featurize("SrTiO3", 8.0, 12)
    numbers = np.asarray(_cell("SrTiO3")[2])
    port, ref = _shell_species(tg, numbers), _shell_species(jg, numbers)
    # summed over the three O centers: 6 O, 2 Ti, 4 Sr each in the port
    assert port[8] == [(8, 3 * 6), (22, 3 * 2), (38, 3 * 4)]
    assert ref[8] == [(8, 3 * 8), (22, 3 * 2), (38, 3 * 2)]
    # the same distances, so the same edge features row for row
    np.testing.assert_array_equal(np.sort(tg.distances),
                                  np.sort(np.asarray(jg.distances)))
    assert not np.array_equal(tg.neighbors, np.asarray(jg.neighbors))
