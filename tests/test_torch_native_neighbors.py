"""The port's native host neighbor search (``cgnn_tpu_torch/native``: a
C++ cell list built with g++ at first use, its candidates' distances
recomputed by the numpy search's own arithmetic) against:

- the port's numpy backend: bit-equal arrays (centers, neighbors, f32
  distances, offsets), order included, on random cells, OC20-like slabs,
  tiny cells that need many images, and the four tie cells of
  tests/test_torch_ties.py at each of their cuts;
- the JAX package's numpy backend: bit-equal, the same way;
- the JAX package's native cell list: equal as canonically sorted sets
  (integers exact), its distances within its own test's atol 1e-5
  (tests/test_neighbors.py), since it keeps cell-list order and its own
  distance formula;
- the featurized tie graphs: the port's default search gives the JAX
  numpy backend's graphs bit for bit, and on SrTiO3 not the JAX default's
  (its native cell list keeps cell-list order at the M-th slot tie:
  ROADMAP Queue 3, item 1);
- speed: >= 10x the numpy backend on a >= 200-atom slab, the JAX test's
  bound;
- the backends' rules: 'auto' is numpy with one line on stderr where g++
  is not on PATH, 'native' raises there, a failed build raises with the
  compiler's output, threads building at once get one library.

Where g++ is not on PATH the native cases skip, naming it; where it is,
a build failure fails them.
"""

import shutil
import threading
import time

import numpy as np
import pytest

from cgnn_tpu.data import neighbors as jneighbors
from cgnn_tpu.data.structure import Structure as JStructure
from cgnn_tpu_torch import native
from cgnn_tpu_torch.data import neighbors as tneighbors
from cgnn_tpu_torch.data import synthetic as tsynthetic
from cgnn_tpu_torch.data.structure import Structure, lattice_from_parameters
from cgnn_tpu_torch.ops import _build
from test_torch_ties import CELLS, CUTS, _featurize, _has_ties, _structures

FIELDS = ("centers", "neighbors", "distances", "offsets")


@pytest.fixture
def gxx():
    """Skips a native case where g++ is not on PATH (decided here, not at
    import); where it is, a build failure fails the case."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH: the native neighbor search "
                    "builds with g++")


def _random_structure(rng, n_atoms):
    """tests/test_neighbors.py's random cell (its generator, its draws)."""
    abc = rng.uniform(2.5, 6.0, size=3)
    angles = rng.uniform(60.0, 120.0, size=3)
    while True:
        try:
            lat = lattice_from_parameters(*abc, *angles)
            break
        except ValueError:
            angles = rng.uniform(70.0, 110.0, size=3)
    return Structure(lat, rng.uniform(0, 1, size=(n_atoms, 3)),
                     rng.integers(1, 80, size=n_atoms))


def _cases():
    """(name, port Structure, radius) for every structure of the file."""
    out = []
    for seed in range(8):
        rng = np.random.default_rng(seed)
        out.append((f"random{seed}",
                    _random_structure(rng, int(rng.integers(2, 16))),
                    float(rng.uniform(3.0, 8.0))))
    # positions on a quarter grid: many exact distance ties
    rng = np.random.default_rng(11)
    s = _random_structure(rng, 12)
    out.append(("quarter_grid", Structure(
        s.lattice, np.round(rng.uniform(-1, 2, (12, 3)) * 4) / 4,
        s.numbers), 6.0))
    for i, kw in enumerate(({"nx": 4, "ny": 4, "layers": 5,
                             "adsorbate_atoms": 2},
                            {"nx": 3, "ny": 5, "layers": 4,
                             "adsorbate_atoms": 3})):
        out.append((f"slab{i}", tsynthetic.synthetic_slab(
            np.random.default_rng(5 + i), **kw), 6.0))
    out.append(("tiny", Structure(np.diag([2.1, 2.3, 2.0]),
                                  [[0.1, 0.2, 0.3], [0.6, 0.7, 0.8]],
                                  [6, 8]), 7.0))
    out.append(("tiny_negative", Structure(
        np.diag([2.1, 2.3, 2.0]), [[-0.1, 1.2, -0.7], [0.6, -0.3, 2.8]],
        [6, 8]), 5.0))
    for name in CELLS:
        for radius, _ in CUTS:
            out.append((f"{name}_{radius}", _structures(name)[0], radius))
    return out


CASES = {name: (s, r) for name, s, r in _cases()}


def _jax(s: Structure) -> JStructure:
    return JStructure(s.lattice, s.frac_coords, s.numbers)


def _assert_bit_equal(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_bit_equal_to_both_numpy_backends(gxx, case):
    """Tolerance: none (bit-equal, order included)."""
    s, radius = CASES[case]
    got = tneighbors.neighbor_list(s, radius, backend="native")
    assert native.backend_used() == "native"
    assert len(got) > 0
    _assert_bit_equal(got, tneighbors.neighbor_list(s, radius,
                                                    backend="numpy"))
    assert native.backend_used() == "numpy"
    _assert_bit_equal(got, jneighbors.neighbor_list(_jax(s), radius,
                                                    backend="numpy"))
    # the default resolves to native here, and so does the k-nearest cut
    _assert_bit_equal(tneighbors.neighbor_list(s, radius), got)
    assert native.backend_used() == "native"
    _assert_bit_equal(
        tneighbors.knn_neighbor_list(s, radius, 12,
                                     warn_under_coordinated=False),
        tneighbors.knn_neighbor_list(s, radius, 12, backend="numpy",
                                     warn_under_coordinated=False))


def _canon(c, nb, d, off):
    key = np.lexsort((off[:, 2], off[:, 1], off[:, 0], nb, c))
    return c[key], nb[key], d[key], off[key]


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_equals_jax_native_as_sets(gxx, case):
    """Integers exact as canonically sorted sets; distances atol 1e-5
    (the JAX test's tolerance between its native and numpy searches)."""
    from cgnn_tpu.native import neighbor_search_native

    s, radius = CASES[case]
    ref = neighbor_search_native(s.lattice, s.frac_coords, radius)
    if ref is None:
        pytest.skip("the JAX package's native search does not build here")
    got = tneighbors.neighbor_list(s, radius, backend="native")
    cg, ng, dg, og = _canon(got.centers, got.neighbors, got.distances,
                            got.offsets)
    cr, nr, dr, orr = _canon(*ref)
    np.testing.assert_array_equal(cg, cr)
    np.testing.assert_array_equal(ng, nr)
    np.testing.assert_array_equal(og, orr)
    np.testing.assert_allclose(dg, dr, rtol=0, atol=1e-5)


def test_native_matches_the_brute_force_oracle(gxx):
    """The explicit loop (``neighbor_list_brute``) as an independent
    oracle: the same pairs in the same order, distances within 1e-6 A
    (another formula: ``np.linalg.norm`` of each difference)."""
    for case in ("random0", "random3", "tiny", "NaCl_5.0"):
        s, radius = CASES[case]
        got = tneighbors.neighbor_list(s, radius, backend="native")
        want = tneighbors.neighbor_list_brute(s, radius)
        for f in ("centers", "neighbors", "offsets"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_allclose(got.distances, want.distances, rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("radius,m", CUTS)
@pytest.mark.parametrize("name", CELLS)
def test_featurized_tie_graphs_follow_the_canonical_order(gxx, name, radius,
                                                          m, monkeypatch):
    """The port's default search (native here) featurizes each tie cell
    into the JAX numpy backend's graph, bit for bit (tolerance: none)."""
    import cgnn_tpu.native

    monkeypatch.setattr(cgnn_tpu.native, "neighbor_search_native",
                        lambda *a, **k: None)  # the JAX numpy backend
    tg, jg = _featurize(name, radius, m)
    assert native.backend_used() == "native"
    assert _has_ties(tg, m)
    want = {key: np.asarray(getattr(jg, key))
            for key in ("centers", "neighbors", "distances", "edge_fea")}
    want["offsets"] = jneighbors.knn_neighbor_list(
        _structures(name)[1], radius, m,
        warn_under_coordinated=False).offsets
    for key, b in want.items():
        a = getattr(tg, key)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def test_srtio3_differs_from_the_jax_default_search(gxx):
    """ROADMAP Queue 3, item 1: at 8 A / M=12 the JAX default search (its
    native cell list) keeps an O center's tied twelfth-shell neighbors in
    cell-list order; the port's native search keeps the canonical order,
    so the two graphs hold other neighbors at the same distances."""
    import cgnn_tpu.native

    if not cgnn_tpu.native.native_available():
        pytest.skip("the JAX package's native search does not build here")
    tg, jg = _featurize("SrTiO3", 8.0, 12)
    assert native.backend_used() == "native"
    np.testing.assert_array_equal(np.sort(tg.distances),
                                  np.sort(np.asarray(jg.distances)))
    assert not np.array_equal(tg.neighbors, np.asarray(jg.neighbors))


def test_native_is_ten_times_numpy_on_a_slab(gxx):
    """>= 10x the numpy backend on a >= 200-atom slab (the JAX test's
    bound for its own cell list), the best of 3 timings each."""
    s = tsynthetic.synthetic_slab(np.random.default_rng(7), nx=6, ny=6,
                                  layers=6, adsorbate_atoms=3)
    assert s.num_atoms >= 200

    def best(backend, reps):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(reps):
                tneighbors.neighbor_list(s, 6.0, backend=backend)
            times.append((time.perf_counter() - t0) / reps)
        return min(times)

    tneighbors.neighbor_list(s, 6.0, backend="native")  # build, warm
    assert best("numpy", 1) / best("native", 10) > 10.0


def test_auto_without_gxx_is_numpy_and_says_so(monkeypatch, capsys,
                                               tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))  # an empty directory
    monkeypatch.setattr(native, "_said_no_gxx", False)
    s, radius = CASES["random1"]
    got = tneighbors.neighbor_list(s, radius)
    tneighbors.neighbor_list(s, radius)
    assert native.backend_used() == "numpy"
    err = capsys.readouterr().err
    assert err.count("g++ not on PATH") == 1
    _assert_bit_equal(got, tneighbors.neighbor_list(s, radius,
                                                    backend="numpy"))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tneighbors.neighbor_list(s, radius, backend="native")
    with pytest.raises(ValueError, match="unknown backend"):
        tneighbors.neighbor_list(s, radius, backend="cell")


def test_failed_build_raises_with_the_compiler_output(gxx, monkeypatch,
                                                      tmp_path):
    broken = tmp_path / "neighbors.cpp"
    broken.write_text("extern \"C\" int cgnn_torch_neighbor_candidates( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "_fn", None)
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "native")
    s, radius = CASES["random1"]
    for backend in ("auto", "native"):
        with pytest.raises(RuntimeError,
                           match="(?s)g\\+\\+ failed.*error:"):
            tneighbors.neighbor_list(s, radius, backend=backend)
    assert not list((tmp_path / "native").glob("*.tmp"))


def test_builds_at_once_give_one_library(gxx, monkeypatch, tmp_path):
    """Threads (as parallel featurization workers) building the same
    source at once: each gets the one hashed library, and no temporary
    file is left behind."""
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "native")
    paths, errors = [], []

    def build():
        try:
            paths.append(_build.build_host(native.SOURCE))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=build, name=f"build-{i}")
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1 and paths[0].exists()
    assert [p.name for p in (tmp_path / "native").iterdir()] == [
        paths[0].name]
