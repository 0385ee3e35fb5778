"""The port's host data layer against the JAX package's: synthetic
structures, neighbor lists, featurization, dense packing with the
transpose slots, the training batch iterator, the split and the shape
ladder. Integer and mask arrays must be bit-equal; floats f32-equal."""

import warnings

import numpy as np
import pytest

from cgnn_tpu.data import dataset as jdataset
from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.data import neighbors as jneighbors
from cgnn_tpu.data import synthetic as jsynthetic
from cgnn_tpu.data.structure import Structure as JStructure
from cgnn_tpu.serve import shapes as jshapes
from cgnn_tpu_torch.data import dataset as tdataset
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.data import neighbors as tneighbors
from cgnn_tpu_torch.data import synthetic as tsynthetic
from cgnn_tpu_torch.data.elements import atom_features, full_embedding_table
from cgnn_tpu_torch.data.structure import Structure
from cgnn_tpu_torch.serve import shapes as tshapes

SMALL = dict(radius=5.0, max_num_nbr=8)


@pytest.fixture
def jax_numpy_backend(monkeypatch):
    """Force the JAX package's neighbor search onto its numpy backend."""
    import cgnn_tpu.native

    monkeypatch.setattr(cgnn_tpu.native, "neighbor_search_native",
                        lambda *a, **k: None)


def _structures():
    """Small cells and MP-like cells, drawn by the JAX generator."""
    small = [s for _, s, _ in jsynthetic.synthetic_dataset(
        10, seed=2, max_atoms=6)]
    mp = [s for _, s, _ in jsynthetic.synthetic_mp_dataset(4, seed=5)]
    return small + mp


def _port(s: JStructure) -> Structure:
    return Structure(s.lattice, s.frac_coords, s.numbers)


def _port_graph(g) -> tgraph.CrystalGraph:
    return tgraph.CrystalGraph(
        atom_fea=g.atom_fea, edge_fea=g.edge_fea, centers=g.centers,
        neighbors=g.neighbors, target=g.target, cif_id=g.cif_id,
        target_mask=g.target_mask, distances=g.distances)


@pytest.mark.parametrize("which", ["synthetic", "mp"])
def test_synthetic_datasets_match(which):
    if which == "synthetic":
        ja = jsynthetic.synthetic_dataset(6, seed=3, max_atoms=8)
        ta = tsynthetic.synthetic_dataset(6, seed=3, max_atoms=8)
    else:
        ja = jsynthetic.synthetic_mp_dataset(4, seed=3)
        ta = tsynthetic.synthetic_mp_dataset(4, seed=3)
    for (ji, js, jt), (ti, ts, tt) in zip(ja, ta, strict=True):
        assert ji == ti and jt == tt
        np.testing.assert_array_equal(js.lattice, ts.lattice)
        np.testing.assert_array_equal(js.frac_coords, ts.frac_coords)
        np.testing.assert_array_equal(js.numbers, ts.numbers)


def test_element_features_match():
    from cgnn_tpu.data import elements as jelements

    np.testing.assert_array_equal(full_embedding_table(),
                                  jelements.full_embedding_table())
    assert full_embedding_table().shape == (101, 92)
    z = np.array([1, 8, 26, 79, 100])
    np.testing.assert_array_equal(atom_features(z),
                                  jelements.atom_features(z))


def test_knn_neighbor_list_bit_equal_to_numpy_backend(jax_numpy_backend):
    for s in _structures():
        want = jneighbors.knn_neighbor_list(s, 5.0, 8,
                                            warn_under_coordinated=False)
        got = tneighbors.knn_neighbor_list(_port(s), 5.0, 8,
                                           warn_under_coordinated=False)
        for field in ("centers", "neighbors", "offsets", "distances"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)


def test_featurize_bit_equal_to_numpy_backend(jax_numpy_backend):
    jcfg = jdataset.FeaturizeConfig(**SMALL)
    tcfg = tdataset.FeaturizeConfig(**SMALL)
    for i, s in enumerate(_structures()):
        want = jdataset.featurize_structure(s, [0.5 * i], jcfg, f"s{i}")
        got = tdataset.featurize_structure(_port(s), [0.5 * i], tcfg,
                                           f"s{i}")
        for field in ("atom_fea", "edge_fea", "centers", "neighbors",
                      "distances", "target"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)


def test_knn_matches_native_backend_within_tolerance():
    """Against the default (C++ native where g++ exists) backend only the
    neighbor sets and distances must agree: ties that differ at 1e-7 can
    reorder slots."""
    for s in _structures():
        want = jneighbors.knn_neighbor_list(s, 5.0, 8,
                                            warn_under_coordinated=False)
        got = tneighbors.knn_neighbor_list(_port(s), 5.0, 8,
                                           warn_under_coordinated=False)
        np.testing.assert_array_equal(got.centers, want.centers)
        for c in np.unique(got.centers):
            a, b = got.centers == c, want.centers == c
            np.testing.assert_allclose(np.sort(got.distances[a]),
                                       np.sort(want.distances[b]),
                                       rtol=0, atol=1e-5)
            # the sets agree below the truncation distance, where no tie
            # can move an edge across the cut
            cut = max(got.distances[a].max(), want.distances[b].max()) - 1e-5
            assert _inner_set(got, a, cut) == _inner_set(want, b, cut)


def _inner_set(nl, sel, cut):
    keep = nl.distances[sel] < cut
    return sorted(zip(nl.neighbors[sel][keep].tolist(),
                      map(tuple, nl.offsets[sel][keep].tolist())))


def _jax_graphs(n=14, seed=2):
    cfg = jdataset.FeaturizeConfig(**SMALL)
    return jdataset.load_synthetic(n, cfg, seed=seed, max_atoms=6)


@pytest.mark.parametrize("n_graphs", [1, 5, 14])
def test_pack_graphs_dense_bit_equal(n_graphs):
    jg = _jax_graphs()[:n_graphs]
    m = 8
    nc = tgraph._align8(sum(g.num_nodes for g in jg) + 5)
    want = jgraph.pack_graphs(jg, nc, nc * m, n_graphs + 3, dense_m=m)
    got = tgraph.pack_graphs([_port_graph(g) for g in jg], nc, nc * m,
                             n_graphs + 3, dense_m=m).numpy()
    for field, a in got.items():
        b = getattr(want, field)
        if a is None:
            assert b is None, field
            continue
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("n_graphs", [1, 6])
def test_keep_geometry_featurize_and_pack_bit_equal(n_graphs,
                                                    jax_numpy_backend):
    """featurize_structure(keep_geometry=True) keeps the same positions,
    lattice, offsets and numbers, and pack_graphs writes positions,
    lattices and edge offsets bit-equal to the JAX package's."""
    jcfg = jdataset.FeaturizeConfig(**SMALL)
    tcfg = tdataset.FeaturizeConfig(**SMALL)
    structs = _structures()[-n_graphs:]
    jg = [jdataset.featurize_structure(s, [0.5], jcfg, f"s{i}",
                                       keep_geometry=True)
          for i, s in enumerate(structs)]
    tg = [tdataset.featurize_structure(_port(s), [0.5], tcfg, f"s{i}",
                                       keep_geometry=True)
          for i, s in enumerate(structs)]
    for a, b in zip(tg, jg):
        for field in ("positions", "lattice", "offsets", "numbers"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype, field
            np.testing.assert_array_equal(x, y, err_msg=field)
    m = 8
    nc = tgraph._align8(sum(g.num_nodes for g in jg) + 5)
    want = jgraph.pack_graphs(jg, nc, nc * m, n_graphs + 3, dense_m=m)
    got = tgraph.pack_graphs(tg, nc, nc * m, n_graphs + 3, dense_m=m)
    _assert_batches_equal(got, want)
    assert np.abs(got.numpy()["positions"]).max() > 0
    # the loaders pass keep_geometry through
    g0 = tdataset.load_synthetic_mp(1, tcfg, seed=4, keep_geometry=True)[0]
    j0 = jdataset.load_synthetic_mp(1, jcfg, seed=4, keep_geometry=True)[0]
    np.testing.assert_array_equal(g0.positions, j0.positions)
    assert tdataset.load_synthetic(1, tcfg, seed=4)[0].lattice is None


def test_pack_graphs_refuses_unported_layouts():
    g = [_port_graph(x) for x in _jax_graphs(2)]
    # COO is ported (tests/test_torch_coo.py); transpose slots stay
    # dense-only, as in the JAX package, and COO counts edges too
    with pytest.raises(ValueError, match="dense layout"):
        tgraph.pack_graphs(g, 64, 512, 4, in_cap=16)
    with pytest.raises(ValueError, match="exceeds capacity"):
        tgraph.pack_graphs(g, 64, 8, 4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tgraph.pack_graphs(g, 64, 512, 4, dense_m=8, in_cap=16, over_cap=16)
    with pytest.raises(ValueError):
        tgraph.pack_graphs(g, 64, 500, 4, dense_m=8)


def _assert_batches_equal(got, want):
    got = got.numpy()
    for field, a in got.items():
        b = getattr(want, field)
        if a is None:
            assert b is None, field
            continue
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("tier", ["two", "single"])
def test_transpose_slots_bit_equal(tier):
    jg = _jax_graphs()
    m = 8
    nc = tgraph._align8(sum(g.num_nodes for g in jg) + 5)
    caps = ({"over_cap": jgraph.overflow_cap(jg, 20, m)} if tier == "two"
            else {"in_cap": jgraph.in_degree_cap(jg)})
    want = jgraph.pack_graphs(jg, nc, nc * m, 20, dense_m=m, **caps)
    got = tgraph.pack_graphs([_port_graph(g) for g in jg], nc, nc * m, 20,
                             dense_m=m, **caps)
    assert want.in_slots is not None
    if tier == "two":
        assert int(np.asarray(want.over_mask).sum()) > 0  # overflow used
    _assert_batches_equal(got, want)


def test_transpose_caps_match():
    jg = _jax_graphs() + jdataset.load_synthetic_mp(6, seed=4)
    tg = [_port_graph(g) for g in jg]
    assert tgraph.max_in_degree(tg) == jgraph.max_in_degree(jg) > 8
    assert tgraph.in_degree_cap(tg) == jgraph.in_degree_cap(jg)
    for gcap, m in ((4, 8), (36, 12), (300, 12)):
        assert tgraph.overflow_cap(tg, gcap, m) == \
            jgraph.overflow_cap(jg, gcap, m)


def test_overflow_raises_never_truncates():
    jg = _jax_graphs()
    tg = [_port_graph(g) for g in jg]
    nc = tgraph._align8(sum(g.num_nodes for g in jg) + 5)
    with pytest.raises(tgraph.TransposeOverflowError):
        tgraph.pack_graphs(tg, nc, nc * 8, 20, dense_m=8, over_cap=1)
    with pytest.raises(ValueError, match="in-degree"):
        tgraph.pack_graphs(tg, nc, nc * 8, 20, dense_m=8, in_cap=1)


@pytest.mark.parametrize("case", ["snug_shuffled", "fixed_order", "eval",
                                  "overflow_split", "drop_last"])
def test_batch_iterator_bit_equal(case):
    jg = _jax_graphs(30, seed=6)
    tg = [_port_graph(g) for g in jg]
    bs, m = 8, 8
    nc, ec = jgraph.capacities_for(jg, bs, dense_m=m, snug=True)
    kw = {
        "snug_shuffled": dict(snug=True, shuffle=True),
        "fixed_order": dict(snug=False),
        "eval": dict(snug=True, in_cap=0),
        "overflow_split": dict(snug=True, over_cap=8),
        "drop_last": dict(snug=False, drop_last=True),
    }[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the overflow split warns
        want = list(jgraph.batch_iterator(
            jg, bs, nc, ec, dense_m=m, rng=np.random.default_rng(3), **kw))
        got = list(tgraph.batch_iterator(
            tg, bs, nc, ec, dense_m=m, rng=np.random.default_rng(3), **kw))
    assert len(got) == len(want) > 2
    for a, b in zip(got, want):
        _assert_batches_equal(a, b)
    if case == "eval":
        assert got[0].in_slots is None
    if case == "overflow_split":  # some batch was split in half
        assert len(got) > jgraph.count_batches(jg, bs, nc, ec, snug=True)
    for snug in (False, True):
        assert tgraph.count_batches(tg, bs, nc, ec, snug=snug) == \
            jgraph.count_batches(jg, bs, nc, ec, snug=snug)


@pytest.mark.parametrize("ratios", [(0.8, 0.1), (0.6, 0.3)])
def test_train_val_test_split_same(ratios):
    jg = _jax_graphs(23, seed=1)
    want = jdataset.train_val_test_split(jg, *ratios, seed=7)
    got = tdataset.train_val_test_split(jg, *ratios, seed=7)
    assert [[id(g) for g in part] for part in got] == \
        [[id(g) for g in part] for part in want]
    with pytest.raises(ValueError):
        tdataset.train_val_test_split(jg, 0.9, 0.2)


@pytest.mark.parametrize("batch_size,rungs", [(4, 1), (8, 2), (64, 3)])
def test_plan_shape_set_same_rungs(batch_size, rungs):
    jg = _jax_graphs(14, seed=2)
    want = jshapes.plan_shape_set(jg, batch_size, rungs=rungs, dense_m=8)
    got = tshapes.plan_shape_set([_port_graph(g) for g in jg], batch_size,
                                 rungs=rungs, dense_m=8)
    assert [tuple(vars(s).values()) for s in got] == [
        tuple(vars(s).values()) for s in want]
    assert tgraph.capacities_for(jg, batch_size, dense_m=8) == \
        jgraph.capacities_for(jg, batch_size, dense_m=8, snug=True)
    assert tgraph.graph_cap_for(batch_size) == jgraph.graph_cap_for(batch_size)
