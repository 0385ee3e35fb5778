"""The port's force-task data against the JAX package's, bit for bit (the
JAX neighbor search on its numpy backend, as tests/test_torch_cache.py
runs it):

- the trajectory loaders on ``tests/fixtures/md/*.npz`` (both key
  conventions, the vacuum box of a lattice-free MD17 file), the graphs
  with their geometry and force labels, ``is_trajectory_path``,
  ``load_trajectory_root`` and ``regroup_by_trajectory``;
- ``split_trajectory_groups``: the same frames in the same order in each
  split, by whole trajectories (3 or more) and by contiguous blocks (fewer),
  with the JAX package's warning where a split lands off its quota;
- the synthetic MD17 and OC20 stand-ins (LJ labels, trajectories, slabs)
  and their featurized graphs;
- ``pack_graphs``' per-atom force labels (``node_targets``), dense and COO;
- the graph cache's force labels, written by either side and read by the
  other.
"""

import dataclasses
import warnings
from pathlib import Path

import numpy as np
import pytest

from cgnn_tpu.data import cache as jcache
from cgnn_tpu.data import dataset as jdataset
from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.data import synthetic as jsynthetic
from cgnn_tpu.data import trajectory as jtraj
from cgnn_tpu_torch.data import cache as tcache
from cgnn_tpu_torch.data import dataset as tdataset
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.data import synthetic as tsynthetic
from cgnn_tpu_torch.data import trajectory as ttraj

MD = Path(__file__).resolve().parent / "fixtures" / "md"
FIELDS = ("atom_fea", "edge_fea", "centers", "neighbors", "target",
          "distances", "positions", "lattice", "offsets", "forces",
          "numbers")


@pytest.fixture
def jax_numpy_backend(monkeypatch):
    """Force the JAX package's neighbor search onto its numpy backend."""
    import cgnn_tpu.native

    monkeypatch.setattr(cgnn_tpu.native, "neighbor_search_native",
                        lambda *a, **k: None)


def assert_same_graphs(got, want):
    assert [g.cif_id for g in got] == [g.cif_id for g in want]
    for a, b in zip(got, want):
        for f in FIELDS:
            x, y = getattr(a, f, None), getattr(b, f, None)
            assert (x is None) == (y is None), f
            if x is not None:
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and x.shape == y.shape, f
                np.testing.assert_array_equal(x, y, err_msg=f)


def _cfgs():
    return (jdataset.FeaturizeConfig(radius=5.0, max_num_nbr=8),
            tdataset.FeaturizeConfig(radius=5.0, max_num_nbr=8))


@pytest.mark.parametrize("name", ["lj-md17", "lj-periodic", "lj-periodic-b"])
def test_trajectory_npz_loads_as_in_jax(name, jax_numpy_backend):
    path = str(MD / f"{name}.npz")
    want, got = jtraj.load_trajectory_npz(path), ttraj.load_trajectory_npz(
        path)
    assert want.keys() == got.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None
        else:
            np.testing.assert_array_equal(got[k], want[k])
    jcfg, tcfg = _cfgs()
    assert_same_graphs(ttraj.trajectory_graphs(path, tcfg, stride=2),
                       jtraj.trajectory_graphs(path, jcfg, stride=2))
    # the vacuum box: the lattice-free MD17 file's periodic images stay
    # out of range
    lat, frac = ttraj._vacuum_box(got["positions"][0], 5.0)
    jlat, jfrac = jtraj._vacuum_box(want["positions"][0], 5.0)
    np.testing.assert_array_equal(lat, jlat)
    np.testing.assert_array_equal(frac, jfrac)


def test_trajectory_root_and_regrouping(tmp_path, jax_numpy_backend):
    assert ttraj.is_trajectory_path(str(MD)) == jtraj.is_trajectory_path(
        str(MD)) is True
    assert not ttraj.is_trajectory_path(str(tmp_path))
    assert ttraj.is_trajectory_path(str(MD / "lj-md17.npz"))
    jcfg, tcfg = _cfgs()
    groups = ttraj.load_trajectory_root(str(MD), tcfg)
    jgroups = jtraj.load_trajectory_root(str(MD), jcfg)
    assert len(groups) == len(jgroups) == 3
    for g, j in zip(groups, jgroups):
        assert_same_graphs(g, j)
    flat = [g for grp in groups for g in grp]
    regrouped = ttraj.regroup_by_trajectory(flat)
    assert [[g.cif_id for g in grp] for grp in regrouped] == [
        [g.cif_id for g in grp] for grp in groups]
    assert ttraj.regroup_by_trajectory(
        [dataclasses.replace(flat[0], cif_id="no-sep")]) is None
    with pytest.raises(FileNotFoundError):
        ttraj.load_trajectory_root(str(tmp_path), tcfg)


@dataclasses.dataclass
class _Frame:
    cif_id: str


def _fake_groups(lengths):
    return [[_Frame(f"traj{i}/{k:05d}") for k in range(n)]
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("lengths", [(40,), (30, 12), (10, 10, 10),
                                     (50, 3, 7, 20, 9), (5, 80, 6, 6),
                                     (12, 12, 12, 12, 12, 12, 12)])
@pytest.mark.parametrize("ratios", [(0.8, 0.1), (0.6, 0.2), (0.7, 0.0)])
@pytest.mark.parametrize("seed", [0, 3])
def test_split_trajectory_groups_bit_equal(lengths, ratios, seed):
    groups = _fake_groups(lengths)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jtraj.split_trajectory_groups(groups, *ratios, seed=seed)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = ttraj.split_trajectory_groups(groups, *ratios, seed=seed)
    assert [[g.cif_id for g in s] for s in got] == [
        [g.cif_id for g in s] for s in want]
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    with pytest.raises(ValueError):
        ttraj.split_trajectory_groups(groups, 0.9, 0.2)


def test_synthetic_md_and_oc20_match_jax(jax_numpy_backend):
    rng_j, rng_t = np.random.default_rng(7), np.random.default_rng(7)
    s_j = jsynthetic.random_structure(rng_j, 6, 6, a_range=(5.5, 7.0))
    s_t = tsynthetic.random_structure(rng_t, 6, 6, a_range=(5.5, 7.0))
    ej, fj = jsynthetic.lj_energy_forces(s_j)
    et, ft = tsynthetic.lj_energy_forces(s_t)
    assert et == ej
    np.testing.assert_array_equal(ft, fj)
    for (ij, sj, e1, f1), (it, st, e2, f2) in zip(
            jsynthetic.synthetic_trajectory(4, seed=2, num_atoms=7),
            tsynthetic.synthetic_trajectory(4, seed=2, num_atoms=7)):
        assert ij == it and e1 == e2
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(sj.frac_coords, st.frac_coords)
    for (ij, sj, tj), (it, st, tt) in zip(
            jsynthetic.synthetic_oc20_dataset(3, seed=1),
            tsynthetic.synthetic_oc20_dataset(3, seed=1)):
        assert ij == it and tj == tt
        np.testing.assert_array_equal(sj.frac_coords, st.frac_coords)
        np.testing.assert_array_equal(sj.numbers, st.numbers)
        assert 37 <= st.num_atoms <= 255
    jcfg, tcfg = _cfgs()
    assert_same_graphs(tdataset.load_trajectory(5, tcfg, seed=3,
                                                num_atoms=6),
                       jdataset.load_trajectory(5, jcfg, seed=3,
                                                num_atoms=6))
    assert_same_graphs(tdataset.load_synthetic_oc20(2, tcfg, seed=4),
                       jdataset.load_synthetic_oc20(2, jcfg, seed=4))


def _port(g):
    names = [f.name for f in dataclasses.fields(tgraph.CrystalGraph)]
    return tgraph.CrystalGraph(**{f: getattr(g, f) for f in names
                                  if hasattr(g, f)})


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "coo"])
def test_pack_graphs_fills_force_labels(dense, jax_numpy_backend):
    jcfg, _ = _cfgs()
    graphs = jdataset.load_trajectory(6, jcfg, seed=9, num_atoms=5)
    graphs[2] = dataclasses.replace(graphs[2], forces=None)  # unlabelled
    dm = 8 if dense else None
    nc, ec = jgraph.capacities_for(graphs, 6, dense_m=dm, snug=True)
    nc += 2
    ec = nc * 8 if dense else ec
    want = jgraph.pack_graphs(graphs, nc, ec, 8, dense_m=dm)
    got = tgraph.pack_graphs([_port(g) for g in graphs], nc, ec, 8,
                             dense_m=dm)
    np.testing.assert_array_equal(got.node_targets.numpy(),
                                  np.asarray(want.node_targets))
    np.testing.assert_array_equal(got.positions.numpy(),
                                  np.asarray(want.positions))
    np.testing.assert_array_equal(got.edge_offsets.numpy(),
                                  np.asarray(want.edge_offsets))
    assert np.abs(got.node_targets.numpy()).max() > 0


def test_cache_carries_force_labels_both_ways(tmp_path, jax_numpy_backend):
    jcfg, tcfg = _cfgs()
    tg = tdataset.load_trajectory(5, tcfg, seed=1, num_atoms=6)
    jg = jdataset.load_trajectory(5, jcfg, seed=1, num_atoms=6)
    tcache.save_graph_cache(tg, str(tmp_path / "t.npz"))
    jcache.save_graph_cache(jg, str(tmp_path / "j.npz"))
    for path in ("t.npz", "j.npz"):
        got = tcache.load_graph_cache(str(tmp_path / path))
        want = jcache.load_graph_cache(str(tmp_path / path))
        assert all(g.forces is not None for g in got)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a.forces),
                                          np.asarray(b.forces))
    # a cache without force labels loads with none
    plain = [dataclasses.replace(g, forces=None) for g in tg]
    tcache.save_graph_cache(plain, str(tmp_path / "p.npz"))
    assert all(g.forces is None
               for g in tcache.load_graph_cache(str(tmp_path / "p.npz")))
