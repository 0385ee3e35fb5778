"""The port's CIF directory reader and graph cache against the JAX
package's (``load_cif_directory``, ``save_graph_cache`` /
``load_graph_cache``, ``featurize_directory_parallel``, the preprocess
entry point): the same directory gives bit-equal graphs on both stacks,
and a cache written by either stack loads on the other bit for bit. The
JAX side's neighbor search runs on its numpy backend (its native search
orders distance ties by cell list; ROADMAP Queue 3, item 1)."""

import shutil
import warnings

import numpy as np
import pytest

from cgnn_tpu.data import cache as jcache
from cgnn_tpu.data import dataset as jdataset
from cgnn_tpu.data import synthetic as jsynthetic
from cgnn_tpu.data.cif import write_cif_file
from cgnn_tpu_torch.data import cache as tcache
from cgnn_tpu_torch.data import dataset as tdataset
from cgnn_tpu_torch.data.preprocess import main as preprocess_main
from test_torch_cif import FIXTURES

FIELDS = ("atom_fea", "edge_fea", "centers", "neighbors", "target",
          "target_mask", "distances", "positions", "lattice", "offsets")
SMALL = dict(radius=5.0, max_num_nbr=8)


@pytest.fixture
def jax_numpy_backend(monkeypatch):
    """Force the JAX package's neighbor search onto its numpy backend."""
    import cgnn_tpu.native

    monkeypatch.setattr(cgnn_tpu.native, "neighbor_search_native",
                        lambda *a, **k: None)


def write_directory(root, n=6, seed=4, bad=True):
    """``n`` small synthetic cells as CIFs plus id_prop.csv with two
    targets a row: the third row's second target left empty (masked), and
    with ``bad`` one file that is no CIF and one id without a file."""
    rows = []
    for i, (sid, s, t) in enumerate(jsynthetic.synthetic_dataset(
            n, seed=seed, max_atoms=6)):
        write_cif_file(s, str(root / f"{sid}.cif"), name=sid)
        second = "" if i == 2 else f"{0.5 * i:.3f}"
        rows.append(f"{sid},{float(np.atleast_1d(t)[0]):.6f},{second}")
    if bad:
        (root / "broken.cif").write_text("data_broken\n_cell_length_a 4\n")
        rows.insert(1, "broken,1.0,2.0")
        rows.append("missing,1.0,2.0")
    (root / "id_prop.csv").write_text("\n".join(rows) + "\n")
    return [r.split(",")[0] for r in rows]


def assert_same_graphs(got, want):
    assert [g.cif_id for g in got] == [g.cif_id for g in want]
    for a, b in zip(got, want):
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and x.shape == y.shape, f
                np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("keep_geometry", [False, True])
def test_load_cif_directory_matches_jax(tmp_path, jax_numpy_backend,
                                        keep_geometry):
    ids = write_directory(tmp_path)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tdataset.load_cif_directory(
            str(tmp_path), tdataset.FeaturizeConfig(**SMALL),
            keep_geometry=keep_geometry)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jdataset.load_cif_directory(
            str(tmp_path), jdataset.FeaturizeConfig(**SMALL),
            keep_geometry=keep_geometry)
    assert_same_graphs(got, want)
    assert [g.cif_id for g in got] == [i for i in ids
                                       if i not in ("broken", "missing")]
    # the empty cell is a masked label
    np.testing.assert_array_equal(got[2].target_mask, [1.0, 0.0])
    assert got[2].target[1] == 0.0
    skipped = sorted(str(w.message).split(":")[0] for w in tw
                     if "skipping" in str(w.message))
    assert skipped == sorted(str(w.message).split(":")[0] for w in jw
                             if "skipping" in str(w.message)) == [
        "skipping broken", "skipping missing"]


def test_load_cif_directory_refusals(tmp_path):
    with pytest.raises(FileNotFoundError, match="id_prop.csv"):
        tdataset.load_cif_directory(str(tmp_path))
    (tmp_path / "id_prop.csv").write_text("nofile,1.0\n")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="no usable structures"):
            tdataset.load_cif_directory(str(tmp_path))


def test_featurize_directory_parallel_workers_agree(tmp_path,
                                                    jax_numpy_backend):
    """Workers 1 (this process) and 2 (spawned processes) give the same
    graphs in id_prop.csv order and the same failures; the JAX package's
    serial run gives the same bits."""
    for i, name in enumerate(("pymatgen_style.cif", "hm_symbol_only.cif",
                              "crlf_windows.cif")):
        shutil.copy(f"{FIXTURES}/{name}", tmp_path / f"fx{i}.cif")
    write_directory(tmp_path)
    with open(tmp_path / "id_prop.csv", "a") as f:
        f.write("fx0,0.1,0.2\nfx1,0.3,0.4\nfx2,0.5,0.6\n")
    cfg = tdataset.FeaturizeConfig(**SMALL)
    one, fail_one = tcache.featurize_directory_parallel(str(tmp_path), cfg,
                                                        workers=1)
    two, fail_two = tcache.featurize_directory_parallel(str(tmp_path), cfg,
                                                        workers=2)
    assert_same_graphs(two, one)
    assert fail_two == fail_one
    assert [c for c, _ in fail_one] == ["broken", "missing", "fx1"]
    assert "Hermann-Mauguin" in dict(fail_one)["fx1"]
    want, jfail = jcache.featurize_directory_parallel(
        str(tmp_path), jdataset.FeaturizeConfig(**SMALL), workers=1)
    assert_same_graphs(one, want)
    assert fail_one == jfail


@pytest.mark.parametrize("keep_geometry", [False, True])
def test_caches_cross_load_bit_equal(tmp_path, jax_numpy_backend,
                                     keep_geometry):
    write_directory(tmp_path, bad=False)
    jgraphs = jdataset.load_cif_directory(
        str(tmp_path), jdataset.FeaturizeConfig(**SMALL),
        keep_geometry=keep_geometry)
    tgraphs = tdataset.load_cif_directory(
        str(tmp_path), tdataset.FeaturizeConfig(**SMALL),
        keep_geometry=keep_geometry)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jcache.save_graph_cache(jgraphs, jpath)
    tcache.save_graph_cache(tgraphs, tpath)
    # the files hold the same arrays under the same keys
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert_same_graphs(tcache.load_graph_cache(jpath),
                       jcache.load_graph_cache(jpath))
    assert_same_graphs(jcache.load_graph_cache(tpath),
                       tcache.load_graph_cache(tpath))
    assert_same_graphs(tcache.load_graph_cache(tpath), tgraphs)


def test_cache_version_is_checked(tmp_path):
    write_directory(tmp_path, bad=False)
    graphs = tdataset.load_cif_directory(str(tmp_path),
                                         tdataset.FeaturizeConfig(**SMALL))
    path = str(tmp_path / "c.npz")
    tcache.save_graph_cache(graphs, path)
    with np.load(path) as z:
        payload = dict(z)
    payload["version"] = np.int64(2)
    np.savez(path, **payload)
    with pytest.raises(ValueError, match="version 2, expected 1"):
        tcache.load_graph_cache(path)


def test_preprocess_entry_points_write_the_same_cache(tmp_path,
                                                      jax_numpy_backend,
                                                      capsys):
    from cgnn_tpu.data.preprocess import main as jpreprocess_main

    data = tmp_path / "data"
    data.mkdir()
    write_directory(data)
    flags = ["--radius", "5", "--max-num-nbr", "8", "--keep-geometry"]
    tpath, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert preprocess_main([str(data), "-o", tpath, "-j", "2"] + flags) == 0
    out = capsys.readouterr()
    assert "featurized 6 structures" in out.out
    assert "skipped broken" in out.err and "skipped missing" in out.err
    assert jpreprocess_main([str(data), "-o", jpath, "-j", "1"] + flags) == 0
    assert_same_graphs(tcache.load_graph_cache(tpath),
                       jcache.load_graph_cache(jpath))
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "id_prop.csv").write_text("nofile,1.0\n")
    assert preprocess_main([str(empty), "-o", str(tmp_path / "e.npz"),
                            "-j", "1"]) == 1
