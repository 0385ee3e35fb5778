"""CIF directory -> cache -> train -> predict through the port's entry
points on the CPU:

- ``python -m cgnn_tpu_torch.data.preprocess``, then the train entry point
  from ``DATA_DIR --cache`` (written when absent, loaded when present) and
  the predict entry point on the cache and on the directory, both wires,
  ``--compact on`` and ``off`` with parallel packers: the same ids and
  targets in the same order, predictions within rtol 1e-4 / atol 1e-4
  (compact against full staging within the expander's exp rounding);
- a model that JAX ``train.py`` trained on the same cache, carried over by
  ``jax_checkpoint_to_torch.py``, predicts through the port what
  ``predict.py`` predicts from that cache (rtol 1e-4 / atol 1e-4);
- the refusals: ``--compact-staging on`` (the scan driver is not
  ported), no data.
"""

import csv
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cgnn_tpu.data import synthetic as jsynthetic
from cgnn_tpu_torch.data.cache import load_graph_cache
from cgnn_tpu_torch.data.cif import write_cif_file
from cgnn_tpu_torch.data.preprocess import main as preprocess_main
from cgnn_tpu_torch.data.structure import Structure
from cgnn_tpu_torch.predict import main as predict_main
from cgnn_tpu_torch.train.__main__ import main as train_main

ROOT = Path(__file__).resolve().parents[1]
SMALL_CLI = ["--radius", "5", "--n-conv", "2", "--atom-fea-len", "16",
             "--print-freq", "0"]
TOL = dict(rtol=1e-4, atol=1e-4)


def write_mp_directory(root: Path, n: int, seed: int = 5) -> list[str]:
    ids = []
    rows = []
    for sid, s, t in jsynthetic.synthetic_mp_dataset(n, seed=seed):
        write_cif_file(Structure(s.lattice, s.frac_coords, s.numbers),
                       str(root / f"{sid}.cif"), name=sid)
        rows.append(f"{sid},{float(np.atleast_1d(t)[0]):.6f}")
        ids.append(sid)
    (root / "id_prop.csv").write_text("\n".join(rows) + "\n")
    return ids


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _preds(rows):
    return np.array([[float(x) for x in r[2:]] for r in rows])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("cif")
    ids = write_mp_directory(d, 36)
    return d, ids


def test_cif_directory_train_and_predict(data, tmp_path, capsys):
    d, ids = data
    cache = str(tmp_path / "graphs.npz")
    ck = str(tmp_path / "ck")
    train = [str(d), "--cache", cache, "--device", "cpu", "--epochs", "1",
             "-b", "8", "-j", "2", "--ckpt-dir", ck, "--out-dir",
             str(tmp_path / "out")] + SMALL_CLI
    assert train_main(train) == 0
    out = capsys.readouterr().out
    assert "featurized 36 structures" in out and f"wrote cache {cache}" in out
    assert "Epoch 0:" in out and "** test mae:" in out
    # a second run loads the cache it wrote
    assert train_main(train) == 0
    assert f"loaded 36 graphs from {cache}" in capsys.readouterr().out
    assert [g.cif_id for g in load_graph_cache(cache)] == ids

    csvs = {}
    runs = {
        "cache_full": ["--cache", cache, "--compact", "off"],
        "cache_compact": ["--cache", cache, "--compact", "on",
                          "--pack-workers", "2"],
        "dir_featurized": [str(d), "--wire", "featurized", "--compact", "on"],
        "dir_raw": [str(d), "--wire", "raw"],
        "dir_buckets": [str(d), "--buckets", "2", "--compact", "on",
                        "--pack-workers", "2"],
    }
    for name, flags in runs.items():
        csvs[name] = str(tmp_path / f"{name}.csv")
        argv = [ck] + flags + ["--device", "cpu", "-b", "8", "--out",
                               csvs[name]]
        if flags[0] == str(d):  # DATA_DIR is the second positional
            argv = [ck, str(d)] + flags[1:] + argv[len(flags) + 1:]
        assert predict_main(argv) == 0, name
        said = capsys.readouterr().out
        assert ('"compact": true' in said) == ("--compact" in flags
                                               and "on" in flags), name
        # the directory's raw run stages raw (the cache holds no species)
        assert ('"raw": 0,' in said) == (name != "dir_raw"), name
    rows = {k: _rows(v) for k, v in csvs.items()}
    want = rows["cache_full"]
    assert [r[0] for r in want] == ids
    for name, got in rows.items():
        assert [r[:2] for r in got] == [r[:2] for r in want], name
        np.testing.assert_allclose(_preds(got), _preds(want), **TOL,
                                   err_msg=name)
    # compact and full staging of the same cache: the CSV's ids and
    # targets equal, its predictions within the expander's exp rounding
    np.testing.assert_allclose(_preds(rows["cache_compact"]),
                               _preds(rows["cache_full"]), rtol=1e-5,
                               atol=2e-6)


@pytest.fixture
def jax_numpy_backend(monkeypatch):
    """Force the JAX package's neighbor search onto its numpy backend."""
    import cgnn_tpu.native

    monkeypatch.setattr(cgnn_tpu.native, "neighbor_search_native",
                        lambda *a, **k: None)


def _run(cmd, timeout=600):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_jax_trained_model_predicts_the_cache_like_predict_py(
        data, tmp_path, jax_numpy_backend):
    d, ids = data
    cache = str(tmp_path / "graphs.npz")
    assert preprocess_main([str(d), "-o", cache, "-j", "2", "--radius",
                            "5"]) == 0
    jck, port = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    p = _run([sys.executable, "train.py", "--cache", cache, "--device",
              "cpu", "--epochs", "1", "--optim", "Adam", "-b", "8",
              "--ckpt-dir", jck, "--n-conv", "2", "--atom-fea-len", "16",
              "--radius", "5", "--print-freq", "0"])
    assert p.returncode == 0, p.stderr[-2000:]
    assert f"loaded 36 graphs from {cache}" in p.stdout
    sys.path.insert(0, str(ROOT))
    try:
        import jax_checkpoint_to_torch
        import predict as jpredict
    finally:
        sys.path.remove(str(ROOT))
    assert jax_checkpoint_to_torch.main([jck, port, "--device", "cpu"]) == 0
    csvs = {k: str(tmp_path / f"{k}.csv")
            for k in ("jax", "port_full", "port_compact")}
    base = ["--cache", cache, "--device", "cpu", "-b", "8"]
    assert jpredict.main([jck] + base + ["--out", csvs["jax"],
                                         "--compile-cache", ""]) == 0
    assert predict_main([port] + base + ["--compact", "off", "--out",
                                         csvs["port_full"]]) == 0
    assert predict_main([port] + base + ["--compact", "on", "--pack-workers",
                                         "2", "--out",
                                         csvs["port_compact"]]) == 0
    rows = {k: _rows(v) for k, v in csvs.items()}
    assert [r[0] for r in rows["jax"]] == ids
    for name in ("port_full", "port_compact"):
        assert [r[:2] for r in rows[name]] == [r[:2] for r in rows["jax"]]
        np.testing.assert_allclose(_preds(rows[name]), _preds(rows["jax"]),
                                   **TOL, err_msg=name)
    np.testing.assert_allclose(_preds(rows["port_compact"]),
                               _preds(rows["port_full"]), rtol=1e-5,
                               atol=2e-6)


@pytest.mark.parametrize("case", ["compact_staging_on", "no_data",
                                  "missing_dir"])
def test_train_entry_refusals(case, tmp_path, capsys):
    argv = ["--device", "cpu", "--epochs", "1", "--ckpt-dir",
            str(tmp_path / "ck"), "--out-dir", str(tmp_path / "out")]
    if case == "compact_staging_on":
        assert train_main(argv + ["--synthetic", "8", "--compact-staging",
                                  "on"]) == 2
        assert "Queue 1, item 5" in capsys.readouterr().err
    elif case == "no_data":
        assert train_main(argv) == 2
        assert "DATA_DIR or --synthetic" in capsys.readouterr().err
    else:
        with pytest.raises(FileNotFoundError, match="id_prop.csv"):
            train_main(argv + [str(tmp_path / "nowhere"), "-j", "1"])
    assert not os.path.exists(tmp_path / "ck")
