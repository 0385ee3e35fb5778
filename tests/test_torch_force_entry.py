"""The force task through the port's entry points on the CPU:

- ``python -m cgnn_tpu_torch.train --task force`` -> ``--resume`` ->
  ``python -m cgnn_tpu_torch.predict``: the CSV's energies and
  ``<out>.forces.npz`` (one [n_atoms, 3] array a structure, in input
  order); a resumed epoch equal to the uninterrupted one bit for bit, in
  every parameter and optimizer buffer, dense and COO (every sum in a
  fixed order, the optimizer state restored);
- a trajectory directory (``tests/fixtures/md``) as ``DATA_DIR``, split by
  whole trajectories, and ``--synthetic-oc20`` for the regression task;
- a ``train.py --task force`` checkpoint carried over by
  ``jax_checkpoint_to_torch.py`` predicting through the port what
  predict.py predicts from it: energies rtol 1e-4 / atol 1e-5 of the
  largest |energy| and forces atol 1e-4 of the largest |force| (f32
  roundoff through a gradient), the same ids, targets and atom counts;
- the refusals, each exit 2 with its reason: ``--aggregation pallas``
  (the JAX package's own failure, tests/test_torch_forces.py),
  ``--fused-epilogue``, ``--cgconv-impl``, ``--compact-staging on``, a
  cache without force labels, a data directory that is no trajectory;
  and ``load_server`` and ``python -m cgnn_tpu_torch.serve`` on a force
  checkpoint (the JAX server's message).
"""

import csv
import sys

import numpy as np
import pytest

from cgnn_tpu_torch.predict import main as port_predict
from cgnn_tpu_torch.train.__main__ import main as port_train
from test_torch_resume import ROOT, _run
from test_torch_resume import jax_numpy_backend  # noqa: F401 (a fixture)
from test_torch_trajectory import MD
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

FORCE_CLI = ["--task", "force", "--device", "cpu", "--md-atoms", "6",
             "--radius", "5", "--max-num-nbr", "8", "--n-conv", "2",
             "--atom-fea-len", "16", "--h-fea-len", "16", "-b", "8",
             "--optim", "Adam", "--lr", "0.002", "--print-freq", "0"]


def _train(tmp_path, name, *extra):
    ck = str(tmp_path / name)
    rc = port_train(["--synthetic", "48", *FORCE_CLI, "--ckpt-dir", ck,
                     "--out-dir", ck + "_out", *extra])
    return rc, ck


def test_force_train_resume_predict(tmp_path, capsys):
    rc, ck = _train(tmp_path, "part", "--epochs", "2")
    assert rc == 0
    out = capsys.readouterr().out
    assert "trajectory-aware split: 38/4/6 frames" in out
    assert "** test force_mae" in out and "** test energy mae" in out
    rc, ck = _train(tmp_path, "part", "--epochs", "3", "--resume", "auto")
    assert rc == 0
    out = capsys.readouterr().out
    assert f"resumed from {ck} at epoch 2" in out and "Epoch 2:" in out
    params = np.load(ck + "_out/params.npz")
    assert not any(k.startswith("batch_stats") for k in params.files)

    csv_out = str(tmp_path / "p.csv")
    assert port_predict([ck, "--device", "cpu", "--synthetic", "10",
                         "-b", "4", "--out", csv_out]) == 0
    rows = list(csv.reader(open(csv_out)))
    assert len(rows) == 10 and all(len(r) == 3 for r in rows)
    z = np.load(csv_out + ".forces.npz")
    assert list(z["ids"]) == [r[0] for r in rows]
    for i in range(10):
        f = z[f"forces_{i}"]
        assert f.shape == (8, 3) and np.isfinite(f).all()


@pytest.mark.parametrize("dense_m", [8, 0], ids=["dense", "coo"])
def test_force_resume_repeats_the_uninterrupted_epoch(tmp_path, dense_m):
    """Epochs 0-1 saved, then epoch 2 in memory (the uninterrupted run);
    a fresh state restored from the epoch-1 save runs the same epoch 2:
    bit-equal in every parameter and optimizer buffer."""
    import torch

    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.data.dataset import FeaturizeConfig, load_trajectory
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager
    from cgnn_tpu_torch.train.loop import fit
    from cgnn_tpu_torch.train.state import init_train_state

    graphs = load_trajectory(40, FeaturizeConfig(radius=5.0, max_num_nbr=8),
                             seed=2, num_atoms=6)
    train_g, val_g = graphs[:32], graphs[32:]
    mcfg = ModelConfig(atom_fea_len=16, n_conv=2, h_fea_len=16,
                       dense_m=dense_m)
    dcfg = DataConfig(radius=5.0, max_num_nbr=8)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=0)
    meta = {"model": mcfg.to_meta(), "data": dcfg.to_meta(),
            "task": "force"}

    def new():
        return init_train_state(mcfg, dcfg, train_g, batch_size=8,
                                device="cpu", optim="adam", lr=2e-3,
                                task="force")[0]

    def run(state, start, end, save):
        return fit(state, train_g, val_g, epochs=end, batch_size=8,
                   dense_m=dense_m, device="cpu", start_epoch=start,
                   on_epoch_end=(lambda s, e, vm, best: mgr.save(
                       s, dict(meta, epoch=e), is_best=best)) if save
                   else None, log_fn=lambda *_: None)

    try:
        state, res = run(new(), 0, 2, True)
        assert res["best_key"] == "force_mae"
        mgr.wait()
        state, _ = run(state, 2, 3, False)
        fresh = new()
        _, saved = mgr.restore(fresh)
        assert saved["epoch"] == 1
        fresh, _ = run(fresh, 2, 3, False)
    finally:
        mgr.close()
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(state.optimizer.tensors(), fresh.optimizer.tensors()):
        assert torch.equal(a, b)


def test_trajectory_directory_and_oc20_train(tmp_path, capsys):
    ck = str(tmp_path / "md")
    assert port_train([str(MD), *FORCE_CLI, "--epochs", "1",
                       "--ckpt-dir", ck, "--out-dir", ck]) == 0
    out = capsys.readouterr().out
    assert "loaded 3 trajectories (76 frames)" in out
    assert "over 3 trajectories" in out
    ck = str(tmp_path / "oc20")
    assert port_train(["--synthetic-oc20", "6", "--device", "cpu",
                       "--epochs", "1", "-b", "3", "--radius", "5",
                       "--max-num-nbr", "8", "--n-conv", "1",
                       "--atom-fea-len", "8", "--h-fea-len", "8",
                       "--ckpt-dir", ck, "--out-dir", ck]) == 0
    assert "** test mae" in capsys.readouterr().out


def test_jax_force_checkpoint_converts_and_predicts(tmp_path,
                                                    jax_numpy_backend):
    jck, port = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    p = _run([sys.executable, "train.py", "--synthetic", "24", "--device",
              "cpu", "--epochs", "1", "--task", "force", "--md-atoms", "6",
              "-b", "8", "--radius", "5", "--max-num-nbr", "8",
              "--n-conv", "2", "--atom-fea-len", "16", "--h-fea-len", "16",
              "--optim", "Adam", "--lr", "0.002", "--print-freq", "0",
              "--ckpt-dir", jck])
    assert p.returncode == 0, p.stderr[-2000:]
    sys.path.insert(0, str(ROOT))
    try:
        import jax_checkpoint_to_torch
        import predict as jpredict
    finally:
        sys.path.remove(str(ROOT))
    assert jax_checkpoint_to_torch.main([jck, port, "--device", "cpu"]) == 0
    res = {}
    for side in ("jax", "port"):
        out = str(tmp_path / f"{side}.csv")
        args = ["--device", "cpu", "--synthetic", "12", "-b", "8", "--out",
                out]
        if side == "port":
            assert port_predict([port] + args) == 0
        else:
            assert jpredict.main([jck] + args + ["--compile-cache", ""]) == 0
        res[side] = (list(csv.reader(open(out))),
                     np.load(out + ".forces.npz"))
    (prow, pz), (jrow, jz) = res["port"], res["jax"]
    assert [r[:2] for r in prow] == [r[:2] for r in jrow]
    got = np.array([float(r[2]) for r in prow])
    want = np.array([float(r[2]) for r in jrow])
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    assert list(pz["ids"]) == list(jz["ids"])
    scale = max(np.abs(jz[f"forces_{i}"]).max() for i in range(12))
    for i in range(12):
        np.testing.assert_allclose(pz[f"forces_{i}"], jz[f"forces_{i}"],
                                   rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("extra,why", [
    (["--aggregation", "pallas"], "_pallas_call_jvp_rule"),
    (["--fused-epilogue", "pallas"], "--task force"),
    (["--cgconv-impl", "xla"], "--task force"),
    (["--device-resident", "--compact-staging", "on"], "non-force task"),
])
def test_force_entry_refusals(tmp_path, capsys, extra, why):
    rc, _ = _train(tmp_path, "r", "--epochs", "1", *extra)
    assert rc == 2
    assert why in capsys.readouterr().err


def test_force_data_refusals(tmp_path, capsys):
    from cgnn_tpu_torch.data.cache import save_graph_cache
    from cgnn_tpu_torch.data.dataset import FeaturizeConfig, load_synthetic

    cache = str(tmp_path / "g.npz")
    save_graph_cache(load_synthetic(6, FeaturizeConfig(radius=5.0),
                                    keep_geometry=True), cache)
    assert port_train(["--cache", cache, *FORCE_CLI, "--epochs", "1",
                       "--ckpt-dir", str(tmp_path / "c")]) == 2
    assert "lacks force labels" in capsys.readouterr().err
    (tmp_path / "cifs").mkdir()
    assert port_train([str(tmp_path / "cifs"), *FORCE_CLI, "--epochs", "1",
                       "--ckpt-dir", str(tmp_path / "c")]) == 2
    assert "on-disk trajectory dataset" in capsys.readouterr().err


def test_server_refuses_a_force_checkpoint(tmp_path, capsys):
    from cgnn_tpu_torch.serve.__main__ import main as serve_main
    from cgnn_tpu_torch.serve.server import FORCE_SERVE_REFUSAL, load_server

    rc, ck = _train(tmp_path, "s", "--epochs", "1")
    assert rc == 0
    for args in ((ck,), (ck + "_out/params.npz", ck + "_out/meta.json")):
        with pytest.raises(NotImplementedError, match="offline-only"):
            load_server(*args, device="cpu", warm=False, watch=False)
    capsys.readouterr()
    assert serve_main([ck, "--device", "cpu", "--port", "0"]) == 2
    assert FORCE_SERVE_REFUSAL in capsys.readouterr().err
