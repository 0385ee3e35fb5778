"""Train -> checkpoint -> resume -> predict with the port, on the CPU:

- the workflow of tests/test_entrypoints.py's resume cycle on the port's
  entry points, as subprocesses: train 2 epochs, ``--resume`` to 3 (its
  numbering continues at ``Epoch 2:``), predict 16 rows; and
  train.py's refusals, each exiting 2;
- a trajectory across a save and a restore against the JAX ``fit`` with
  ``start_epoch`` from the same weights: epoch 0, a checkpoint, a restore
  into a fresh state, epoch 1 from ``start_epoch=1`` (the data order
  restarting from the seed, as in the JAX loop); per-epoch losses rel
  1e-4, every parameter and running statistic rtol 2e-3 / atol 1e-4 (f32
  through two convs and the BatchNorm backward, tests/test_torch_train.py);
- a model that JAX ``train.py`` trained, carried over by
  ``jax_checkpoint_to_torch.py``, predicts through the port what
  ``predict.py`` predicts: the same ids in the same order, predictions
  within rtol 1e-4 / atol 1e-4. Both featurize with the numpy neighbor
  search (the JAX package's native search orders distance ties by cell
  list; ROADMAP Queue 3, item 1).
"""

import csv
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.train.loop import fit as jfit
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.state import TrainState as JTrainState
from cgnn_tpu.train.state import make_optimizer as jmake_optimizer
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import DataConfig, ModelConfig
from cgnn_tpu_torch.data.dataset import load_synthetic as tload
from cgnn_tpu_torch.predict import main as port_predict
from cgnn_tpu_torch.train import state as tstate
from cgnn_tpu_torch.train.__main__ import main as train_main
from cgnn_tpu_torch.train.checkpoint import (
    CheckpointManager,
    CheckpointRestoreError,
    load_tree,
    state_tree,
)
from cgnn_tpu_torch.train.loop import fit
from cgnn_tpu_torch.train.normalizer import Normalizer
from test_torch_train import (
    GRAD_TOL,
    SMALL,
    JNet,
    M,
    _batches,
    _graphs,
    _jax_variables,
    _port,
    _port_model,
)

ROOT = Path(__file__).resolve().parents[1]


def _run(cmd, timeout=600):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


SMALL_CLI = ["--radius", "5", "--n-conv", "2", "--atom-fea-len", "16",
             "--print-freq", "0"]


def test_train_resume_predict_cycle(tmp_path):
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "out")
    base = [sys.executable, "-m", "cgnn_tpu_torch.train", "--synthetic",
            "64", "--device", "cpu", "--epochs", "2", "--optim", "Adam",
            "-b", "16", "--ckpt-dir", ckpt, "--out-dir", out] + SMALL_CLI
    p1 = _run(base)
    assert p1.returncode == 0, p1.stderr[-2000:]
    assert "Epoch 1:" in p1.stdout and "** test mae:" in p1.stdout
    assert sorted(n for n in os.listdir(ckpt) if n.startswith("ckpt-")) == [
        "ckpt-00000000", "ckpt-00000001"]
    at = base.index("--epochs") + 1
    p2 = _run(base[:at] + ["3"] + base[at + 1:] + ["--resume", ckpt])
    assert p2.returncode == 0, p2.stderr[-2000:]
    assert "resumed from" in p2.stdout and "at epoch 2" in p2.stdout
    assert "Epoch 2:" in p2.stdout
    assert "Epoch 0:" not in p2.stdout  # numbering continued
    assert CheckpointManager(ckpt).read_meta()["epoch"] == 2
    out_csv = str(tmp_path / "preds.csv")
    p3 = _run([sys.executable, "-m", "cgnn_tpu_torch.predict", ckpt,
               "--device", "cpu", "--synthetic", "16", "-b", "16",
               "--out", out_csv])
    assert p3.returncode == 0, p3.stderr[-2000:]
    rows = open(out_csv).read().strip().splitlines()
    assert len(rows) == 16
    cid, target, pred = rows[0].split(",")
    float(target), float(pred)
    assert cid.startswith("synth-")


def _train(tmp_path, *extra, epochs="1"):
    return train_main(["--synthetic", "24", "--device", "cpu", "--epochs",
                       epochs, "-b", "8", "--ckpt-dir",
                       str(tmp_path / "ckpt"), "--out-dir",
                       str(tmp_path / "out"), *SMALL_CLI, *extra])


def _inference_only(d):
    """Replace the newest save with one that has no optimizer state."""
    mgr = CheckpointManager(d)
    meta = mgr.read_meta()
    tree = load_tree(os.path.join(d, mgr.newest_committed(), "state.npz"))
    del tree["opt_state"]
    for name in os.listdir(d):
        if name.startswith("ckpt-"):
            os.remove(os.path.join(d, name, "MANIFEST.json"))
    mgr.save_tree(tree, meta)
    mgr.close()


RESUME_CASES = ("auto_empty", "auto_unrestorable", "no_epoch",
                "inference_only")


@pytest.mark.parametrize("case", RESUME_CASES)
def test_resume_rules(case, tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    if case == "auto_empty":
        assert _train(tmp_path, "--resume", "auto") == 0
        assert "no checkpoint under" in capsys.readouterr().out
        assert CheckpointManager(d).read_meta()["epoch"] == 0
        return
    assert _train(tmp_path) == 0
    capsys.readouterr()
    mgr = CheckpointManager(d)
    newest = os.path.join(d, mgr.newest_committed())
    if case == "auto_unrestorable":
        open(os.path.join(newest, "state.npz"), "wb").write(b"torn")
        want = "non-empty but unrestorable"
    elif case == "no_epoch":
        import json

        with open(os.path.join(newest, "meta.json"), "w") as f:
            json.dump({"model": {}, "task": "regression"}, f)
        want = "lacks 'epoch'"
    else:
        _inference_only(d)
        want = "no optimizer state"
    resume = "auto" if case == "auto_unrestorable" else d
    assert _train(tmp_path, "--resume", resume, epochs="2") == 2
    assert want in capsys.readouterr().err


def test_trajectory_across_restore_matches_jax_fit(tmp_path):
    train_g, val_g = _graphs(30, seed=8), _graphs(10, seed=9)
    jb, _ = _batches(train_g)
    jnet = JNet(**SMALL, dense_m=M)
    variables = _jax_variables(jnet, jb)
    targets = np.stack([g.target for g in train_g])
    opt = dict(lr=0.05, momentum=0.9, lr_milestones=[4])
    tx = jmake_optimizer("sgd", **opt)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        normalizer=JNormalizer.fit(targets), rng=jax.random.key(0),
        apply_fn=jnet.apply, tx=tx)
    node_cap, _ = jgraph.capacities_for(train_g, 10, dense_m=M, snug=True)
    kw = dict(batch_size=10, node_cap=node_cap, dense_m=M, seed=3,
              print_freq=0, log_fn=lambda *a: None)
    jstate, j0 = jfit(jstate, train_g, val_g, epochs=1, snug=True, **kw)
    jstate, j1 = jfit(jstate, train_g, val_g, epochs=2, start_epoch=1,
                      snug=True, **kw)

    def fresh():
        net = _port_model({}, variables)
        return tstate.TrainState(
            net, tstate.make_optimizer(net.parameters(), "sgd", **opt),
            Normalizer.fit(targets, device="cpu"))

    tg, tv = [_port(g) for g in train_g], [_port(g) for g in val_g]
    mgr = CheckpointManager(str(tmp_path))
    saves = []
    state, t0 = fit(fresh(), tg, tv, epochs=1, device="cpu",
                    on_epoch_end=lambda s, e, m, b: saves.append(
                        mgr.save(s, {"epoch": e}, b)), **kw)
    assert len(saves) == 1
    restored, meta = mgr.restore(fresh())
    assert meta == {"epoch": 0} and restored.optimizer.count == state.step
    restored, t1 = fit(restored, tg, tv, epochs=2, start_epoch=1,
                       device="cpu", **kw)
    assert [h["epoch"] for h in t1["history"]] == [1]
    for t, j in ((t0, j0), (t1, j1)):
        (th,), (jh,) = t["history"], j["history"]
        assert th["train"]["steps"] == jh["train"]["steps"] >= 3
        assert th["train"]["loss"] == pytest.approx(jh["train"]["loss"],
                                                    rel=1e-4)
        assert th["val"]["mae"] == pytest.approx(jh["val"]["mae"], rel=1e-4)
    assert t1["best"] == th["val"]["mae"]  # best restarts at inf
    want = convert.flatten(jax.tree_util.tree_map(np.asarray,
                                                  jstate.variables()))
    tree = state_tree(restored)
    got = convert.flatten({"params": tree["params"],
                           "batch_stats": tree["batch_stats"]})
    assert sorted(got) == sorted(want)
    for path, a in got.items():
        np.testing.assert_allclose(a, want[path], **GRAD_TOL, err_msg=path)
    assert int(jstate.step) == restored.optimizer.count
    mgr.close()


@pytest.fixture
def jax_numpy_backend(monkeypatch):
    """Force the JAX package's neighbor search onto its numpy backend."""
    import cgnn_tpu.native

    monkeypatch.setattr(cgnn_tpu.native, "neighbor_search_native",
                        lambda *a, **k: None)


def test_jax_trained_checkpoint_predicts_like_predict_py(
        tmp_path, jax_numpy_backend):
    jck, port = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    p = _run([sys.executable, "train.py", "--synthetic", "32", "--device",
              "cpu", "--epochs", "1", "--optim", "Adam", "-b", "16",
              "--ckpt-dir", jck, "--n-conv", "2", "--atom-fea-len", "16",
              "--radius", "5", "--print-freq", "0"])
    assert p.returncode == 0, p.stderr[-2000:]
    sys.path.insert(0, str(ROOT))
    try:
        import jax_checkpoint_to_torch
        import predict as jpredict
    finally:
        sys.path.remove(str(ROOT))
    assert jax_checkpoint_to_torch.main([jck, port, "--device", "cpu"]) == 0
    meta = CheckpointManager(port).read_meta()
    assert meta["epoch"] == 0 and meta["model"]["n_conv"] == 2
    csvs = {}
    for side, run in (("jax", jpredict.main), ("port", None)):
        csvs[side] = str(tmp_path / f"{side}.csv")
        args = ["--device", "cpu", "--synthetic", "16", "-b", "16",
                "--out", csvs[side]]
        if run is None:
            assert port_predict([port] + args) == 0
        else:
            assert run([jck] + args + ["--compile-cache", ""]) == 0
    rows = {k: list(csv.reader(open(v))) for k, v in csvs.items()}
    assert len(rows["port"]) == len(rows["jax"]) == 16
    assert [r[0] for r in rows["port"]] == [r[0] for r in rows["jax"]]
    assert [r[1] for r in rows["port"]] == [r[1] for r in rows["jax"]]
    np.testing.assert_allclose(
        np.array([float(r[2]) for r in rows["port"]]),
        np.array([float(r[2]) for r in rows["jax"]]), rtol=1e-4, atol=1e-4)
    # the converted checkpoint cannot resume training: no optimizer state
    cfg = ModelConfig.from_meta(meta["model"])
    dcfg = DataConfig.from_meta(meta["data"])
    st, _, _ = tstate.init_train_state(
        cfg, dcfg, tload(4, dcfg.featurize_config()), batch_size=4,
        device="cpu")
    with pytest.raises(CheckpointRestoreError, match="no optimizer state"):
        CheckpointManager(port).restore(st)
