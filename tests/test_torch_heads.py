"""The port's classification head and multi-task head against the JAX
package's, with weights carried by ``convert.from_flax_variables``, on
the same packed batches (f32, rtol 1e-4 / atol 1e-5 on outputs and metric
sums: f32 roundoff through the convs):

- classification: the [G, num_classes] log-probs, ``classification_loss``'s
  NLL and ``correct_sum``, eval and train mode;
- the multi-task head: its [G, T] output and ``regression_loss``'s
  per-task MAE sums with a quarter of the labels missing;
- one SGD train step of each with dropout 0 (loss, metric sums and every
  parameter after the step, the f32 training tolerances of
  tests/test_torch_train.py: rtol 2e-3 / atol 1e-4);
- the port's inverted dropout given flax's keep mask (drawn by applying
  flax's ``nn.Dropout`` to ones), bit-equal to flax's output, f32 and bf16;
- the weight round trip of both heads (JAX tree -> port -> JAX tree bit
  for bit; the numpy init's tree has the JAX init's paths and shapes);
- the entry point's refusals: a label outside [0, num_classes), and
  ``--task force --aggregation pallas``;
- a ``train.py --bf16 --multi-task-head`` checkpoint carried over by
  ``jax_checkpoint_to_torch.py`` predicting what predict.py predicts,
  within 2e-2 of the largest |prediction| (bf16).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgnn_tpu.config import ModelConfig as JModelConfig
from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.state import TrainState as JTrainState
from cgnn_tpu.train.state import make_optimizer as jmake_optimizer
from cgnn_tpu.train.step import classification_loss as jclassification_loss
from cgnn_tpu.train.step import make_train_step as jmake_train_step
from cgnn_tpu.train.step import regression_loss as jregression_loss
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.models.cgcnn import apply_dropout
from cgnn_tpu_torch.train import state as tstate
from cgnn_tpu_torch.train.normalizer import Normalizer
from cgnn_tpu_torch.train.step import (
    classification_loss,
    make_train_step,
    regression_loss,
)
from test_torch_resume import jax_numpy_backend  # noqa: F401 (a fixture)
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

M = 8
SMALL = dict(atom_fea_len=16, n_conv=2, h_fea_len=24)
CFG = FeaturizeConfig(radius=5.0, max_num_nbr=M)
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=1e-4)
T = 4  # multi-task columns (BASELINE config #3's four properties)


def _classed(graphs, num_classes=3):
    """Labels 0 .. num_classes-1 by the target's rank."""
    t = np.array([float(g.target[0]) for g in graphs])
    ranks = np.argsort(np.argsort(t))
    return [dataclasses.replace(g, target=np.float32(
        [ranks[i] * num_classes // len(graphs)]))
        for i, g in enumerate(graphs)]


def _multi(graphs, seed=0):
    """T target columns, about a quarter of the cells empty."""
    rng = np.random.default_rng(seed)
    out = []
    for g in graphs:
        t = np.float32([g.target[0], *rng.normal(0.0, 1.0, T - 1)])
        mask = (rng.random(T) > 0.25).astype(np.float32)
        mask[0] = 1.0
        out.append(dataclasses.replace(g, target=t, target_mask=mask))
    return out


def _port(g):
    return tgraph.CrystalGraph(g.atom_fea, g.edge_fea, g.centers,
                               g.neighbors, g.target,
                               target_mask=g.target_mask)


def _batches(graphs):
    nc, _ = jgraph.capacities_for(graphs, len(graphs), dense_m=M, snug=True)
    nc += 16
    jb = next(iter(jgraph.batch_iterator(graphs, len(graphs), nc, nc * M,
                                         dense_m=M, snug=True)))
    tb = next(iter(tgraph.batch_iterator([_port(g) for g in graphs],
                                         len(graphs), nc, nc * M,
                                         dense_m=M, snug=True)))
    return jb, tb


def _cfgs(kind, **kw):
    if kind == "classification":
        kw = dict(classification=True, num_classes=3, **kw)
    else:
        kw = dict(multi_task_head=True, num_targets=T, n_h=2, **kw)
    return (JModelConfig(**SMALL, dense_m=M, **kw),
            ModelConfig(**SMALL, dense_m=M, **kw))


def _case(kind, seed=2):
    graphs = load_synthetic(14, CFG, seed=seed, max_atoms=6)
    graphs = _classed(graphs) if kind == "classification" else _multi(graphs)
    jb, tb = _batches(graphs)
    jcfg, tcfg = _cfgs(kind)
    jnet = jcfg.build()
    v = jax.tree_util.tree_map(np.array, jnet.init(jax.random.key(0), jb))
    rng = np.random.default_rng(seed)
    for conv in v["batch_stats"].values():
        for bn in conv.values():
            bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(
                np.float32)
    net = build_model(tcfg, DataConfig(radius=5.0, max_num_nbr=M),
                      device="cpu")
    net.load_state_dict(convert.from_flax_variables(v))
    targets = np.stack([g.target for g in graphs])
    masks = np.stack([g.target_mask if g.target_mask is not None
                      else np.ones_like(g.target) for g in graphs])
    return jnet, v, net, jb, tb, targets, masks


def _sums(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("kind", ["classification", "multi_task"])
def test_heads_match_jax(kind, mode):
    jnet, v, net, jb, tb, targets, masks = _case(kind)
    train = mode == "train"
    if train:
        want, _ = jnet.apply(v, jb, train=True, mutable=["batch_stats"])
        net.train()
        got = net(tb).detach()
    else:
        want = jnet.apply(v, jb, train=False)
        with torch.inference_mode():
            got = net(tb)
    want = np.asarray(want)
    width = 3 if kind == "classification" else T
    assert got.shape == want.shape == (tb.graph_mask.shape[0], width)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if kind == "classification":
        real = tb.graph_mask.numpy() > 0
        np.testing.assert_allclose(np.exp(got.numpy()[real]).sum(-1), 1.0,
                                   rtol=0, atol=1e-5)
        _, jm = jclassification_loss(jnp.asarray(want), jb, None)
        loss, tm = classification_loss(got, tb)
        assert set(tm) == set(jm) == {"loss_sum", "correct_sum", "count"}
    else:
        jnorm = JNormalizer.fit(targets, masks)
        _, jm = jregression_loss(jnp.asarray(want), jb, jnorm)
        loss, tm = regression_loss(got, tb, Normalizer.fit(targets, masks,
                                                           device="cpu"))
        assert {f"mae_task{t}_sum" for t in range(T)} <= set(tm)
        assert set(tm) == set(jm)
    for k, w in _sums(jm).items():
        np.testing.assert_allclose(float(tm[k]), w, **TOL, err_msg=k)


@pytest.mark.parametrize("kind", ["classification", "multi_task"])
def test_one_train_step_matches_jax(kind):
    jnet, v, net, jb, tb, targets, masks = _case(kind, seed=6)
    classification = kind == "classification"
    opt = dict(lr=0.05, momentum=0.9)
    tx = jmake_optimizer("sgd", **opt)
    jnorm = (JNormalizer.identity(1) if classification
             else JNormalizer.fit(targets, masks))
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
        normalizer=jnorm, rng=jax.random.key(0), apply_fn=jnet.apply, tx=tx)
    jstate, jm = jmake_train_step(classification)(jstate, jb)
    state = tstate.TrainState(
        net, tstate.make_optimizer(net.parameters(), "sgd", **opt),
        Normalizer.identity(1, device="cpu") if classification
        else Normalizer.fit(targets, masks, device="cpu"))
    tm = make_train_step(classification=classification)(state, tb)
    for k, w in _sums(jm).items():
        np.testing.assert_allclose(float(tm[k]), w, rtol=1e-4, err_msg=k)
    want = convert.flatten(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}))
    got = convert.flatten(convert.to_flax_variables(net.state_dict()))
    assert sorted(got) == sorted(want)
    for path, a in got.items():
        np.testing.assert_allclose(a, want[path], **GRAD_TOL, err_msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_given_flax_mask_is_bit_equal(dtype):
    rate = 0.3
    rng = np.random.default_rng(0)
    x = rng.standard_normal((9, 24)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = jnp.asarray(x).astype(jdt)
    key = jax.random.key(7)
    drop = fnn.Dropout(rate, deterministic=False)
    keep = np.asarray(drop.apply({}, jnp.ones_like(jx),
                                 rngs={"dropout": key})) != 0
    assert 0 < keep.mean() < 1
    want = np.asarray(drop.apply({}, jx, rngs={"dropout": key})
                      .astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = apply_dropout(tx, torch.from_numpy(keep), rate)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_dropout_draws_from_the_model_generator():
    """Train-mode dropout draws from the model's generator alone: the
    same generator state gives the same mask, the global one is
    untouched, eval draws nothing, and consecutive steps differ."""
    _, v, _, _, tb, _, _ = _case("classification")
    _, tcfg = _cfgs("classification", dropout=0.5)
    net = build_model(tcfg, DataConfig(radius=5.0, max_num_nbr=M),
                      device="cpu", dropout_seed=11)
    net.load_state_dict(convert.from_flax_variables(v))
    net.train()
    gen = net.dropout_generator()
    start = gen.get_state()
    glob = torch.random.get_rng_state()
    a = net(tb).detach()
    b = net(tb).detach()
    assert not torch.equal(a, b)
    gen.set_state(start)
    assert torch.equal(net(tb).detach(), a)
    assert torch.equal(torch.random.get_rng_state(), glob)
    after = gen.get_state()
    net.eval()
    net(tb)
    assert torch.equal(gen.get_state(), after)


@pytest.mark.parametrize("kind", ["classification", "multi_task"])
def test_head_weights_round_trip(kind):
    _, v, net, _, _, _, _ = _case(kind)
    back = convert.flatten(convert.to_flax_variables(net.state_dict()))
    flat = convert.flatten(v)
    assert set(back) == set(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    if kind == "multi_task":
        assert "params/head/task3_out/kernel" in flat
        assert "params/head/task0_fc0/kernel" in flat
        assert not any(k.startswith("params/fc_") for k in flat)
    else:
        assert flat["params/fc_out/kernel"].shape == (SMALL["h_fea_len"], 3)
    _, tcfg = _cfgs(kind)
    init = convert.flatten(convert.init_params(
        tcfg, DataConfig(radius=5.0, max_num_nbr=M), seed=1))
    assert {k: a.shape for k, a in init.items()} == {
        k: a.shape for k, a in flat.items()}


def test_entry_point_refuses_bad_labels_and_force(tmp_path, capsys):
    from cgnn_tpu_torch.train.__main__ import bad_label, main

    graphs = _classed(load_synthetic(6, CFG, seed=1, max_atoms=4), 2)
    assert bad_label(graphs, 2) is None
    graphs[3] = dataclasses.replace(graphs[3], target=np.float32([2.0]))
    why = bad_label(graphs, 2)
    assert "row 3" in why and "outside [0, 2)" in why
    assert main(["--synthetic", "8", "--device", "cpu", "--task",
                 "classification", "--ckpt-dir", str(tmp_path / "ck"),
                 "--out-dir", str(tmp_path)]) == 2
    assert "row 0" in capsys.readouterr().err
    # the force task trains (tests/test_torch_force_entry.py); what it
    # refuses is the JAX package's failure, COO with --aggregation pallas
    assert main(["--synthetic", "8", "--device", "cpu", "--task",
                 "force", "--aggregation", "pallas"]) == 2
    assert "ROADMAP Queue 3" in capsys.readouterr().err


def test_jax_bf16_multitask_checkpoint_converts_and_predicts(
        tmp_path, jax_numpy_backend):
    """A ``train.py --bf16 --multi-task-head`` checkpoint through
    ``jax_checkpoint_to_torch.py`` (the head's tree carried over) predicts
    through the port's entry point what predict.py predicts from it,
    within 2e-2 of the largest |prediction| (bf16 matmuls round at other
    places in the two frameworks), the same ids and targets."""
    import csv
    import sys

    from cgnn_tpu_torch.predict import main as port_predict
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager
    from test_torch_resume import ROOT, SMALL_CLI, _run

    jck, port = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    p = _run([sys.executable, "train.py", "--synthetic", "32", "--device",
              "cpu", "--epochs", "1", "-b", "16", "--bf16",
              "--multi-task-head", "--n-h", "2", "--ckpt-dir", jck,
              *SMALL_CLI])
    assert p.returncode == 0, p.stderr[-2000:]
    sys.path.insert(0, str(ROOT))
    try:
        import jax_checkpoint_to_torch
        import predict as jpredict
    finally:
        sys.path.remove(str(ROOT))
    assert jax_checkpoint_to_torch.main([jck, port, "--device", "cpu"]) == 0
    meta = CheckpointManager(port).read_meta()
    cfg = ModelConfig.from_meta(meta["model"])
    assert cfg.dtype == "bfloat16" and cfg.multi_task_head
    rows = {}
    for side in ("jax", "port"):
        out = str(tmp_path / f"{side}.csv")
        args = ["--device", "cpu", "--synthetic", "16", "-b", "16",
                "--out", out]
        if side == "port":
            assert port_predict([port] + args) == 0
        else:
            assert jpredict.main([jck] + args + ["--compile-cache", ""]) == 0
        rows[side] = list(csv.reader(open(out)))
    assert [r[:2] for r in rows["port"]] == [r[:2] for r in rows["jax"]]
    got, want = (np.array([float(r[2]) for r in rows[s]])
                 for s in ("port", "jax"))
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
