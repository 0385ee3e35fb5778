"""The port's bulk inference and predict entry point against the JAX
package's, on the CPU, with weights carried over from a JAX-initialized
model (non-trivial BatchNorm statistics, a non-identity normalizer):

- ``assign_size_buckets`` and ``plan_batches`` bit-equal;
- ``run_fast_inference`` on the shape-ladder path and on the
  ``buckets=3`` path, and ``run_raw_inference`` (the plain neighbor
  search), each against the JAX function on the same graphs, rtol 1e-5 /
  atol 1e-5 (f32, sums in another order); the port's model runs the
  whole-conv op (``cgconv_impl='pallas'``: its plain version here), the
  JAX model the unfused path;
- ``python -m cgnn_tpu_torch.predict``: its raw-wire and featurized CSVs
  agree (same ids in input order, predictions within 1e-4: f32 distances
  on the raw wire, f64 on the host), what it refuses exits 2 (more
  devices than exist among them), and its default device is the card;
- ``load_server`` on a checkpoint directory answers as on the same
  weights saved as ``params.npz`` + ``meta.json``.
"""

import csv
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.data import rawbatch as jr
from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu.models import CrystalGraphConvNet as JNet
from cgnn_tpu.serve import shapes as jshapes
from cgnn_tpu.train import infer as jinfer
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.state import TrainState as JTrainState
from cgnn_tpu.train.state import make_optimizer as jmake_optimizer
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.data import rawbatch as tr
from cgnn_tpu_torch.predict import main as predict_main
from cgnn_tpu_torch.serve import shapes as tshapes
from cgnn_tpu_torch.serve.server import load_server
from cgnn_tpu_torch.train import infer as tinfer
from cgnn_tpu_torch.train import state as tstate
from cgnn_tpu_torch.train.checkpoint import CheckpointManager
from cgnn_tpu_torch.train.normalizer import Normalizer
from cgnn_tpu_torch.train.step import InferenceState
from test_torch_rawwire import _port_graph
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

M = 8
SMALL = dict(atom_fea_len=16, n_conv=2, h_fea_len=24)
CFG = FeaturizeConfig(radius=5.0, max_num_nbr=M)
TOL = dict(rtol=1e-5, atol=1e-5)
NORM = ([1.5], [2.0])
B = 8  # batch size: several batches and a ragged tail


@pytest.fixture(scope="module")
def models():
    """JAX graphs (geometry kept), JAX variables, the JAX predict state
    and the port's InferenceState on the same weights."""
    graphs = load_synthetic(30, CFG, seed=2, max_atoms=6, keep_geometry=True)
    jnet = JNet(**SMALL, dense_m=M)
    ss = jshapes.plan_shape_set(graphs, B, rungs=2, dense_m=M)
    v = jax.tree_util.tree_map(
        np.array, jnet.init(jax.random.key(0), ss.pack_full(graphs[:1])))
    rng = np.random.default_rng(5)
    for conv in v["batch_stats"].values():
        for bn in conv.values():
            bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    tx = jmake_optimizer("sgd")
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
        normalizer=JNormalizer(mean=jnp.asarray(NORM[0], np.float32),
                               std=jnp.asarray(NORM[1], np.float32)),
        rng=jax.random.key(0), apply_fn=jnet.apply, tx=tx)
    net = build_model(ModelConfig(**SMALL, dense_m=M, cgconv_impl="pallas"),
                      DataConfig(radius=5.0, max_num_nbr=M), device="cpu")
    net.load_state_dict(convert.from_flax_variables(v))
    state = InferenceState(net, Normalizer.from_arrays(*NORM, device="cpu"))
    return types.SimpleNamespace(graphs=graphs,
                                 port=[_port_graph(g) for g in graphs],
                                 jstate=jstate, state=state, variables=v)


@pytest.mark.parametrize("n_buckets", [1, 2, 3, 5])
def test_buckets_and_plans_bit_equal(models, n_buckets):
    jids = jgraph.assign_size_buckets(models.graphs, n_buckets)
    tids = tgraph.assign_size_buckets(models.port, n_buckets)
    assert tids.dtype == jids.dtype
    np.testing.assert_array_equal(tids, jids)
    for snug in (True, False):
        for caps in ((40, 320), (24, 192), (64, 200)):
            assert list(tgraph.plan_batches(models.port, n_buckets + 2,
                                            *caps, snug=snug)) == list(
                jgraph.plan_batches(models.graphs, n_buckets + 2, *caps,
                                    snug=snug))
    with pytest.raises(ValueError, match="exceeds batch capacity"):
        list(tgraph.plan_batches(models.port, 4, 2, 16))


def test_fast_inference_shape_set_matches_jax(models):
    jss = jshapes.plan_shape_set(models.graphs, B, rungs=2, dense_m=M)
    tss = tshapes.plan_shape_set(models.port, B, rungs=2, dense_m=M)
    want, _ = jinfer.run_fast_inference(models.jstate, models.graphs, B,
                                        shape_set=jss)
    got, rate = tinfer.run_fast_inference(models.state, models.port, B,
                                          shape_set=tss)
    assert got.shape == want.shape == (len(models.graphs), 1) and rate > 0
    np.testing.assert_allclose(got, want, **TOL)
    # input order: the same rows one graph at a time
    one = np.concatenate([tinfer.run_fast_inference(
        models.state, [g], 1, shape_set=tss)[0] for g in models.port[:5]])
    np.testing.assert_allclose(one, got[:5], **TOL)


def test_fast_inference_buckets_matches_jax(models):
    want, _ = jinfer.run_fast_inference(models.jstate, models.graphs, B,
                                        buckets=3, dense_m=M, snug=True)
    got, _ = tinfer.run_fast_inference(models.state, models.port, B,
                                       buckets=3, dense_m=M)
    np.testing.assert_allclose(got, want, **TOL)


def test_raw_inference_matches_jax(models):
    jspec = jr.plan_raw_spec(models.graphs, CFG.gdf(), CFG.radius, M)
    jss = jshapes.plan_shape_set(models.graphs, B, rungs=2, dense_m=M,
                                 raw=jspec)
    tspec = tr.plan_raw_spec(models.port, CFG.gdf(), CFG.radius, M)
    tss = tshapes.plan_shape_set(models.port, B, rungs=2, dense_m=M,
                                 raw=tspec)
    jraws = [jr.raw_from_graph(g) for g in models.graphs]
    traws = [tr.raw_from_graph(g) for g in models.port]
    keep = [i for i, r in enumerate(traws) if tss.admits_raw(r)]
    assert keep == [i for i, r in enumerate(jraws) if jss.admits_raw(r)]
    assert len(keep) > B  # several batches
    want, _ = jinfer.run_raw_inference(models.jstate,
                                       [jraws[i] for i in keep], jss)
    got, _ = tinfer.run_raw_inference(models.state, [traws[i] for i in keep],
                                      tss)
    np.testing.assert_allclose(got, want, **TOL)
    # and the featurized answers of the same structures
    feat, _ = tinfer.run_fast_inference(
        models.state, [models.port[i] for i in keep], B, shape_set=tss)
    np.testing.assert_allclose(got, feat, rtol=1e-4, atol=1e-4)


def test_inference_refuses_unported_options(models):
    """What bulk inference refuses: an engine neither package has, and a
    raw call without a raw spec. ``devices`` and ``engine='mesh'`` are
    served (tests/test_torch_executor.py)."""
    tss = tshapes.plan_shape_set(models.port, B, rungs=1, dense_m=M)
    for kw in (dict(engine="ring"), dict(devices=["cpu", "cpu"],
                                         engine="pmap")):
        with pytest.raises(ValueError, match="engine must be"):
            tinfer.run_fast_inference(models.state, models.port, B,
                                      shape_set=tss, **kw)
    with pytest.raises(ValueError, match="raw spec"):
        tinfer.run_raw_inference(models.state, [], tss)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A committed port checkpoint of a seeded small model (2 convs,
    F=16), and the same weights as params.npz + meta.json."""
    from cgnn_tpu_torch.data.dataset import load_synthetic as tload

    d = tmp_path_factory.mktemp("ckpt")
    data_cfg = DataConfig(radius=5.0, max_num_nbr=M)
    model_cfg = ModelConfig(**SMALL, dense_m=M)
    graphs = tload(24, data_cfg.featurize_config(), seed=3)
    state, _, _ = tstate.init_train_state(model_cfg, data_cfg, graphs,
                                          batch_size=B, device="cpu")
    mgr = CheckpointManager(str(d / "ck"))
    mgr.save(state, {"model": model_cfg.to_meta(), "data": data_cfg.to_meta(),
                     "task": "regression", "epoch": 0, "best_mae": 1.0},
             is_best=True)
    mgr.close()
    npz, meta = str(d / "params.npz"), str(d / "meta.json")
    convert.save_params(
        npz, meta, convert.to_flax_variables(state.model.state_dict()),
        model_cfg, data_cfg, normalizer_mean=state.normalizer.mean.numpy(),
        normalizer_std=state.normalizer.std.numpy())
    return types.SimpleNamespace(dir=str(d / "ck"), npz=npz, meta=meta,
                                 graphs=graphs, tmp=d)


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_predict_raw_and_featurized_csvs_agree(ckpt, capsys):
    out = {}
    for wire in ("raw", "featurized"):
        out[wire] = str(ckpt.tmp / f"{wire}.csv")
        assert predict_main([ckpt.dir, "--device", "cpu", "--synthetic",
                             "20", "-b", str(B), "--wire", wire,
                             "--out", out[wire]]) == 0
    said = capsys.readouterr().out
    assert '"raw": 20' in said and '"batches_raw": 2' in said
    raw, feat = _csv(out["raw"]), _csv(out["featurized"])
    assert len(raw) == len(feat) == 20
    assert [r[0] for r in raw] == [r[0] for r in feat] == [
        f"synth-{i:06d}" for i in range(20)]
    assert [r[1] for r in raw] == [r[1] for r in feat]  # targets
    np.testing.assert_allclose(np.array([float(r[2]) for r in raw]),
                               np.array([float(r[2]) for r in feat]),
                               rtol=1e-4, atol=1e-4)
    # the buckets path gives the featurized answers
    bucket_csv = str(ckpt.tmp / "buckets.csv")
    assert predict_main([ckpt.dir, "--device", "cpu", "--synthetic", "20",
                         "-b", str(B), "--buckets", "3",
                         "--out", bucket_csv]) == 0
    np.testing.assert_allclose(
        np.array([float(r[2]) for r in _csv(bucket_csv)]),
        np.array([float(r[2]) for r in feat]), rtol=1e-5, atol=2e-6)


REFUSED = {  # case -> (extra flags, what the message names)
    "cache": (["--cache", "graphs.npz"], "does not exist"),
    # refused until the ladder was ported; now accepted (named None):
    # its answers must equal the snug packing's
    "packing_ladder": (["--packing", "ladder", "--buckets", "1"], None),
    # a cache without raw distances cannot stage compactly
    "compact_on": (["--compact", "on"], "compact staging unavailable"),
    # more devices than exist: never clamped
    "devices": (["--devices", "4"], "local device(s) exist"),
    # accepted: one CPU device runs the single loop whatever the engine
    "engine_mesh": (["--engine", "mesh"], None),
    "data_dir": ([], "id_prop.csv"),
    "no_data": ([], "DATA_DIR, --cache, or --synthetic is required"),
    "no_checkpoint": ([], "no 'latest' checkpoint"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_predict_refusals_exit_2(ckpt, case, capsys, tmp_path):
    flags, named = REFUSED[case]
    argv = [ckpt.dir, "--device", "cpu", "--out", str(tmp_path / "x.csv"),
            *flags] + ([] if case in ("no_data", "data_dir", "compact_on")
                       else ["--synthetic", "4"])
    if case == "data_dir":
        argv.insert(1, str(tmp_path / "no_cif_dir"))
    elif case == "compact_on":
        from cgnn_tpu_torch.data.cache import save_graph_cache

        cache = str(tmp_path / "no_distances.npz")
        save_graph_cache([dataclasses.replace(g, distances=None)
                          for g in ckpt.graphs[:4]], cache)
        argv += ["--cache", cache]
    elif case == "no_checkpoint":
        argv[0] = str(tmp_path / "empty")
    if named is None:
        snug = str(tmp_path / "snug.csv")
        assert predict_main(argv) == 0
        assert predict_main([*argv[:4], snug, "--buckets", "1",
                             "--synthetic", "4"]) == 0
        got, want = _csv(str(tmp_path / "x.csv")), _csv(snug)
        assert [r[0] for r in got] == [r[0] for r in want]
        # the same graphs in other batch shapes: f32 sums reordered
        np.testing.assert_allclose(
            np.array([[float(v) for v in r[1:]] for r in got]),
            np.array([[float(v) for v in r[1:]] for r in want]),
            rtol=1e-5, atol=2e-6)
        return
    assert predict_main(argv) == 2
    assert named in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x.csv")


def test_predict_defaults_to_cuda(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_main([ckpt.dir, "--synthetic", "4"])


def test_load_server_from_checkpoint_dir(ckpt):
    kw = dict(batch_size=B, rungs=2, calibration=ckpt.graphs, device="cpu",
              log_fn=lambda *a: None, default_timeout_ms=60_000.0)
    answers = []
    for args in ((ckpt.dir,), (ckpt.npz, ckpt.meta)):
        server, info = load_server(*args, **kw)
        try:
            answers.append((server.version, np.stack([
                server.predict(g, timeout_ms=60_000).prediction
                for g in ckpt.graphs[:6]])))
        finally:
            assert server.drain(timeout_s=30)
    (v_ck, got), (v_npz, want) = answers
    assert v_ck == "ckpt-00000000" and v_npz == "params.npz"
    np.testing.assert_array_equal(got, want)
    server, _ = load_server(ckpt.dir, tag="best", **kw)
    assert server.version == "ckpt-00000000"
    assert server.drain(timeout_s=30)
    with pytest.raises(FileNotFoundError):
        load_server(str(ckpt.tmp / "nothing"), **kw)
