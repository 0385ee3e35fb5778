"""The port's CrystalGraphConvNet against the JAX package's, with weights
carried by ``convert.from_flax_variables``: eval forward for every
``cgconv_impl`` setting (the JAX Pallas kernel in interpret mode), the
weight file round trip, the numpy init's tree, and the config meta.
Same packed arrays on both sides; f32, rtol 1e-4 / atol 1e-5."""

import jax
import numpy as np
import pytest
import torch

from cgnn_tpu.config import ModelConfig as JModelConfig
from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu.data.graph import pack_graphs as jpack
from cgnn_tpu.models import CrystalGraphConvNet as JNet
from cgnn_tpu.ops.pallas_cgconv import interpret_mode
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
from cgnn_tpu_torch.data.graph import CrystalGraph, pack_graphs
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

M = 8
SMALL = dict(atom_fea_len=16, n_conv=2, h_fea_len=24)
TOL = dict(rtol=1e-4, atol=1e-5)


def _graphs():
    return load_synthetic(14, FeaturizeConfig(radius=5.0, max_num_nbr=M),
                          seed=2, max_atoms=6)


def _pack_both(graphs):
    n = sum(g.num_nodes for g in graphs)
    nc = -(-(n + 9) // 8) * 8
    jb = jpack(graphs, nc, nc * M, len(graphs) + 2, dense_m=M)
    tb = pack_graphs([CrystalGraph(g.atom_fea, g.edge_fea, g.centers,
                                   g.neighbors, g.target) for g in graphs],
                     nc, nc * M, len(graphs) + 2, dense_m=M)
    return jb, tb


def _variables(jnet, jbatch, seed=0):
    """JAX init, then non-trivial running statistics from a numpy seed so
    both BatchNorms do real work in eval."""
    with interpret_mode():  # a 'pallas' model runs its kernel at init
        v = jax.tree_util.tree_map(np.asarray,
                                   jnet.init(jax.random.key(0), jbatch))
    v = jax.tree_util.tree_map(np.array, v)  # writable copies
    rng = np.random.default_rng(seed)
    for conv in v["batch_stats"].values():
        for bn in conv.values():
            bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return v


@pytest.mark.parametrize("n_h", [1, 2])
@pytest.mark.parametrize("impl", ["", "xla", "pallas"])
def test_eval_forward_matches_jax(impl, n_h):
    graphs = _graphs()
    jb, tb = _pack_both(graphs)
    jnet = JNet(**SMALL, n_h=n_h, dense_m=M, cgconv_impl=impl or None)
    variables = _variables(jnet, jb)
    if impl == "pallas":
        with interpret_mode():
            want = np.asarray(jnet.apply(variables, jb, train=False))
    else:
        want = np.asarray(jnet.apply(variables, jb, train=False))

    cfg = ModelConfig(**SMALL, n_h=n_h, dense_m=M, cgconv_impl=impl)
    net = cfg.build(nbr_fea_len=graphs[0].edge_fea.shape[1], device="cpu")
    net.load_state_dict(convert.from_flax_variables(variables))
    with torch.inference_mode():
        got = net(tb).numpy()
    assert got.shape == want.shape == (len(graphs) + 2, 1)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, **TOL)


def test_weight_layout():
    graphs = _graphs()
    jb, _ = _pack_both(graphs)
    v = _variables(JNet(**SMALL, dense_m=M), jb)
    sd = convert.from_flax_variables(v)
    p = v["params"]
    np.testing.assert_array_equal(sd["embedding.weight"].numpy(),
                                  p["embedding"]["kernel"].T)
    np.testing.assert_array_equal(sd["conv_0.fc_full.kernel"].numpy(),
                                  p["conv_0"]["fc_full"]["kernel"])
    np.testing.assert_array_equal(sd["conv_1.bn1.weight"].numpy(),
                                  p["conv_1"]["bn1"]["scale"])
    np.testing.assert_array_equal(
        sd["conv_1.bn2.running_var"].numpy(),
        v["batch_stats"]["conv_1"]["bn2"]["var"])
    back = convert.flatten(convert.to_flax_variables(sd))
    for k, a in convert.flatten(v).items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)
    assert set(back) == set(convert.flatten(v))


def test_save_load_round_trip_bit_exact(tmp_path):
    jb, _ = _pack_both(_graphs())
    v = _variables(JNet(**SMALL, dense_m=M), jb)
    cfg = ModelConfig(**SMALL, dense_m=M, cgconv_impl="pallas")
    dcfg = DataConfig(radius=5.0, max_num_nbr=M)
    npz, meta = tmp_path / "params.npz", tmp_path / "meta.json"
    convert.save_params(str(npz), str(meta), v, cfg, dcfg,
                        normalizer_mean=[1.1], normalizer_std=[0.3])
    v2, m2 = convert.load_params(str(npz), str(meta))
    flat, flat2 = convert.flatten(v), convert.flatten(v2)
    assert set(flat) == set(flat2)
    for k in flat:
        assert flat2[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(flat2[k], flat[k], err_msg=k)
    assert ModelConfig.from_meta(m2["model"]) == cfg
    assert DataConfig.from_meta(m2["data"]) == dcfg
    np.testing.assert_array_equal(
        np.asarray(m2["normalizer"]["mean"], np.float32),
        np.float32([1.1]))
    np.testing.assert_array_equal(
        np.asarray(m2["normalizer"]["std"], np.float32),
        np.float32([0.3]))


@pytest.mark.parametrize("n_h", [1, 3])
def test_init_params_tree_matches_jax_init(n_h):
    jb, _ = _pack_both(_graphs())
    jv = jax.tree_util.tree_map(
        np.asarray, JNet(**SMALL, n_h=n_h, dense_m=M).init(
            jax.random.key(0), jb))
    cfg = ModelConfig(**SMALL, n_h=n_h, dense_m=M)
    pv = convert.init_params(cfg, DataConfig(radius=5.0, max_num_nbr=M),
                             seed=3)
    jf, pf = convert.flatten(jv), convert.flatten(pv)
    assert set(jf) == set(pf)
    for k in jf:
        assert pf[k].shape == jf[k].shape and pf[k].dtype == np.float32, k
    k = pf["params/conv_0/fc_full/kernel"]
    fan_in = k.shape[0]
    assert np.abs(k).max() <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978
    assert abs(k.std() * np.sqrt(fan_in) - 1.0) < 0.1
    np.testing.assert_array_equal(
        convert.flatten(convert.init_params(
            cfg, DataConfig(radius=5.0, max_num_nbr=M), seed=3))[
            "params/conv_0/fc_full/kernel"], k)


def test_model_config_meta_matches_jax():
    kw = dict(atom_fea_len=32, n_conv=4, dense_m=12, cgconv_impl="pallas",
              cgconv_window=384)
    assert ModelConfig(**kw).to_meta() == JModelConfig(**kw).to_meta()
    meta = JModelConfig(**kw).to_meta()
    assert ModelConfig.from_meta(meta).to_meta() == meta
    assert ModelConfig(**kw).for_arbitrary_inputs().cgconv_window == 0


def test_unported_settings_raise(monkeypatch):
    import cgnn_tpu_torch.config as tconfig

    dcfg = DataConfig()
    # bf16 builds on the card with every setting whose kernels have bf16
    # instances: kernel 3 (fused_epilogue='pallas') and kernel 6 (COO with
    # aggregation='pallas') among them
    bf16_kernel_paths = (dict(dense_m=12, fused_epilogue="pallas"),
                         dict(dense_m=0, aggregation="pallas"))
    for ok in bf16_kernel_paths:
        cfg = ModelConfig(dtype="bfloat16", **ok)
        assert build_model(cfg, dcfg, device="cpu") is not None
        with monkeypatch.context() as m:  # the card, stood in for
            m.setattr(tconfig, "resolve_device",
                      lambda device: torch.device("cuda"))
            m.setattr(torch.nn.Module, "to", lambda self, *a, **k: self)
            assert build_model(cfg, dcfg, device="cuda") is not None
    # what stays refused: the force task where the JAX package fails or
    # refuses (COO with aggregation='pallas'; the BN-fusing ops), named
    assert build_model(ModelConfig(dense_m=12), dcfg, device="cpu",
                       task="force") is not None
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 3"):
        build_model(ModelConfig(dense_m=0, aggregation="pallas"), dcfg,
                    device="cpu", task="force")
    for bad in (dict(fused_epilogue="pallas"), dict(cgconv_impl="xla")):
        with pytest.raises(NotImplementedError, match="BatchNorm"):
            build_model(ModelConfig(dense_m=12, **bad), dcfg, device="cpu",
                        task="force")
    # classification, the multi-task head and bf16 build
    for ok in (dict(classification=True), dict(multi_task_head=True),
               dict(dtype="bfloat16")):
        assert build_model(ModelConfig(dense_m=12, **ok), dcfg,
                           device="cpu") is not None
    # COO is ported (tests/test_torch_coo.py), without the dense-layout
    # fused ops
    with pytest.raises(NotImplementedError, match="dense layout"):
        build_model(ModelConfig(cgconv_impl="pallas"), dcfg, device="cpu")
    # train mode and the fused epilogue are ported: both build and run
    _, tb = _pack_both(_graphs())
    for ok in (dict(), dict(fused_epilogue="xla")):
        cfg = ModelConfig(**SMALL, dense_m=M, **ok)
        small = DataConfig(radius=5.0, max_num_nbr=M)
        net = build_model(cfg, small, device="cpu")
        net.load_state_dict(convert.from_flax_variables(
            convert.init_params(cfg, small, seed=0)))
        net.train()
        assert torch.isfinite(net(tb)).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(ModelConfig(dense_m=12), dcfg)  # default device: cuda


@pytest.mark.parametrize("layout", ["packed", "raw_blocks", "empty_slots"])
def test_segment_mean_sorted_sums_equal_index_add(layout):
    """The pooling's fixed-order segment sums (``segment_mean``) equal the
    ``index_add_`` formula, values and gradient, on the node layouts the
    packers make: real nodes by graph with padding after (graph slot 0),
    one block of slots a structure with padding inside each block (the
    raw expander's), and graph slots with no node."""
    from cgnn_tpu_torch.ops.segment import segment_mean, segment_sum

    rng = np.random.default_rng(3)
    if layout == "raw_blocks":
        g, s = 6, 8
        ids = np.repeat(np.arange(g), s)
        w = (rng.random(g * s) < 0.6).astype(np.float32)
        w[s: 2 * s] = 0.0  # an all-padding structure slot
    else:
        g = 9 if layout == "empty_slots" else 6
        ids = np.sort(rng.integers(0, 5, 40))
        w = np.ones(len(ids), np.float32)
        ids = np.concatenate([ids, np.zeros(12, np.int64)])
        w = np.concatenate([w, np.zeros(12, np.float32)])
    ids = torch.from_numpy(ids.astype(np.int32))
    w = torch.from_numpy(w)
    x = torch.from_numpy(rng.standard_normal((len(ids), 7)).astype(
        np.float32)).requires_grad_(True)
    got = segment_mean(x, ids, g, w)
    want = (segment_sum(x * w[:, None], ids, g)
            / torch.clamp_min(segment_sum(w, ids, g), 1.0)[:, None])
    assert torch.equal(got, want)
    ct = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    assert torch.equal(torch.autograd.grad((got * ct).sum(), x)[0],
                       torch.autograd.grad((want * ct).sum(), x)[0])
