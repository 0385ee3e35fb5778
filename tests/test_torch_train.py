"""The port's training path against the JAX package's, on the same numpy
inputs and packed batches: the transpose gather's backward, MaskedBatchNorm
in train mode, the whole-conv training op ``fused_cgconv`` (the JAX Pallas
kernels in interpret mode, whole range and a bounded window), the model in
train mode for every conv setting with weights carried by
``convert.from_flax_variables``, a 3-step optimizer trajectory, and the
``python -m cgnn_tpu_torch.train`` entry point.

Tolerances, with their reasons:

- agg rtol 2e-5 / atol 2e-5 and batch statistics rtol 1e-4 / atol 1e-5:
  f32, sums over slots and rows taken in another order (the JAX package's
  own, tests/test_ops.py ``TestFusedEpilogue``/``TestFusedCGConv``);
- BatchNorm values and grads rtol 1e-5 / atol 1e-5 in f32 (one
  normalization), 1e-10 in f64;
- model loss rel 1e-4, parameter grads rtol 2e-3 / atol 1e-4, running
  stats rtol 1e-4 / atol 1e-5 (the JAX package's ``TestFusedCGConv``: f32
  roundoff through three convs and the BN backward);
- the 3-step trajectory: in f64 for the unfused path (rel 1e-9 on the
  losses, rtol 1e-7 / atol 1e-9 on the parameters: roundoff only), and in
  f32 for the kernel paths with the model tolerances above; under Adam,
  fc_full's bias (to which BN1 makes the loss invariant, so its gradient
  is roundoff that Adam scales up, to lr-sized steps in f32) and bn1's
  running mean are held to the bound of those steps, 2 * lr * K.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.models import CrystalGraphConvNet as JNet
from cgnn_tpu.ops import pallas_cgconv as jops
from cgnn_tpu.ops.norm import MaskedBatchNorm as JBN
from cgnn_tpu.ops.segment import gather_transpose as jgather_transpose
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.state import TrainState as JTrainState
from cgnn_tpu.train.state import make_optimizer as jmake_optimizer
from cgnn_tpu.train.step import make_train_step as jmake_train_step
from cgnn_tpu.train.step import regression_loss as jregression_loss
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.ops import fused_cgconv as tops
from cgnn_tpu_torch.ops.norm import MaskedBatchNorm
from cgnn_tpu_torch.ops.segment import gather, gather_transpose
from cgnn_tpu_torch.train import state as tstate
from cgnn_tpu_torch.train.normalizer import Normalizer
from cgnn_tpu_torch.train.step import make_train_step, regression_loss

ROOT = Path(__file__).resolve().parents[1]
M = 8
SMALL = dict(atom_fea_len=16, n_conv=2, h_fea_len=24)
AGG_TOL = dict(rtol=2e-5, atol=2e-5)
STAT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=1e-4)


def _graphs(n=14, seed=2):
    return load_synthetic(n, FeaturizeConfig(radius=5.0, max_num_nbr=M),
                          seed=seed, max_atoms=6)


def _port(g):
    return tgraph.CrystalGraph(g.atom_fea, g.edge_fea, g.centers,
                               g.neighbors, g.target)


def _batches(graphs, n_batches=1, shuffle=False, seed=0):
    """The same packed training batches (two-tier transpose) on both
    sides: the JAX iterator's and the port's, from one numpy seed."""
    nc, ec = jgraph.capacities_for(graphs, len(graphs), dense_m=M,
                                   snug=True)
    nc += 16  # padding rows and slots in every batch
    jb = list(jgraph.batch_iterator(graphs, len(graphs), nc, nc * M,
                                    dense_m=M, snug=True))
    tb = list(tgraph.batch_iterator([_port(g) for g in graphs],
                                    len(graphs), nc, nc * M, dense_m=M,
                                    snug=True))
    return jb[0], tb[0]


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# gather_transpose
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["two", "single", "none"])
def test_gather_transpose_grad_equals_plain_gather_grad(tier):
    graphs = [_port(g) for g in _graphs()]
    n = tgraph._align8(sum(g.num_nodes for g in graphs) + 5)
    caps = {"two": {"over_cap": tgraph.overflow_cap(graphs, 20, M)},
            "single": {"in_cap": tgraph.in_degree_cap(graphs)},
            "none": {}}[tier]
    b = tgraph.pack_graphs(graphs, n, n * M, 20, dense_m=M, **caps)
    rng = np.random.default_rng(0)
    nodes = _t(rng.standard_normal((n, 5)), torch.float64)
    ct = rng.standard_normal((n * M, 5)) * b.edge_mask.numpy()[:, None]
    tr = (b.in_slots, b.in_mask, b.over_slots, b.over_nodes, b.over_mask)
    x = nodes.clone().requires_grad_()
    out = gather_transpose(x, b.neighbors, *(tr if tier != "none" else ()))
    (out * _t(ct)).sum().backward()
    y = nodes.clone().requires_grad_()
    (gather(y, b.neighbors) * _t(ct)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  nodes.numpy()[b.neighbors.numpy()])
    if tier != "none":  # and the JAX package's transpose gives the same
        jtr = [None if a is None else jnp.asarray(a.numpy()) for a in tr]
        want = jax.grad(lambda v: (jgather_transpose(
            v, jnp.asarray(b.neighbors.numpy()), jtr[0], jtr[1],
            over_slots=jtr[2], over_nodes=jtr[3], over_mask=jtr[4])
            * ct).sum())(jnp.asarray(nodes.numpy()))
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# MaskedBatchNorm, train mode
# ---------------------------------------------------------------------------


def _bn_case(dtype, seed=0, all_padding=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.7, 1.3, size=(23, 5, 6)).astype(dtype)
    mask = (rng.random((23, 5)) > 0.3).astype(np.float32)
    mask[-4:] = 0.0
    if all_padding:
        mask[:] = 0.0
    scale = rng.normal(1.0, 0.1, 6).astype(dtype)
    bias = rng.normal(0.0, 0.1, 6).astype(dtype)
    ct = rng.standard_normal(x.shape).astype(dtype)
    return x, mask, scale, bias, ct


def _jax_bn(x, mask, scale, bias, ct, rmean, rvar):
    bn = JBN()

    def loss(x, scale, bias):
        y, mut = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": {"mean": rmean, "var": rvar}},
                          x, mask=mask, use_running_average=False,
                          mutable=["batch_stats"])
        return (y * ct).sum(), (y, mut["batch_stats"])

    (_, (y, stats)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    return (np.asarray(y), np.asarray(stats["mean"]),
            np.asarray(stats["var"]), [np.asarray(g) for g in grads])


@pytest.mark.parametrize("case", ["f32", "f64", "all_padding"])
def test_masked_batchnorm_train_matches_jax(case):
    dtype = np.float64 if case == "f64" else np.float32
    x, mask, scale, bias, ct = _bn_case(dtype, all_padding=case ==
                                        "all_padding")
    rng = np.random.default_rng(4)
    rmean = rng.normal(0, 1, 6).astype(dtype)
    rvar = rng.uniform(0.5, 2, 6).astype(dtype)
    want_y, want_m, want_v, want_g = _jax_bn(x, mask, scale, bias, ct,
                                             rmean, rvar)
    tol = dict(rtol=1e-10, atol=1e-10) if case == "f64" else \
        dict(rtol=1e-5, atol=1e-5)
    bn = MaskedBatchNorm(6)
    if case == "f64":
        bn = bn.double()
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(rmean))
        bn.running_var.copy_(_t(rvar))
    xt = _t(x).requires_grad_()
    y = bn.train()(xt, _t(mask))
    (y * _t(ct)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, **tol)
    for a, b in zip((xt.grad, bn.weight.grad, bn.bias.grad), want_g):
        np.testing.assert_allclose(a.numpy(), b, **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_m, **tol)
    np.testing.assert_allclose(bn.running_var.numpy(), want_v, **tol)
    if case == "all_padding":  # the running stats stay as they were
        np.testing.assert_array_equal(bn.running_mean.numpy(), rmean)
        np.testing.assert_array_equal(bn.running_var.numpy(), rvar)


def test_one_pass_bn_high_mean_no_cancellation():
    """|mean| >> std (tests/test_ops.py:382's case): the shifted one-pass
    f32 moments keep the output unit-scale, as in the JAX package."""
    rng = np.random.default_rng(1)
    x = (1e4 + rng.normal(0.0, 1.0, size=(1024, 4))).astype(np.float32)
    mask = np.ones(1024, np.float32)
    mask[900:] = 0.0
    y = MaskedBatchNorm(4).train()(_t(x), _t(mask)).detach().numpy()
    rows = x[mask > 0].astype(np.float64)
    ref = (x.astype(np.float64) - rows.mean(0)) / np.sqrt(rows.var(0) + 1e-5)
    np.testing.assert_allclose(y[:900], ref[:900], atol=5e-2)
    assert float(np.abs(y).max()) < 10.0


# ---------------------------------------------------------------------------
# the whole-conv training op
# ---------------------------------------------------------------------------


def _conv_inputs(seed=0, f=16):
    graphs = _graphs()
    jb, tb = _batches(graphs)
    n = jb.nodes.shape[0]
    g = jb.edges.shape[-1]
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return jb, tb, dict(
        nodes=rng.standard_normal((n, f)).astype(f32),
        kernel=(rng.standard_normal((2 * f + g, 2 * f))
                / np.sqrt(2 * f + g)).astype(f32),
        bias=(0.1 * rng.standard_normal(2 * f)).astype(f32),
        scale=rng.uniform(0.5, 1.5, 2 * f).astype(f32),
        bn_bias=(0.2 * rng.standard_normal(2 * f)).astype(f32),
        ct=rng.standard_normal((n, f)).astype(f32),
    )


_DIFF = ("nodes", "kernel", "bias", "scale", "bn_bias")


def _jax_conv(jb, inp, **kw):
    n = jb.nodes.shape[0]
    tr = (jb.in_slots, jb.in_mask, jb.over_slots, jb.over_nodes,
          jb.over_mask)

    def loss(nodes, kernel, bias, scale, bn_bias):
        outs = jops.fused_cgconv(
            nodes, jnp.asarray(jb.edges), kernel, bias, scale, bn_bias,
            jnp.asarray(jb.neighbors),
            jnp.asarray(jb.edge_mask).reshape(n, M),
            tuple(jnp.asarray(a) for a in tr), **kw)
        return (outs[0] * inp["ct"]).sum(), outs

    (_, outs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                          has_aux=True)(
        *(jnp.asarray(inp[k]) for k in _DIFF))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _torch_conv(tb, inp, **kw):
    n = tb.nodes.shape[0]
    args = {k: _t(inp[k]).requires_grad_() for k in _DIFF}
    tr = (tb.in_slots, tb.in_mask, tb.over_slots, tb.over_nodes,
          tb.over_mask)
    outs = tops.fused_cgconv(
        args["nodes"], tb.edges, args["kernel"], args["bias"],
        args["scale"], args["bn_bias"], tb.neighbors,
        tb.edge_mask.reshape(n, M), tr, **kw)
    (outs[0] * _t(inp["ct"])).sum().backward()
    return ([o.detach().numpy() for o in outs],
            [args[k].grad.numpy() for k in _DIFF])


@pytest.mark.parametrize("port_impl", ["pallas", "xla"])
@pytest.mark.parametrize("jax_case", ["pallas", "pallas_window", "xla"])
def test_fused_cgconv_train_matches_jax(jax_case, port_impl):
    jb, tb, inp = _conv_inputs()
    if jax_case == "xla":
        want, want_g = _jax_conv(jb, inp, impl="xla")
    else:
        window = jops.window_width(6) if jax_case == "pallas_window" else 0
        with jops.interpret_mode():
            want, want_g = _jax_conv(jb, inp, impl="pallas", window=window)
    got, got_g = _torch_conv(tb, inp, impl=port_impl)
    np.testing.assert_allclose(got[0], want[0], **AGG_TOL)
    np.testing.assert_allclose(got[1], want[1], **STAT_TOL)
    np.testing.assert_allclose(got[2], want[2], **STAT_TOL)
    assert float(got[3]) == float(want[3])
    for a, b, name in zip(got_g, want_g, _DIFF):
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=name)


def test_fused_cgconv_kernel_path_counts_no_launch_on_cpu():
    """On CPU tensors 'pallas' runs the plain versions of kernels 1, 2, 4
    and 5: no kernel launch is counted, and the op's gradient equals the
    structured twin's autograd gradient."""
    from cgnn_tpu_torch.ops import fused_epilogue as tfe

    wrappers = (tops.fused_cgconv_eval_cuda, tops.fused_cgconv_stats_cuda,
                tfe.epilogue_reduce_cuda, tfe.epilogue_dz_cuda)
    before = [w.launches for w in wrappers]
    _, tb, inp = _conv_inputs(seed=3)
    got, got_g = _torch_conv(tb, inp, impl="pallas")
    want, want_g = _torch_conv(tb, inp, impl="xla")
    assert [w.launches for w in wrappers] == before
    np.testing.assert_allclose(got[0], want[0], **AGG_TOL)
    for a, b, name in zip(got_g, want_g, _DIFF):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5,
                                   err_msg=name)


def test_stats_wrapper_refuses_non_cuda_tensors():
    _, tb, inp = _conv_inputs()
    n = tb.nodes.shape[0]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.fused_cgconv_stats_cuda(
            _t(inp["nodes"]), tb.edges, _t(inp["kernel"]), _t(inp["bias"]),
            tb.neighbors, tb.edge_mask.reshape(n, M), _t(inp["bias"]))


# ---------------------------------------------------------------------------
# the model in train mode
# ---------------------------------------------------------------------------

SETTINGS = {
    "unfused": {},
    "cgconv_pallas": {"cgconv_impl": "pallas"},
    "cgconv_xla": {"cgconv_impl": "xla"},
    "epilogue_pallas": {"fused_epilogue": "pallas"},
    "epilogue_xla": {"fused_epilogue": "xla"},
}


def _jax_interpret(setting):
    if "cgconv_impl" in setting:
        return jops.interpret_mode()
    return pltpu.force_tpu_interpret_mode()


def _jax_variables(jnet, jb, seed=0, dtype=np.float32):
    with jops.interpret_mode():
        v = jax.tree_util.tree_map(np.asarray,
                                   jnet.init(jax.random.key(0), jb))
    v = jax.tree_util.tree_map(lambda a: np.array(a, dtype), v)
    rng = np.random.default_rng(seed)
    for conv in v["batch_stats"].values():
        for bn in conv.values():  # f32 values: the weight file holds f32
            bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(
                np.float32).astype(dtype)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(
                np.float32).astype(dtype)
    return v


def _port_model(setting, variables, dtype=torch.float32):
    cfg = ModelConfig(dense_m=M, **SMALL, **setting)
    dcfg = DataConfig(radius=5.0, max_num_nbr=M)
    net = build_model(cfg, dcfg, device="cpu").to(dtype)
    net.load_state_dict(convert.from_flax_variables(variables))
    return net.to(dtype)


def _flat(tree):
    return dict(convert.flatten(jax.tree_util.tree_map(np.asarray, tree)))


@pytest.mark.parametrize("name", list(SETTINGS))
def test_model_train_mode_matches_jax(name):
    setting = SETTINGS[name]
    jb, tb = _batches(_graphs())
    jnet = JNet(**SMALL, dense_m=M, **setting)
    variables = _jax_variables(jnet, jb)

    def loss(params):
        out, mut = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jb, train=True, mutable=["batch_stats"])
        return (out ** 2).sum(), mut["batch_stats"]

    with _jax_interpret(setting):
        (l_j, s_j), g_j = jax.value_and_grad(loss, has_aux=True)(
            variables["params"])
    net = _port_model(setting, variables).train()
    out = net(tb)
    l_t = (out ** 2).sum()
    l_t.backward()
    assert float(l_t.detach()) == pytest.approx(float(l_j), rel=1e-4)
    grads = _flat({"params": g_j})
    got = convert.to_flax_variables(
        {k: p.grad for k, p in net.named_parameters()})
    for path, a in _flat(got).items():
        np.testing.assert_allclose(a, grads[path], **GRAD_TOL,
                                   err_msg=path)
    stats = _flat({"batch_stats": s_j})
    got_s = _flat(convert.to_flax_variables(net.state_dict()))
    for path, b in stats.items():
        np.testing.assert_allclose(got_s[path], b, **STAT_TOL, err_msg=path)


# ---------------------------------------------------------------------------
# a 3-step trajectory against make_train_step + make_optimizer
# ---------------------------------------------------------------------------

K = 3
BN1_INVARIANT = ("fc_full/bias", "bn1/mean")


def _trajectory_batches():
    graphs = _graphs(30, seed=8)
    nc, ec = jgraph.capacities_for(graphs, 10, dense_m=M, snug=True)
    jb = list(jgraph.batch_iterator(graphs, 10, nc, ec, dense_m=M,
                                    snug=True, shuffle=True,
                                    rng=np.random.default_rng(1)))
    tb = list(tgraph.batch_iterator([_port(g) for g in graphs], 10, nc, ec,
                                    dense_m=M, snug=True, shuffle=True,
                                    rng=np.random.default_rng(1)))
    assert len(jb) >= K
    targets = np.stack([g.target for g in graphs])
    return jb[:K], tb[:K], targets


@pytest.mark.parametrize("optim", ["sgd", "adam"])
@pytest.mark.parametrize("name", ["unfused", "cgconv_pallas",
                                  "epilogue_pallas"])
def test_three_step_trajectory_matches_jax(name, optim):
    setting = SETTINGS[name]
    f64 = name == "unfused"
    np_dtype = np.float64 if f64 else np.float32
    jb, tb, targets = _trajectory_batches()
    opt_kw = (dict(lr=0.05, momentum=0.9, lr_milestones=[2])
              if optim == "sgd" else dict(lr=0.01, lr_milestones=[1]))
    jnet = JNet(**SMALL, dense_m=M, dtype=jnp.float64 if f64 else
                jnp.float32, **setting)
    variables = _jax_variables(jnet, jb[0], dtype=np_dtype)
    tx = jmake_optimizer(optim, **opt_kw)
    jnorm = JNormalizer.fit(targets)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), normalizer=jnorm,
        rng=jax.random.key(0), apply_fn=jnet.apply, tx=tx)
    jstep = jmake_train_step()
    want_loss = []
    with _jax_interpret(setting):
        for b in jb:
            jstate, m = jstep(jstate, b)
            want_loss.append(float(m["loss_sum"]) / float(m["count"]))

    net = _port_model(setting, variables,
                      torch.float64 if f64 else torch.float32)
    state = tstate.TrainState(
        net, tstate.make_optimizer(net.parameters(), optim, **opt_kw),
        Normalizer.fit(targets, device="cpu"))
    step = make_train_step()
    got_loss = []
    for b in tb:
        m = step(state, b)
        got_loss.append(float(m["loss_sum"]) / float(m["count"]))
    assert state.step == K
    rel, tol = (1e-9, dict(rtol=1e-7, atol=1e-9)) if f64 else \
        (1e-4, GRAD_TOL)
    assert got_loss == pytest.approx(want_loss, rel=rel)
    want = _flat(jstate.variables())
    got = _flat(convert.to_flax_variables(net.state_dict()))
    assert sorted(got) == sorted(want)
    for path, a in got.items():
        if optim == "adam" and path.endswith(BN1_INVARIANT):
            # BN1 makes the loss invariant to fc_full's bias, so its
            # gradient is f32 roundoff, which Adam's normalization turns
            # into steps of up to lr in either framework; the running
            # mean of bn1 carries that drift
            assert np.abs(a - want[path]).max() <= 2 * opt_kw["lr"] * K
            continue
        np.testing.assert_allclose(a, want[path], **tol, err_msg=path)


# ---------------------------------------------------------------------------
# loss, normalizer and optimizer pieces
# ---------------------------------------------------------------------------


def test_regression_loss_and_normalizer_match_jax():
    _, tb = _batches(_graphs())
    rng = np.random.default_rng(2)
    targets = rng.normal(-1.0, 2.0, size=(30, 2)).astype(np.float32)
    mask = (rng.random((30, 2)) > 0.2).astype(np.float32)
    jn = JNormalizer.fit(targets, mask)
    tn = Normalizer.fit(targets, mask, device="cpu")
    np.testing.assert_array_equal(tn.mean.numpy(), np.asarray(jn.mean))
    np.testing.assert_array_equal(tn.std.numpy(), np.asarray(jn.std))
    gcap = tb.graph_capacity
    out = rng.standard_normal((gcap, 2)).astype(np.float32)
    tgt = rng.normal(-1.0, 2.0, size=(gcap, 2)).astype(np.float32)

    class B:  # the fields regression_loss reads
        targets, target_mask = tgt, np.ones((gcap, 2), np.float32)
        graph_mask = tb.graph_mask.numpy()

    class TB:
        targets, target_mask = _t(tgt), torch.ones(gcap, 2)
        graph_mask = tb.graph_mask

    jl, jm = jregression_loss(jnp.asarray(out), B, jn)
    tl, tm = regression_loss(_t(out), TB, tn)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6), k
    ident = Normalizer.identity(3, device="cpu")
    assert ident.norm(torch.ones(3)).tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("optim", ["sgd", "sgd_decay", "adam", "adamw"])
def test_optimizer_updates_match_optax(optim):
    """Four updates of one parameter vector from fixed gradients, with a
    milestone at update 2, gradient clipping and weight decay where the
    JAX optimizer chain has them (f64: roundoff only)."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(7)
    grads = rng.standard_normal((4, 7)) * 3.0
    kind = optim.split("_")[0]
    kw = dict(lr=0.1, lr_milestones=[2], grad_clip=2.0,
              weight_decay=0.05 if optim in ("sgd_decay", "adamw") else 0.0)
    tx = jmake_optimizer(kind, **kw)
    p, opt_state = jnp.asarray(p0), None
    opt_state = tx.init(p)
    for g in grads:
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, p)
        p = p + upd
    tp = torch.nn.Parameter(_t(p0.copy()))
    opt = tstate.make_optimizer([tp], kind, **kw)
    for g in grads:
        tp.grad = _t(g.copy())
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(p),
                               rtol=1e-12, atol=1e-12)
    assert opt.schedule(1) == 0.1 and opt.schedule(2) == pytest.approx(0.01)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def test_train_entry_point_writes_weights_that_load_server_serves(tmp_path):
    out_dir = tmp_path / "run"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "cgnn_tpu_torch.train", "--device", "cpu",
         "--synthetic", "40", "--epochs", "1", "--out-dir", str(out_dir),
         "--ckpt-dir", str(tmp_path / "ckpt")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "** test mae:" in res.stdout
    meta = json.loads((out_dir / "meta.json").read_text())
    assert meta["model"]["dense_m"] == 12

    from cgnn_tpu_torch.data.dataset import load_synthetic as tload
    from cgnn_tpu_torch.serve.server import load_server

    graphs = tload(8, DataConfig().featurize_config(), seed=11)
    server, _ = load_server(str(out_dir / "params.npz"),
                            str(out_dir / "meta.json"), batch_size=8,
                            rungs=1, calibration=graphs, device="cpu",
                            log_fn=lambda *a: None)
    try:
        preds = [server.submit(g).result(timeout=60).prediction
                 for g in graphs]
    finally:
        assert server.drain(timeout_s=60)
    assert np.isfinite(np.stack(preds)).all()


def test_train_entry_point_defaults_to_cuda(monkeypatch):
    from cgnn_tpu_torch.train.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--synthetic", "4", "--epochs", "1"])
    assert main(["--synthetic", "4", "--cgconv-impl", "pallas",
                 "--fused-epilogue", "pallas"]) == 2
