"""The port's flat COO layout against the JAX package's, on the same numpy
inputs: COO packing, capacities, the batch iterator and the serving
ladder (bit-equal); ``aggregate_edge_messages`` for every impl against
``jax.ops.segment_sum`` and ``segment_sum_pallas`` (interpret mode), and
its gradient; MaskedBatchNorm on [E, 2F] edge rows; the COO
``CrystalGraphConvNet`` in eval and train mode with transplanted weights;
a 3-step SGD trajectory; the entry point's layout rules; and the trained
weight file served on a COO ladder.

Tolerances, with their reasons:

- aggregation rtol 1e-5 / atol 1e-5, the hub case atol 1e-4: f32 sums in
  another order (the JAX package's ``TestPallasSegmentSum``);
- BatchNorm rtol 1e-5 / atol 1e-5 in f32 (one normalization);
- the model: f64 through ``'xla'`` at roundoff (rtol 1e-9 / atol 1e-10
  on outputs and stats, 1e-8 / 1e-10 on grads); f32 through ``'pallas'``
  (the JAX kernel accumulates in f32, so it is compared in f32 only) at
  outputs rtol 1e-4 / atol 1e-5, param grads rtol 2e-3 / atol 1e-4,
  running stats rtol 1e-4 / atol 1e-5 (f32 roundoff through the convs and
  the BN backward, as tests/test_torch_train.py);
- the trajectory (f32, 'pallas'): losses rel 1e-4, parameters and
  running stats at the grad tolerance above.
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu.models import CrystalGraphConvNet as JNet
from cgnn_tpu.ops.norm import MaskedBatchNorm as JBN
from cgnn_tpu.ops.pallas_scatter import segment_sum_pallas
from cgnn_tpu.ops.segment import segment_sum as jsegment_sum
from cgnn_tpu.serve import shapes as jshapes
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.state import TrainState as JTrainState
from cgnn_tpu.train.state import make_optimizer as jmake_optimizer
from cgnn_tpu.train.step import make_train_step as jmake_train_step
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.ops import scatter
from cgnn_tpu_torch.ops.norm import MaskedBatchNorm
from cgnn_tpu_torch.ops.segment import aggregate_edge_messages, gather
from cgnn_tpu_torch.serve import shapes as tshapes
from cgnn_tpu_torch.train import state as tstate
from cgnn_tpu_torch.train.normalizer import Normalizer
from cgnn_tpu_torch.train.step import make_train_step
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

ROOT = Path(__file__).resolve().parents[1]
M = 8
SMALL = dict(atom_fea_len=16, n_conv=2, h_fea_len=24)
AGG_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=1e-4)
STAT_TOL = dict(rtol=1e-4, atol=1e-5)
GEOMETRY = ("positions", "lattice", "offsets", "numbers", "distances",
            "target_mask")


def _graphs(n=14, seed=2, geometry=False):
    return load_synthetic(n, FeaturizeConfig(radius=5.0, max_num_nbr=M),
                          seed=seed, max_atoms=6, keep_geometry=geometry)


def _port(g):
    return tgraph.CrystalGraph(
        g.atom_fea, g.edge_fea, g.centers, g.neighbors, g.target,
        cif_id=g.cif_id, **{k: getattr(g, k) for k in GEOMETRY})


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _assert_batches_equal(tb, jb):
    got = tb.numpy()
    for name, a in got.items():
        if name in tgraph.PORT_FIELDS:  # held by the transpose test
            continue
        want = getattr(jb, name)
        if a is None:
            assert want is None, name
            continue
        want = np.asarray(want)
        assert a.dtype == want.dtype and a.shape == want.shape, name
        np.testing.assert_array_equal(a, want, err_msg=name)


def _pack_both(graphs, extra_nodes=16, extra_edges=40, extra_graphs=2):
    nc, ec = jgraph.capacities_for(graphs, len(graphs), snug=True)
    caps = (nc + extra_nodes, ec + extra_edges, len(graphs) + extra_graphs)
    jb = jgraph.pack_graphs(graphs, *caps)
    tb = tgraph.pack_graphs([_port(g) for g in graphs], *caps)
    return jb, tb


# ---------------------------------------------------------------------------
# packing, capacities, the iterator and the serving ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["geometry", "plain", "unsorted"])
def test_coo_pack_matches_jax(case):
    graphs = _graphs(geometry=case != "plain")
    if case == "unsorted":  # edges of one graph out of center order
        g = graphs[3]
        perm = np.random.default_rng(0).permutation(g.num_edges)
        for k in ("edge_fea", "centers", "neighbors", "offsets",
                  "distances"):
            setattr(g, k, getattr(g, k)[perm])
    jb, tb = _pack_both(graphs)
    _assert_batches_equal(tb, jb)
    n_cap, e_real = tb.nodes.shape[0], sum(g.num_edges for g in graphs)
    assert tb.edges.dim() == 2
    assert (tb.centers[e_real:] == n_cap - 1).all()
    assert (tb.neighbors[e_real:] == n_cap - 1).all()
    assert (tb.edge_mask[e_real:] == 0).all() and (tb.edge_mask[:e_real]
                                                    == 1).all()
    assert (tb.centers[1:] >= tb.centers[:-1]).all()


def test_coo_pack_refuses_what_jax_refuses():
    graphs = [_port(g) for g in _graphs()]
    n = sum(g.num_nodes for g in graphs)
    e = sum(g.num_edges for g in graphs)
    with pytest.raises(ValueError, match="exceeds capacity"):
        tgraph.pack_graphs(graphs, n + 8, e - 1, len(graphs))
    with pytest.raises(ValueError, match="dense layout"):
        tgraph.pack_graphs(graphs, n + 8, e, len(graphs), over_cap=64)


def test_coo_capacities_and_batch_iterator_match_jax():
    graphs = _graphs(40, seed=5)
    caps = jgraph.capacities_for(graphs, 12, snug=True)
    assert tgraph.capacities_for([_port(g) for g in graphs], 12) == caps
    # a node budget wide enough that the edge budget closes batches too
    nc, ec = caps[0] * 2, caps[1]
    kw = dict(shuffle=True, snug=True)
    jb = list(jgraph.batch_iterator(graphs, 12, nc, ec,
                                    rng=np.random.default_rng(3), **kw))
    tb = list(tgraph.batch_iterator([_port(g) for g in graphs], 12, nc, ec,
                                    rng=np.random.default_rng(3), **kw))
    assert len(tb) == len(jb) == tgraph.count_batches(
        graphs, 12, nc, ec, snug=True) >= 4
    for a, b in zip(tb, jb):
        _assert_batches_equal(a, b)
    order = np.random.default_rng(3).permutation(len(graphs))
    first = int(tb[0].graph_mask.sum())
    edges = sum(graphs[i].num_edges for i in order[:first + 1])
    nodes = sum(graphs[i].num_nodes for i in order[:first + 1])
    assert edges > ec and nodes <= nc  # the edge budget closed batch 0


def test_coo_training_batches_carry_the_transpose():
    """A COO training batch (``batch_iterator`` without ``in_cap=0``)
    carries its gathers' transpose: the edge slots in stable neighbor
    order and each node's first position in it and in the centers, as
    the CSR lists of ``np.argsort`` and ``np.searchsorted``; an eval batch
    (``in_cap=0``) and a plain pack carry none, and the dense layout
    refuses it."""
    graphs = [_port(g) for g in _graphs(40, seed=5)]
    nc, ec = tgraph.capacities_for(graphs, 12)
    train = list(tgraph.batch_iterator(graphs, 12, nc, ec, snug=True))
    rows = np.arange(nc + 1)
    for b in train:
        nbr, cen = b.neighbors.numpy(), b.centers.numpy()
        order = np.argsort(nbr, kind="stable")
        assert b.nbr_order.dtype == b.nbr_offsets.dtype == \
            b.center_offsets.dtype == torch.int32
        np.testing.assert_array_equal(b.nbr_order.numpy(), order)
        np.testing.assert_array_equal(b.nbr_offsets.numpy(),
                                      np.searchsorted(nbr[order], rows))
        np.testing.assert_array_equal(b.center_offsets.numpy(),
                                      np.searchsorted(cen, rows))
    evals = list(tgraph.batch_iterator(graphs, 12, nc, ec, snug=True,
                                       in_cap=0))
    assert len(evals) == len(train) >= 2
    plain = tgraph.pack_graphs(graphs[:4], nc, ec, 12)
    for b in (*evals, plain):
        assert b.nbr_order is b.nbr_offsets is b.center_offsets is None
    with pytest.raises(ValueError, match="COO layout"):
        tgraph.pack_graphs(graphs[:4], nc, nc * M, 12, dense_m=M,
                           coo_transpose=True)


def test_coo_plan_shape_set_matches_jax():
    graphs = _graphs(40, seed=6)
    js = jshapes.plan_shape_set(graphs, 16, rungs=3)
    ts = tshapes.plan_shape_set([_port(g) for g in graphs], 16, rungs=3)
    assert [tuple(vars(s).values()) for s in ts] == [
        (s.graph_cap, s.node_cap, s.edge_cap) for s in js]
    assert ts.dense_m is None and ts.raw is None
    g = _port(graphs[0])
    assert ts.graph_counts(g) == js.graph_counts(graphs[0]) == (
        g.num_nodes, g.num_edges)
    # the rung follows the true edges: a flush picks the same rung
    rungs = set()
    for k in (1, 3, 6, 12):
        jb = js.pack_full(graphs[:k])
        tb = ts.pack_full([_port(x) for x in graphs[:k]])
        _assert_batches_equal(tb, jb)
        rungs.add(tb.edges.shape[0])
    assert len(rungs) >= 2
    with pytest.raises(ValueError, match="dense layout"):
        tshapes.ShapeSet(list(ts), dense_m=None,
                         raw=types.SimpleNamespace(dense_m=M))


# ---------------------------------------------------------------------------
# aggregation and its gradient
# ---------------------------------------------------------------------------


def _agg_case(e, n, f, seed):
    rng = np.random.default_rng(seed)
    msgs = rng.normal(size=(e, f)).astype(np.float32)
    centers = np.sort(rng.integers(0, n, size=e)).astype(np.int32)
    return msgs, centers


def _hub_case():
    """Empty nodes, one hub with more edges than a chunk, a tail node."""
    rng = np.random.default_rng(1)
    n = 260
    centers = np.sort(np.concatenate([
        np.full(700, 5), rng.integers(100, 120, 50), np.full(30, n - 1),
    ])).astype(np.int32)
    msgs = rng.normal(size=(len(centers), 8)).astype(np.float32)
    return msgs, centers, n


def _tail_hub_case():
    """A packed COO batch's skew: 520 padding edges on node N-1 (zero
    messages, as CGConv's mask leaves them) and a real hub of 150 edges at
    node 120, beside short ranges and empty nodes."""
    rng = np.random.default_rng(3)
    n = 300
    centers = np.sort(np.concatenate([
        rng.integers(0, n - 1, 1500), np.full(150, 120), np.full(520, n - 1),
    ])).astype(np.int32)
    msgs = rng.normal(size=(len(centers), 64)).astype(np.float32)
    msgs[-520:] = 0.0
    return msgs, centers, n


CASES = {"64x16x8": (64, 16, 8), "1000x300x32": (1000, 300, 32),
         "2048x513x16": (2048, 513, 16), "hub": None, "tail_and_hub": None}


@functools.lru_cache(maxsize=None)
def _jax_aggregates(case):
    if case in ("hub", "tail_and_hub"):
        msgs, centers, n = _hub_case() if case == "hub" else _tail_hub_case()
    else:
        e, n, f = CASES[case]
        msgs, centers = _agg_case(e, n, f, seed=e)
    xla = np.asarray(jsegment_sum(jnp.asarray(msgs), jnp.asarray(centers),
                                  n))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(segment_sum_pallas(jnp.asarray(msgs),
                                               jnp.asarray(centers), n))
    return msgs, centers, n, xla, pallas


@pytest.mark.parametrize("impl", ["xla", "sort", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_aggregate_matches_jax(case, impl):
    msgs, centers, n, xla, pallas = _jax_aggregates(case)
    before = scatter.segment_sum_sorted_cuda.launches
    got = aggregate_edge_messages(_t(msgs), _t(centers), n,
                                  impl=impl).numpy()
    assert scatter.segment_sum_sorted_cuda.launches == before  # CPU: plain
    tol = dict(rtol=1e-5, atol=1e-4) if "hub" in case else AGG_TOL
    assert got.shape == xla.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, xla, **tol)
    np.testing.assert_allclose(got, pallas, **tol)
    empty = np.setdiff1d(np.arange(n), centers)
    assert (got[empty] == 0).all()


def test_segment_sum_plain_version_on_a_tail_and_a_hub():
    """Kernel 6's plain version on the offsets the wrapper passes it, where
    node N-1 holds 520 padding edges and node 120 a real hub of 150: equal
    to the JAX ``segment_sum_pallas`` (interpret mode) at the hub case's
    tolerance."""
    msgs, centers, n, _, pallas = _jax_aggregates("tail_and_hub")
    offsets = scatter.segment_offsets(_t(centers), n)
    spans = np.diff(offsets.numpy())
    assert spans[-1] >= 500 and spans[120] >= 150
    got = scatter.segment_sum_sorted_reference(_t(msgs), offsets).numpy()
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-4)
    assert (got[-1] == 0).all()


def test_aggregate_gradient_is_gather():
    msgs, centers = _agg_case(200, 40, 8, seed=0)
    c = jnp.asarray(centers)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.grad(
            lambda m: jnp.sum(segment_sum_pallas(m, c, 40) ** 2))(
            jnp.asarray(msgs)))
    x = _t(msgs).requires_grad_()
    out = scatter.segment_sum_sorted(x, _t(centers), 40, impl="pallas")
    (out ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, **AGG_TOL)
    np.testing.assert_array_equal(
        x.grad.numpy(), gather(2 * out.detach(), _t(centers)).numpy())
    assert aggregate_edge_messages(_t(msgs), _t(centers), 40,
                                   impl=None).shape == (40, 8)
    with pytest.raises(ValueError, match="aggregation impl"):
        aggregate_edge_messages(_t(msgs), _t(centers), 40, impl="atomic")


def test_segment_sum_kernel_wrapper_refuses_cpu_tensors():
    msgs, centers = _agg_case(64, 16, 8, seed=1)
    offsets = scatter.segment_offsets(_t(centers), 16)
    assert offsets.dtype == torch.int32 and offsets.shape == (17,)
    with pytest.raises(ValueError, match="CUDA"):
        scatter.segment_sum_sorted_cuda(_t(msgs), offsets)


# ---------------------------------------------------------------------------
# MaskedBatchNorm on [E, 2F] edge rows
# ---------------------------------------------------------------------------


def test_masked_batchnorm_on_edge_rows_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(3.0, 1.3, size=(57, 6)).astype(np.float32)
    mask = np.ones(57, np.float32)
    mask[49:] = 0.0  # COO padding edges last
    scale = rng.normal(1.0, 0.1, 6).astype(np.float32)
    bias = rng.normal(0.0, 0.1, 6).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    rmean = rng.normal(0, 1, 6).astype(np.float32)
    rvar = rng.uniform(0.5, 2, 6).astype(np.float32)

    def loss(x, scale, bias):
        y, mut = JBN().apply(
            {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": rmean, "var": rvar}},
            x, mask=mask, use_running_average=False, mutable=["batch_stats"])
        return (y * ct).sum(), (y, mut["batch_stats"])

    (_, (want_y, stats)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    bn = MaskedBatchNorm(6)
    with torch.no_grad():
        for p, v in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, rmean), (bn.running_var, rvar)):
            p.copy_(_t(v))
    xt = _t(x).requires_grad_()
    y = bn.train()(xt, _t(mask))
    (y * _t(ct)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **tol)
    for a, b in zip((xt.grad, bn.weight.grad, bn.bias.grad), grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), **tol)
    # n_real counts the real edges: the unbiased update uses 49, not 57
    real = x[:49].astype(np.float64)
    want_var = 0.9 * rvar + 0.1 * real.var(0) * 49 / 48
    np.testing.assert_allclose(bn.running_var.numpy(), want_var, rtol=1e-4)


# ---------------------------------------------------------------------------
# the COO model, eval and train mode
# ---------------------------------------------------------------------------

IMPLS = {"xla_f64": ("xla", np.float64), "pallas_f32": ("pallas",
                                                          np.float32)}


def _variables(seed=0, dtype=np.float32):
    """convert.init_params for a COO model, with non-trivial running
    statistics so BatchNorm does real work in eval."""
    cfg = ModelConfig(**SMALL, dense_m=0, aggregation="pallas")
    v = convert.init_params(cfg, DataConfig(radius=5.0, max_num_nbr=M),
                            seed=seed)
    rng = np.random.default_rng(seed + 1)
    for conv in v["batch_stats"].values():
        for bn in conv.values():
            bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(
                np.float32)
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype), v)


def _port_model(impl, variables, dtype):
    cfg = ModelConfig(**SMALL, dense_m=0, aggregation=impl)
    net = build_model(cfg, DataConfig(radius=5.0, max_num_nbr=M),
                      device="cpu")
    net.load_state_dict(convert.from_flax_variables(variables))
    return net.to(dtype)


def _by_port_name(tree) -> dict:
    """A JAX variables tree as {port state_dict key: array}, keeping the
    dtype (convert's maps write f32, the weight file's type)."""
    out = {}
    for path, a in convert.flatten(
            jax.tree_util.tree_map(np.asarray, tree)).items():
        coll, *mods, leaf = path.split("/")
        mod = ".".join(mods)
        if leaf == "kernel":
            out[f"{mod}.kernel" if mods[-1] == "fc_full"
                else f"{mod}.weight"] = a if mods[-1] == "fc_full" else a.T
        elif leaf == "scale":
            out[f"{mod}.weight"] = a
        elif coll == "batch_stats":
            out[f"{mod}.running_{leaf}"] = a
        else:
            out[f"{mod}.{leaf}"] = a
    return out


def _assert_tree_close(got: dict, want: dict, tol):
    """{port key: tensor} against ``_by_port_name`` of a JAX tree."""
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        a = t.detach().numpy()
        assert a.dtype == want[key].dtype, key
        np.testing.assert_allclose(a, want[key], **tol, err_msg=key)


def _cast_batch(jb, dtype):
    return jb.replace(nodes=jb.nodes.astype(dtype),
                      edges=jb.edges.astype(dtype))


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", list(IMPLS))
def test_coo_model_matches_jax(name, mode):
    impl, np_dtype = IMPLS[name]
    f64 = np_dtype == np.float64
    jb, tb = _pack_both(_graphs())
    variables = _variables(dtype=np_dtype)
    jnet = JNet(**SMALL, aggregation_impl=impl,
                dtype=jnp.float64 if f64 else jnp.float32)
    net = _port_model(impl, variables,
                      torch.float64 if f64 else torch.float32)
    if f64:
        tb = tgraph.GraphBatch(**{**tb.__dict__,
                                  "nodes": tb.nodes.double(),
                                  "edges": tb.edges.double()})
        jb = _cast_batch(jb, np.float64)
    out_tol = dict(rtol=1e-9, atol=1e-10) if f64 else TOL
    if mode == "eval":
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax.jit(
                lambda v, b: jnet.apply(v, b, train=False))(variables, jb))
        with torch.no_grad():
            got = net.eval()(tb).numpy()
        assert np.abs(got).max() > 0
        np.testing.assert_allclose(got, want, **out_tol)
        return

    def loss(params):
        out, mut = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jb, train=True, mutable=["batch_stats"])
        return (out ** 2).sum(), mut["batch_stats"]

    with pltpu.force_tpu_interpret_mode():
        (l_j, s_j), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
    out = net.train()(tb)
    l_t = (out ** 2).sum()
    l_t.backward()
    assert float(l_t.detach()) == pytest.approx(
        float(l_j), rel=1e-9 if f64 else 1e-4)
    grad_tol = dict(rtol=1e-8, atol=1e-10) if f64 else GRAD_TOL
    _assert_tree_close({k: p.grad for k, p in net.named_parameters()},
                       _by_port_name({"params": g_j}), grad_tol)
    stat_tol = dict(rtol=1e-9, atol=1e-10) if f64 else STAT_TOL
    _assert_tree_close({k: v for k, v in net.state_dict().items()
                        if "running" in k},
                       _by_port_name({"batch_stats": s_j}), stat_tol)


def test_coo_model_refuses_dense_only_settings():
    for kw in ({"cgconv_impl": "pallas"}, {"fused_epilogue": "xla"}):
        cfg = ModelConfig(**SMALL, dense_m=0, aggregation="pallas", **kw)
        with pytest.raises(NotImplementedError, match="dense layout"):
            cfg.build(nbr_fea_len=26, device="cpu")
        jb, _ = _pack_both(_graphs(4))
        jkw = {k: v for k, v in kw.items()}
        with pytest.raises(NotImplementedError):
            JNet(**SMALL, aggregation_impl="pallas", **jkw).init(
                jax.random.key(0), jb)
    with pytest.raises(ValueError, match="aggregation_impl"):
        ModelConfig(**SMALL, dense_m=0, aggregation="scan").build(
            nbr_fea_len=26, device="cpu")


def test_coo_meta_round_trip_keeps_the_aggregation():
    cfg = ModelConfig(dense_m=0, aggregation="pallas")
    meta = json.loads(json.dumps(cfg.to_meta()))
    back = ModelConfig.from_meta(meta)
    assert back == cfg and back.dense_m == 0
    net = back.build(nbr_fea_len=41, device="cpu")
    assert all(getattr(net, f"conv_{i}").dense_m is None
               and getattr(net, f"conv_{i}").aggregation_impl == "pallas"
               for i in range(cfg.n_conv))
    none = ModelConfig.from_meta(ModelConfig(dense_m=0).to_meta())
    assert none.to_meta()["aggregation"] == "__none__"
    assert none.aggregation is None


# ---------------------------------------------------------------------------
# a 3-step trajectory, init_train_state, the entry point
# ---------------------------------------------------------------------------

K = 3


def test_coo_three_step_trajectory_matches_jax():
    """The main path's setting: f32 through 'pallas' (the f64 'xla' grads
    are held in ``test_coo_model_matches_jax``)."""
    impl, np_dtype = IMPLS["pallas_f32"]
    graphs = _graphs(30, seed=8)
    nc, ec = jgraph.capacities_for(graphs, 10, snug=True)
    kw = dict(snug=True, shuffle=True)
    jb = list(jgraph.batch_iterator(graphs, 10, nc, ec,
                                    rng=np.random.default_rng(1), **kw))[:K]
    tb = list(tgraph.batch_iterator([_port(g) for g in graphs], 10, nc, ec,
                                    rng=np.random.default_rng(1), **kw))[:K]
    assert len(jb) == len(tb) == K
    targets = np.stack([g.target for g in graphs])
    opt_kw = dict(lr=0.05, momentum=0.9, lr_milestones=[2])
    variables = _variables(dtype=np_dtype)
    jnet = JNet(**SMALL, aggregation_impl=impl, dtype=jnp.float32)
    tx = jmake_optimizer("sgd", **opt_kw)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        normalizer=JNormalizer.fit(targets), rng=jax.random.key(0),
        apply_fn=jnet.apply, tx=tx)
    jstep = jax.jit(jmake_train_step())
    want_loss = []
    with pltpu.force_tpu_interpret_mode():
        for b in jb:
            jstate, m = jstep(jstate, b)
            want_loss.append(float(m["loss_sum"]) / float(m["count"]))
    net = _port_model(impl, variables, torch.float32)
    state = tstate.TrainState(
        net, tstate.make_optimizer(net.parameters(), "sgd", **opt_kw),
        Normalizer.fit(targets, device="cpu"))
    step = make_train_step()
    got_loss = [float(m["loss_sum"]) / float(m["count"])
                for m in (step(state, b) for b in tb)]
    assert got_loss == pytest.approx(want_loss, rel=1e-4)
    _assert_tree_close(net.state_dict(), _by_port_name(jstate.variables()),
                       GRAD_TOL)


def test_init_train_state_coo_caps_match_jax():
    """dense_m=0 is the COO layout, not a dense layout with M = 0: the
    edge capacity is the snug one, never node_cap * 0."""
    graphs = _graphs(30, seed=8)
    cfg = ModelConfig(**SMALL, dense_m=0, aggregation="pallas")
    _, node_cap, edge_cap = tstate.init_train_state(
        cfg, DataConfig(radius=5.0, max_num_nbr=M),
        [_port(g) for g in graphs], batch_size=10, device="cpu")
    assert (node_cap, edge_cap) == jgraph.capacities_for(graphs, 10,
                                                         snug=True)
    assert edge_cap >= max(g.num_edges for g in graphs) > 0


def _jax_train_main():
    spec = importlib.util.spec_from_file_location("_jax_train",
                                                  ROOT / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("flags", [
    ["--layout", "dense", "--aggregation", "pallas"],
    ["--aggregation", "sort", "--fused-epilogue", "xla"],
    ["--layout", "coo", "--cgconv-impl", "pallas"],
])
def test_train_cli_layout_rules_match_jax(flags, tmp_path, capsys):
    from cgnn_tpu_torch.train.__main__ import main

    argv = ["--synthetic", "6", "--epochs", "1", "--device", "cpu", *flags]
    want = _jax_train_main()([*argv, "--ckpt-dir", str(tmp_path)])
    assert want == 2
    assert main([*argv, "--out-dir", str(tmp_path / "port")]) == want


@pytest.mark.parametrize("flags,dense_m,aggregation", [
    ([], 12, None),
    (["--aggregation", "pallas"], 0, "pallas"),
    (["--layout", "coo"], 0, None),
    (["--layout", "dense", "--cgconv-impl", "pallas"], 12, None),
])
def test_train_cli_layouts(flags, dense_m, aggregation):
    from cgnn_tpu_torch.train.__main__ import build_parser, resolve_layout

    args = build_parser().parse_args(["--synthetic", "4", *flags])
    assert resolve_layout(args) == dense_m
    assert args.aggregation == aggregation


def test_train_entry_point_coo_weights_serve_on_a_coo_ladder(tmp_path):
    out_dir = tmp_path / "run"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "cgnn_tpu_torch.train", "--device", "cpu",
         "--aggregation", "pallas", "--synthetic", "40", "--epochs", "1",
         "--out-dir", str(out_dir)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "** test mae:" in res.stdout
    meta = json.loads((out_dir / "meta.json").read_text())
    assert meta["model"]["dense_m"] == 0
    assert meta["model"]["aggregation"] == "pallas"

    from cgnn_tpu_torch.data.dataset import load_synthetic as tload
    from cgnn_tpu_torch.data.rawbatch import RawStructure, raw_from_graph
    from cgnn_tpu_torch.serve.batcher import ServeRejection
    from cgnn_tpu_torch.serve.server import load_server

    graphs = tload(8, DataConfig().featurize_config(), seed=11,
                   keep_geometry=True)
    logs = []
    server, info = load_server(str(out_dir / "params.npz"),
                               str(out_dir / "meta.json"), batch_size=8,
                               rungs=2, calibration=graphs, device="cpu",
                               wire="raw", log_fn=logs.append)
    try:
        ss = server.shape_set
        assert ss.dense_m is None and ss.raw is None
        assert any("raw wire requires the dense layout; featurized wire "
                   "only" in line for line in logs)
        assert [s.edge_cap for s in ss] != [s.node_cap * 12 for s in ss]
        raw = raw_from_graph(graphs[2])
        futs = [server.submit(g) for g in graphs] + [server.submit(raw)]
        res = [f.result(timeout=60) for f in futs]
        with pytest.raises(ServeRejection) as err:  # a bad lattice alone
            server.submit(RawStructure(np.zeros((1, 3)), np.zeros((3, 3)),
                                       np.array([6], np.int32)))
        assert err.value.http_status == 400

        def fails(rs):
            raise ValueError("no neighbors within the radius")

        server.featurizer = fails  # a featurization failure rejects alone
        with pytest.raises(ServeRejection, match="featurization failed"):
            server.submit(raw)
        assert server.counts["reject_malformed"] == 2
    finally:
        assert server.drain(timeout_s=60)
    preds = np.stack([r.prediction for r in res])
    assert np.isfinite(preds).all()
    assert all(r.wire == "featurized" for r in res)
    # the structure featurized at admission answers as its graph does
    np.testing.assert_allclose(preds[-1], preds[2], rtol=1e-4, atol=1e-4)
    assert server.counts["responses"] == 9
