"""bf16 compute in the port against the JAX package's bf16, on the same
numpy inputs rounded to bf16 the same way (torch's ``.to(bfloat16)`` and
``astype(bfloat16)`` both round to nearest even).

- Kernels 1 and 2: the plain versions of their bf16 instances (the f32
  plain versions on the widened inputs) against the JAX Pallas kernels
  run in interpret mode on bf16 nodes and edges, which widen them to f32
  too: rtol 1e-4 / atol 1e-5, the stats row-scaled (the f32 contract:
  sums over slots in another order).
- Kernel 4's plain version against ``_reduce_kernel`` on bf16 z: rtol
  5e-4 of each row's largest entry (f32 column sums, the f32 kernel's
  tolerance); kernel 5's against ``_dz_kernel`` on the same reduction:
  dz in bf16, equal or one bf16 ulp apart (f32 roundoff before the
  rounding to bf16).
- Staging: bf16 edges packed by ``pack_graphs`` bit-equal to JAX's; the
  compact expander's bf16 edges bit-equal to the bf16 rounding of its f32
  ones, and within one bf16 ulp of the JAX expander's, or 2e-6 where the
  features are tiny (the two f32 expansions already differ within 2e-6:
  JAX multiplies by 1/var^2, the port divides), equal in over 99% of
  entries; the raw expander's likewise the rounding of its f32 ones.
- The whole bf16 model, eval and train mode, and one SGD step, for the
  unfused path and ``cgconv_impl='pallas'`` (the JAX kernel in interpret
  mode): within 2e-2 of the reference's largest |entry| (bf16 matmuls
  round at other places in the two frameworks). The largest gap met is
  recorded in the assertion messages and in CHANGES.md.
- The repairs: kernel 6's fixed-order backward raises for a non-f32
  cotangent on the card (a ``meta`` tensor stands in for the card: the
  dispatch takes the kernel route for any tensor not on the CPU), and the
  training forward hands the bf16 nodes and edges themselves, no f32
  copy, to the bf16 instances of kernels 1 and 2, then the backward runs
  the bf16 instances of kernels 4 and 5 (stand-in instances that run the
  plain versions and record what they were given).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cgnn_tpu.data import compact as jcompact
from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.data.dataset import load_synthetic
from cgnn_tpu.models import CrystalGraphConvNet as JNet
from cgnn_tpu.ops import fused_epilogue as jfe
from cgnn_tpu.ops import pallas_cgconv as jops
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.state import TrainState as JTrainState
from cgnn_tpu.train.state import make_optimizer as jmake_optimizer
from cgnn_tpu.train.step import make_train_step as jmake_train_step
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
from cgnn_tpu_torch.data import compact as tcompact
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.ops import fused_cgconv as tops
from cgnn_tpu_torch.ops import fused_epilogue as tfe
from cgnn_tpu_torch.train import state as tstate
from cgnn_tpu_torch.train.normalizer import Normalizer
from cgnn_tpu_torch.train.step import make_train_step
from test_torch_cgconv import _ORDER, _inputs
from test_torch_predict import CFG
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

F, M = 16, 8
SMALL = dict(atom_fea_len=F, n_conv=2, h_fea_len=24)
TOL = dict(rtol=1e-4, atol=1e-5)
STATS_RTOL = 1e-4
REDUCE_RTOL = 5e-4
MODEL_TOL = 2e-2  # of the reference's largest |entry|
BF16 = torch.bfloat16
BF16_EPS = 2.0 ** -7  # bf16's spacing at 1 (8 significant bits)
EDGE_ATOL = 2e-6  # the f32 expansions' bound (tests/test_torch_compact.py)


def _bf16_inputs(seed=0):
    """test_torch_cgconv's conv inputs with nodes and edges rounded to
    bf16: (numpy f32 dict with the rounded values, JAX bf16 dict, torch
    dict with bf16 nodes and edges)."""
    inp = _inputs(seed)
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    for k in ("nodes", "edges"):
        j[k] = j[k].astype(jnp.bfloat16)
        t[k] = t[k].to(BF16)
        np.testing.assert_array_equal(
            np.asarray(j[k].astype(jnp.float32)), t[k].float().numpy())
    return inp, j, t


def _ulp_bf16(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (the spacing of its binade)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e) * BF16_EPS


# ---------------------------------------------------------------------------
# kernels 1 and 2
# ---------------------------------------------------------------------------


def test_kernel1_bf16_plain_matches_jax_pallas():
    _, j, t = _bf16_inputs(seed=0)
    with jops.interpret_mode():
        want = np.asarray(jops.fused_cgconv_eval(
            *(j[k] for k in _ORDER), impl="pallas"))
    # the bf16 instance's plain version: the f32 pass on widened inputs
    got = tops.fused_cgconv_eval_reference(*(t[k] for k in _ORDER)).numpy()
    # ... which is what the op runs for 'pallas' on CPU tensors
    op = tops.fused_cgconv_eval(*(t[k] for k in _ORDER), impl="pallas")
    np.testing.assert_array_equal(op.numpy(), got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("form", ["whole", "factored"])
def test_kernel2_bf16_plain_matches_jax_pallas(form):
    inp, j, t = _bf16_inputs(seed=4)
    shift = inp["mean"]
    with jops.interpret_mode():
        want = np.asarray(jops._pallas_stats(
            j["nodes"], j["edges"], j["kernel"], j["bias"], j["neighbors"],
            j["edge_mask"], jnp.asarray(shift), 0))
    if form == "whole":
        got = tops.fused_cgconv_stats_reference(
            t["nodes"], t["edges"], t["kernel"], t["bias"], t["neighbors"],
            t["edge_mask"], torch.from_numpy(shift))
    else:
        p = tops.node_projections_reference(t["nodes"], t["kernel"],
                                            t["bias"])
        got = tops.stats_from_projections_reference(
            p, t["edges"], t["kernel"], t["neighbors"], t["edge_mask"],
            torch.from_numpy(shift))
    got = got.numpy()
    assert got.shape == want.shape == (2, 2 * F)
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= STATS_RTOL * scale).all()


# ---------------------------------------------------------------------------
# kernels 4 and 5
# ---------------------------------------------------------------------------


def _epilogue_case(seed=0, n=67, m=12, f=32):
    rng = np.random.default_rng(seed)
    z = rng.normal(0.5, 1.5, size=(n, m, 2 * f)).astype(np.float32)
    mask = np.zeros((n, m), np.float32)
    for i in range(n - 7):
        mask[i, : rng.integers(3, m + 1)] = 1.0
    zb = torch.from_numpy(z).to(BF16)
    real = mask > 0
    zf = zb.float().numpy()
    mean = np.asarray([zf[..., c][real].mean() for c in range(2 * f)],
                      np.float32)
    var = np.asarray([zf[..., c][real].var() for c in range(2 * f)],
                     np.float32)
    cst = np.stack([mean, 1.0 / np.sqrt(var + 1e-5),
                    rng.normal(1.0, 0.1, 2 * f),
                    rng.normal(0.0, 0.1, 2 * f)]).astype(np.float32)
    ct = rng.standard_normal((n, f)).astype(np.float32)
    return zb, mask, cst, ct, float(real.sum())


def _jax_pass(kernel_fn, z, mask, cst, ct, red5=None):
    """One of the JAX epilogue's Pallas kernels alone, in interpret mode,
    with the JAX package's grid and blocks (``_pallas_bwd``)."""
    n, m, c2 = z.shape
    bn = min(jfe._BLOCK_N, n)
    vmem = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    z_spec = vmem((bn, m, c2), lambda i: (i, 0, 0))
    specs = [z_spec, vmem((bn, m), lambda i: (i, 0)), vmem()]
    args = [z, jnp.asarray(mask), jnp.asarray(cst)]
    if red5 is not None:
        specs.append(vmem())
        args.append(jnp.asarray(red5))
    specs.append(vmem((bn, c2 // 2), lambda i: (i, 0)))
    args.append(jnp.asarray(ct))
    if red5 is None:
        out_spec = vmem((4, c2), lambda i: (0, 0))
        out_shape = jax.ShapeDtypeStruct((4, c2), jnp.float32)
    else:
        out_spec = z_spec
        out_shape = jax.ShapeDtypeStruct((n, m, c2), z.dtype)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(
            functools.partial(kernel_fn, n=n), grid=(pl.cdiv(n, bn),),
            in_specs=specs, out_specs=out_spec, out_shape=out_shape,
        )(*args).astype(jnp.float32))


def test_kernel4_bf16_plain_matches_jax_reduce_kernel():
    zb, mask, cst, ct, _ = _epilogue_case(seed=1)
    jz = jnp.asarray(zb.float().numpy()).astype(jnp.bfloat16)
    want = _jax_pass(jfe._reduce_kernel, jz, mask, cst, ct)
    got = tfe.epilogue_reduce_reference(
        zb, torch.from_numpy(mask), torch.from_numpy(cst),
        torch.from_numpy(ct)).numpy()
    assert got.shape == want.shape == (4, zb.shape[-1])
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= REDUCE_RTOL * scale).all()


def test_kernel5_bf16_plain_matches_jax_dz_kernel():
    zb, mask, cst, ct, n_real = _epilogue_case(seed=2)
    red = tfe.epilogue_reduce_reference(
        zb, torch.from_numpy(mask), torch.from_numpy(cst),
        torch.from_numpy(ct))
    red5 = torch.cat([red, torch.full((1, red.shape[1]), 1.0 / n_real)])
    jz = jnp.asarray(zb.float().numpy()).astype(jnp.bfloat16)
    want = _jax_pass(jfe._dz_kernel, jz, mask, cst, ct,
                     red5=red5.numpy())
    got = tfe.epilogue_dz_reference(
        zb, torch.from_numpy(mask), torch.from_numpy(cst), red5,
        torch.from_numpy(ct))
    assert got.dtype == BF16  # dz in z's dtype, as _dz_kernel writes it
    got = got.float().numpy()
    gap = np.abs(got - want)
    assert (gap <= _ulp_bf16(want)).all(), gap.max()


# ---------------------------------------------------------------------------
# bf16 staging
# ---------------------------------------------------------------------------


def _geometry_graphs(n=12):
    return load_synthetic(n, CFG, seed=2, max_atoms=6, keep_geometry=True)


def _port_copy(g):
    return tgraph.CrystalGraph(g.atom_fea, g.edge_fea, g.centers,
                               g.neighbors, g.target, distances=g.distances)


def test_packed_bf16_edges_bit_equal_to_jax():
    graphs = _geometry_graphs()
    nc, ec = jgraph.capacities_for(graphs, len(graphs), dense_m=M,
                                   snug=True)
    jb = jgraph.pack_graphs(graphs, nc, ec, len(graphs) + 2, dense_m=M,
                            edge_dtype=jnp.bfloat16)
    tb = tgraph.pack_graphs([_port_copy(g) for g in graphs], nc, ec,
                            len(graphs) + 2, dense_m=M, edge_dtype=BF16)
    assert tb.edges.dtype == BF16 and tb.edges.shape == jb.edges.shape
    want = np.asarray(jb.edges).view(np.uint16)
    np.testing.assert_array_equal(tb.edges.view(torch.int16).numpy()
                                  .view(np.uint16), want)
    f32 = tgraph.pack_graphs([_port_copy(g) for g in graphs], nc, ec,
                             len(graphs) + 2, dense_m=M)
    for f in dataclasses.fields(tgraph.GraphBatch):
        a, b = getattr(tb, f.name), getattr(f32, f.name)
        if f.name != "edges" and a is not None:
            assert torch.equal(a, b), f.name


def test_expanded_bf16_edges_are_the_rounded_f32_ones():
    graphs = _geometry_graphs()
    port = [_port_copy(g) for g in graphs]
    nc, ec = jgraph.capacities_for(graphs, len(graphs), dense_m=M,
                                   snug=True)
    caps = (nc, ec, len(graphs) + 2)
    jspec = jcompact.CompactSpec.build(graphs, CFG.gdf(), dense_m=M,
                                       edge_dtype=jnp.bfloat16)
    tspec = tcompact.CompactSpec.build(port, CFG.gdf(), dense_m=M,
                                       edge_dtype=BF16)
    tspec32 = dataclasses.replace(tspec, edge_dtype=torch.float32)
    jb = jcompact.pack_compact(graphs, *caps, jspec)
    cb = tcompact.CompactBatch(**{
        f.name: (None if (v := getattr(jb, f.name)) is None
                 else torch.from_numpy(np.array(v)))
        for f in dataclasses.fields(tcompact.CompactBatch)})
    got = tcompact.make_expander(tspec, "cpu")(cb).edges
    f32 = tcompact.make_expander(tspec32, "cpu")(cb).edges
    assert got.dtype == BF16
    assert torch.equal(got, f32.to(BF16))
    want = np.asarray(jax.jit(jcompact.make_expander(jspec))(jb).edges)
    assert want.dtype == jnp.bfloat16
    want = want.astype(np.float32)
    gap = np.abs(got.float().numpy() - want)
    # one bf16 ulp, or the f32 expansions' own bound where the features
    # are tiny (a Gaussian tail one side rounds to 0 in f32)
    assert (gap <= np.maximum(_ulp_bf16(want), EDGE_ATOL)).all(), gap.max()
    assert (gap == 0).mean() > 0.99


def test_raw_expander_bf16_edges_are_the_rounded_f32_ones():
    from cgnn_tpu_torch.data import rawbatch as trb
    from cgnn_tpu_torch.data.dataset import load_synthetic as tload
    from cgnn_tpu_torch.ops.neighbor_search import make_raw_expander

    graphs = tload(8, DataConfig(radius=5.0, max_num_nbr=M)
                   .featurize_config(), seed=3, keep_geometry=True)
    fcfg = DataConfig(radius=5.0, max_num_nbr=M).featurize_config()
    spec = trb.plan_raw_spec(graphs, fcfg.gdf(), fcfg.radius, M)
    rb = trb.pack_raw([trb.raw_from_graph(g) for g in graphs], 8, spec)
    got, _, _ = make_raw_expander(spec, device="cpu", edge_dtype=BF16)(rb)
    f32, _, _ = make_raw_expander(spec, device="cpu")(rb)
    assert got.edges.dtype == BF16
    assert torch.equal(got.edges, f32.edges.to(BF16))


# ---------------------------------------------------------------------------
# the whole bf16 model
# ---------------------------------------------------------------------------


def _train_batches(n_graphs=14, seed=2):
    graphs = load_synthetic(n_graphs, CFG, seed=seed, max_atoms=6)
    nc, _ = jgraph.capacities_for(graphs, len(graphs), dense_m=M, snug=True)
    nc += 16
    jb = next(iter(jgraph.batch_iterator(
        graphs, len(graphs), nc, nc * M, dense_m=M, snug=True,
        edge_dtype=jnp.bfloat16)))
    tb = next(iter(tgraph.batch_iterator(
        [_port_copy(g) for g in graphs], len(graphs), nc, nc * M,
        dense_m=M, snug=True,
        pack_fn=functools.partial(tgraph.pack_graphs, edge_dtype=BF16))))
    assert tb.edges.dtype == BF16
    targets = np.stack([g.target for g in graphs])
    return jb, tb, targets


def _variables(jnet, jb, seed=0):
    with jops.interpret_mode():
        v = jax.tree_util.tree_map(np.array,
                                   jnet.init(jax.random.key(0), jb))
    rng = np.random.default_rng(seed)
    for conv in v["batch_stats"].values():
        for bn in conv.values():
            bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(
                np.float32)
    return v


def _port_net(impl, variables):
    cfg = ModelConfig(**SMALL, dense_m=M, dtype="bfloat16",
                      cgconv_impl=impl)
    net = build_model(cfg, DataConfig(radius=5.0, max_num_nbr=M),
                      device="cpu")
    net.load_state_dict(convert.from_flax_variables(variables))
    return net


def _close(label, got, want, tol=MODEL_TOL):
    """Within ``tol`` of the reference's largest |entry|; -> the gap as a
    share of it."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, label
    scale = np.abs(want).max()
    share = float(np.abs(got - want).max() / max(scale, 1e-30))
    assert share <= tol, f"{label}: gap {share:.3e} of max |ref| {scale}"
    return share


@pytest.mark.parametrize("impl", ["", "pallas"])
def test_bf16_model_eval_and_train_match_jax(impl):
    jb, tb, _ = _train_batches()
    jnet = JNet(**SMALL, dense_m=M, dtype=jnp.bfloat16,
                cgconv_impl=impl or None)
    v = _variables(jnet, jb)
    net = _port_net(impl, v)
    with jops.interpret_mode():
        want_eval = np.asarray(jnet.apply(v, jb, train=False))
        want_train, mut = jnet.apply(v, jb, train=True,
                                     mutable=["batch_stats"])
    assert want_eval.dtype == np.float32
    with torch.inference_mode():
        got_eval = net(tb)
    assert got_eval.dtype == torch.float32
    _close("eval", got_eval.numpy(), want_eval)
    net.train()
    got_train = net(tb)
    _close("train", got_train.detach().numpy(), np.asarray(want_train))
    stats = convert.flatten({"batch_stats": jax.tree_util.tree_map(
        np.asarray, mut["batch_stats"])})
    got_stats = convert.flatten(convert.to_flax_variables(net.state_dict()))
    for path, want in stats.items():
        _close(path, got_stats[path], want)


@pytest.mark.parametrize("impl", ["", "pallas"])
def test_bf16_one_sgd_step_matches_jax(impl):
    jb, tb, targets = _train_batches(seed=5)
    jnet = JNet(**SMALL, dense_m=M, dtype=jnp.bfloat16,
                cgconv_impl=impl or None)
    v = _variables(jnet, jb)
    opt = dict(lr=0.05, momentum=0.9)
    tx = jmake_optimizer("sgd", **opt)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
        normalizer=JNormalizer.fit(targets), rng=jax.random.key(0),
        apply_fn=jnet.apply, tx=tx)
    with jops.interpret_mode():
        jstate, jm = jmake_train_step()(jstate, jb)
    net = _port_net(impl, v)
    state = tstate.TrainState(
        net, tstate.make_optimizer(net.parameters(), "sgd", **opt),
        Normalizer.fit(targets, device="cpu"))
    m = make_train_step()(state, tb)
    _close("loss", float(m["loss_sum"]), float(jm["loss_sum"]))
    before = convert.flatten({"params": v["params"]})
    after_j = convert.flatten(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params}))
    after_t = convert.flatten(convert.to_flax_variables(
        {k: p.detach() for k, p in net.named_parameters()}))
    # the update itself, held to the reference update's largest |entry|
    # over the whole tree (fc_full's bias, to which BN1 makes the loss
    # invariant, gets a gradient of bf16 roundoff on both sides)
    want = {p: after_j[p] - b for p, b in before.items()}
    got = {p: after_t[p] - b for p, b in before.items()}
    scale = max(np.abs(w).max() for w in want.values())
    gap = max(np.abs(got[p] - want[p]).max() for p in want)
    assert gap <= MODEL_TOL * scale, f"update gap {gap / scale:.3e}"


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------


def test_kernel6_backward_raises_for_a_bf16_cotangent_on_the_card(
        monkeypatch):
    """The fixed-order gather's backward on the card sums a bf16
    cotangent with kernel 6's bf16 instance, through the sum op (never
    ``torch.segment_reduce`` in its place), and raises naming the dtype
    where kernel 6 has no instance (f16). A ``meta`` tensor stands in for
    the card, a recording stand-in for the bf16 instance."""
    from cgnn_tpu_torch.ops import scatter

    offsets = torch.tensor([0, 2, 4], dtype=torch.int32)
    idx = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    seen = []
    monkeypatch.setattr(
        scatter, "segment_sum_sorted_bf16_cuda",
        lambda rows, off: seen.append(rows.dtype) or rows.new_zeros(
            (off.numel() - 1, rows.shape[1])))
    ctx = types.SimpleNamespace(saved_tensors=(idx, None, offsets),
                                impl="pallas")
    ct = torch.zeros((4, F), dtype=BF16, device="meta")
    grad = scatter.SortedGather.backward(ctx, ct)[0]
    assert seen == [BF16] and grad.dtype == BF16
    with pytest.raises(ValueError, match="float16"):
        scatter.SortedGather.backward(ctx, ct.half())
    # on the CPU the plain version runs, summed in f32, in the
    # cotangent's dtype
    grad = scatter.SortedGather.backward(
        ctx, torch.ones((4, F), dtype=BF16))[0]
    assert grad.dtype == BF16 and torch.equal(
        grad, torch.full((2, F), 2.0, dtype=BF16))


def test_training_forward_hands_bf16_inputs_to_the_bf16_instances(
        monkeypatch):
    """The card stood in for by the CPU: ``runs_kernel`` says kernel for
    every tensor and the bf16 instances of kernels 1, 2, 4 and 5 are
    stand-ins that run the plain versions and record their inputs. The
    training forward hands them the bf16 nodes and edges themselves (same
    storage: no f32 copy), launches no f32 instance, and the backward
    runs kernels 4 and 5 on bf16 z."""
    _, _, t = _bf16_inputs(seed=3)
    seen = {"node": [], "stats": [], "eval": [], "reduce": [], "dz": []}

    def node(nodes, kernel, bias):
        seen["node"].append(nodes)
        return tops.node_projections_reference(nodes, kernel, bias)

    def stats(nodes, edges, kernel, bias, nbr, mask, shift, *, p=None):
        seen["stats"].append((nodes, edges))
        return tops.stats_from_projections_reference(
            p, edges, kernel, nbr, mask, shift)

    def apply(nodes, edges, kernel, bias, scale, bn_bias, nbr, mask, mean,
              var, *, eps=1e-5, p=None):
        seen["eval"].append((nodes, edges))
        return tops.fused_cgconv_eval_reference(
            nodes, edges, kernel, bias, scale, bn_bias, nbr, mask, mean,
            var, eps=eps)

    def reduce(z, mask, cst, ct):
        seen["reduce"].append(z)
        return tfe.epilogue_reduce_reference(z, mask, cst, ct)

    def dz(z, mask, cst, red5, ct):
        seen["dz"].append(z)
        return tfe.epilogue_dz_reference(z, mask, cst, red5, ct)

    def refuse(*a, **k):
        raise AssertionError("an f32 instance was launched")

    for mod in (tops, tfe):
        monkeypatch.setattr(mod, "runs_kernel", lambda impl, x: True)
    monkeypatch.setattr(tops, "NODE_CUDA", {torch.float32: refuse,
                                            BF16: node})
    monkeypatch.setattr(tops, "STATS_CUDA", {torch.float32: refuse,
                                             BF16: stats})
    monkeypatch.setattr(tops, "EVAL_CUDA", {torch.float32: refuse,
                                            BF16: apply})
    monkeypatch.setattr(tfe, "REDUCE_CUDA", {torch.float32: refuse,
                                             BF16: reduce})
    monkeypatch.setattr(tfe, "DZ_CUDA", {torch.float32: refuse, BF16: dz})
    nodes = t["nodes"].clone().requires_grad_()
    kernel = t["kernel"].clone().requires_grad_()
    agg, *_ = tops.fused_cgconv(
        nodes, t["edges"], kernel, t["bias"], t["scale"], t["bn_bias"],
        t["neighbors"], t["edge_mask"], impl="pallas", dtype=BF16)
    (agg * agg).sum().backward()
    assert len(seen["node"]) == len(seen["stats"]) == len(seen["eval"]) == 1
    for got_nodes, got_edges in seen["stats"] + seen["eval"]:
        assert got_nodes.dtype == got_edges.dtype == BF16
        assert got_nodes.data_ptr() == nodes.data_ptr()
        assert got_edges.data_ptr() == t["edges"].data_ptr()
    assert seen["node"][0].data_ptr() == nodes.data_ptr()
    assert [z.dtype for z in seen["reduce"] + seen["dz"]] == [BF16, BF16]
    assert nodes.grad.dtype == BF16 and kernel.grad.dtype == torch.float32
    assert torch.isfinite(kernel.grad).all()
    # a storage type without an instance raises; nothing is cast to one
    with pytest.raises(ValueError, match="no instance"):
        tops.instance(tops.EVAL_CUDA, t["nodes"].half())
