"""The port's force field against the JAX package's, on the same LJ
trajectory frames packed by both packers, with weights carried by
``convert.from_flax_variables`` (2 convs, width 16, h 24, M 8, 5 A):

- the Gaussian centres, length and every value, against ``jnp.arange``
  in f32 and bf16 (bit-equal) over a grid of (dmin, dmax, step);
- energies and forces, dense and COO: f32 rtol 1e-4 / atol 1e-5 (f32
  roundoff through two convs and a gradient); bf16 energies within 2e-2
  of the reference's largest |entry| (tests/test_torch_bf16.py's
  tolerance: bf16 matmuls round at other places in the two frameworks)
  and bf16 forces within 5e-2 of it: a force is a gradient through every
  bf16 op of the model, and the JAX package's own bf16 forces lie 14-22%
  of the largest |force| from its f32 ones on these frames, so the
  rounding, not the algorithm, sets the gap (1-4% measured), and the
  test also holds the port's bf16 forces at most a third as far from
  JAX's as JAX's bf16 forces are from its f32 ones;
- one force train step's parameter gradients (the second-order path:
  forces taken with ``create_graph=True``, the composite loss
  differentiated to the parameters), after ``tests/test_forces.py:100``:
  each gradient within 2e-3 of its largest |entry| + 1e-5 (f32 sums of
  second derivatives in another order), dense and COO;
- ``gradcheck`` and ``gradgradcheck`` in f64 on the fixed-order gather and
  sum ops (ops/scatter.py, ops/segment.py), at their defaults (eps 1e-6,
  atol 1e-5, rtol 1e-3);
- the port's dense layout against its COO layout (energies, forces, one
  step's gradients), rtol 1e-4 / atol 1e-5 and the gradient tolerance;
- the JAX package's own failure on ``aggregation_impl='pallas'`` (the
  Pallas kernel in interpret mode, ``NotImplementedError`` from its JVP
  rule), beside the port's refusal of the same setting;
- a replay of the same step bit-equal to itself (two steps from the same
  state give the same bits: every sum in a fixed order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.data.dataset import FeaturizeConfig
from cgnn_tpu.data.dataset import load_trajectory as jload_trajectory
from cgnn_tpu.models.forcefield import ForceFieldCGCNN as JForceField
from cgnn_tpu.models.forcefield import energy_and_forces as jenergy_and_forces
from cgnn_tpu.train.force_step import _energy_and_grad_pos
from cgnn_tpu.train.force_step import force_loss as jforce_loss
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    build_force_model,
    build_model,
)
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.models.forcefield import (
    energy_and_forces,
    gaussian_centres,
)
from cgnn_tpu_torch.ops import scatter
from cgnn_tpu_torch.ops import segment as tsegment
from cgnn_tpu_torch.train.force_step import force_loss
from cgnn_tpu_torch.train.normalizer import Normalizer
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

M = 8
RADIUS = 5.0
SMALL = dict(atom_fea_len=16, n_conv=2, h_fea_len=24)
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL, GRAD_ABS = 2e-3, 1e-5
BF16_TOL = 2e-2
BF16_FORCE_TOL = 5e-2
FIELDS = [f.name for f in dataclasses.fields(tgraph.CrystalGraph)]


def _port(g):
    return tgraph.CrystalGraph(**{f: getattr(g, f) for f in FIELDS
                                  if hasattr(g, f)})


def _graphs(n=10, seed=5, atoms=6):
    return jload_trajectory(n, FeaturizeConfig(radius=RADIUS, max_num_nbr=M),
                            seed=seed, num_atoms=atoms)


def _batches(graphs, dense: bool):
    dm = M if dense else None
    nc, ec = jgraph.capacities_for(graphs, len(graphs), dense_m=dm,
                                   snug=True)
    nc += 3
    ec = nc * M if dense else ec + 5
    jb = next(iter(jgraph.batch_iterator(graphs, len(graphs), nc, ec,
                                         dense_m=dm, snug=True)))
    tb = next(iter(tgraph.batch_iterator([_port(g) for g in graphs],
                                         len(graphs), nc, ec, dense_m=dm,
                                         snug=True)))
    return jb, tb


def _models(dense: bool, dtype="float32", seed=0, example=None):
    dm = M if dense else None
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jnet = JForceField(**SMALL, dmax=RADIUS, dense_m=dm, dtype=jdt)
    v = jax.tree_util.tree_map(np.array, jnet.init(jax.random.key(seed),
                                                   example))
    tnet = build_force_model(
        ModelConfig(**SMALL, dense_m=dm or 0, dtype=dtype),
        DataConfig(radius=RADIUS, max_num_nbr=M), device="cpu")
    tnet.load_state_dict(convert.from_flax_variables(v))
    return jnet, v, tnet


def _normalizers(graphs):
    t = np.stack([g.target for g in graphs])
    jn = JNormalizer.fit(t)
    return jn, Normalizer.from_arrays(np.asarray(jn.mean),
                                      np.asarray(jn.std), device="cpu")


def _masked(jb, tb, je, jf, te, tf):
    gm = np.asarray(jb.graph_mask) > 0
    nm = np.asarray(jb.node_mask) > 0
    assert np.array_equal(gm, tb.graph_mask.numpy() > 0)
    return (np.asarray(je)[gm], te.detach().numpy()[gm],
            np.asarray(jf)[nm], tf.detach().numpy()[nm])


# ---------------------------------------------------------------------------
# the Gaussian centres
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jd,td", [(jnp.float32, torch.float32),
                                   (jnp.bfloat16, torch.bfloat16)])
def test_gaussian_centres_match_jnp_arange(jd, td):
    for dmin in (0.0, 0.5, 0.7):
        for dmax in (4.0, 5.0, 6.0, 7.3, 8.0, 8.2, 12.0):
            for step in (0.05, 0.1, 0.15, 0.2, 0.25, 0.3):
                want = np.asarray(jnp.arange(dmin, dmax + step, step,
                                             dtype=jd)).astype(np.float32)
                got = gaussian_centres(dmin, dmax, step, td)
                assert got.dtype == td
                np.testing.assert_array_equal(got.float().numpy(), want)


def test_gaussian_width_matches_the_featurizer():
    """The model's G (len of the centres) is the data config's edge
    width, which sizes fc_full (convert.init_params)."""
    for radius in (5.0, 6.0, 8.0):
        dcfg = DataConfig(radius=radius)
        assert gaussian_centres(dcfg.dmin, radius, dcfg.step).numel() == (
            dcfg.nbr_fea_len)


# ---------------------------------------------------------------------------
# energies, forces and one step's gradients against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "coo"])
def test_energies_and_forces_match_jax(dense):
    graphs = _graphs()
    jb, tb = _batches(graphs, dense)
    jnet, v, tnet = _models(dense, example=jb)
    je, jf, _ = jenergy_and_forces(jnet, v, jb)
    te, tf = energy_and_forces(tnet, tb)
    je, te, jf, tf = _masked(jb, tb, je, jf, te, tf)
    np.testing.assert_allclose(te, je, **TOL)
    np.testing.assert_allclose(tf, jf, **TOL)
    assert np.abs(jf).max() > 1e-3  # the forces are not trivially zero


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "coo"])
def test_bf16_energies_and_forces_match_jax(dense):
    graphs = _graphs(seed=7)
    jb, tb = _batches(graphs, dense)
    jnet, v, tnet = _models(dense, dtype="bfloat16", example=jb)
    je, jf, _ = jenergy_and_forces(jnet, v, jb)
    te, tf = energy_and_forces(tnet, tb)
    assert te.dtype == torch.float32 and tf.dtype == torch.float32
    je, te, jf, tf = _masked(jb, tb, je, jf, te, tf)
    gap = np.abs(te - je).max()
    assert gap <= BF16_TOL * np.abs(je).max(), gap
    gap = np.abs(tf - jf).max()
    assert gap <= BF16_FORCE_TOL * np.abs(jf).max(), gap
    # the JAX package's bf16 forces against its f32 ones on the weights
    jnet32 = JForceField(**SMALL, dmax=RADIUS, dense_m=M if dense else None)
    jf32 = np.asarray(jenergy_and_forces(jnet32, v, jb)[1])[
        np.asarray(jb.node_mask) > 0]
    assert gap <= np.abs(jf - jf32).max() / 3, gap


def _jax_grads(jnet, v, jb, jnorm, w_e=1.0, w_f=10.0):
    def loss_fn(params):
        energies, grad_pos, _ = _energy_and_grad_pos(
            jnet.apply, {"params": params}, jb, train=True)
        forces = -grad_pos * jb.node_mask[:, None]
        loss, metrics = jforce_loss(energies, forces, jb, jnorm, w_e, w_f)
        return loss, metrics

    (loss, metrics), g = jax.value_and_grad(loss_fn, has_aux=True)(
        v["params"])
    return float(loss), metrics, convert.flatten(
        jax.tree_util.tree_map(np.asarray, {"params": g}))


def _port_grads(tnet, tb, tnorm, w_e=1.0, w_f=10.0):
    tnet.train()
    tnet.zero_grad(set_to_none=True)
    energies, forces = energy_and_forces(tnet, tb, create_graph=True)
    loss, metrics = force_loss(energies, forces, tb, tnorm, w_e, w_f)
    params = list(tnet.parameters())
    loss.backward(inputs=params)
    grads = convert.flatten(convert.to_flax_variables(
        {k: p.grad for k, p in tnet.named_parameters()}))
    return float(loss), metrics, grads


def _grads_close(got, want):
    assert set(got) == set(want)
    for k in want:
        scale = np.abs(want[k]).max()
        gap = np.abs(got[k] - want[k]).max()
        assert gap <= GRAD_REL * scale + GRAD_ABS, (k, gap, scale)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "coo"])
def test_force_train_step_gradients_match_jax(dense):
    """One composite-loss step's parameter gradients, through the
    second-order path (tests/test_forces.py:100's check, across
    frameworks)."""
    graphs = _graphs(seed=11)
    jb, tb = _batches(graphs, dense)
    jnet, v, tnet = _models(dense, seed=3, example=jb)
    jnorm, tnorm = _normalizers(graphs)
    jl, jm, jg = _jax_grads(jnet, v, jb, jnorm)
    tl, tm, tg = _port_grads(tnet, tb, tnorm)
    assert tl == pytest.approx(jl, rel=1e-4)
    for k in ("mae_sum", "force_mae_sum", "count", "force_mae_count"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
    _grads_close(tg, jg)
    assert all(np.abs(a).max() > 0 for a in tg.values())


def test_port_dense_layout_matches_coo():
    """The port's two layouts on the same frames and weights: energies,
    forces and one step's gradients (the JAX package's
    test_dense_force_layout_matches_coo, in the port)."""
    graphs = _graphs(seed=13)
    _, td = _batches(graphs, True)
    jc, tc = _batches(graphs, False)
    _, v, coo = _models(False, example=jc)
    dense = build_force_model(ModelConfig(**SMALL, dense_m=M),
                              DataConfig(radius=RADIUS, max_num_nbr=M),
                              device="cpu")
    dense.load_state_dict(convert.from_flax_variables(v))
    ed, fd = energy_and_forces(dense, td)
    ec, fc = energy_and_forces(coo, tc)
    gd, gc = td.graph_mask > 0, tc.graph_mask > 0
    nd, nc = td.node_mask > 0, tc.node_mask > 0
    np.testing.assert_allclose(ed[gd].detach().numpy(),
                               ec[gc].detach().numpy(), **TOL)
    np.testing.assert_allclose(fd[nd].numpy(), fc[nc].numpy(), **TOL)
    _, tnorm = _normalizers(graphs)
    _grads_close(_port_grads(dense, td, tnorm)[2],
                 _port_grads(coo, tc, tnorm)[2])


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "coo"])
def test_force_step_repeats_its_bits(dense):
    """Two train steps from the same state give the same bits: every sum
    of both passes runs in a fixed order."""
    from cgnn_tpu_torch.train import state as tstate
    from cgnn_tpu_torch.train.force_step import make_force_train_step

    graphs = _graphs(seed=17)
    jb, tb = _batches(graphs, dense)
    _, v, _ = _models(dense, example=jb)
    _, tnorm = _normalizers(graphs)
    runs = []
    for _ in range(2):
        net = build_force_model(
            ModelConfig(**SMALL, dense_m=M if dense else 0),
            DataConfig(radius=RADIUS, max_num_nbr=M), device="cpu")
        net.load_state_dict(convert.from_flax_variables(v))
        st = tstate.TrainState(net, tstate.make_optimizer(
            net.parameters(), "sgd", lr=0.01), tnorm)
        step = make_force_train_step()
        m = [step(st, tb) for _ in range(2)]
        runs.append(([float(x["loss_sum"]) for x in m],
                     {k: p.detach().clone()
                      for k, p in net.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    for k, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][k]), k


# ---------------------------------------------------------------------------
# the fixed-order gather and sum ops, twice differentiable
# ---------------------------------------------------------------------------


def _csr(indices, n):
    order, offsets = tgraph.csr_transpose(indices, n)
    return (None if order is None else torch.from_numpy(order),
            torch.from_numpy(offsets))


@pytest.mark.parametrize("sorted_idx", [True, False])
def test_sorted_gather_and_sum_gradgradcheck(sorted_idx):
    rng = np.random.default_rng(0)
    n, e, f = 5, 13, 3
    idx = rng.integers(0, n, e).astype(np.int32)
    if sorted_idx:
        idx = np.sort(idx)
    order, offsets = tgraph.csr_transpose(idx, n, indices_sorted=sorted_idx)
    order = None if order is None else torch.from_numpy(order)
    offsets = torch.from_numpy(offsets)
    indices = torch.from_numpy(idx)
    x = torch.randn(n, f, dtype=torch.float64, requires_grad=True)
    ct = torch.randn(e, f, dtype=torch.float64, requires_grad=True)

    def gather_op(v):
        return tsegment.gather_fixed_order(v, indices, order, offsets)

    def sum_op(c):
        return scatter.SortedSum.apply(c, indices, order, offsets, "xla")

    for fn, inp in ((gather_op, x), (sum_op, ct)):
        assert torch.autograd.gradcheck(fn, (inp,))
        assert torch.autograd.gradgradcheck(fn, (inp,))
    # the two are each other's transposes: <G x, c> == <x, S c>
    assert torch.allclose((gather_op(x) * ct).sum(), (x * sum_op(ct)).sum())


def test_segment_sum_sorted_gradgradcheck():
    centers = torch.tensor([0, 0, 1, 3, 3, 3, 4], dtype=torch.int32)
    msg = torch.randn(7, 4, dtype=torch.float64, requires_grad=True)

    def fn(m):
        return scatter.segment_sum_sorted(m, centers, 6, impl="xla")

    assert torch.autograd.gradcheck(fn, (msg,))
    assert torch.autograd.gradgradcheck(fn, (msg,))
    out = fn(msg)
    assert out.dtype == torch.float64 and out.shape == (6, 4)
    assert torch.equal(out[2], torch.zeros(4, dtype=torch.float64))


@pytest.mark.parametrize("two_tier", [True, False])
def test_gather_transpose_gradgradcheck(two_tier):
    """The dense neighbor gather with its packed transpose, on a batch
    whose edge slots are all real (the transpose is then exactly the
    gather's): once and twice differentiable in f64."""
    rng = np.random.default_rng(1)
    n, m, f = 6, 3, 2
    neighbors = rng.integers(0, n, n * m).astype(np.int32)
    real = np.ones(n * m, bool)
    slots = tgraph.transpose_slots(neighbors, real, n, m,
                                   None if two_tier else 2 * m,
                                   n * m if two_tier else None)
    t = [None if a is None else torch.from_numpy(np.asarray(a))
         for a in slots]
    nbr = torch.from_numpy(neighbors)
    x = torch.randn(n, f, dtype=torch.float64, requires_grad=True)

    def fn(v):
        return tsegment.gather_transpose(v, nbr, *t)

    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))


def test_first_order_backward_bits_unchanged():
    """The gather's first-order backward is the plain sorted sum of the
    permuted cotangent (``torch.segment_reduce`` in f32): the bits the
    op gave before it could be differentiated twice."""
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 7, 40).astype(np.int32)
    order, offsets = _csr(idx, 7)
    x = torch.randn(7, 5, requires_grad=True)
    ct = torch.randn(40, 5)
    tsegment.gather_fixed_order(x, torch.from_numpy(idx), order,
                                offsets).backward(ct)
    want = torch.segment_reduce(ct.index_select(0, order), "sum",
                                offsets=offsets, axis=0, unsafe=True)
    assert torch.equal(x.grad, want)


# ---------------------------------------------------------------------------
# aggregation='pallas': the JAX package's failure, the port's refusal
# ---------------------------------------------------------------------------


def test_pallas_aggregation_fails_in_jax_and_is_refused_in_the_port():
    graphs = _graphs(n=6, seed=19)
    jb, _ = _batches(graphs, False)
    jnet = JForceField(**SMALL, dmax=RADIUS, aggregation_impl="pallas")
    jnorm, _ = _normalizers(graphs)
    with pltpu.force_tpu_interpret_mode():
        v = jnet.init(jax.random.key(0), jb)

        def loss(params):
            energies, grad_pos, _ = _energy_and_grad_pos(
                jnet.apply, {"params": params}, jb, train=True)
            return jnp.sum(grad_pos ** 2) + jnp.sum(energies)

        with pytest.raises(NotImplementedError):
            jax.grad(loss)(v["params"])
    with pytest.raises(NotImplementedError, match="_pallas_call_jvp_rule"):
        build_model(ModelConfig(**SMALL, dense_m=0, aggregation="pallas"),
                    DataConfig(radius=RADIUS, max_num_nbr=M), device="cpu",
                    task="force")


def test_force_tree_round_trips_and_matches_jax_init():
    graphs = _graphs(n=4, seed=23)
    jb, _ = _batches(graphs, True)
    _, v, tnet = _models(True, example=jb)
    flat = convert.flatten(v)
    assert not any(k.startswith("batch_stats") for k in flat)
    back = convert.flatten(convert.to_flax_variables(tnet.state_dict()))
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    init = convert.flatten(convert.init_params(
        ModelConfig(**SMALL, dense_m=M), DataConfig(radius=RADIUS,
                                                    max_num_nbr=M),
        seed=1, task="force"))
    assert {k: a.shape for k, a in init.items()} == {
        k: a.shape for k, a in flat.items()}
