"""The port's graph sharding (``cgnn_tpu_torch/parallel/edge_parallel.py``
and the branches it drives) on the CPU, against the JAX package's
``make_edge_parallel_*`` steps on the conftest's host devices and
against its own unsharded step.

Every multi-process case starts its ranks as subprocesses over gloo (a
worker script that imports torch and the port only), each on a free
port and killed past its own timeout, as tests/test_torch_parallel.py
does.

Tolerances, with their reasons: the integer sharding outputs (per-shard
transpose mappings, packed batches, capacities, padded edges) are held
bit for bit; one sharded train and eval step at the JAX test's own
tolerances (``tests/test_edge_parallel.py:106-131``, ``:236-278``: loss
abs 1e-4, every parameter and running statistic atol 1e-5, eval
``mae_sum`` rel 1e-5), against the JAX sharded step and against the
port's unsharded step; a 2-epoch D=2 x G=2 fit against the port's plain
data-parallel fit at ``tests/test_edge_parallel.py:135-172``'s (rel 1e-4,
parameters atol 1e-4); the bf16 COO sharded step against the bf16
unsharded step within tests/test_torch_bf16.py's 2e-2 of the largest
|entry|; the force task's data-parallel step against the JAX
``make_force_train_step(axis_name='data')`` at tests/test_torch_forces.py's
(metric sums rel 1e-4, the update within 2e-3 of its largest |entry| +
1e-5). The ranks of a graph group are held to each other bit for bit.
"""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cgnn_tpu import parallel as jpar
from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.data import invariants as jinv
from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu.data.dataset import load_trajectory as jload_trajectory
from cgnn_tpu.models import CrystalGraphConvNet as JNet
from cgnn_tpu.models.forcefield import ForceFieldCGCNN as JForceField
from cgnn_tpu.parallel import edge_parallel as jep
from cgnn_tpu.parallel.mesh import make_mesh
from cgnn_tpu.train.force_step import make_force_train_step
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.state import TrainState as JTrainState
from cgnn_tpu.train.state import make_optimizer as jmake_optimizer
from cgnn_tpu.train.step import make_eval_step as jmake_eval_step
from cgnn_tpu.train.step import make_train_step as jmake_train_step
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.data import invariants as tinv
from cgnn_tpu_torch.parallel import dist
from cgnn_tpu_torch.parallel import edge_parallel as tep
from cgnn_tpu_torch.train.normalizer import Normalizer
from cgnn_tpu_torch.train.state import TrainState, make_optimizer
from cgnn_tpu_torch.train.step import make_eval_step, make_train_step

ROOT = Path(__file__).resolve().parents[1]
M = 8
SMALL = dict(atom_fea_len=32, n_conv=2, h_fea_len=32)
DATA = dict(radius=5.0, max_num_nbr=M)
OPT = dict(optim="sgd", lr=0.01, momentum=0.9, lr_milestones=[100])
RANK_TIMEOUT_S = 240
BF16_TOL = 2e-2
GRAD_REL, GRAD_ABS = 2e-3, 1e-5

WORKER = r'''
import sys
import torch
from cgnn_tpu_torch.parallel import dist


def new_state(case, group=None):
    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.train.normalizer import Normalizer
    from cgnn_tpu_torch.train.state import TrainState, make_optimizer

    net = build_model(ModelConfig(**case["model"]),
                      DataConfig(**case["data"]), device="cpu",
                      task=case.get("task", "regression"),
                      graph_group=group)
    net.load_state_dict(case["state_dict"])
    return TrainState(net, make_optimizer(net.parameters(), **case["opt"]),
                      Normalizer.fit(case["targets"], device="cpu"))


def sharded(spec, rank, world):
    from cgnn_tpu_torch.parallel import (
        edge_nbytes, make_parallel_train_step, rank_view, state_digest)
    from cgnn_tpu_torch.train.step import make_eval_step

    group = dist.graph_group()
    outs = []
    for case in spec["cases"]:
        state = new_state(case, group)
        out = {"eval": None, "metrics": []}
        if case.get("eval") is not None:
            view = rank_view(case["eval"], group.size, group.index)
            out["eval"] = {k: float(v) for k, v in
                           make_eval_step()(state, view).items()}
        step = make_parallel_train_step(guard=case.get("guard", False))
        for b in case["train"]:
            view = rank_view(b, group.size, group.index)
            out["edge_bytes"] = edge_nbytes(view)
            out["metrics"].append({k: float(v) for k, v in
                                   step(state, view).items()})
        out["state"] = {k: v.clone() for k, v in
                        state.model.state_dict().items()}
        out["digest"] = state_digest(state)
        outs.append(out)
    return outs


def force(spec, rank, world):
    from cgnn_tpu_torch.parallel import make_parallel_train_step
    from cgnn_tpu_torch.train.force_step import make_force_grad_step

    case = spec["cases"][0]
    state = new_state(case)
    step = make_parallel_train_step(grad_step=make_force_grad_step())
    metrics = {k: float(v) for k, v in
               step(state, case["train"][rank]).items()}
    return {"metrics": metrics,
            "params": {k: p.detach().clone()
                       for k, p in state.model.named_parameters()}}


def main():
    rank, world, port, shards = (int(a) for a in sys.argv[1:5])
    spec = torch.load(sys.argv[5], weights_only=False)
    dist.initialize(f"localhost:{port}", world, rank, backend="gloo",
                    timeout_s=60, log_fn=lambda *a: None,
                    graph_shards=shards)
    try:
        out = {"sharded": sharded, "force": force}[spec["mode"]](
            spec, rank, world)
    finally:
        dist.shutdown()
    torch.save(out, sys.argv[6])


main()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CGNN_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update({"OMP_NUM_THREADS": "1"}, **extra)
    return env


def _wait_all(procs, timeout):
    try:
        return [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _run_ranks(tmp_path, spec, world, shards):
    path = tmp_path / "spec.pt"
    torch.save(spec, path)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(port),
         str(shards), str(path), str(tmp_path / f"out{r}.pt")],
        cwd=tmp_path, env=_child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = _wait_all(procs, RANK_TIMEOUT_S)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(world)]


def _port(g):
    return tgraph.CrystalGraph(g.atom_fea, g.edge_fea, g.centers,
                               g.neighbors, g.target)


def _graphs(n=16, seed=0):
    return load_synthetic(n, FeaturizeConfig(**DATA), seed=seed)


def _bit_equal(got, want, label=""):
    if want is None:
        assert got is None, label
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=label)


def _batches_bit_equal(tb, jb):
    for f in dataclasses.fields(jb):
        _bit_equal(getattr(tb, f.name), getattr(jb, f.name), f.name)


# ---------------------------------------------------------------------------
# the integer sharding outputs, bit-equal to the JAX package's
# ---------------------------------------------------------------------------


def _dense_pair(n_shards, n=16, batch=16):
    graphs = _graphs(n)
    nc, ec = jgraph.capacities_for(graphs, batch, dense_m=M,
                                   node_multiple=8 * n_shards)
    jb = next(jgraph.batch_iterator(graphs, batch, nc, ec, dense_m=M))
    tb = next(tgraph.batch_iterator([_port(g) for g in graphs], batch, nc,
                                    ec, dense_m=M))
    return graphs, jb, tb


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_transpose_slots_bit_equal(n_shards):
    _, jb, tb = _dense_pair(n_shards)
    args = (np.asarray(jb.neighbors), np.asarray(jb.edge_mask) > 0,
            jb.node_capacity, M, n_shards, len(jb.over_slots))
    want = jgraph.shard_transpose_slots(*args)
    got = tgraph.shard_transpose_slots(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        _bit_equal(g, w)
    # prepare_dense_sharded rebuilds the same mappings from the flat one
    _batches_bit_equal(tep.prepare_dense_sharded(tb, n_shards),
                       jep.prepare_dense_sharded(jb, n_shards))
    prepped = tep.prepare_dense_sharded(tb, n_shards)
    tinv.check_batch(prepped)
    bad = prepped.in_slots.clone()
    first = tuple(np.argwhere(prepped.in_mask.numpy().reshape(
        n_shards, -1) > 0)[0])
    bad[first] += 1
    with pytest.raises(tinv.BatchInvariantError):
        tinv.check_batch(dataclasses.replace(prepped, in_slots=bad))
    # eval batches drop the mapping
    for name in tep.MAPPING_FIELDS:
        assert getattr(tep.prepare_dense_sharded(tb, n_shards, train=False),
                       name) is None


@pytest.mark.parametrize("n_shards", [2, 4])
def test_iterators_pack_per_shard_mappings_bit_equal(n_shards):
    graphs = _graphs(40, seed=3)
    tg = [_port(g) for g in graphs]
    nc, ec = jgraph.capacities_for(graphs, 8, dense_m=M, snug=True,
                                   node_multiple=8 * n_shards)
    jl = list(jgraph.batch_iterator(graphs, 8, nc, ec, dense_m=M, snug=True,
                                    shuffle=True,
                                    rng=np.random.default_rng(2),
                                    transpose_shards=n_shards))
    tl = list(tgraph.batch_iterator(tg, 8, nc, ec, dense_m=M, snug=True,
                                    shuffle=True,
                                    rng=np.random.default_rng(2),
                                    transpose_shards=n_shards))
    assert len(jl) == len(tl) > 1
    for jb, tb in zip(jl, tl):
        assert tb.in_mask.shape[0] == n_shards
        _batches_bit_equal(tb, jb)
    jl = list(jgraph.bucketed_batch_iterator(
        graphs, 8, 2, shuffle=True, rng=np.random.default_rng(4),
        dense_m=M, snug=True, node_multiple=8 * n_shards,
        transpose_shards=n_shards))
    tl = list(tgraph.bucketed_batch_iterator(
        tg, 8, 2, shuffle=True, rng=np.random.default_rng(4), dense_m=M,
        snug=True, node_multiple=8 * n_shards, transpose_shards=n_shards))
    assert len(jl) == len(tl)
    for jb, tb in zip(jl, tl):
        assert tb.node_capacity % (8 * n_shards) == 0
        _batches_bit_equal(tb, jb)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "coo"])
@pytest.mark.parametrize("snug", [True, False], ids=["snug", "ladder"])
@pytest.mark.parametrize("multiple", [1, 16, 32])
def test_capacities_for_node_multiple_bit_equal(dense, snug, multiple):
    graphs = _graphs(30, seed=5)
    dm = M if dense else None
    want = jgraph.capacities_for(graphs, 8, dense_m=dm, snug=snug,
                                 node_multiple=multiple)
    got = tgraph.capacities_for([_port(g) for g in graphs], 8, dense_m=dm,
                                snug=snug, node_multiple=multiple)
    assert got == tuple(int(x) for x in want)
    assert got[0] % multiple == 0


@pytest.mark.parametrize("n_shards", [3, 4, 8])
def test_pad_edges_divisible_bit_equal(n_shards):
    graphs = _graphs()
    nc, ec = jgraph.capacities_for(graphs, 16)
    jb = next(jgraph.batch_iterator(graphs, 16, nc, ec + 1))
    tb = next(tgraph.batch_iterator([_port(g) for g in graphs], 16, nc,
                                    ec + 1))
    assert tb.nbr_order is not None  # a COO training batch
    jp = jep.pad_edges_divisible(jb, n_shards)
    tp = tep.pad_edges_divisible(tb, n_shards)
    assert tp.edge_capacity % n_shards == 0
    _batches_bit_equal(tp, jp)
    # the gathers' transpose of the padded batch is its own CSR transpose
    order, nbr_offsets = tgraph.csr_transpose(tp.neighbors.numpy(),
                                              tp.node_capacity)
    _, center_offsets = tgraph.csr_transpose(tp.centers.numpy(),
                                             tp.node_capacity, True)
    _bit_equal(tp.nbr_order, order)
    _bit_equal(tp.nbr_offsets, nbr_offsets)
    _bit_equal(tp.center_offsets, center_offsets)
    tinv.check_batch(tp)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_rank_views_split_the_edge_leaves(n_shards):
    """Each rank's view: the node and graph leaves whole, its strip or
    chunk of the edge leaves, its row of the dense mapping, and a COO
    chunk's transposes equal to a numpy recomputation over all N nodes;
    together the views hold every edge once."""
    graphs = _graphs()
    tg = [_port(g) for g in graphs]
    nc, ec = tgraph.capacities_for(tg, 16, snug=False)
    coo = tep.pad_edges_divisible(next(tgraph.batch_iterator(tg, 16, nc,
                                                             ec)), n_shards)
    _, jb, dense = _dense_pair(n_shards)
    for batch in (coo, dense):
        views = [tep.rank_view(batch, n_shards, s) for s in range(n_shards)]
        for name in tep.EDGE_FIELDS:
            _bit_equal(torch.cat([getattr(v, name) for v in views]),
                       getattr(batch, name).numpy(), name)
        for v in views:
            for name in ("nodes", "node_mask", "graph_mask", "targets"):
                assert getattr(v, name) is getattr(batch, name)
        total = tep.edge_nbytes(batch)
        assert all(tep.edge_nbytes(v) < total for v in views)
    prepped = jep.prepare_dense_sharded(jb, n_shards)
    for s in range(n_shards):
        v = tep.rank_view(dense, n_shards, s)
        for name in tep.MAPPING_FIELDS:
            _bit_equal(getattr(v, name),
                       np.asarray(getattr(prepped, name))[s:s + 1], name)
    n = coo.node_capacity
    for s in range(n_shards):
        v = tep.rank_view(coo, n_shards, s)
        cen, nbr = v.centers.numpy(), v.neighbors.numpy()
        _bit_equal(v.nbr_order, np.argsort(nbr, kind="stable"))
        _bit_equal(v.nbr_offsets, np.concatenate(
            [[0], np.cumsum(np.bincount(nbr, minlength=n))]))
        _bit_equal(v.center_offsets, np.searchsorted(cen, np.arange(n + 1)))


def test_refusals_name_their_cause():
    _, jb, tb = _dense_pair(4)
    with pytest.raises(ValueError, match="node_cap 6 not divisible"):
        tgraph.shard_transpose_slots(np.zeros(48, np.int32),
                                     np.zeros(48, bool), 6, M, 4, over_cap=8)
    with pytest.raises(ValueError, match="node_cap 6 not divisible"):
        jgraph.shard_transpose_slots(np.zeros(48, np.int32),
                                     np.zeros(48, bool), 6, M, 4, over_cap=8)
    ncap = tb.node_capacity
    odd = tgraph.pack_graphs(_graphs(2), ncap + 2, (ncap + 2) * M, 4,
                             dense_m=M, over_cap=64)
    with pytest.raises(ValueError, match=f"node capacity {ncap + 2} not "
                                         f"divisible by 4 graph shards"):
        tep.prepare_dense_sharded(odd, 4)
    four = tep.prepare_dense_sharded(tb, 4)
    with pytest.raises(ValueError, match="4-shard transpose mapping but 2"):
        tep.prepare_dense_sharded(four, 2)
    single = next(tgraph.batch_iterator([_port(g) for g in _graphs()], 16,
                                        ncap, ncap * M, dense_m=M,
                                        in_cap=32))
    with pytest.raises(ValueError, match="two-tier transpose layout"):
        tep.prepare_dense_sharded(single, 2)
    coo = next(tgraph.batch_iterator([_port(g) for g in _graphs()], 16,
                                     ncap, 4 * ncap * M + 1))
    with pytest.raises(ValueError, match="dense-layout batch"):
        tep.prepare_dense_sharded(coo, 2)
    with pytest.raises(ValueError, match="not divisible by 2 graph shards"):
        tep.rank_view(coo, 2, 0)
    with pytest.raises(ValueError, match="two-tier layout"):
        tgraph.pack_graphs(_graphs(2), 32, 32 * M, 4, dense_m=M, in_cap=8,
                           transpose_shards=2)


def test_model_refuses_fused_ops_and_force_with_a_group():
    group = dist.Group([0, 1], None, "gloo", 0)
    for kw in ({"cgconv_impl": "xla"}, {"fused_epilogue": "xla"}):
        with pytest.raises(NotImplementedError, match="no graph sharding"):
            build_model(ModelConfig(**SMALL, dense_m=M, **kw),
                        DataConfig(**DATA), device="cpu", graph_group=group)
    with pytest.raises(NotImplementedError, match="force task"):
        build_model(ModelConfig(**SMALL, dense_m=M), DataConfig(**DATA),
                    device="cpu", task="force", graph_group=group)
    net = build_model(ModelConfig(**SMALL, dense_m=M), DataConfig(**DATA),
                      device="cpu", graph_group=group)
    names = {n for n, p in net.named_parameters()
             if any(p is q for q in net.sharded_parameters())}
    assert names == {f"conv_{i}.{m}.{w}" for i in range(2)
                     for m, ws in (("fc_full", ("kernel", "bias")),
                                   ("bn1", ("weight", "bias")))
                     for w in ws}


# ---------------------------------------------------------------------------
# one train and eval step against the JAX sharded steps
# ---------------------------------------------------------------------------


def _variables(jnet, jb, seed=0):
    v = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.key(0), jb))
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    rng = np.random.default_rng(seed)
    for conv in v["batch_stats"].values():
        for bn in conv.values():
            bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(
                np.float32)
    return v


def _jstate(jnet, v, targets):
    tx = jmake_optimizer(**OPT)
    return JTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
        normalizer=JNormalizer.fit(targets), rng=jax.random.key(0),
        apply_fn=jnet.apply, tx=tx)


def _flat(tree):
    return dict(convert.flatten(jax.tree_util.tree_map(np.asarray, tree)))


def _layout_case(layout, n_shards):
    """(JAX train batch, JAX eval batch, port train batch, port eval
    batch, targets, port model kw, JAX net kw) of one layout."""
    graphs = _graphs()
    tg = [_port(g) for g in graphs]
    targets = np.stack([g.target for g in graphs])
    if layout == "dense":
        nc, ec = jgraph.capacities_for(graphs, 16, dense_m=M,
                                       node_multiple=8 * n_shards)
        jb = next(jgraph.batch_iterator(graphs, 16, nc, ec, dense_m=M))
        tb = next(tgraph.batch_iterator(tg, 16, nc, ec, dense_m=M))
        je = next(jgraph.batch_iterator(graphs, 16, nc, ec, dense_m=M,
                                        in_cap=0))
        te = next(tgraph.batch_iterator(tg, 16, nc, ec, dense_m=M,
                                        in_cap=0))
        return (jb, je, tb, te, targets, dict(SMALL, dense_m=M),
                dict(SMALL, dense_m=M))
    nc, ec = jgraph.capacities_for(graphs, 16)
    jb = jep.pad_edges_divisible(next(jgraph.batch_iterator(
        graphs, 16, nc, ec)), n_shards)
    tb = tep.pad_edges_divisible(next(tgraph.batch_iterator(
        tg, 16, nc, ec)), n_shards)
    te = tep.pad_edges_divisible(next(tgraph.batch_iterator(
        tg, 16, nc, ec, in_cap=0)), n_shards)
    return (jb, jb, tb, te, targets,
            dict(SMALL, dense_m=0, aggregation="pallas"),
            dict(SMALL, aggregation_impl="xla"))


def _jax_sharded(layout, n_shards, jb, je, jnet_kw, v, targets):
    """The JAX sharded train and eval steps on a ('graph',) mesh of
    ``n_shards`` host devices -> (train metrics, variables, eval
    metrics)."""
    dense = layout == "dense"
    jnet = JNet(**jnet_kw, edge_axis_name="graph")
    mesh = Mesh(np.array(jax.devices()[:n_shards]), ("graph",))
    if dense:
        train_b = jep.prepare_dense_sharded(jb, n_shards, train=True)
        eval_b = jep.prepare_dense_sharded(je, n_shards, train=False)
    else:
        train_b = eval_b = jb
    ev = jax.device_get(jep.make_edge_parallel_eval_step(
        mesh, dense=dense)(_jstate(jnet, v, targets),
                           jep.shard_batch(eval_b, mesh)))
    state, m = jep.make_edge_parallel_train_step(mesh, dense=dense)(
        _jstate(jnet, v, targets), jep.shard_batch(train_b, mesh))
    return (jax.device_get(m), _flat(jax.device_get(state.variables())),
            {k: float(x) for k, x in ev.items()})


def _port_unsharded(model_kw, v, targets, tb, te, dtype="float32"):
    net = build_model(ModelConfig(**model_kw, dtype=dtype),
                      DataConfig(**DATA), device="cpu")
    net.load_state_dict(convert.from_flax_variables(v))
    state = TrainState(net, make_optimizer(net.parameters(), **OPT),
                       Normalizer.fit(targets, device="cpu"))
    ev = {k: float(x) for k, x in make_eval_step()(state, te).items()}
    m = {k: float(x) for k, x in make_train_step()(state, tb).items()}
    return m, _flat(convert.to_flax_variables(net.state_dict())), ev


def _case(model_kw, v, targets, train, eval_batch=None, **kw):
    return dict(model=model_kw, data=DATA,
                state_dict=convert.from_flax_variables(v), targets=targets,
                opt=OPT, train=train, eval=eval_batch, **kw)


def _assert_step(label, got_m, got_vars, got_ev, want_m, want_vars,
                 want_ev):
    assert got_m["loss_sum"] == pytest.approx(float(want_m["loss_sum"]),
                                              abs=1e-4), label
    assert sorted(got_vars) == sorted(want_vars), label
    for path, a in got_vars.items():
        np.testing.assert_allclose(a, want_vars[path], atol=1e-5,
                                   err_msg=f"{label} {path}")
    assert got_ev["mae_sum"] == pytest.approx(want_ev["mae_sum"],
                                              rel=1e-5), label


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_steps_match_jax_and_the_unsharded_step(n_shards, tmp_path):
    """One train step and one eval step, dense and COO, on G ranks against
    the JAX ``make_edge_parallel_*`` steps and the port's unsharded
    step; the ranks bit-equal to each other, each staging a part of the
    edge bytes. At G = 2 also: a NaN batch skipped by every rank (the
    run equals one without it), and the bf16 sharded steps, COO and
    dense, against the bf16 unsharded ones."""
    from cgnn_tpu_torch.resilience.faultinject import poison_nan

    cases, want = [], {}
    for layout in ("dense", "coo"):
        jb, je, tb, te, targets, kw, jkw = _layout_case(layout, n_shards)
        v = _variables(JNet(**jkw), jb)
        want[layout] = (_jax_sharded(layout, n_shards, jb, je, jkw, v,
                                     targets),
                        _port_unsharded(kw, v, targets, tb, te),
                        tep.edge_nbytes(tb))
        cases.append(_case(kw, v, targets, [tb], te))
    if n_shards == 2:
        jb, je, tb, te, targets, kw, jkw = _layout_case("dense", 2)
        v = _variables(JNet(**jkw), jb)
        second = tep.prepare_dense_sharded(tb, 2)
        cases.append(_case(kw, v, targets, [poison_nan(tb), second],
                           guard=True))
        cases.append(_case(kw, v, targets, [second], guard=True))
        for layout in ("coo", "dense"):
            jb, je, tb, te, targets, kw, jkw = _layout_case(layout, 2)
            v = _variables(JNet(**jkw), jb)
            want[f"bf16_{layout}"] = (
                _port_unsharded(kw, v, targets, tb, te, dtype="bfloat16"),
                _flat(v))
            cases.append(_case(dict(kw, dtype="bfloat16"), v, targets,
                               [tb], te))
    outs = _run_ranks(tmp_path, {"mode": "sharded", "cases": cases},
                      world=n_shards, shards=n_shards)
    for r in range(1, n_shards):
        for a, b in zip(outs[0], outs[r]):
            assert a["digest"] == b["digest"]
            assert a["metrics"] == b["metrics"] and a["eval"] == b["eval"]
    for i, layout in enumerate(("dense", "coo")):
        (jm, jvars, jev), (pm, pvars, pev), full = want[layout]
        got = outs[0][i]
        gvars = _flat(convert.to_flax_variables(got["state"]))
        _assert_step(f"{layout} vs JAX", got["metrics"][0], gvars,
                     got["eval"], jm, jvars, jev)
        _assert_step(f"{layout} vs unsharded", got["metrics"][0], gvars,
                     got["eval"], pm, pvars, pev)
        for out in outs:
            assert out[i]["edge_bytes"] <= full / n_shards * 1.2, layout
    if n_shards == 2:
        poisoned, clean = outs[0][2], outs[0][3]
        assert [m["guard_skipped_sum"] for m in poisoned["metrics"]] == [
            1.0, 0.0]
        assert poisoned["digest"] == clean["digest"] == outs[1][2]["digest"]
        for i, layout in ((4, "coo"), (5, "dense")):
            (pm, pvars, pev), before = want[f"bf16_{layout}"]
            got = outs[0][i]
            assert abs(got["metrics"][0]["loss_sum"] - pm["loss_sum"]) <= \
                BF16_TOL * abs(pm["loss_sum"]), layout
            assert abs(got["eval"]["mae_sum"] - pev["mae_sum"]) <= \
                BF16_TOL * abs(pev["mae_sum"]), layout
            gvars = _flat(convert.to_flax_variables(got["state"]))
            # tests/test_torch_bf16.py's rules: the parameters' update held
            # to the reference update's largest |entry| over the whole
            # tree, each running statistic to its own largest |entry|
            params = [p for p in gvars if p.startswith("params/")]
            scale = max(np.abs(pvars[p] - before[p]).max() for p in params)
            gap = max(np.abs(gvars[p] - pvars[p]).max() for p in params)
            assert gap <= BF16_TOL * scale, (layout, gap / scale)
            for path in set(gvars) - set(params):
                assert np.abs(gvars[path] - pvars[path]).max() <= \
                    BF16_TOL * np.abs(pvars[path]).max(), (layout, path)


def test_force_data_parallel_step_matches_jax(tmp_path):
    """The force task's data-parallel step on two ranks, one frame batch
    each, against the JAX force step built with ``axis_name='data'`` on a
    2-device mesh: the summed metric sums and the update."""
    from cgnn_tpu.train.force_step import make_force_train_step as jforce

    graphs = jload_trajectory(16, FeaturizeConfig(**DATA), seed=4,
                              num_atoms=6)
    fields = [f.name for f in dataclasses.fields(tgraph.CrystalGraph)]
    tg = [tgraph.CrystalGraph(**{f: getattr(g, f) for f in fields
                                 if hasattr(g, f)}) for g in graphs]
    nc, _ = jgraph.capacities_for(graphs, 8, dense_m=M, snug=True)
    nc += 8
    jbs = list(jgraph.batch_iterator(graphs, 8, nc, nc * M, dense_m=M))
    tbs = list(tgraph.batch_iterator(tg, 8, nc, nc * M, dense_m=M))
    assert len(jbs) == len(tbs) == 2
    targets = np.stack([g.target for g in graphs])
    force_kw = dict(atom_fea_len=16, n_conv=2, h_fea_len=24)
    jnet = JForceField(**force_kw, dmax=DATA["radius"], dense_m=M)
    v = jax.tree_util.tree_map(np.array, jnet.init(jax.random.key(1),
                                                   jbs[0]))
    opt = dict(optim="sgd", lr=0.01, momentum=0.9, lr_milestones=[100])
    tx = jmake_optimizer(**opt)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"], batch_stats={},
        opt_state=tx.init(v["params"]), normalizer=JNormalizer.fit(targets),
        rng=jax.random.key(0), apply_fn=jnet.apply, tx=tx)
    mesh = make_mesh(2)
    step = jpar.make_parallel_train_step(mesh, inner_step=jforce(
        axis_name="data"))
    jstate, jm = step(jpar.replicate_state(jstate, mesh),
                      jpar.shard_leading_axis(jpar.stack_batches(jbs), mesh))
    jm = {k: float(x) for k, x in jax.device_get(jm).items()}
    outs = _run_ranks(tmp_path, {"mode": "force", "cases": [dict(
        model=dict(force_kw, dense_m=M), data=DATA, task="force",
        state_dict=convert.from_flax_variables(v), targets=targets,
        opt=opt, train=tbs)]}, world=2, shards=1)
    assert outs[0]["metrics"] == outs[1]["metrics"]
    for k in ("loss_sum", "mae_sum", "count", "force_mae_sum",
              "force_mae_count"):
        assert outs[0]["metrics"][k] == pytest.approx(jm[k], rel=1e-4), k
    before = convert.flatten({"params": v["params"]})
    after_j = convert.flatten(jax.tree_util.tree_map(
        np.asarray, {"params": jax.device_get(jstate.params)}))
    after_t = convert.flatten(convert.to_flax_variables(outs[0]["params"]))
    for r in (0, 1):
        assert all(torch.equal(outs[r]["params"][k], outs[0]["params"][k])
                   for k in outs[0]["params"])
    for path, b in before.items():
        want = after_j[path].astype(np.float64) - b
        got = after_t[path].astype(np.float64) - b
        gap = np.abs(got - want).max()
        assert gap <= GRAD_REL * np.abs(want).max() + opt["lr"] * GRAD_ABS, \
            (path, gap)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

ENTRY = ["--device", "cpu", "--synthetic", "48", "-b", "8",
         "--atom-fea-len", "16", "--h-fea-len", "16", "--n-conv", "2",
         "--max-num-nbr", "8", "--radius", "5", "--print-freq", "0"]


def _entry_ranks(tmp_path, label, argv, world, env=None):
    port = _free_port()
    procs = []
    for r in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cgnn_tpu_torch.train", *ENTRY, *argv,
             "--ckpt-dir", str(tmp_path / f"{label}-ck{r}"),
             "--out-dir", str(tmp_path / f"{label}-out{r}")],
            cwd=tmp_path, env=_child_env(
                **dist.env_for(f"localhost:{port}", world, r), **(env or {})),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = _wait_all(procs, RANK_TIMEOUT_S)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{label} rank {r} exited " \
                                  f"{p.returncode}:\n{log}"
    return logs


def _summary(log):
    return json.loads(next(line for line in log.splitlines()
                           if line.startswith("train: "))[7:])


def test_fit_data_x_graph_matches_the_plain_data_parallel_fit(tmp_path):
    """A 2-epoch fit on D=2 x G=2 ranks against the plain data-parallel
    fit on 2 ranks with the same capacities, seed and weights; the
    graph ranks bit-equal, process 0 the only writer."""
    caps = ["--node-cap", "96", "--epochs", "2", "--data-parallel"]
    sharded = _entry_ranks(tmp_path, "dg", [*caps, "--graph-shards", "2"],
                           world=4)
    plain = _entry_ranks(tmp_path, "dp", caps, world=2)
    s = [_summary(log) for log in sharded]
    p = [_summary(log) for log in plain]
    assert all(x["dp"]["digests"] == s[0]["dp"]["digests"] for x in s)
    assert [x["dp"]["data_index"] for x in s] == [0, 0, 1, 1]
    assert s[0]["graphs"]["captures"] == 0
    assert "[dp x2 * graph x2]" in sharded[0]
    for key in ("train_loss", "val_metric"):
        np.testing.assert_allclose(s[0][key], p[0][key], rtol=1e-4,
                                   err_msg=key)
    assert s[0]["train_steps"] == p[0]["train_steps"]
    from cgnn_tpu_torch.convert import load_params

    got, _ = load_params(str(tmp_path / "dg-out0" / "params.npz"),
                         str(tmp_path / "dg-out0" / "meta.json"))
    want, _ = load_params(str(tmp_path / "dp-out0" / "params.npz"),
                          str(tmp_path / "dp-out0" / "meta.json"))
    for path, a in convert.flatten(got).items():
        np.testing.assert_allclose(a, convert.flatten(want)[path],
                                   atol=1e-4, err_msg=path)
    for r in (1, 2, 3):
        assert not (tmp_path / f"dg-out{r}").exists()
        assert not (tmp_path / f"dg-ck{r}").exists()


def test_nan_batch_skipped_on_every_rank_under_graph_shards(tmp_path):
    logs = _entry_ranks(tmp_path, "nan", ["--graph-shards", "2",
                                          "--epochs", "1"], world=2,
                        env={"CGNN_TPU_FAULTS": "nan_batch=1"})
    s0, s1 = map(_summary, logs)
    assert s0["guard_skipped"] == s1["guard_skipped"] == [1]
    assert s0["dp"]["digests"] == s1["dp"]["digests"]
    assert all(np.isfinite(v) for v in (s0["test"]["loss"],
                                        s0["test"]["mae"]))


def test_force_data_parallel_entry_point_trains(tmp_path):
    logs = _entry_ranks(tmp_path, "force", [
        "--task", "force", "--data-parallel", "--md-atoms", "6",
        "--optim", "Adam", "--lr", "0.002", "--epochs", "1",
        "--synthetic", "24"], world=2)
    s0, s1 = map(_summary, logs)
    assert s0["dp"]["digests"] == s1["dp"]["digests"]
    assert np.isfinite(s0["test"]["force_mae"])
    assert "[dp x2]" in logs[0]


def test_launch_local_graph_shards_trains_and_process_0_writes(
        tmp_path, monkeypatch, capfd):
    from cgnn_tpu_torch.predict import main as predict_main
    from cgnn_tpu_torch.train.__main__ import launch_local

    for k in [k for k in os.environ if k.startswith("CGNN_TPU_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(tmp_path)
    rc = launch_local([*ENTRY, "--graph-shards", "2", "--aggregation",
                       "pallas", "--epochs", "1", "--ckpt-dir",
                       str(tmp_path / "ck"), "--out-dir",
                       str(tmp_path / "out")], 2, timeout=RANK_TIMEOUT_S)
    out = capfd.readouterr().out
    assert rc == 0, out
    assert "[dp x1 * graph x2]" in out
    digests = dict(re.findall(
        r"dp: process (\d)/2 epoch 0 digest ([0-9a-f]{64})", out))
    assert sorted(digests) == ["0", "1"] and len(set(digests.values())) == 1
    assert "process 1 leaves --out-dir to process 0" in out
    assert (tmp_path / "out" / "params.npz").exists()
    assert predict_main([str(tmp_path / "ck"), "--device", "cpu",
                         "--synthetic", "8", "--out",
                         str(tmp_path / "p.csv")]) == 0
    rows = (tmp_path / "p.csv").read_text().splitlines()
    assert len(rows) == 8 and all(np.isfinite(float(r.split(",")[-1]))
                                  for r in rows)


REFUSALS = {
    "force": (["--task", "force"],
              "--graph-shards is not supported for --task force"),
    "fused_epilogue": (["--fused-epilogue", "xla"], "no graph sharding"),
    "cgconv_impl": (["--cgconv-impl", "xla"], "no graph sharding"),
    "buckets_coo": (["--aggregation", "pallas", "--buckets", "2"],
                    "--buckets with --graph-shards requires the dense"),
    "compact_on": (["--compact-staging", "on"],
                   "--compact-staging on is not yet supported"),
    "indivisible": (["--graph-shards", "3"], "do not make"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_graph_shards_refusals_exit_2(case, monkeypatch, capsys):
    from cgnn_tpu_torch.train.__main__ import main

    argv, reason = REFUSALS[case]
    for k, v in dist.env_for("localhost:1", 2, 1).items():
        monkeypatch.setenv(k, v)
    assert main(["--device", "cpu", "--synthetic", "8", "--graph-shards",
                 "2", *argv]) == 2
    assert reason in capsys.readouterr().err
    assert not dist.active()


def test_invariants_hold_per_shard_mappings_as_jax_does():
    _, jb, tb = _dense_pair(2)
    jp = jep.prepare_dense_sharded(jb, 2)
    tp = tep.prepare_dense_sharded(tb, 2)
    jinv.check_batch(jp)
    tinv.check_batch(tp)
    bad = tp.over_mask.clone()
    bad[0, -1] = 1  # a padding overflow entry listed as real
    with pytest.raises(tinv.BatchInvariantError):
        tinv.check_batch(dataclasses.replace(tp, over_mask=bad))
