"""The port's batch invariant checks (``cgnn_tpu_torch/data/invariants.py``)
against the JAX package's (``cgnn_tpu/data/invariants.py``):

- tests/test_invariants.py's dense batch and its corruptions, made the
  same way in both packages (the port's batch is packed bit-equal to the
  JAX one): the same batches pass and the same raise, with messages
  that match the same pattern; likewise for more corruptions, for
  compact batches (data/compact.py), and for stacked batches (a row
  corrupted, an all-padding row in a training stack);
- the port's own COO transpose fields (``nbr_order``, ``nbr_offsets``,
  ``center_offsets``): a clean COO training batch passes, each field
  corrupted raises naming it;
- the switch: the iterators, bulk predict's packers and the epoch
  driver check what they pack or stage only while the checks are on;
- the cache: a corrupted or truncated cache fails its spot check on
  load; the train entry point with ``--check-invariants`` on such a
  cache exits non-zero naming the check.

The port's checks are switched on by a fixture of this file, which
restores their state after each test (tests/conftest.py switches on the
JAX package's alone).
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from cgnn_tpu.data import compact as jcompact
from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.data import invariants as jinv
from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu.parallel.data_parallel import empty_batch_like, stack_batches
from cgnn_tpu_torch.data import compact as tcompact
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.data import invariants as tinv
from cgnn_tpu_torch.data.cache import load_graph_cache, save_graph_cache
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = FeaturizeConfig(radius=5.0, max_num_nbr=8)
M = 8


@pytest.fixture(autouse=True)
def checks_on():
    was = tinv.enabled()
    tinv.enable(True)
    yield
    tinv.enable(was)


def _port(g) -> tgraph.CrystalGraph:
    return tgraph.CrystalGraph(
        atom_fea=g.atom_fea, edge_fea=g.edge_fea, centers=g.centers,
        neighbors=g.neighbors, target=g.target, cif_id=g.cif_id,
        target_mask=g.target_mask, distances=g.distances)


@pytest.fixture(scope="module")
def graphs():
    jg = load_synthetic(24, CFG, seed=9, max_atoms=6)
    return jg, [_port(g) for g in jg]


@pytest.fixture(scope="module")
def batches(graphs):
    """(JAX, port) dense training batch: tests/test_invariants.py's."""
    jg, tg = graphs
    nc, ec = jgraph.capacities_for(jg, 8, dense_m=M, snug=True)
    jb = next(jgraph.batch_iterator(jg, 8, nc, ec, dense_m=M, snug=True))
    tb = next(tgraph.batch_iterator(tg, 8, nc, ec, dense_m=M, snug=True))
    return jb, tb


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _replace(jb, tb, **fields):
    """Both batches with the same numpy arrays in ``fields``."""
    return (jb.replace(**fields),
            dataclasses.replace(tb, **{k: _t(v) for k, v in fields.items()}))


def _outcome(check, batch, *args, **kw):
    """None when ``check`` passes, else its BatchInvariantError text."""
    try:
        check(batch, *args, **kw)
    except AssertionError as e:
        return str(e) or type(e).__name__
    return None


# name -> (numpy corruption of the JAX batch's fields, pattern)
DENSE = {
    "clean": (lambda b: {}, None),
    "centers_flipped": (lambda b: {"centers": np.flip(
        np.asarray(b.centers)).copy()}, "non-decreasing|ownership"),
    "neighbors_out_of_range": (lambda b: {"neighbors": np.full_like(
        np.asarray(b.neighbors), b.node_capacity + 3)},
        "out of node-slot range"),
    "edge_mask_inverted": (lambda b: {"edge_mask": 1.0 - np.asarray(
        b.edge_mask)}, "padding|prefix|features"),
    "first_node_padding": (lambda b: {"node_mask": np.concatenate(
        [[0.0], np.asarray(b.node_mask)[1:]]).astype(np.float32)},
        "prefix|padding node"),
    "graph_mask_half": (lambda b: {"graph_mask": np.asarray(
        b.graph_mask) * np.float32(0.5)}, "outside"),
    "in_slots_zeroed": (lambda b: {"in_slots": np.zeros_like(
        np.asarray(b.in_slots))}, "transpose|twice"),
    "wrong_owner": (lambda b: {"centers": _owner_broken(b)},
                    "non-decreasing|ownership"),
    "padding_edge_features": (lambda b: {"edges": _padding_features(b)},
                              "nonzero features"),
    "padding_node_graph": (lambda b: {"node_graph": _padding_graph(b)},
                           "graph slot 0"),
    "over_nodes_unsorted": (lambda b: {"over_nodes": np.flip(
        np.asarray(b.over_nodes)).copy()}, "over_nodes|transpose"),
    "in_mask_drops_one": (lambda b: {"in_mask": _drop_first(b)},
                          "lists .* edges"),
}


def _owner_broken(b):
    c = np.asarray(b.centers).copy()
    c[10] = (10 // M) + 1
    return c


def _padding_features(b):
    e = np.asarray(b.edges).copy().reshape(-1, np.shape(b.edges)[-1])
    pad = np.flatnonzero(np.asarray(b.edge_mask) == 0)[0]
    e[pad, 0] = 1.0
    return e.reshape(np.shape(b.edges))


def _padding_graph(b):
    g = np.asarray(b.node_graph).copy()
    g[-1] = 1
    return g


def _drop_first(b):
    m = np.asarray(b.in_mask).copy()
    r, c = np.argwhere(m > 0)[0]
    m[r, c] = 0
    return m


@pytest.mark.parametrize("case", sorted(DENSE))
def test_dense_corruptions_raise_as_in_jax(batches, case):
    jb, tb = batches
    corrupt, pattern = DENSE[case]
    jb, tb = _replace(jb, tb, **corrupt(jb))
    want = _outcome(jinv.check_batch, jb, dense_m=M)
    got = _outcome(tinv.check_batch, tb, dense_m=M)
    assert (got is None) == (want is None) == (pattern is None), (got, want)
    if pattern is not None:
        assert re.search(pattern, got) and re.search(pattern, want)
        with pytest.raises(tinv.BatchInvariantError):
            tinv.check_batch(tb, dense_m=M)
    # the dense width is read off [N, M, G] edges when not given
    assert (_outcome(tinv.check_batch, tb) is None) == (
        _outcome(jinv.check_batch, jb) is None)


@pytest.fixture(scope="module")
def compact_batches(graphs):
    jg, tg = graphs
    jspec = jcompact.CompactSpec.build(jg, CFG.gdf(), dense_m=M)
    tspec = tcompact.CompactSpec.build(tg, CFG.gdf(), dense_m=M)
    nc, ec = jgraph.capacities_for(jg, 8, dense_m=M, snug=True)
    jb = next(jgraph.batch_iterator(jg, 8, nc, ec, dense_m=M, snug=True,
                                    pack_fn=jcompact.compact_pack_fn(jspec)))
    tb = next(tgraph.batch_iterator(tg, 8, nc, ec, dense_m=M, snug=True,
                                    pack_fn=tcompact.compact_pack_fn(tspec)))
    return jb, tb


COMPACT = {
    "clean": lambda b: {},
    "negative_atom": lambda b: {"atom_idx": np.asarray(b.atom_idx) - 100},
    "padding_distance": lambda b: {"distances": _pad_distance(b)},
    "neighbors_out_of_range": lambda b: {"neighbors": np.full_like(
        np.asarray(b.neighbors), np.shape(b.distances)[0])},
    "padding_node_owns_edge": lambda b: {"edge_mask": _pad_owner(b)},
    "nan_distance": lambda b: {"distances": _nan_distance(b)},
    "in_slots_zeroed": lambda b: {"in_slots": np.zeros_like(
        np.asarray(b.in_slots))},
}


def _pad_distance(b):
    d = np.asarray(b.distances).copy()
    d[np.asarray(b.edge_mask) == 0] = 1.5
    return d


def _pad_owner(b):
    m = np.asarray(b.edge_mask).copy()
    m[-1, 0] = 1
    return m


def _nan_distance(b):
    d = np.asarray(b.distances).copy()
    d[0, 0] = np.nan
    return d


@pytest.mark.parametrize("case", sorted(COMPACT))
def test_compact_corruptions_raise_as_in_jax(compact_batches, case):
    jb, tb = compact_batches
    jb, tb = _replace(jb, tb, **COMPACT[case](jb))
    want = _outcome(jinv.check_compact_batch, jb, dense_m=M)
    got = _outcome(tinv.check_compact_batch, tb, dense_m=M)
    assert (got is None) == (want is None) == (case == "clean"), (got, want)
    assert (_outcome(tinv.maybe_check, tb, M) is None) == (want is None)
    # a compact batch packed with another M than asked
    assert _outcome(tinv.check_compact_batch, tb, dense_m=M + 1) \
        and _outcome(jinv.check_compact_batch, jb, dense_m=M + 1)


def _port_stack(batches):
    first = batches[0]
    return dataclasses.replace(first, **{
        f.name: torch.stack([getattr(b, f.name) for b in batches])
        for f in dataclasses.fields(first)
        if getattr(first, f.name) is not None})


def _port_empty_like(tb, jb):
    """The port's batch with JAX ``empty_batch_like``'s arrays."""
    e = empty_batch_like(jb)
    return dataclasses.replace(tb, **{
        f.name: _t(np.asarray(getattr(e, f.name)))
        for f in dataclasses.fields(tb)
        if getattr(tb, f.name) is not None and f.name not in
        tgraph.PORT_FIELDS})


@pytest.mark.parametrize("case", ["clean", "bad_row", "empty_row"])
@pytest.mark.parametrize("train", [False, True])
def test_stacked_batches_checked_row_by_row(batches, case, train):
    jb, tb = batches
    if case == "clean":
        jrows, trows = [jb, jb], [tb, tb]
    elif case == "bad_row":
        jbad, tbad = _replace(jb, tb, centers=np.flip(
            np.asarray(jb.centers)).copy())
        jrows, trows = [jb, jbad], [tb, tbad]
    else:
        jrows, trows = [jb, empty_batch_like(jb)], [tb,
                                                     _port_empty_like(tb, jb)]
    want = _outcome(jinv.check_any, stack_batches(jrows), train=train)
    got = _outcome(tinv.check_any, _port_stack(trows), train=train)
    assert (got is None) == (want is None), (got, want)
    expect_raise = case == "bad_row" or (case == "empty_row" and train)
    assert (got is not None) == expect_raise
    if case == "empty_row" and train:
        assert "eval-only" in got and "eval-only" in want


@pytest.fixture(scope="module")
def coo_batch(graphs):
    _, tg = graphs
    nc, ec = tgraph.capacities_for(tg, 8)
    b = next(tgraph.batch_iterator(tg, 8, nc, ec, snug=True))
    assert b.nbr_order is not None
    return b


@pytest.mark.parametrize("field", [None, "nbr_order", "nbr_offsets",
                                   "center_offsets"])
def test_coo_transpose_fields_checked(coo_batch, field):
    """A COO training batch's fixed-order gathers' transpose must be the
    stable CSR transpose of its neighbors and centers."""
    if field is None:
        assert tinv.check_batch(coo_batch) is coo_batch
        return
    bad = getattr(coo_batch, field).clone()
    if field == "nbr_order":
        # swap two slots of different neighbors
        nb = coo_batch.neighbors.numpy()
        i = int(np.flatnonzero(nb != nb[int(bad[0])])[0])
        j = int(np.flatnonzero(bad.numpy() == i)[0])
        bad[0], bad[j] = bad[j].clone(), bad[0].clone()
    else:
        bad[1] += 1
    with pytest.raises(tinv.BatchInvariantError, match=field):
        tinv.check_batch(dataclasses.replace(coo_batch, **{field: bad}))


def test_checks_refuse_card_tensors(batches):
    """The checks read host copies only: a tensor elsewhere is refused
    before any copy (on the CPU a 'meta' tensor stands in for the card's)."""
    _, tb = batches
    with pytest.raises(ValueError, match="host copies"):
        tinv.check_batch(dataclasses.replace(
            tb, centers=torch.empty(tb.centers.shape, device="meta",
                                    dtype=torch.int32)))


def _corrupting(pack):
    """A packer whose batches carry out-of-range neighbors."""
    def fn(*a, **k):
        b = pack(*a, **k)
        return dataclasses.replace(b, neighbors=torch.full_like(
            b.neighbors, b.node_capacity + 3))
    return fn


@pytest.mark.parametrize("bucketed", [False, True])
def test_the_switch_gates_the_iterators(graphs, bucketed):
    _, tg = graphs
    nc, ec = tgraph.capacities_for(tg, 4, dense_m=M)
    pack = _corrupting(tgraph.pack_graphs)

    def run():
        if bucketed:
            return list(tgraph.bucketed_batch_iterator(
                tg, 4, 2, dense_m=M, pack_fn=pack, snug=False))
        return list(tgraph.batch_iterator(tg, 4, nc, ec, dense_m=M,
                                          snug=True, pack_fn=pack))

    with pytest.raises(tinv.BatchInvariantError, match="out of node-slot"):
        run()
    tinv.enable(False)
    assert len(run()) >= 2


def test_bulk_predict_packers_check(graphs, monkeypatch):
    """Bulk predict's packers (on threads too) check what they pack."""
    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.train import infer
    from cgnn_tpu_torch.train.state import init_train_state
    from cgnn_tpu_torch.train.step import InferenceState

    _, tg = graphs
    st, _, _ = init_train_state(
        ModelConfig(atom_fea_len=8, n_conv=1, h_fea_len=8, dense_m=M),
        DataConfig(radius=5.0, max_num_nbr=M), tg, batch_size=8,
        device="cpu")
    state = InferenceState(st.model, st.normalizer)
    clean, _ = infer.run_fast_inference(state, tg, 8, buckets=2, dense_m=M)
    monkeypatch.setattr(infer, "pack_graphs", _corrupting(infer.pack_graphs))
    for workers in (0, 2):
        with pytest.raises(tinv.BatchInvariantError):
            infer.run_fast_inference(state, tg, 8, buckets=2, dense_m=M,
                                     pack_workers=workers)
    # unchecked, the same batches reach the model, which fails elsewhere
    tinv.enable(False)
    with pytest.raises(IndexError):
        infer.run_fast_inference(state, tg, 8, buckets=2, dense_m=M)
    assert np.isfinite(clean).all()


def test_epoch_driver_refuses_a_corrupted_batch(batches):
    """ScanEpochDriver checks every input batch before staging it."""
    from cgnn_tpu_torch.train.loop import ScanEpochDriver

    _, tb = batches
    bad = dataclasses.replace(tb, neighbors=torch.full_like(
        tb.neighbors, tb.node_capacity + 3))

    def drive(train, val):
        return ScanEpochDriver(lambda s, b: {}, lambda s, b: {}, train, val,
                               np.random.default_rng(0), device="cpu")

    with pytest.raises(tinv.BatchInvariantError):
        drive([tb, bad], [])
    with pytest.raises(tinv.BatchInvariantError):
        drive([tb], [bad])
    # an all-padding training batch is eval-only
    empty = dataclasses.replace(
        tb, node_mask=torch.zeros_like(tb.node_mask),
        edge_mask=torch.zeros_like(tb.edge_mask),
        graph_mask=torch.zeros_like(tb.graph_mask),
        nodes=torch.zeros_like(tb.nodes), edges=torch.zeros_like(tb.edges),
        node_graph=torch.zeros_like(tb.node_graph),
        in_mask=torch.zeros_like(tb.in_mask),
        over_mask=torch.zeros_like(tb.over_mask))
    drive([tb], [empty])
    tinv.enable(False)
    drive([tb, bad], [bad])


def _corrupt_cache(path, how):
    with np.load(path) as z:
        payload = {k: np.asarray(z[k]).copy() for k in z.files}
    if how == "neighbors":
        # the spot check always samples graph 0
        payload["neighbors"][: int(payload["edge_counts"][0])] = 10**6
    else:  # truncated: the edge features cut short in the last graph
        cut = int(payload["edge_counts"][-1]) // 2
        payload["edge_fea"] = payload["edge_fea"][:-cut]
    with open(path, "wb") as f:
        np.savez(f, **payload)


@pytest.mark.parametrize("how,match", [("neighbors", "out of range"),
                                       ("truncated", "row counts")])
def test_cache_spot_check(graphs, tmp_path, how, match):
    jg, tg = graphs
    path = str(tmp_path / "cache.npz")
    save_graph_cache(tg[:6], path)
    assert len(load_graph_cache(path)) == 6
    _corrupt_cache(path, how)
    with pytest.raises(tinv.BatchInvariantError, match=match):
        load_graph_cache(path)
    if how == "neighbors":  # the JAX loader raises on the same file
        from cgnn_tpu.data.cache import load_graph_cache as jload

        with pytest.raises(jinv.BatchInvariantError, match=match):
            jload(path)
    tinv.enable(False)
    assert len(load_graph_cache(path)) == 6


def test_entry_point_exits_nonzero_naming_the_check(graphs, tmp_path):
    """``--check-invariants`` on a corrupted cache: a non-zero exit whose
    error names the broken invariant; the same run without the flag does
    not check the cache."""
    _, tg = graphs
    path = str(tmp_path / "bad.npz")
    save_graph_cache(tg, path)
    _corrupt_cache(path, "neighbors")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cmd = [sys.executable, "-m", "cgnn_tpu_torch.train", "--device", "cpu",
           "--cache", path, "--epochs", "1", "-b", "8", "--radius", "5",
           "--max-num-nbr", "8", "--ckpt-dir", str(tmp_path / "ck"),
           "--out-dir", str(tmp_path / "out"), "--check-invariants"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "BatchInvariantError" in out.stderr
    assert "edge endpoints out of range" in out.stderr
