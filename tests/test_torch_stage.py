"""Staging for the port's training drivers against the JAX package's:
``bucketed_batch_iterator`` and ``batch_shape_key`` bit-equal in every
array (transpose slots included, the generator's draws in the JAX order),
full and compact; ``staged_nbytes`` equal on the same batches; and
``PackOncePlan``'s epoch orders equal."""

import numpy as np
import pytest
import torch

from cgnn_tpu.data import compact as jcompact
from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic_mp
from cgnn_tpu.train import loop as jloop
from cgnn_tpu_torch.data import compact as tcompact
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.train import loop as tloop

CFG = FeaturizeConfig(radius=6.0, max_num_nbr=12)
M = 12


def _port(g) -> tgraph.CrystalGraph:
    return tgraph.CrystalGraph(
        atom_fea=g.atom_fea, edge_fea=g.edge_fea, centers=g.centers,
        neighbors=g.neighbors, target=g.target, cif_id=g.cif_id,
        target_mask=g.target_mask, distances=g.distances)


@pytest.fixture(scope="module")
def data():
    jg = load_synthetic_mp(60, CFG, seed=2)
    return jg, [_port(g) for g in jg]


def _assert_equal(got, want):
    for field, a in got.numpy().items():
        if field in tgraph.PORT_FIELDS:
            continue  # the port's COO transpose (tests/test_torch_coo.py)
        b = getattr(want, field)
        if a is None:
            assert b is None, field
            continue
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def _specs(jg, tg):
    return (jcompact.CompactSpec.build(jg, CFG.gdf(), dense_m=M),
            tcompact.CompactSpec.build(tg, CFG.gdf(), dense_m=M))


@pytest.mark.parametrize("case,form", [
    ("train", "full"), ("eval", "full"), ("coo", "full"),
    ("fixed_order", "full"), ("train", "compact"), ("eval", "compact"),
    ("fixed_order", "compact")])  # compact staging is dense-only
@pytest.mark.parametrize("buckets", [1, 2, 3])
def test_bucketed_batches_bit_equal(data, buckets, case, form):
    jg, tg = data
    kw = {"train": dict(shuffle=True), "eval": dict(in_cap=0),
          "coo": dict(shuffle=True), "fixed_order": {}}[case]
    dense_m = None if case == "coo" else M
    jkw, tkw = {}, {}
    if form == "compact":
        jspec, tspec = _specs(jg, tg)
        jkw["pack_fn"] = jcompact.compact_pack_fn(jspec)
        tkw["pack_fn"] = tcompact.compact_pack_fn(tspec)
    want = list(jgraph.bucketed_batch_iterator(
        jg, 8, buckets, rng=np.random.default_rng(4), dense_m=dense_m,
        snug=True, **kw, **jkw))
    jrng = np.random.default_rng(4)
    list(jgraph.bucketed_batch_iterator(jg, 8, buckets, rng=jrng,
                                        dense_m=dense_m, snug=True, **kw,
                                        **jkw))
    trng = np.random.default_rng(4)
    got = list(tgraph.bucketed_batch_iterator(tg, 8, buckets, rng=trng,
                                              dense_m=dense_m, **kw, **tkw))
    assert len(got) == len(want) > buckets
    for a, b in zip(got, want):
        _assert_equal(a, b)
        assert tgraph.batch_shape_key(a) == jgraph.batch_shape_key(b)
    assert len({tgraph.batch_shape_key(b) for b in got}) <= buckets
    # the generators end in the same state: the draws came in one order
    assert trng.bit_generator.state == jrng.bit_generator.state
    # the port's COO training batches also stage their gathers' transpose
    extra = sum(t.nbytes for b in got for f in tgraph.PORT_FIELDS
                if (t := getattr(b, f, None)) is not None)
    assert (extra > 0) == (case == "coo")
    assert tloop.staged_nbytes(got) == jloop.staged_nbytes(want) + extra
    if case == "train" and dense_m:
        assert got[0].in_slots is not None and got[0].over_slots is not None
    if case == "eval":
        assert got[0].in_slots is None


def test_single_bucket_is_batch_iterator(data):
    """One bucket: the batch iterator's batches (the per-step loop's)."""
    _, tg = data
    nc, ec = tgraph.capacities_for(tg, 8, dense_m=M)
    a = list(tgraph.bucketed_batch_iterator(
        tg, 8, 1, shuffle=True, rng=np.random.default_rng(1), dense_m=M))
    b = list(tgraph.batch_iterator(tg, 8, nc, ec, shuffle=True,
                                   rng=np.random.default_rng(1), dense_m=M,
                                   snug=True))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k, v in x.numpy().items():
            w = y.numpy()[k]
            assert (v is None and w is None) or np.array_equal(v, w), k


def test_ladder_packing_is_refused(data):
    """Ladder packing was refused here until it was ported; now its
    bucketed batches are the JAX package's, bit for bit (the name is
    kept: tests/test_torch_ladder.py holds the rest of the ladder)."""
    jg, tg = data
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    want = list(jgraph.bucketed_batch_iterator(
        jg, 8, 2, shuffle=True, rng=jrng, dense_m=M, snug=False))
    got = list(tgraph.bucketed_batch_iterator(
        tg, 8, 2, shuffle=True, rng=trng, dense_m=M, snug=False))
    assert len(got) == len(want) > 2
    for a, b in zip(got, want):
        _assert_equal(a, b)
    assert trng.bit_generator.state == jrng.bit_generator.state


@pytest.mark.parametrize("device_resident", [False, True])
def test_pack_once_plan_orders_equal(device_resident):
    """Five epochs of ``PackOncePlan`` over ten stand-in batches: the
    packing order first, then one permutation an epoch from the shared
    generator, equal to the JAX plan's; validation in packing order."""
    def make(n):
        return lambda: [torch.tensor([i]) for i in range(n)]

    jplan = jloop.PackOncePlan(make(10), make(3), np.random.default_rng(7),
                               device_resident=device_resident,
                               stage=lambda b: b + 100)
    tplan = tloop.PackOncePlan(make(10), make(3), np.random.default_rng(7),
                               device_resident=device_resident,
                               stage=lambda b: b + 100)
    for _ in range(5):
        jt, jv = jplan.epoch_iterators()
        tt, tv = tplan.epoch_iterators()
        assert [int(b) for b in tt] == [int(b) for b in jt]
        assert [int(b) for b in tv] == [int(b) for b in jv]


def test_staged_nbytes_and_budget(data):
    jg, tg = data
    nc, ec = jgraph.capacities_for(jg, 8, dense_m=M, snug=True)
    want = list(jgraph.batch_iterator(jg, 8, nc, ec, dense_m=M, snug=True))
    got = list(tgraph.batch_iterator(tg, 8, nc, ec, dense_m=M, snug=True))
    assert tloop.staged_nbytes(got) == jloop.staged_nbytes(want) > 0
    # off a card the budget is unknown and the fit check passes
    assert tloop.device_hbm_budget("cpu") is None
    assert tloop.check_device_resident_fit(10**15, device="cpu")
