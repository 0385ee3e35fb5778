"""Compact staging in the port (``cgnn_tpu_torch/data/compact.py``) against
the JAX package's on the same graphs: the vocabulary and ``pack_compact``
bit-equal; the port's expander against ``pack_graphs`` (indices, masks
and node rows bit-equal, edge features within the reference's own bound,
atol 2e-6: the expander's ``exp`` is not numpy's) and against the JAX
``make_expander`` on the same CompactBatch; pooled buffers reused bit for
bit; the probes that refuse compact staging; bulk predict and the server
staging compactly, with the same answers as full staging and as the JAX
package's compact predict."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cgnn_tpu.data import compact as jcompact
from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.data.featurize import GaussianDistance
from cgnn_tpu.serve import shapes as jshapes
from cgnn_tpu.train import infer as jinfer
from cgnn_tpu_torch.data import compact as tcompact
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.serve import shapes as tshapes
from cgnn_tpu_torch.serve.server import InferenceServer, load_server
from cgnn_tpu_torch.train import infer as tinfer
from test_torch_predict import B, CFG, M, TOL, ckpt, models  # noqa: F401

EDGE_ATOL = 2e-6  # the reference's bound on expanded edge features
INT_FIELDS = ("atom_idx", "neighbors", "edge_mask", "node_graph",
              "node_mask", "in_slots", "in_mask", "over_slots", "over_nodes",
              "over_mask")
GB_EXACT = ("nodes", "centers", "neighbors", "node_graph", "node_mask",
            "edge_mask", "graph_mask", "targets", "target_mask", "in_slots",
            "in_mask", "over_slots", "over_nodes", "over_mask")


@pytest.fixture(scope="module")
def specs(models):
    """(JAX spec on the JAX graphs, port spec on the port's copies)."""
    return (jcompact.CompactSpec.build(models.graphs, CFG.gdf(), dense_m=M),
            tcompact.CompactSpec.build(models.port, CFG.gdf(), dense_m=M))


def _caps(graphs):
    nc, ec = jgraph.capacities_for(graphs, len(graphs), dense_m=M, snug=True)
    return nc, ec, len(graphs) + 3


def _transpose(kind, graphs):
    if kind == "two_tier":
        return dict(over_cap=jgraph.overflow_cap(graphs, len(graphs) + 3, M))
    if kind == "single_tier":
        return dict(in_cap=jgraph.in_degree_cap(graphs))
    return {}


def _jax_as_port(jb) -> tcompact.CompactBatch:
    return tcompact.CompactBatch(**{
        f.name: (None if (v := getattr(jb, f.name)) is None
                 else torch.from_numpy(np.array(v)))
        for f in dataclasses.fields(tcompact.CompactBatch)})


def test_vocabulary_matches_jax(specs):
    jspec, tspec = specs
    np.testing.assert_array_equal(tspec.vocab.table, jspec.vocab.table)
    np.testing.assert_array_equal(tspec.gauss_filter, jspec.gauss_filter)
    assert tspec.gauss_var == jspec.gauss_var and tspec.dense_m == M


@pytest.mark.parametrize("kind", ["forward", "two_tier", "single_tier"])
def test_pack_compact_bit_equal_to_jax(models, specs, kind):
    jspec, tspec = specs
    caps = _caps(models.graphs)
    kw = _transpose(kind, models.graphs)
    want = jcompact.pack_compact(models.graphs, *caps, jspec, **kw)
    got = tcompact.pack_compact(models.port, *caps, tspec, **kw)
    host = got.numpy()
    for f in dataclasses.fields(tcompact.CompactBatch):
        w = getattr(want, f.name)
        assert (w is None) == (host[f.name] is None), f.name
        if w is not None:
            assert host[f.name].dtype == np.asarray(w).dtype, f.name
            np.testing.assert_array_equal(host[f.name], w, err_msg=f.name)
    assert tcompact.compact_shape_key(got) == jcompact.compact_shape_key(want)


@pytest.mark.parametrize("kind", ["forward", "two_tier"])
def test_expander_reproduces_pack_graphs(models, specs, kind):
    _, tspec = specs
    caps = _caps(models.port)
    kw = _transpose(kind, models.port)
    full = tgraph.pack_graphs(models.port, *caps, dense_m=M, **kw)
    got = tcompact.make_expander(tspec, "cpu")(
        tcompact.pack_compact(models.port, *caps, tspec, **kw))
    for name in GB_EXACT:
        a, b = getattr(got, name), getattr(full, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            assert torch.equal(a, b), name
    assert got.edges.shape == full.edges.shape
    torch.testing.assert_close(got.edges, full.edges, rtol=0, atol=EDGE_ATOL)
    assert got.positions is None and got.lattices is None


def test_graph_packed_under_two_vocabularies(models):
    """A graph staged under one vocabulary, then under another (two
    servers of one process, each with its own calibration), expands to
    its own atom rows under each: the cached index is keyed to its
    vocabulary. (The JAX package caches it unkeyed: there the second
    vocabulary reads the first's indices, wrong rows.)"""
    graphs = [dataclasses.replace(g) for g in models.port]
    caps = _caps(graphs)
    # two vocabularies whose tables order the rows differently
    first = tcompact.CompactSpec.build(graphs[len(graphs) // 2:], CFG.gdf(),
                                       dense_m=M)
    second = tcompact.CompactSpec.build(graphs, CFG.gdf(), dense_m=M)
    assert not np.array_equal(first.vocab.table[:len(second.vocab.table)],
                              second.vocab.table[:len(first.vocab.table)])
    full = tgraph.pack_graphs(graphs, *caps, dense_m=M)
    for spec in (first, second, first):
        sub = [g for g in graphs if spec.graph_compactable(g)]
        got = tcompact.make_expander(spec, "cpu")(
            tcompact.pack_compact(sub, *caps, spec))
        want = tgraph.pack_graphs(sub, *caps, dense_m=M)
        assert len(sub) > 0 and torch.equal(got.nodes, want.nodes)
    assert full.nodes.shape[0] == caps[0]


def test_expander_matches_the_jax_expander(models, specs):
    """The same CompactBatch through both expanders: the JAX one
    multiplies by 1/var², the port divides by var² as ``pack_graphs``
    does, so edges agree within the bound and the rest bit for bit."""
    jspec, tspec = specs
    caps = _caps(models.graphs)
    jb = jcompact.pack_compact(models.graphs, *caps, jspec,
                               **_transpose("two_tier", models.graphs))
    want = jax.jit(jcompact.make_expander(jspec))(jb)
    got = tcompact.make_expander(tspec, "cpu")(_jax_as_port(jb))
    for name in GB_EXACT:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.edges.numpy(), np.asarray(want.edges),
                               rtol=0, atol=EDGE_ATOL)


def test_buffer_reuse_bit_identical(models, specs):
    """A buffer dirtied by a large batch, then packed with a small one,
    equals a fresh pack of the small one (the padding-tail zeroing)."""
    _, tspec = specs
    caps = _caps(models.port)
    buf = tcompact.alloc_compact_buffers(caps[0], M, caps[2], 1)
    tcompact.pack_compact(models.port, *caps, tspec, num_targets=1, out=buf)
    small = models.port[:5]
    fresh = tcompact.pack_compact(small, *caps, tspec, num_targets=1)
    reused = tcompact.pack_compact(small, *caps, tspec, num_targets=1,
                                   out=buf)
    assert reused is buf  # written in place, not copied
    for name, v in fresh.numpy().items():
        if v is not None:
            np.testing.assert_array_equal(reused.numpy()[name], v,
                                          err_msg=name)
    assert buf.atom_idx.data_ptr() == reused.atom_idx.data_ptr()


def test_out_buffer_refusals(models, specs):
    _, tspec = specs
    caps = _caps(models.port)
    wrong = tcompact.alloc_compact_buffers(caps[0] + 8, M, caps[2], 1)
    with pytest.raises(ValueError, match="geometry"):
        tcompact.pack_compact(models.port, *caps, tspec, num_targets=1,
                              out=wrong)
    ok = tcompact.alloc_compact_buffers(caps[0], M, caps[2], 1)
    with pytest.raises(ValueError, match="forward-only"):
        tcompact.pack_compact(models.port, *caps, tspec, num_targets=1,
                              **_transpose("two_tier", models.port), out=ok)


def test_compact_unsupported(models):
    rng = np.random.default_rng(0)
    cont = [dataclasses.replace(g, atom_fea=rng.standard_normal(
        g.atom_fea.shape).astype(np.float32)) for g in models.port]
    with pytest.raises(tcompact.CompactUnsupported, match="continuous"):
        tcompact.AtomVocab.build(cont, max_size=64)
    with pytest.raises(tcompact.CompactUnsupported, match="Gaussian"):
        tcompact.CompactSpec.build(models.port,
                                   GaussianDistance(0.0, 4.0, 0.5), dense_m=M)
    with pytest.raises(tcompact.CompactUnsupported, match="no raw distances"):
        tcompact.CompactSpec.build(
            [dataclasses.replace(g, distances=None) for g in models.port],
            CFG.gdf(), dense_m=M)
    with pytest.raises(tcompact.CompactUnsupported, match="empty"):
        tcompact.CompactSpec.build([], CFG.gdf(), dense_m=M)


def test_graph_compactable_probe(models):
    spec = tcompact.CompactSpec.build(models.port, CFG.gdf(), dense_m=M)
    g = models.port[0]
    assert spec.graph_compactable(g)
    assert not spec.graph_compactable(dataclasses.replace(g, distances=None))
    lying = dataclasses.replace(g, edge_fea=g.edge_fea + 0.25)
    assert not spec.graph_compactable(lying)
    alien = dataclasses.replace(g, atom_fea=np.full_like(g.atom_fea, 0.123))
    assert not spec.graph_compactable(alien)
    assert g._compact_ok == (spec._probe_token, True)
    spec2 = tcompact.CompactSpec.build(models.port, CFG.gdf(), dense_m=M)
    assert spec2.graph_compactable(g)  # probed again under spec2
    assert g._compact_ok[0] is spec2._probe_token


def test_batched_probe_matches_the_jax_probe(models):
    """One vectorized pass over a mixed batch gives each graph the JAX
    package's one-graph-at-a-time verdict (and caches it)."""
    jspec = jcompact.CompactSpec.build(models.graphs, CFG.gdf(), dense_m=M)
    tspec = tcompact.CompactSpec.build(models.port, CFG.gdf(), dense_m=M)

    def mixed(graphs):
        out = []
        for i, g in enumerate(graphs[:12]):
            if i % 4 == 1:
                g = dataclasses.replace(g, edge_fea=g.edge_fea + 0.25)
            elif i % 4 == 2:
                g = dataclasses.replace(g, distances=None)
            elif i == 3:
                g = dataclasses.replace(
                    g, atom_fea=np.full_like(g.atom_fea, 0.123))
            else:
                g = dataclasses.replace(g)
            out.append(g)
        return out

    want = [jspec.graph_compactable(g) for g in mixed(models.graphs)]
    batch = mixed(models.port)
    got = tspec.compactable_many(batch)
    assert got == want and True in got and False in got
    assert [g._compact_ok[1] for g in batch] == got
    assert tspec.compactable_many([]) == []


def test_compact_batch_is_small(models, specs):
    _, tspec = specs
    caps = _caps(models.port)
    full = tgraph.pack_graphs(models.port, *caps, dense_m=M)
    comp = tcompact.pack_compact(models.port, *caps, tspec)

    def nbytes(batch):
        return sum(v.nbytes for v in batch.numpy().values() if v is not None)

    assert nbytes(comp) < nbytes(full) / 8


def test_shape_set_packs_compact_like_jax(models, specs):
    jspec, tspec = specs
    jss = jshapes.plan_shape_set(models.graphs, B, rungs=2, dense_m=M,
                                 compact=jspec)
    tss = tshapes.plan_shape_set(models.port, B, rungs=2, dense_m=M,
                                 compact=tspec)
    assert [vars(s) for s in tss] == [vars(s) for s in jss]
    assert tss.to_meta()["compact"] and tss.compactable(models.port[0])
    for shape in tss:
        got = tss.pack(models.port[:3], shape=shape)
        want = jss.pack(models.graphs[:3], shape=shape)
        for name in INT_FIELDS + ("distances", "targets"):
            w = getattr(want, name)
            if w is not None:
                np.testing.assert_array_equal(getattr(got, name).numpy(), w)
        assert tss.buffer_key(shape) == jss.buffer_key(shape)
        buf = tss.buffer_factory(shape)()
        assert tss.pack(models.port[:3], shape=shape, out=buf) is buf
        assert isinstance(tss.pack_full(models.port[:3], shape=shape),
                          tgraph.GraphBatch)
    plain = tshapes.plan_shape_set(models.port, B, rungs=2, dense_m=M)
    assert plain.expander() is None and not plain.compactable(models.port[0])
    with pytest.raises(ValueError, match="compact staging"):
        plain.buffer_key(plain.largest)
    with pytest.raises(ValueError, match="dense layout"):
        tshapes.ShapeSet(list(tss), dense_m=None, compact=tspec)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("path", ["shape_set", "buckets"])
def test_fast_inference_compact_matches_full(models, specs, workers, path):
    """Compact staging through pooled buffers, packed on this thread or
    on two: the full-staged answers, and the buffers recycled (at most
    the packers' depth + 1 of them live a buffer geometry)."""
    _, tspec = specs
    graphs = models.port * 6  # many more batches than the packers hold
    if path == "shape_set":
        kw = dict(shape_set=tshapes.plan_shape_set(graphs, B, rungs=2,
                                                   dense_m=M))
        ckw = dict(shape_set=tshapes.plan_shape_set(graphs, B, rungs=2,
                                                    dense_m=M, compact=tspec))
        n_batches = len(list(tinfer._shape_set_plan(graphs,
                                                    ckw["shape_set"])))
    else:
        kw = dict(buckets=2, dense_m=M)
        ckw = dict(kw, compact=tspec)
        n_batches = len(list(tinfer._bucket_jobs(graphs, B, 2, M)))
    want, _ = tinfer.run_fast_inference(models.state, graphs, B, **kw)
    stats = {}
    got, rate = tinfer.run_fast_inference(models.state, graphs, B,
                                          pack_workers=workers, stats=stats,
                                          **ckw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    assert rate > 0 and n_batches >= 20
    assert stats["buffers_allocated"] + stats["buffers_reused"] == n_batches
    assert stats["jobs"] == (0 if workers == 0 else n_batches)
    live = 1 if workers == 0 else 2 * workers + 1
    assert 0 < stats["buffers_allocated"] <= 2 * live  # two geometries


def test_fast_inference_compact_matches_jax(models, specs):
    jspec, tspec = specs
    jss = jshapes.plan_shape_set(models.graphs, B, rungs=2, dense_m=M,
                                 compact=jspec)
    tss = tshapes.plan_shape_set(models.port, B, rungs=2, dense_m=M,
                                 compact=tspec)
    want, _ = jinfer.run_fast_inference(models.jstate, models.graphs, B,
                                        shape_set=jss)
    got, _ = tinfer.run_fast_inference(models.state, models.port, B,
                                       shape_set=tss, pack_workers=2)
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="already carries"):
        tinfer.run_fast_inference(models.state, models.port, B,
                                  shape_set=tss, compact=jspec)


def test_server_stages_compact_flushes(ckpt):
    """load_server(compact='on') on the CPU: answers equal to the full
    server's; a flush of compactable graphs counts pack_compact, one with
    a graph whose edge features lie about its distances pack_full."""
    kw = dict(batch_size=B, rungs=2, calibration=ckpt.graphs, device="cpu",
              log_fn=lambda *a: None, default_timeout_ms=60_000.0)
    full, _ = load_server(ckpt.dir, compact="off", **kw)
    comp, _ = load_server(ckpt.dir, compact="on", **kw)
    auto, _ = load_server(ckpt.dir, **kw)  # auto: off on the CPU
    try:
        assert comp.shape_set.compact is not None
        assert full.shape_set.compact is None
        assert auto.shape_set.compact is None
        asked = ckpt.graphs[:12]
        want = [full.predict(g, timeout_ms=60_000).prediction for g in asked]
        got = [comp.predict(g, timeout_ms=60_000).prediction for g in asked]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
        assert comp.counts["pack_compact"] == 12
        assert comp.counts["pack_full"] == 0
        lying = dataclasses.replace(asked[0], edge_fea=asked[0].edge_fea
                                    + 0.25)
        comp.predict(lying, timeout_ms=60_000)
        assert comp.counts["pack_full"] == 1
        assert comp.stats()["compact"] and not full.stats()["compact"]
        # warm() allocated one staging buffer a rung; traffic reuses them
        assert comp._pool.allocated == len(comp.shape_set)
        assert comp._pool.reused == 12
    finally:
        for s in (full, comp, auto):
            assert s.drain(timeout_s=60)
    with pytest.raises(ValueError, match="compact must be"):
        load_server(ckpt.dir, compact="yes", **kw)


def test_server_logs_unsupported_compact_and_packs_full(ckpt):
    said = []
    server, _ = load_server(
        ckpt.dir, batch_size=B, rungs=1, device="cpu", compact="on",
        calibration=[dataclasses.replace(g, distances=None)
                     for g in ckpt.graphs],
        log_fn=said.append, default_timeout_ms=60_000.0)
    try:
        assert server.shape_set.compact is None
        assert any("compact staging unavailable" in s for s in said)
        server.predict(ckpt.graphs[0], timeout_ms=60_000)
    finally:
        assert server.drain(timeout_s=60)
    assert isinstance(server, InferenceServer)


def test_compact_pack_fn(models, specs):
    _, tspec = specs
    caps = _caps(models.port)
    pack = tcompact.compact_pack_fn(tspec)
    got = pack(models.port, *caps, num_targets=1)
    want = tcompact.pack_compact(models.port, *caps, tspec, num_targets=1)
    for name, v in want.numpy().items():
        if v is not None:
            np.testing.assert_array_equal(got.numpy()[name], v)
