"""The port's raw wire against the JAX package's, on the CPU: the wire form
and its planning (``RawSpec``, ``plan_raw_spec``, ``pack_raw``, the image
counts, the fingerprint) bit-equal; the device neighbor search (kernel 8's
plain version here) against the JAX search's 'xla' and 'pallas' variants
(the Pallas kernel in interpret mode): integers bit-equal, distances within
2e-5 (the JAX side takes ``frac @ lat`` as a matmul), the overflow flag
equal; the raw expander (edge features within 1e-6) and the raw predict
step (rtol 1e-4 / atol 1e-4) on the same seeded inputs; the batcher's form
cut; and ``load_server(device="cpu", wire="raw")`` under mixed traffic,
every answer equal to the featurized answer of the same structure."""

import threading
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from cgnn_tpu.data import rawbatch as jr
from cgnn_tpu.data.dataset import FeaturizeConfig as JFeaturizeConfig
from cgnn_tpu.data.dataset import featurize_structure as jfeaturize
from cgnn_tpu.data.structure import Structure as JStructure
from cgnn_tpu.data.synthetic import synthetic_dataset as jsynthetic
from cgnn_tpu.models import CrystalGraphConvNet as JNet
from cgnn_tpu.ops import neighbor_search as jns
from cgnn_tpu.serve import batcher as jbatcher
from cgnn_tpu.serve import shapes as jshapes
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.step import make_predict_step as jmake_predict_step
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import DataConfig, ModelConfig
from cgnn_tpu_torch.data import rawbatch as tr
from cgnn_tpu_torch.data.dataset import load_synthetic
from cgnn_tpu_torch.data.graph import CrystalGraph
from cgnn_tpu_torch.data.structure import Structure
from cgnn_tpu_torch.data.synthetic import synthetic_dataset, synthetic_mp_dataset
from cgnn_tpu_torch.ops import neighbor_search as tns
from cgnn_tpu_torch.serve import batcher as tbatcher
from cgnn_tpu_torch.serve import shapes as tshapes
from cgnn_tpu_torch.serve.server import load_server, structure_featurizer
from cgnn_tpu_torch.train.normalizer import Normalizer
from cgnn_tpu_torch.train.step import InferenceState, make_predict_step

M = 12
CFG = JFeaturizeConfig(radius=6.0, max_num_nbr=M)
SMALL = dict(atom_fea_len=16, n_conv=2, h_fea_len=32)
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)
NORM = ([1.5], [2.0])


def _jax_graphs(items):
    """The JAX package's graphs on its numpy neighbor search: ``CASES``
    is built while the module is imported, in every xdist worker at once,
    and the native search would make each of them compile the JAX native
    library into one shared path."""
    import cgnn_tpu.native

    with mock.patch.object(cgnn_tpu.native, "neighbor_search_native",
                           lambda *a, **k: None):
        return [jfeaturize(s, t, CFG, sid, keep_geometry=True)
                for sid, s, t in items]


def _port_graph(g) -> CrystalGraph:
    return CrystalGraph(g.atom_fea, g.edge_fea, g.centers, g.neighbors,
                        g.target, cif_id=g.cif_id, distances=g.distances,
                        positions=g.positions, lattice=g.lattice,
                        offsets=g.offsets, numbers=g.numbers)


def _port_spec(js) -> tr.RawSpec:
    return tr.RawSpec(js.snode_cap, tuple(js.images), js.radius, js.dense_m,
                      np.asarray(js.gauss_filter), js.gauss_var)


def _port_raw(r) -> tr.RawStructure:
    return tr.RawStructure(r.frac_coords, r.lattice, r.numbers,
                           target=r.target, cif_id=r.cif_id,
                           target_mask=r.target_mask)


def _spec(s_cap=8, images=(2, 2, 2)):
    gdf = CFG.gdf()
    return jr.RawSpec(snode_cap=s_cap, images=images, radius=6.0, dense_m=M,
                      gauss_filter=gdf.filter, gauss_var=gdf.var)


# ---------------------------------------------------------------------------
# the wire form and its planning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coverage", [1.0, 0.8])
def test_spec_planning_and_pack_bit_equal(coverage):
    items = jsynthetic(20, seed=13)
    jg = _jax_graphs(items)
    js = jr.plan_raw_spec(jg, CFG.gdf(), CFG.radius, M, coverage=coverage)
    ts = tr.plan_raw_spec([_port_graph(g) for g in jg], CFG.gdf(),
                          CFG.radius, M, coverage=coverage)
    assert (ts.snode_cap, ts.images, ts.radius, ts.dense_m, ts.gauss_var) == (
        js.snode_cap, js.images, js.radius, js.dense_m, js.gauss_var)
    np.testing.assert_array_equal(ts.gauss_filter, js.gauss_filter)
    assert ts.n_images == js.n_images and ts.home_image == js.home_image
    np.testing.assert_array_equal(ts.offsets_grid(), js.offsets_grid())
    assert ts.to_meta() == js.to_meta()
    jt, tt = js.template(), ts.template()
    np.testing.assert_array_equal(tt.lattice, jt.lattice)
    # structures back from graphs, admission, image counts, fingerprints
    jraw = [jr.raw_from_graph(g) for g in jg]
    traw = [tr.raw_from_graph(_port_graph(g)) for g in jg]
    for a, b in zip(traw, jraw):
        np.testing.assert_array_equal(a.frac_coords, b.frac_coords)
        assert ts.admits(a) == js.admits(b)
        assert ts.oversize_detail(a) == js.oversize_detail(b)
        assert tr.raw_fingerprint(a) == jr.raw_fingerprint(b)
        assert tr.host_image_counts(a.lattice, 6.0) == jr.host_image_counts(
            b.lattice, 6.0)
        np.testing.assert_array_equal(
            tr.needed_images_f32(a.lattice, 6.0),
            jr.needed_images_f32(b.lattice, 6.0))
    assert tr.raw_from_graph(CrystalGraph(
        jg[0].atom_fea, jg[0].edge_fea, jg[0].centers, jg[0].neighbors,
        jg[0].target)) is None
    admitted = [(a, b) for a, b in zip(traw, jraw) if js.admits(b)]
    assert admitted
    g_cap = len(admitted) + 3  # padding structure slots
    got = tr.pack_raw([a for a, _ in admitted], g_cap, ts).numpy()
    want = jr.pack_raw([b for _, b in admitted], g_cap, js)
    for field, a in got.items():
        b = np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_spec_refusals_match():
    items = jsynthetic(4, seed=0)
    plain = [jfeaturize(s, t, CFG, sid) for sid, s, t in items]
    with pytest.raises(jr.RawUnsupported):
        jr.plan_raw_spec(plain, CFG.gdf(), CFG.radius, M)
    with pytest.raises(tr.RawUnsupported):
        tr.plan_raw_spec([_port_graph(g) for g in plain], CFG.gdf(),
                         CFG.radius, M)
    with pytest.raises(tr.RawUnsupported):
        tr.plan_raw_spec(_jax_graphs(items), CFG.gdf(), CFG.radius, 0)
    with pytest.raises(ValueError, match="species"):
        tr.RawStructure(np.zeros((2, 3)), np.eye(3), [1])
    ts = _port_spec(_spec())
    big = tr.RawStructure(np.zeros((9, 3)), np.eye(3) * 9, [1] * 9)
    assert not ts.admits(big)  # more atoms than snode_cap
    with pytest.raises(ValueError, match="snode_cap"):
        tr.pack_raw([big], 2, ts)


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------


def _cases():
    """name -> (JAX spec, JAX RawStructures, graph_cap)."""
    items = jsynthetic(10, seed=7)
    js = jr.plan_raw_spec(_jax_graphs(items), CFG.gdf(), CFG.radius, M,
                          coverage=1.0)
    cubic = jr.RawStructure.from_structure(
        JStructure(np.eye(3) * 3.0, [[0, 0, 0]], [29]))
    skewed = jr.RawStructure(np.array([[0.5, 0.5, 0.5]]),
                             np.diag([20.0, 20.0, 2.2]),
                             np.array([14], np.int32))
    ok = jr.RawStructure(np.zeros((1, 3)), np.eye(3) * 7.0,
                         np.array([6], np.int32))
    tiny = jr.RawStructure(np.zeros((1, 3)), np.eye(3) * 2.0,
                           np.array([6], np.int32))
    return {
        "synthetic": (js, [jr.RawStructure.from_structure(s, t, sid)
                           for sid, s, t in items], 12),
        "exact_tie_cubic": (_spec(), [cubic], 2),
        "skewed": (_spec(images=(1, 1, 3)), [skewed], 1),
        "tiny_overflow": (_spec(images=(1, 1, 1)), [ok, tiny], 4),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
def test_search_matches_jax(case, jimpl):
    js, raws, g_cap = CASES[case]
    ts = _port_spec(js)
    jrb = jr.pack_raw(raws, g_cap, js)
    trb = tr.pack_raw([_port_raw(r) for r in raws], g_cap, ts)
    want = [np.asarray(x) for x in jax.jit(
        lambda rb: jns.neighbor_search(rb.frac, rb.lattices, rb.atom_mask,
                                       js, impl=jimpl))(jrb)]
    got = [x.numpy() for x in tns.neighbor_search(
        trb.frac, trb.lattices, trb.atom_mask, ts, impl="pallas")]
    names = ("neighbors", "distances", "edge_mask", "n_edges", "overflow")
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "distances":
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    nbr, dist, em, ne, ovf = got
    # padding slots: self-loops, zero mask and distance, no edges, no flag
    pad = trb.graph_mask.numpy() == 0
    own = np.arange(ts.snode_cap)[None, :, None]
    assert (nbr[pad] == np.broadcast_to(own, nbr.shape)[pad]).all()
    assert em[pad].max(initial=0) == 0 and dist[pad].max(initial=0) == 0
    assert ne[pad].max(initial=0) == 0 and not ovf[pad].any()
    if case == "tiny_overflow":
        assert list(ovf) == [False, True, False, False]
    else:
        assert not ovf.any()
    # 'xla' selects the same plain version; the numpy mirror agrees
    again = tns.neighbor_search(trb.frac, trb.lattices, trb.atom_mask, ts,
                                impl="xla")
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a.numpy(), b)
    for gi in range(g_cap):
        hn, hd, hm, hne, hovf = tr.raw_neighbor_graph_host(
            trb.frac[gi].numpy(), trb.lattices[gi].numpy(),
            trb.atom_mask[gi].numpy(), ts)
        np.testing.assert_array_equal(hn, nbr[gi])
        np.testing.assert_array_equal(hm, em[gi].astype(np.uint8))
        np.testing.assert_allclose(hd, dist[gi], atol=2e-5)
        assert hne == int(ne[gi])
        assert hovf == bool(ovf[gi]) or pad[gi]


def test_plain_version_chunks_like_one_pass(monkeypatch):
    js, raws, g_cap = CASES["synthetic"]
    ts = _port_spec(js)
    rb = tr.pack_raw([_port_raw(r) for r in raws], g_cap, ts)
    args = (rb.frac, rb.lattices, rb.atom_mask, tns.offsets_tensor(ts, "cpu"),
            ts.radius, ts.home_image, M)
    whole = tns.neighbor_search_reference(*args)
    monkeypatch.setattr(tns, "REFERENCE_CHUNK", 1)  # one structure a chunk
    for a, b in zip(tns.neighbor_search_reference(*args), whole):
        assert torch.equal(a, b)


def test_needed_images_torch_equals_numpy():
    rng = np.random.default_rng(5)
    lats = np.concatenate([
        rng.normal(0, 4, (64, 3, 3)),
        np.stack([np.eye(3) * a for a in (2.0, 3.0, 4.0, 6.0, 7.5)]),
        [np.diag([20.0, 20.0, 2.2])],
    ]).astype(np.float32)
    want = np.stack([tr.needed_images_f32(a, 6.0) for a in lats])
    got = tns.needed_images(torch.from_numpy(lats), 6.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_search_refuses_on_cpu_and_checks_impl():
    js, raws, g_cap = CASES["exact_tie_cubic"]
    ts = _port_spec(js)
    rb = tr.pack_raw([_port_raw(r) for r in raws], g_cap, ts)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tns.neighbor_search_cuda(rb.frac, rb.lattices, rb.atom_mask,
                                 tns.offsets_tensor(ts, "cpu"), 6.0,
                                 ts.home_image, M)
    with pytest.raises(ValueError, match="impl"):
        tns.neighbor_search(rb.frac, rb.lattices, rb.atom_mask, ts,
                            impl="triton")
    # one real atom a structure with one filled slot: per candidate 9
    # unfusable f32 ops (18), per (j, k) the image's 3 adds (6), one SFU
    # root (16); the earlier count, 14 a candidate, stays beside it
    cost = tns.neighbor_search_cost(2, 8, 125, 12, real_pairs=1,
                                    real_atoms=1, filled=1)
    assert cost["flops"] == 18 * 125 + 6 * 125 + 16
    assert cost["flops_before"] == 14 * 125
    assert cost["bytes"] > 3 * 2 * 8 * 12 * 4


# ---------------------------------------------------------------------------
# the expander and the raw predict step
# ---------------------------------------------------------------------------


def test_raw_expander_matches_jax():
    items = jsynthetic(6, seed=5)
    js = jr.plan_raw_spec(_jax_graphs(items), CFG.gdf(), CFG.radius, M,
                          coverage=1.0)
    ts = _port_spec(js)
    raws = [jr.RawStructure.from_structure(s, t, sid) for sid, s, t in items]
    g_cap = 8
    jgb, jovf, jne = jax.jit(jns.make_raw_expander(js))(
        jr.pack_raw(raws, g_cap, js))
    gb, ovf, ne = tns.make_raw_expander(ts, impl="pallas", device="cpu")(
        tr.pack_raw([_port_raw(r) for r in raws], g_cap, ts))
    for name in ("nodes", "centers", "neighbors", "node_graph", "node_mask",
                 "edge_mask", "graph_mask", "targets", "target_mask"):
        a, b = getattr(gb, name).numpy(), np.asarray(getattr(jgb, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # edge features: the JAX expander's formula on the port's distances
    # within 1e-6 (jnp.exp against torch.exp); against the JAX expander's
    # own edges, whose distances come from a matmul (within 2e-5, above),
    # within 1e-4: the Gaussian's slope is at most sqrt(2/e)/0.2 = 4.3/A
    rb = tr.pack_raw([_port_raw(r) for r in raws], g_cap, ts)
    _, dist, em, _, _ = tns.neighbor_search(rb.frac, rb.lattices,
                                            rb.atom_mask, ts)
    mu, var2 = np.asarray(ts.gauss_filter), np.float32(ts.gauss_var) ** 2
    want = jax.numpy.exp(-((dist.numpy()[..., None] - mu) ** 2) / var2) \
        * em.numpy()[..., None]
    got = gb.edges.numpy()
    np.testing.assert_allclose(got, np.asarray(want).reshape(got.shape),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jgb.edges), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(jovf))
    np.testing.assert_array_equal(ne.numpy(), np.asarray(jne))
    # dense-layout invariants
    s_cap = ts.snode_cap
    nbr, emask = gb.neighbors.numpy(), gb.edge_mask.numpy()
    own = np.arange(g_cap * s_cap * M) // M
    np.testing.assert_array_equal(gb.centers.numpy(), own)
    assert (nbr[emask == 0] == own[emask == 0]).all()
    assert gb.edges.shape == (g_cap * s_cap, M, len(ts.gauss_filter))
    for gi in range(len(items)):
        blk = nbr[gi * s_cap * M:(gi + 1) * s_cap * M]
        assert blk.min() >= gi * s_cap and blk.max() < (gi + 1) * s_cap
    assert gb.node_mask.numpy()[len(items) * s_cap:].max() == 0
    assert gb.graph_mask.numpy()[len(items):].max() == 0
    assert gb.positions is None and gb.in_slots is None


def test_raw_predict_step_matches_jax():
    items = jsynthetic(16, seed=2)
    jg = _jax_graphs(items)
    js = jr.plan_raw_spec(jg, CFG.gdf(), CFG.radius, M)
    jladder = jshapes.plan_shape_set(jg, 8, rungs=2, dense_m=M, raw=js)
    jnet = JNet(**SMALL, dense_m=M)
    v = jax.tree_util.tree_map(np.array, jnet.init(
        jax.random.key(0), jladder.pack_full(jg[:1])))
    rng = np.random.default_rng(7)
    for conv in v["batch_stats"].values():
        for bn in conv.values():
            bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    raws = [jr.raw_from_graph(g) for g in jg]
    raws = [r for r in raws if js.admits(r)][:8]
    jstate = types.SimpleNamespace(
        apply_fn=jnet.apply, variables=lambda: v,
        normalizer=JNormalizer(mean=jax.numpy.asarray(NORM[0], np.float32),
                               std=jax.numpy.asarray(NORM[1], np.float32)))
    jstep = jmake_predict_step(raw_expander=jladder.raw_expander())
    jrb = jladder.pack_raw(raws)
    want = [np.asarray(x) for x in jax.jit(lambda rb: jstep(jstate, rb))(jrb)]

    ts = _port_spec(js)
    ladder = tshapes.plan_shape_set([_port_graph(g) for g in jg], 8,
                                    rungs=2, dense_m=M, raw=ts)
    assert [tuple(vars(s).values()) for s in ladder] == [
        tuple(vars(s).values()) for s in jladder]
    net = ModelConfig(**SMALL, dense_m=M, cgconv_impl="pallas").build(
        nbr_fea_len=len(ts.gauss_filter), device="cpu")
    net.load_state_dict(convert.from_flax_variables(v))
    state = InferenceState(net, Normalizer.from_arrays(*NORM, "cpu"))
    step = make_predict_step(raw_expander=ladder.raw_expander("pallas",
                                                              "cpu"))
    preds, ovf, ne = step(state, ladder.pack_raw([_port_raw(r)
                                                  for r in raws]))
    assert preds.shape == want[0].shape == (jrb.graph_capacity, 1)
    assert np.isfinite(preds.numpy()).all()
    np.testing.assert_allclose(preds.numpy(), want[0], **SERVE_TOL)
    np.testing.assert_array_equal(ovf.numpy(), want[1])
    np.testing.assert_array_equal(ne.numpy(), want[2])
    # a featurized batch still takes the plain branch of the same step
    fb = ladder.pack_full([_port_graph(g) for g in jg[:3]])
    assert step(state, fb).shape == (fb.graph_capacity, 1)


# ---------------------------------------------------------------------------
# the batcher's form cut
# ---------------------------------------------------------------------------


def test_batcher_cuts_flushes_at_a_form_change():
    jg = _jax_graphs(jsynthetic(4, seed=3))
    js = jr.plan_raw_spec(jg, CFG.gdf(), CFG.radius, M)
    jss = jshapes.plan_shape_set(jg, 8, rungs=2, dense_m=M, raw=js)
    tss = tshapes.plan_shape_set([_port_graph(g) for g in jg], 8, rungs=2,
                                 dense_m=M, raw=_port_spec(js))
    got = []
    for mod, ss, graph, raw in (
            (jbatcher, jss, jg[0], jr.raw_from_graph(jg[1])),
            (tbatcher, tss, _port_graph(jg[0]),
             tr.raw_from_graph(_port_graph(jg[1])))):
        b = mod.MicroBatcher(ss, max_wait_ms=1000.0)
        for req in (mod.Request(graph=graph, enqueued=0.0, deadline=None),
                    mod.Request(graph=graph, enqueued=0.0, deadline=None),
                    mod.Request(graph=raw, enqueued=0.0, deadline=None,
                                form="raw")):
            b.offer(req)
        first = b.poll(now=0.001)
        assert b.poll(now=0.002) is None  # the raw one waits its budget
        second = b.poll(now=2.0)
        got.append([(f.reason, f.form, len(f.requests))
                    for f in (first, second)])
    assert got[0] == got[1] == [("tier_boundary", "feat", 2),
                                ("deadline", "raw", 1)]


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    dcfg = DataConfig(radius=6.0, max_num_nbr=M)
    cfg = ModelConfig(**SMALL, dense_m=M, cgconv_impl="pallas")
    d = tmp_path_factory.mktemp("raw_params")
    npz, meta = str(d / "params.npz"), str(d / "meta.json")
    convert.save_params(npz, meta, convert.init_params(cfg, dcfg, seed=3),
                        cfg, dcfg, normalizer_mean=NORM[0],
                        normalizer_std=NORM[1])
    calibration = load_synthetic(24, dcfg.featurize_config(), seed=4,
                                 keep_geometry=True)
    return types.SimpleNamespace(npz=npz, meta=meta, dcfg=dcfg,
                                 calibration=calibration)


def _server(saved, **kw):
    server, info = load_server(saved.npz, saved.meta, batch_size=8, rungs=2,
                               calibration=saved.calibration, device="cpu",
                               max_wait_ms=2.0, log_fn=lambda *a: None, **kw)
    calls = []
    featurize = server.featurizer

    def recording(rs):
        calls.append(threading.current_thread().name)
        return featurize(rs)

    server.featurizer = recording
    return server, info, calls


def _featurized_answers(server, data_cfg, structures):
    """The server's answers to host-featurized copies of ``structures``."""
    featurize = structure_featurizer(data_cfg)
    futs = [server.submit(featurize(s), timeout_ms=60_000)
            for s in structures]
    return np.stack([f.result(timeout=120).prediction for f in futs])


def test_server_mixed_traffic_raw_and_deferred(saved):
    server, info, calls = _server(saved, wire="raw")
    spec = server.shape_set.raw
    assert spec is not None and server.stats()["raw"] == spec.to_meta()
    structs = [s for _, s, _ in synthetic_dataset(10, seed=21)]
    raws = [tr.RawStructure.from_structure(s) for s in structs]
    assert all(spec.admits(r) for r in raws)
    # an oversize-atom structure: past snode_cap, inside the node cap
    big = next(s for _, s, _ in synthetic_mp_dataset(40, seed=3)
               if spec.snode_cap < s.num_atoms
               <= server.shape_set.largest.node_cap)
    want = _featurized_answers(server, saved.dcfg, structs + [big])
    counts0 = dict(server.counts)
    feat_graphs = [structure_featurizer(saved.dcfg)(s) for s in structs[:4]]
    futs = []
    for i, r in enumerate(raws):  # raw, featurized graphs and a Structure
        futs.append(server.submit(r, timeout_ms=60_000))
        if i < len(feat_graphs):
            futs.append(server.submit(feat_graphs[i], timeout_ms=60_000))
    futs.append(server.submit(big, timeout_ms=60_000))  # deferred
    results = [f.result(timeout=120) for f in futs]
    raw_res = [r for r in results if r.wire == "raw"]
    feat_res = [r for r in results if r.wire == "featurized"]
    assert len(raw_res) == len(raws) and len(feat_res) == 5
    order = []
    for i in range(len(raws)):
        order.append(i)
        if i < len(feat_graphs):
            order.append(i)
    order.append(len(structs))
    got = np.stack([r.prediction for r in results])
    np.testing.assert_allclose(got, want[order], **SERVE_TOL)
    c = server.counts
    assert c["responses_raw"] - counts0["responses_raw"] == len(raws)
    assert c["pack_raw"] - counts0["pack_raw"] >= 1
    assert c["ingest_cap_overflow"] == 0
    # deferred structures were featurized on the worker, never here
    assert calls and set(calls) == {"cgnn-torch-serve"}
    assert server.drain(timeout_s=30)


def test_server_overflow_falls_back_to_featurized(saved):
    server, _, calls = _server(saved, wire="raw", raw_precheck=False)
    tiny = Structure(np.eye(3) * 2.0, np.zeros((1, 3)), [6])
    res = server.predict(tiny, timeout_ms=60_000)
    assert res.wire == "featurized"
    assert server.counts["ingest_cap_overflow"] == 1
    assert server.counts["pack_raw"] == 1 and calls == ["cgnn-torch-serve"]
    want = _featurized_answers(server, saved.dcfg, [tiny])
    np.testing.assert_allclose(res.prediction, want[0], **SERVE_TOL)
    assert server.drain(timeout_s=30)


def test_server_rejects_malformed_wire_alone(saved):
    server, _, _ = _server(saved, wire="raw")
    bad = [tr.RawStructure(np.full((1, 3), np.nan), np.eye(3) * 5, [6]),
           tr.RawStructure(np.zeros((1, 3)), np.eye(3) * 5, [0]),
           tr.RawStructure(np.zeros((1, 3)), np.zeros((3, 3)), [6]),
           tr.RawStructure(np.zeros((0, 3)), np.eye(3) * 5, [])]
    for rs in bad:
        with pytest.raises(tbatcher.ServeRejection) as e:
            server.submit(rs)
        assert e.value.http_status == 400
    assert server.counts["reject_malformed"] == len(bad)
    assert server.drain(timeout_s=30)


def test_load_server_wire_choice(saved):
    server, _, _ = _server(saved)  # 'auto' on the CPU: featurized wire
    assert server.shape_set.raw is None
    s = synthetic_dataset(1, seed=9)[0][1]
    via_feat = server.predict(s, timeout_ms=60_000)
    assert via_feat.wire == "featurized"
    assert server.drain(timeout_s=30)
    # the raw wire asked for by name: the device picks the search (its
    # plain version on the CPU), and the plain search asked for by name
    # through the same shape set gives the same answer
    server, _, _ = _server(saved, wire="raw")
    res = server.predict(s, timeout_ms=60_000)
    assert res.wire == "raw"
    np.testing.assert_allclose(res.prediction, via_feat.prediction,
                               **SERVE_TOL)
    rs = tr.RawStructure.from_structure(s)
    for impl in ("pallas", "xla"):
        step = make_predict_step(
            raw_expander=server.shape_set.raw_expander(impl, "cpu"))
        preds, _, _ = step(server.state, server.shape_set.pack_raw([rs]))
        np.testing.assert_allclose(preds[0].numpy(), res.prediction,
                                   **SERVE_TOL)
    with pytest.raises(ValueError, match="impl"):
        server.shape_set.raw_expander("triton", "cpu")
    assert server.drain(timeout_s=30)
    with pytest.raises(ValueError, match="wire"):
        load_server(saved.npz, saved.meta, device="cpu", wire="json")
    # without lattices in the calibration the raw wire is refused, not
    # guessed: the server serves the featurized wire
    plain = load_synthetic(12, saved.dcfg.featurize_config(), seed=4)
    logs = []
    server, _ = load_server(saved.npz, saved.meta, batch_size=8, rungs=1,
                            calibration=plain, device="cpu", wire="raw",
                            log_fn=logs.append)
    assert server.shape_set.raw is None
    assert any("raw wire unavailable" in str(x) for x in logs)
    assert server.drain(timeout_s=30)
