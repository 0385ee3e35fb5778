"""The port's serving path on the CPU: ``load_server(device="cpu")`` on a
saved parameter file answers concurrent clients, every answer equal to the
JAX ``make_predict_step`` on a JAX ``pack_full`` of the same graphs (the
Pallas kernel in interpret mode, a non-identity normalizer); admission
rejections match the JAX batcher's; the worker exits on drain."""

import threading
import types

import jax
import numpy as np
import pytest
import torch

from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu.models import CrystalGraphConvNet as JNet
from cgnn_tpu.ops.pallas_cgconv import interpret_mode
from cgnn_tpu.serve import batcher as jbatcher
from cgnn_tpu.serve import shapes as jshapes
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.step import make_predict_step as jmake_predict_step
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import DataConfig, ModelConfig
from cgnn_tpu_torch.data import synthetic as tsynthetic
from cgnn_tpu_torch.data.graph import CrystalGraph
from cgnn_tpu_torch.serve import batcher as tbatcher
from cgnn_tpu_torch.serve import shapes as tshapes
from cgnn_tpu_torch.serve.server import load_server, structure_featurizer

M = 8
SMALL = dict(atom_fea_len=16, n_conv=2, h_fea_len=24)
TOL = dict(rtol=1e-4, atol=1e-5)
NORM = ([1.5], [2.0])
N_CLIENTS, PER_CLIENT = 4, 10


def _port_graph(g) -> CrystalGraph:
    return CrystalGraph(g.atom_fea, g.edge_fea, g.centers, g.neighbors,
                        g.target, cif_id=g.cif_id)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """JAX graphs, JAX-initialized variables with non-trivial running
    stats, and the parameter file the port server loads."""
    graphs = load_synthetic(N_CLIENTS * PER_CLIENT,
                            FeaturizeConfig(radius=5.0, max_num_nbr=M),
                            seed=2, max_atoms=6)
    jnet = JNet(**SMALL, dense_m=M, cgconv_impl="pallas")
    shape_set = jshapes.plan_shape_set(graphs, 8, rungs=2, dense_m=M)
    with interpret_mode():
        v = jnet.init(jax.random.key(0), shape_set.pack_full(graphs[:1]))
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.default_rng(7)
    for conv in v["batch_stats"].values():
        for bn in conv.values():
            bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    d = tmp_path_factory.mktemp("params")
    npz, meta = str(d / "params.npz"), str(d / "meta.json")
    convert.save_params(
        npz, meta, v,
        ModelConfig(**SMALL, dense_m=M, cgconv_impl="pallas"),
        DataConfig(radius=5.0, max_num_nbr=M),
        normalizer_mean=NORM[0], normalizer_std=NORM[1])
    return types.SimpleNamespace(graphs=graphs, jnet=jnet, variables=v,
                                 shape_set=shape_set, npz=npz, meta=meta)


def _jax_predictions(saved) -> np.ndarray:
    """JAX make_predict_step on JAX pack_full batches, one row per graph."""
    state = types.SimpleNamespace(
        apply_fn=saved.jnet.apply, variables=lambda: saved.variables,
        normalizer=JNormalizer(mean=jax.numpy.asarray(NORM[0], np.float32),
                               std=jax.numpy.asarray(NORM[1], np.float32)))
    step = jmake_predict_step()
    big = saved.shape_set.largest
    chunks, cur = [], []
    for g in saved.graphs:
        n = sum(x.num_nodes for x in cur) + g.num_nodes
        if cur and not big.fits(len(cur) + 1, n, n * M):
            chunks.append(cur)
            cur = []
        cur.append(g)
    chunks.append(cur)
    rows = []
    with interpret_mode():
        for chunk in chunks:
            out = np.asarray(step(state, saved.shape_set.pack_full(chunk)))
            rows.append(out[:len(chunk)])
    return np.concatenate(rows)


def _server(saved, **kw):
    kw.setdefault("max_wait_ms", 2.0)
    return load_server(saved.npz, saved.meta, batch_size=8, rungs=2,
                       calibration=[_port_graph(g) for g in saved.graphs],
                       device="cpu", log_fn=lambda *a: None, **kw)


def test_concurrent_clients_match_jax_predict_step(saved):
    want = _jax_predictions(saved)
    server, info = _server(saved)
    assert [tuple(vars(s).values()) for s in server.shape_set] == [
        tuple(vars(s).values()) for s in saved.shape_set]
    graphs = [_port_graph(g) for g in saved.graphs]
    results: dict[int, object] = {}
    errors: list = []

    def client(k):
        try:
            futs = [(i, server.submit(graphs[i], timeout_ms=60_000))
                    for i in range(k, len(graphs), N_CLIENTS)]
            for i, f in futs:
                results[i] = f.result(timeout=120)
        except Exception as e:  # noqa: BLE001 — reported by the assert
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,),
                                name=f"test-client-{k}")
               for k in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sorted(results) == list(range(len(graphs)))
    got = np.stack([results[i].prediction for i in range(len(graphs))])
    assert got.shape == want.shape == (len(graphs), 1)
    np.testing.assert_allclose(got, want, **TOL)
    stats = server.stats()
    assert stats["counts"]["responses"] == len(graphs)
    assert stats["counts"]["batches"] >= len(graphs) // 16
    assert all(0 < r.batch_occupancy <= 1 for r in results.values())
    assert server.drain(timeout_s=30)
    assert not server._worker.is_alive()


def test_wire_structure_is_featurized_on_host(saved):
    server, info = _server(saved)
    s = tsynthetic.synthetic_dataset(1, seed=11, max_atoms=6)[0][1]
    via_wire = server.predict(s, timeout_ms=60_000)
    graph = structure_featurizer(info["data_cfg"])(s)
    via_graph = server.predict(graph, timeout_ms=60_000)
    assert np.isfinite(via_wire.prediction).all()
    np.testing.assert_allclose(via_wire.prediction, via_graph.prediction,
                               **TOL)
    assert server.drain(timeout_s=30)


def _giant(dims, n_nodes) -> CrystalGraph:
    nd, ed = dims
    idx = np.arange(n_nodes, dtype=np.int32)
    return CrystalGraph(np.zeros((n_nodes, nd), np.float32),
                        np.zeros((n_nodes, ed), np.float32), idx, idx,
                        np.zeros(1, np.float32))


def test_oversize_rejected_like_jax(saved):
    big = saved.shape_set.largest.node_cap + 1
    dims = (saved.graphs[0].atom_fea.shape[1],
            saved.graphs[0].edge_fea.shape[1])
    jb = jbatcher.MicroBatcher(saved.shape_set)
    with pytest.raises(jbatcher.ServeRejection) as je:
        jb.offer(jbatcher.Request(graph=_giant(dims, big), enqueued=0.0,
                                  deadline=None))
    server, _ = _server(saved)
    with pytest.raises(tbatcher.ServeRejection) as te:
        server.submit(_giant(dims, big))
    assert te.value.reason == je.value.reason == tbatcher.OVERSIZE
    assert te.value.http_status == 413
    assert server.stats()["counts"]["reject_oversize"] == 1
    assert server.drain(timeout_s=30)


def test_queue_bound_rejected_like_jax(saved):
    jss = saved.shape_set
    tss = tshapes.ShapeSet(
        [tshapes.BatchShape(*vars(s).values()) for s in jss], dense_m=M)
    g = saved.graphs[0]
    jb = jbatcher.MicroBatcher(jss, max_queue=2)
    tb = tbatcher.MicroBatcher(tss, max_queue=2)
    reasons = []
    for b, mod, graph in ((jb, jbatcher, g), (tb, tbatcher, _port_graph(g))):
        for _ in range(2):
            b.offer(mod.Request(graph=graph, enqueued=0.0, deadline=None))
        with pytest.raises(mod.ServeRejection) as e:
            b.offer(mod.Request(graph=graph, enqueued=0.0, deadline=None))
        reasons.append(e.value.reason)
        # the same flush decision once the wait budget has passed
        flush = b.poll(now=1.0)
        assert flush.reason == "deadline" and len(flush.requests) == 2
    assert reasons == [jbatcher.QUEUE_FULL, tbatcher.QUEUE_FULL]
    assert tbatcher.ServeRejection(tbatcher.QUEUE_FULL).http_status == 429


def test_deadline_and_drain(saved):
    server, _ = _server(saved, max_queue=4)
    server.begin_drain()
    server._worker.join(timeout=30)
    assert not server._worker.is_alive()
    with pytest.raises(tbatcher.ServeRejection) as e:
        server.submit(_port_graph(saved.graphs[0]))
    assert e.value.reason == tbatcher.SHUTDOWN
    # a request that waits past its own deadline is failed, not packed
    b = tbatcher.MicroBatcher(server.shape_set, max_wait_ms=1000.0)
    r = tbatcher.Request(graph=_port_graph(saved.graphs[0]), enqueued=0.0,
                         deadline=0.5)
    b.offer(r)
    flush = b.poll(now=0.6)
    assert flush.expired == [r] and not flush.requests
    assert tbatcher.ServeRejection(tbatcher.TIMEOUT).http_status == 504


def test_load_server_defaults_to_cuda(saved, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_server(saved.npz, saved.meta)
