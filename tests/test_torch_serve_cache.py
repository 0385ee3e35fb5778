"""The port's result cache (``cgnn_tpu_torch/serve/cache.py``) against
the JAX package's, and its wiring into ``InferenceServer.submit`` on the
CPU.

- ``structure_fingerprint`` and ``data.rawbatch.raw_fingerprint`` give
  the same strings as JAX's on the same arrays;
- a hypothesis script of puts and gets leaves both LRUs with the same
  keys in the same order and the same hit and miss counts;
- the server: a repeat is a hit carrying ``cached`` with the miss's value;
  the ``raw:`` / ``fs:`` key split keeps a row the raw program computed
  from answering a host-featurized request; a row of a version no longer
  live is never served; identical misses in flight coalesce onto one
  leader (single flight).
"""

import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cgnn_tpu.data.dataset import FeaturizeConfig as JFeaturizeConfig
from cgnn_tpu.data.dataset import load_synthetic as jload_synthetic
from cgnn_tpu.data.rawbatch import RawStructure as JRaw
from cgnn_tpu.data.rawbatch import raw_fingerprint as jraw_fingerprint
from cgnn_tpu.serve import cache as jcache
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import DataConfig, ModelConfig
from cgnn_tpu_torch.data.dataset import load_synthetic
from cgnn_tpu_torch.data.graph import CrystalGraph
from cgnn_tpu_torch.data.rawbatch import RawStructure
from cgnn_tpu_torch.data.rawbatch import raw_fingerprint
from cgnn_tpu_torch.data.synthetic import synthetic_dataset
from cgnn_tpu_torch.serve import cache as tcache
from cgnn_tpu_torch.serve.server import load_server, structure_featurizer
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

M = 8


@pytest.fixture(scope="module")
def jgraphs():
    return jload_synthetic(12, JFeaturizeConfig(radius=5.0, max_num_nbr=M),
                           seed=3, max_atoms=6)


def _port(g) -> CrystalGraph:
    return CrystalGraph(g.atom_fea, g.edge_fea, g.centers, g.neighbors,
                        g.target, cif_id=g.cif_id, distances=g.distances)


def test_structure_fingerprint_matches_jax(jgraphs):
    fps = [tcache.structure_fingerprint(_port(g)) for g in jgraphs]
    assert fps == [jcache.structure_fingerprint(g) for g in jgraphs]
    assert len(set(fps)) == len(fps)


def test_raw_fingerprint_matches_jax():
    for _, s, _ in synthetic_dataset(10, seed=5):
        got = raw_fingerprint(RawStructure.from_structure(s))
        want = jraw_fingerprint(JRaw(s.frac_coords, s.lattice, s.numbers))
        assert got == want and got.startswith("raw:")


OPS = st.lists(st.tuples(st.sampled_from(("put", "get", "clear")),
                         st.integers(0, 7)), max_size=60)


@settings(max_examples=60, deadline=None, database=None)
@given(ops=OPS, capacity=st.integers(1, 5))
def test_lru_order_matches_jax(ops, capacity):
    caches = (jcache.ResultCache(capacity), tcache.ResultCache(capacity))
    logs = ([], [])
    for op, k in ops:
        for c, log in zip(caches, logs):
            if op == "put":
                c.put(f"k{k}", k)
            elif op == "get":
                log.append(c.get(f"k{k}"))
            else:
                c.clear()
    j, t = caches
    assert logs[0] == logs[1]
    assert list(t._data) == list(j._data)
    assert t.snapshot() == j.snapshot() and t.stats() == j.stats()
    assert len(t) == len(j)


def test_capacity_must_be_positive():
    for mod in (jcache, tcache):
        with pytest.raises(ValueError, match="capacity must be >= 1"):
            mod.ResultCache(0)


@pytest.fixture(scope="module")
def weights(tmp_path_factory, jgraphs):
    model_cfg = ModelConfig(atom_fea_len=16, n_conv=2, h_fea_len=24,
                            dense_m=M)
    data_cfg = DataConfig(radius=5.0, max_num_nbr=M)
    d = tmp_path_factory.mktemp("w")
    npz, meta = str(d / "p.npz"), str(d / "m.json")
    convert.save_params(npz, meta,
                        convert.init_params(model_cfg, data_cfg, seed=2),
                        model_cfg, data_cfg, normalizer_mean=[1.0],
                        normalizer_std=[3.0])
    return types.SimpleNamespace(npz=npz, meta=meta, data_cfg=data_cfg,
                                 graphs=[_port(g) for g in jgraphs])


def _server(weights, **kw):
    kw.setdefault("log_fn", lambda *a: None)
    kw.setdefault("calibration", weights.graphs)
    return load_server(weights.npz, weights.meta, batch_size=8, rungs=2,
                       device="cpu", default_timeout_ms=60_000.0, **kw)


def test_repeat_is_a_hit_with_the_miss_value(weights):
    server, _ = _server(weights)
    try:
        g = weights.graphs[0]
        miss = server.predict(g)
        hit = server.predict(CrystalGraph(**vars(g)))  # a fresh copy
        assert not miss.cached and hit.cached and hit.device_id == -1
        np.testing.assert_array_equal(hit.prediction, miss.prediction)
        assert hit.param_version == miss.param_version
        c = server.stats()
        assert c["counts"]["cache_hits"] == 1
        assert c["cache"]["hits"] == 1 and c["cache"]["size"] == 1
    finally:
        assert server.drain(timeout_s=30)


def test_raw_and_featurized_rows_never_alias(weights):
    """The raw wire on the CPU (the plain neighbor search): a structure
    staged raw is cached under 'raw:'; the same structure featurized by
    the host (a featurized-only server) under 'fs:' with the same digest;
    a host-featurized graph of it under its array hash."""
    s = synthetic_dataset(1, seed=9, max_atoms=6)[0][1]
    rs = RawStructure.from_structure(s)
    # geometry kept: the raw spec plans its caps from the lattices
    calib = load_synthetic(16, weights.data_cfg.featurize_config(), seed=1,
                           keep_geometry=True)
    raw_server, _ = _server(weights, wire="raw", calibration=calib)
    feat_server, _ = _server(weights, wire="featurized", calibration=calib)
    try:
        a = raw_server.predict(rs)
        b = feat_server.predict(RawStructure.from_structure(s))
        assert a.wire == "raw" and b.wire == "featurized"
        key = raw_fingerprint(rs)
        assert list(raw_server.cache._data) == [key]
        assert list(feat_server.cache._data) == ["fs:" + key[len("raw:"):]]
        # the graph the host featurizes from it: a miss on both servers
        g = structure_featurizer(weights.data_cfg)(s)
        c = raw_server.predict(g)
        assert not c.cached and c.wire == "featurized"
        np.testing.assert_allclose(c.prediction, a.prediction, rtol=1e-4,
                                   atol=1e-5)
        # an upstream hash is used only where its form matches
        assert raw_server._cache_key(rs, True, "raw", key) == key
        assert raw_server._cache_key(rs, True, "feat", key) == (
            "fs:" + key[4:])
        assert raw_server._cache_key(g, False, "feat", key) == (
            tcache.structure_fingerprint(g))
    finally:
        assert raw_server.drain(timeout_s=30)
        assert feat_server.drain(timeout_s=30)


def test_stale_version_row_is_not_served(weights):
    server, _ = _server(weights)
    try:
        g = weights.graphs[1]
        key = tcache.structure_fingerprint(g)
        server.cache.put(key, (np.array([123.0], np.float32), "old"))
        res = server.predict(g)
        assert not res.cached and res.prediction[0] != 123.0
        assert server.cache.get(key)[1] == server.version
    finally:
        assert server.drain(timeout_s=30)


def test_identical_misses_in_flight_coalesce(weights):
    server, info = _server(weights, warm=False)
    server.warm(info["template"])
    g = weights.graphs[2]
    futs = [server.submit(CrystalGraph(**vars(g))) for _ in range(3)]
    assert server.stats()["counts"]["cache_coalesced"] == 2
    assert server.batcher.depth == 1
    server.start()
    try:
        res = [f.result(60) for f in futs]
        for r in res[1:]:
            np.testing.assert_array_equal(r.prediction, res[0].prediction)
        assert [r.coalesced for r in res] == [False, True, True]
        assert len({r.trace_id for r in res}) == 3
    finally:
        assert server.drain(timeout_s=30)
