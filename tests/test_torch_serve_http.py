"""The port's HTTP front end (``cgnn_tpu_torch/serve/http.py``) against
the JAX package's (``cgnn_tpu/serve/http.py``) on the CPU.

A model that JAX ``train.py`` trained serves through the JAX server, and
the same weights, carried over by ``jax_checkpoint_to_torch.py``, through
the port's. Both get the same requests over real sockets: ``/healthz``,
a full queue (429), a valid graph and its repeat (a cache hit), a
wire-form structure, a malformed body and a malformed graph (400), an
oversize graph (413), an unknown class (400), a deadline that passes in
the queue (504), and a draining server (503, and ``/healthz`` 503). The
status codes, ``Retry-After`` headers and response keys are the same, the
``X-Request-Id`` echo too, and the predictions agree within rtol 1e-4 /
atol 1e-4, checked in float32 and float64. Both featurize with the numpy
neighbor search (the JAX package's native search orders distance ties by
cell list; ROADMAP Queue 3, item 1).
"""

import dataclasses
import http.client
import json
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest

from cgnn_tpu.data.graph import CrystalGraph as JGraph
from cgnn_tpu.serve.http import make_http_server as jmake_http_server
from cgnn_tpu.serve.server import load_server as jload_server
from cgnn_tpu_torch.config import DataConfig
from cgnn_tpu_torch.data.dataset import load_synthetic
from cgnn_tpu_torch.data.graph import CrystalGraph
from cgnn_tpu_torch.data.synthetic import synthetic_dataset
from cgnn_tpu_torch.serve.http import make_http_server
from cgnn_tpu_torch.serve.server import load_server
from cgnn_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("http")
    jck, pck = str(d / "jck"), str(d / "pck")
    sys.path.insert(0, str(ROOT))
    try:
        import jax_checkpoint_to_torch
        import train as jtrain
    finally:
        sys.path.remove(str(ROOT))
    assert jtrain.main(["--synthetic", "24", "--device", "cpu", "--epochs",
                        "1", "-b", "8", "--ckpt-dir", jck, "--n-conv", "2",
                        "--atom-fea-len", "16", "--radius", "5",
                        "--print-freq", "0", "--compile-cache", ""]) == 0
    assert jax_checkpoint_to_torch.main([jck, pck, "--device", "cpu"]) == 0
    data_cfg = DataConfig.from_meta(CheckpointManager(pck).read_meta()["data"])
    graphs = load_synthetic(16, data_cfg.featurize_config(), seed=8)
    return types.SimpleNamespace(jck=jck, pck=pck, graphs=graphs)


def _jgraph(g):
    return JGraph(g.atom_fea, g.edge_fea, g.centers, g.neighbors, g.target,
                  cif_id=g.cif_id)


def _graph_json(g):
    return {"atom_fea": g.atom_fea.tolist(), "edge_fea": g.edge_fea.tolist(),
            "centers": g.centers.tolist(), "neighbors": g.neighbors.tolist(),
            "id": g.cif_id}


def _call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path,
                     body=None if body is None else (
                         body if isinstance(body, bytes)
                         else json.dumps(body).encode()),
                     headers=headers or {})
        r = conn.getresponse()
        data = r.read()
        return (r.status, r.getheader("Retry-After"),
                r.getheader("X-Request-Id"), json.loads(data))
    finally:
        conn.close()


def _drive(server, httpd, start, ck, filler):
    """The request script of the module docstring -> [(name, status,
    Retry-After, X-Request-Id, body)]; ``filler``, submitted in process
    before the worker starts, fills the one-request queue."""
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="test-http")
    t.start()
    g = ck.graphs
    out = []

    def post(name, body, headers=None):
        out.append((name, *_call(port, "POST", "/predict", body, headers)))

    try:
        out.append(("healthz", *_call(port, "GET", "/healthz")))
        # the queue holds one: a request submitted here fills it
        filler = server.submit(filler)
        post("queue_full", {"graph": _graph_json(g[1])})
        start()
        filler.result(60)
        post("valid", {"graph": _graph_json(g[1]), "class": "batch",
                       "tenant": "acme"}, {"X-Request-Id": "req-abc/1"})
        post("repeat", {"graph": _graph_json(g[1])})
        s = synthetic_dataset(1, seed=21)[0][1]
        post("structure", {"structure": {
            "lattice": s.lattice.tolist(),
            "frac_coords": s.frac_coords.tolist(),
            "numbers": s.numbers.tolist(), "id": "s0"}})
        out.append(("malformed_json", *_call(port, "POST", "/predict",
                                             b"{not json")))
        post("malformed_payload", {"neither": 1})
        post("malformed_graph", {"graph": {"atom_fea": [[1.0]]}})
        n = 4 * max(s.node_cap for s in server.shape_set)
        post("oversize", {"graph": {
            "atom_fea": np.zeros((n, g[0].atom_fea.shape[1])).tolist(),
            "edge_fea": np.zeros((n, g[0].edge_fea.shape[1])).tolist(),
            "centers": list(range(n)), "neighbors": list(range(n))}})
        post("unknown_class", {"graph": _graph_json(g[2]), "class": "vip"})
        post("timeout", {"graph": _graph_json(g[3]), "timeout_ms": 0.001})
        server.begin_drain()
        post("draining", {"graph": _graph_json(g[4])})
        out.append(("healthz_draining", *_call(port, "GET", "/healthz")))
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.drain(timeout_s=30)
    return out


def test_http_matches_jax(checkpoints, monkeypatch):
    import cgnn_tpu.native

    monkeypatch.setattr(cgnn_tpu.native, "neighbor_search_native",
                        lambda *a, **k: None)
    kw = dict(batch_size=8, rungs=2, max_queue=1, watch=False,
              log_fn=_quiet)
    jserver, _ = jload_server(checkpoints.jck,
                              calibration=[_jgraph(x) for x in
                                           checkpoints.graphs], **kw)
    want = _drive(jserver, jmake_http_server(jserver, port=0),
                  jserver.start, checkpoints,
                  _jgraph(checkpoints.graphs[0]))
    tserver, info = load_server(checkpoints.pck,
                                calibration=checkpoints.graphs,
                                device="cpu", warm=False, **kw)
    tserver.warm(info["template"])
    got = _drive(tserver, make_http_server(tserver, port=0),
                 tserver.start, checkpoints, checkpoints.graphs[0])
    assert [r[0] for r in got] == [r[0] for r in want]
    statuses = {r[0]: r[1] for r in got}
    assert statuses == {
        "healthz": 200, "queue_full": 429, "valid": 200, "repeat": 200,
        "structure": 200, "malformed_json": 400, "malformed_payload": 400,
        "malformed_graph": 400, "oversize": 413, "unknown_class": 400,
        "timeout": 504, "draining": 503, "healthz_draining": 503}
    preds = {}
    for (name, st, ra, rid, body), (_, jst, jra, jrid, jbody) in zip(got,
                                                                     want):
        assert (st, ra) == (jst, jra), name
        assert sorted(body) == sorted(jbody), name
        if name.startswith("healthz"):
            for k in ("ok", "ready", "warmed", "draining", "queue_depth"):
                assert body[k] == jbody[k], (name, k)
        elif st == 200:
            assert rid == body["trace_id"] and jrid == jbody["trace_id"]
            for k in ("cached", "class", "backfilled", "coalesced",
                      "precision", "wire", "device_id"):
                assert body[k] == jbody[k], (name, k)
            preds[name] = (body["prediction"], jbody["prediction"])
        else:
            assert body["reason"] == jbody["reason"] if "reason" in jbody \
                else "reason" not in body
    assert got[2][3] == want[2][3] == "req-abc/1"
    assert set(preds) == {"valid", "repeat", "structure"}
    for name, (a, b) in preds.items():
        for dt in (np.float32, np.float64):
            np.testing.assert_allclose(np.asarray(a, dt), np.asarray(b, dt),
                                       err_msg=name, **TOL)


def test_unported_routes_answer_404(checkpoints):
    server, _ = load_server(checkpoints.pck, batch_size=8, rungs=1,
                            calibration=checkpoints.graphs, device="cpu",
                            watch=False, log_fn=_quiet)
    httpd = make_http_server(server, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="test-http")
    t.start()
    port = httpd.server_address[1]
    try:
        for method, path in (("POST", "/label"), ("POST", "/cache-fill")):
            st, _, _, body = _call(port, method, path, {})
            assert st == 404 and body == {"error": f"unknown path {path}"}
        # the planes of item 11 answer as the JAX handler answers an
        # in-process server: the ring and the store are on by default,
        # the recorder and the profiler are the entry point's to attach
        for method, path, want in (("GET", "/trace", 200),
                                   ("GET", "/timeseries", 200),
                                   ("GET", "/flightrec", 501),
                                   ("POST", "/profile", 501)):
            st, _, _, body = _call(port, method, path,
                                   {} if method == "POST" else None)
            assert st == want, (path, body)
        st, _, _, body = _call(port, "POST", "/reload-control", {"pin": "x"})
        assert st == 501
        st, _, _, body = _call(port, "GET", "/stats")
        assert st == 200 and body["param_version"] == "ckpt-00000000"
    finally:
        httpd.shutdown()
        httpd.server_close()
        assert server.drain(timeout_s=30)


def test_graph_json_round_trip(checkpoints):
    from cgnn_tpu_torch.serve.http import graph_from_json, structure_from_json

    g = checkpoints.graphs[0]
    back = graph_from_json(dict(_graph_json(g),
                                distances=g.distances.tolist()))
    assert isinstance(back, CrystalGraph)
    for k in ("atom_fea", "edge_fea", "centers", "neighbors"):
        np.testing.assert_array_equal(getattr(back, k), getattr(g, k))
    # as in the JAX package, a client's distances are not read
    assert back.distances is None
    with pytest.raises(ValueError, match="malformed graph payload"):
        graph_from_json({"atom_fea": [[0.0]]})
    with pytest.raises(ValueError, match="malformed structure payload"):
        structure_from_json({"lattice": [[1, 0, 0]], "numbers": [1]})


def test_client_distances_never_decide_the_staging(checkpoints):
    """A graph posted with distances that disagree with its edge_fea off
    the compactability probe's sampled edges stages full, is answered
    from its edge_fea, and the row it caches is the honest graph's."""
    server, _ = load_server(checkpoints.pck, batch_size=8, rungs=1,
                            calibration=checkpoints.graphs, device="cpu",
                            watch=False, compact="on", log_fn=_quiet)
    assert server.shape_set.compact is not None
    httpd = make_http_server(server, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="test-http")
    t.start()
    port = httpd.server_address[1]
    g = checkpoints.graphs[2]
    lies = np.asarray(g.distances, np.float32).copy()
    n = len(lies)
    unsampled = np.ones(n, bool)  # the probe's sample (data/compact.py)
    unsampled[np.arange(0, n, max(1, n // 32))[:32]] = False
    assert unsampled.any()
    lies[unsampled] += 1.5
    try:
        server.start()
        packed = lambda: (server.counts["pack_compact"],  # noqa: E731
                          server.counts["pack_full"])
        c0, f0 = packed()
        st, _, _, body = _call(port, "POST", "/predict", {"graph": dict(
            _graph_json(g), distances=lies.tolist())})
        assert st == 200 and not body["cached"]
        assert packed() == (c0, f0 + 1)
        # the honest graph, as a client sends it: a hit on the same row
        st, _, _, hit = _call(port, "POST", "/predict",
                              {"graph": _graph_json(g)})
        assert st == 200 and hit["cached"]
        assert hit["prediction"] == body["prediction"]
        # the row is the full form's answer from the edge_fea sent
        honest = server.predict(dataclasses.replace(g, distances=None),
                                fingerprint="honest-full")
        assert not honest.cached and packed() == (c0, f0 + 2)
        np.testing.assert_array_equal(
            np.asarray(body["prediction"], np.float32), honest.prediction)
        # the compact form is live on this server: the same graph with
        # its true distances, submitted in process, stages compactly
        server.predict(g, fingerprint="honest-compact")
        assert packed() == (c0 + 1, f0 + 2)
    finally:
        httpd.shutdown()
        httpd.server_close()
        assert server.drain(timeout_s=30)
