"""``GET /metrics`` of the port's server (``serve/http.py`` over
``InferenceServer.registry``) against the JAX server's on the CPU.

A model that JAX ``train.py`` trained serves through the JAX server, and
the same weights (``jax_checkpoint_to_torch.py``) through the port's
(test_torch_serve_http.py's fixture). Both take the same fixed burst, one
request at a time so every flush holds one request on both sides: six
graphs, a repeat (a cache hit), a wire-form structure (featurized on the
packer), a graph in the batch class, and three rejections (oversize,
malformed, an unknown class). Then each is scraped over HTTP and parsed
with the port's ``parse_prometheus_text``:

- the content type is the JAX handler's;
- every counter family both expose has the same value, the packers'
  seconds excepted (``pipeline_pack_s``, ``pipeline_wait_s``); the JAX
  server's own families are those of planes the port has not ported
  (peer cache fill, item 12), the port's own its flush-failure, reload
  and per-tier batch counters;
- the gauge names are the JAX server's (the SLO engine's, the
  time-series store's and the trace ring's among them) less the two the
  cache rollup derives from peer cache fill, and the gauges that do not
  read a clock have the same values, each rung's edge occupancy among
  them (the store's fill follows its collector's clock);
- the latency, queue-wait and occupancy histograms and the rolling
  summaries count the same observations (their values are times);
- the counters equal ``stats()``'s counts.

Both run with telemetry off and with it on (``epoch``: the ``serve_*``
counter mirror, the series and the spans). A raw-wire server of the port
reports each rung's device-counted edge occupancy in (0, 1].
"""

import http.client
import re

import numpy as np
import pytest

from cgnn_tpu.data.graph import CrystalGraph as JGraph
from cgnn_tpu.data.rawbatch import RawStructure as JRawStructure
from cgnn_tpu.observe.telemetry import Telemetry as JTelemetry
from cgnn_tpu.serve.batcher import ServeRejection as JServeRejection
from cgnn_tpu.serve.http import make_http_server as jmake_http_server
from cgnn_tpu.serve.server import load_server as jload_server
from cgnn_tpu_torch.data.dataset import load_synthetic
from cgnn_tpu_torch.data.graph import CrystalGraph
from cgnn_tpu_torch.data.rawbatch import RawStructure
from cgnn_tpu_torch.data.synthetic import synthetic_dataset
from cgnn_tpu_torch.observe.export import parse_prometheus_text
from cgnn_tpu_torch.observe.metrics_io import read_jsonl
from cgnn_tpu_torch.observe.telemetry import Telemetry
from cgnn_tpu_torch.serve.batcher import ServeRejection
from cgnn_tpu_torch.serve.http import make_http_server
from cgnn_tpu_torch.serve.server import load_server
from test_torch_serve_http import _jgraph, _quiet, checkpoints  # noqa: F401
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
TIMED = {"cgnn_pipeline_pack_s_total", "cgnn_pipeline_wait_s_total"}
# the JAX server's counters of peer cache fill (item 12), and the gauges
# its cache rollup derives from them
JAX_ONLY = {"cgnn_serve_cache_dup_misses_total", "cgnn_serve_cache_fills_total",
            "cgnn_serve_cache_fill_stale_total"}
JAX_ONLY_GAUGES = {"cgnn_serve_cache_dup_miss_total",
                   "cgnn_serve_cache_fill_total"}
# the port's own counters: failed flushes, hot reloads, batches a tier
PORT_ONLY = re.compile(r"^cgnn_serve_(batch_failures|reloads|batches_f32)"
                       r"(_raw)?_total$")
# counters both servers keep, the JAX one from their first count, the
# port's from zero
JAX_LAZY = {f"cgnn_serve_{k}_total" for k in (
    "pack_raw", "pack_compact", "pack_full", "responses_raw",
    "ingest_cap_overflow")}
# gauges whose value reads a clock or the run's timing (the store's
# fill: the collector's ticks)
CLOCKED = re.compile(r"_(s|ms)$|pipeline_|^cgnn_tsdb_")


def _scrape(httpd):
    import threading

    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="test-metrics-http")
    t.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1],
                                          timeout=60)
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        body = r.read().decode()
        conn.close()
        return r.status, r.getheader("Content-Type"), body
    finally:
        httpd.shutdown()
        httpd.server_close()


def _burst(server, graphs, structure, graph_type, rejection):
    for g in graphs[:6]:
        server.predict(g, timeout_ms=30000)
    server.predict(graphs[0], timeout_ms=30000)  # a cache hit
    server.predict(structure, timeout_ms=30000)
    server.predict(graphs[6], timeout_ms=30000, klass="batch",
                   tenant="acme")
    n = 4 * max(s.node_cap for s in server.shape_set)
    g0 = graphs[0]
    bad = [graph_type(np.zeros((n, g0.atom_fea.shape[1]), np.float32),
                      np.zeros((n, g0.edge_fea.shape[1]), np.float32),
                      np.arange(n, dtype=np.int32),
                      np.arange(n, dtype=np.int32), np.zeros(1, np.float32)),
           graph_type(g0.atom_fea[:, :3], g0.edge_fea, g0.centers,
                      g0.neighbors, g0.target)]
    for g in bad:
        with pytest.raises(rejection):
            server.predict(g, timeout_ms=30000)
    with pytest.raises(rejection):
        server.predict(graphs[7], timeout_ms=30000, klass="vip")


def _families(text, kind):
    return {name: fam for name, fam in parse_prometheus_text(text).items()
            if fam["type"] == kind}


def _value(fam):
    (labels, v), = fam["samples"]
    return v


@pytest.mark.parametrize("level", ["off", "epoch"])
def test_metrics_match_the_jax_server(checkpoints, monkeypatch, tmp_path,
                                      level):
    import cgnn_tpu.native

    monkeypatch.setattr(cgnn_tpu.native, "neighbor_search_native",
                        lambda *a, **k: None)
    rs = synthetic_dataset(1, seed=21)[0][1]
    structure = RawStructure(rs.frac_coords, rs.lattice, rs.numbers)
    kw = dict(batch_size=8, rungs=2, watch=False, log_fn=_quiet,
              pack_workers=0)
    jtel = (JTelemetry("epoch", str(tmp_path / "j"), use_clu=False)
            if level == "epoch" else None)
    jserver, _ = jload_server(
        checkpoints.jck, calibration=[_jgraph(x) for x in checkpoints.graphs],
        telemetry=jtel, **kw)
    jserver.start()
    _burst(jserver, [_jgraph(g) for g in checkpoints.graphs],
           JRawStructure(rs.frac_coords, rs.lattice, rs.numbers), JGraph,
           JServeRejection)
    jstatus, jtype, jtext = _scrape(jmake_http_server(jserver, port=0))
    ttel = (Telemetry("epoch", str(tmp_path / "t")) if level == "epoch"
            else None)
    tserver, _ = load_server(checkpoints.pck,
                             calibration=checkpoints.graphs, device="cpu",
                             telemetry=ttel, **kw)
    _burst(tserver, checkpoints.graphs, structure, CrystalGraph,
           ServeRejection)
    status, ctype, text = _scrape(make_http_server(tserver, port=0))
    assert (status, ctype) == (jstatus, jtype) == (200, CONTENT_TYPE)

    got, want = _families(text, "counter"), _families(jtext, "counter")
    assert set(want) - set(got) <= JAX_ONLY
    # the port's own families, and zeros of counters the JAX server keeps
    # too but starts only at their first count
    extra = {n for n in set(got) - set(want) if not PORT_ONLY.match(n)}
    assert extra <= JAX_LAZY and all(_value(got[n]) == 0 for n in extra), \
        sorted(extra)
    for name in set(got) & set(want) - TIMED:
        assert _value(got[name]) == _value(want[name]), name
    assert _value(got["cgnn_serve_requests_total"]) == 12
    assert _value(got["cgnn_serve_cache_hits_total"]) == 1
    stats = tserver.stats()
    for k, v in stats["counts"].items():
        name = f"cgnn_serve_{k}_total"
        if name in got:
            assert _value(got[name]) == v, k

    got_g, want_g = _families(text, "gauge"), _families(jtext, "gauge")
    assert set(got_g) == set(want_g) - JAX_ONLY_GAUGES
    assert "cgnn_ingest_rung0_edge_occupancy" in got_g
    for name in got_g:
        if not CLOCKED.search(name):
            assert got_g[name]["samples"] == want_g[name]["samples"], name

    got_h, want_h = _families(text, "histogram"), _families(jtext,
                                                             "histogram")
    for name in ("cgnn_serve_latency_ms_hist",
                 "cgnn_serve_queue_wait_ms_hist",
                 "cgnn_serve_flush_occupancy_hist"):
        g, w = got_h[name]["histogram"][""], want_h[name]["histogram"][""]
        assert g["count"] == w["count"] > 0 and g["bounds"] == w["bounds"]
    assert got_h["cgnn_serve_flush_occupancy_hist"]["histogram"][""] == \
        want_h["cgnn_serve_flush_occupancy_hist"]["histogram"][""]
    got_s, want_s = _families(text, "summary"), _families(jtext, "summary")
    assert set(got_s) == set(want_s)
    for name in got_s:
        count = [v for lbl, v in got_s[name]["samples"]
                 if lbl.endswith("_count")]
        assert count == [v for lbl, v in want_s[name]["samples"]
                         if lbl.endswith("_count")], name
    assert stats["rolling"]["latency_ms"]["count"] == 9
    assert stats["rolling"]["window_s"] == 60.0

    tserver.drain(timeout_s=30)
    jserver.drain(timeout_s=30)
    if level == "epoch":
        ttel.close()
        jtel.close()
        summary = read_jsonl(str(tmp_path / "t" / "metrics.jsonl"))[-1]
        want_sum = read_jsonl(str(tmp_path / "j" / "metrics.jsonl"))[-1]
        assert summary["event"] == want_sum["event"] == "run_summary"
        for k, v in want_sum["counters"].items():
            if k.startswith("serve_") and k in summary["counters"]:
                assert summary["counters"][k] == v, k
        assert summary["gauges"]["serve_drained_clean"] == 1.0
        assert summary["gauges"]["device0_dispatches"] == want_sum[
            "gauges"]["device0_dispatches"]
        import json

        names = {e["name"] for e in json.load(open(
            tmp_path / "t" / "trace.json"))["traceEvents"]}
        assert {"serve.request", "serve.pack", "serve.dispatch"} <= names


def test_raw_wire_edge_occupancy(checkpoints):
    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager

    data_cfg = DataConfig.from_meta(
        CheckpointManager(checkpoints.pck).read_meta()["data"])
    calibration = load_synthetic(24, data_cfg.featurize_config(), seed=8,
                                 keep_geometry=True)
    server, _ = load_server(checkpoints.pck, batch_size=8, rungs=2,
                            calibration=calibration, device="cpu",
                            wire="raw", watch=False, log_fn=_quiet)
    try:
        assert server.shape_set.raw is not None
        futs = [server.submit(RawStructure(t[1].frac_coords, t[1].lattice,
                                           t[1].numbers))
                for t in synthetic_dataset(12, seed=5)]
        for f in futs:
            f.result(60)
        text = server.registry.prometheus_text()
    finally:
        server.drain(timeout_s=30)
    fams = _families(text, "gauge")
    occ = {n: _value(f) for n, f in fams.items()
           if re.match(r"cgnn_ingest_rung\d+_edge_occupancy$", n)}
    assert occ and all(0.0 < v <= 1.0 for v in occ.values()), occ
    assert _value(fams["cgnn_ingest_raw_wire"]) == 1.0
    assert _value(_families(text, "counter")[
        "cgnn_serve_responses_raw_total"]) > 0
    assert server.stats()["ingest"]["rung_edge_occupancy"]
