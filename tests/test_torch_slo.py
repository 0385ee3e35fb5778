"""The SLO engine and time-series store of the port (``observe/slo.py``,
``observe/tsdb.py``) against the JAX package's on the CPU, and the
server's live plane against the JAX server's.

- ``SLOEngine``: both packages get the same events on the same fake
  clock and must make the same transitions (fire, resolve, the re-arm
  after a resolve, a pending alert cleared by a blip, a spike only the
  fast window sees), with equal ``state()``, ``gauges()``, budgets, burn
  rates and hook calls; class-scoped objectives and the default rules
  too.
- ``TimeSeriesStore``: the same appends give equal ``query`` for every
  name and resolution, ``names`` and ``stats`` (the 1m buckets the fold
  of the 10s ones, the ring and series bounds, NaN points, a registry
  snapshot's fan-out, the collector's tick with a broken hook).
- Two servers at their defaults on one checkpoint (a JAX ``train.py``
  model and its weights carried over), each with a flight recorder and a
  profile dir: their ``/metrics`` family names are equal apart from a
  listed set with no counterpart; ``GET /trace``, ``/flightrec`` and
  ``/timeseries`` bodies have the same keys; the port's ``POST /profile``
  answers 200 with the JAX record's keys, 409 while a capture runs and
  501 without a profile dir, as the JAX server answers that.
"""

import http.client
import json
import threading
import time

import pytest

from cgnn_tpu.observe import export as jexport
from cgnn_tpu.observe import flightrec as jflightrec
from cgnn_tpu.observe import hist as jhist
from cgnn_tpu.observe import slo as jslo
from cgnn_tpu.observe import tsdb as jtsdb
from cgnn_tpu.serve.http import make_http_server as jmake_http_server
from cgnn_tpu.serve.server import load_server as jload_server
from cgnn_tpu_torch.observe import export as texport
from cgnn_tpu_torch.observe import flightrec as tflightrec
from cgnn_tpu_torch.observe import hist as thist
from cgnn_tpu_torch.observe import slo as tslo
from cgnn_tpu_torch.observe import tsdb as ttsdb
from cgnn_tpu_torch.observe.export import parse_prometheus_text
from cgnn_tpu_torch.serve.http import make_http_server
from cgnn_tpu_torch.serve.server import load_server
from test_torch_serve_http import _jgraph, _quiet, checkpoints  # noqa: F401
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

PKGS = {"jax": (jslo, jtsdb, jexport, jhist),
        "torch": (tslo, ttsdb, texport, thist)}


# ------------------------------------------------------------ SLO engine


def _avail(slo):
    return slo.SLOObjective("avail", target=0.9, window_s=60.0)


def _rule(slo, for_s=1.0):
    return slo.BurnRateRule(fast_s=2.0, slow_s=8.0, factor=2.0, for_s=for_s)


def _lifecycle(slo, clk):
    """Fire, resolve and re-arm (the JAX test's script)."""
    fired, resolved = [], []
    eng = slo.SLOEngine((_avail(slo),), rules=(_rule(slo),),
                        clock=lambda: clk[0], on_fire=fired.append,
                        on_resolve=resolved.append)
    made, views = [], []
    for t in range(30):
        eng.record(True, 1.0, now=float(t))
    made.append(eng.evaluate(now=30.0))
    for t in range(31, 36):
        for _ in range(5):
            eng.record(False, 0.0, now=float(t))
    for now in (33.0, 34.5):
        clk[0] = now
        made.append(eng.evaluate())
        views.append((eng.state(), eng.gauges(), eng.firing()))
    for t in range(40, 60):
        eng.record(True, 1.0, now=float(t))
    clk[0] = 55.0
    made.append(eng.evaluate())
    views.append((eng.state(), eng.gauges(), eng.alerts()))
    for t in range(60, 65):
        for _ in range(5):
            eng.record(False, 0.0, now=float(t))
    for now in (62.0, 63.5):
        clk[0] = now
        made.append(eng.evaluate())
    views.append((eng.state(), eng.gauges(), eng.firing(),
                  list(eng.transitions)))
    return {"made": made, "views": views, "fired": fired,
            "resolved": resolved}


def _blip(slo, clk):
    fired = []
    eng = slo.SLOEngine((_avail(slo),), rules=(_rule(slo),),
                        clock=lambda: clk[0], on_fire=fired.append)
    for _ in range(5):
        eng.record(False, 0.0, now=10.0)
    made = [eng.evaluate(now=10.5)]
    for t in range(11, 25):
        for _ in range(20):
            eng.record(True, 1.0, now=float(t))
    made.append(eng.evaluate(now=24.0))
    clk[0] = 24.0
    return {"made": made, "fired": fired, "state": eng.state()}


def _spike(slo, clk):
    """A spike only the fast window sees: no alert."""
    eng = slo.SLOEngine((_avail(slo),), rules=(_rule(slo),),
                        clock=lambda: clk[0])
    for t in range(50):
        for _ in range(10):
            eng.record(True, 1.0, now=float(t))
    for _ in range(4):
        eng.record(False, 0.0, now=50.0)
    clk[0] = 50.5
    return {"made": eng.evaluate(),
            "burns": (eng.burn_rate("avail", 2.0),
                      eng.burn_rate("avail", 8.0)),
            "state": eng.state(), "gauges": eng.gauges()}


def _budget_and_status(slo, clk):
    eng = slo.SLOEngine((_avail(slo),), rules=(_rule(slo),),
                        clock=lambda: clk[0])
    for i in range(100):
        eng.record(i >= 5, 1.0, now=30.0)
    for st in (500, 503, 429, 200):
        eng.note_status(st, now=30.0)
    clk[0] = 30.0
    return {"budget": eng.budget("avail"), "state": eng.state(),
            "gauges": eng.gauges()}


def _classes_and_latency(slo, clk):
    """serve.py's objectives with a class-scoped one, and the default
    rules scaled to a 60 s window."""
    objectives = (
        slo.SLOObjective("availability", target=0.999, window_s=60.0),
        slo.SLOObjective("latency", target=0.95, latency_threshold_ms=100.0,
                         window_s=60.0),
        slo.SLOObjective("latency_batch", target=0.95,
                         latency_threshold_ms=400.0, window_s=60.0,
                         klass="batch"))
    fired = []
    eng = slo.SLOEngine(objectives, clock=lambda: clk[0],
                        on_fire=fired.append)
    made = []
    for t in range(40):
        clk[0] = float(t)
        for i in range(6):
            eng.record(True, 50.0 + 40.0 * (t % 7) + i,
                       klass=("batch", "interactive", None)[i % 3])
        if 20 <= t < 30:
            eng.record(False, 0.0, klass="batch")
            eng.record(True, 900.0, klass="batch")
        made.append(eng.evaluate())
    return {"made": made, "fired": fired, "state": eng.state(),
            "gauges": eng.gauges(),
            "rules": [(r.key, r.fast_s, r.slow_s, r.factor, r.for_s)
                      for r in slo.default_rules(60.0)]}


SCRIPTS = {"lifecycle": _lifecycle, "blip": _blip, "spike": _spike,
           "budget_and_status": _budget_and_status,
           "classes_and_latency": _classes_and_latency}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_slo_engine_matches_jax(script):
    got = SCRIPTS[script](tslo, [0.0])
    want = SCRIPTS[script](jslo, [0.0])
    assert got == want


def test_slo_lifecycle_fires_resolves_and_rearms():
    out = _lifecycle(tslo, [0.0])
    assert [[m["to"] for m in made] for made in out["made"]] == [
        [], ["pending"], ["firing"], ["resolved"], ["pending"], ["firing"]]
    assert len(out["fired"]) == 2 and len(out["resolved"]) == 1
    assert out["views"][-1][2][0]["fire_count"] == 2
    assert _blip(tslo, [0.0])["fired"] == []
    burn_fast, burn_slow = _spike(tslo, [0.0])["burns"]
    assert burn_fast > 2.0 > burn_slow


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_slo_validation(pkg):
    slo = PKGS[pkg][0]
    obj = _avail(slo)
    with pytest.raises(ValueError, match="at least one"):
        slo.SLOEngine(())
    with pytest.raises(ValueError, match="duplicate"):
        slo.SLOEngine((obj, obj))
    with pytest.raises(ValueError, match="target"):
        slo.SLOObjective("x", target=1.0)
    with pytest.raises(ValueError, match="fast_s"):
        slo.BurnRateRule(fast_s=8.0, slow_s=2.0, factor=2.0)


# ---------------------------------------------------- time-series store

RES = (("10s", 10.0), ("1m", 60.0))


def _dump(store):
    return {"names": store.names(), "stats": store.stats(),
            "res": store.resolutions(),
            "rings": {(n, r): store.query(n, r) for n in store.names()
                      for r in store.resolutions()}}


def _fold(tsdb, hist):
    store = tsdb.TimeSeriesStore(RES, clock=lambda: 0.0)
    for i in range(12):
        store.observe("lat", float(i + 1), now=i * 10.0)
    store.observe("lat", float("nan"), now=5.0)
    return store


def _bounds(tsdb, hist):
    store = tsdb.TimeSeriesStore(RES, points_per_tier=5, max_series=2)
    for i in range(20):
        store.observe("x", 1.0 + i, now=i * 10.0)
    store.observe("y", 2.0, now=0.0)
    store.observe("z", 3.0, now=0.0)  # past the cap: dropped
    store.observe("y", 4.0, now=1.0)
    store.observe("y", 5.0, now=-3.0)  # an earlier clock folds
    return store


def _snapshot(tsdb, hist):
    h = hist.Histogram(hist.log_bounds(0.1, 1000.0, 6))
    for v in (1.0, 2.0, 4.0, 350.0):
        h.observe(v)
    store = tsdb.TimeSeriesStore(RES)
    for t in (0.0, 11.0, 65.0):
        store.append_snapshot({
            "counters": {"served_total": 7 + t},
            "gauges": {"queue_depth": 3.0},
            "series": {"lat_ms": {"p50": 1.0, "p95": 2.0, "p99": 4.0}},
            "histograms": {"lat_ms_hist": h.snapshot(),
                           "empty_hist": hist.Histogram(
                               hist.log_bounds(1.0, 10.0, 2)).snapshot()},
        }, now=t)
    return store


STORES = {"fold": _fold, "bounds": _bounds, "snapshot": _snapshot}


@pytest.mark.parametrize("script", sorted(STORES))
def test_tsdb_matches_jax(script):
    got = _dump(STORES[script](ttsdb, thist))
    want = _dump(STORES[script](jtsdb, jhist))
    assert got == want


def test_tsdb_coarse_tier_is_the_fold_of_the_fine_tier():
    store = _fold(ttsdb, thist)
    fine, coarse = store.query("lat", "10s"), store.query("lat", "1m")
    assert len(fine) == 12 and len(coarse) == 2
    for cb in coarse:
        members = [b for b in fine if cb["t"] <= b["t"] < cb["t"] + 60.0]
        assert cb["count"] == sum(b["count"] for b in members)
        assert cb["sum"] == sum(b["sum"] for b in members)
        assert (cb["min"], cb["max"]) == (min(b["min"] for b in members),
                                          max(b["max"] for b in members))
    with pytest.raises(KeyError, match="unknown resolution"):
        store.query("lat", "5m")
    assert store.query("never-seen", "10s") == []
    with pytest.raises(ValueError):
        ttsdb.TimeSeriesStore(RES, points_per_tier=0)
    with pytest.raises(ValueError):
        ttsdb.TimeSeriesStore((("10s", 10.0), ("10s", 20.0)))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_collector_tick_survives_a_broken_hook(pkg):
    _, tsdb, export, _ = PKGS[pkg]
    reg = export.MetricsRegistry()
    reg.add_provider("p", lambda: {"gauges": {"g": 1.0},
                                   "counters": {"c": 2.0}})
    store = tsdb.TimeSeriesStore(RES, clock=lambda: 40.0)
    collector = tsdb.TsdbCollector(reg, store, interval_s=0.1)
    calls = []
    collector.add_on_tick(lambda: calls.append(1))

    def broken():
        raise RuntimeError("hook down")

    collector.add_on_tick(broken)
    assert collector.tick_once() >= 2
    assert collector.tick_once() >= 2
    assert len(calls) == 2 and collector.ticks == 2
    assert {"g", "c"} <= set(store.names())
    collector.start()
    time.sleep(0.35)
    collector.stop()
    assert collector.ticks >= 3
    with pytest.raises(ValueError):
        tsdb.TsdbCollector(reg, store, interval_s=0)


# ------------------------------------------------------- the two servers

# /metrics families one server exposes and the other has no counterpart
# for: the JAX server's peer cache-fill counters and the two gauges its
# cache rollup derives from them (ROADMAP item 12); the port's
# flush-failure, reload and per-tier batch counters
JAX_ONLY = {"cgnn_serve_cache_dup_misses_total", "cgnn_serve_cache_fills_total",
            "cgnn_serve_cache_fill_stale_total",
            "cgnn_serve_cache_dup_miss_total", "cgnn_serve_cache_fill_total"}
PORT_ONLY = {"cgnn_serve_batch_failures_total", "cgnn_serve_reloads_total",
             "cgnn_serve_batches_f32_total"}
# counters the JAX server starts at their first count, the port at zero
JAX_LAZY = {f"cgnn_serve_{k}_total" for k in (
    "pack_raw", "pack_compact", "pack_full", "responses_raw",
    "ingest_cap_overflow")}


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body).encode())
        r = conn.getresponse()
        data = r.read()
        ctype = r.getheader("Content-Type") or ""
        return r.status, (json.loads(data) if "json" in ctype
                          else data.decode())
    finally:
        conn.close()


def _serve(server, make_http):
    httpd = make_http(server, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="test-slo-http").start()
    return httpd, httpd.server_address[1]


def _plane(port, graphs, tick):
    """A burst (a repeat among it, one in the batch class), one collector
    tick, then the live plane's answers."""
    for i, g in enumerate(graphs + graphs[:1]):
        st, _ = _call(port, "POST", "/predict", {
            "graph": {"atom_fea": g.atom_fea.tolist(),
                      "edge_fea": g.edge_fea.tolist(),
                      "centers": g.centers.tolist(),
                      "neighbors": g.neighbors.tolist()},
            **({"class": "batch"} if i == 1 else {})})
        assert st == 200
    tick()
    out = {}
    for path in ("/metrics", "/trace", "/flightrec", "/timeseries",
                 "/timeseries?name=serve_responses&res=10s",
                 "/timeseries?name=serve_responses&res=5m"):
        out[path] = _call(port, "GET", path)
    return out


def test_live_plane_matches_the_jax_server(checkpoints, monkeypatch,
                                           tmp_path):
    import cgnn_tpu.native

    monkeypatch.setattr(cgnn_tpu.native, "neighbor_search_native",
                        lambda *a, **k: None)
    kw = dict(batch_size=8, rungs=2, watch=False, log_fn=_quiet,
              pack_workers=0)
    graphs = checkpoints.graphs[:4]
    jserver, _ = jload_server(
        checkpoints.jck, calibration=[_jgraph(x) for x in checkpoints.graphs],
        **kw)
    jserver.attach_flight_recorder(jflightrec.FlightRecorder(
        str(tmp_path / "jfr"), role="replica", registry=jserver.registry,
        tracer=jserver.tracer, log_fn=_quiet))
    jserver.start()
    jhttpd, jport = _serve(jserver, jmake_http_server)
    tserver, _ = load_server(checkpoints.pck,
                             calibration=checkpoints.graphs, device="cpu",
                             profile_dir=str(tmp_path / "prof"), **kw)
    tserver.attach_flight_recorder(tflightrec.FlightRecorder(
        str(tmp_path / "tfr"), role="replica", registry=tserver.registry,
        tracer=tserver.tracer, log_fn=_quiet))
    thttpd, tport = _serve(tserver, make_http_server)
    try:
        want = _plane(jport, [_jgraph(g) for g in graphs],
                      jserver._tsdb_collector.tick_once)
        got = _plane(tport, graphs, tserver._tsdb_collector.tick_once)
        for path in got:
            assert got[path][0] == want[path][0], path
        assert got["/timeseries?name=serve_responses&res=5m"][0] == 400
        gfam = parse_prometheus_text(got["/metrics"][1])
        wfam = parse_prometheus_text(want["/metrics"][1])
        extra = set(gfam) - set(wfam)
        assert set(wfam) - set(gfam) <= JAX_ONLY
        assert extra - JAX_LAZY <= PORT_ONLY | {
            "cgnn_profile_captures", "cgnn_profile_busy"}, sorted(extra)
        for name in ("cgnn_slo_availability_budget_remaining",
                     "cgnn_slo_latency_burn_fast", "cgnn_slo_alerts_firing",
                     "cgnn_tsdb_series", "cgnn_observe_trace_ring",
                     "cgnn_flightrec_bundles",
                     "cgnn_serve_class_latency_ms_hist",
                     "cgnn_serve_version_latency_ms_hist",
                     "cgnn_serve_cache_lookup_ms_hist"):
            assert name in gfam and name in wfam, name
        assert gfam["cgnn_serve_class_latency_ms_hist"]["histogram"].keys() \
            == wfam["cgnn_serve_class_latency_ms_hist"]["histogram"].keys()
        assert gfam["cgnn_serve_cache_lookup_ms_hist"]["histogram"].keys() \
            == {'{form="feat",outcome="hit",tier="f32"}',
                '{form="feat",outcome="miss",tier="f32"}'}
        for path in ("/trace", "/flightrec", "/timeseries",
                     "/timeseries?name=serve_responses&res=10s"):
            assert sorted(got[path][1]) == sorted(want[path][1]), path
        names = {e["name"] for e in got["/trace"][1]["events"]}
        assert {"serve.request", "serve.pack", "serve.dispatch"} <= names
        assert got["/trace"][1]["role"] == "replica"
        fr = got["/flightrec"][1]
        assert [r["status"] for r in fr["requests"]] == [
            r["status"] for r in want["/flightrec"][1]["requests"]]
        assert sorted(fr["requests"][0]) == sorted(
            want["/flightrec"][1]["requests"][0])
        assert set(got["/timeseries"][1]["names"]) >= {
            "serve_responses", "slo_alerts_firing", "tsdb_series"}
        points = got["/timeseries?name=serve_responses&res=10s"][1]["points"]
        assert points[-1]["last"] == len(graphs)
        stats = tserver.stats()
        assert stats["slo"]["events"] == len(graphs) + 1
        assert stats["slo"].keys() == jserver.stats()["slo"].keys()

        # POST /profile: a record, then 409 while a capture runs
        st, rec = _call(tport, "POST", "/profile", {"duration_ms": 50})
        assert st == 200 and {"ok", "dir", "duration_s", "files",
                              "bytes"} <= set(rec), rec
        assert rec["files"] >= 1 and rec["bytes"] > 0
        slow = {}
        t = threading.Thread(target=lambda: slow.update(r=_call(
            tport, "POST", "/profile", {"duration_ms": 1500})),
            name="test-slo-profile")
        t.start()
        deadline = time.monotonic() + 30
        while not tserver.profiler.busy and time.monotonic() < deadline:
            time.sleep(0.01)
        st, body = _call(tport, "POST", "/profile", {"duration_ms": 50})
        t.join()
        assert st == 409 and body["reason"] == "busy"
        assert slow["r"][0] == 200
        assert tserver.stats()["profile"]["captures"] == 2
        assert tserver.stats()["profile"]["rejected"] == 1
        # no profile dir: 501 on both
        assert _call(jport, "POST", "/profile", {})[0] == 501
    finally:
        for h in (jhttpd, thttpd):
            h.shutdown()
            h.server_close()
        assert tserver.drain(timeout_s=30)
        jserver.drain(timeout_s=30)
    bare, _ = load_server(checkpoints.pck, calibration=checkpoints.graphs,
                          device="cpu", warm=False, **kw)
    bhttpd, bport = _serve(bare, make_http_server)
    try:
        assert _call(bport, "POST", "/profile", {})[0] == 501
    finally:
        bhttpd.shutdown()
        bhttpd.server_close()
