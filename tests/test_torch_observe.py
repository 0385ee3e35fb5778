"""The port's observability core (``cgnn_tpu_torch/observe``) against the
JAX package's (``cgnn_tpu/observe``) on the CPU, on the same inputs.

- Text outputs byte for byte: histogram snapshots and exposition lines,
  the bucket layouts, ``MetricsRegistry.prometheus_text()`` for the same
  telemetry, providers and observations, ``parse_prometheus_text`` round
  trips (each parser on each side's text), ``json_log_fn`` and
  ``MetricsLogger`` lines at one fixed clock, each gauge function's
  output on the same counters and padding statistics, and the telemetry
  facade's ``run_summary``.
- ``SpanTracer``'s export: the same events, nesting, threads and
  metadata (timestamps are wall time and differ).
- The manifest: the JAX keys, with the port's inventory in place of
  ``jax_version``.
- ``StepStream``: the device ring on the CPU (one record a tap, the JAX
  record's keys and means, rows lost to overwrites counted, rows inside
  ``muted()`` dropped, rates from the marks).
- Grad health with transplanted weights and the same batch, against
  ``cgnn_tpu/observe/health.py`` inside the JAX train step: in f32 within
  the step tests' ``GRAD_TOL`` (rtol 2e-3, atol 1e-4); in f64 the norms
  within rtol 1e-9 of the same norms taken in float64 from the JAX step's
  own gradients and update (the JAX module rounds its norms to f32, so
  its values are held within f32 round-off, rtol 1e-6), the NaN/Inf
  counts equal.
"""

import io
import json
import math
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.observe import export as jexport
from cgnn_tpu.observe import gauges as jgauges
from cgnn_tpu.observe import hist as jhist
from cgnn_tpu.observe import log as jlog
from cgnn_tpu.observe import manifest as jmanifest
from cgnn_tpu.observe import metrics_io as jmio
from cgnn_tpu.observe import spans as jspans
from cgnn_tpu.observe import stream as jstream
from cgnn_tpu.observe.telemetry import Telemetry as JTelemetry
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.state import TrainState as JTrainState
from cgnn_tpu.train.state import make_optimizer as jmake_optimizer
from cgnn_tpu.train.step import make_train_step as jmake_train_step
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.observe import export as texport
from cgnn_tpu_torch.observe import gauges as tgauges
from cgnn_tpu_torch.observe import health as thealth
from cgnn_tpu_torch.observe import hist as thist
from cgnn_tpu_torch.observe import log as tlog
from cgnn_tpu_torch.observe import manifest as tmanifest
from cgnn_tpu_torch.observe import metrics_io as tmio
from cgnn_tpu_torch.observe import spans as tspans
from cgnn_tpu_torch.observe import stream as tstream
from cgnn_tpu_torch.observe.telemetry import Telemetry
from cgnn_tpu_torch.train import state as tstate
from cgnn_tpu_torch.train.normalizer import Normalizer
from cgnn_tpu_torch.train.step import make_train_step
from test_torch_train import (
    GRAD_TOL,
    SMALL,
    JNet,
    M,
    _graphs,
    _jax_variables,
    _port,
    _port_model,
)
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

# dyadic values: their sums are exact, so merged and pooled agree bitwise
OBS = [0.125, 0.5, 3.0, 17.25, 250.0, 0.0625, 99999.0, 1.5, float("nan"),
       4.0, 0.09375, 60000.0, 2.0]


def _both_hists(bounds_name):
    j = jhist.Histogram(getattr(jhist, bounds_name))
    t = thist.Histogram(getattr(thist, bounds_name))
    for v in OBS:
        j.observe(v)
        t.observe(v)
    return j, t


# ---------------------------------------------------------------------------
# hist
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["LATENCY_MS_BOUNDS", "QUEUE_WAIT_MS_BOUNDS",
                                  "OCCUPANCY_BOUNDS"])
def test_histogram_snapshot_and_exposition_match_jax(name):
    assert getattr(thist, name) == getattr(jhist, name)
    j, t = _both_hists(name)
    assert t.snapshot() == j.snapshot()
    assert t.cumulative() == j.cumulative()
    labels = {"replica": "3"}
    assert (t.exposition_lines("cgnn_x_hist", labels=labels)
            == j.exposition_lines("cgnn_x_hist", labels=labels))
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert thist.quantile_from_snapshot(t.snapshot(), q) == \
            jhist.quantile_from_snapshot(j.snapshot(), q)
    assert thist.log_bounds(0.3, 7.0, 5) == jhist.log_bounds(0.3, 7.0, 5)


def test_histogram_merge_and_family_round_trip_match_jax():
    j, t = _both_hists("LATENCY_MS_BOUNDS")
    j2, t2 = jhist.Histogram(), thist.Histogram()
    for v in (0.25, 8.0, 8.0, 1e6):
        j2.observe(v)
        t2.observe(v)
    assert t.merge(t2).snapshot() == j.merge(j2).snapshot()
    lines_t = t.exposition_lines("cgnn_h", labels={"rung": "1"})
    lines_j = j.exposition_lines("cgnn_h", labels={"rung": "1"})
    fam = {"samples": [(ln.rsplit(" ", 1)[0], float(ln.rsplit(" ", 1)[1]))
                       for ln in lines_t]}
    got = thist.snapshots_from_family(fam)
    assert got == jhist.snapshots_from_family(
        {"samples": [(ln.rsplit(" ", 1)[0], float(ln.rsplit(" ", 1)[1]))
                     for ln in lines_j]})
    assert got['{rung="1"}']["counts"] == t.snapshot()["counts"]
    maps = [{"": t.snapshot()}, {"": t2.snapshot()}]
    assert thist.merge_snapshot_maps(maps) == jhist.merge_snapshot_maps(maps)
    with pytest.raises(ValueError, match="different bounds"):
        t.merge(thist.Histogram(thist.OCCUPANCY_BOUNDS))


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def _fill_telemetry(tel):
    tel.counter_add("serve_requests", 7)
    tel.counter_add("pipeline_jobs", 3)
    tel.counter_add("serve_cache_lookup_hits", 2)
    tel.set_gauge("device0_occupancy", 0.5)
    tel.set_gauge("device1_occupancy", 0.25)
    tel.set_gauge("ingest_rung0_edge_occupancy", 0.75)
    tel.set_gauge("replica2_up", 1.0)
    tel.set_gauge("poisoned", float("nan"))
    for v in (1.0, 2.0, 4.0, 8.0, 16.0):
        tel.observe_value("serve_latency_ms", v)


def _registries(tmp_path):
    jt = JTelemetry("epoch", str(tmp_path / "j"), use_clu=False)
    tt = Telemetry("epoch", str(tmp_path / "t"))
    _fill_telemetry(jt)
    _fill_telemetry(tt)
    j, t = _both_hists("LATENCY_MS_BOUNDS")
    provider = {
        "counters": {"serve_batches": 4.0, "x_total": 1.0},
        "gauges": {"serve_queue_depth": 2.0, "device0_inflight": 1.0},
        "series": {"serve_batch_occupancy": {"p50": 0.5, "p95": 0.75,
                                             "p99": 1.0, "mean": 0.6,
                                             "count": 3}},
    }
    jr = jexport.MetricsRegistry(window_s=60.0).attach_telemetry(jt)
    tr = texport.MetricsRegistry(window_s=60.0).attach_telemetry(tt)
    jr.add_provider("serve", lambda: dict(
        provider, histograms={"serve_latency_ms_hist": j.snapshot(),
                              'serve_class_ms_hist{class="batch"}':
                                  j.snapshot()}))
    tr.add_provider("serve", lambda: dict(
        provider, histograms={"serve_latency_ms_hist": t.snapshot(),
                              'serve_class_ms_hist{class="batch"}':
                                  t.snapshot()}))
    jr.add_provider("broken", lambda: 1 / 0)
    tr.add_provider("broken", lambda: 1 / 0)
    return jr, tr, jt, tt


def test_prometheus_text_matches_jax_byte_for_byte(tmp_path):
    jr, tr, jt, tt = _registries(tmp_path)
    text = tr.prometheus_text()
    assert text == jr.prometheus_text()
    assert "cgnn_device_occupancy" in text and 'device="1"' in text
    assert tr.last_provider_errors.keys() == jr.last_provider_errors.keys()
    snap_t, snap_j = tr.snapshot(), jr.snapshot()
    snap_t.pop("time"), snap_j.pop("time")
    assert json.dumps(tmio.jsonfinite(snap_t), sort_keys=True) == \
        json.dumps(jmio.jsonfinite(snap_j), sort_keys=True)
    # each parser on each side's text: the same families and samples
    want = jexport.parse_prometheus_text(text)
    assert texport.parse_prometheus_text(text) == want
    assert want["cgnn_serve_latency_ms_hist"]["type"] == "histogram"
    got = want["cgnn_serve_latency_ms_hist"]["histogram"][""]
    assert got["counts"] == _both_hists("LATENCY_MS_BOUNDS")[1].snapshot()[
        "counts"]
    with pytest.raises(ValueError, match="not a valid sample"):
        texport.parse_prometheus_text("cgnn_x 1\nbroken line here\n")
    jt.close()
    tt.close()


def test_rolling_series_and_live_writer_match_jax(tmp_path):
    clock = [100.0]
    j = jexport.RollingSeries(window_s=10.0, max_samples=4,
                              clock=lambda: clock[0])
    t = texport.RollingSeries(window_s=10.0, max_samples=4,
                              clock=lambda: clock[0])
    for i, v in enumerate([5.0, 1.0, 3.0, 9.0, 7.0, 2.0]):
        clock[0] = 100.0 + 3 * i
        j.add(v)
        t.add(v)
        assert t.quantiles() == j.quantiles()
        assert t.quantiles(window_s=4.0) == j.quantiles(window_s=4.0)
    assert (t.evicted, t.total_count) == (j.evicted, j.total_count)
    jr, tr, jt, tt = _registries(tmp_path)
    wt = texport.LiveMetricsWriter(tr, str(tmp_path / "live.jsonl"),
                                   interval_s=0.05).start()
    time.sleep(0.3)
    wt.stop()
    lines = tmio.read_jsonl(str(tmp_path / "live.jsonl"))
    assert len(lines) == wt.writes >= 2
    want = jr.snapshot()
    for got in lines:
        assert set(got) == set(want)
        assert got["counters"] == want["counters"]
    jt.close()
    tt.close()


# ---------------------------------------------------------------------------
# metrics_io, log, spans, manifest
# ---------------------------------------------------------------------------


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1754300000.125)


def test_metrics_logger_lines_match_jax(tmp_path, fixed_clock):
    jl = jmio.MetricsLogger(str(tmp_path / "j"), use_clu=False)
    tl = tmio.MetricsLogger(str(tmp_path / "t"), use_clu=True)
    for lg in (jl, tl):
        lg.write(3, {"loss": 0.5, "mae": float("nan"), "steps": 4,
                     "name": "x"}, prefix="train")
        lg.write(4, {"a": 1})
        lg.event("step", {"phase": "train", "step": 2,
                          "loss": float("inf"), "count": 8.0})
        lg.close()
    got = open(tmp_path / "t" / "metrics.jsonl").read()
    assert got == open(tmp_path / "j" / "metrics.jsonl").read()
    assert "NaN" not in got and "Infinity" not in got
    assert tmio.read_jsonl(str(tmp_path / "t" / "metrics.jsonl")) == \
        jmio.read_jsonl(str(tmp_path / "j" / "metrics.jsonl"))


def test_json_log_lines_match_jax(fixed_clock):
    outs = []
    for mod in (jlog, tlog):
        buf = io.StringIO()
        log = mod.json_log_fn("replica", stream=buf)
        log("serve: plain", 3)
        with mod.bind_trace("req-ab12/7"):
            assert mod.current_trace_id() == "req-ab12/7"
            log("serve: bound", float("nan"), file=None)
        assert mod.current_trace_id() == ""
        buf.write(mod.format_record("extra", "router", 42, trace_id="t-1",
                                    score=float("inf"), level="warn")
                  + "\n")
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    recs = [json.loads(line) for line in outs[1].splitlines()]
    assert recs[1]["trace_id"] == "req-ab12/7" and recs[2]["score"] is None
    buf = io.StringIO()
    logger = tlog.setup_json_logging("trainer", stream=buf)
    tlog.setup_json_logging("trainer", stream=buf)  # idempotent
    logger.info("hello %s", "there")
    line = json.loads(buf.getvalue())
    assert line["msg"] == "hello there" and line["level"] == "info"
    assert len(buf.getvalue().splitlines()) == 1


def _drive_tracer(tracer):
    with tracer.span("epoch", epoch=0, driver="scan"):
        with tracer.span("eval", epoch=0):
            tracer.instant("mark", n=1)
    t0 = tracer.now_s()
    tracer.complete("serve.request", t0 + 0.002, t0, trace_id="r1",
                    queue_ms=float("nan"))

    def other():
        with tracer.span("checkpoint_save", is_best=True):
            pass

    th = threading.Thread(target=other, name="test-other")
    th.start()
    th.join()


def _strip(doc):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in doc["traceEvents"]]


def test_span_tracer_export_matches_jax(tmp_path):
    jt, tt = jspans.SpanTracer(max_events=3), tspans.SpanTracer(max_events=3)
    _drive_tracer(jt)
    _drive_tracer(tt)
    jp = jt.export(str(tmp_path / "j" / "trace.json"))
    tp = tt.export(str(tmp_path / "t" / "trace.json"))
    jdoc, tdoc = json.load(open(jp)), json.load(open(tp))
    assert _strip(tdoc) == _strip(jdoc)
    assert tdoc["displayTimeUnit"] == "ms"
    assert tt.dropped == jt.dropped == 2
    for e in tdoc["traceEvents"]:
        if e.get("ph") == "X":
            assert e["dur"] >= 0
    tw, jw = tt.window(), jt.window()
    assert set(tw) == set(jw) and tw["dropped"] == 2


def test_manifest_has_the_jax_keys_with_the_port_inventory(tmp_path):
    got = json.load(open(tmanifest.write_manifest(
        str(tmp_path), {"lr": 0.1, "obj": object(), "ms": [1, 2]},
        task="regression")))
    want = jmanifest.build_manifest({"lr": 0.1}, task="regression")
    assert set(got) == (set(want) - {"jax_version"}
                        | {"torch_version", "cuda_version"})
    assert got["torch_version"] == torch.__version__
    assert got["backend"] == "cpu" and got["device_count"] == 1
    assert got["devices"] == [{"id": 0, "kind": "cpu", "platform": "cpu"}]
    assert got["config"] == {"lr": 0.1, "ms": [1, 2]}
    assert got.get("git_sha") == want.get("git_sha")


# ---------------------------------------------------------------------------
# gauges
# ---------------------------------------------------------------------------

COUNTERS = {"ingest_cap_overflow": 2.0, "serve_responses_backfilled": 3.0,
            "serve_responses_class_interactive": 5.0,
            "serve_responses_class_batch": 15.0,
            "serve_cache_lookup_hits": 4.0, "serve_cache_lookup_misses": 12.0,
            "serve_requests": 20.0, "serve_cache_hits": 3.0,
            "serve_cache_coalesced": 1.0, "serve_cache_dup_misses": 0.0,
            "serve_cache_fills": 2.0, "fleet_owner_routed": 3.0,
            "fleet_owner_fallback": 1.0, "pipeline_wait_s": 0.5,
            "pipeline_pack_s": 1.5, "pipeline_jobs": 6.0}
GAUGES = {"device_count": 3.0, "device0_dispatches": 4.0,
          "device1_dispatches": 0.0, "device2_dispatches": 12.0,
          "ingest_rung0_edge_occupancy": 0.25,
          "ingest_rung2_edge_occupancy": 0.875, "ingest_raw_wire": 1.0,
          "serve_padding_fill_share": 0.4, "serve_backfill_enabled": 1.0,
          "serve_cache_capacity": 64.0, "serve_cache_size": 16.0,
          "pipeline_occupancy": 0.5}


@pytest.mark.parametrize("fn", ["device_gauges", "ingest_gauges",
                                "priority_gauges", "cache_gauges",
                                "pipeline_gauges"])
def test_gauge_rollups_match_jax(fn):
    for counters, gauges in ((COUNTERS, GAUGES), ({}, {})):
        got = getattr(tgauges, fn)(dict(counters), dict(gauges))
        assert json.dumps(got) == json.dumps(getattr(jgauges, fn)(
            dict(counters), dict(gauges)))


def test_padding_gauges_match_jax():
    graphs = _graphs(30, seed=5)
    jstats, tstats = jgraph.PaddingStats(), tgraph.PaddingStats()
    for cap in (10, 7):
        nc, ec = jgraph.capacities_for(graphs, cap, dense_m=M, snug=True)
        list(jstats.wrap(jgraph.batch_iterator(
            graphs, cap, nc, ec, dense_m=M, snug=True)))
        list(tstats.wrap(tgraph.batch_iterator(
            [_port(g) for g in graphs], cap, nc, ec, dense_m=M, snug=True)))
    got = tgauges.padding_gauges(tstats)
    assert json.dumps(got) == json.dumps(jgauges.padding_gauges(jstats))
    assert got[-1]["bucket"] == "overall" and got[-1]["shapes"] == 2
    cpu = tgauges.hbm_gauges()
    assert cpu == [{"device": "cpu", "kind": "cpu", "platform": "cpu",
                    "source": "unknown"}]
    assert tgauges.device_hbm_table_bytes("TPU v5 lite") is None


# ---------------------------------------------------------------------------
# the telemetry facade
# ---------------------------------------------------------------------------


def _facade_calls(tel):
    tel.write_epoch(0, {"loss": 1.5, "mae": 0.5}, {"mae": 0.75})
    with tel.span("pack"):
        pass
    tel.counter_add("scan_steps", 12)
    tel.counter_add("per_step_steps", 4)
    with tel.warmup():
        tel.counter_add("scan_steps", 100)  # muted: warm-up is no work
    tel.set_gauge("train_epoch", 0.0)
    tel.set_gauge("device_count", 1.0)
    tel.set_gauge("device0_dispatches", 5.0)
    for v in (1.0, 3.0, 2.0):
        tel.observe_value("epoch_time_s", v)
    tel.write_scalars(1, {"mae": 0.25}, prefix="test")


def test_telemetry_summary_matches_jax(tmp_path, fixed_clock):
    jt = JTelemetry("epoch", str(tmp_path / "j"), use_clu=False)
    tt = Telemetry("epoch", str(tmp_path / "t"))
    _facade_calls(jt)
    _facade_calls(tt)
    tt.sample_hbm("end_of_run")
    jt.close()
    tt.close()
    tt.close()  # a second close is a no-op
    got = tmio.read_jsonl(str(tmp_path / "t" / "metrics.jsonl"))
    want = jmio.read_jsonl(str(tmp_path / "j" / "metrics.jsonl"))
    # the epoch and test records first, then the buffered events
    assert [r.get("event") for r in got] == [None, None, None, "hbm",
                                             "run_summary"]
    assert got[:3] == want[:3]
    summary = next(r for r in want if r.get("event") == "run_summary")
    assert json.dumps(got[-1]) == json.dumps(summary)
    assert got[-1]["gauges"]["scan_dispatch_share"] == 0.75
    names = {e["name"] for e in json.load(
        open(tmp_path / "t" / "trace.json"))["traceEvents"]}
    assert "pack" in names


def test_telemetry_off_writes_nothing(tmp_path):
    tel = Telemetry("off", str(tmp_path / "off"))
    _facade_calls(tel)
    tel.sample_hbm("x")
    tel.write_manifest({"a": 1})
    assert tel.stream is None and tel.wrap_train_body(len) is len
    tel.close()
    assert not (tmp_path / "off").exists()
    assert tel.counters() == {} and tel.gauges() == {}
    with pytest.raises(ValueError, match="not in"):
        Telemetry("verbose", str(tmp_path))


# ---------------------------------------------------------------------------
# the step stream on the CPU
# ---------------------------------------------------------------------------


def _sums(i):
    return {"loss_sum": torch.tensor(float(i) * 3.0),
            "mae_sum": torch.tensor(float(i)),
            "count": torch.tensor(3.0),
            "grad_norm_sum": torch.tensor(0.5 * i),
            "grad_norm_count": torch.tensor(1.0),
            "vector": torch.ones(2)}  # not a scalar: left out


def test_step_stream_records_match_the_jax_derivation(tmp_path):
    logger = tmio.MetricsLogger(str(tmp_path))
    stream = tstream.StepStream(logger, slots=8, rate_window=4)
    count = torch.zeros((), dtype=torch.int64)
    for epoch in range(2):
        stream.mark("train", "cpu", start=True)
        for i in range(5):
            count += 1
            stream.tap(_sums(i), "train", step=count)
            stream.mark("train", "cpu")
        stream.mark("eval", "cpu", start=True)
        stream.tap(_sums(9), "eval")
        stream.mark("eval", "cpu")
    stream.flush()
    train = stream.records("train")
    assert [r["step"] for r in train] == list(range(1, 11))
    assert [r["step"] for r in stream.records("eval")] == [0, 1]
    for r, i in zip(train, list(range(5)) * 2):
        want = jstream._derive_means({k: float(v) for k, v in _sums(i).items()
                                      if v.dim() == 0})
        got = {k: v for k, v in r.items()
               if k not in ("phase", "step", "steps_per_s")}
        assert got == want
    # each epoch starts with a mark: every row has a rate
    assert all(r["steps_per_s"] > 0 for r in train)
    assert stream.dropped == 0
    # a row with no earlier mark has none
    stream.tap(_sums(1), "test", step=None)
    stream.mark("test", "cpu")
    stream.flush()
    assert "steps_per_s" not in stream.records("test")[0]
    logger.close()
    lines = tmio.read_jsonl(str(tmp_path / "metrics.jsonl"))
    assert sum(r["event"] == "step" for r in lines) == 13


def test_step_stream_counts_overwrites_and_drops_muted_rows():
    stream = tstream.StepStream(slots=4)
    stream.mark("train", "cpu", start=True)
    for i in range(7):  # one chunk longer than the ring
        stream.tap(_sums(i), "train", step=torch.tensor(i + 1))
    stream.mark("train", "cpu")
    stream.flush()
    assert [r["step"] for r in stream.records()] == [4, 5, 6, 7]
    assert stream.dropped == 3
    with stream.muted():
        stream.tap(_sums(1), "train", step=torch.tensor(8))
        stream.tap(_sums(1), "eval")  # a phase first seen while muted
        stream.mark("train", "cpu")
    stream.tap(_sums(2), "train", step=torch.tensor(9))
    stream.mark("train", "cpu")
    stream.flush()
    assert [r["step"] for r in stream.records()] == [4, 5, 6, 7, 9]
    assert stream.records("eval") == []
    with pytest.raises(ValueError, match="differ from the ring"):
        stream.tap({"loss_sum": torch.tensor(1.0)}, "train")
    stream.reserve(100)
    assert stream.slots == 400
    stream.close()


def test_step_stream_skips_warm_up_runs(monkeypatch):
    from cgnn_tpu_torch.train import graphs

    stream = tstream.StepStream()
    monkeypatch.setattr(graphs._tls, "warming", True, raising=False)
    stream.tap(_sums(1), "train", step=torch.tensor(1))
    monkeypatch.setattr(graphs._tls, "warming", False)
    stream.flush()
    assert stream.records() == []
    # the ring exists (made at the first tap) and stays unwritten
    ph = stream._phases["train"]
    assert ph.ring is not None and ph.queued == 0


# ---------------------------------------------------------------------------
# grad health against the JAX train step
# ---------------------------------------------------------------------------

HEALTH_KEYS = ("grad_norm", "update_norm", "nonfinite_grads",
               "nonfinite_loss")


def _health_case(dtype, poison=False):
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    graphs = _graphs(30, seed=8)
    nc, ec = jgraph.capacities_for(graphs, 30, dense_m=M, snug=True)
    jb = next(jgraph.batch_iterator(graphs, 30, nc, ec, dense_m=M,
                                    snug=True))
    tb = next(tgraph.batch_iterator([_port(g) for g in graphs], 30, nc, ec,
                                    dense_m=M, snug=True))
    if poison:  # one structure's target: the loss and every gradient NaN
        jb = jb.replace(targets=np.where(
            np.arange(len(jb.targets))[:, None] == 0, np.nan, jb.targets))
        tb.targets[0] = float("nan")
    targets = np.stack([g.target for g in graphs])
    jnet = JNet(**SMALL, dense_m=M,
                dtype=jnp.float64 if np_dtype == np.float64 else jnp.float32)
    variables = _jax_variables(jnet, jb, dtype=np_dtype)
    opt = dict(lr=0.05, momentum=0.9)
    tx = jmake_optimizer("sgd", **opt)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        normalizer=JNormalizer.fit(targets), rng=jax.random.key(0),
        apply_fn=jnet.apply, tx=tx)
    new_jstate, jm = jmake_train_step(grad_health=True)(jstate, jb)
    net = _port_model({}, variables, dtype)
    state = tstate.TrainState(net, tstate.make_optimizer(
        net.parameters(), "sgd", **opt), Normalizer.fit(targets, device="cpu"))
    tm = make_train_step(grad_health=True)(state, tb)
    return jstate, new_jstate, jm, tm, opt


def _leaves(tree):
    return [np.asarray(a, np.float64)
            for a in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_grad_health_matches_jax(dtype):
    jstate, new_jstate, jm, tm, opt = _health_case(dtype)
    for k in HEALTH_KEYS:
        assert float(tm[f"{k}_count"]) == float(jm[f"{k}_count"]) == 1.0
    assert float(tm["nonfinite_grads_sum"]) == float(
        jm["nonfinite_grads_sum"]) == 0.0
    assert float(tm["nonfinite_loss_sum"]) == float(
        jm["nonfinite_loss_sum"]) == 0.0
    got = {k: float(tm[f"{k}_sum"]) for k in ("grad_norm", "update_norm")}
    jax_health = {k: float(jm[f"{k}_sum"]) for k in got}
    if dtype == torch.float32:
        for k, v in got.items():
            np.testing.assert_allclose(v, jax_health[k], **GRAD_TOL,
                                       err_msg=k)
        return
    # f64: the JAX step's own gradients and update, in float64 (its first
    # SGD step moves each parameter by -lr * grad)
    old, new = _leaves(jstate.params), _leaves(new_jstate.params)
    delta = np.concatenate([(b - a).ravel() for a, b in zip(old, new)])
    want = {"grad_norm": np.linalg.norm(delta / opt["lr"]),
            "update_norm": np.linalg.norm(delta)}
    for k, v in got.items():
        assert v == pytest.approx(want[k], rel=1e-9), k
        assert v == pytest.approx(jax_health[k], rel=1e-6), k


def test_grad_health_counts_a_nan_onset_like_jax():
    _, _, jm, tm, _ = _health_case(torch.float32, poison=True)
    assert float(tm["nonfinite_loss_sum"]) == float(
        jm["nonfinite_loss_sum"]) == 1.0
    assert float(tm["nonfinite_grads_sum"]) == float(
        jm["nonfinite_grads_sum"]) > 0
    assert math.isnan(float(tm["grad_norm_sum"]))
    assert math.isnan(float(jm["grad_norm_sum"]))


def test_grad_health_leaves_the_step_unchanged():
    """The same step with and without the health metrics: every
    parameter, statistic and metric sum bit-equal (metric outputs only)."""
    graphs = _graphs(30, seed=8)
    nc, ec = jgraph.capacities_for(graphs, 30, dense_m=M, snug=True)
    tb = next(tgraph.batch_iterator([_port(g) for g in graphs], 30, nc, ec,
                                    dense_m=M, snug=True))
    targets = np.stack([g.target for g in graphs])
    jb = next(jgraph.batch_iterator(graphs, 30, nc, ec, dense_m=M,
                                    snug=True))
    variables = _jax_variables(JNet(**SMALL, dense_m=M), jb)
    outs = []
    for health in (False, True):
        net = _port_model({}, variables)
        state = tstate.TrainState(net, tstate.make_optimizer(
            net.parameters(), "adam", lr=0.01),
            Normalizer.fit(targets, device="cpu"))
        step = make_train_step(grad_health=health)
        ms = [step(state, tb) for _ in range(2)]
        outs.append((net.state_dict(), ms))
    (v0, m0), (v1, m1) = outs
    assert v0.keys() == v1.keys()
    for path in v0:
        assert torch.equal(v0[path], v1[path]), path
    for a, b in zip(m0, m1):
        assert set(b) - set(a) == {f"{k}_{s}" for k in HEALTH_KEYS
                                   for s in ("sum", "count")}
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert thealth.global_norm([]).item() == 0.0


def test_observe_package_exports():
    import cgnn_tpu_torch.observe as obs

    assert set(obs.__all__) <= set(dir(obs))
    assert obs.Histogram is thist.Histogram
    assert obs.Telemetry is Telemetry and obs.StepStream is tstream.StepStream
