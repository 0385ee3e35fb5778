"""The flight recorder and the trace joiner of the port
(``observe/flightrec.py``, ``observe/trace_join.py``,
``observe/tracectx.py``) against the JAX package's on the CPU, and the
serving entry point's planes at its defaults.

- ``join_windows`` on the same windows (a retried request across two
  processes, a truncated ring, empty and missing windows) gives an equal
  document in both packages, ``incomplete_processes`` and the per-trace
  index included; ``cross_process_traces``, ``write_joined``'s file and
  ``parse_since_query`` alike.
- ``FlightRecorder``: the same notes and triggers on the same fake clock
  leave bundles with the same file set, and ``manifest.json``,
  ``requests.jsonl`` and ``metrics.json`` equal apart from their time
  fields; the rate limit, ``max_bundles``, a forced trigger, the 5xx
  burst firing once a plateau and re-arming, ``snapshot`` and ``stats``
  alike.
- ``python -m cgnn_tpu_torch.serve CKPT`` with no observability flag (a
  subprocess): ``GET /trace``, ``/flightrec`` and ``/timeseries`` answer
  200, ``POST /profile`` 200 with the JAX record's keys into
  ``CKPT/profiles``, SIGUSR2 writes a capture there too, a stretch of
  failed flushes (``dispatch_exc``) with the SLO windows cut to seconds
  fires ``slo_burn_availability`` into ``CKPT/flightrec`` (its bundle's
  manifest naming the alert; twelve failures are too few for the 5xx
  burst's twenty), and SIGTERM drains with exit 0.
"""

import copy
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

from cgnn_tpu.observe import export as jexport
from cgnn_tpu.observe import flightrec as jflightrec
from cgnn_tpu.observe import trace_join as jtrace_join
from cgnn_tpu_torch.observe import export as texport
from cgnn_tpu_torch.observe import flightrec as tflightrec
from cgnn_tpu_torch.observe import spans as tspans
from cgnn_tpu_torch.observe import trace_join as ttrace_join
from cgnn_tpu_torch.observe import tracectx
from cgnn_tpu_torch.train.__main__ import main as train_main

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"jax": (jflightrec, jexport), "torch": (tflightrec, texport)}
# fields that read a clock or name the process
TIME_FIELDS = {"time_unix", "t_unix", "time"}


def _quiet(*a, **k):
    pass


# ------------------------------------------------------------ tracectx


def test_trace_context():
    ids = {tracectx.mint_span_id("att") for _ in range(500)}
    assert len(ids) == 500 and all(i.startswith("att-") for i in ids)
    value = tracectx.format_parent("req/with/slashes", "att-1-2-000003")
    assert tracectx.parse_parent(value) == ("req/with/slashes",
                                            "att-1-2-000003")
    for bad in (None, "", "noslash", "/x", "x/", 7):
        assert tracectx.parse_parent(bad) == ("", "")


# -------------------------------------------------------------- joiner


def _windows(spans, drop_replica=False):
    """A router ring and a replica ring holding a retried request: two
    attempts (replica 0 failed, replica 1 answered) and the replica's
    serve.request under attempt 2."""
    router = spans.SpanTracer(process_name="router")
    replica = spans.SpanTracer(process_name="replica1", max_events=3)
    t = 100.0
    router.complete("fleet.attempt", t, t + 0.01, trace_id="tid-1",
                    span_id="att-1", parent="req-0", replica=0,
                    status=0)
    router.complete("fleet.attempt", t + 0.02, t + 0.05, trace_id="tid-1",
                    span_id="att-2", parent="req-0", replica=1, status=200)
    router.complete("fleet.request", t, t + 0.05, trace_id="tid-1",
                    span_id="req-0", status=200, attempts=2)
    router.complete("serve.request", t + 0.06, t + 0.07, trace_id="tid-2")
    replica.complete("serve.request", t + 0.025, t + 0.045,
                     trace_id="tid-1", parent="att-2", flush_id="f-1")
    replica.complete("serve.dispatch", t + 0.03, t + 0.04, flush_id="f-1",
                     trace_ids=["tid-1"])
    if drop_replica:
        for i in range(2):  # the ring evicts the serve.request
            replica.complete("serve.pack", t + 0.05, t + 0.06,
                             trace_id="tid-1", n=i)
    wr, wp = router.window(), replica.window()
    for w, role, pid, t0 in ((wr, "router", 11, 1000.0),
                             (wp, "replica", 12, 1000.25)):
        w.update(role=role, pid=pid, t0_unix=t0, end_us=5e6)
    return [wr, wp]


JOINS = {"retried": lambda s: _windows(s),
         "truncated": lambda s: _windows(s, drop_replica=True),
         "empty": lambda s: [],
         "missing": lambda s: [None, {"events": None},
                               _windows(s)[1]]}


@pytest.mark.parametrize("case", sorted(JOINS))
def test_join_windows_matches_jax(case, tmp_path):
    # one set of windows (a window is wire data: who made it does not
    # matter), a copy for each joiner
    got_w = JOINS[case](tspans)
    want_w = copy.deepcopy(got_w)
    got = ttrace_join.join_windows(got_w)
    assert got == jtrace_join.join_windows(want_w)
    assert ttrace_join.cross_process_traces(got) == \
        jtrace_join.cross_process_traces(got)
    ttrace_join.write_joined(str(tmp_path / "t" / "trace.json"), got_w)
    jtrace_join.write_joined(str(tmp_path / "j" / "trace.json"), want_w)
    assert (tmp_path / "t" / "trace.json").read_text() == \
        (tmp_path / "j" / "trace.json").read_text()
    if case == "retried":
        assert ttrace_join.cross_process_traces(got) == ["tid-1"]
        assert got["traces"]["tid-1"]["complete"]
        assert got["incomplete_processes"] == []
        assert sum(e.get("ph") == "s" for e in got["traceEvents"]) == 3
    if case == "truncated":
        assert got["incomplete_processes"] == ["replica:replica1"]
        assert not got["traces"]["tid-1"]["complete"]


def test_parse_since_query_matches_jax():
    for path in ("/trace", "/trace?since=1700000000.5", "/trace?since=x",
                 "/trace?since=", "/trace?a=1&since=3"):
        assert ttrace_join.parse_since_query(path) == \
            jtrace_join.parse_since_query(path), path


# ------------------------------------------------------------- recorder


def _registry(export):
    reg = export.MetricsRegistry()
    reg.add_provider("serve", lambda: {"counters": {"serve_requests": 3.0},
                                       "gauges": {"serve_queue_depth": 1.0}})
    return reg


def _script(pkg, root, clk):
    """Notes, statuses and triggers on a fake clock -> what each step
    returned, and the recorder."""
    flightrec, export = PKGS[pkg]
    tracer = tspans.SpanTracer(process_name="replica")
    tracer.complete("serve.request", 0.0, 0.01, trace_id="t1")
    fr = flightrec.FlightRecorder(
        str(root), role="replica", name="replica:1", ring=8,
        burst_threshold=5, burst_window_s=10.0, min_interval_s=30.0,
        max_bundles=3, registry=_registry(export), tracer=tracer,
        manifest={"param_version": "ckpt-7"}, log_fn=_quiet,
        clock=lambda: clk[0])
    seen = []
    fr.on_trigger = lambda reason, detail, bundle: seen.append(
        (reason, bundle is not None))
    out = []
    for i in range(12):
        fr.note_request({"trace_id": f"t{i}", "status": "ok", "t_unix": 1.0})
    out.append(fr.trigger("breaker_trip", "replica1 ejected", wait=True))
    out.append(fr.trigger("breaker_trip", wait=True))  # rate-limited
    clk[0] += 31.0
    for _ in range(4):
        fr.note_status(500)
    fr.note_status(404)
    fr.note_status(502)  # the fifth 5xx: the burst fires
    fr.wait_idle()
    for _ in range(10):
        fr.note_status(500)  # the plateau: no second firing
    fr.wait_idle()
    clk[0] += 20.0
    for _ in range(6):
        fr.note_status(503)  # a fresh burst, rate-limited (19 s later)
    fr.wait_idle()
    out.append(fr.trigger("drain_force_exit", "1 unanswered", wait=True,
                          force=True))
    clk[0] += 31.0
    out.append(fr.trigger("late", wait=True))  # past max_bundles
    return out, fr, seen


def _bundle_files(bundle):
    out = {}
    for name in sorted(os.listdir(bundle)):
        path = os.path.join(bundle, name)
        if name == "requests.jsonl":
            out[name] = [{k: v for k, v in json.loads(line).items()
                          if k not in TIME_FIELDS}
                         for line in open(path)]
        elif name == "trace.json":
            doc = json.load(open(path))
            out[name] = (sorted(doc["traces"]), doc["incomplete_processes"])
        else:
            doc = json.load(open(path))
            out[name] = {k: v for k, v in doc.items()
                         if k not in TIME_FIELDS}
    return out


def test_flight_recorder_matches_jax(tmp_path):
    got, tfr, tseen = _script("torch", tmp_path / "t", [0.0])
    want, jfr, jseen = _script("jax", tmp_path / "j", [0.0])
    assert [b is None for b in got] == [b is None for b in want] == [
        False, True, False, True]
    assert tseen == jseen
    assert {k: v for k, v in tfr.stats().items() if k != "last_bundle"} \
        == {k: v for k, v in jfr.stats().items() if k != "last_bundle"}
    assert tfr.stats()["triggers"] == {"breaker_trip": 2, "5xx_burst": 2,
                                       "drain_force_exit": 1, "late": 1}
    tb = sorted(os.listdir(tmp_path / "t"))
    jb = sorted(os.listdir(tmp_path / "j"))
    # bundle-<utc>-p<pid>-<nn>-<reason>: the same numbers and reasons
    assert [b.split("-", 3)[3] for b in tb] == \
        [b.split("-", 3)[3] for b in jb]
    assert [b.rsplit("-", 1)[1] for b in tb] == [
        "breaker_trip", "5xx_burst", "drain_force_exit"]
    for t, j in zip(tb, jb):
        got_files = _bundle_files(tmp_path / "t" / t)
        assert got_files == _bundle_files(tmp_path / "j" / j), t
        assert set(got_files) == {"manifest.json", "requests.jsonl",
                                  "metrics.json", "trace.json"}
        assert got_files["manifest.json"]["reason"] == t.rsplit("-", 1)[1]
    assert len(_bundle_files(tmp_path / "t" / tb[0])["requests.jsonl"]) == 8
    def untimed(snap):
        out = {k: v for k, v in snap.items() if k not in TIME_FIELDS}
        out["metrics"] = {k: v for k, v in out["metrics"].items()
                          if k not in TIME_FIELDS}
        return out

    snap = untimed(tfr.snapshot())
    assert snap == untimed(jfr.snapshot())
    json.dumps(snap)


def test_flight_recorder_degrades_without_surfaces(tmp_path):
    """No registry, tracer or peers: a bundle of the manifest and the
    ring; a failing dump is logged, the process goes on."""
    logged = []
    fr = tflightrec.FlightRecorder(str(tmp_path / "fr"), log_fn=logged.append)
    fr.note_request({"trace_id": "t9", "status": "ok"})
    b = fr.trigger("manual", wait=True)
    assert sorted(os.listdir(b)) == ["manifest.json", "requests.jsonl"]
    (tmp_path / "file").write_text("")
    fr2 = tflightrec.FlightRecorder(str(tmp_path / "file"),
                                    log_fn=logged.append)
    assert fr2.trigger("manual", wait=True) is not None
    assert any("dump for 'manual' failed" in m for m in logged)


# ---------------------------------------- the entry point at its defaults

STRUCTURE = {"structure": {"lattice": [[4.0, 0, 0], [0, 4.0, 0], [0, 0, 4.0]],
                           "frac_coords": [[0, 0, 0], [0.5, 0.5, 0.5]],
                           "numbers": [11, 17]}}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("flightrec_entry")
    ck = str(d / "ckpt")
    assert train_main(["--synthetic", "24", "--device", "cpu", "--epochs",
                       "1", "-b", "8", "--ckpt-dir", ck, "--out-dir",
                       str(d / "out"), "--radius", "5", "--n-conv", "2",
                       "--atom-fea-len", "16", "--print-freq", "0",
                       "--telemetry", "off"]) == 0
    return types.SimpleNamespace(dir=ck, tmp=d)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call(port, method, path, body=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body).encode())
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _bundles(root):
    """{reason: manifest} of the bundles under ``root``."""
    out = {}
    for b in sorted(os.listdir(root)) if os.path.isdir(root) else ():
        path = os.path.join(root, b, "manifest.json")
        if os.path.exists(path):
            m = json.load(open(path))
            out[m["reason"]] = m
    return out


def test_entry_point_runs_every_plane_at_its_defaults(ckpt):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS", "CGNN_TPU_FAULT_STATE")}
    # flushes 3-14 fail, with the SLO windows cut to seconds
    env["CGNN_TPU_FAULTS"] = "dispatch_exc=3:12"
    log = open(os.path.join(ckpt.tmp, f"serve-{port}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cgnn_tpu_torch.serve", ckpt.dir, "--device",
         "cpu", "--port", str(port), "--calibrate", "16", "--poll-interval",
         "0", "--slo-fast-s", "5", "--slo-slow-s", "10", "--slo-factor", "2"],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, open(log.name).read()[-3000:]
            try:
                if _call(port, "GET", "/healthz", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "never ready"
            time.sleep(0.2)
        for i in range(3):
            st, _ = _call(port, "POST", "/predict", {"structure": dict(
                STRUCTURE["structure"],
                frac_coords=[[0, 0, 0], [0.5, 0.5, 0.45 + 0.01 * i]])})
            assert st == 200
        st, rec = _call(port, "POST", "/profile", {"duration_ms": 100})
        assert st == 200 and {"ok", "dir", "duration_s", "files",
                              "bytes"} <= set(rec), rec
        assert rec["dir"].startswith(os.path.join(ckpt.dir, "profiles"))
        proc.send_signal(signal.SIGUSR2)
        for path in ("/trace", "/flightrec", "/timeseries"):
            st, body = _call(port, "GET", path)
            assert st == 200, (path, body)
        assert {"serve.request", "serve.pack", "serve.dispatch"} <= {
            e["name"] for e in _call(port, "GET", "/trace")[1]["events"]}
        statuses = []
        for i in range(12):
            statuses.append(_call(port, "POST", "/predict", {
                "structure": dict(STRUCTURE["structure"], frac_coords=[
                    [0, 0, 0], [0.5, 0.4 + 0.01 * i, 0.5]])})[0])
        assert statuses == [500] * 12, statuses
        frdir = os.path.join(ckpt.dir, "flightrec")
        deadline = time.monotonic() + 30
        while "slo_burn_availability" not in _bundles(frdir):
            assert time.monotonic() < deadline, _bundles(frdir)
            time.sleep(0.2)
        snap = _call(port, "GET", "/flightrec")[1]
        assert snap["triggers"].get("slo_burn_availability", 0) >= 1
        assert [r["status"] for r in snap["requests"]].count(
            "dispatch_failed") == 12
        ts = _call(port, "GET", "/timeseries")[1]
        assert "serve_latency_ms_hist_count" in ts["names"]
        st, pts = _call(port, "GET",
                        "/timeseries?name=serve_latency_ms_hist_count&res=10s")
        assert st == 200 and pts["points"]
        profiles = os.listdir(os.path.join(ckpt.dir, "profiles"))
        deadline = time.monotonic() + 30
        while len(profiles) < 2 and time.monotonic() < deadline:
            time.sleep(0.2)  # the SIGUSR2 capture: 1 s by default
            profiles = os.listdir(os.path.join(ckpt.dir, "profiles"))
        assert len(profiles) == 2, profiles
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = open(log.name).read()
    assert "SLO ALERT firing: objective=availability" in out, out[-3000:]
    bundles = _bundles(os.path.join(ckpt.dir, "flightrec"))
    assert bundles["slo_burn_availability"]["role"] == "replica"
    assert "rule=5s_10s_x2" in bundles["slo_burn_availability"]["detail"]
    for sub in profiles:
        files = os.listdir(os.path.join(ckpt.dir, "profiles", sub))
        assert "device_trace.json" in files, files
