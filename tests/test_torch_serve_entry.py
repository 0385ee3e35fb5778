"""``python -m cgnn_tpu_torch.serve`` on the CPU, as subprocesses (the
boot, readiness, drain and exit-code contract of ``serve.py``):

- ``/healthz`` answers 503 (ready=false) between the bind and the end of
  ``warm()`` (held there by ``wedge_warm``), then 200; a structure is
  answered; SIGTERM drains and exits 0;
- ``exit75_at=0``: the first flush's dispatch SIGTERMs the process, the
  request is still answered, and the drain exits 75;
- ``wedge_flush=0`` with a 1 s ``--drain-timeout``: SIGTERM, the drain
  times out and the process exits 3 with the unanswered count;
  the flight recorder's ``drain_force_exit`` bundle is written first;
- ``--journal`` (not ported) exits 2 naming its ROADMAP item, as do an
  unknown precision tier, more devices than exist (never clamped) and a
  directory without a checkpoint; serve.py's profiling, SLO and
  trace-ring flags reach ``load_server``; without a card the default
  device raises.
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest
import torch

from cgnn_tpu_torch.serve.__main__ import main as serve_main
from cgnn_tpu_torch.train.__main__ import main as train_main

ROOT = Path(__file__).resolve().parents[1]
SMALL_CLI = ["--radius", "5", "--n-conv", "2", "--atom-fea-len", "16",
             "--print-freq", "0"]
STRUCTURE = {"structure": {"lattice": [[4.0, 0, 0], [0, 4.0, 0], [0, 0, 4.0]],
                           "frac_coords": [[0, 0, 0], [0.5, 0.5, 0.5]],
                           "numbers": [11, 17]}}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_entry")
    ck = str(d / "ckpt")
    assert train_main(["--synthetic", "24", "--device", "cpu", "--epochs",
                       "1", "-b", "8", "--ckpt-dir", ck, "--out-dir",
                       str(d / "out"), *SMALL_CLI]) == 0
    return types.SimpleNamespace(dir=ck, tmp=d)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path, timeout=10):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _post(port, body, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/predict", body=json.dumps(body).encode())
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _start(ckpt, port, faults="", *extra, state=""):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS", "CGNN_TPU_FAULTS",
                        "CGNN_TPU_FAULT_STATE")}
    if faults:
        env["CGNN_TPU_FAULTS"] = faults
    if state:
        env["CGNN_TPU_FAULT_STATE"] = state
    log = open(os.path.join(ckpt.tmp, f"serve-{port}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cgnn_tpu_torch.serve", ckpt.dir, "--device",
         "cpu", "--port", str(port), "--calibrate", "16",
         "--poll-interval", "0", *extra],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    proc.log_path = log.name
    return proc


def _statuses_until_ready(proc, port, deadline_s=120):
    """/healthz statuses until 200 (connection refused: None)."""
    seen = []
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        assert proc.poll() is None, open(proc.log_path).read()[-3000:]
        try:
            st, body = _get(port, "/healthz")
        except OSError:
            st = None
        if not seen or seen[-1] != st:
            seen.append(st)
        if st == 200:
            return seen, body
        time.sleep(0.1)
    raise AssertionError(f"never ready: {seen}")


def _wait(proc, timeout=60) -> int:
    try:
        return proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_boot_answer_and_sigterm_exit_0(ckpt):
    port = _free_port()
    # the boot fault point holds the process between bind and warm()
    proc = _start(ckpt, port, "wedge_warm=3")
    seen, body = _statuses_until_ready(proc, port)
    assert 503 in seen and seen[-1] == 200, seen
    assert body["ready"] and not body["draining"]
    st, res = _post(port, STRUCTURE)
    assert st == 200 and res["param_version"] == "ckpt-00000000"
    assert len(res["prediction"]) == 1 and res["wire"] == "featurized"
    proc.send_signal(signal.SIGTERM)
    assert _wait(proc) == 0, open(proc.log_path).read()[-3000:]
    log = open(proc.log_path).read()
    assert "draining" in log and "drained: 1 responses" in log


def test_exit75_after_a_preemption_mid_load(ckpt):
    port = _free_port()
    proc = _start(ckpt, port, "exit75_at=0")
    _statuses_until_ready(proc, port)
    st, res = _post(port, STRUCTURE)
    assert st == 200  # answered through the drain the fault started
    assert _wait(proc) == 75, open(proc.log_path).read()[-3000:]


def test_wedged_flush_drain_times_out_with_3(ckpt):
    port = _free_port()
    proc = _start(ckpt, port, "wedge_flush=0:60", "--drain-timeout", "1")
    _statuses_until_ready(proc, port)

    def wedged_client():
        try:
            _post(port, STRUCTURE, 90)
        except OSError:  # the force exit closes the connection unanswered
            pass

    stuck = threading.Thread(target=wedged_client, daemon=True,
                             name="test-wedged-client")
    stuck.start()
    time.sleep(1.0)  # the request reaches the wedged dispatch
    proc.send_signal(signal.SIGTERM)
    assert _wait(proc) == 3
    log = open(proc.log_path).read()
    assert "1 accepted request(s) unanswered" in log, log[-3000:]
    # the flight recorder (--flightrec-dir auto: CKPT_DIR/flightrec)
    # wrote the forced exit's bundle before the exit
    frdir = os.path.join(ckpt.dir, "flightrec")
    bundles = [d for d in os.listdir(frdir)
               if d.endswith("-drain_force_exit")]
    assert len(bundles) == 1, os.listdir(frdir)
    manifest = json.load(open(os.path.join(frdir, bundles[0],
                                           "manifest.json")))
    assert manifest["reason"] == "drain_force_exit"
    assert "1 unanswered" in manifest["detail"]


def test_boot_crash_dies_once_then_boots(ckpt):
    """``boot_crash=1`` with a state file: the first boot dies with 7
    after binding, the next one serves."""
    state = str(ckpt.tmp / "boots")
    proc = _start(ckpt, _free_port(), "boot_crash=1", state=state)
    assert _wait(proc) == 7
    port = _free_port()
    proc = _start(ckpt, port, "boot_crash=1", state=state)
    _statuses_until_ready(proc, port)
    proc.send_signal(signal.SIGTERM)
    assert _wait(proc) == 0
    assert os.path.getsize(state) == 2


@pytest.mark.parametrize("flag, item", [
    (["--precision", "f32,fp4"], "unknown precision tier"),
    (["--devices", "4"], "local device(s) exist"),
    (["--devices", "0"], "--devices must be >= 1"),
    (["--journal", "j.jsonl"], "item 12"),
    (["--compile-cache", "/tmp/x"], "no counterpart"),
])
def test_unported_flags_exit_2(ckpt, capsys, flag, item):
    assert serve_main([ckpt.dir, "--device", "cpu", *flag]) == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("flag, check", [
    (["--profile-dir", "x"], lambda kw: kw["profile_dir"] == "x"),
    (["--slo-target", "0.99"],
     lambda kw: kw["slo_objectives"][0].target == 0.99
     and kw["slo_layer"] and kw["slo_rules"] is None),
    (["--trace-ring", "4096"], lambda kw: kw["trace_ring"] == 4096),
])
def test_observe_flags_reach_the_server(ckpt, monkeypatch, flag, check):
    """serve.py's profiling, SLO and trace-ring flags are served: each
    reaches ``load_server`` (stopped there, before a server boots)."""
    import cgnn_tpu_torch.serve.server as server_mod

    seen = {}

    def fake_load_server(path, **kw):
        seen.update(kw)
        raise FileNotFoundError("stopped before the boot")

    monkeypatch.setattr(server_mod, "load_server", fake_load_server)
    assert serve_main([ckpt.dir, "--device", "cpu", *flag]) == 2
    assert check(seen), seen


def test_missing_checkpoint_exits_2(ckpt, capsys):
    assert serve_main([str(ckpt.tmp / "nothing"), "--device", "cpu"]) == 2
    assert "no 'latest' checkpoint" in capsys.readouterr().err


def test_default_device_is_the_card(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_main([ckpt.dir])


def test_serving_fault_hooks_match_jax():
    """The same plan fires the same dispatch and connection faults at the
    same ordinals as the JAX package's hooks."""
    from cgnn_tpu.resilience import faultinject as jfi
    from cgnn_tpu_torch.resilience import faultinject as tfi

    spec = "dispatch_exc=1:2;slow_dispatch=1:3;drop_conn=3"
    seen = {}
    for name, mod in (("jax", jfi), ("port", tfi)):
        mod.set_plan(mod.FaultPlan.parse(spec))
        try:
            out = []
            for _ in range(6):
                try:
                    mod.dispatch_point()
                    out.append("ok")
                except RuntimeError as e:
                    out.append(str(e))
            out += [mod.drop_connection() for _ in range(7)]
            out.append(mod.exit75_requested())
            seen[name] = out
        finally:
            mod.set_plan(None)
    assert seen["port"] == seen["jax"]
    assert seen["port"][1] == "injected dispatch failure at flush 1"
    assert seen["port"][6:13] == [False, False, True] * 2 + [False]


def test_drop_conn_closes_every_nth_predict(ckpt):
    """``drop_conn=2``: the second /predict connection is closed
    unanswered; /healthz is never dropped."""
    from cgnn_tpu_torch.resilience import faultinject
    from cgnn_tpu_torch.serve.http import make_http_server
    from cgnn_tpu_torch.serve.server import load_server

    server, _ = load_server(ckpt.dir, batch_size=8, rungs=1, device="cpu",
                            calibration_n=8, watch=False,
                            log_fn=lambda *a: None)
    httpd = make_http_server(server, port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="test-http").start()
    faultinject.set_plan(faultinject.FaultPlan.parse("drop_conn=2"))
    try:
        assert _post(port, STRUCTURE)[0] == 200
        with pytest.raises(http.client.RemoteDisconnected):
            _post(port, STRUCTURE)
        assert _get(port, "/healthz")[0] == 200
        assert _post(port, STRUCTURE)[0] == 200
    finally:
        faultinject.set_plan(None)
        httpd.shutdown()
        httpd.server_close()
        assert server.drain(timeout_s=30)
