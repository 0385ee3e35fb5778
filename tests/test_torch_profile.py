"""On-demand profiling of the port (``observe/profile.py``,
``observe/metrics_io.py`` ``profile_trace``, ``train/loop.py``
``profile_wrap``, the train entry point's ``--profile`` and SIGUSR2) on
the CPU, where ``torch.profiler`` records the CPU activity alone.

- ``ProfileCapture``: a capture is a ``torch.profiler`` session held for
  its window (clamped to [0.05, ``max_duration_s``]) and written as
  ``device_trace.json`` into ``profile-<stamp>-<nnn>/``, beside the span
  tracer's ``host_trace.json``; it returns the JAX record's keys. A
  second capture while one runs, or while any other profiler session of
  the process runs, raises ``ProfileBusy`` (counted, never stacked);
  ``wait_idle`` waits one out; SIGUSR2 starts one on a thread.
- A session starts and stops only while no CUDA graph capture is in
  flight (``train.graphs.CAPTURE_GATE``).
- ``profile_trace`` under a busy session logs the JAX line and traces
  nothing.
- The train entry point: ``--profile 2`` writes a trace into the log dir
  and ends in the same parameter bits as a run without; with
  ``--device-resident`` it keeps the per-step loop; under an explicit
  ``--scan-epochs`` it logs that it traces nothing; with
  ``--graph-shards 2`` it exits 2 with train.py's reason; a SIGUSR2 sent
  to a training subprocess writes a capture under the log dir, and that
  run's parameters are bit-equal to a run without.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from cgnn_tpu_torch.observe import metrics_io, profile
from cgnn_tpu_torch.observe.spans import SpanTracer
from cgnn_tpu_torch.train.__main__ import main as train_main
from cgnn_tpu_torch.train.graphs import CAPTURE_GATE

ROOT = Path(__file__).resolve().parents[1]
# the JAX ProfileCapture's record (cgnn_tpu/observe/profile.py)
RECORD_KEYS = {"dir", "duration_s", "files", "bytes"}


def _quiet(*a, **k):
    pass


def test_capture_writes_a_trace_and_the_jax_record(tmp_path):
    spans = SpanTracer(process_name="t")
    spans.complete("epoch", 0.0, 0.01)
    cap = profile.ProfileCapture(str(tmp_path), spans=spans,
                                 max_duration_s=0.2, log_fn=_quiet)
    rec = cap.capture(0.0)  # clamped up to 0.05 s
    assert set(rec) == RECORD_KEYS | {"host_trace"}
    assert sorted(os.listdir(rec["dir"])) == ["device_trace.json",
                                              "host_trace.json"]
    assert os.path.basename(rec["dir"]).startswith("profile-")
    assert os.path.basename(rec["dir"]).endswith("-000")
    assert rec["files"] == 2 and rec["bytes"] > 0
    assert rec["duration_s"] >= 0.05
    doc = json.load(open(os.path.join(rec["dir"], "device_trace.json")))
    assert "traceEvents" in doc
    t0 = time.perf_counter()
    rec = cap.capture(30.0)  # clamped down to max_duration_s
    assert time.perf_counter() - t0 < 10.0
    assert rec["dir"].endswith("-001") and cap.captures == 2
    assert cap.last == rec and not cap.busy and not cap.recording
    assert not profile.session_busy()


def test_second_capture_is_rejected_never_stacked(tmp_path):
    cap = profile.ProfileCapture(str(tmp_path), log_fn=_quiet)
    out = {}
    t = threading.Thread(target=lambda: out.update(rec=cap.capture(1.0)),
                         name="test-profile-capture")
    t.start()
    deadline = time.monotonic() + 30
    while not cap.recording and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cap.busy and profile.session_busy()
    with pytest.raises(profile.ProfileBusy, match="already running"):
        cap.capture(0.05)
    # another capture object of the process: the session is taken
    other = profile.ProfileCapture(str(tmp_path / "other"), log_fn=_quiet)
    with pytest.raises(profile.ProfileBusy, match="session"):
        other.capture(0.05)
    assert cap.wait_idle(timeout_s=60)
    t.join()
    assert set(out["rec"]) == RECORD_KEYS
    assert (cap.captures, cap.rejected, other.rejected) == (1, 1, 1)
    assert not os.path.exists(tmp_path / "other")


def test_profile_trace_under_a_busy_session(tmp_path, capsys):
    with profile.session():
        with metrics_io.profile_trace(str(tmp_path / "a")):
            pass
        with pytest.raises(profile.ProfileBusy):
            profile.ProfileCapture(str(tmp_path / "c")).capture(0.05)
    assert "profile_trace: skipped" in capsys.readouterr().out
    assert os.listdir(tmp_path / "a") == []
    with metrics_io.profile_trace(str(tmp_path / "b")):
        sum(range(1000))
    (trace,) = os.listdir(tmp_path / "b")
    assert trace.startswith("profile-") and trace.endswith(
        f"-p{os.getpid()}.json")
    with metrics_io.profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not os.path.exists(tmp_path / "off")


def test_sessions_wait_out_graph_captures():
    """``quiet`` (a profiler's start and stop) waits while another thread
    captures, and holds new captures off meanwhile."""
    order = []
    capturing, release_capture = threading.Event(), threading.Event()
    quiet_in, release_quiet = threading.Event(), threading.Event()

    def capturer():
        with CAPTURE_GATE.capturing():
            capturing.set()
            release_capture.wait(10)
            order.append("capture 1")

    def session():
        with CAPTURE_GATE.quiet():
            order.append("quiet")
            quiet_in.set()
            release_quiet.wait(10)
            order.append("quiet done")

    def late():
        with CAPTURE_GATE.capturing():
            order.append("capture 2")

    def start(fn):
        t = threading.Thread(target=fn, name=f"test-{fn.__name__}")
        t.start()
        return t

    t1 = start(capturer)
    assert capturing.wait(10)
    t2 = start(session)
    time.sleep(0.2)
    assert order == []
    release_capture.set()
    t1.join(10)
    assert quiet_in.wait(10)
    t3 = start(late)
    time.sleep(0.2)
    assert order == ["capture 1", "quiet"]
    release_quiet.set()
    t2.join(10)
    t3.join(10)
    assert order == ["capture 1", "quiet", "quiet done", "capture 2"]


def test_sigusr2_starts_a_capture(tmp_path):
    old = signal.getsignal(signal.SIGUSR2)
    logged = []
    cap = profile.ProfileCapture(str(tmp_path), default_duration_s=0.1,
                                 log_fn=logged.append)
    try:
        assert profile.install_sigusr2(cap, log_fn=logged.append)
        os.kill(os.getpid(), signal.SIGUSR2)
        deadline = time.monotonic() + 30
        while cap.captures == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert cap.captures == 1
        assert any("profile: captured" in m for m in logged)
    finally:
        cap.wait_idle()
        signal.signal(signal.SIGUSR2, old)
    result = {}
    t = threading.Thread(
        target=lambda: result.update(ok=profile.install_sigusr2(cap)),
        name="test-not-main")
    t.start()
    t.join()
    assert result["ok"] is False  # not the main thread: nothing installed


# ------------------------------------------------------ the train entry

SMALL = ["--synthetic", "40", "--device", "cpu", "-b", "8", "--radius", "5",
         "--n-conv", "2", "--atom-fea-len", "16", "--h-fea-len", "24",
         "--print-freq", "0"]


def _argv(root, *extra, epochs=2):
    return [*SMALL, "--epochs", str(epochs), "--ckpt-dir",
            str(root / "ck"), "--out-dir", str(root / "out"), *extra]


def _params(root):
    with np.load(root / "out" / "params.npz") as z:
        return {k: z[k] for k in z.files}


def _bit_equal(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def _summary(out):
    return json.loads(next(line for line in out.splitlines()
                           if line.startswith("train: "))[7:])


def test_profile_steps_leave_the_trajectory_alone(tmp_path, capsys):
    assert train_main(_argv(tmp_path / "plain")) == 0
    capsys.readouterr()
    assert train_main(_argv(tmp_path / "prof", "--profile", "2")) == 0
    out = capsys.readouterr().out
    assert "profiler trace written to" in out
    logs = tmp_path / "prof" / "ck" / "logs"
    traces = [f for f in os.listdir(logs) if f.startswith("profile-")]
    assert len(traces) == 1
    names = {e.get("name") for e in json.load(open(logs / traces[0]))[
        "traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    assert _bit_equal(_params(tmp_path / "prof"), _params(tmp_path / "plain"))


def test_profile_with_device_resident_keeps_the_per_step_loop(tmp_path,
                                                              capsys):
    assert train_main(_argv(tmp_path / "dr", "--device-resident",
                            "--profile", "1", epochs=1)) == 0
    out = capsys.readouterr().out
    assert "staging" not in _summary(out) or "stage_s" not in _summary(
        out)["staging"]
    assert [f for f in os.listdir(tmp_path / "dr" / "ck" / "logs")
            if f.startswith("profile-")]
    assert train_main(_argv(tmp_path / "scan", "--scan-epochs",
                            "--profile", "1", epochs=1)) == 0
    out = capsys.readouterr().out
    assert "scan_epochs: --profile and per-step prints are unavailable" in out
    assert "stage_s" in _summary(out)["staging"]
    assert not [f for f in os.listdir(tmp_path / "scan" / "ck" / "logs")
                if f.startswith("profile-")]


def test_profile_with_graph_shards_exits_2(tmp_path, capsys):
    assert train_main(_argv(tmp_path, "--graph-shards", "2",
                            "--profile", "1")) == 2
    assert "--profile is not supported with --graph-shards" in \
        capsys.readouterr().err


def test_sigusr2_capture_of_a_training_subprocess(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS", "CGNN_TPU_FAULTS")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    procs = {}
    for name in ("signalled", "plain"):
        procs[name] = subprocess.Popen(
            [sys.executable, "-u", "-m", "cgnn_tpu_torch.train",
             *_argv(tmp_path / name, epochs=12)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    proc = procs["signalled"]
    seen = []
    try:
        for line in proc.stdout:
            seen.append(line)
            if line.startswith("Epoch 1:"):
                proc.send_signal(signal.SIGUSR2)
                break
        rest, _ = proc.communicate(timeout=300)
        out_plain, _ = procs["plain"].communicate(timeout=300)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out = "".join(seen) + rest
    assert proc.returncode == 0, out[-3000:]
    assert procs["plain"].returncode == 0, out_plain[-3000:]
    assert "profile: captured" in out, out[-3000:]
    logs = tmp_path / "signalled" / "ck" / "logs"
    caps = [d for d in os.listdir(logs) if d.startswith("profile-")]
    assert len(caps) == 1, os.listdir(logs)
    assert sorted(os.listdir(logs / caps[0])) == ["device_trace.json",
                                                  "host_trace.json"]
    assert _bit_equal(_params(tmp_path / "signalled"),
                      _params(tmp_path / "plain"))
