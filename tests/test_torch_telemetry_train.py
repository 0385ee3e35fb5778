"""Training telemetry of the port (``fit(telemetry=)``, the train entry
point's ``--telemetry``/``--log-dir``/``--live-metrics``) on the CPU.

- The epoch driver at ``step`` level against the JAX scan driver at step
  level, from the same weights and data (SGD): the train records count
  one per optimizer step, numbered 1..N in both, each step's loss within
  rel 1e-4 and its grad norm within rtol 1e-3 (f32, sums in another
  order); the eval records count alike; neither side streams a warm-up
  or capture run.
- The port against itself: final parameters and every epoch mean
  bit-equal at ``off``, ``epoch`` and ``step``, under the driver and the
  per-step loop; the driver's background pair fetch (and ``fit``'s
  deferred bookkeeping) bit-equal to the synchronous fetch, with the
  same schedules.
- The train entry point: at its default level it writes
  ``<ckpt-dir>/logs/metrics.jsonl`` (the epoch-0 aggregates first, then
  the later epochs, the test record, ``hbm``, ``padding`` and
  ``run_summary``), ``trace.json`` and ``manifest.json``; at ``step`` one
  record an optimizer step; at ``off`` nothing; ``--live-metrics``
  appends ``metrics_live.jsonl``; a preempted run (exit 75) still
  flushes its files; ``--resume auto`` resumes from a directory that
  holds ``logs/``; ``--profile N`` writes a profiler trace into the log
  dir.
- Two gloo ranks fed the same batches (a data-parallel step on replicated
  batches is the one-process step: a sum of two equal values halved is
  exact): process 0's step records equal, key for key, those of one
  process on those batches, one a step, under the per-step loop and the
  driver.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgnn_tpu.observe.telemetry import Telemetry as JTelemetry
from cgnn_tpu.train.loop import fit as jfit
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.state import TrainState as JTrainState
from cgnn_tpu.train.state import make_optimizer as jmake_optimizer
from cgnn_tpu_torch.observe.metrics_io import read_jsonl
from cgnn_tpu_torch.observe.telemetry import Telemetry
from cgnn_tpu_torch.train import loop as tloop
from cgnn_tpu_torch.train import state as tstate
from cgnn_tpu_torch.train.__main__ import main as train_main
from cgnn_tpu_torch.train.loop import fit
from cgnn_tpu_torch.train.normalizer import Normalizer
from test_torch_driver import _port
from test_torch_parallel import (
    RANK_TIMEOUT_S,
    ROOT,
    _child_env,
    _free_port,
    _wait_all,
)
from test_torch_train import SMALL, JNet, M, _graphs, _jax_variables, \
    _port_model
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

EPOCHS = 3
SGD = dict(lr=0.05, momentum=0.9)
KW = dict(batch_size=10, dense_m=M, seed=3, print_freq=0,
          log_fn=lambda *a: None)


@pytest.fixture(scope="module")
def setup():
    from test_torch_train import _batches

    train_g, val_g = _graphs(40, seed=8), _graphs(12, seed=9)
    jb, _ = _batches(train_g)
    variables = _jax_variables(JNet(**SMALL, dense_m=M), jb)
    return train_g, val_g, variables


def _fresh(setup):
    train_g, _, variables = setup
    net = _port_model({}, variables)
    return tstate.TrainState(
        net, tstate.make_optimizer(net.parameters(), "sgd", **SGD),
        Normalizer.fit(np.stack([g.target for g in train_g]), device="cpu"))


def _port_fit(setup, telemetry=None, **kw):
    train_g, val_g, _ = setup
    state, res = fit(_fresh(setup), [_port(g) for g in train_g],
                     [_port(g) for g in val_g], epochs=EPOCHS, device="cpu",
                     telemetry=telemetry, **KW, **kw)
    return state, res


def _records(recs, phase):
    out = sorted((r for r in recs if r["phase"] == phase),
                 key=lambda r: r["step"])
    return out


@pytest.mark.parametrize("buckets", [1, 2])
def test_step_records_match_the_jax_scan_driver(setup, tmp_path, buckets):
    train_g, val_g, variables = setup
    jnet = JNet(**SMALL, dense_m=M)
    tx = jmake_optimizer("sgd", **SGD)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        normalizer=JNormalizer.fit(np.stack([g.target for g in train_g])),
        rng=jax.random.key(0), apply_fn=jnet.apply, tx=tx)
    jtel = JTelemetry("step", str(tmp_path / "j"), use_clu=False)
    _, jres = jfit(jstate, train_g, val_g, epochs=EPOCHS, snug=True,
                   scan_epochs=True, buckets=buckets, telemetry=jtel, **KW)
    jax.effects_barrier()
    want = jtel.stream.records()
    jtel.close()
    tel = Telemetry("step", str(tmp_path / "t"))
    _, res = _port_fit(setup, tel, scan_epochs=True, buckets=buckets)
    got = tel.stream.records()
    tel.close()
    n_train = sum(h["train"]["steps"] for h in res["history"])
    assert n_train == sum(h["train"]["steps"] for h in jres["history"])
    g_train, w_train = _records(got, "train"), _records(want, "train")
    # one record an optimizer step, the in-graph count: no warm-up rows
    assert [r["step"] for r in g_train] == list(range(1, n_train + 1))
    assert [r["step"] for r in w_train] == list(range(1, n_train + 1))
    for g, w in zip(g_train, w_train):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-4), g["step"]
        assert g["count"] == w["count"]
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-3)
        assert g["nonfinite_grads"] == w["nonfinite_grads"] == 0.0
        assert set(w) - {"steps_per_s"} <= set(g)
    assert len(_records(got, "eval")) == len(_records(want, "eval")) \
        == sum(h["val"]["steps"] for h in res["history"])
    assert all(r["steps_per_s"] > 0 for r in got)
    assert tel.stream.dropped == 0


@pytest.mark.parametrize("mode", [dict(scan_epochs=True),
                                  dict(scan_epochs=True, buckets=2),
                                  dict(pack_once=True)],
                         ids=["driver", "driver_buckets2", "per_step"])
def test_levels_leave_the_trajectory_bit_equal(setup, tmp_path, mode):
    outs = {}
    for level in ("off", "epoch", "step"):
        tel = Telemetry(level, str(tmp_path / level))
        state, res = _port_fit(setup, tel, **mode)
        tel.close()
        outs[level] = ({k: v.clone() for k, v in
                        state.model.state_dict().items()}, res["history"])
    base_sd, base_h = outs["off"]
    for level in ("epoch", "step"):
        sd, hist = outs[level]
        for k, v in base_sd.items():
            assert torch.equal(sd[k], v), (level, k)
        for a, b in zip(base_h, hist):
            for part in ("train", "val"):
                for k, v in a[part].items():
                    assert b[part][k] == v, (level, part, k)
    assert not (tmp_path / "off").exists()
    recs = read_jsonl(str(tmp_path / "step" / "metrics.jsonl"))
    steps = [r for r in recs if r.get("event") == "step"
             and r["phase"] == "train"]
    assert len(steps) == sum(h["train"]["steps"] for h in base_h)
    assert not any(r.get("event") == "step" for r in read_jsonl(
        str(tmp_path / "epoch" / "metrics.jsonl")))
    summary = next(r for r in recs if r.get("event") == "run_summary")
    key = "scan_steps" if mode.get("scan_epochs") else "per_step_steps"
    assert summary["counters"][key] > 0
    names = {e["name"] for e in json.load(open(
        tmp_path / "epoch" / "trace.json"))["traceEvents"]}
    assert "epoch" in names
    if mode.get("scan_epochs"):
        assert {"pack", "stage_scan_stacks"} <= names


def test_background_pair_fetch_is_bit_equal_to_the_sync_fetch(setup):
    """The driver's ``async_fetch`` pair against the synchronous one: the
    same schedules (the trace), means and parameters, bit for bit, and
    ``fit``'s deferred bookkeeping (no hook) against its in-iteration
    join (a checkpoint hook)."""
    train_g, val_g, _ = setup
    outs = []
    for async_fetch in (False, True):
        state = _fresh(setup)
        rng = np.random.default_rng(3)
        nc, ec = tloop.batch_caps([_port(g) for g in train_g], 10, M)
        batches = list(tloop.batch_iterator(
            [_port(g) for g in train_g], 10, nc, ec, shuffle=True, rng=rng,
            dense_m=M))
        vals = list(tloop.batch_iterator([_port(g) for g in val_g], 10, nc,
                                         ec, dense_m=M, in_cap=0))
        from cgnn_tpu_torch.train.step import make_eval_step, make_train_step

        drv = tloop.ScanEpochDriver(make_train_step(), make_eval_step(),
                                    batches, vals, rng, device="cpu")
        drv.trace = []
        drv.warm(state)
        means = []
        for epoch in range(EPOCHS):
            if async_fetch:
                state, pending = drv.run_epoch_pair(
                    state, first=epoch == 0, async_fetch=True)
                means.append(pending.result())
            else:
                state, tm, vm = drv.run_epoch_pair(state, first=epoch == 0)
                means.append((tm, vm))
        outs.append((means, [(k, list(c)) for k, c in drv.trace],
                     state.model.state_dict()))
    (m0, t0, s0), (m1, t1, s1) = outs
    assert m0 == m1 and t0 == t1
    for k, v in s0.items():
        assert torch.equal(s1[k], v), k
    _, joined = _port_fit(setup, scan_epochs=True,
                          on_epoch_end=lambda *a: None)
    t0 = time.perf_counter()
    _, deferred = _port_fit(setup, scan_epochs=True)
    wall = time.perf_counter() - t0
    for a, b in zip(joined["history"], deferred["history"]):
        assert a["train"] == b["train"] and a["val"] == b["val"]
    # the deferred epochs' windows tile the run: none overlaps another
    secs = [h["seconds"] for h in deferred["history"]]
    assert all(s > 0 for s in secs) and sum(secs) <= wall


# ---------------------------------------------------------------------------
# the train entry point
# ---------------------------------------------------------------------------


def _argv(tmp_path, *extra, epochs=2):
    return ["--synthetic", "40", "--device", "cpu", "--epochs", str(epochs),
            "-b", "8", "--radius", "5", "--n-conv", "2", "--atom-fea-len",
            "16", "--h-fea-len", "24", "--print-freq", "0", "--ckpt-dir",
            str(tmp_path / "ck"), "--out-dir", str(tmp_path / "out"), *extra]


def _summary(out):
    return json.loads(next(line for line in out.splitlines()
                           if line.startswith("train: "))[7:])


def test_entry_point_writes_the_jax_layout_at_epoch(tmp_path, capsys):
    assert train_main(_argv(tmp_path, "--live-metrics", "0.05")) == 0
    summary = _summary(capsys.readouterr().out)
    logs = tmp_path / "ck" / "logs"
    assert sorted(os.listdir(logs)) == ["manifest.json", "metrics.jsonl",
                                        "metrics_live.jsonl", "trace.json"]
    recs = read_jsonl(str(logs / "metrics.jsonl"))
    # the epoch-0 aggregates first, then epoch 1, the test record, the
    # buffered events
    assert [(r.get("event"), r.get("step")) for r in recs[:5]] == [
        (None, 0), (None, 0), (None, 1), (None, 1), (None, 2)]
    assert "train/loss" in recs[0] and "val/mae" in recs[1]
    assert recs[0]["train/loss"] == pytest.approx(summary["train_loss"][0])
    assert "test/mae" in recs[4]
    events = [r["event"] for r in recs[5:]]
    assert events[0] == "hbm" and events[-1] == "run_summary"
    assert "padding" in events and "step" not in events
    run = recs[-1]
    assert run["counters"]["per_step_steps"] > 0
    assert run["gauges"]["train_epoch"] == 1.0
    names = {e["name"] for e in json.load(open(logs / "trace.json"))[
        "traceEvents"]}
    assert {"state_init", "epoch", "eval", "checkpoint_save",
            "test_eval"} <= names
    manifest = json.load(open(logs / "manifest.json"))
    assert manifest["backend"] == "cpu" and manifest["task"] == "regression"
    assert manifest["config"]["telemetry"] == "epoch"
    assert manifest["mesh_shape"] == {"data": 1, "graph": 1}
    live = read_jsonl(str(logs / "metrics_live.jsonl"))
    assert live and "gauges" in live[-1]
    # the checkpoint chain ignores logs/: resume and a further epoch
    assert train_main(_argv(tmp_path, "--resume", "auto", epochs=3)) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "Epoch 2:" in out
    again = read_jsonl(str(logs / "metrics.jsonl"))
    assert [r.get("step") for r in again[len(recs):][:2]] == [2, 2]


def test_entry_point_step_level_and_off(tmp_path, capsys):
    assert train_main(_argv(tmp_path, "--telemetry", "step",
                            "--device-resident", "--log-dir",
                            str(tmp_path / "tl"))) == 0
    summary = _summary(capsys.readouterr().out)
    recs = read_jsonl(str(tmp_path / "tl" / "metrics.jsonl"))
    steps = [r for r in recs if r.get("event") == "step"]
    train = sorted(r["step"] for r in steps if r["phase"] == "train")
    assert train == list(range(1, sum(summary["train_steps"]) + 1))
    assert sum(r["phase"] == "eval" for r in steps) == sum(
        summary["eval_steps"])
    assert all(np.isfinite(r["grad_norm"]) for r in steps
               if r["phase"] == "train")
    assert not (tmp_path / "ck" / "logs").exists()
    off = tmp_path / "off"
    assert train_main(_argv(off, "--telemetry", "off")) == 0
    assert sorted(os.listdir(off / "ck")) == ["best.json", "ckpt-00000000",
                                              "ckpt-00000001"]


def test_entry_point_profiles(tmp_path, capsys):
    assert train_main(_argv(tmp_path, "--profile", "3")) == 0
    logs = tmp_path / "ck" / "logs"
    traces = [f for f in os.listdir(logs) if f.startswith("profile-")]
    assert len(traces) == 1, os.listdir(logs)
    doc = json.load(open(logs / traces[0]))
    assert doc["traceEvents"]
    assert "profiler trace written to" in capsys.readouterr().out


def test_preempted_run_flushes_its_telemetry(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), CGNN_TPU_FAULTS="sigterm_epoch=0")
    out = subprocess.run([sys.executable, "-m", "cgnn_tpu_torch.train",
                          *_argv(tmp_path, "--device-resident", epochs=3)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 75, out.stderr[-2000:]
    logs = tmp_path / "ck" / "logs"
    recs = read_jsonl(str(logs / "metrics.jsonl"))
    assert [r["step"] for r in recs if "event" not in r] == [0, 0]
    assert recs[-1]["event"] == "run_summary"
    assert any(r.get("event") == "hbm" and r["tag"] == "preempted"
               for r in recs)
    assert (logs / "trace.json").exists()


# ---------------------------------------------------------------------------
# two gloo ranks against one process
# ---------------------------------------------------------------------------

# python -c WORKER rank world port spec out
WORKER = r'''
import sys
import time
import torch

torch.set_num_threads(2)
from cgnn_tpu_torch.parallel import dist


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    spec = torch.load(sys.argv[4], weights_only=False)
    dist.initialize(f"localhost:{port}", world, rank, backend="gloo",
                    timeout_s=60, log_fn=lambda *a: None)
    try:
        from test_torch_telemetry_train import run_fit

        out = run_fit(spec, sys.argv[5] + ".logs")
    finally:
        dist.shutdown()
    torch.save(out, sys.argv[5])


main()
'''


def run_fit(spec, log_dir):
    """One fit of ``spec`` at step level -> (step records, history)."""
    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model

    net = build_model(ModelConfig(**spec["model"]),
                      DataConfig(**spec["data"]), device="cpu")
    net.load_state_dict(spec["state_dict"])
    state = tstate.TrainState(
        net, tstate.make_optimizer(net.parameters(), "sgd", **SGD),
        Normalizer.fit(spec["targets"], device="cpu"))
    tel = Telemetry("step", log_dir)
    _, res = fit(state, spec["train"], spec["val"], epochs=2, device="cpu",
                 telemetry=tel, **KW, **spec["mode"])
    recs = tel.stream.records()
    tel.close()
    return recs, [(h["train"], h["val"]) for h in res["history"]]


@pytest.mark.parametrize("mode", [dict(pack_once=True),
                                  dict(scan_epochs=True)],
                         ids=["per_step", "driver"])
def test_two_gloo_ranks_stream_the_one_process_records(setup, tmp_path,
                                                       mode):
    train_g, val_g, variables = setup
    spec = {"model": dict(dense_m=M, **SMALL),
            "data": dict(radius=5.0, max_num_nbr=M),
            "state_dict": _port_model({}, variables).state_dict(),
            "targets": np.stack([g.target for g in train_g]),
            "train": [_port(g) for g in train_g],
            "val": [_port(g) for g in val_g], "mode": mode}
    torch.save(spec, tmp_path / "spec.pt")
    port = _free_port()
    env = _child_env()
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "tests"),
                                         env["PYTHONPATH"]])
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "2", str(port),
         str(tmp_path / "spec.pt"), str(tmp_path / f"out{r}.pt")],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = _wait_all(procs, RANK_TIMEOUT_S)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    ranks = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
             for r in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the ranks' count: CPU sums split by thread
    try:
        want, want_h = run_fit(spec, str(tmp_path / "one"))
    finally:
        torch.set_num_threads(threads)

    def strip(recs, phase):
        return [{k: v for k, v in r.items() if k not in ("steps_per_s",
                                                         "count")}
                for r in _records(recs, phase)]

    n_steps = sum(h[0]["steps"] for h in want_h)
    assert [r["step"] for r in _records(want, "train")] == list(
        range(1, n_steps + 1))
    for recs, hist in ranks:
        assert strip(recs, "train") == strip(want, "train")
        assert strip(recs, "eval") == strip(want, "eval")
        # the data group's sums: twice one process's graphs
        assert [r["count"] for r in _records(recs, "train")] == [
            2 * r["count"] for r in _records(want, "train")]
        assert [h[0]["loss"] for h in hist] == [h[0]["loss"]
                                                 for h in want_h]
