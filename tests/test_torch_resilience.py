"""The port's resilience layer (``cgnn_tpu_torch/resilience``: ``preempt``,
``faultinject``, ``guard``; its wiring in ``train/loop.py`` ``fit``, the
checkpoint finalizer's crash points and ``python -m
cgnn_tpu_torch.train``) on the CPU, class for class as
tests/test_resilience.py holds the JAX package's, on the same numpy
inputs and weights (convert.py):

- ``FaultPlan.parse`` and ``describe`` equal the JAX package's on every
  key of the ``CGNN_TPU_FAULTS`` grammar;
- the guard's no-op is bit-equal to the port's own unguarded run, in the
  per-step loop and under the epoch driver (the JAX test of this
  property is red on the reference, so the port is held to itself); a
  NaN batch skipped by the guard leaves every tensor and the count
  bit-equal to a run that never saw it; under the epoch driver the staged
  poisoned batch is skipped once every epoch, dense and COO, and the
  optimizer's host count ends equal to its device count;
- against the JAX ``fit`` with ``nan_batch`` and SGD (pack-once): the
  same ``guard_skipped`` each epoch, and the per-epoch train loss, train
  MAE and val MAE within rel 1e-5 (the JAX package's tolerance between
  its drivers, tests/test_train.py);
- the ``DivergenceMonitor``'s decisions, rate cut and rollbacks equal the
  JAX monitor's on the same metric sequence; the cut rewrites the rate
  table in place and halves an SGD update (rtol 1e-6, f32 round-off);
  its meta survives a requeue; a rollback inside ``fit`` restores in
  place;
- the preemption handler latches a real signal, hands a second one to
  the previous disposition and restores the previous handlers (the suite
  runs under xdist: each test puts them back in ``finally``); the epoch
  driver stops at a chunk boundary; ``fit`` saves a mid-epoch stop under
  epoch - 1 and a resume completes the full epoch count;
- each crash point of the checkpoint finalizer leaves the previous save
  restorable, and ``corrupt_checkpoint`` drives the fallback chain;
- ``loader_exc`` propagates through the prefetch loader and its producer
  thread exits; a batch packed page-locked (``pack_graphs(pin=True)``,
  what the loader copies from on a card) is bit-equal to the pageable
  one, dense and COO, and every tensor of it was made page-locked (the
  CPU build cannot pin: the allocator is stood in for);
- COO training repeats its bits: the endpoint gathers' fixed-order
  backward (``ops/segment.py`` ``gather_fixed_order``, over the
  packer's ``csr_transpose``) equals ``index_select``'s gradient in f64
  within rtol 1e-12 (the same terms summed in another order), and a COO
  driver run twice, and resumed from a checkpoint against the in-memory
  state, is bit-equal;
- the train entry point: train.py's resilience flags and defaults, exit
  75 on an injected SIGTERM and ``--resume auto`` completing the run (a
  subprocess), an injected ``crash=after_write:2:exit`` dying with 137
  and leaving the first save restorable, ``--debug-nans`` naming the
  first module whose output is not finite, ``--guard rollback`` keeping
  its progress in every save's meta.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cgnn_tpu.resilience import DivergenceError as JDivergenceError
from cgnn_tpu.resilience import DivergenceMonitor as JDivergenceMonitor
from cgnn_tpu.resilience import faultinject as jfaultinject
from cgnn_tpu.train.state import make_optimizer as jmake_optimizer
from cgnn_tpu_torch.config import DataConfig, ModelConfig
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
from cgnn_tpu_torch.data.loader import prefetch_to_device
from cgnn_tpu_torch.resilience import faultinject
from cgnn_tpu_torch.resilience.guard import (
    DivergenceError,
    DivergenceMonitor,
    guard_step,
)
from cgnn_tpu_torch.resilience.preempt import (
    RESUMABLE_EXIT_CODE,
    PreemptionHandler,
)
from cgnn_tpu_torch.train.__main__ import build_parser
from cgnn_tpu_torch.train.__main__ import main as train_main
from cgnn_tpu_torch.train.checkpoint import CheckpointManager
from cgnn_tpu_torch.train.loop import ScanEpochDriver, fit
from cgnn_tpu_torch.train.state import init_train_state
from cgnn_tpu_torch.train.step import make_eval_step, make_train_step
from test_torch_driver import (  # noqa: F401 — setup is a fixture
    EPOCHS,
    KW,
    SGD,
    _close,
    _fresh,
    _jax_fit,
    _port,
    setup,
)
from test_torch_train import M, SMALL

ROOT = Path(__file__).resolve().parents[1]
UPDATE_RTOL = 1e-6  # a cut SGD update against half the full one (f32)


@pytest.fixture(autouse=True)
def _clear_fault_plans():
    yield
    faultinject.set_plan(None)
    jfaultinject.set_plan(None)


def _graphs(setup):
    train_g, val_g, _ = setup
    return [_port(g) for g in train_g], [_port(g) for g in val_g]


def _state(setup):
    return _fresh(setup, "sgd", SGD)


def _coo_state(setup):
    train_g, _ = _graphs(setup)
    cfg = ModelConfig(**SMALL, dense_m=0, aggregation="pallas")
    state, nc, ec = init_train_state(cfg, DataConfig(radius=5.0,
                                                     max_num_nbr=M),
                                     train_g, batch_size=10, device="cpu",
                                     seed=2)
    return state, nc, ec


def _fit(setup, state, **kw):
    train_g, val_g = _graphs(setup)
    return fit(state, train_g, val_g, device="cpu",
               **(dict(KW, epochs=EPOCHS) | kw))


def _bits(state) -> list:
    return ([t.detach().clone() for t in state.model.state_dict().values()]
            + [t.clone() for t in state.optimizer.tensors()])


def _assert_bits_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _finite(state) -> bool:
    return all(bool(torch.isfinite(p).all())
               for p in state.model.parameters())


def _device_count(state) -> int:
    return int(state.optimizer.tensors()[0])


def _plan(spec):
    faultinject.set_plan(faultinject.FaultPlan.parse(spec))


# ---------------------------------------------------------------------------
# the fault plan
# ---------------------------------------------------------------------------


SPECS = ["nan_batch=5;sigterm_epoch=1;crash=after_write:2:exit",
         "crash=before_commit", "crash=after_commit:3", "loader_exc=4",
         "dispatch_exc=2:5;wedge_flush=1:2.5;slow_dispatch=40:3",
         "drop_conn=7;boot_crash=2;wedge_warm=;exit75_at=9",
         "label_noise=2:3.5;dispatch_exc=0", " nan_batch=0 ; ", ""]


class TestFaultPlan:
    @pytest.mark.parametrize("spec", SPECS)
    def test_parse_and_describe_match_jax(self, spec):
        got = faultinject.FaultPlan.parse(spec)
        want = jfaultinject.FaultPlan.parse(spec)
        assert got.describe() == want.describe()
        for f in dataclasses.fields(got):
            if not f.name.startswith("_"):
                assert getattr(got, f.name) == getattr(want, f.name), f.name

    def test_unknown_key_rejected(self):
        with pytest.raises(ValueError, match="unknown fault key"):
            faultinject.FaultPlan.parse("chaos_monkey=1")

    def test_unported_keys_are_named(self):
        # the serving hooks are ported (serve/server.py, serve/http.py,
        # python -m cgnn_tpu_torch.serve); only label_noise is not
        p = faultinject.FaultPlan.parse(SPECS[4] + ";nan_batch=1")
        assert faultinject.unported_keys(p) == []
        assert faultinject.serving_keys(p) == [
            "dispatch_exc", "wedge_flush", "slow_dispatch"]
        assert faultinject.unported_keys(
            faultinject.FaultPlan.parse(SPECS[6])) == ["label_noise"]
        assert faultinject.unported_keys(
            faultinject.FaultPlan.parse(SPECS[0])) == []

    def test_no_plan_is_a_passthrough(self, monkeypatch):
        monkeypatch.delenv(faultinject.ENV_VAR, raising=False)
        faultinject.set_plan(None)
        batches = [object()]
        out = list(faultinject.poison_batches(iter(batches)))
        assert len(out) == 1 and out[0] is batches[0]
        faultinject.crash_point("after_write")  # no-op
        faultinject.maybe_sigterm(0)  # no-op

    def test_env_plan_and_poison(self, monkeypatch, setup):
        monkeypatch.setenv(faultinject.ENV_VAR, "nan_batch=1")
        train_g, _ = _graphs(setup)
        nc, ec = capacities_for(train_g, 10, dense_m=M)
        batches = list(batch_iterator(train_g, 10, nc, nc * M, dense_m=M,
                                      snug=True))
        out = list(faultinject.poison_batches(iter(batches[:3])))
        assert out[0] is batches[0] and out[2] is batches[2]
        assert torch.isnan(out[1].targets).all()
        assert torch.isnan(out[1].nodes).all()
        assert torch.equal(out[1].edges, batches[1].edges)


# ---------------------------------------------------------------------------
# the in-graph guard
# ---------------------------------------------------------------------------


class TestDivergenceGuard:
    @pytest.mark.parametrize("mode", [dict(pack_once=True),
                                      dict(scan_epochs=True, buckets=2)],
                             ids=["per_step", "driver"])
    def test_guard_noop_is_bit_identical(self, setup, mode):
        s_off, r_off = _fit(setup, _state(setup), **mode)
        s_on, r_on = _fit(setup, _state(setup), guard=True, **mode)
        _assert_bits_equal(_bits(s_on), _bits(s_off))
        assert s_on.optimizer.count == s_off.optimizer.count
        for h0, h1 in zip(r_off["history"], r_on["history"]):
            assert h1["train"]["guard_skipped"] == 0.0
            h1 = {p: {k: v for k, v in h1[p].items()
                      if not k.startswith("guard")} for p in ("train", "val")}
            assert h1["train"] == h0["train"] and h1["val"] == h0["val"]

    def test_nan_batch_skip_equals_manual_skip_bit_exact(self, setup):
        train_g, _ = _graphs(setup)
        nc, _ = capacities_for(train_g, 10, dense_m=M)
        batches = list(batch_iterator(train_g, 10, nc, nc * M, dense_m=M,
                                      snug=True))
        assert len(batches) >= 3
        step = guard_step(make_train_step())
        j = 1
        s1, s2 = _state(setup), _state(setup)
        skips = 0.0
        for i, b in enumerate(batches):
            m = step(s1, faultinject.poison_nan(b) if i == j else b)
            skips += float(m["guard_skipped_sum"])
            if i == j:
                assert all(float(v) == 0.0 for k, v in m.items()
                           if not k.startswith("guard"))
        for i, b in enumerate(batches):
            if i != j:
                step(s2, b)
        assert skips == 1.0
        assert _device_count(s1) == _device_count(s2) == len(batches) - 1
        _assert_bits_equal(_bits(s1), _bits(s2))

    @pytest.mark.parametrize("layout", ["dense", "coo"])
    def test_driver_skips_the_staged_nan_batch_every_epoch(self, setup,
                                                           layout):
        def run(guard):
            _plan("nan_batch=1")
            if layout == "dense":
                state, kw = _state(setup), {}
            else:
                state, nc, ec = _coo_state(setup)
                kw = dict(dense_m=None, node_cap=nc, edge_cap=ec)
            return _fit(setup, state, scan_epochs=True, guard=guard, **kw)

        state, res = run(True)
        steps = sum(h["train"]["steps"] for h in res["history"])
        for h in res["history"]:
            assert np.isfinite(h["train"]["loss"])
            assert h["train"]["guard_skipped"] * h["train"]["steps"] == 1.0
        assert _finite(state)
        assert state.optimizer.count == _device_count(state) == \
            steps - EPOCHS
        assert res["graphs"]["captures_after_warm"] == 0
        control, _ = run(False)  # without the guard the NaN reaches it
        assert not _finite(control)

    def test_fit_matches_the_jax_fit_with_a_nan_batch(self, setup):
        jfaultinject.set_plan(jfaultinject.FaultPlan.parse("nan_batch=1"))
        want = _jax_fit(setup, "sgd", SGD, pack_once=True, guard=True)
        _plan("nan_batch=1")
        state, got = _fit(setup, _state(setup), pack_once=True, guard=True)
        _close(got["history"], want)
        for t, j in zip(got["history"], want):
            assert t["train"]["guard_skipped"] == j["train"]["guard_skipped"]
            assert t["train"]["guard_skipped"] * t["train"]["steps"] == 1.0
        assert state.optimizer.count == _device_count(state)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------


class RequestAfterPolls:
    """Reads as requested from the (n+1)-th poll on: a signal that lands
    while the n-th chunk runs."""

    def __init__(self, n):
        self.polls, self.n = 0, n

    @property
    def requested(self):
        self.polls += 1
        return self.polls > self.n


class TestPreemption:
    def test_handler_latches_real_sigterm(self):
        before = signal.getsignal(signal.SIGTERM), signal.getsignal(
            signal.SIGINT)
        hits = []
        handler = PreemptionHandler(log_fn=hits.append).install()
        try:
            assert not handler.requested
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.time() + 2
            while not handler.requested and time.time() < deadline:
                time.sleep(0.01)
            assert handler.requested
            assert hits and "SIGTERM" in hits[0]
        finally:
            handler.uninstall()
        assert (signal.getsignal(signal.SIGTERM),
                signal.getsignal(signal.SIGINT)) == before

    def test_second_signal_goes_to_the_previous_handler(self):
        seen = []
        prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
        handler = PreemptionHandler(log_fn=lambda m: None)
        try:
            handler.install(signals=(signal.SIGUSR1,))
            fired = []
            handler.add_callback(lambda: fired.append(1))
            os.kill(os.getpid(), signal.SIGUSR1)
            assert handler.requested and fired == [1] and seen == []
            os.kill(os.getpid(), signal.SIGUSR1)
            assert seen == [signal.SIGUSR1]
        finally:
            handler.uninstall()
            signal.signal(signal.SIGUSR1, prev)

    def test_epoch_boundary_preempt_then_resume_full_count(self, setup,
                                                           tmp_path):
        ckpt = CheckpointManager(str(tmp_path))
        pre = PreemptionHandler(log_fn=lambda m: None)

        def save(s, e, m, b):
            ckpt.save(s, {"epoch": e}, is_best=b)
            if e == 1:
                pre.request()

        try:
            _, res = _fit(setup, _state(setup), epochs=5, on_epoch_end=save,
                          preempt=pre)
            assert res["preempted"] is True
            assert [h["epoch"] for h in res["history"]] == [0, 1]
            ckpt.wait()
            assert ckpt.read_meta()["epoch"] == 1
            resumed, meta = ckpt.restore(_state(setup))
            _, r2 = _fit(setup, resumed, epochs=5,
                         start_epoch=meta["epoch"] + 1)
            assert [h["epoch"] for h in r2["history"]] == [2, 3, 4]
            assert "preempted" not in r2
        finally:
            ckpt.close()

    def test_driver_aborts_at_a_chunk_boundary(self, setup):
        train_g, val_g = _graphs(setup)
        nc, _ = capacities_for(train_g, 8, dense_m=M)
        batches = list(batch_iterator(train_g, 8, nc, nc * M, dense_m=M,
                                      snug=True))
        vbatches = list(batch_iterator(val_g, 8, nc, nc * M, dense_m=M,
                                       in_cap=0, snug=True))
        assert len(batches) >= 4 and len(vbatches) >= 2

        def driver(n):
            return ScanEpochDriver(
                make_train_step(), make_eval_step(), batches, vbatches,
                np.random.default_rng(7), device="cpu",
                preempt=RequestAfterPolls(n))

        drv = driver(1)
        state = _state(setup)
        drv.warm(state)
        _, train_m, val_m = drv.run_epoch_pair(state, first=True)
        assert drv.aborted and not drv.eval_truncated
        assert train_m["steps"] == drv.chunk_steps < len(batches)
        assert val_m == {"count": 0.0, "steps": 0}
        assert state.optimizer.count == drv.chunk_steps
        # a request during eval: the train epoch completed, eval is cut
        drv2 = driver(-(-len(batches) // drv.chunk_steps))
        state2 = _state(setup)
        drv2.warm(state2)
        _, train_m2, val_m2 = drv2.run_epoch_pair(state2, first=True)
        assert not drv2.aborted and drv2.eval_truncated
        assert train_m2["steps"] == len(batches)
        assert val_m2["steps"] < len(vbatches)

    def test_fit_driver_preempted_mid_epoch_saves_the_last_completed(
            self, setup, tmp_path):
        ckpt = CheckpointManager(str(tmp_path))
        saved = []

        def save(s, e, m, b):
            saved.append(e)
            ckpt.save(s, {"epoch": e}, is_best=b)

        pre = RequestAfterPolls(10**9)

        def save_and_arm(s, e, m, b):
            save(s, e, m, b)
            if e == 0:  # the epoch-end poll, then epoch 1's first chunk
                pre.n = pre.polls + 2

        try:
            state, res = _fit(setup, _state(setup), epochs=4,
                              scan_epochs=True, on_epoch_end=save_and_arm,
                              preempt=pre)
            assert res["preempted"] is True
            assert [h["epoch"] for h in res["history"]] == [0]
            assert saved == [0, 0]  # epoch 1 stopped: saved under 0
            ckpt.wait()
            assert ckpt.read_meta()["epoch"] == 0
            assert state.optimizer.count == _device_count(state) > \
                res["history"][0]["train"]["steps"]
            resumed, meta = ckpt.restore(_state(setup))
            _, r2 = _fit(setup, resumed, epochs=4, scan_epochs=True,
                         start_epoch=meta["epoch"] + 1)
            assert [h["epoch"] for h in r2["history"]] == [1, 2, 3]
        finally:
            ckpt.close()


# ---------------------------------------------------------------------------
# the rollback monitor
# ---------------------------------------------------------------------------


class _JState:
    """The JAX monitor's view of a state: ``tx`` and ``replace``."""

    def __init__(self, tx):
        self.tx = tx

    def replace(self, **kw):
        return _JState(kw.get("tx", self.tx))


class _JCkpt:
    def __init__(self, exists):
        self.has = exists

    def exists(self, tag="latest"):
        return self.has

    def restore(self, state):
        return state, {"epoch": 0}


def _sgd_delta(state) -> list:
    """Each parameter's change from one SGD update with every gradient
    1, from zero parameters and momentum, so each change is the rate
    itself (the state is left as it was)."""
    before = _bits(state)
    with torch.no_grad():
        for p in state.optimizer.params:
            p.zero_()
            p.grad = torch.ones_like(p)
        for t in state.optimizer.tensors()[1:]:
            t.zero_()
    state.optimizer.step()
    delta = [p.detach().clone() for p in state.optimizer.params]
    with torch.no_grad():
        for t, b in zip(list(state.model.state_dict().values())
                        + state.optimizer.tensors(), before):
            t.copy_(b)
    state.optimizer.zero_grad()
    return delta


class TestDivergenceMonitor:
    SEQ = [{"loss": 1.0, "guard_skipped": 0.0, "steps": 4},
           {"loss": 1.0, "guard_skipped": 0.5, "steps": 4},
           {"loss": float("nan"), "steps": 4},
           {"loss": 1.0, "guard_skipped": 0.25, "steps": 4},
           {"loss": 1.0, "guard_skipped": 0.75, "steps": 4}]

    def test_decisions_match_the_jax_monitor(self, setup, tmp_path):
        state = _state(setup)
        ckpt = CheckpointManager(str(tmp_path))
        try:
            ckpt.save(state, {"epoch": 0})
            ckpt.wait()
            full = _sgd_delta(state)
            table = state.optimizer._lr_table
            ptr = table.data_ptr()
            mon = DivergenceMonitor(ckpt, max_skips=2, lr_cut=0.5,
                                    max_rollbacks=2, log_fn=lambda m: None)
            jmon = JDivergenceMonitor(_JCkpt(True), max_skips=2, lr_cut=0.5,
                                      max_rollbacks=2, log_fn=lambda m: None)
            jstate = _JState(jmake_optimizer("sgd", lr=0.05))
            for epoch, m in enumerate(self.SEQ):
                try:
                    jstate, jrolled = jmon.observe(jstate, epoch, m)
                    jerr = None
                except JDivergenceError as e:
                    jerr = e
                if jerr is not None:
                    with pytest.raises(DivergenceError):
                        mon.observe(state, epoch, m)
                    break
                state, rolled = mon.observe(state, epoch, m)
                assert rolled == jrolled
                assert (mon.lr_scale, mon.rollbacks) == (jmon.lr_scale,
                                                         jmon.rollbacks)
            assert jerr is not None and mon.rollbacks == 2
            assert table.data_ptr() == ptr and state.optimizer.lr_scale == \
                0.25
            for a, b in zip(_sgd_delta(state), full):
                torch.testing.assert_close(a, b * 0.25, rtol=UPDATE_RTOL,
                                           atol=0.0)
        finally:
            ckpt.close()

    def test_progress_survives_a_requeue_via_meta(self, setup, tmp_path):
        state = _state(setup)
        ckpt = CheckpointManager(str(tmp_path))
        try:
            ckpt.save(state, {"epoch": 0})
            ckpt.wait()
            mon = DivergenceMonitor(ckpt, max_skips=2, lr_cut=0.5,
                                    max_rollbacks=3, log_fn=lambda m: None)
            mon.observe(state, 1, self.SEQ[1])
            meta = {"epoch": 1, **mon.meta()}
            assert meta["guard_lr_scale"] == 0.5
            assert meta["guard_rollbacks"] == 1
            mon2 = DivergenceMonitor(ckpt, max_skips=2, lr_cut=0.5,
                                     max_rollbacks=3, log_fn=lambda m: None)
            fresh = _state(setup)
            full = _sgd_delta(fresh)
            fresh = mon2.resume_from_meta(fresh, meta)
            assert (mon2.lr_scale, mon2.rollbacks) == (0.5, 1)
            for a, b in zip(_sgd_delta(fresh), full):
                torch.testing.assert_close(a, b * 0.5, rtol=UPDATE_RTOL,
                                           atol=0.0)
            untouched = _state(setup)
            mon3 = DivergenceMonitor(ckpt, log_fn=lambda m: None)
            assert mon3.resume_from_meta(untouched, {"epoch": 0}) is untouched
            assert untouched.optimizer.lr_scale == 1.0
        finally:
            ckpt.close()

    def test_nonfinite_loss_triggers_and_no_ckpt_continues(self, setup,
                                                           tmp_path):
        state = _state(setup)
        ckpt = CheckpointManager(str(tmp_path / "empty"))
        try:
            mon = DivergenceMonitor(ckpt, log_fn=lambda m: None)
            s, rolled = mon.observe(state, 0, self.SEQ[2])
            assert not rolled and s is state and mon.rollbacks == 0
            ckpt.save(state, {"epoch": 0})
            ckpt.wait()
            _, rolled = mon.observe(state, 1, self.SEQ[2])
            assert rolled and mon.rollbacks == 1
        finally:
            ckpt.close()

    def test_fit_rolls_back_in_place_until_the_budget_is_spent(
            self, setup, tmp_path):
        """A poisoned staged batch under the epoch driver, one skip allowed an
        epoch: epoch 0 has no checkpoint to go back to, so it is saved;
        epoch 1 rolls back to it with the rate halved, in place; epoch 2
        spends the budget."""
        state = _state(setup)
        ptrs = [t.data_ptr() for t in list(state.model.state_dict().values())
                + state.optimizer.tensors()]
        ckpt = CheckpointManager(str(tmp_path))
        mon = DivergenceMonitor(ckpt, max_skips=1, max_rollbacks=1,
                                log_fn=lambda m: None)
        metas = []

        def save(s, e, m, b):
            metas.append({"epoch": e, **mon.meta()})
            ckpt.save(s, metas[-1], is_best=b)

        _plan("nan_batch=1")
        try:
            with pytest.raises(DivergenceError, match="1 rollbacks already"):
                _fit(setup, state, scan_epochs=True, guard=True,
                     monitor=mon, on_epoch_end=save)
            assert metas == [{"epoch": 0, "guard_lr_scale": 1.0,
                              "guard_rollbacks": 0}]
            assert mon.rollbacks == 1 and state.optimizer.lr_scale == 0.5
            assert ptrs == [t.data_ptr() for t in list(
                state.model.state_dict().values())
                + state.optimizer.tensors()]
        finally:
            ckpt.close()


# ---------------------------------------------------------------------------
# checkpoints under injected crashes and corruption
# ---------------------------------------------------------------------------


class TestCrashSafeCheckpoint:
    @pytest.mark.parametrize("point", ["after_write", "before_commit",
                                       "after_commit"])
    def test_crash_point_leaves_the_previous_save_restorable(
            self, setup, tmp_path, point):
        state = _state(setup)
        ckpt = CheckpointManager(str(tmp_path), log_fn=lambda m: None)
        try:
            ckpt.save(state, {"epoch": 0})
            ckpt.wait()
            first = _bits(state)
            with torch.no_grad():
                for p in state.model.parameters():
                    p.add_(1.0)
            _plan(f"crash={point}:1")
            ckpt.save(state, {"epoch": 1})
            with pytest.raises(faultinject.InjectedCrash, match=point):
                ckpt.wait()
            faultinject.set_plan(None)
            restored, meta = CheckpointManager(
                str(tmp_path), log_fn=lambda m: None).restore(_state(setup))
            # a crash after the commit left the new save committed
            want_epoch = 1 if point == "after_commit" else 0
            assert meta["epoch"] == want_epoch
            if want_epoch == 0:
                _assert_bits_equal(_bits(restored), first)
        finally:
            ckpt.close()

    @pytest.mark.parametrize("mode", ["garble", "truncate", "meta"])
    def test_corrupt_latest_falls_back_with_a_report(self, setup, tmp_path,
                                                     mode):
        state = _state(setup)
        ckpt = CheckpointManager(str(tmp_path), log_fn=lambda m: None)
        try:
            ckpt.save(state, {"epoch": 0})
            ckpt.save(state, {"epoch": 1})
            ckpt.wait()
            newest = ckpt.newest_committed()
            faultinject.corrupt_checkpoint(str(tmp_path / newest), mode)
            _, meta = ckpt.restore(_state(setup))
            assert meta["epoch"] == 0
            assert len(ckpt.last_restore_report) == 1
            assert ckpt.last_restore_report[0].startswith(newest)
        finally:
            ckpt.close()


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------


def _alive_producers():
    return [t for t in threading.enumerate()
            if t.name == "cgnn-torch-prefetch" and t.is_alive()]


class TestLoaderShutdown:
    def test_injected_loader_exception_propagates(self, setup):
        train_g, _ = _graphs(setup)
        nc, _ = capacities_for(train_g, 10, dense_m=M)
        batches = list(batch_iterator(train_g, 10, nc, nc * M, dense_m=M,
                                      snug=True))
        _plan("loader_exc=2")
        got = []
        with pytest.raises(faultinject.InjectedLoaderError, match="batch 2"):
            for b in prefetch_to_device(
                    faultinject.poison_batches(iter(batches)), "cpu"):
                got.append(b)
        assert len(got) == 2
        deadline = time.time() + 5
        while _alive_producers() and time.time() < deadline:
            time.sleep(0.02)
        assert not _alive_producers()

    @pytest.mark.parametrize("layout", ["dense", "coo"])
    def test_pinned_pack_is_bit_equal_and_page_locked(self, setup,
                                                      monkeypatch, layout):
        """``pack_graphs(pin=True)`` against the pageable pack of the same
        graphs: every field bit-equal, and every tensor one the page-locked
        allocator made (so none is a pageable view the loader would copy
        synchronously). The CPU build cannot pin: ``torch.zeros(...,
        pin_memory=True)`` and ``Tensor.pin_memory`` are stood in for by
        versions that record the tensors they return."""
        train_g, _ = _graphs(setup)
        dense_m = M if layout == "dense" else None
        nc, ec = capacities_for(train_g, 10, dense_m=dense_m)
        packed = list(batch_iterator(train_g, 10, nc, ec, dense_m=dense_m,
                                     snug=True))
        want, graphs = packed[0], train_g[:int(packed[0].graph_mask.sum())]
        made = []
        zeros, pin_memory = torch.zeros, torch.Tensor.pin_memory

        def fake_zeros(*a, pin_memory=False, **kw):
            t = zeros(*a, **kw)
            if pin_memory:
                made.append(t)
            return t

        def fake_pin_memory(t):
            made.append(t.clone())
            return made[-1]

        monkeypatch.setattr(torch, "zeros", fake_zeros)
        monkeypatch.setattr(torch.Tensor, "pin_memory", fake_pin_memory)
        kw = ({"over_cap": want.over_slots.numel()} if dense_m
              else {"coo_transpose": True})
        got = tgraph.pack_graphs(graphs, nc, ec, want.graph_capacity,
                                 dense_m=dense_m, pin=True, **kw)
        monkeypatch.setattr(torch, "zeros", zeros)
        monkeypatch.setattr(torch.Tensor, "pin_memory", pin_memory)
        owners = {t.untyped_storage().data_ptr() for t in made}
        for f in dataclasses.fields(want):
            a, b = getattr(want, f.name), getattr(got, f.name)
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), f.name
                assert b.untyped_storage().data_ptr() in owners, f.name
        assert (got.in_slots is None) == (layout == "coo")
        assert (got.nbr_order is None) == (layout == "dense")


# ---------------------------------------------------------------------------
# the train entry point
# ---------------------------------------------------------------------------


def _argv(tmp_path, *extra, epochs=2):
    return ["--synthetic", "40", "--device", "cpu", "--epochs", str(epochs),
            "-b", "8", "--radius", "5", "--n-conv", "2", "--atom-fea-len",
            "16", "--h-fea-len", "24", "--print-freq", "0", "--ckpt-dir",
            str(tmp_path / "ck"), "--out-dir", str(tmp_path / "out"), *extra]


def _run(argv, faults=""):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    if faults:
        env[faultinject.ENV_VAR] = faults
    else:
        env.pop(faultinject.ENV_VAR, None)
    return subprocess.run([sys.executable, "-m", "cgnn_tpu_torch.train",
                           *argv], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


class TestEntryPoint:
    def test_flags_and_defaults_are_train_py_s(self):
        args = build_parser().parse_args([])
        assert (args.guard, args.guard_max_skips, args.guard_lr_cut,
                args.guard_max_rollbacks, args.no_preempt_handler,
                args.debug_nans) == ("skip", 3, 0.5, 3, False, False)

    def test_sigterm_exits_75_and_resume_auto_completes(self, tmp_path):
        out = _run(_argv(tmp_path, "--device-resident", epochs=3),
                   faults="sigterm_epoch=0")
        assert out.returncode == RESUMABLE_EXIT_CODE, out.stderr[-2000:]
        assert "FAULT INJECTION ACTIVE: SIGTERM @epoch 0" in out.stderr
        assert "preempted: resumable checkpoint saved" in out.stdout
        assert "Epoch 1:" not in out.stdout
        again = _run(_argv(tmp_path, "--device-resident", "--resume",
                           "auto", epochs=3))
        assert again.returncode == 0, again.stderr[-2000:]
        assert "resumed from" in again.stdout and "at epoch 1" in \
            again.stdout
        assert "Epoch 2:" in again.stdout and "** test mae:" in again.stdout

    def test_crash_exit_dies_137_and_the_first_save_restores(self, tmp_path):
        out = _run(_argv(tmp_path), faults="crash=after_write:2:exit")
        assert out.returncode == 137, out.stderr[-2000:]
        ckpt = CheckpointManager(str(tmp_path / "ck"))
        try:
            assert ckpt.read_meta()["epoch"] == 0
        finally:
            ckpt.close()
        assert _run(_argv(tmp_path, "--resume", "auto")).returncode == 0

    def test_debug_nans_names_the_first_module(self, tmp_path, capsys):
        _plan("nan_batch=0")
        with pytest.raises(FloatingPointError,
                           match="non-finite output of module 'embedding'"):
            train_main(_argv(tmp_path, "--debug-nans", "--pack-once"))
        assert "step graphs off" in capsys.readouterr().out

    def test_rollback_keeps_its_progress_in_the_meta(self, tmp_path):
        _plan("nan_batch=1")
        with pytest.raises(DivergenceError):
            train_main(_argv(tmp_path, "--pack-once", "--guard", "rollback",
                             "--guard-max-skips", "1",
                             "--guard-max-rollbacks", "1", epochs=4))
        ckpt = CheckpointManager(str(tmp_path / "ck"))
        try:
            meta = ckpt.read_meta()
        finally:
            ckpt.close()
        assert (meta["epoch"], meta["guard_lr_scale"],
                meta["guard_rollbacks"]) == (0, 1.0, 0)
        _plan("nan_batch=1")
        with pytest.raises(DivergenceError, match="1 rollbacks already"):
            train_main(_argv(tmp_path, "--pack-once", "--guard", "rollback",
                             "--guard-max-skips", "1",
                             "--guard-max-rollbacks", "1", "--resume",
                             "auto", epochs=4))
        ckpt = CheckpointManager(str(tmp_path / "ck"))
        try:
            assert ckpt.read_meta()["epoch"] == 0
        finally:
            ckpt.close()


# ---------------------------------------------------------------------------
# COO bit-repeats: the endpoint gathers' fixed-order backward
# ---------------------------------------------------------------------------


class TestCooRepeats:
    @pytest.mark.parametrize("indices_sorted", [True, False])
    def test_fixed_order_gather_grad_equals_the_plain_gather_grad(
            self, indices_sorted):
        """f64: the sorted segment sum against ``index_select``'s scatter,
        within rtol 1e-12 (sums of the same terms in another order)."""
        from cgnn_tpu_torch.ops.segment import gather_fixed_order

        rng = np.random.default_rng(4)
        idx = rng.integers(0, 30, 200).astype(np.int32)
        idx[-20:] = 29  # the packer's padding edges, on the last node
        if indices_sorted:
            idx = np.sort(idx)
        order, offsets = tgraph.csr_transpose(idx, 30, indices_sorted)
        order = None if order is None else torch.from_numpy(order)
        idx = torch.from_numpy(idx)
        values = torch.from_numpy(rng.standard_normal((30, 5)))
        ct = torch.from_numpy(rng.standard_normal((200, 5)))
        x = values.clone().requires_grad_()
        out = gather_fixed_order(x, idx, order, torch.from_numpy(offsets))
        (out * ct).sum().backward()
        y = values.clone().requires_grad_()
        (y.index_select(0, idx) * ct).sum().backward()
        assert torch.equal(out.detach(), values[idx.long()])
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-12, atol=1e-12)

    def test_coo_driver_repeats_and_resumes_bit_equal(self, setup,
                                                      tmp_path):
        def run(state, nc, ec, epochs, start=0):
            return _fit(setup, state, epochs=epochs, start_epoch=start,
                        dense_m=None, node_cap=nc, edge_cap=ec,
                        scan_epochs=True)[0]

        runs = []
        for _ in range(2):
            state, nc, ec = _coo_state(setup)
            runs.append(_bits(run(state, nc, ec, 2)))
        _assert_bits_equal(*runs)
        state, nc, ec = _coo_state(setup)
        state = run(state, nc, ec, 1)
        ckpt = CheckpointManager(str(tmp_path))
        try:
            ckpt.save(state, {"epoch": 0})
            restored, _ = ckpt.restore(_coo_state(setup)[0])
        finally:
            ckpt.close()
        _assert_bits_equal(_bits(run(restored, nc, ec, 2, start=1)),
                           _bits(run(state, nc, ec, 2, start=1)))
