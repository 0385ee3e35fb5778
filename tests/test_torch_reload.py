"""Hot reload (``cgnn_tpu_torch/serve/reload.py``) on the CPU.

- The restore that a reload runs writes the normalizer in place
  (``CheckpointManager.restore_for_inference``): a captured predict graph
  reads its mean and std by address, so a rebound normalizer would serve
  new weights denormalized with the old statistics. A reload that changes
  only the mean and std changes a served answer by exactly that:
  ``out * std + mean`` of the model's own output, before and after.
- The watcher's decisions (stage or not, which save, pin, gate, holds,
  skips) against the JAX ``CheckpointWatcher`` on the same scripted
  directory, through a stand-in checkpoint manager.
- A server on a real checkpoint directory: the version flips at a flush
  boundary and the answers equal the plain path under the weights of the
  version they report; pin back down, gate, a corrupt save skipped and
  never retried; no row of the old version served after the swap.
"""

import os
import shutil
import time
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cgnn_tpu.serve import reload as jreload
from cgnn_tpu_torch.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu_torch.resilience import faultinject
from cgnn_tpu_torch.serve import reload as treload
from cgnn_tpu_torch.serve.server import load_server
from cgnn_tpu_torch.train.__main__ import main as train_main
from cgnn_tpu_torch.train.checkpoint import (
    CheckpointManager,
    inference_state,
    load_for_inference,
    load_tree,
)
from cgnn_tpu_torch.train.normalizer import Normalizer
from cgnn_tpu_torch.train.step import InferenceState, make_predict_step

SMALL_CLI = ["--radius", "5", "--n-conv", "2", "--atom-fea-len", "16",
             "--print-freq", "0"]
V0, V1, V2 = (f"ckpt-{i:08d}" for i in range(3))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("reload")
    ck = str(d / "ckpt")
    assert train_main(["--synthetic", "24", "--device", "cpu", "--epochs",
                       "1", "-b", "8", "--ckpt-dir", ck, "--out-dir",
                       str(d / "out"), *SMALL_CLI]) == 0
    graphs = load_synthetic(12, FeaturizeConfig(radius=5.0, max_num_nbr=12),
                            seed=6)
    return types.SimpleNamespace(ck=ck, graphs=graphs)


def _live(server, version, timeout=30.0) -> bool:
    """Wait until the server's worker has made ``version`` live."""
    end = time.monotonic() + timeout
    while server.version != version and time.monotonic() < end:
        time.sleep(0.01)
    return server.version == version


def _fresh_dir(trained, tmp_path) -> str:
    ck = str(tmp_path / "ck")
    shutil.copytree(trained.ck, ck)
    return ck


def _commit(ck, scale=1.0, mean_shift=0.0, std_scale=1.0) -> str:
    """Commit a new version of the newest save: every parameter times
    ``scale``, the normalizer's mean + ``mean_shift`` and std times
    ``std_scale`` -> its name."""
    mgr = CheckpointManager(ck, keep=0)
    newest = mgr.newest_committed()
    tree = load_tree(os.path.join(ck, newest, "state.npz"))
    meta = mgr.read_meta(newest)

    def scaled(t):
        if isinstance(t, dict):
            return {k: scaled(v) for k, v in t.items()}
        return (t * np.float32(scale)).astype(t.dtype)

    tree["params"] = scaled(tree["params"])
    tree["normalizer"] = {
        "mean": (tree["normalizer"]["mean"] + mean_shift).astype(np.float32),
        "std": (tree["normalizer"]["std"] * std_scale).astype(np.float32)}
    mgr.save_tree(tree, meta)
    mgr.close()
    return CheckpointManager(ck).newest_committed()


def test_restore_for_inference_writes_the_normalizer_in_place(trained,
                                                              tmp_path):
    ck = _fresh_dir(trained, tmp_path)
    _commit(ck, mean_shift=2.5, std_scale=0.5)
    mgr = CheckpointManager(ck)
    state = inference_state(mgr.read_meta(), "cpu")
    mean, std = state.normalizer.mean, state.normalizer.std
    ptrs = (mean.data_ptr(), std.data_ptr())
    for name in (V0, V1):
        mgr.restore_for_inference(state, name)
        assert state.normalizer.mean is mean and state.normalizer.std is std
        assert (mean.data_ptr(), std.data_ptr()) == ptrs
        tree = load_tree(os.path.join(ck, name, "state.npz"))
        np.testing.assert_array_equal(mean.numpy(),
                                      tree["normalizer"]["mean"])
        np.testing.assert_array_equal(std.numpy(), tree["normalizer"]["std"])


def _denorm_answer(server, g, mean, std) -> np.ndarray:
    """``out * std + mean`` of the live model's own output for ``g`` at
    the rung the server flushes one graph into."""
    ss = server.shape_set
    n, e = ss.graph_counts(g)
    batch = ss.pack_full([g], shape=ss.shape_for(1, n, e))
    with torch.inference_mode():
        out = server.state.model(batch)
        return ((out * torch.as_tensor(std) + torch.as_tensor(mean))
                * batch.graph_mask[:, None])[0].numpy()


def test_normalizer_reload_changes_the_answer_exactly(trained, tmp_path):
    ck = _fresh_dir(trained, tmp_path)
    server, _ = load_server(ck, batch_size=8, rungs=2,
                            calibration=trained.graphs, device="cpu",
                            poll_interval_s=3600.0, cache_size=0,
                            log_fn=lambda *a: None)
    try:
        g = trained.graphs[0]
        t0 = load_tree(os.path.join(ck, V0, "state.npz"))["normalizer"]
        before = server.predict(g)
        np.testing.assert_array_equal(
            before.prediction, _denorm_answer(server, g, t0["mean"],
                                              t0["std"]))
        mean_t = server.state.normalizer.mean
        _commit(ck, mean_shift=3.0, std_scale=2.0)
        assert server.watcher.poll_once()
        assert _live(server, V1)
        assert server.state.normalizer.mean is mean_t
        t1 = load_tree(os.path.join(ck, V1, "state.npz"))["normalizer"]
        after = server.predict(g)
        assert after.param_version == V1 and before.param_version == V0
        np.testing.assert_array_equal(
            after.prediction, _denorm_answer(server, g, t1["mean"],
                                             t1["std"]))
        assert not np.array_equal(after.prediction, before.prediction)
    finally:
        assert server.drain(timeout_s=30)


# ---- the watcher's decisions against the JAX one ----


class _Dir:
    """A stand-in checkpoint manager over an in-memory directory:
    ``saves`` maps a committed name to its value, or None for a save
    that fails verification."""

    def __init__(self):
        self.saves: dict = {V0: 0.0}
        self.last_restore_report: list = []

    def newest_committed(self):
        return max(self.saves) if self.saves else None

    def is_committed(self, name):
        return name in self.saves

    def restore_for_inference(self, template, name):
        self.last_restore_report = []
        value = self.saves.get(name)
        if value is None:
            self.last_restore_report = [f"{name}: crc mismatch"]
            raise RuntimeError(f"no restorable {name!r} checkpoint")
        if isinstance(template, InferenceState):  # the port's staging
            with torch.no_grad():
                template.model.weight.fill_(value)
            return template
        return value  # the JAX side: the value is the state


def _tiny_state(value=0.0) -> InferenceState:
    model = torch.nn.Linear(1, 1, bias=False)
    with torch.no_grad():
        model.weight.fill_(value)
    return InferenceState(model, Normalizer.identity(1, device="cpu"))


OP = st.one_of(
    st.tuples(st.just("commit"), st.booleans()),  # True: a corrupt save
    st.tuples(st.just("pin"), st.sampled_from((None, V0, V1, V2, "x"))),
    st.tuples(st.just("gate"), st.sampled_from((None, V0, V1, V2))),
    st.tuples(st.just("poll")), st.tuples(st.just("poll")))


def _drive(side, script):
    d = _Dir()
    logs = []
    if side == "jax":
        store = jreload.ParamStore(0.0, V0)
        w = jreload.CheckpointWatcher(d, store, None,
                                      log_fn=lambda *a: None)
        live = store.get
    else:
        store = treload.ParamStore(_tiny_state(), V0)
        w = treload.CheckpointWatcher(d, store, _tiny_state,
                                      log_fn=lambda *a: None)

        def live():
            return float(store.state.model.weight.detach()), store.version
    for op in script:
        if op[0] == "commit":
            name = f"ckpt-{len(d.saves):08d}"
            d.saves[name] = None if op[1] else float(len(d.saves))
        elif op[0] == "pin":
            w.set_pin(op[1])
        elif op[0] == "gate":
            w.set_gate(op[1])
        else:
            swapped = w.poll_once()
            if side == "port":
                # the serving worker applies the staged swap between two
                # flushes
                assert (store.apply_pending() is not None) == swapped
            logs.append((swapped, live(), w.control(), w.skips))
    return logs


@settings(max_examples=60, deadline=None, database=None)
@given(script=st.lists(OP, max_size=25))
def test_watcher_decisions_match_jax(script):
    assert _drive("port", script) == _drive("jax", script)


# ---- a server on a real checkpoint directory ----


def _plain(ck, name, server, g) -> np.ndarray:
    """The plain path under save ``name``'s weights, at the server's
    one-graph rung."""
    state, _, _ = load_for_inference(ck, name, "cpu")
    ss = server.shape_set
    n, e = ss.graph_counts(g)
    batch = ss.pack_full([g], shape=ss.shape_for(1, n, e))
    return make_predict_step()(state, batch)[0].numpy()


def test_server_reload_pin_gate_and_skip(trained, tmp_path):
    ck = _fresh_dir(trained, tmp_path)
    logs = []
    server, info = load_server(ck, batch_size=8, rungs=2,
                               calibration=trained.graphs, device="cpu",
                               poll_interval_s=3600.0, log_fn=logs.append)
    w = server.watcher
    g = trained.graphs[1]
    try:
        r0 = server.predict(g)
        assert r0.param_version == V0 and not r0.cached
        assert server.predict(g).cached
        np.testing.assert_array_equal(r0.prediction, _plain(ck, V0, server,
                                                            g))
        # a new version: staged, applied at the next flush boundary
        _commit(ck, scale=1.25, mean_shift=1.0, std_scale=1.5)
        assert w.poll_once() and _live(server, V1)
        r1 = server.predict(g)
        assert r1.param_version == V1 and not r1.cached
        np.testing.assert_array_equal(r1.prediction, _plain(ck, V1, server,
                                                            g))
        # an old-version row written after the swap is never served
        key = next(iter(server.cache._data))
        server.cache.put(key, (r0.prediction, V0))
        r1b = server.predict(g)
        assert not r1b.cached and r1b.param_version == V1
        # pinned back down
        w.set_pin(V0)
        assert w.poll_once() and _live(server, V0)
        np.testing.assert_array_equal(server.predict(g).prediction,
                                      r0.prediction)
        assert not w.poll_once()  # already there
        # the gate holds at what runs
        w.set_pin(None)
        w.set_gate(V0)
        assert not w.poll_once() and w.control()["gate_holds"] == 1
        # a corrupt newest save: skipped, never retried, V0 still served
        w.set_gate(None)
        _commit(ck, scale=0.5)
        faultinject.corrupt_checkpoint(os.path.join(ck, V2))
        assert not w.poll_once() and not w.poll_once()
        assert w.skips == 1 and w.skipped == [V2]
        assert server.version == V0
        assert any("SKIPPING ckpt-00000002" in str(m) for m in logs)
        st_ = server.stats()
        assert st_["counts"]["reloads"] == 2
        assert st_["reload"]["swaps"] == 2 and st_["reload"]["skips"] == 1
        assert st_["counts"]["captures_after_warm"] == 0
    finally:
        assert server.drain(timeout_s=30)


def test_reload_while_idle_and_never_started(trained, tmp_path):
    """A server whose worker is not running applies a staged reload under
    the dispatch lock itself; a started one wakes its idle worker."""
    ck = _fresh_dir(trained, tmp_path)
    server, info = load_server(ck, batch_size=8, rungs=2,
                               calibration=trained.graphs, device="cpu",
                               warm=False, poll_interval_s=3600.0,
                               log_fn=lambda *a: None)
    _commit(ck, scale=0.75)
    assert server.watcher.poll_once()
    assert server.version == V1  # applied at once: no worker runs
    server.warm(info["template"])
    server.start()
    _commit(ck, scale=0.5)
    assert server.watcher.poll_once()
    assert _live(server, V2)  # no flush needed
    assert server.predict(trained.graphs[0]).param_version == V2
    assert server.drain(timeout_s=30)
