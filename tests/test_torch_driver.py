"""The port's training drivers against the JAX ``fit`` on the CPU, from
the same weights (convert.py) and data:

- ``pack_once``, ``device_resident`` and ``scan_epochs`` (the epoch
  driver), each against the JAX ``fit`` in the same mode, SGD with
  momentum: every epoch's train loss, train MAE and val MAE within rel
  1e-5 (the JAX package's own tolerance between its drivers,
  tests/test_train.py);
- ``buckets=2`` under the driver: the same, since the schedule is shared;
- Adam under the driver against the port's per-step pack-once loop, the
  same three metrics within rel 1e-5. Against the JAX ``fit`` Adam is
  ill-conditioned: ``fc_full``'s bias feeds BatchNorm, so its true
  gradient is zero and what reaches it is rounding noise, which Adam's
  first step turns into +-lr by its sign; the running mean then carries
  that into every validation answer (val MAE 1-3% apart between JAX runs
  on one and on eight CPU devices);
- compact staging under the driver against full staging: per-epoch
  metrics within tests/test_torch_predict.py's TOL (the expander's
  ``exp`` against numpy's);
- SGD across a learning-rate milestone: bit-equal to the same loop with
  a host-scheduled ``torch.optim.SGD`` (the update the port had before
  its rate moved to the device), and within rel 1e-5 of the JAX ``fit``;
- the train entry point's flag rules (exit 2 where train.py exits 2),
  compact staging on by default under ``--device-resident``, and the
  order ``--resume`` needs: the restore (in place, addresses kept)
  before the driver captures its graphs.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgnn_tpu.data.dataset import FeaturizeConfig
from cgnn_tpu.train.loop import fit as jfit
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.state import TrainState as JTrainState
from cgnn_tpu.train.state import make_optimizer as jmake_optimizer
from cgnn_tpu_torch.data.compact import CompactSpec
from cgnn_tpu_torch.data.graph import CrystalGraph
from cgnn_tpu_torch.train import loop as tloop
from cgnn_tpu_torch.train import state as tstate
from cgnn_tpu_torch.train.__main__ import main as train_main
from cgnn_tpu_torch.train.checkpoint import CheckpointManager
from cgnn_tpu_torch.train.loop import fit
from cgnn_tpu_torch.train.normalizer import Normalizer
from test_torch_predict import TOL
from test_torch_train import (
    SMALL,
    JNet,
    M,
    _batches,
    _graphs,
    _jax_variables,
    _port_model,
)
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

REL = 1e-5  # per-epoch metrics, the JAX package's tolerance
EPOCHS = 3
KW = dict(batch_size=10, dense_m=M, seed=3, print_freq=0,
          log_fn=lambda *a: None)


def _port(g) -> CrystalGraph:
    return CrystalGraph(g.atom_fea, g.edge_fea, g.centers, g.neighbors,
                        g.target, cif_id=g.cif_id, distances=g.distances)


@pytest.fixture(scope="module")
def setup():
    train_g, val_g = _graphs(40, seed=8), _graphs(12, seed=9)
    jb, _ = _batches(train_g)
    variables = _jax_variables(JNet(**SMALL, dense_m=M), jb)
    return train_g, val_g, variables


def _jax_fit(setup, optim, opt, **kw):
    train_g, val_g, variables = setup
    jnet = JNet(**SMALL, dense_m=M)
    tx = jmake_optimizer(optim, **opt)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        normalizer=JNormalizer.fit(np.stack([g.target for g in train_g])),
        rng=jax.random.key(0), apply_fn=jnet.apply, tx=tx)
    _, res = jfit(jstate, train_g, val_g, epochs=EPOCHS, snug=True, **KW,
                  **kw)
    return res["history"]


def _fresh(setup, optim, opt):
    train_g, _, variables = setup
    net = _port_model({}, variables)
    return tstate.TrainState(
        net, tstate.make_optimizer(net.parameters(), optim, **opt),
        Normalizer.fit(np.stack([g.target for g in train_g]), device="cpu"))


def _port_fit(setup, state, **kw):
    train_g, val_g, _ = setup
    tg, tv = [_port(g) for g in train_g], [_port(g) for g in val_g]
    return fit(state, tg, tv, epochs=EPOCHS, device="cpu", **KW, **kw)


def _close(got, want, rel=REL):
    assert len(got) == len(want) == EPOCHS
    for t, j in zip(got, want):
        assert t["train"]["steps"] == j["train"]["steps"] >= 3
        for part, key in (("train", "loss"), ("train", "mae"),
                          ("val", "mae")):
            assert t[part][key] == pytest.approx(j[part][key], rel=rel), \
                (t["epoch"], part, key)


ADAM = dict(lr=0.01)
SGD = dict(lr=0.05, momentum=0.9)


@pytest.mark.parametrize("mode", [
    dict(pack_once=True), dict(device_resident=True),
    dict(scan_epochs=True), dict(scan_epochs=True, buckets=2)],
    ids=["pack_once", "device_resident", "scan_epochs", "buckets2_scan"])
def test_fit_matches_the_jax_fit(setup, mode):
    want = _jax_fit(setup, "sgd", SGD, **mode)
    state, got = _port_fit(setup, _fresh(setup, "sgd", SGD), **mode)
    _close(got["history"], want)
    assert state.optimizer.count == sum(h["train"]["steps"]
                                        for h in got["history"])
    if mode.get("scan_epochs"):
        st = got["staging"]
        assert st["staged_bytes"] > 0 and not st["compact"]
        assert got["graphs"]["captures_after_warm"] == 0


@pytest.mark.parametrize("buckets", [1, 2])
def test_adam_driver_matches_the_per_step_loop(setup, buckets):
    """One bucket: the driver's steps are the pack-once loop's, batch
    for batch, so every metric agrees. Two: the driver walks the same
    batches in its own chunked order, each structure once an epoch."""
    _, drv = _port_fit(setup, _fresh(setup, "adam", ADAM), scan_epochs=True,
                       buckets=buckets)
    _, loop = _port_fit(setup, _fresh(setup, "adam", ADAM), pack_once=True,
                        buckets=buckets)
    if buckets == 1:
        _close(drv["history"], loop["history"])
    for d, p in zip(drv["history"], loop["history"]):
        assert d["train"]["count"] == p["train"]["count"] == 40.0
        assert d["val"]["count"] == p["val"]["count"] == 12.0


def test_compact_staging_under_the_driver_matches_full(setup):
    train_g, val_g, _ = setup
    spec = CompactSpec.build([_port(g) for g in train_g + val_g],
                             FeaturizeConfig(radius=5.0,
                                             max_num_nbr=M).gdf(),
                             dense_m=M)
    _, full = _port_fit(setup, _fresh(setup, "sgd", SGD), scan_epochs=True)
    _, comp = _port_fit(setup, _fresh(setup, "sgd", SGD), scan_epochs=True,
                        compact=spec)
    assert comp["staging"]["compact"]
    assert comp["staging"]["staged_bytes"] * 4 < \
        full["staging"]["staged_bytes"]
    for c, f in zip(comp["history"], full["history"]):
        for part, key in (("train", "loss"), ("train", "mae"),
                          ("val", "mae")):
            assert c[part][key] == pytest.approx(f[part][key], rel=TOL[
                "rtol"], abs=TOL["atol"]), (c["epoch"], part, key)


def test_fit_rules(setup):
    state = _fresh(setup, "adam", ADAM)
    spec = object()
    with pytest.raises(ValueError, match="requires scan_epochs"):
        _port_fit(setup, state, pack_once=True, compact=spec)
    with pytest.raises(ValueError, match="dense layout"):
        train_g, val_g, _ = setup
        fit(state, [_port(g) for g in train_g], [_port(g) for g in val_g],
            epochs=1, device="cpu", scan_epochs=True, compact=spec,
            **dict(KW, dense_m=None))


class HostScheduleSGD:
    """SGD as the port stepped it before its rate moved to the device:
    ``torch.optim.SGD`` with the rate set from a host count each step."""

    def __init__(self, params, schedule, momentum):
        self.params = list(params)
        self.schedule = schedule
        self.inner = torch.optim.SGD(self.params, lr=schedule(0),
                                     momentum=momentum)
        self.count = 0

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def step(self):
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(self.count)
        self.inner.step()
        self.count += 1


def test_sgd_across_a_milestone(setup):
    opt = dict(lr=0.05, momentum=0.9, lr_milestones=[4])
    state, got = _port_fit(setup, _fresh(setup, "sgd", opt),
                           device_resident=True)
    ref = _fresh(setup, "sgd", opt)
    ref.optimizer = HostScheduleSGD(ref.model.parameters(),
                                    ref.optimizer.schedule, 0.9)
    ref, want = _port_fit(setup, ref, device_resident=True)
    assert state.optimizer.count == ref.optimizer.count > 4
    for a, b in zip(state.model.state_dict().values(),
                    ref.model.state_dict().values()):
        assert torch.equal(a, b)
    assert [h["train"] for h in got["history"]] == \
        [h["train"] for h in want["history"]]
    _close(got["history"], _jax_fit(setup, "sgd", opt, device_resident=True))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def _argv(tmp_path, *extra):
    return ["--synthetic", "32", "--device", "cpu", "--epochs", "1", "-b",
            "8", "--radius", "5", "--n-conv", "2", "--atom-fea-len", "16",
            "--print-freq", "0", "--ckpt-dir", str(tmp_path / "ck"),
            "--out-dir", str(tmp_path / "out"), *extra]


@pytest.mark.parametrize("flags,message", [
    (["--scan-epochs", "--no-scan-epochs"], "contradictory"),
    (["--device-resident", "--no-scan-epochs", "--compact-staging", "on"],
     "--compact-staging on requires"),
    (["--scan-epochs", "--aggregation", "pallas", "--compact-staging", "on"],
     "--compact-staging on requires"),
    (["--compact-staging", "on"], "--compact-staging on requires"),
], ids=["scan_and_no_scan", "on_without_driver", "on_with_coo",
        "on_per_step"])
def test_entry_point_refusals(tmp_path, capsys, flags, message):
    assert train_main(_argv(tmp_path, *flags)) == 2
    assert message in capsys.readouterr().err


def test_device_resident_runs_the_driver_with_compact_staging(tmp_path,
                                                              capsys):
    assert train_main(_argv(tmp_path, "--device-resident", "--buckets",
                            "2")) == 0
    out = capsys.readouterr().out
    assert "compact staging: on" in out
    summary = json.loads(next(line for line in out.splitlines()
                              if line.startswith("train: "))[7:])
    assert summary["staging"]["compact"] is True
    assert summary["staging"]["staged_bytes"] > 0
    assert summary["graphs"]["captures_after_warm"] == 0
    assert (tmp_path / "out" / "params.npz").exists()
    assert train_main(_argv(tmp_path, "--device-resident",
                            "--compact-staging", "off")) == 0
    assert "compact staging: on" not in capsys.readouterr().out


def test_resume_restores_in_place_before_the_driver_captures(
        tmp_path, monkeypatch):
    """``--resume`` restores the checkpoint into the state's own tensors
    (the addresses a captured graph holds) and only then warms the
    driver, which captures its graphs."""
    assert train_main(_argv(tmp_path, "--device-resident")) == 0
    events = []
    restore, warm = CheckpointManager.restore, tloop.ScanEpochDriver.warm

    def traced_restore(self, state, *a, **k):
        before = [t.data_ptr() for t in list(state.model.parameters())
                  + state.optimizer.tensors()]
        out = restore(self, state, *a, **k)
        after = [t.data_ptr() for t in list(state.model.parameters())
                 + state.optimizer.tensors()]
        assert after == before, "the restore rebound a tensor"
        events.append("restore")
        return out

    def traced_warm(self, state):
        events.append("warm")
        return warm(self, state)

    monkeypatch.setattr(CheckpointManager, "restore", traced_restore)
    monkeypatch.setattr(tloop.ScanEpochDriver, "warm", traced_warm)
    assert train_main(_argv(tmp_path, "--device-resident", "--resume",
                            "auto", "--epochs", "2")) == 0
    assert events == ["restore", "warm"]
