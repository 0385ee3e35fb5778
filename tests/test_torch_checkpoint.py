"""The port's checkpoint protocol (``cgnn_tpu_torch/train/checkpoint.py``),
held to the JAX package's (``cgnn_tpu/train/checkpoint.py``) on the CPU,
one case per protocol property:

- an uncommitted ``.tmp-*`` directory is never offered for restore and
  is swept by the first save only, never by a reader;
- a ``ckpt-*`` directory without a manifest is ignored;
- a flipped byte in the newest ``state.npz`` fails its crc (the zip's,
  before the manifest's; a value rewritten into a well-formed file fails
  the manifest's), the restore falls back to the older save and the
  report names the skipped one;
- retention with ``keep=2`` keeps the two newest saves and the best one;
- the tags ``previous`` and an explicit ``ckpt-%08d`` (no fallback);
- an empty meta is refused; an exhausted chain raises
  ``CheckpointRestoreError``;
- a JAX save found in a port directory (no ``state.npz``) is skipped and
  reported;
- saves are snapshots: weights mutated in place after ``save`` and before
  ``wait`` restore as they were at save time;
- the optimizer's state (SGD momentum, Adam, AdamW), its ``count`` and so
  its lr past a milestone round-trip bit-equal, and the next step after
  a restore is bit-equal to the next step without one.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgnn_tpu.train import checkpoint as jckpt
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.state import TrainState as JTrainState
from cgnn_tpu.train.state import make_optimizer as jmake_optimizer
from cgnn_tpu_torch.resilience.integrity import MANIFEST_NAME, tree_manifest
from cgnn_tpu_torch.train import state as tstate
from cgnn_tpu_torch.train.checkpoint import (
    STATE_FILE,
    CheckpointManager,
    CheckpointRestoreError,
    state_tree,
)
from cgnn_tpu_torch.train.normalizer import Normalizer
from cgnn_tpu_torch.train.step import make_train_step
from test_torch_train import (
    SMALL,
    JNet,
    M,
    _batches,
    _graphs,
    _jax_variables,
    _port_model,
    _trajectory_batches,
)
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse


def jax_and_port_states(optim="sgd", **opt_kw):
    """A JAX TrainState and a port TrainState on the same weights,
    optimizer and normalizer (SMALL widths, M=8)."""
    graphs = _graphs()
    jb, _ = _batches(graphs)
    jnet = JNet(**SMALL, dense_m=M)
    variables = _jax_variables(jnet, jb)
    targets = np.stack([g.target for g in graphs])
    kw = dict(lr=0.05, lr_milestones=[2]) | opt_kw
    tx = jmake_optimizer(optim, **kw)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        normalizer=JNormalizer.fit(targets), rng=jax.random.key(0),
        apply_fn=jnet.apply, tx=tx)
    net = _port_model({}, variables)
    state = tstate.TrainState(
        net, tstate.make_optimizer(net.parameters(), optim, **kw),
        Normalizer.fit(targets, device="cpu"))
    return jstate, state


def _fresh(optim="sgd", **opt_kw):
    return jax_and_port_states(optim, **opt_kw)[1]


def _steps(state, k=2):
    _, batches, _ = _trajectory_batches()
    step = make_train_step()
    for b in (batches * 2)[:k]:
        step(state, b)
    return state


def _weights(state):
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def _equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _saves(d):
    return sorted(n for n in os.listdir(d) if n.startswith("ckpt-"))


def _two_saves(d):
    """Two committed saves of a state two steps apart -> (manager,
    weights of the first, weights of the second)."""
    mgr = CheckpointManager(d, log_fn=lambda *a: None)
    state = _steps(_fresh(), 1)
    mgr.save(state, {"epoch": 0}, is_best=True)
    first = _weights(state)
    _steps(state, 1)
    mgr.save(state, {"epoch": 1})
    mgr.wait()
    return mgr, first, _weights(state)


def _restored(mgr, tag="latest"):
    state, meta = mgr.restore(_fresh(), tag)
    return _weights(state), meta


def _flip_byte(path, array_bytes):
    """Flip one byte inside a stored array's data (np.savez stores
    uncompressed, so its bytes appear verbatim in the file)."""
    raw = bytearray(open(path, "rb").read())
    at = raw.find(array_bytes)
    assert at > 0
    raw[at + len(array_bytes) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))


def tmp_ignored_swept_by_first_save(d):
    stale = os.path.join(d, ".tmp-ckpt-00000007")
    os.makedirs(stale)
    open(os.path.join(stale, "state.npz"), "wb").write(b"partial")
    reader = CheckpointManager(d, log_fn=lambda *a: None)
    assert not reader.exists() and reader.newest_committed() is None
    with pytest.raises(CheckpointRestoreError):
        reader.restore(_fresh())
    assert os.path.isdir(stale)  # a reader never sweeps
    reader.save(_fresh(), {"epoch": 0})
    reader.wait()
    assert not os.path.exists(stale) and _saves(d) == ["ckpt-00000000"]
    open(os.path.join(d, ".tmp-ckpt-00000009"), "w").close()
    reader.save(_fresh(), {"epoch": 1})  # the second save sweeps nothing
    reader.wait()
    assert os.path.exists(os.path.join(d, ".tmp-ckpt-00000009"))
    # the JAX manager reads the directory the same way
    assert jckpt.CheckpointManager(d).newest_committed() == "ckpt-00000001"


def no_manifest_ignored(d):
    mgr, _, second = _two_saves(d)
    os.makedirs(os.path.join(d, "ckpt-00000005"))
    assert mgr.newest_committed() == "ckpt-00000001"
    assert not mgr.is_committed("ckpt-00000005")
    assert mgr.is_committed("ckpt-00000001")
    got, meta = _restored(mgr)
    assert _equal(got, second) and meta == {"epoch": 1}
    assert mgr.last_restore_report == []


def flipped_byte_falls_back(d):
    mgr, first, second = _two_saves(d)
    path = os.path.join(d, "ckpt-00000001", STATE_FILE)
    with np.load(path) as z:
        kernel = z["params/conv_0/fc_full/kernel"]
    _flip_byte(path, np.ascontiguousarray(kernel).tobytes())
    got, meta = _restored(mgr)
    assert _equal(got, first) and meta == {"epoch": 0}
    assert mgr.last_restored == "ckpt-00000000"
    assert len(mgr.last_restore_report) == 1
    assert mgr.last_restore_report[0].startswith("ckpt-00000001: ")
    assert "CRC-32" in mgr.last_restore_report[0]
    # a well-formed file whose value changed: the manifest's crc32
    with np.load(os.path.join(d, "ckpt-00000000", STATE_FILE)) as z:
        flat = {k: z[k] for k in z.files}
    flat["params/conv_0/fc_full/bias"][0] += 1.0
    np.savez(os.path.join(d, "ckpt-00000000", STATE_FILE), **flat)
    with pytest.raises(CheckpointRestoreError):
        _restored(mgr)
    assert "IntegrityError" in mgr.last_restore_report[1]
    assert "params/conv_0/fc_full/bias: crc32" in mgr.last_restore_report[1]


def retention_keeps_best(d):
    mgr = CheckpointManager(d, keep=2, log_fn=lambda *a: None)
    state = _fresh()
    for epoch in range(4):
        _steps(state, 1)
        mgr.save(state, {"epoch": epoch}, is_best=epoch == 0)
    mgr.wait()
    assert _saves(d) == ["ckpt-00000000", "ckpt-00000002", "ckpt-00000003"]
    assert json.load(open(os.path.join(d, "best.json")))["save"] \
        == "ckpt-00000000"
    _, meta = _restored(mgr, "best")
    assert meta == {"epoch": 0}
    # the JAX manager follows the same pointer
    assert jckpt.CheckpointManager(d)._best_target() == "ckpt-00000000"


def previous_and_explicit_tags(d):
    mgr, first, second = _two_saves(d)
    assert _equal(_restored(mgr, "previous")[0], first)
    assert _equal(_restored(mgr, "ckpt-00000000")[0], first)
    assert _equal(_restored(mgr, "ckpt-00000001")[0], second)
    assert mgr.read_meta("previous") == {"epoch": 0}
    assert not mgr.exists("ckpt-00000004")
    # an explicit save has no fallback
    open(os.path.join(d, "ckpt-00000001", STATE_FILE), "wb").write(b"x")
    with pytest.raises(CheckpointRestoreError):
        mgr.restore(_fresh(), "ckpt-00000001")
    assert len(mgr.last_restore_report) == 1


def empty_meta_refused(d):
    mgr, first, _ = _two_saves(d)
    with open(os.path.join(d, "ckpt-00000001", "meta.json"), "w") as f:
        json.dump({}, f)
    got, meta = _restored(mgr)
    assert _equal(got, first) and meta == {"epoch": 0}
    assert "meta empty" in mgr.last_restore_report[0]


def exhausted_chain_raises(d):
    mgr, _, _ = _two_saves(d)
    for name in _saves(d):
        open(os.path.join(d, name, STATE_FILE), "wb").write(b"torn")
    with pytest.raises(CheckpointRestoreError) as e:
        mgr.restore(_fresh())
    assert len(e.value.attempts) == 2
    assert mgr.read_meta() == {"epoch": 1}  # meta is still readable


def jax_save_skipped(d):
    mgr, first, _ = _two_saves(d)
    jdir = os.path.join(d, "ckpt-00000002")  # the JAX layout: state/
    os.makedirs(os.path.join(jdir, "state"))
    json.dump({"epoch": 2}, open(os.path.join(jdir, "meta.json"), "w"))
    json.dump(tree_manifest({"step": np.zeros((), np.int32)}),
              open(os.path.join(jdir, MANIFEST_NAME), "w"))
    mgr = CheckpointManager(d, log_fn=lambda *a: None)
    got, meta = _restored(mgr)
    assert meta == {"epoch": 1}
    assert mgr.last_restore_report[0].startswith("ckpt-00000002: ")


def save_is_a_snapshot(d):
    mgr = CheckpointManager(d, log_fn=lambda *a: None)
    state = _steps(_fresh(), 1)
    before = _weights(state)
    mgr.save(state, {"epoch": 0})
    with torch.no_grad():  # in place, before the finalizer has written
        for p in state.model.parameters():
            p.add_(1.0)
        for b in state.model.buffers():
            b.mul_(3.0)
    mgr.wait()
    got, _ = _restored(mgr)
    assert _equal(got, before) and not _equal(got, _weights(state))


PROPERTIES = {f.__name__: f for f in (
    tmp_ignored_swept_by_first_save, no_manifest_ignored,
    flipped_byte_falls_back, retention_keeps_best,
    previous_and_explicit_tags, empty_meta_refused, exhausted_chain_raises,
    jax_save_skipped, save_is_a_snapshot)}


@pytest.mark.parametrize("prop", sorted(PROPERTIES))
def test_checkpoint_protocol(prop, tmp_path):
    PROPERTIES[prop](str(tmp_path / "ckpt"))


@pytest.mark.parametrize("optim", ["sgd", "adam", "adamw"])
def test_optimizer_state_round_trips(optim, tmp_path):
    kw = {"weight_decay": 0.01} if optim == "adamw" else {}
    state = _steps(_fresh(optim, lr_milestones=[2], **kw), 3)
    assert state.optimizer.count == 3
    mgr = CheckpointManager(str(tmp_path), log_fn=lambda *a: None)
    mgr.save(state, {"epoch": 0})
    restored, _ = mgr.restore(_fresh(optim, lr_milestones=[2], **kw))
    assert restored.optimizer.count == 3
    assert restored.optimizer.schedule(restored.optimizer.count) \
        == pytest.approx(0.005)  # past the milestone at step 2
    assert _equal(_weights(restored), _weights(state))
    for (n, p), (_, q) in zip(state.model.named_parameters(),
                              restored.model.named_parameters()):
        a, b = state.optimizer.inner.state[p], restored.optimizer.inner.state[q]
        assert sorted(a) == sorted(b), n
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), \
                (n, k)
    for s in (state, restored):  # the next step: bit-equal
        _steps(s, 1)
    assert _equal(_weights(restored), _weights(state))
    # an inference-only checkpoint (no optimizer state) cannot resume
    tree = state_tree(state)
    del tree["opt_state"]
    mgr.save_tree(tree, {"epoch": 1})
    mgr.wait()
    with pytest.raises(CheckpointRestoreError, match="no optimizer state"):
        mgr.restore(_fresh(optim, **kw), "ckpt-00000001")
    inf = mgr.restore_for_inference(_fresh(optim, **kw), "ckpt-00000001")
    assert _equal(_weights(inf), _weights(state))
    mgr.close()
