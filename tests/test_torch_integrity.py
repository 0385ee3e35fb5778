"""The port's checkpoint integrity manifests against the JAX package's
(``cgnn_tpu/resilience/integrity.py``), on the same numpy trees: the same
``MANIFEST.json`` (format 1: each leaf's ``/``-joined path, shape, numpy
dtype name and crc32 of its C-contiguous bytes), the same under
``params/`` and ``batch_stats/`` for a model's weights saved by either
side, and the same verdict of ``verify_tree`` on each kind of fault.
Exact: manifests are integers and strings."""

import json

import jax
import numpy as np
import pytest

from cgnn_tpu.resilience import integrity as jint
from cgnn_tpu.train.checkpoint import _state_pytree
from cgnn_tpu_torch.resilience import integrity as tint


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "step": np.asarray(7, np.int64),
        "params": {
            "conv_0": {"fc_full": {
                "kernel": rng.standard_normal((5, 4)).astype(np.float32),
                "bias": rng.standard_normal(4).astype(np.float32)}},
            "embedding": {"kernel": rng.standard_normal((3, 2))},
        },
        "normalizer": {"mean": np.zeros(1, np.float32),
                       "std": np.ones(1, np.float32)},
        "opt_state": {"count": np.asarray(3, np.int32),
                      "b": {"momentum_buffer": np.arange(6.0).reshape(2, 3)
                            .T}},  # a strided leaf: crc of C order
    }


def test_manifest_equals_jax_and_round_trips(tmp_path):
    tree = _tree()
    got = tint.tree_manifest(tree)
    assert got == jint.tree_manifest(tree)
    assert list(got["leaves"]) == list(jint.tree_manifest(tree)["leaves"])
    tint.write_manifest(str(tmp_path), got)
    assert tint.read_manifest(str(tmp_path)) == got
    assert jint.read_manifest(str(tmp_path)) == got
    (tmp_path / tint.MANIFEST_NAME).write_text("{not json")
    assert tint.read_manifest(str(tmp_path)) is None
    (tmp_path / tint.MANIFEST_NAME).write_text(json.dumps({"format": 1}))
    assert tint.read_manifest(str(tmp_path)) is None
    assert tint.read_manifest(str(tmp_path / "absent")) is None
    with pytest.raises(ValueError):  # a NaN is never committed
        tint.write_manifest(str(tmp_path), {"leaves": {}, "x": float("nan")})


def test_model_weights_manifest_equals_jax_checkpoint():
    """A JAX TrainState and the port's TrainState on the same weights:
    their checkpoint trees' manifests agree under params/ and
    batch_stats/ (paths, shapes, dtypes, crcs)."""
    from test_torch_checkpoint import jax_and_port_states

    jstate, state = jax_and_port_states()
    from cgnn_tpu_torch.train.checkpoint import state_tree

    want = jint.tree_manifest(jax.device_get(_state_pytree(jstate)))
    got = tint.tree_manifest(state_tree(state))
    for prefix in ("params/", "batch_stats/"):
        w = {k: v for k, v in want["leaves"].items() if k.startswith(prefix)}
        g = {k: v for k, v in got["leaves"].items() if k.startswith(prefix)}
        assert w and g == w, prefix
    assert got["leaves"]["normalizer/mean"] == want["leaves"]["normalizer/mean"]


FAULTS = {
    "missing_leaf": lambda t: t["params"].pop("embedding"),
    "extra_leaf": lambda t: t["normalizer"].update(extra=np.zeros(1)),
    "shape": lambda t: t["params"]["conv_0"]["fc_full"].update(
        bias=np.zeros(5, np.float32)),
    "dtype": lambda t: t["params"]["conv_0"]["fc_full"].update(
        bias=t["params"]["conv_0"]["fc_full"]["bias"].astype(np.float64)),
    "crc": lambda t: t["params"]["conv_0"]["fc_full"]["kernel"].__setitem__(
        (1, 2), np.float32(0.5)),
}


@pytest.mark.parametrize("fault", ["none"] + sorted(FAULTS))
def test_verify_tree_catches_each_fault(fault):
    manifest = tint.tree_manifest(_tree())
    tree = _tree()
    if fault != "none":
        FAULTS[fault](tree)
    outcomes = []
    for mod in (tint, jint):
        try:
            mod.verify_tree(tree, manifest)
            outcomes.append("ok")
        except mod.IntegrityError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]  # the same verdict and message
    assert (outcomes[0] == "ok") == (fault == "none")
    want = {"missing_leaf": "leaf set", "extra_leaf": "leaf set",
            "shape": "shape", "dtype": "dtype", "crc": "crc32"}
    if fault != "none":
        assert want[fault] in outcomes[0]
