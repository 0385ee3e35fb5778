"""The port's meters and metrics (``cgnn_tpu_torch/train/metrics.py``)
against the JAX package's (``cgnn_tpu/train/metrics.py``) on seeded
inputs: the device-side sums (accumulated, fetched in one copy, averaged)
within 1e-6 relative (the JAX side fetches them as f32, the port as f64),
and the host meters and metrics exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgnn_tpu.train import metrics as jm
from cgnn_tpu_torch.train import metrics as tm


def _step_sums(rng, t=2):
    out = {"loss_sum": rng.uniform(0, 5), "mae_sum": rng.uniform(0, 3),
           "count": float(rng.integers(1, 9))}
    for k in range(t):
        out[f"mae_task{k}_sum"] = rng.uniform(0, 2)
        out[f"mae_task{k}_count"] = float(rng.integers(0, 5))
    return {k: np.float32(v) for k, v in out.items()}


def test_device_sums_and_means_match_jax():
    rng = np.random.default_rng(0)
    steps = [_step_sums(rng) for _ in range(7)]
    steps[3]["extra_sum"] = np.float32(1.5)  # a key appearing mid-epoch
    js = ts = None
    for s in steps:
        js = jm.accumulate_on_device(js, {k: jnp.asarray(v)
                                          for k, v in s.items()})
        ts = tm.accumulate_on_device(ts, {k: torch.tensor(v)
                                          for k, v in s.items()})
    jh, th = jm.fetch_device_sums(js), tm.fetch_device_sums(ts)
    assert list(th) == list(jh)  # sorted keys, one copy each
    for k in jh:
        assert th[k] == pytest.approx(jh[k], rel=1e-6), k
    jmeans = jm.means_from_sums(jh, len(steps))
    tmeans = tm.means_from_sums(th, len(steps))
    assert sorted(tmeans) == sorted(jmeans)
    for k in jmeans:
        assert tmeans[k] == pytest.approx(jmeans[k], rel=1e-6), k
    assert tm.fetch_device_sums(None) == {} == jm.fetch_device_sums(None)
    # the first call copies: later in-place adds leave the step's tensors
    first = {"count": torch.tensor(1.0)}
    sums = tm.accumulate_on_device(None, first)
    tm.accumulate_on_device(sums, {"count": torch.tensor(2.0)})
    assert float(first["count"]) == 1.0 and float(sums["count"]) == 3.0


def test_meter_and_mae_match_jax():
    rng = np.random.default_rng(1)
    a, b = jm.AverageMeter("loss"), tm.AverageMeter("loss")
    for val, n in zip(rng.normal(size=9), rng.integers(1, 5, 9)):
        a.update(val, n)
        b.update(val, n)
        assert (b.val, b.sum, b.count, b.avg) == (a.val, a.sum, a.count,
                                                  a.avg)
    b.reset()
    assert (b.val, b.sum, b.count, b.avg) == (0.0, 0.0, 0.0, 0.0)
    pred, target = rng.normal(size=(20, 2)), rng.normal(size=(20, 2))
    assert tm.mae(pred, target) == jm.mae(pred, target)


@pytest.mark.parametrize("case", ["ties", "random", "one_class"])
def test_binary_auc_matches_jax(case):
    rng = np.random.default_rng(2)
    if case == "ties":
        scores = rng.integers(0, 4, 40).astype(float)
        labels = rng.integers(0, 2, 40)
    elif case == "random":
        scores, labels = rng.random(50), rng.integers(0, 2, 50)
    else:
        scores, labels = rng.random(10), np.ones(10, int)
    got, want = tm._binary_auc(scores, labels), jm._binary_auc(scores,
                                                              labels)
    assert got == want or (np.isnan(got) and np.isnan(want))


@pytest.mark.parametrize("classes", [2, 3])
def test_class_eval_matches_jax(classes):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(60, classes))
    log_probs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = rng.integers(0, classes, 60)
    got, want = tm.class_eval(log_probs, labels), jm.class_eval(log_probs,
                                                                labels)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    # a degenerate split: no positive prediction -> NaN precision, as JAX
    if classes == 2:
        lp = np.log(np.tile([0.9, 0.1], (6, 1)))
        g, w = tm.class_eval(lp, np.array([0, 1] * 3)), jm.class_eval(
            lp, np.array([0, 1] * 3))
        assert np.isnan(g["precision"]) and np.isnan(w["precision"])
        assert np.isnan(g["f1"]) and np.isnan(w["f1"])
