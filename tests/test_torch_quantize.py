"""Serving precision tiers (``cgnn_tpu_torch/serve/quantize.py``) against
the JAX package's (``cgnn_tpu/serve/quantize.py``), on the CPU:

- ``quantize_kernel``: q bit-equal to the JAX q and the scales equal, on a
  ragged matrix and on an all-zero one; the dequantized weight (q * scale
  in f32) bit-equal too;
- ``quantize_params`` on weights trained by the JAX package and carried
  over: the same weights are targeted (2-D kernels with more than 8
  output columns outside ``embedding`` and ``fc_out``), each q the JAX q
  (transposed for an ``nn.Linear`` weight) bit for bit;
- the tiers' predictions on one ladder rung: each within BF16_TOL (2e-2
  of the largest |answer|) of the JAX tier on the same weights and
  batch, the MAE ratio to f32 at most 1.005 for bf16 and int8, and each
  tier differing from f32 (and int8 from bf16);
- the bf16 and int8 tiers keep no second copy of the f32 weights;
- the server: an unknown tier refused at admission, the batcher cutting a
  flush at a tier boundary, the cache keeping tiers apart, and a hot swap
  rebuilding every tier (the int8 tier re-quantized) with the answers of
  the new weights;
- the entry point: ``--precision f32,bf16,int8 --device cpu`` boots and
  answers each tier's ``precision`` field over HTTP.
"""

import signal
import types

import jax
import numpy as np
import pytest
import torch

from cgnn_tpu.config import DataConfig as JDataConfig
from cgnn_tpu.config import ModelConfig as JModelConfig
from cgnn_tpu.config import build_model as jbuild_model
from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu.serve import quantize as jq
from cgnn_tpu.serve.shapes import plan_shape_set as jplan_shape_set
from cgnn_tpu.train import Normalizer as JNormalizer
from cgnn_tpu.train import create_train_state, make_optimizer
from cgnn_tpu.train.step import make_predict_step as jmake_predict_step
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
from cgnn_tpu_torch.serve import quantize as tq
from cgnn_tpu_torch.serve.batcher import MicroBatcher, Request, ServeRejection
from cgnn_tpu_torch.serve.server import InferenceServer
from cgnn_tpu_torch.serve.shapes import plan_shape_set
from cgnn_tpu_torch.train.checkpoint import CheckpointManager
from cgnn_tpu_torch.train.normalizer import Normalizer
from cgnn_tpu_torch.train.step import InferenceState, make_predict_step
from test_torch_rawwire import _port_graph
from test_torch_reload import _commit
from test_torch_serve_entry import (
    STRUCTURE,
    _free_port,
    _post,
    _start,
    _statuses_until_ready,
    _wait,
)
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

CFG = FeaturizeConfig(radius=5.0, max_num_nbr=8)
SMALL = dict(atom_fea_len=16, n_conv=2, h_fea_len=24)
BF16_TOL = 2e-2  # of the largest |answer|: bf16's 8-bit mantissa, summed
MAE_GATE = 1.005  # the JAX package's drift gate (scripts/quant_parity.py)


@pytest.fixture(scope="module")
def trained():
    """A model briefly trained by the JAX package (quantization error on
    random weights says nothing about the served operating point), and
    the same weights and normalizer in the port."""
    from cgnn_tpu.data.graph import batch_iterator, capacities_for
    from cgnn_tpu.train.loop import fit

    graphs = load_synthetic(96, CFG, seed=3, max_atoms=8)
    model = jbuild_model(JModelConfig(**SMALL),
                         JDataConfig(radius=5.0, max_num_nbr=8))
    train_g = graphs[:64]
    nc, ec = capacities_for(train_g, 16)
    state = create_train_state(
        model, next(batch_iterator(train_g, 16, nc, ec)),
        make_optimizer(optim="adam", lr=0.01),
        JNormalizer.fit(np.stack([g.target for g in train_g])),
        rng=jax.random.key(0))
    state, _ = fit(state, train_g, graphs[64:80], epochs=4, batch_size=16,
                   node_cap=nc, edge_cap=ec, seed=0, print_freq=0,
                   log_fn=lambda *a, **k: None)
    variables = jax.tree_util.tree_map(
        np.array, {"params": state.params,
                   "batch_stats": state.batch_stats})
    net = build_model(ModelConfig(**SMALL),
                      DataConfig(radius=5.0, max_num_nbr=8), device="cpu")
    net.load_state_dict(convert.from_flax_variables(variables))
    tstate = InferenceState(net.eval(), Normalizer.from_arrays(
        np.asarray(state.normalizer.mean), np.asarray(state.normalizer.std),
        device="cpu"))
    return types.SimpleNamespace(graphs=graphs, model=model, state=state,
                                 tstate=tstate,
                                 port=[_port_graph(g) for g in graphs])


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, zero", [((70, 48), False), ((8, 4), True),
                                         ((33, 9), False)])
def test_quantize_kernel_bit_equal(shape, zero):
    rng = np.random.default_rng(0)
    w = (np.zeros(shape, np.float32) if zero
         else rng.normal(0, 0.2, size=shape).astype(np.float32))
    if not zero:
        w[:, 1] = 0.0  # an all-zero column: scale 1, q 0
    want = jq.quantize_kernel(w)
    got = tq.quantize_kernel(w)
    assert got.q.dtype == torch.int8 and got.in_dim == want.in_dim
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    jdeq = np.asarray(jq.dequantize_params({"x": {"kernel": want}})["x"]
                      ["kernel"])
    tdeq = tq.dequantize_kernel(got.q, got.scale, got.in_dim, False).numpy()
    np.testing.assert_array_equal(tdeq, jdeq)
    assert tdeq.shape == w.shape
    if zero:
        np.testing.assert_array_equal(tdeq, w)
    # an nn.Linear weight [out, in] quantizes its transpose
    lin = tq.quantize_params({"fc.weight": torch.from_numpy(w.T.copy())})
    if shape[1] > 8:
        np.testing.assert_array_equal(lin["fc.weight"].q.numpy(),
                                      np.asarray(want.q))
        np.testing.assert_array_equal(
            tq.dequantize_params(lin)["fc.weight"].numpy(), jdeq.T)
    else:
        assert isinstance(lin["fc.weight"], torch.Tensor)


def test_quantize_params_targets_the_jax_weights(trained):
    jparams = jq.quantize_params(trained.state.params)
    jleaves = jax.tree_util.tree_leaves_with_path(
        jparams, is_leaf=lambda x: isinstance(x, jq.QuantizedKernel))
    jnames = {"/".join(k.key for k in p): v for p, v in jleaves
              if isinstance(v, jq.QuantizedKernel)}
    params = dict(trained.tstate.model.named_parameters())
    got = {k: v for k, v in tq.quantize_params(params).items()
           if isinstance(v, tq.QuantizedKernel)}
    # port names -> the JAX paths (an nn.Linear weight is a flax kernel)
    as_jax = {k.rsplit(".", 1)[0].replace(".", "/") + "/kernel": v
              for k, v in got.items()}
    assert sorted(as_jax) == sorted(jnames) and len(got) > 0
    assert any("fc_full" in k for k in got)
    assert not any("embedding" in k or "fc_out" in k for k in got)
    for name, qk in as_jax.items():
        np.testing.assert_array_equal(qk.q.numpy(),
                                      np.asarray(jnames[name].q))
        np.testing.assert_array_equal(qk.scale.numpy(),
                                      np.asarray(jnames[name].scale))
        assert qk.linear == ("fc_full" not in name)
    # every other parameter passes through as the same tensor
    for k, v in tq.quantize_params(params).items():
        if not isinstance(v, tq.QuantizedKernel):
            assert v is params[k]


def test_unknown_tier_rejected():
    with pytest.raises(ValueError, match="unknown precision"):
        tq.build_tier_specs(("f32", "fp4"))
    with pytest.raises(ValueError, match="unknown precision"):
        tq.parse_precisions("bf16,fp4")
    assert tq.parse_precisions("int8, bf16") == ("f32", "int8", "bf16")


# ---------------------------------------------------------------------------
# the tiers' programs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tier_preds(trained):
    """Every tier's predictions on one rung, in both packages, with the
    targets (eval graphs 80..96)."""
    eval_j = trained.graphs[80:]
    eval_t = trained.port[80:]
    jladder = jplan_shape_set(trained.graphs, 16, rungs=1)
    tladder = plan_shape_set(trained.port, 16, rungs=1)
    jspecs = jq.build_tier_specs(trained.model, jq.TIERS)
    tspecs = tq.build_tier_specs(tq.TIERS)
    jstep = jax.jit(jmake_predict_step())
    tstep = make_predict_step()
    jbatch = jladder.pack(eval_j)
    tbatch = tladder.pack(eval_t)
    out = {"targets": np.stack([np.atleast_1d(g.target) for g in eval_j])}
    for tier in tq.TIERS:
        st = jspecs[tier].state_for(trained.state)
        out[f"jax_{tier}"] = np.array(jax.device_get(
            jstep(st, jbatch)))[:len(eval_j)]
        out[tier] = tstep(tspecs[tier].state_for(trained.tstate),
                          tbatch)[:len(eval_t)].numpy()
    return out


@pytest.mark.parametrize("tier", tq.TIERS)
def test_tier_matches_jax_tier(tier_preds, tier):
    got, want = tier_preds[tier], tier_preds[f"jax_{tier}"]
    tol = 1e-4 if tier == "f32" else BF16_TOL
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (tier, err)


@pytest.mark.parametrize("tier", ("bf16", "int8"))
def test_mae_ratio_within_half_percent(tier_preds, tier):
    t = tier_preds["targets"]
    mae = {k: float(np.abs(tier_preds[k] - t).mean())
           for k in ("f32", tier)}
    assert mae["f32"] > 0
    ratio = mae[tier] / mae["f32"]
    assert ratio <= MAE_GATE, (tier, ratio, mae)


def test_tiers_actually_differ_from_f32(tier_preds):
    assert np.abs(tier_preds["bf16"] - tier_preds["f32"]).max() > 0
    assert np.abs(tier_preds["int8"] - tier_preds["bf16"]).max() > 0


def test_tiers_share_the_native_weights(trained):
    """No second copy of the f32 weights: every parameter and buffer of a
    tier's clone is the native model's own tensor; the int8 tier adds only
    its int8 q and f32 scales."""
    native = trained.tstate
    ids = {id(t) for t in list(native.model.parameters())
           + list(native.model.buffers())}
    for tier in ("bf16", "int8"):
        st = tq.TierSpec(tier).state_for(native)
        inner = st.model.inner
        assert all(id(t) in ids for t in inner.parameters())
        assert all(id(t) in ids for t in inner.buffers())
        assert st.normalizer is native.normalizer
        own = [b for n, b in st.model.named_buffers(recurse=False)]
        assert (tier == "int8") == bool(own)
        assert all(b.dtype in (torch.int8, torch.float32) for b in own)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def _tier_server(trained, **kw):
    ss = plan_shape_set(trained.port, 8, rungs=2)
    kw.setdefault("log_fn", lambda *a, **k: None)
    kw.setdefault("max_wait_ms", 5.0)
    server = InferenceServer(trained.tstate, ss, device="cpu",
                             precisions=("f32", "bf16", "int8"), **kw)
    server.warm(trained.port[0])
    return server.start()


def test_unknown_tier_rejected_at_admission(trained):
    server = _tier_server(trained, cache_size=0)
    try:
        with pytest.raises(ServeRejection, match="precision"):
            server.submit(trained.port[0], precision="fp4")
        assert server.counts["reject_malformed"] == 1
        res = {t: server.predict(trained.port[1], timeout_ms=60_000,
                                 precision=t) for t in tq.TIERS}
        assert {t: r.precision for t, r in res.items()} == {
            t: t for t in tq.TIERS}
        f32 = res["f32"].prediction
        for tier in ("bf16", "int8"):
            assert not np.array_equal(res[tier].prediction, f32)
            np.testing.assert_allclose(res[tier].prediction, f32,
                                       rtol=0.05, atol=0.05)
        assert server.stats()["precisions"] == list(tq.TIERS)
    finally:
        assert server.drain(timeout_s=30)


def test_batcher_cuts_flush_at_tier_boundary(trained):
    ss = plan_shape_set(trained.port, 8, rungs=2)
    b = MicroBatcher(ss, max_wait_ms=5.0)
    for tier in ("f32", "f32", "bf16", "bf16", "int8"):
        b.offer(Request(graph=trained.port[0], enqueued=0.0,
                        deadline=None, precision=tier))
    flushes = []
    while True:
        f = b.poll(now=1.0)  # all past the batching deadline
        if f is None or not f.requests:
            break
        flushes.append((f.precision, len(f.requests)))
    assert flushes == [("f32", 2), ("bf16", 2), ("int8", 1)]


def test_tier_keyed_cache_isolation(trained):
    server = _tier_server(trained, cache_size=64)
    g = trained.port[2]
    try:
        r_f32 = server.predict(g, timeout_ms=60_000)
        r_int8 = server.predict(g, timeout_ms=60_000, precision="int8")
        # the int8 request is not answered from the f32 row
        assert not r_int8.cached and r_int8.precision == "int8"
        assert not np.array_equal(r_int8.prediction, r_f32.prediction)
        again = server.predict(g, timeout_ms=60_000)
        assert again.cached and again.precision == "f32"
        np.testing.assert_array_equal(again.prediction, r_f32.prediction)
        r_int8_2 = server.predict(g, timeout_ms=60_000, precision="int8")
        assert r_int8_2.cached and r_int8_2.precision == "int8"
        np.testing.assert_array_equal(r_int8_2.prediction,
                                      r_int8.prediction)
        assert server._cache_key(g, False, "feat", None, "int8") == \
            "int8:" + server._cache_key(g, False, "feat", None)
    finally:
        assert server.drain(timeout_s=30)


def test_hot_swap_rebuilds_every_tier(trained, tmp_path):
    """A reload re-derives every tier: each tier's answer after the swap
    equals that tier's own program on the new weights, bit for bit (the
    int8 tier re-quantized), under the new version; nothing is captured
    again (on the card: chip_smoke.py)."""
    from cgnn_tpu_torch.serve.server import load_server
    from cgnn_tpu_torch.train.__main__ import main as train_main

    ck = str(tmp_path / "ck")
    assert train_main(["--synthetic", "24", "--device", "cpu", "--epochs",
                       "1", "-b", "8", "--ckpt-dir", ck, "--out-dir",
                       str(tmp_path / "out"), "--radius", "5", "--n-conv",
                       "2", "--atom-fea-len", "16", "--print-freq",
                       "0"]) == 0
    server, info = load_server(ck, batch_size=8, rungs=1, device="cpu",
                               precision="f32,bf16,int8", cache_size=0,
                               poll_interval_s=3600, log_fn=lambda *a: None,
                               calibration_n=24)
    g = info["calibration"][1]
    try:
        v1 = server.version
        before = {t: server.predict(g, timeout_ms=60_000, precision=t)
                  for t in tq.TIERS}
        v2 = _commit(ck, scale=1.25)
        assert server.watcher.poll_once()
        after = {t: server.predict(g, timeout_ms=60_000, precision=t)
                 for t in tq.TIERS}
        mgr = CheckpointManager(ck)
        fresh = mgr.restore_for_inference(
            InferenceState(build_model(info["model_cfg"], info["data_cfg"],
                                       device="cpu").eval(),
                           Normalizer.identity(1, device="cpu")), v2)
        batch = server.shape_set.pack([g])
        step = make_predict_step()
        for t in tq.TIERS:
            assert before[t].param_version == v1
            assert after[t].param_version == v2
            want = step(tq.TierSpec(t).state_for(fresh), batch)[0].numpy()
            np.testing.assert_array_equal(after[t].prediction, want,
                                          err_msg=t)
            assert not np.array_equal(after[t].prediction,
                                      before[t].prediction)
        assert server.stats()["counts"]["reloads"] == 1
    finally:
        assert server.drain(timeout_s=30)


def test_entry_point_serves_precision_tiers(tmp_path):
    """``python -m cgnn_tpu_torch.serve CKPT --precision f32,bf16,int8
    --device cpu`` boots and answers each tier's ``precision`` field."""
    from cgnn_tpu_torch.train.__main__ import main as train_main

    ck = types.SimpleNamespace(dir=str(tmp_path / "ck"), tmp=tmp_path)
    assert train_main(["--synthetic", "24", "--device", "cpu", "--epochs",
                       "1", "-b", "8", "--ckpt-dir", ck.dir, "--out-dir",
                       str(tmp_path / "out"), "--radius", "5", "--n-conv",
                       "2", "--atom-fea-len", "16", "--print-freq",
                       "0"]) == 0
    port = _free_port()
    proc = _start(ck, port, "", "--precision", "f32,bf16,int8")
    try:
        _statuses_until_ready(proc, port)
        answers = {}
        for tier in tq.TIERS:
            st, body = _post(port, dict(STRUCTURE, precision=tier))
            assert st == 200 and body["precision"] == tier, body
            answers[tier] = body["prediction"]
        st, body = _post(port, dict(STRUCTURE, precision="fp4"))
        assert st == 400 and "precision" in body["error"], body
        assert answers["bf16"] != answers["f32"]
        proc.send_signal(signal.SIGTERM)
        assert _wait(proc) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
