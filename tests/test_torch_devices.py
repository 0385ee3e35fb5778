"""The device set (``cgnn_tpu_torch/serve/devices.py``) and the store of
its states (``serve/reload.py`` ``ParamStore``) on the CPU:

- ``DeviceSet``: the same pick / enqueue / complete script gives the same
  picks, in-flight depths and per-entry records (every key the JAX
  ``DeviceSet.stats`` has) as the JAX ``DeviceSet``, and the same gauge
  names;
- ``resolve_devices``: 'auto' on the CPU is one entry; N beyond the
  devices raises with the JAX message, never clamps; 0 raises; CUDA
  without a card raises; the predict entry point exits 2 on it;
- ``replicate_state``: entry 0 is the state itself, every other entry
  (a repeated device too) tensors of its own;
- ``ParamStore`` over entries and tiers: ``devices`` and ``placer``
  exclude each other; a staged swap reaches every entry and tier in
  place (the int8 tier re-quantized) under one version.
"""

import numpy as np
import pytest
import torch

import jax
from cgnn_tpu.serve import devices as jdevices
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
from cgnn_tpu_torch.predict import main as predict_main
from cgnn_tpu_torch.serve import devices as tdevices
from cgnn_tpu_torch.serve.quantize import build_tier_specs, quantize_params
from cgnn_tpu_torch.serve.reload import ParamStore
from cgnn_tpu_torch.train.normalizer import Normalizer
from cgnn_tpu_torch.train.step import InferenceState

CPU = torch.device("cpu")
SMALL = dict(atom_fea_len=16, n_conv=2, h_fea_len=24, dense_m=8)
DATA = DataConfig(radius=5.0, max_num_nbr=8)
# stats() keys compared by value: occupancy divides by each set's wall time
EXACT = ("device_id", "dispatches", "busy_s", "inflight", "max_window_depth")


def _script(n, seed, steps=60):
    """A pick/enqueue/complete script: each pick enqueues on the picked
    entry; completions retire an in-flight entry, some as failures."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(steps):
        if rng.random() < 0.6:
            ops.append(("pick",))
        else:
            ops.append(("complete", int(rng.integers(n)),
                        float(rng.integers(1, 50)) / 1000.0,
                        bool(rng.random() < 0.8)))
    return ops


def _drive(ds, ops) -> list:
    seen = []
    for op in ops:
        if op[0] == "pick":
            i = ds.pick()
            ds.note_enqueue(i)
            seen.append(("pick", i, ds.inflight_depths()))
        else:
            _, i, busy, ok = op
            ds.note_complete(i, busy, ok=ok)
            seen.append(("complete", i, ds.inflight_depths(),
                         ds.inflight(i)))
    return seen


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_device_set_matches_jax(n, seed):
    ops = _script(n, seed)
    want_ds = jdevices.DeviceSet(jax.devices()[:n])
    got_ds = tdevices.DeviceSet([CPU] * n)
    assert len(got_ds) == len(want_ds) == n
    assert _drive(got_ds, ops) == _drive(want_ds, ops)
    want, got = want_ds.stats(), got_ds.stats()
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [{k: r[k] for k in EXACT} for r in got] == [
        {k: r[k] for k in EXACT} for r in want]
    assert all(0.0 <= r["occupancy"] <= 1.0 for r in got)
    assert [r["device"] for r in got] == ["cpu"] * n


def test_flush_gauges_match_jax():
    class Gauges:
        def __init__(self):
            self.names = []

        def set_gauge(self, name, value):
            self.names.append(name)
            assert isinstance(value, float)

    want, got = Gauges(), Gauges()
    jdevices.DeviceSet(jax.devices()[:3]).flush_gauges(want)
    tdevices.DeviceSet([CPU] * 3).flush_gauges(got)
    assert got.names == want.names
    tdevices.DeviceSet([CPU]).flush_gauges(None)  # no telemetry: a no-op


@pytest.mark.parametrize("spec, n", [("auto", 1), (None, 1), (1, 1),
                                     ("1", 1)])
def test_resolve_devices_on_the_cpu(spec, n):
    got = tdevices.resolve_devices(spec, "cpu")
    assert got == [CPU] * n


@pytest.mark.parametrize("spec, match", [
    (2, r"--devices 2 requested but only 1 local device\(s\) exist"),
    ("99", r"--devices 99 requested but only 1 local device\(s\) exist"),
    (0, r"--devices must be >= 1, got 0"),
])
def test_resolve_devices_never_clamps(spec, match):
    with pytest.raises(ValueError, match=match):
        tdevices.resolve_devices(spec, "cpu")
    # the JAX package's message, on its 8 host devices
    jmatch = match.replace("only 1", "only 8")
    if spec != 2:
        with pytest.raises(ValueError, match=jmatch):
            jdevices.resolve_devices(spec)


def test_resolve_devices_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevices.resolve_devices("auto")


def test_predict_devices_beyond_the_count_exits_2(tmp_path, capsys):
    assert predict_main([str(tmp_path / "no_ckpt"), "--device", "cpu",
                         "--devices", "2", "--synthetic", "4"]) == 2
    assert "requested but only 1 local device(s) exist" in \
        capsys.readouterr().err


def _state(seed=0) -> InferenceState:
    cfg = ModelConfig(**SMALL)
    net = build_model(cfg, DATA, device="cpu")
    net.load_state_dict(convert.from_flax_variables(
        convert.init_params(cfg, DATA, seed=seed)))
    return InferenceState(net.eval(), Normalizer.from_arrays(
        [1.5], [2.0], device="cpu"))


def test_replicate_state_entries_own_their_tensors():
    state = _state()
    reps = tdevices.replicate_state(state, ["cpu", "cpu", "cpu"])
    assert reps[0] is state
    ptrs = {t.data_ptr() for t in state.model.state_dict().values()}
    for r in reps[1:]:
        assert not r.model.training
        for (k, a), b in zip(r.model.state_dict().items(),
                             state.model.state_dict().values()):
            assert torch.equal(a, b), k
            assert a.data_ptr() not in ptrs, k
        assert torch.equal(r.normalizer.mean, state.normalizer.mean)
        assert r.normalizer.mean.data_ptr() != \
            state.normalizer.mean.data_ptr()


def test_param_store_entries_tiers_and_swap():
    state = _state(0)
    specs = build_tier_specs(("f32", "bf16", "int8"))
    with pytest.raises(ValueError, match="not both"):
        ParamStore(state, devices=[CPU], placer=lambda s: [s])
    store = ParamStore(state, "v1", devices=[CPU, CPU], tier_specs=specs)
    assert len(store) == 2 and store.tiers == ("f32", "bf16", "int8")
    assert store.get(0)[0] is state and store.state is state
    live1, v = store.get(1, "f32")
    assert v == "v1" and live1 is not state
    new = _state(1)
    store.stage(new, "v2")
    assert store.pending == "v2" and store.version == "v1"
    assert store.apply_pending() == "v2"
    assert store.version == "v2" and store.pending is None
    assert store.apply_pending() is None
    want_q = {k: v.q for k, v in quantize_params(
        dict(new.model.named_parameters())).items() if hasattr(v, "q")}
    for i in range(2):
        f32 = store.get(i, "f32")[0]
        for k, t in f32.model.state_dict().items():
            assert torch.equal(t, new.model.state_dict()[k]), (i, k)
        assert torch.equal(f32.normalizer.std, new.normalizer.std)
        bf16 = store.get(i, "bf16")[0]
        # the bf16 tier reads the native tensors: the swap reached it
        assert all(p is q for p, q in zip(bf16.model.inner.parameters(),
                                          f32.model.parameters()))
        int8 = store.get(i, "int8")[0].model
        for k, (name, _, _) in enumerate(int8._quant):
            assert torch.equal(getattr(int8, f"q{k}"), want_q[name])
    # a placer maps the state to one state per entry itself
    placed = ParamStore(state, "p", placer=lambda s: tdevices.replicate_state(
        s, [CPU, CPU]), tier_specs=specs)
    assert len(placed) == 2 and placed.get(1, "int8")[1] == "p"
