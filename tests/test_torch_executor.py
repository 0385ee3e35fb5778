"""The forward paths over a device set (``cgnn_tpu_torch/parallel/
executor.py``, ``train/infer.py``, ``serve/server.py``) on the CPU, where
``[cpu] * N`` is N entries of one device (torch has one CPU device), as
``[cuda:0, cuda:0]`` is on one card:

- ``MeshExecutor.plan_flush`` gives the JAX ``MeshExecutor.plan_flush``'s
  groups, rung and counts over the same graphs and ladder (JAX on
  ``jax.devices()[:N]``, the conftest's host devices); ``stack`` takes
  exactly N batches; ``stage`` hands each entry its slice alone and
  counts that slice's bytes;
- bulk predict (``run_fast_inference`` on the ladder, compact staging
  and size buckets; ``run_raw_inference``) over ``[cpu] * N`` under both
  engines is bit-equal to one entry, and within rtol 1e-4 / atol 1e-4 of
  the JAX functions with ``devices=jax.devices()[:N]`` (after
  tests/test_executor.py); the port's model runs the whole-conv op
  (its plain version), the JAX model the unfused path;
- the server: ``engine`` reads 'single', 'mesh' or 'threads' as the JAX
  server's does, and bulk predict opens its device set through the same
  ``open_entries`` (one step a distinct device); over ``[cpu, cpu]``
  under both engines one request a flush answers bit-equal to a one-entry server (the same packed batch),
  a mixed-tier burst is answered by every entry in its tier and within
  tolerance of the JAX predict step, and nothing is captured after
  warm-up; a hot swap under concurrent sharded dispatch is atomic: every
  answer's numbers are those of the version it reports, and no client
  sees the old version after it has seen the new one.
"""

import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgnn_tpu.data import rawbatch as jr
from cgnn_tpu.data.compact import CompactSpec as JCompactSpec
from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu.models import CrystalGraphConvNet as JNet
from cgnn_tpu.parallel.executor import MeshExecutor as JMeshExecutor
from cgnn_tpu.serve import shapes as jshapes
from cgnn_tpu.serve.server import InferenceServer as JInferenceServer
from cgnn_tpu.train import infer as jinfer
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.state import TrainState as JTrainState
from cgnn_tpu.train.state import make_optimizer as jmake_optimizer
from cgnn_tpu.train.step import make_predict_step as jmake_predict_step
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
from cgnn_tpu_torch.data import rawbatch as tr
from cgnn_tpu_torch.data.compact import CompactSpec
from cgnn_tpu_torch.parallel.executor import (
    MeshExecutor,
    batch_fields,
    open_entries,
)
from cgnn_tpu_torch.serve import shapes as tshapes
from cgnn_tpu_torch.serve.server import InferenceServer, load_server
from cgnn_tpu_torch.train import infer as tinfer
from cgnn_tpu_torch.train.checkpoint import CheckpointManager, inference_state
from cgnn_tpu_torch.train.normalizer import Normalizer
from cgnn_tpu_torch.train.step import InferenceState, make_predict_step
from test_torch_rawwire import _port_graph
from test_torch_reload import _commit

M = 8
SMALL = dict(atom_fea_len=16, n_conv=2, h_fea_len=24)
CFG = FeaturizeConfig(radius=5.0, max_num_nbr=M)
TOL = dict(rtol=1e-4, atol=1e-4)  # against the JAX package (f32 sums)
NORM = ([1.5], [2.0])
B = 8
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    """JAX graphs (geometry kept), JAX-initialized variables with
    non-trivial BatchNorm statistics, the JAX predict state and the
    port's InferenceState on the same weights."""
    graphs = load_synthetic(44, CFG, seed=2, max_atoms=6, keep_geometry=True)
    jnet = JNet(**SMALL, dense_m=M)
    ss = jshapes.plan_shape_set(graphs, B, rungs=2, dense_m=M)
    v = jax.tree_util.tree_map(
        np.array, jnet.init(jax.random.key(1), ss.pack_full(graphs[:1])))
    rng = np.random.default_rng(9)
    for conv in v["batch_stats"].values():
        for bn in conv.values():
            bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    tx = jmake_optimizer("sgd")
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
        normalizer=JNormalizer(mean=jnp.asarray(NORM[0], np.float32),
                               std=jnp.asarray(NORM[1], np.float32)),
        rng=jax.random.key(0), apply_fn=jnet.apply, tx=tx)
    net = build_model(ModelConfig(**SMALL, dense_m=M, cgconv_impl="pallas"),
                      DataConfig(radius=5.0, max_num_nbr=M), device="cpu")
    net.load_state_dict(convert.from_flax_variables(v))
    state = InferenceState(net.eval(),
                           Normalizer.from_arrays(*NORM, device="cpu"))
    port = [_port_graph(g) for g in graphs]
    jspec = jr.plan_raw_spec(graphs, CFG.gdf(), CFG.radius, M)
    tspec = tr.plan_raw_spec(port, CFG.gdf(), CFG.radius, M)
    return types.SimpleNamespace(
        graphs=graphs, port=port, jstate=jstate, state=state,
        jss=jshapes.plan_shape_set(graphs, B, rungs=2, dense_m=M, raw=jspec),
        tss=tshapes.plan_shape_set(port, B, rungs=2, dense_m=M, raw=tspec))


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("size", [1, 5, 11, 16])
def test_plan_flush_matches_jax(models, n, size):
    jex = JMeshExecutor(jax.devices()[:n])
    tex = MeshExecutor([CPU] * n)
    assert len(tex) == len(jex) == n
    jl = jshapes.plan_shape_set(models.graphs, B, rungs=3, dense_m=M)
    tl = tshapes.plan_shape_set(models.port, B, rungs=3, dense_m=M)
    want = jex.plan_flush(models.graphs[:size], jl)
    got = tex.plan_flush(models.port[:size], tl)
    assert [[g.cif_id for g in grp] for grp in got[0]] == [
        [g.cif_id for g in grp] for grp in want[0]]
    assert got[1].to_meta() == want[1].to_meta()
    assert got[2] == want[2] and sum(got[2]) == size
    assert tex.split_round_robin(list(range(size))) == \
        jex.split_round_robin(list(range(size)))


def test_stack_and_stage_hand_each_entry_its_slice(models):
    ex = MeshExecutor([CPU] * 3)
    ss = models.tss
    batches = [ss.pack_full(models.port[k:k + 2], shape=ss.largest)
               for k in (0, 2, 4)]
    with pytest.raises(ValueError, match="exactly 3"):
        ex.stack(batches[:2])
    stacked = ex.stack(batches)
    assert type(stacked) is type(batches[0])
    staged = ex.stage(stacked)
    one = sum(t.numel() * t.element_size()
              for t in batch_fields(batches[0]).values())
    assert ex.staged_bytes == [one] * 3 and ex.stages == 1
    for got, want in zip(staged, batches):
        assert batch_fields(got).keys() == batch_fields(want).keys()
        for k, t in batch_fields(want).items():
            assert torch.equal(batch_fields(got)[k], t), k
    raws = [r for r in map(tr.raw_from_graph, models.port)
            if ss.admits_raw(r)]
    rstack = ex.stack([ss.pack_raw(raws[k:k + 3], shape=ss.largest)
                       for k in (0, 3, 6)])
    assert type(rstack).__name__ == "RawBatch"
    ex.stage(rstack)
    assert ex.staged_bytes[0] == ex.staged_bytes[2] > one


# ---------------------------------------------------------------------------
# bulk predict
# ---------------------------------------------------------------------------


def _paths(models):
    spec = CompactSpec.build(models.port, CFG.gdf(), dense_m=M)
    jspec = JCompactSpec.build(models.graphs, CFG.gdf(), dense_m=M)
    return {
        "ladder": (dict(shape_set=tshapes.plan_shape_set(
            models.port, B, rungs=2, dense_m=M)), dict(
            shape_set=jshapes.plan_shape_set(models.graphs, B, rungs=2,
                                             dense_m=M))),
        "compact": (dict(shape_set=tshapes.plan_shape_set(
            models.port, B, rungs=2, dense_m=M, compact=spec),
            pack_workers=2), dict(shape_set=jshapes.plan_shape_set(
                models.graphs, B, rungs=2, dense_m=M, compact=jspec))),
        "buckets": (dict(buckets=3, dense_m=M),
                    dict(buckets=3, dense_m=M, snug=True)),
    }


@pytest.mark.parametrize("path", ["ladder", "compact", "buckets"])
@pytest.mark.parametrize("engine", ["mesh", "threads"])
def test_bulk_predict_engines_bit_equal_and_match_jax(models, path, engine):
    tkw, jkw = _paths(models)[path]
    one, _ = tinfer.run_fast_inference(models.state, models.port, B, **tkw)
    for n in (2, 3):
        stats = {}
        got, rate = tinfer.run_fast_inference(
            models.state, models.port, B, devices=[CPU] * n, engine=engine,
            stats=stats, **tkw)
        assert rate > 0 and stats["engine"] == engine
        assert stats["entries"] == n
        np.testing.assert_array_equal(got, one)
        if engine == "mesh":
            assert stats["dispatches"] < stats["batches"]
            assert len(set(stats["staged_bytes"])) == 1
        else:
            assert stats["dispatches"] == stats["batches"]
        if path == "compact" and engine == "threads":
            # each entry's pool recycles behind its own fence
            assert stats["buffers_allocated"] >= n
        want, _ = jinfer.run_fast_inference(
            models.jstate, models.graphs, B, devices=jax.devices()[:n],
            engine=engine, **jkw)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("engine", ["mesh", "threads"])
def test_raw_inference_engines_bit_equal_and_match_jax(models, engine):
    traws = [tr.raw_from_graph(g) for g in models.port]
    jraws = [jr.raw_from_graph(g) for g in models.graphs]
    keep = [i for i, r in enumerate(traws) if models.tss.admits_raw(r)]
    assert len(keep) > 2 * B  # several batches, a ragged tail
    items = [traws[i] for i in keep]
    one, _ = tinfer.run_raw_inference(models.state, items, models.tss)
    for n in (2, 3):
        stats = {}
        got, _ = tinfer.run_raw_inference(models.state, items, models.tss,
                                          devices=[CPU] * n, engine=engine,
                                          stats=stats)
        np.testing.assert_array_equal(got, one)
        assert stats["engine"] == engine and stats["batches"] >= 3
        want, _ = jinfer.run_raw_inference(
            models.jstate, [jraws[i] for i in keep], models.jss,
            devices=jax.devices()[:n], engine=engine)
        np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, engine", [(1, "auto"), (1, "mesh"),
                                       (1, "threads"), (2, "auto"),
                                       (2, "mesh"), (2, "threads")])
def test_engine_reads_like_jax(models, n, engine):
    jserver = JInferenceServer(models.jstate, models.jss,
                               devices=jax.devices()[:n], engine=engine,
                               log_fn=lambda *a, **k: None)
    tserver = InferenceServer(models.state, models.tss, devices=[CPU] * n,
                              engine=engine, log_fn=lambda *a: None)
    assert tserver.engine == jserver.engine
    assert tserver.stats()["engine"] == jserver.stats()["engine"]
    assert len(tserver.stats()["devices"]) == n
    assert tserver.stats()["device_inflight"] == [0] * n
    with pytest.raises(ValueError, match="engine must be"):
        InferenceServer(models.state, models.tss, devices=[CPU] * n,
                        engine="ring")


@pytest.mark.parametrize("n, engine", [(1, "auto"), (1, "mesh"),
                                       (1, "threads"), (2, "auto"),
                                       (2, "mesh"), (3, "threads")])
def test_bulk_predict_opens_the_servers_device_set(models, n, engine):
    """``open_entries`` decides the engine for the server and for bulk
    predict alike: the JAX server's reading, one step built a distinct
    device, a mesh executor only under the mesh engine, no stream on the
    CPU."""
    made = []
    ents = open_entries([CPU] * n, engine, lambda d: made.append(d) or d)
    want = JInferenceServer(models.jstate, models.jss,
                            devices=jax.devices()[:n], engine=engine,
                            log_fn=lambda *a, **k: None).engine
    assert ents.engine == want
    assert made == [CPU] and ents.steps == [CPU] * n
    assert (ents.mesh is not None) == (want == "mesh")
    assert ents.streams == [None] * (1 if n == 1 else n)
    stats = {}
    tinfer.run_fast_inference(models.state, models.port[:B], B,
                              shape_set=models.tss, devices=[CPU] * n,
                              engine=engine, stats=stats)
    assert stats["engine"] == want and len(stats["entry_replays"]) == n
    with pytest.raises(ValueError, match="engine must be"):
        open_entries([CPU] * n, "ring", lambda d: d)


def _jax_one(models, graphs):
    step = jmake_predict_step()
    return np.stack([np.asarray(step(models.jstate, models.jss.pack_full(
        [g])))[0] for g in graphs])


@pytest.mark.parametrize("engine", ["mesh", "threads"])
def test_server_engines_bit_equal_to_one_entry(models, engine):
    kw = dict(precisions=("f32", "bf16"), cache_size=0, pack_workers=1,
              default_timeout_ms=60_000.0, log_fn=lambda *a: None)
    graphs = models.port[:12]
    single = InferenceServer(models.state, models.tss, device="cpu",
                             max_wait_ms=1.0, **kw)
    multi = InferenceServer(models.state, models.tss, devices=[CPU, CPU],
                            engine=engine, max_wait_ms=20.0, **kw)
    try:
        for s in (single, multi):
            s.warm(models.port[0])
            s.start()
        # one request a flush: the same packed batch on either side
        for tier in ("f32", "bf16"):
            want = [single.predict(g, precision=tier) for g in graphs]
            got = [multi.predict(g, precision=tier) for g in graphs]
            for a, b in zip(got, want):
                assert a.precision == b.precision == tier
                np.testing.assert_array_equal(a.prediction, b.prediction)
        # a burst: every entry answers, each answer in its tier
        idx = list(range(len(models.port))) * 2
        futs = [(t, k, multi.submit(models.port[k], precision=t))
                for t in ("f32", "bf16") for k in idx]
        res = [(t, k, f.result(120)) for t, k, f in futs]
        assert all(r.precision == t for t, _, r in res)
        assert {r.device_id for _, _, r in res} == {0, 1}
        st = multi.stats()
        assert st["engine"] == engine
        assert all(d["dispatches"] >= 1 for d in st["devices"])
        assert st["counts"]["captures_after_warm"] == 0
        assert st["counts"]["responses_bf16"] == len(models.port) * 2 + 12
        f32 = [(k, r) for t, k, r in res if t == "f32"]
        np.testing.assert_allclose(
            np.stack([r.prediction for _, r in f32]),
            _jax_one(models, [models.graphs[k] for k, _ in f32]), **TOL)
        if engine == "mesh":
            sb = st["staged_bytes"]
            assert sb[0] == sb[1] > 0
    finally:
        assert single.drain(timeout_s=60) and multi.drain(timeout_s=60)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from cgnn_tpu_torch.train.__main__ import main as train_main

    d = tmp_path_factory.mktemp("executor_swap")
    ck = str(d / "ckpt")
    assert train_main(["--synthetic", "24", "--device", "cpu", "--epochs",
                       "1", "-b", "8", "--ckpt-dir", ck, "--out-dir",
                       str(d / "out"), "--radius", "5", "--n-conv", "2",
                       "--atom-fea-len", "16", "--print-freq", "0"]) == 0
    return ck


def test_hot_swap_atomic_under_concurrent_sharded_dispatch(ckpt, tmp_path):
    import shutil

    ck = str(tmp_path / "ck")
    shutil.copytree(ckpt, ck)
    server, info = load_server(
        ck, batch_size=8, rungs=2, device="cpu", devices=[CPU, CPU],
        engine="mesh", cache_size=0, pack_workers=1, max_queue=4096,
        default_timeout_ms=60_000.0, poll_interval_s=3600,
        log_fn=lambda *a: None, calibration_n=24)
    assert server.engine == "mesh"
    graphs = info["calibration"][:12]
    v1 = server.version
    v2 = _commit(ck, scale=1.25)
    results, lock, stop = [], threading.Lock(), threading.Event()

    def client(ci):
        rng = np.random.default_rng(ci)
        while not stop.is_set():
            k = int(rng.integers(len(graphs)))
            r = server.predict(graphs[k], timeout_ms=60_000)
            with lock:
                results.append((ci, k, r))

    threads = [threading.Thread(target=client, args=(i,), daemon=True,
                                name=f"test-swap-client-{i}")
               for i in range(6)]
    try:
        for t in threads:
            t.start()

        def wait_for(count):
            end = time.monotonic() + 120
            while time.monotonic() < end:
                with lock:
                    if len(results) >= count:
                        return
                time.sleep(0.01)

        wait_for(30)
        assert server.watcher.poll_once()  # the swap lands mid-load
        wait_for(len(results) + 60)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert server.drain(timeout_s=60)
    assert server.stats()["counts"]["captures_after_warm"] == 0
    mgr = CheckpointManager(ck)
    step = make_predict_step()
    refs = {}
    for v in (v1, v2):
        st = mgr.restore_for_inference(inference_state(
            mgr.read_meta(v), "cpu"), v)
        refs[v] = np.stack([step(st, server.shape_set.pack([g]))[0].numpy()
                            for g in graphs])
    seen_new = set()
    versions = set()
    for ci, k, r in results:
        versions.add(r.param_version)
        assert r.param_version in (v1, v2)
        # the version an answer reports is the one that computed it
        np.testing.assert_allclose(
            r.prediction, refs[r.param_version][k], **TOL,
            err_msg=f"answer labeled {r.param_version} (shard "
                    f"{r.device_id}) disagrees with those weights")
        if r.param_version == v2:
            seen_new.add(ci)
        else:
            assert ci not in seen_new, "the old version after the new one"
    assert versions == {v1, v2}
    assert {r.device_id for _, _, r in results} == {0, 1}
