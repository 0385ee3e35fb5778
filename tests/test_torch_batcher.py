"""The port's priority-class batcher (``cgnn_tpu_torch/serve/batcher.py``)
against the JAX package's (``cgnn_tpu/serve/batcher.py``), and the
server's pack-overlapped worker on the CPU.

- A hypothesis script of offers (priority class, tenant, deadline, size,
  staging form) and ``poll(now)`` times runs through both batchers over
  the same shape ladder: every flush has the same members in the same
  order, shape, reason, class, expired requests and backfill counts, and
  every offer the same rejection; ``parse_kv_spec`` gives the same
  results and errors.
- ``pack_workers=2`` against ``pack_workers=0``: the same requests give
  bit-equal answers in the same flush order, and a pack that raises
  fails its own flush alone.
"""

import threading
import time
import types

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cgnn_tpu.serve import batcher as jb
from cgnn_tpu.serve import shapes as jshapes
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.config import DataConfig, ModelConfig
from cgnn_tpu_torch.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu_torch.data.graph import CrystalGraph
from cgnn_tpu_torch.serve import batcher as tb
from cgnn_tpu_torch.serve import shapes as tshapes
from cgnn_tpu_torch.serve.server import load_server

M = 4
SIZES = (1, 2, 3, 5, 8)  # atoms of the graphs offered
# (graph cap, node cap, edge cap): a ladder whose top rung fills on any of
# its three budgets
RUNGS = ((2, 8, 32), (4, 16, 64))


def _graph(mod, n):
    idx = np.zeros(n * M, np.int32)
    return mod(np.zeros((n, 3), np.float32), np.zeros((n * M, 2), np.float32),
               idx, idx, np.zeros(1, np.float32))


@pytest.fixture(scope="module")
def ladders():
    from cgnn_tpu.data.graph import CrystalGraph as JGraph

    jss = jshapes.ShapeSet([jshapes.BatchShape(*r) for r in RUNGS],
                           dense_m=M)
    tss = tshapes.ShapeSet([tshapes.BatchShape(*r) for r in RUNGS],
                           dense_m=M)
    graphs = {n: (_graph(JGraph, n), _graph(CrystalGraph, n))
              for n in SIZES + (9,)}
    return types.SimpleNamespace(jss=jss, tss=tss, graphs=graphs)


OFFER = st.tuples(
    st.just("offer"),
    st.sampled_from(tb.CLASSES + ("vip",)),  # an unknown class, rarely
    st.sampled_from(("", "acme", "guest")),
    st.sampled_from(SIZES + (9,)),  # 9 atoms: oversize
    st.one_of(st.none(), st.floats(0.001, 0.2)),  # deadline, s from now
    st.sampled_from(("feat", "feat", "raw")),
)
POLL = st.tuples(st.just("poll"), st.floats(0.0, 0.05))
CLOSE = st.tuples(st.just("close"))


def _run(mod, ss, graphs, script, side):
    b = mod.MicroBatcher(ss, max_queue=6, max_wait_ms=5.0,
                         class_max_wait_ms={"scavenger": 30.0},
                         wfq_weights={"acme": 3.0})
    now, log, reqs = 0.0, [], []
    for op in script:
        if op[0] == "offer":
            _, klass, tenant, n, dl, form = op
            r = mod.Request(graph=graphs[n][side], enqueued=now,
                            deadline=None if dl is None else now + dl,
                            klass=klass, tenant=tenant, form=form)
            r.trace_id = f"r{len(reqs)}"
            reqs.append(r)
            try:
                b.offer(r)
                log.append(("ok", r.trace_id))
            except mod.ServeRejection as e:
                log.append(("reject", e.reason))
        elif op[0] == "poll":
            now += op[1]
            f = b.poll(now=now)
            log.append(None if f is None else (
                [r.trace_id for r in f.requests],
                [r.trace_id for r in f.expired],
                None if f.shape is None else tuple(vars(f.shape).values()),
                f.reason, f.klass, f.form, f.n_backfilled, f.slack_slots,
                [r.backfilled for r in f.requests]))
        else:
            b.close()
            log.append("closed")
    log.append((b.depth, b.backfilled_total, b.slack_total))
    return log


@settings(max_examples=80, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(script=st.lists(st.one_of(OFFER, OFFER, POLL, POLL, CLOSE),
                       min_size=1, max_size=40))
def test_flush_script_matches_jax(ladders, script):
    want = _run(jb, ladders.jss, ladders.graphs, script, 0)
    got = _run(tb, ladders.tss, ladders.graphs, script, 1)
    assert got == want


def test_backfill_and_class_budgets_match_jax(ladders):
    """A fixed script that exercises backfill, an overdue scavenger and
    WFQ across tenants, with both batchers' decisions recorded."""
    script = ([("offer", "scavenger", "", 1, None, "feat")] * 2
              + [("offer", "batch", "acme", 2, None, "feat"),
                 ("offer", "interactive", "guest", 1, None, "feat"),
                 ("poll", 0.006)]
              + [("offer", "interactive", "acme", 1, None, "feat")] * 2
              + [("offer", "interactive", "guest", 1, None, "feat"),
                 ("poll", 0.006), ("poll", 0.04), ("poll", 0.04)])
    want = _run(jb, ladders.jss, ladders.graphs, script, 0)
    got = _run(tb, ladders.tss, ladders.graphs, script, 1)
    assert got == want
    assert want[-1][1] > 0  # something rode the slack


@pytest.mark.parametrize("spec", [
    "", "batch=20,scavenger=80", " acme = 4 , guest=1 ,", "x=1e3",
    "batch", "a=b", "=3", "a=1,,b=2"])
def test_parse_kv_spec_matches_jax(spec):
    try:
        want = jb.parse_kv_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tb.parse_kv_spec(spec)
        assert str(got.value) == str(e)
    else:
        assert tb.parse_kv_spec(spec) == want


def test_config_errors_match_jax(ladders):
    for kw in ({"class_max_wait_ms": {"vip": 1.0}},
               {"wfq_weights": {"acme": 0.0}}, {"max_queue": 0}):
        with pytest.raises(ValueError) as je:
            jb.MicroBatcher(ladders.jss, **kw)
        with pytest.raises(ValueError) as te:
            tb.MicroBatcher(ladders.tss, **kw)
        assert str(te.value) == str(je.value)


def test_future_callbacks_fire_once(ladders):
    fut = tb.RequestFuture()
    seen = []
    fut.add_done_callback(lambda f: seen.append(f.result(0)))
    fut.set_result(3)
    fut.add_done_callback(lambda f: seen.append(f.result(0) + 1))
    assert seen == [3, 4]


# ---- the pack-overlapped worker ----

NS = 24


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    fcfg = FeaturizeConfig(radius=5.0, max_num_nbr=8)
    graphs = load_synthetic(NS, fcfg, seed=4)
    model_cfg = ModelConfig(atom_fea_len=16, n_conv=2, h_fea_len=24,
                            dense_m=8)
    data_cfg = DataConfig(radius=5.0, max_num_nbr=8)
    d = tmp_path_factory.mktemp("w")
    npz, meta = str(d / "p.npz"), str(d / "m.json")
    convert.save_params(npz, meta,
                        convert.init_params(model_cfg, data_cfg, seed=1),
                        model_cfg, data_cfg, normalizer_mean=[0.5],
                        normalizer_std=[2.0])
    return types.SimpleNamespace(graphs=graphs, npz=npz, meta=meta)


def _answers(weights, pack_workers, poison=None):
    """Every graph submitted before the worker starts (so the flushes
    are cut the same way), then answered -> (flush id, prediction or the
    error) per graph, and the order the futures resolved in."""
    server, _ = load_server(weights.npz, weights.meta, batch_size=8,
                            rungs=2, calibration=weights.graphs,
                            device="cpu", pack_workers=pack_workers,
                            cache_size=0, warm=False,
                            log_fn=lambda *a: None,
                            default_timeout_ms=60_000.0)
    server.warm(weights.graphs[0])
    if poison is not None:
        pack_full = server.shape_set.pack_full

        def poisoned(graphs, **kw):
            if any(g.cif_id == poison for g in graphs):
                raise ValueError("poisoned pack")
            return pack_full(graphs, **kw)

        server.shape_set.pack_full = poisoned
    order = []
    lock = threading.Lock()

    def resolved(i):
        with lock:
            order.append(i)

    futs = []
    for i, g in enumerate(weights.graphs):
        f = server.submit(g)
        f.add_done_callback(lambda _f, i=i: resolved(i))
        futs.append(f)
    server.start()
    out = []
    for f in futs:
        try:
            r = f.result(60)
            out.append((r.flush_id, r.prediction))
        except ValueError as e:
            out.append(("failed", str(e)))
    assert server.drain(timeout_s=30)
    return out, order, server.stats()


@pytest.mark.parametrize("poison", [None, 3])
def test_pipelined_worker_matches_serial(weights, poison):
    pid = None if poison is None else weights.graphs[poison].cif_id
    serial, s_order, s_stats = _answers(weights, 0, pid)
    piped, p_order, p_stats = _answers(weights, 2, pid)
    assert [a[0] for a in piped] == [a[0] for a in serial]
    for (_, a), (_, b) in zip(piped, serial):
        if isinstance(a, str):
            assert a == b == "poisoned pack"
        else:
            np.testing.assert_array_equal(a, b)
    # answered flush by flush, in flush order (FIFO within the class)
    ids = [piped[i][0] for i in p_order]
    assert ids == sorted(ids) and p_order == s_order
    assert s_stats["ingest"]["pack_workers"] == 0
    assert p_stats["ingest"]["packed_flushes"] == p_stats["counts"][
        "batches"] + p_stats["counts"]["batch_failures"] > 1
    assert s_stats["ingest"]["worker_pack_s"] > 0
    assert p_stats["ingest"]["worker_pack_s"] == 0
    failed = [i for i, a in enumerate(piped) if a[0] == "failed"]
    if poison is None:
        assert not failed
    else:
        # the poisoned flush alone: its members, and nothing else
        assert poison in failed and len(failed) < NS
        assert p_stats["counts"]["batch_failures"] == 1
        assert p_stats["counts"]["responses"] == NS - len(failed)
