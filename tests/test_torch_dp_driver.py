"""The port's epoch driver under a process group (train/loop.py
``ScanEpochDriver`` with ``ParallelTrainStep``, parallel/data_parallel.py
``agree_batches``) on the CPU: two gloo ranks of ``fit`` with
``scan_epochs`` (and ``pack_once``), small models (2 convs, F=16, M=8).

- the driver's trace, chunk for chunk, equal on both ranks and equal to
  the JAX ``ScanEpochDriver._build_sched`` draws for the same group sizes
  and generator state (the JAX ``_drive`` run order);
- one shape group with SGD against the JAX ``ScanEpochDriver`` over
  ``make_parallel_train_step`` on a 2-device mesh of the conftest's host
  devices, fed ``[rank0_k, rank1_k]`` stacks of the ranks' agreed lists:
  per-epoch train loss and val MAE within rel 1e-5 (the JAX package's
  tolerance between its drivers), parameters within atol 1e-5 after 2
  epochs;
- the driver against the pack-once per-step loop (the twin of
  tests/test_parallel.py's scan-vs-per-step case), rel 1e-5; and under
  ``--graph-shards 2``, dense and COO (tests/test_edge_parallel.py's), with
  each rank's staged edge bytes about 1/G of one process's;
- ``--buckets 3`` on shards whose size classes differ: the same groups,
  with the same sizes, on both ranks, and no hang;
- a NaN batch on one rank, a preemption requested on one rank, and one
  rank's staging budget forced low: both ranks skip, stop, or fall back
  together, and stay bit-equal.

Every case runs its ranks as subprocesses on a free port, killed past
``RANK_TIMEOUT_S``, and every collective is bounded by the process
group's timeout, so a hang fails the case instead of the suite.
"""

import collections
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cgnn_tpu import parallel as jpar
from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu.parallel.data_parallel import shard_scan_stack
from cgnn_tpu.parallel.mesh import make_mesh
from cgnn_tpu.train.loop import ScanEpochDriver as JDriver
from cgnn_tpu_torch.resilience.guard import skipped_steps
from cgnn_tpu_torch.train.loop import batch_caps, fit, sharded_caps
from test_torch_parallel import (
    DATA,
    M,
    OPT,
    _child_env,
    _flat,
    _free_port,
    _jnet,
    _jstate,
    _port,
    _spec,
    _variables,
    _wait_all,
)
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

REL = 1e-5
RANK_TIMEOUT_S = 300
BATCH = 8
EPOCHS = 2

# the ranks' program: python -c WORKER rank world port spec out
WORKER = r'''
import sys
import torch
from cgnn_tpu_torch.parallel import dist
from cgnn_tpu_torch.train import loop

DRIVERS = []


class Recorded(loop.ScanEpochDriver):
    """The driver, its host inputs and generator state kept for the
    test, its trace on."""

    def __init__(self, train_body, eval_body, train_batches, val_batches,
                 rng, **kw):
        self.inputs = (list(train_batches), list(val_batches),
                       rng.bit_generator.state)
        super().__init__(train_body, eval_body, train_batches, val_batches,
                         rng, **kw)
        self.trace = []
        DRIVERS.append(self)


loop.ScanEpochDriver = Recorded


class RequestAfterPolls:
    def __init__(self, n):
        self.polls, self.n = 0, n

    @property
    def requested(self):
        self.polls += 1
        return self.n is not None and self.polls > self.n


def new_state(spec):
    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.train.normalizer import Normalizer
    from cgnn_tpu_torch.train.state import TrainState, make_optimizer

    net = build_model(ModelConfig(**spec["model"]),
                      DataConfig(**spec["data"]), device="cpu")
    net.load_state_dict(spec["state_dict"])
    return TrainState(net, make_optimizer(net.parameters(), **spec["opt"]),
                      Normalizer.fit(spec["targets"], device="cpu"))


def one_run(spec, run, rank):
    from cgnn_tpu_torch.parallel.data_parallel import state_digest
    from cgnn_tpu_torch.resilience import faultinject
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager

    state = new_state(spec)
    index, count = dist.data_index(), dist.data_count()
    train_g, val_g = spec["train"], spec["val"]
    shards = run.get("shards")
    if shards is not None:
        tshard, vshard = shards[index]
    else:
        tshard = dist.host_shard(train_g, index, count)
        vshard = dist.host_shard(val_g, index, count)
    fault = run.get("faults", {}).get(rank)
    faultinject.set_plan(faultinject.FaultPlan.parse(fault) if fault
                         else None)
    budget = loop.device_hbm_budget
    if run.get("low_budget") == rank:
        loop.device_hbm_budget = lambda device=None: 1
    if "restore" in run and rank == 0:
        source = CheckpointManager(run["restore"])
        source.restore(state)
        source.close()
    ckpt = (CheckpointManager(run["ckpt"]) if "ckpt" in run and rank == 0
            else None)
    saves = []

    def save(s, epoch, val_m, is_best):
        saves.append(epoch)
        if ckpt is not None:
            ckpt.save(s, {"epoch": epoch}, is_best=is_best)

    group = dist.graph_group()
    if group is not None:
        state.model.set_graph_group(group)
    n_drivers = len(DRIVERS)
    try:
        state, res = loop.fit(
            state, tshard, vshard, device="cpu", log_fn=lambda *a: None,
            fit_on=(train_g, val_g), on_epoch_end=save,
            preempt=RequestAfterPolls(run.get("preempt", {}).get(rank)),
            **dict(spec["fit"], **run["fit"]))
    finally:
        loop.device_hbm_budget = budget
        faultinject.set_plan(None)
        if ckpt is not None:
            ckpt.wait()
            ckpt.close()
        if group is not None:
            state.model.set_graph_group(None)
    out = {"history": [{"epoch": h["epoch"], "train": h["train"],
                        "val": h["val"]} for h in res["history"]],
           "dp": res["dp"], "staging": res.get("staging", {}),
           "edge_bytes": res["edge_bytes"], "graphs": res["graphs"],
           "preempted": res.get("preempted", False), "saves": saves,
           "state": {k: v.clone() for k, v in
                     state.model.state_dict().items()},
           "digest": state_digest(state)}
    if len(DRIVERS) > n_drivers:
        drv = DRIVERS[-1]
        out["trace"] = drv.trace
        out["train_in"], out["val_in"], out["rng"] = drv.inputs
        out["groups"] = [[(k, g.n) for k, g in d.items()]
                         for d in (drv._train_groups, drv._val_groups)]
    return out


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    spec = torch.load(sys.argv[4], weights_only=False)
    dist.initialize(f"localhost:{port}", world, rank, backend="gloo",
                    timeout_s=60, log_fn=lambda *a: None,
                    graph_shards=spec.get("graph_shards", 1))
    try:
        out = [one_run(spec, run, rank) for run in spec["runs"]]
    finally:
        dist.shutdown()
    torch.save(out, sys.argv[5])


main()
'''


def _run_ranks(tmp_path, spec, world=2):
    path = tmp_path / "spec.pt"
    torch.save(spec, path)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), str(port),
         str(path), str(tmp_path / f"out{r}.pt")], cwd=tmp_path,
        env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = _wait_all(procs, RANK_TIMEOUT_S)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(world)]


def _graphs(n, seed, max_atoms=6):
    return load_synthetic(n, FeaturizeConfig(**DATA), seed=seed,
                          max_atoms=max_atoms)


@pytest.fixture(scope="module")
def data():
    """JAX graphs (train, val), their port twins, the JAX initial
    variables."""
    jtrain, jval = _graphs(48, seed=8), _graphs(16, seed=9)
    nc, ec = jgraph.capacities_for(jtrain, BATCH, dense_m=M, snug=True)
    example = next(jgraph.batch_iterator(jtrain, BATCH, nc, ec, dense_m=M))
    variables = _variables(_jnet("dense"), example)
    return (jtrain, jval, [_port(g) for g in jtrain],
            [_port(g) for g in jval], variables)


def _base_spec(data, layout="dense", **fit_kw):
    jtrain, _, train, val, variables = data
    targets = np.stack([g.target for g in jtrain])
    spec = _spec(layout, variables, targets, train=train, val=val)
    spec["fit"] = dict(epochs=EPOCHS, batch_size=BATCH, seed=3,
                       dense_m=M if layout == "dense" else None, **fit_kw)
    return spec


def _skewed_shards(train, val):
    """Rank 0 the smaller half of each split by atoms, rank 1 the larger:
    shards whose size classes differ."""
    def halves(gs):
        order = sorted(range(len(gs)), key=lambda i: gs[i].num_nodes)
        half = len(gs) // 2
        return ([gs[i] for i in order[:half]], [gs[i] for i in order[half:]])

    (t0, t1), (v0, v1) = halves(train), halves(val)
    return [(t0, v0), (t1, v1)]


@pytest.fixture(scope="module")
def dense_runs(data, tmp_path_factory):
    """One pair of ranks, one run after another: keyed by run name."""
    tmp = tmp_path_factory.mktemp("dp_driver")
    _, _, train, val, _ = data
    runs = {
        "scan": {"fit": dict(scan_epochs=True)},
        "pack_once": {"fit": dict(pack_once=True)},
        "buckets3": {"fit": dict(scan_epochs=True, buckets=3)},
        "skewed": {"fit": dict(scan_epochs=True, buckets=3),
                   "shards": _skewed_shards(train, val)},
        "nan": {"fit": dict(scan_epochs=True, guard=True),
                "faults": {1: "nan_batch=1"}},
        "low_budget": {"fit": dict(scan_epochs=True), "low_budget": 1},
        "preempted": {"fit": dict(scan_epochs=True, epochs=3),
                      "preempt": {1: 5}, "ckpt": str(tmp / "ck")},
        "resumed": {"fit": dict(scan_epochs=True, start_epoch=1),
                    "restore": str(tmp / "ck")},
        "resumed_again": {"fit": dict(scan_epochs=True, start_epoch=1),
                          "restore": str(tmp / "ck")},
    }
    spec = _base_spec(data)
    spec["runs"] = list(runs.values())
    outs = _run_ranks(tmp, spec)
    return {name: [outs[r][i] for r in range(2)]
            for i, name in enumerate(runs)}


def _metrics(hist):
    return [(h["train"]["loss"], h["val"]["mae"]) for h in hist]


def _close_history(got, want, rel=REL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["train"]["steps"] == w["train"]["steps"]
        for part, key in (("train", "loss"), ("val", "mae")):
            assert g[part][key] == pytest.approx(w[part][key], rel=rel), \
                (g["epoch"], part, key)


def _same_trace(a, b) -> bool:
    return len(a) == len(b) and all(
        ka == kb and np.array_equal(ia, ib) for (ka, ia), (kb, ib) in zip(a, b))


def _ranks_agree(pair):
    a, b = pair
    assert a["dp"]["digests"] == b["dp"]["digests"]
    assert a["digest"] == b["digest"]
    assert _metrics(a["history"]) == _metrics(b["history"])


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


def _run_order(sched, weighted):
    """The chunks of a JAX schedule in its ``_drive`` order: the queues
    by the predrawn picks (or round-robin), then the tails round-robin."""
    queues, tails, _, pick_order = sched
    out = []

    def run(entries, by_pick):
        qs = [[k, collections.deque(ch)] for k, _, ch in entries]
        by_index, live, rr = list(qs), list(qs), 0
        picks = iter(pick_order)
        while live:
            if by_pick and pick_order:
                entry = by_index[next(picks)]
            else:
                entry = live[rr % len(live)]
                rr += 1
            out.append((entry[0], np.asarray(entry[1].popleft())))
            if not entry[1]:
                live.remove(entry)

    run(queues, weighted)
    run(tails, False)
    return out


def test_driver_trace_is_the_jax_schedule_on_every_rank(dense_runs):
    """Three size classes: both ranks run the same chunks, and they are
    the JAX ``_build_sched`` draws from the same group sizes and
    generator state, train and eval, epoch for epoch."""
    r0, r1 = dense_runs["buckets3"]
    assert r0["groups"] == r1["groups"]
    assert len(r0["groups"][0]) > 1  # several train groups: weighted picks
    assert _same_trace(r0["trace"], r1["trace"])
    _ranks_agree(dense_runs["buckets3"])
    jd = JDriver.__new__(JDriver)
    jd._rng = np.random.default_rng()
    jd._rng.bit_generator.state = r0["rng"]
    train_groups, val_groups = ({k: np.zeros((n, 1)) for k, n in g}
                                for g in r0["groups"])
    first = jd._build_sched(train_groups, True, True)
    later = jd._build_sched(train_groups, True, False)
    evals = _run_order(jd._build_sched(val_groups, False, True), False)
    want = (_run_order(first, False) + evals + _run_order(later, True)
            + evals)
    got = r0["trace"]
    assert len(got) == len(want)
    for (gk, gi), (wk, wi) in zip(got, want):
        assert gk == wk
        np.testing.assert_array_equal(gi, wi)


# ---------------------------------------------------------------------------
# against the JAX driver over make_parallel_train_step
# ---------------------------------------------------------------------------


def _jax_batch(b):
    return jgraph.GraphBatch(**{
        k: None if (v := getattr(b, k)) is None else v.numpy()
        for k in jgraph.GraphBatch.__dataclass_fields__})


def test_dp_driver_matches_the_jax_driver_on_a_two_device_mesh(
        data, dense_runs):
    jtrain, _, _, _, variables = data
    r0, r1 = dense_runs["scan"]
    _ranks_agree(dense_runs["scan"])
    assert len(r0["groups"][0]) == 1 and r0["graphs"]["replays"] == 0

    def stacks(key):
        return [jpar.stack_batches([_jax_batch(a), _jax_batch(b)])
                for a, b in zip(r0[key], r1[key], strict=True)]

    mesh = make_mesh(2)
    rng = np.random.default_rng()
    rng.bit_generator.state = r0["rng"]
    assert r1["rng"] == r0["rng"]
    drv = JDriver(jpar.make_parallel_train_step(mesh),
                  jpar.make_parallel_eval_step(mesh), stacks("train_in"),
                  stacks("val_in"), rng,
                  stage=lambda t: shard_scan_stack(t, mesh))
    jnet = _jnet("dense")
    targets = np.stack([g.target for g in jtrain])
    jstate = jpar.replicate_state(_jstate(jnet, variables, targets), mesh)
    for epoch, got in enumerate(r0["history"]):
        jstate, tm, vm = drv.run_epoch_pair(jstate, first=epoch == 0)
        assert got["train"]["steps"] == tm["steps"]
        assert got["train"]["loss"] == pytest.approx(tm["loss"], rel=REL)
        assert got["val"]["mae"] == pytest.approx(vm["mae"], rel=REL)
    want = _flat(jax.device_get(jstate.variables()))
    from cgnn_tpu_torch import convert

    params = _flat(convert.to_flax_variables(r0["state"]))
    assert sorted(params) == sorted(want)
    for path, a in params.items():
        np.testing.assert_allclose(a, want[path], rtol=0, atol=1e-5,
                                   err_msg=path)


def test_dp_driver_matches_the_dp_pack_once_loop(dense_runs):
    """One shape group: the driver's steps are the pack-once per-step
    loop's, batch for batch, on both ranks."""
    _ranks_agree(dense_runs["pack_once"])
    scan, loop_ = dense_runs["scan"][0], dense_runs["pack_once"][0]
    _close_history(scan["history"][:1], loop_["history"][:1])
    _close_history(scan["history"], loop_["history"])
    assert scan["edge_bytes"] == loop_["edge_bytes"] > 0


def test_skewed_size_classes_agree_without_a_hang(dense_runs):
    """Rank 0 holds the small structures, rank 1 the large: the classes
    and capacities fitted on the whole split give both the same keys;
    training keeps the shapes both hold at the lesser count, validation
    pads each shape to the greater, a rank without a shape padding it
    from the other's template."""
    pair = dense_runs["skewed"]
    r0, r1 = pair
    _ranks_agree(pair)
    assert r0["groups"] == r1["groups"]
    assert r0["history"][0]["train"]["steps"] == sum(
        n for _, n in r0["groups"][0])
    empty = [sum(float(b.graph_mask.sum()) == 0 for b in r["val_in"])
             for r in pair]
    assert sum(empty) > 0


# ---------------------------------------------------------------------------
# the guard, preemption and the staging fall-back, agreed
# ---------------------------------------------------------------------------


def test_nan_batch_on_one_rank_skips_the_step_on_both(dense_runs):
    """Rank 1's second batch poisoned before staging: it stays staged, so
    both ranks skip one step every epoch, and the rest trains."""
    pair = dense_runs["nan"]
    _ranks_agree(pair)
    for r in pair:
        skipped = [skipped_steps(h["train"]) for h in r["history"]]
        assert skipped == [1] * EPOCHS, skipped
        assert all(np.isfinite(h["train"]["loss"]) for h in r["history"])


def test_preemption_on_one_rank_stops_both_at_one_chunk(dense_runs):
    """Rank 1 alone is asked to stop, mid-epoch: both stop at the same
    chunk boundary (the same trace), save under the last whole epoch,
    and the resumed epoch is the same bits each time it is run."""
    pre = dense_runs["preempted"]
    assert all(r["preempted"] for r in pre)
    assert _same_trace(pre[0]["trace"], pre[1]["trace"])
    assert [h["epoch"] for h in pre[0]["history"]] == [0]
    # epoch 0 whole, then some but not all of epoch 1's chunks
    one = len(dense_runs["resumed"][0]["trace"])
    assert one < len(pre[0]["trace"]) < 2 * one
    assert pre[0]["saves"] == [0, 0]  # epoch 0, then the mid-epoch save
    _ranks_agree(pre)
    res, again = dense_runs["resumed"], dense_runs["resumed_again"]
    _ranks_agree(res)
    assert [h["epoch"] for h in res[0]["history"]] == [1]
    assert res[0]["digest"] == again[0]["digest"]
    for k, v in res[0]["state"].items():
        assert torch.equal(v, again[0]["state"][k]), k


def test_a_low_staging_budget_on_one_rank_falls_back_on_both(dense_runs):
    pair = dense_runs["low_budget"]
    _ranks_agree(pair)
    for r in pair:
        assert r["staging"]["fallback"] == "host_pack_once"
        assert "trace" not in r
    _close_history(pair[0]["history"], dense_runs["pack_once"][0]["history"])


# ---------------------------------------------------------------------------
# graph sharding
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sharded_runs(data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gs_driver")
    out = {}
    for layout in ("dense", "coo"):
        spec = _base_spec(data, layout)
        spec["graph_shards"] = 2
        spec["runs"] = [{"fit": dict(scan_epochs=True)},
                        {"fit": dict(pack_once=True)}]
        run_dir = tmp / layout
        run_dir.mkdir()
        (d0, p0), (d1, p1) = _run_ranks(run_dir, spec)
        out[layout] = {"scan": [d0, d1], "pack_once": [p0, p1]}
    return out


@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_graph_sharded_driver_matches_the_sharded_loop(data, sharded_runs,
                                                       layout):
    runs = sharded_runs[layout]
    for pair in runs.values():
        _ranks_agree(pair)
    scan, loop_ = runs["scan"][0], runs["pack_once"][0]
    assert scan["dp"]["graph_shards"] == 2
    assert scan["graphs"]["captures"] == 0
    _close_history(scan["history"], loop_["history"])
    # each rank stages its strip or chunk: about 1/G of one process's
    _, _, train, val, _ = data
    dense_m = M if layout == "dense" else None
    nc, ec = sharded_caps(*batch_caps(train, BATCH, dense_m), dense_m, 2)
    spec = _base_spec(data, layout)
    from test_torch_parallel import _model_kw

    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.train.normalizer import Normalizer
    from cgnn_tpu_torch.train.state import TrainState, make_optimizer

    net = build_model(ModelConfig(**_model_kw(layout)), DataConfig(**DATA),
                      device="cpu")
    net.load_state_dict(spec["state_dict"])
    state = TrainState(net, make_optimizer(net.parameters(), **OPT),
                       Normalizer.fit(spec["targets"], device="cpu"))
    _, one = fit(state, train, val, device="cpu", log_fn=lambda *a: None,
                 scan_epochs=True, node_cap=nc, edge_cap=ec,
                 **dict(spec["fit"], epochs=1))
    for r in runs["scan"]:
        share = r["edge_bytes"] / one["edge_bytes"]
        assert 0 < share <= 0.5 + 0.05, share

