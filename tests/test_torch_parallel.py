"""The port's data-parallel training (``cgnn_tpu_torch/parallel``) on the
CPU, two processes over gloo, against the JAX package's
``make_parallel_train_step`` / ``make_parallel_eval_step`` on a 2-device
mesh of the conftest's host CPU devices, and against its own one-process
step.

Every multi-process case starts its ranks as subprocesses (a worker
script that imports torch and the port only), each on a free port, and
kills them past its own timeout, so a hung collective fails one test
instead of the suite.

Tolerances, with their reasons: the 3-step trajectory is held as
tests/test_torch_train.py holds its f32 trajectory (losses rel 1e-4,
every parameter and running statistic rtol 2e-3 / atol 1e-4: f32
roundoff through the convs and the BN backward, here with the averages
taken in another order); the eval sums rel 1e-4 (the f32 model's output
tolerance). The port's own two ranks, and a replicated batch against
the one-process step, are held bit for bit: a SUM of two equal values
halved is exact.
"""

import dataclasses
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cgnn_tpu import parallel as jpar
from cgnn_tpu.data import graph as jgraph
from cgnn_tpu.data.dataset import FeaturizeConfig, load_synthetic
from cgnn_tpu.models import CrystalGraphConvNet as JNet
from cgnn_tpu.parallel.mesh import make_mesh
from cgnn_tpu.train.normalizer import Normalizer as JNormalizer
from cgnn_tpu.train.state import TrainState as JTrainState
from cgnn_tpu.train.state import make_optimizer as jmake_optimizer
from cgnn_tpu.train.step import make_eval_step as jmake_eval_step
from cgnn_tpu_torch import convert
from cgnn_tpu_torch.data import graph as tgraph
from cgnn_tpu_torch.data import invariants as tinv
from cgnn_tpu_torch.parallel import dist
from cgnn_tpu_torch.parallel.data_parallel import (
    empty_batch_like,
    parallel_batches,
    stack_batches,
)
from cgnn_tpu_torch.resilience.faultinject import poison_nan

ROOT = Path(__file__).resolve().parents[1]
M = 8
SMALL = dict(atom_fea_len=16, n_conv=2, h_fea_len=24)
DATA = dict(radius=5.0, max_num_nbr=M)
OPT = dict(optim="sgd", lr=0.05, momentum=0.9, lr_milestones=[2])
TRAJ_TOL = dict(rtol=2e-3, atol=1e-4)
RANK_TIMEOUT_S = 240

# the ranks' program: python -c WORKER rank world port spec out
WORKER = r'''
import sys
import torch
from cgnn_tpu_torch.parallel import dist


def new_state(spec):
    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.train.normalizer import Normalizer
    from cgnn_tpu_torch.train.state import TrainState, make_optimizer

    net = build_model(ModelConfig(**spec["model"]),
                      DataConfig(**spec["data"]), device="cpu")
    net.load_state_dict(spec["state_dict"])
    return TrainState(net, make_optimizer(net.parameters(), **spec["opt"]),
                      Normalizer.fit(spec["targets"], device="cpu"))


def train(spec, rank, world):
    from cgnn_tpu_torch.parallel import (
        make_parallel_train_step, replicate_state, state_digest)

    outs = []
    for run in spec["runs"]:
        state = replicate_state(new_state(spec))
        step = make_parallel_train_step(guard=spec.get("guard", False))
        metrics = [{k: float(v) for k, v in step(state, b).items()}
                   for b in run[rank]]
        outs.append({"state": {k: v.clone() for k, v in
                               state.model.state_dict().items()},
                     "metrics": metrics,
                     "count": int(state.optimizer.tensors()[0]),
                     "digest": state_digest(state)})
    return outs


def evaluate(spec, rank, world):
    from cgnn_tpu_torch.parallel import make_parallel_eval_step

    state = new_state(spec)
    step = make_parallel_eval_step()
    return [{k: float(v) for k, v in step(state, b).items()}
            for b in spec["batches"][rank]]


def coordinate(spec, rank, world):
    import os

    class Dir:
        def is_committed(self, name):
            return os.path.exists(os.path.join(spec["dir"], name))

    coord = dist.ReloadCoordinator(Dir(), visibility_timeout_s=20)
    dist.barrier("start")
    return {"min": dist.min_over_hosts(10 + rank),
            "max": dist.max_over_hosts(10 + rank),
            "str": dist.broadcast_str(f"from process {rank}: é"),
            "empty": dist.broadcast_str(""),
            "agreed": coord("ckpt-00000001" if rank == 0 else None),
            "idle": coord(None if rank == 0 else "ckpt-00000001"),
            "shard": dist.host_shard(list(range(7)))}


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    spec = torch.load(sys.argv[4], weights_only=False)
    dist.initialize(f"localhost:{port}", world, rank, backend="gloo",
                    timeout_s=60, log_fn=lambda *a: None)
    try:
        out = {"train": train, "eval": evaluate,
               "coord": coordinate}[spec["mode"]](spec, rank, world)
    finally:
        dist.shutdown()
    torch.save(out, sys.argv[5])


main()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CGNN_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    # two threads a rank: the suite runs files side by side
    env.update({"OMP_NUM_THREADS": "2"}, **extra)
    return env


def _wait_all(procs, timeout):
    """Each process's output; every one killed past ``timeout``."""
    try:
        return [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


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


def _port(g):
    return tgraph.CrystalGraph(g.atom_fea, g.edge_fea, g.centers,
                               g.neighbors, g.target)


def _batches(layout, n=60, batch=10):
    """The same shuffled training batches on both sides."""
    graphs = load_synthetic(n, FeaturizeConfig(**DATA), seed=8, max_atoms=6)
    dense_m = M if layout == "dense" else None
    nc, ec = jgraph.capacities_for(graphs, batch, dense_m=dense_m,
                                   snug=True)
    jb = list(jgraph.batch_iterator(graphs, batch, nc, ec, dense_m=dense_m,
                                    snug=True, shuffle=True,
                                    rng=np.random.default_rng(1)))
    tb = list(tgraph.batch_iterator([_port(g) for g in graphs], batch, nc,
                                    ec, dense_m=dense_m, snug=True,
                                    shuffle=True,
                                    rng=np.random.default_rng(1)))
    return jb, tb, np.stack([g.target for g in graphs])


def _jnet(layout):
    if layout == "dense":
        return JNet(**SMALL, dense_m=M)
    return JNet(**SMALL, aggregation_impl="xla")


def _model_kw(layout):
    return (dict(SMALL, dense_m=M) if layout == "dense"
            else dict(SMALL, dense_m=0, aggregation="xla"))


def _variables(jnet, jb, seed=0):
    v = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.key(0), jb))
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    rng = np.random.default_rng(seed)
    for conv in v["batch_stats"].values():
        for bn in conv.values():
            bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(
                np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(
                np.float32)
    return v


def _jstate(jnet, variables, targets):
    tx = jmake_optimizer(**OPT)
    return JTrainState(
        step=jax.numpy.zeros((), jax.numpy.int32),
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        normalizer=JNormalizer.fit(targets), rng=jax.random.key(0),
        apply_fn=jnet.apply, tx=tx)


def _spec(layout, variables, targets, **kw):
    return dict(model=_model_kw(layout), data=DATA,
                state_dict=convert.from_flax_variables(variables),
                targets=targets, opt=OPT, **kw)


def _flat(tree):
    return dict(convert.flatten(jax.tree_util.tree_map(np.asarray, tree)))


def _assert_bit_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

STEPS = 3


@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_dp_step_matches_jax_parallel_train_step(layout, tmp_path):
    """Rank r fed row r of each step, 3 chained SGD steps, against the
    JAX shard_map step on make_mesh(2): parameters, running statistics
    and the summed metrics."""
    jb, tb, targets = _batches(layout)
    assert len(jb) >= 2 * STEPS
    jnet = _jnet(layout)
    variables = _variables(jnet, jb[0])
    mesh = make_mesh(2)
    jstep = jpar.make_parallel_train_step(mesh)
    jstate = jpar.replicate_state(_jstate(jnet, variables, targets), mesh)
    want_m = []
    for i in range(STEPS):
        stacked = jpar.shard_leading_axis(
            jpar.stack_batches([jb[2 * i], jb[2 * i + 1]]), mesh)
        jstate, m = jstep(jstate, stacked)
        want_m.append({k: float(v) for k, v in jax.device_get(m).items()})
    run = [[tb[2 * i + r] for i in range(STEPS)] for r in range(2)]
    outs = _run_ranks(tmp_path, _spec(layout, variables, targets,
                                      mode="train", runs=[run]))
    r0, r1 = outs[0][0], outs[1][0]
    assert r0["digest"] == r1["digest"]
    _assert_bit_equal(r0["state"], r1["state"])
    assert r0["count"] == STEPS
    for got, want in zip(r0["metrics"], want_m):
        for k in ("loss_sum", "mae_sum", "count"):
            assert got[k] == pytest.approx(want[k], rel=1e-4), k
    want = _flat(jax.device_get(jstate.variables()))
    got = _flat(convert.to_flax_variables(r0["state"]))
    assert sorted(got) == sorted(want)
    for path, a in got.items():
        np.testing.assert_allclose(a, want[path], **TRAJ_TOL, err_msg=path)


@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_replicated_batch_matches_single_process_step(layout, tmp_path):
    """The JAX ``test_replicated_batch_matches_single_device`` analogue:
    the same batch on both ranks is the one-process step, bit for bit,
    with twice its metric sums."""
    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.train.normalizer import Normalizer
    from cgnn_tpu_torch.train.state import TrainState, make_optimizer
    from cgnn_tpu_torch.train.step import make_train_step

    jb, tb, targets = _batches(layout)
    variables = _variables(_jnet(layout), jb[0])
    spec = _spec(layout, variables, targets, mode="train",
                 runs=[[tb[:2], tb[:2]]])
    net = build_model(ModelConfig(**spec["model"]), DataConfig(**DATA),
                      device="cpu")
    net.load_state_dict(spec["state_dict"])
    state = TrainState(net, make_optimizer(net.parameters(), **OPT),
                       Normalizer.fit(targets, device="cpu"))
    step = make_train_step()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the ranks' count: CPU sums split by thread
    try:
        want_m = [step(state, b) for b in tb[:2]]
    finally:
        torch.set_num_threads(threads)
    out = _run_ranks(tmp_path, spec)[0][0]
    _assert_bit_equal(out["state"], net.state_dict())
    for got, want in zip(out["metrics"], want_m):
        for k, v in want.items():
            assert got[k] == 2 * float(v), k


def test_nan_batch_on_one_rank_skips_the_step_on_every_rank(tmp_path):
    """A NaN batch on rank 1 only: the guard's verdict reads the summed
    loss and the averaged state, so both ranks skip that step and stay
    bit-equal, and the run equals one that never took the step."""
    jb, tb, targets = _batches("dense")
    variables = _variables(_jnet("dense"), jb[0])
    poisoned = [[tb[0], tb[2], tb[4]], [tb[1], poison_nan(tb[3]), tb[5]]]
    without = [[tb[0], tb[4]], [tb[1], tb[5]]]
    outs = _run_ranks(tmp_path, _spec("dense", variables, targets,
                                      mode="train", guard=True,
                                      runs=[poisoned, without]))
    for rank_out in outs:
        skipped = [m["guard_skipped_sum"] for m in rank_out[0]["metrics"]]
        assert skipped == [0.0, 1.0, 0.0]
        assert rank_out[0]["metrics"][1]["loss_sum"] == 0.0
        assert rank_out[0]["count"] == 2
        _assert_bit_equal(rank_out[0]["state"], rank_out[1]["state"])
    assert outs[0][0]["digest"] == outs[1][0]["digest"]
    _assert_bit_equal(outs[0][0]["state"], outs[1][0]["state"])


# ---------------------------------------------------------------------------
# eval with empty_batch_like padding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_eval_padding_on_one_rank_matches_jax(layout, tmp_path):
    """Rank 0 a real batch, rank 1 its ``empty_batch_like``: the summed
    sums equal the JAX padded eval's, and the one-process eval's bit for
    bit (the padding adds exact zeros)."""
    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.train.normalizer import Normalizer
    from cgnn_tpu_torch.train.state import TrainState, make_optimizer
    from cgnn_tpu_torch.train.step import make_eval_step

    graphs = load_synthetic(12, FeaturizeConfig(**DATA), seed=9,
                            max_atoms=6)
    dense_m = M if layout == "dense" else None
    nc, ec = jgraph.capacities_for(graphs, 12, dense_m=dense_m, snug=True)
    jb = next(jgraph.batch_iterator(graphs, 12, nc + 8, ec + 8 * M,
                                    dense_m=dense_m, in_cap=0))
    tb = next(tgraph.batch_iterator([_port(g) for g in graphs], 12, nc + 8,
                                    ec + 8 * M, dense_m=dense_m, in_cap=0))
    targets = np.stack([g.target for g in graphs])
    jnet = _jnet(layout)
    variables = _variables(jnet, jb)
    mesh = make_mesh(2)
    jstate = _jstate(jnet, variables, targets)
    want = jax.device_get(jpar.make_parallel_eval_step(mesh)(
        jpar.replicate_state(jstate, mesh), jpar.shard_leading_axis(
            jpar.stack_batches([jb, jpar.empty_batch_like(jb)]), mesh)))
    spec = _spec(layout, variables, targets, mode="eval",
                 batches=[[tb], [empty_batch_like(tb)]])
    outs = _run_ranks(tmp_path, spec)
    assert outs[0] == outs[1]
    for k, v in want.items():
        assert outs[0][0][k] == pytest.approx(float(v), rel=1e-4), k
    net = build_model(ModelConfig(**spec["model"]), DataConfig(**DATA),
                      device="cpu")
    net.load_state_dict(spec["state_dict"])
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the ranks' count: CPU sums split by thread
    try:
        single = make_eval_step()(TrainState(
            net, make_optimizer(net.parameters()),
            Normalizer.fit(targets, device="cpu")), tb)
    finally:
        torch.set_num_threads(threads)
    assert outs[0][0] == {k: float(v) for k, v in single.items()}
    assert float(jax.device_get(jmake_eval_step()(jstate, jb))["count"]) \
        == outs[0][0]["count"]


# ---------------------------------------------------------------------------
# the per-rank batch lists and the empty-batch contract (no processes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_empty_batch_like_matches_jax_and_passes_the_checks(layout):
    graphs = load_synthetic(10, FeaturizeConfig(**DATA), seed=3,
                            max_atoms=6)
    dense_m = M if layout == "dense" else None
    nc, ec = jgraph.capacities_for(graphs, 10, dense_m=dense_m, snug=True)
    jb = next(jgraph.batch_iterator(graphs, 10, nc, ec, dense_m=dense_m))
    tb = next(tgraph.batch_iterator([_port(g) for g in graphs], 10, nc, ec,
                                    dense_m=dense_m))
    want = jpar.empty_batch_like(jb)
    got = empty_batch_like(tb)
    for f in dataclasses.fields(got):
        t = getattr(got, f.name)
        if t is None or f.name in tgraph.PORT_FIELDS:
            continue
        assert t.dtype == getattr(tb, f.name).dtype, f.name
        np.testing.assert_array_equal(t.numpy(), np.asarray(
            getattr(want, f.name)), err_msg=f.name)
    tinv.check_batch(got, dense_m)
    with pytest.raises(tinv.BatchInvariantError, match="zero real graphs"):
        tinv.check_any(got, dense_m, train=True)
    with pytest.raises(tinv.BatchInvariantError, match="device row 1"):
        tinv.check_any(stack_batches([tb, got]), dense_m, train=True)
    tinv.check_any(tb, dense_m, train=True)


def test_parallel_batches_cut_training_and_pad_eval():
    graphs = [_port(g) for g in load_synthetic(
        30, FeaturizeConfig(**DATA), seed=8, max_atoms=6)]
    nc, ec = tgraph.capacities_for(graphs, 4, dense_m=M, snug=True)
    packed = list(tgraph.batch_iterator(graphs, 4, nc, ec, dense_m=M))
    assert len(packed) >= 4
    cut = parallel_batches(iter(packed), train=True, dense_m=M, steps=2)
    assert cut == packed[:2]
    padded = parallel_batches(iter(packed), train=False, dense_m=M,
                              steps=len(packed) + 2)
    assert padded[:len(packed)] == packed
    assert all(float(b.graph_mask.sum()) == 0 for b in padded[-2:])
    assert all(b.nodes.shape == packed[-1].nodes.shape for b in padded)
    # one process: the counts are its own
    assert parallel_batches(iter(packed), train=True) == packed
    with pytest.raises(ValueError, match="no validation batch"):
        parallel_batches(iter([]), train=False, steps=1)


@pytest.mark.parametrize("n,world", [(0, 2), (7, 2), (10, 3), (5, 8)])
def test_host_shard_is_disjoint_and_complete(n, world):
    seq = list(range(n))
    shards = [dist.host_shard(seq, r, world) for r in range(world)]
    assert sorted(x for s in shards for x in s) == seq
    assert max(map(len, shards)) - min(map(len, shards)) <= 1
    assert dist.host_shard(seq) == seq  # one process: the whole
    with pytest.raises(ValueError):
        dist.host_shard(seq, world, world)


def test_coordination_helpers_with_two_ranks(tmp_path):
    (tmp_path / "ckpt-00000001").mkdir()
    outs = _run_ranks(tmp_path, {"mode": "coord", "dir": str(tmp_path)})
    for r, out in enumerate(outs):
        assert (out["min"], out["max"]) == (10, 11)
        assert out["str"] == "from process 0: é"
        assert out["empty"] == ""
        assert out["agreed"] == "ckpt-00000001"
        assert out["idle"] is None
        assert out["shard"] == list(range(7))[r::2]


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

ENTRY = ["--device", "cpu", "--data-parallel", "--synthetic", "48",
         "--epochs", "2", "-b", "8", "--atom-fea-len", "16",
         "--h-fea-len", "24", "--n-conv", "2", "--max-num-nbr", "8",
         "--radius", "5"]


def _entry_ranks(tmp_path, extra=(), rank_env=None, world=2):
    """``world`` ranks of the train entry point with the environment
    triple, each with its own --ckpt-dir and --out-dir -> their
    outputs."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = _child_env(**dist.env_for(f"localhost:{port}", world, r),
                         **(rank_env or {}).get(r, {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cgnn_tpu_torch.train", *ENTRY, *extra,
             "--ckpt-dir", str(tmp_path / f"ck{r}"),
             "--out-dir", str(tmp_path / f"out{r}")],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = _wait_all(procs, RANK_TIMEOUT_S)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return logs


def _summary(log):
    import json

    return json.loads(next(line for line in log.splitlines()
                           if line.startswith("train: "))[7:])


@pytest.mark.parametrize("world", [2, 3])
def test_entry_point_ranks_stay_bit_equal_and_only_process_0_commits(
        tmp_path, world):
    logs = _entry_ranks(tmp_path, world=world)
    s0, *rest = map(_summary, logs)
    assert len(s0["dp"]["digests"]) == 2
    assert s0["dp"]["world"] == world
    for r, s in enumerate(rest, 1):
        assert s["dp"]["rank"] == r
        assert s["dp"]["digests"] == s0["dp"]["digests"]
        for key in ("train_steps", "eval_steps", "train_loss",
                    "val_metric", "test"):
            assert s[key] == s0[key], key
        assert not (tmp_path / f"ck{r}").exists()
        assert not (tmp_path / f"out{r}").exists()
        assert f"process {r} skips checkpoint commits" in logs[r]
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ck0"))
    assert mgr.exists() and mgr.read_meta()["epoch"] == 1
    assert (tmp_path / "out0" / "params.npz").exists()


def test_entry_point_nan_batch_on_one_rank(tmp_path):
    logs = _entry_ranks(tmp_path, rank_env={1: {
        "CGNN_TPU_FAULTS": "nan_batch=1"}})
    s0, s1 = map(_summary, logs)
    assert "FAULT INJECTION ACTIVE" in logs[1]
    assert s0["dp"]["digests"] == s1["dp"]["digests"]
    assert s0["test"] == s1["test"]
    assert all(np.isfinite(v) for v in (s0["test"]["loss"],
                                        s0["test"]["mae"]))
    assert s0["guard_skipped"] == s1["guard_skipped"]
    assert s0["guard_skipped"][0] == 1 and sum(s0["guard_skipped"]) == 1


def test_entry_point_resume_and_rollback_agree_across_ranks(tmp_path):
    """``--resume auto``: process 0 restores and every rank continues at
    its epoch; ``--guard rollback``: a NaN batch on rank 1 past the
    threshold rolls both ranks back to process 0's save with the rate
    cut, and they stay bit-equal."""
    _entry_ranks(tmp_path)
    logs = _entry_ranks(
        tmp_path, ["--epochs", "4", "--resume", "auto", "--guard",
                   "rollback", "--guard-max-skips", "1"],
        rank_env={1: {"CGNN_TPU_FAULTS": "nan_batch=3"}})
    s0, s1 = map(_summary, logs)
    assert "resumed from" in logs[0] and s0["epochs"] == [2, 3]
    assert s0["dp"]["digests"] == s1["dp"]["digests"]
    assert s0["guard_skipped"] == s1["guard_skipped"] == [0, 1]
    for log in logs:
        assert "rolled back to checkpoint epoch 2 with lr x0.5" in log


def test_launch_local_runs_two_workers(tmp_path, monkeypatch, capfd):
    from cgnn_tpu_torch.train.__main__ import launch_local

    for k in [k for k in os.environ if k.startswith("CGNN_TPU_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.chdir(tmp_path)
    rc = launch_local([*ENTRY, "--epochs", "1", "--ckpt-dir",
                       str(tmp_path / "ck"), "--out-dir",
                       str(tmp_path / "out")], 2, timeout=RANK_TIMEOUT_S)
    out = capfd.readouterr().out
    assert rc == 0, out
    digests = dict(re.findall(
        r"dp: process (\d)/2 epoch 0 digest ([0-9a-f]{64})", out))
    assert sorted(digests) == ["0", "1"] and len(set(digests.values())) == 1
    assert (tmp_path / "out" / "params.npz").exists()
    assert "2 workers exited [0, 0]" in out


# ---------------------------------------------------------------------------
# the refusals (exit 2, before any process group starts)
# ---------------------------------------------------------------------------

# host-local staging: trained when every rank is on one host, refused
# (train.py's reason) when the ranks span hosts
HOST_LOCAL = {"device_resident": ["--device-resident"],
              "pack_once": ["--pack-once"],
              "scan_epochs": ["--scan-epochs"]}
MULTI_HOST = ("multi-host DP runs the per-step loop; drop "
              "--scan-epochs/--device-resident/--pack-once")
REFUSALS = {
    "triple_without_dp": ([], "requires --data-parallel"),
    "device_resident": (["--data-parallel", "--device-resident"],
                        MULTI_HOST),
    "pack_once": (["--data-parallel", "--pack-once"], MULTI_HOST),
    "scan_epochs": (["--data-parallel", "--scan-epochs"], MULTI_HOST),
    "compact_on": (["--data-parallel", "--compact-staging", "on"],
                   "--compact-staging on is not yet supported"),
    "force": (["--data-parallel", "--graph-shards", "2", "--task",
               "force"], "--graph-shards is not supported for --task force"),
}
# the entry point with this rank's host name faked: python -c ... host argv
ON_HOST = ("import socket, sys; socket.gethostname = lambda: sys.argv[1]; "
           "from cgnn_tpu_torch.train.__main__ import main; "
           "sys.exit(main(sys.argv[2:]))")


def _ranks_on_hosts(tmp_path, argv, hosts):
    """Ranks of the train entry point, rank r on host ``hosts[r]`` ->
    (exit codes, outputs)."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", ON_HOST, host, *argv],
        cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=_child_env(**dist.env_for(f"localhost:{port}", len(hosts), r)),
        text=True) for r, host in enumerate(hosts)]
    logs = _wait_all(procs, RANK_TIMEOUT_S)
    return [p.returncode for p in procs], logs


@pytest.mark.parametrize("case", list(REFUSALS))
def test_entry_point_refusals_exit_2(case, monkeypatch, capsys, tmp_path):
    """Exit 2 with train.py's reason: before any process group starts,
    or, for the host-local staging flags, on every rank once the group
    has found that the ranks span hosts (host names faked per rank)."""
    from cgnn_tpu_torch.train.__main__ import main

    argv, reason = REFUSALS[case]
    if case in HOST_LOCAL:
        codes, logs = _ranks_on_hosts(
            tmp_path, ["--device", "cpu", "--synthetic", "8", *argv],
            ["node-a", "node-b"])
        assert codes == [2, 2], logs
        assert all(reason in log for log in logs), logs
        return
    for k, v in dist.env_for("localhost:1", 2, 1).items():
        monkeypatch.setenv(k, v)
    assert main(["--device", "cpu", "--synthetic", "8", *argv]) == 2
    assert reason in capsys.readouterr().err
    assert not dist.active()


@pytest.mark.parametrize("case", list(HOST_LOCAL))
def test_host_local_flags_train_two_ranks_on_one_host(case, tmp_path):
    """``--device-resident``, ``--pack-once`` and ``--scan-epochs`` train
    two ranks on one host to the end, bit-equal after every epoch."""
    logs = _entry_ranks(tmp_path, ["--buckets", "2", *HOST_LOCAL[case]])
    s0, s1 = map(_summary, logs)
    assert len(s0["dp"]["digests"]) == 2
    assert s0["dp"]["digests"] == s1["dp"]["digests"]
    for key in ("train_steps", "eval_steps", "train_loss", "val_metric"):
        assert s0[key] == s1[key], key
    staging = s0["staging"]
    assert "agree_s" in staging  # the lists agreed once
    assert ("staged_bytes" in staging) == (case != "pack_once")
    assert "fallback" not in staging
    assert (tmp_path / "out0" / "params.npz").exists()


def test_more_ranks_than_cards_needs_gloo(monkeypatch, capsys):
    from cgnn_tpu_torch.train.__main__ import main

    for k, v in dist.env_for("localhost:1", 2, 0).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr("cgnn_tpu_torch.parallel.mesh.device_count",
                        lambda: 1)
    assert main(["--data-parallel", "--synthetic", "8"]) == 2
    err = capsys.readouterr().err
    assert "2 ranks but 1 visible CUDA card(s)" in err
    assert "--dist-backend gloo" in err


@pytest.mark.parametrize("requested,device_type,world,cards,want", [
    ("auto", "cpu", 4, 0, "gloo"),
    ("gloo", "cpu", 2, 0, "gloo"),
    ("auto", "cuda", 2, 2, "nccl"),
    ("gloo", "cuda", 2, 1, "gloo"),
    ("auto", "cuda", 2, 1, None),
])
def test_resolve_backend(requested, device_type, world, cards, want):
    backend, why = dist.resolve_backend(requested, device_type, world, cards)
    assert backend == want
    assert (why == "") == (want is not None)


def test_dist_backend_takes_auto_or_gloo(capsys):
    from cgnn_tpu_torch.train.__main__ import build_parser

    assert build_parser().parse_args([]).dist_backend == "auto"
    with pytest.raises(SystemExit) as e:
        build_parser().parse_args(["--dist-backend", "nccl"])
    assert e.value.code == 2
    assert "invalid choice: 'nccl'" in capsys.readouterr().err


def test_malformed_triple_exits_2(monkeypatch, capsys):
    from cgnn_tpu_torch.train.__main__ import main

    monkeypatch.setenv("CGNN_TPU_COORDINATOR", "localhost:1")
    monkeypatch.delenv("CGNN_TPU_NUM_PROCESSES", raising=False)
    assert main(["--device", "cpu", "--data-parallel"]) == 2
    assert "all three configure" in capsys.readouterr().err


def test_data_parallel_with_one_process_is_the_plain_fit(tmp_path, capsys):
    from cgnn_tpu_torch.train.__main__ import main

    assert main(["--device", "cpu", "--data-parallel", "--synthetic", "24",
                 "--epochs", "1", "-b", "8", "--atom-fea-len", "8",
                 "--h-fea-len", "8", "--n-conv", "1", "--ckpt-dir",
                 str(tmp_path / "ck"), "--out-dir",
                 str(tmp_path / "out")]) == 0
    out = capsys.readouterr().out
    assert "the one-process fit" in out and "[dp x" not in out


def test_dropout_streams_differ_by_rank_and_resume():
    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.parallel.data_parallel import seed_rank_dropout

    cfg = ModelConfig(**SMALL, dense_m=M, classification=True,
                      num_classes=2, dropout=0.5)

    def first_draws(rank, world, start_epoch=0):
        net = build_model(cfg, DataConfig(**DATA), device="cpu",
                          dropout_seed=7)
        before = net.dropout_generator().get_state()
        seed_rank_dropout(net, 7, rank, world, start_epoch)
        kept = torch.equal(net.dropout_generator().get_state(), before)
        return kept, torch.rand(8, generator=net.dropout_generator())

    kept0, a = first_draws(0, 2)
    kept1, b = first_draws(1, 2)
    assert kept0 and not kept1 and not torch.equal(a, b)
    # a resume keeps process 0's restored stream; rank 1's seed moves on
    assert first_draws(0, 2, start_epoch=3)[0]
    _, c = first_draws(1, 2, start_epoch=3)
    assert not torch.equal(b, c)
    regression = build_model(ModelConfig(**SMALL, dense_m=M),
                             DataConfig(**DATA), device="cpu")
    seed_rank_dropout(regression, 7, 1, 2)  # draws nothing: untouched
    assert regression.dropout_seed == 0


def test_parallel_sources_import_neither_jax_nor_the_jax_package():
    import ast

    files = sorted((ROOT / "cgnn_tpu_torch" / "parallel").glob("*.py"))
    assert {f.name for f in files} >= {"__init__.py", "dist.py", "mesh.py",
                                       "data_parallel.py"}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not [n for n in names if n.split(".")[0] in (
                "jax", "jaxlib", "flax", "optax", "cgnn_tpu")], path
