"""Train CGCNN with the port:

    python -m cgnn_tpu_torch.train DATA_DIR --cache graphs.npz --epochs 30
    python -m cgnn_tpu_torch.train --synthetic 400 --epochs 30
    python -m cgnn_tpu_torch.train --synthetic 400 --bf16 --cgconv-impl pallas
    python -m cgnn_tpu_torch.train DATA_DIR --task classification --dropout 0.1
    python -m cgnn_tpu_torch.train DATA_DIR --multi-task-head --n-h 2
    python -m cgnn_tpu_torch.train --device cpu --synthetic 40 --epochs 1
    python -m cgnn_tpu_torch.train --aggregation pallas --synthetic 400
    python -m cgnn_tpu_torch.train --synthetic 400 --epochs 40 --resume auto
    python -m cgnn_tpu_torch.train --task force --synthetic 2048 --md-atoms 21
    python -m cgnn_tpu_torch.train TRAJ_DIR_OR_NPZ --task force --epochs 30
    python -m cgnn_tpu_torch.train --synthetic 400 --data-parallel
    python -m cgnn_tpu_torch.train --synthetic 400 --graph-shards 2

Data, as train.py reads it: ``--cache PATH`` loads a graph cache
(data/cache.py) when PATH exists; otherwise ``--synthetic N`` structures,
or the CIF directory ``DATA_DIR`` (``{id}.cif`` + ``id_prop.csv``)
featurized on ``-j`` worker processes (0: every core; 1: this process),
and ``--cache PATH`` then writes the cache.

Staging and driving, with train.py's rules: ``--buckets K`` packs per
size class (K batch shapes); ``--pack-once`` packs the training batches
once and reshuffles their order each epoch; ``--device-resident`` (which
implies it) stages them on the card once, and selects the epoch driver
(``--scan-epochs``, train/loop.py ``ScanEpochDriver``: every step a
replayed CUDA graph, the JAX schedule, ``--chunk-steps`` its mean chunk)
unless ``--no-scan-epochs`` keeps the per-step loop; both flags together
exit 2. ``--compact-staging`` stages the batches compactly, rebuilt
inside each step: ``auto`` (the default) is on wherever it is supported
(the driver and the dense layout) and says why when the data cannot
stage compactly; ``on`` exits 2 without them.

``--layout`` follows train.py's rules: ``auto`` is the dense layout unless
``--aggregation`` names a COO aggregation; ``--layout dense`` with
``--aggregation``, and ``--cgconv-impl`` or ``--fused-epilogue`` with COO,
exit 2.

Every epoch commits a checkpoint to ``--ckpt-dir`` (train/checkpoint.py;
newest ``--keep-ckpts`` kept, plus the best). ``--resume DIR`` continues
from DIR's newest restorable checkpoint at its epoch + 1; ``--resume
auto`` does so from ``--ckpt-dir`` when it holds one and starts fresh
(saying so) when it holds none. Exit 2, as train.py: a non-empty
directory that cannot be restored (an inference-only checkpoint, which
has no optimizer state, among them), or a meta without ``epoch``.

Fault tolerance, with train.py's flags and defaults
(``cgnn_tpu_torch/resilience``): ``--guard skip`` (the default) skips a
non-finite update on the card, inside the replayed train graph;
``--guard rollback`` also restores the last good checkpoint with the
rate cut by ``--guard-lr-cut`` when ``--guard-max-skips`` steps of an
epoch were skipped, at most ``--guard-max-rollbacks`` times (the cut and
the rollbacks spent are kept in every save's meta and reapplied on
``--resume``); ``--guard off`` does neither. SIGTERM or SIGINT saves a
resumable checkpoint at the next epoch boundary (the next chunk boundary
under the epoch driver) and exits 75 (``--no-preempt-handler`` leaves
the signals alone); ``--resume auto`` then completes the run.
``--debug-nans`` steps eagerly (a captured graph cannot stop at the
first NaN) and raises at the first non-finite module output or backward
op. The ``CGNN_TPU_FAULTS`` variable injects faults
(resilience/faultinject.py) and is announced as ``FAULT INJECTION
ACTIVE``.

Tasks and modes, with train.py's flags: ``--task classification``
(``--num-classes`` log-prob head, NLL loss, accuracy; the first label
column must hold class indices in [0, num_classes), else exit 2 naming
the first bad row; an identity normalizer; the best save is the highest
validation accuracy; the test split's ``class_eval`` line: accuracy and,
for two classes, precision, recall, F1 and AUC), ``--dropout P`` (after
``conv_to_fc``, classification only, its masks drawn from a generator
seeded by ``--seed`` and saved with the optimizer state),
``--multi-task-head`` (one softplus stack a target column, each task's
test MAE printed), ``--bf16`` (bf16 compute with f32 parameters and
statistics, bf16 edge storage; on the card the bf16 kernel instances).
``--task force`` trains the force field (models/forcefield.py: distances
recomputed in the model, ``F = -dE/dr``) on the composite loss
``--energy-weight`` x MSE(E) + ``--force-weight`` x MSE(F)
(train/force_step.py): on ``--synthetic N`` LJ trajectory frames of
``--md-atoms`` atoms jittered by ``--md-jitter``, on a trajectory ``.npz``
or a directory of them as ``DATA_DIR`` (data/trajectory.py; MD17's
R/z/E/F files load unchanged), or on a cache that carries force labels
(one without them exits 2). Its split keeps each trajectory's frames
together (``split_trajectory_groups``); the best save is the lowest
validation force MAE, and the test line adds the energy MAE. With
``--task force``, as train.py: ``--fused-epilogue`` and
``--cgconv-impl`` exit 2 (they fuse BatchNorm, which the force trunk
lacks), and so does ``--compact-staging on``; the port also refuses
``--aggregation pallas``, where the JAX package's force step fails
(``config.FORCE_PALLAS_REFUSAL``). ``--synthetic-oc20 N`` trains on N
OC20-like catalyst slabs (37-255 atoms).

Packing and capacities, with train.py's flags: ``--packing snug`` (the
default: fill-to-capacity batches) or ``ladder`` (batches closed at
``--batch-size`` graphs, headroom/ladder capacities); the training
batches' padding efficiency is logged at the first epoch.
``--node-cap``/``--edge-cap`` (0: auto) replace the computed
capacities; on the dense layout the edge capacity is ``node_cap`` x M,
so ``--edge-cap`` is ignored there with a warning. ``--check-invariants``
validates every batch the iterators pack and the epoch driver stages,
and the cache on load (data/invariants.py); a broken invariant raises
``BatchInvariantError`` naming it, and the run exits non-zero.

Data parallel, with train.py's multi-process rules
(``cgnn_tpu_torch/parallel``): ``--data-parallel`` under the environment
triple ``CGNN_TPU_COORDINATOR`` (``host:port``) /
``CGNN_TPU_NUM_PROCESSES`` / ``CGNN_TPU_PROCESS_ID`` makes this process
one rank: the process group starts before anything touches CUDA
(``--dist-backend auto``: gloo on the CPU, NCCL on CUDA; ``gloo`` for
ranks that share a card; every collective waits at most
``dist.DEFAULT_TIMEOUT_S``), each rank trains on its strided shard of the training and
validation splits with the one-collective step
(``parallel.data_parallel``), the test split is evaluated whole on every
rank, and process 0 alone commits checkpoints and writes ``--out-dir``
(``--resume`` restores there and the ranks take its state). Without the
triple, ``--data-parallel`` starts one worker a visible card with the
triple set (coordinator on localhost); with one card it is the
one-process fit. ``--device-resident`` (with its ``--scan-epochs``
default), ``--scan-epochs`` and ``--pack-once`` run under the triple when
every rank is on one host: each rank packs its shard once and the ranks
agree on the same shape groups (train/loop.py); ``--compact-staging
auto`` is off there. Exit 2, as train.py: the triple without
``--data-parallel`` (or ``--graph-shards``); with it, ``--compact-staging
on``, and ``--scan-epochs``, ``--device-resident`` or ``--pack-once``
when the ranks span hosts (after the process group starts, every rank
alike); and, the port's own, more ranks than cards under NCCL. ``--task
force`` trains data-parallel too (the force step's gradients and
statistics averaged, its metric sums summed).

Graph sharding, with train.py's rules (``cgnn_tpu_torch/parallel/
edge_parallel.py``): ``--graph-shards G`` splits every batch's edge work
over G ranks (dense: node strips; COO: edge chunks), each staging only
its part of the edge leaves; with ``--data-parallel`` the world is D x G
ranks (D the cards // G without the triple, the triple's count // G with
it), rank r with data index r // G and graph index r % G. The host
shards, the shuffles and the dropout streams follow the data index.
Without the triple, ``launch_local`` starts the D·G workers; a graph
group must lie on one host (exit 2 otherwise). Exit 2, as train.py:
``--graph-shards`` with ``--task force``, ``--fused-epilogue`` or
``--cgconv-impl``, ``--buckets`` > 1 on COO, ``--compact-staging
on`` and ``--profile``; a world that G does not divide.

Profiling, as train.py: ``--profile N`` traces N steps after the first
of the first epoch with ``torch.profiler`` into the log dir (train/
loop.py ``profile_wrap``; ``--device-resident`` then keeps the per-step
loop, and an explicit ``--scan-epochs`` logs that it traces nothing).
With telemetry on, SIGUSR2 takes one bounded capture into a
``profile-<stamp>-<nnn>/`` of the log dir (observe/profile.py), and
every exit waits an in-flight capture out.

The flags are train.py's that this entry point serves, with train.py's
defaults. It runs on the CUDA card unless ``--device cpu`` asks for the
CPU (where the kernels' plain versions run); without a card the default
raises. At the end it writes ``params.npz`` + ``meta.json`` to
``--out-dir`` (the JAX layout, convert.save_params), which ``load_server``
serves, and prints the test-split MAE (a classifier's accuracy) and one
``train: {...}`` JSON line (``run_summary``: epoch seconds, step graphs,
the driver's staging, the test metrics).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cgnn_tpu_torch.train",
        description="Train CGCNN with the PyTorch/CUDA port.")
    p.add_argument("root_dir", nargs="?", default=None,
                   help="dataset dir: {id}.cif files + id_prop.csv")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="train on N synthetic crystals instead of root_dir")
    p.add_argument("--synthetic-oc20", type=int, default=0, metavar="N",
                   help="train on N synthetic OC20-like catalyst slabs "
                        "(50-200+ atom graphs)")
    p.add_argument("--cache", type=str, default="",
                   help="graph cache (.npz): loaded if present, else written "
                        "after featurization (python -m "
                        "cgnn_tpu_torch.data.preprocess)")
    p.add_argument("-j", "--workers", type=int, default=0,
                   help="featurization worker processes (0 = all cores)")
    p.add_argument("--task", default="regression",
                   choices=["regression", "classification", "force"])
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0.0,
                   help="dropout after conv_to_fc (classification only)")
    p.add_argument("--multi-task-head", action="store_true",
                   help="per-task MLP stacks over the pooled features "
                        "(multi-target regression)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (f32 parameters and statistics, "
                        "bf16 edge storage)")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--start-epoch", type=int, default=0)
    p.add_argument("-b", "--batch-size", type=int, default=256)
    p.add_argument("--lr", "--learning-rate", type=float, default=0.01,
                   dest="lr")
    p.add_argument("--lr-milestones", type=int, nargs="*", default=[100],
                   help="epochs at which the lr is multiplied by 0.1")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--optim", choices=["SGD", "Adam", "AdamW"], default="SGD")
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint dir to resume from, or 'auto': resume "
                        "from --ckpt-dir when a checkpoint exists there, "
                        "start fresh otherwise")
    p.add_argument("--train-ratio", type=float, default=0.8)
    p.add_argument("--val-ratio", type=float, default=0.1)
    p.add_argument("--atom-fea-len", type=int, default=64)
    p.add_argument("--h-fea-len", type=int, default=128)
    p.add_argument("--n-conv", type=int, default=3)
    p.add_argument("--n-h", type=int, default=1)
    p.add_argument("--max-num-nbr", type=int, default=12)
    p.add_argument("--radius", type=float, default=8.0)
    p.add_argument("--dmin", type=float, default=0.0)
    p.add_argument("--step", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--check-invariants", action="store_true",
                   help="validate every packed batch's GraphBatch "
                        "invariants (sorted centers, mask/slot consistency, "
                        "dense ownership, transpose completeness) host-side "
                        "before it reaches the step; ~free vs device time, "
                        "on by default in the test suite")
    p.add_argument("--node-cap", type=int, default=0, help="0 = auto")
    p.add_argument("--edge-cap", type=int, default=0, help="0 = auto")
    p.add_argument("--packing", choices=["snug", "ladder"], default="snug",
                   help="'snug': fill-to-capacity packing with exact "
                        "batch-count-balanced capacities (~0.99 padding "
                        "efficiency); 'ladder': close batches at "
                        "--batch-size graphs with geometric-ladder "
                        "capacities (round-2 behavior)")
    p.add_argument("--cgconv-impl", choices=["off", "xla", "pallas"],
                   default="off",
                   help="whole-conv fused op; 'pallas' runs the CUDA "
                        "kernels on the card")
    p.add_argument("--fused-epilogue", choices=["off", "xla", "pallas"],
                   default="off",
                   help="fused BN1->gate->sum op; 'pallas' runs the CUDA "
                        "kernels on the card")
    p.add_argument("--aggregation", choices=["xla", "sort", "pallas"],
                   default=None,
                   help="edge aggregation of the flat COO layout; 'pallas' "
                        "runs kernel 6 on the card")
    p.add_argument("--layout", choices=["auto", "dense", "coo"],
                   default="auto",
                   help="edge layout: auto = dense unless --aggregation "
                        "is given")
    p.add_argument("--buckets", type=int, default=1,
                   help="size-class buckets for batching (>1: one batch "
                        "shape, and one step graph, per bucket)")
    p.add_argument("--pack-once", action="store_true",
                   help="pack training batches once and shuffle batch "
                        "order across epochs")
    p.add_argument("--device-resident", action="store_true",
                   help="stage packed batches on the card once and reuse "
                        "them every epoch (implies --pack-once); selects "
                        "--scan-epochs unless --no-scan-epochs")
    p.add_argument("--scan-epochs", action="store_true",
                   help="the epoch driver (implies --device-resident): "
                        "the JAX scan driver's step sequence, every step "
                        "a replayed CUDA graph")
    p.add_argument("--no-scan-epochs", action="store_true",
                   help="keep the per-step loop under --device-resident")
    p.add_argument("--chunk-steps", type=int, default=2, metavar="C",
                   help="the driver's mean chunk (lengths drawn from "
                        "{C/2, C, 2C})")
    p.add_argument("--compact-staging", choices=["auto", "on", "off"],
                   default="auto",
                   help="stage training batches compactly (atoms + "
                        "distances, rebuilt on the card inside the step): "
                        "needs the epoch driver and the dense layout; "
                        "'auto' is on where supported")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--ckpt-dir", default="checkpoints/torch",
                   help="where the per-epoch checkpoints are committed")
    p.add_argument("--keep-ckpts", type=int, default=3, metavar="K",
                   help="checkpoint retention: newest K versioned saves "
                        "plus the best-pointer target (0 keeps all)")
    p.add_argument("--guard", choices=["off", "skip", "rollback"],
                   default="skip",
                   help="divergence guard. 'skip' (default): non-finite "
                        "updates are skipped on the card, inside the "
                        "replayed train graph (trajectory bit-equal when "
                        "nothing fires). 'rollback' also restores the last "
                        "good checkpoint with an LR cut when >= "
                        "--guard-max-skips steps of one epoch were "
                        "skipped. 'off' disables both")
    p.add_argument("--guard-max-skips", type=int, default=3, metavar="K",
                   help="skipped steps per epoch that count as divergence "
                        "(--guard rollback)")
    p.add_argument("--guard-lr-cut", type=float, default=0.5,
                   help="LR multiplier applied per rollback")
    p.add_argument("--guard-max-rollbacks", type=int, default=3,
                   help="rollback budget before the run fails for real")
    p.add_argument("--no-preempt-handler", action="store_true",
                   help="do not trap SIGTERM/SIGINT for graceful "
                        "checkpoint-and-resume (exit code 75)")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast with a traceback at the first NaN "
                        "(eager steps: the step graphs are turned off)")
    # observability (cgnn_tpu_torch.observe)
    p.add_argument("--telemetry", choices=["off", "epoch", "step"],
                   default="epoch",
                   help="telemetry level. 'epoch' (default, nothing added "
                        "to a step): epoch records in metrics.jsonl, the "
                        "host span trace (trace.json, opens in Perfetto), "
                        "the run manifest (manifest.json) and the padding, "
                        "memory and dispatch gauges. 'step' adds one "
                        "record a step (loss, grad and update norms, "
                        "NaN/Inf counts) from the replayed step graphs "
                        "through a ring on the card, and the in-graph "
                        "grad-health metrics. 'off' writes nothing")
    p.add_argument("--log-dir", type=str, default="",
                   help="telemetry dir (metrics.jsonl, trace.json, "
                        "manifest.json); default: <ckpt-dir>/logs")
    p.add_argument("--live-metrics", type=float, default=0.0,
                   metavar="SECS",
                   help="append a live registry snapshot (counters, "
                        "gauges, rolling-window quantiles) to "
                        "metrics_live.jsonl in the log dir every SECS "
                        "seconds (0 disables; needs --telemetry != off). "
                        "SIGUSR2 additionally captures a bounded on-demand "
                        "torch.profiler trace into the log dir")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="trace N steps after the first of the first epoch "
                        "with torch.profiler (a Chrome trace in the log "
                        "dir; the per-step loop: --device-resident then "
                        "keeps it, and the epoch driver traces nothing)")
    p.add_argument("--out-dir", default="checkpoints/torch",
                   help="where params.npz and meta.json are written")
    p.add_argument("--data-parallel", action="store_true",
                   help="data-parallel training, one process a card: "
                        "under the CGNN_TPU_COORDINATOR/_NUM_PROCESSES/"
                        "_PROCESS_ID triple this process is one rank; "
                        "without it one worker is started for each "
                        "visible card (one card: the one-process fit)")
    p.add_argument("--graph-shards", type=int, default=1, metavar="G",
                   help="shard every batch's edge work over G ranks (node "
                        "strips on the dense layout, edge chunks on COO); "
                        "with --data-parallel a D x G layout")
    p.add_argument("--dist-backend", choices=["auto", "gloo"],
                   default="auto",
                   help="--data-parallel's collectives: auto = gloo on "
                        "the CPU, NCCL on CUDA (a card a rank); gloo on "
                        "CUDA for ranks that share a card")
    # the force task
    p.add_argument("--energy-weight", type=float, default=1.0,
                   help="w_e in L = w_e*MSE(E) + w_f*MSE(F)")
    p.add_argument("--force-weight", type=float, default=10.0,
                   help="w_f in L = w_e*MSE(E) + w_f*MSE(F)")
    p.add_argument("--md-atoms", type=int, default=8,
                   help="atoms per frame for --synthetic MD trajectories")
    p.add_argument("--md-jitter", type=float, default=0.08,
                   help="per-frame Cartesian jitter (A) for synthetic MD")
    return p


def resolve_layout(args) -> int | None:
    """train.py's layout rules -> dense_m (``--max-num-nbr``; 0 = COO), or
    None after printing why the flags do not go together."""
    if args.layout == "dense" and args.aggregation is not None:
        print("--layout dense is incompatible with --aggregation",
              file=sys.stderr)
        return None
    use_dense = (args.aggregation is None if args.layout == "auto"
                 else args.layout == "dense")
    force = args.task == "force"
    if args.fused_epilogue != "off" and (not use_dense or force):
        print("--fused-epilogue requires the dense layout with BatchNorm "
              "(not --layout coo / --aggregation / --task force)",
              file=sys.stderr)
        return None
    if args.cgconv_impl != "off" and (not use_dense or force
                                      or args.fused_epilogue != "off"):
        print("--cgconv-impl (the whole-conv fused kernel) requires the "
              "dense layout with BatchNorm and no --fused-epilogue (it "
              "subsumes it; not --task force)", file=sys.stderr)
        return None
    if force and not use_dense and args.aggregation == "pallas":
        from cgnn_tpu_torch.config import FORCE_PALLAS_REFUSAL

        print(FORCE_PALLAS_REFUSAL, file=sys.stderr)
        return None
    return args.max_num_nbr if use_dense else 0


def graph_shards_refusal(args, dense_m) -> str:
    """Why ``--graph-shards`` does not go with the other flags (train.py's
    reasons), or ''."""
    if args.graph_shards < 1:
        return f"--graph-shards must be >= 1, got {args.graph_shards}"
    if args.graph_shards == 1:
        return ""
    if args.task == "force":
        return "--graph-shards is not supported for --task force"
    if args.fused_epilogue != "off":
        return ("--fused-epilogue requires the dense layout with BatchNorm "
                "and no graph sharding (not --layout coo / --task force / "
                "--graph-shards)")
    if args.cgconv_impl != "off":
        return ("--cgconv-impl (the whole-conv fused kernel) requires the "
                "dense layout with BatchNorm, no graph sharding, and no "
                "--fused-epilogue (it subsumes it)")
    if args.buckets > 1 and not dense_m:
        return ("--buckets with --graph-shards requires the dense layout "
                "(drop --layout coo)")
    if args.compact_staging == "on":
        return ("--compact-staging on is not yet supported with "
                "--data-parallel/--graph-shards (full staging only); drop "
                "the flag or use auto")
    if args.profile:
        return ("--profile is not supported with --graph-shards "
                "(edge-sharded meshes)")
    return ""


def data_parallel_plan(args) -> tuple | None:
    """train.py's data-parallel and graph-sharding rules -> ("single",
    None): the one-process fit; ("spawn", n): start n workers (one a
    card, G a data index under ``--graph-shards G``); ("rank", backend):
    this process is one rank of the environment triple's run. None after
    printing why the flags do not go together."""
    import torch

    from cgnn_tpu_torch.parallel import dist, mesh

    try:
        cfg = dist.configured_env()
    except ValueError as e:
        print(e, file=sys.stderr)
        return None
    shards = args.graph_shards
    if cfg is not None and not (args.data_parallel or shards > 1):
        print("multi-process run (CGNN_TPU_COORDINATOR set) requires "
              "--data-parallel: without the data-parallel step there is "
              "no cross-process gradient reduction and the processes "
              "would silently train divergent models", file=sys.stderr)
        return None
    if not (args.data_parallel or shards > 1):
        return "single", None
    device_type = torch.device(args.device).type
    cards = mesh.device_count() if device_type == "cuda" else 0
    if cfg is not None:
        world = cfg["num_processes"]
    elif shards > 1:
        world = shards * (max(1, cards // shards) if args.data_parallel
                          else 1)
    else:
        world = cards
    if world % shards or (not args.data_parallel and world != shards):
        print(f"--graph-shards {shards}: {world} processes do not make "
              f"{'D x ' if args.data_parallel else ''}{shards} ranks "
              f"(--data-parallel for more than one data index)",
              file=sys.stderr)
        return None
    if world < 2:
        print(f"--data-parallel: {world} visible card(s) and no "
              f"CGNN_TPU_* triple: the one-process fit")
        return "single", None
    if args.compact_staging == "on":
        print("--compact-staging on is not yet supported with "
              "--data-parallel (full staging only); drop the flag or use "
              "auto", file=sys.stderr)
        return None
    backend, why = dist.resolve_backend(args.dist_backend, device_type,
                                        world, cards)
    if backend is None:
        print(f"--data-parallel: {why}", file=sys.stderr)
        return None
    return ("rank", backend) if cfg is not None else ("spawn", world)


def launch_local(argv, world: int, timeout: float | None = None) -> int:
    """``--data-parallel`` over this host's cards: ``world`` workers of
    this entry point with ``argv``, rank r with the environment triple
    (coordinator on localhost, a free port) -> their exit code: the
    first failure's (the others are stopped: a rank that died leaves its
    peers blocked in a collective), else 75 when the run was preempted,
    else 0. SIGTERM and SIGINT are passed on to the workers; past
    ``timeout`` seconds every worker is killed (exit 124)."""
    import signal
    import socket
    import subprocess

    from cgnn_tpu_torch.parallel import dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cgnn_tpu_torch.train", *argv],
        env=dict(os.environ, **dist.env_for(f"localhost:{port}", world, r)))
        for r in range(world)]

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    old = {sig: signal.signal(sig, forward)
           for sig in (signal.SIGTERM, signal.SIGINT)}
    deadline = None if timeout is None else time.monotonic() + timeout
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((p.returncode for p in procs
                           if p.returncode not in (None, 0, 75)), None)
            if deadline is not None and time.monotonic() > deadline:
                failed = 124
            time.sleep(0.1)
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    print(f"--data-parallel: {world} workers exited {codes}")
    bad = [c for c in codes if c not in (0, 75)]
    if failed is not None or bad:
        return failed if failed is not None else bad[0]
    return 75 if 75 in codes else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    dense_m = resolve_layout(args)
    if dense_m is None:
        return 2
    refusal = graph_shards_refusal(args, dense_m)
    if refusal:
        print(refusal, file=sys.stderr)
        return 2
    plan = data_parallel_plan(args)
    if plan is None:
        return 2
    if plan[0] == "spawn":
        return launch_local(argv, plan[1])
    if (args.device_resident and not args.no_scan_epochs
            and not args.profile):
        # train.py: the device-resident default, but not for per-step
        # profiling, which the epoch driver cannot give
        args.scan_epochs = True
    if args.scan_epochs and args.no_scan_epochs:
        print("--scan-epochs and --no-scan-epochs are contradictory",
              file=sys.stderr)
        return 2
    # compact staging is single-process (train.py decides it outside its
    # data-parallel branch)
    compact_ok = (args.scan_epochs and bool(dense_m)
                  and args.task != "force" and plan[0] == "single")
    if args.compact_staging == "on" and not compact_ok:
        print("--compact-staging on requires --scan-epochs, the dense "
              "layout, and a non-force task", file=sys.stderr)
        return 2

    preempt = None
    if not args.no_preempt_handler:
        from cgnn_tpu_torch.resilience.preempt import PreemptionHandler

        preempt = PreemptionHandler.installed(log_fn=print)
    from cgnn_tpu_torch.data import invariants
    from cgnn_tpu_torch.parallel import dist

    checks_were = invariants.enabled()
    if args.check_invariants:
        invariants.enable()
    try:
        if plan[0] == "rank":
            # before anything touches CUDA
            dist.initialize_from_env(backend=plan[1],
                                     graph_shards=args.graph_shards)
            problem = dist.graph_hosts_problem()
            if problem:
                print(f"--graph-shards: {problem}", file=sys.stderr)
                return 2
            if args.scan_epochs or args.device_resident or args.pack_once:
                # host-local staging: every rank on one host (train.py)
                problem = dist.hosts_problem()
                if problem:
                    print(problem, file=sys.stderr)
                    return 2
        return _train(args, dense_m, compact_ok, preempt)
    finally:
        dist.shutdown()
        invariants.enable(checks_were)
        if preempt is not None:
            preempt.uninstall()


def _train(args, dense_m, compact_ok, preempt) -> int:
    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.device import resolve_device
    from cgnn_tpu_torch.observe.telemetry import Telemetry
    from cgnn_tpu_torch.parallel import dist
    from cgnn_tpu_torch.parallel.mesh import rank_device
    from cgnn_tpu_torch.resilience import faultinject

    fault_plan = faultinject.plan()
    if fault_plan is not None:
        print(f"FAULT INJECTION ACTIVE: {fault_plan.describe()}",
              file=sys.stderr)
        ignored = (faultinject.serving_keys(fault_plan)
                   + faultinject.unported_keys(fault_plan))
        if ignored:
            print(f"fault injection: {', '.join(ignored)} not run by "
                  f"this trainer (serving and continual hooks): ignored",
                  file=sys.stderr)
    if args.debug_nans:
        print("--debug-nans: step graphs off; eager steps under "
              "torch.autograd.detect_anomaly(check_nan=True), each module's "
              "output checked")
    dp = dist.active()
    rank, world = dist.process_index(), dist.process_count()
    dev = resolve_device(rank_device(args.device, rank) if dp
                         else args.device)
    if dp:
        import torch

        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        elif "OMP_NUM_THREADS" not in os.environ:
            # the ranks share this host's cores: as many intra-op threads
            # each as leaves them unshared (oversubscribed, they spin)
            torch.set_num_threads(
                max(1, len(os.sched_getaffinity(0)) // world))
    data_cfg = DataConfig(radius=args.radius, max_num_nbr=args.max_num_nbr,
                          dmin=args.dmin, step=args.step)
    # the data first: a run refused for its data leaves no directory
    loaded = load_graphs(args, data_cfg)
    if loaded is None:
        return 2
    log_dir = args.log_dir or os.path.join(args.ckpt_dir, "logs")
    # process 0 alone writes the telemetry files, as it alone commits
    telemetry = (Telemetry(args.telemetry, log_dir) if dist.is_coordinator()
                 else Telemetry.disabled())
    live_writer = None
    if args.live_metrics > 0 and telemetry.enabled:
        from cgnn_tpu_torch.observe.export import (
            LiveMetricsWriter,
            MetricsRegistry,
        )

        # the telemetry's window (15 min), not serving's 60 s: an epoch
        # time is observed once an epoch
        live_writer = LiveMetricsWriter(
            MetricsRegistry(window_s=telemetry.series_window_s
                            ).attach_telemetry(telemetry),
            os.path.join(log_dir, "metrics_live.jsonl"),
            interval_s=args.live_metrics).start()
    profiler = None
    sigusr2 = getattr(signal, "SIGUSR2", None)
    old_sigusr2 = None
    if telemetry.enabled:
        # SIGUSR2 -> one bounded capture into the log dir (host-side
        # only: the trajectory is bit-equal with or without one)
        from cgnn_tpu_torch.observe.profile import (
            ProfileCapture,
            install_sigusr2,
        )

        profiler = ProfileCapture(log_dir, spans=telemetry.spans)
        if sigusr2 is not None:
            old_sigusr2 = signal.getsignal(sigusr2)
        if install_sigusr2(profiler, log_fn=print):
            print(f"profile: SIGUSR2 takes a "
                  f"{profiler.default_duration_s:g} s capture into "
                  f"{log_dir}")
        else:
            old_sigusr2 = None
    try:
        return _train_run(args, dense_m, compact_ok, preempt, dev, data_cfg,
                          loaded, telemetry)
    finally:
        if profiler is not None:
            # every exit (the end, 75, an error) waits a capture out, so
            # its trace is written
            profiler.wait_idle()
        if old_sigusr2 is not None:
            signal.signal(sigusr2, old_sigusr2)
        if live_writer is not None:
            live_writer.stop()
        # flushes the counters and gauges, exports trace.json: also on
        # the resumable exit and on an error
        telemetry.close()


def _train_run(args, dense_m, compact_ok, preempt, dev, data_cfg, loaded,
               telemetry) -> int:
    """``_train``'s run on its device, with its telemetry."""
    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import ModelConfig
    from cgnn_tpu_torch.data.dataset import train_val_test_split
    from cgnn_tpu_torch.parallel import dist
    from cgnn_tpu_torch.parallel.data_parallel import (
        CoordinatedCheckpoint,
        seed_rank_dropout,
    )
    from cgnn_tpu_torch.resilience.guard import DivergenceMonitor, debug_nans
    from cgnn_tpu_torch.resilience.preempt import resumable_exit
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager
    from cgnn_tpu_torch.train.loop import evaluate, fit
    from cgnn_tpu_torch.train.state import init_train_state

    dp = dist.active()
    rank, world = dist.process_index(), dist.process_count()
    # what the host shards, the shuffles and the dropout streams follow
    data_index, n_data = dist.data_index(), dist.data_count()
    graphs, traj_groups = loaded
    if traj_groups is not None:
        from cgnn_tpu_torch.data.trajectory import split_trajectory_groups

        train_g, val_g, test_g = split_trajectory_groups(
            traj_groups, args.train_ratio, args.val_ratio, seed=args.seed)
        print(f"trajectory-aware split: {len(train_g)}/{len(val_g)}/"
              f"{len(test_g)} frames over {len(traj_groups)} trajectories")
    else:
        train_g, val_g, test_g = train_val_test_split(
            graphs, args.train_ratio, args.val_ratio, seed=args.seed)
    # the normalizer, the capacities and the milestones come from the
    # whole training split, so every rank holds the same
    full_train, full_val = train_g, val_g
    per_epoch = None
    if dp:
        # every rank ran the same split; each data index takes its
        # strided shard (the G ranks of a graph group the same one)
        train_g = dist.host_shard(train_g, data_index, n_data)
        val_g = dist.host_shard(val_g, data_index, n_data)
        layout = (f" (data index {data_index}/{n_data}, graph shard "
                  f"{rank % args.graph_shards}/{args.graph_shards})"
                  if args.graph_shards > 1 else "")
        print(f"data-parallel: process {rank}/{world}{layout} trains "
              f"{len(train_g)} / validates {len(val_g)} structures "
              f"(strided host shard); test eval runs the full split on "
              f"every process")
        per_epoch = _dp_steps_per_epoch(args, full_train, train_g, dense_m)
    num_targets = int(train_g[0].target.shape[0])
    classification = args.task == "classification"
    force = args.task == "force"
    if classification:
        bad = bad_label(graphs, args.num_classes)
        if bad is not None:
            print(bad, file=sys.stderr)
            return 2
    model_cfg = ModelConfig(
        atom_fea_len=args.atom_fea_len, n_conv=args.n_conv,
        h_fea_len=args.h_fea_len, n_h=args.n_h, num_targets=num_targets,
        classification=classification, num_classes=args.num_classes,
        dropout=args.dropout, dtype="bfloat16" if args.bf16 else "float32",
        multi_task_head=args.multi_task_head,
        aggregation=args.aggregation, dense_m=dense_m,
        fused_epilogue="" if args.fused_epilogue == "off"
        else args.fused_epilogue,
        cgconv_impl="" if args.cgconv_impl == "off" else args.cgconv_impl,
    )
    with telemetry.span("state_init"):
        state, node_cap, edge_cap = init_train_state(
            model_cfg, data_cfg, full_train, batch_size=args.batch_size,
            device=dev, steps_per_epoch=per_epoch,
            seed=args.seed, optim=args.optim, lr=args.lr,
            momentum=args.momentum, weight_decay=args.weight_decay,
            lr_milestones_epochs=args.lr_milestones, task=args.task,
            packing=args.packing, node_cap=args.node_cap or None,
            edge_cap=args.edge_cap or None)
    if dense_m and args.edge_cap:
        print(f"warning: --edge-cap {args.edge_cap} ignored by the dense "
              f"layout (edge capacity is node_cap * max_num_nbr = "
              f"{node_cap * dense_m}); use --layout coo to honor it",
              file=sys.stderr)
    snug = args.packing == "snug"
    # process 0 alone commits (and, under --resume, restores: the other
    # ranks take its state by broadcast)
    ckpt = (CheckpointManager(args.ckpt_dir, keep=args.keep_ckpts,
                              telemetry=telemetry)
            if dist.is_coordinator() else None)
    try:
        resumed = _resume(args, ckpt, state) if ckpt is not None else None
        if dp:
            resumed = _agree_resume(resumed)
        if resumed is None:
            return 2
        start_epoch, resume_meta = resumed
        # the run manifest: config, device inventory, git SHA, once
        telemetry.write_manifest(
            vars(args), task=args.task,
            mesh_shape={"data": n_data if dp else 1,
                        "graph": args.graph_shards})
        meta_base = {"model": model_cfg.to_meta(), "data": data_cfg.to_meta(),
                     "task": args.task}
        sel_key = ("force_mae" if force
                   else "correct" if classification else "mae")
        monitor = None
        if args.guard == "rollback":
            monitor = DivergenceMonitor(
                CoordinatedCheckpoint(ckpt) if dp else ckpt,
                max_skips=args.guard_max_skips,
                lr_cut=args.guard_lr_cut,
                max_rollbacks=args.guard_max_rollbacks, log_fn=print)
            if resume_meta is not None:
                # the cut and the spent budget survive a requeue
                state = monitor.resume_from_meta(state, resume_meta)

        skip_noted = []

        def save(s, epoch, val_m, is_best):
            if ckpt is None:
                if not skip_noted:
                    skip_noted.append(True)
                    print(f"data-parallel: process {rank} skips "
                          f"checkpoint commits (process 0 is the single "
                          f"committer)")
                return
            extra = monitor.meta() if monitor is not None else {}
            # train.py's key, whatever the selection metric
            ckpt.save(s, dict(meta_base, epoch=epoch,
                              best_mae=val_m.get(sel_key, -1.0), **extra),
                      is_best=is_best)

        compact = None
        if args.compact_staging != "off" and compact_ok:
            compact = _compact_spec(args, train_g + val_g + test_g,
                                    data_cfg, dense_m, model_cfg.torch_dtype)
        if dp:
            seed_rank_dropout(state.model, args.seed, data_index, n_data,
                              start_epoch)
        # the sharded model trains; the test split and the saves read
        # the same parameters unsharded
        if dist.graph_group() is not None:
            state.model.set_graph_group(dist.graph_group())
        with (debug_nans(state.model) if args.debug_nans
              else contextlib.nullcontext()):
            state, result = fit(
                state, train_g, val_g, epochs=args.epochs,
                batch_size=args.batch_size, dense_m=dense_m, device=dev,
                node_cap=node_cap, edge_cap=edge_cap, seed=args.seed,
                print_freq=args.print_freq, start_epoch=start_epoch,
                on_epoch_end=save, buckets=args.buckets,
                pack_once=args.pack_once,
                device_resident=args.device_resident,
                scan_epochs=args.scan_epochs,
                chunk_steps=args.chunk_steps, compact=compact,
                graphs=not args.debug_nans, guard=args.guard != "off",
                monitor=monitor, preempt=preempt,
                force_weights=(args.energy_weight, args.force_weight),
                packing=args.packing,
                fit_on=(full_train, full_val) if dp else None,
                telemetry=telemetry,
                on_epoch_metrics=telemetry.write_epoch,
                profile_steps=args.profile,
                profile_dir=args.log_dir or os.path.join(args.ckpt_dir,
                                                         "logs"))
        if ckpt is not None:
            ckpt.wait()
    finally:
        if dist.graph_group() is not None:
            state.model.set_graph_group(None)
        if ckpt is not None:
            ckpt.close()
    if result.get("preempted"):
        # the loop saved a resumable checkpoint at the boundary and the
        # close above waited for its commit (a failed save raised there);
        # the caller flushes the telemetry before the exit
        telemetry.sample_hbm("preempted")
        return resumable_exit(print)
    with telemetry.span("test_eval"):
        test_m = evaluate(state, test_g, args.batch_size, node_cap, dense_m,
                          dev, edge_cap=edge_cap,
                          force_weights=(args.energy_weight,
                                         args.force_weight),
                          snug=snug)
    print(f"** test {sel_key}: {test_m.get(sel_key, float('nan')):.4f} "
          f"(best val: {result['best']:.4f})")
    if force:
        print(f"** test energy mae: {test_m.get('mae', float('nan')):.4f}")
    for t in range(num_targets):
        if f"mae_task{t}" in test_m:
            print(f"** test mae task {t}: {test_m[f'mae_task{t}']:.4f}")
    if classification:
        cls, n_batches = class_eval_on(state, test_g, args.batch_size,
                                         node_cap, edge_cap, dense_m, dev,
                                         snug=snug)
        test_m = dict(test_m, **cls, class_eval_batches=n_batches)
        print("** test " + "  ".join(
            f"{k} {v:.4f}" for k, v in cls.items() if v == v))
    telemetry.write_scalars(args.epochs, test_m, prefix="test")
    telemetry.sample_hbm("end_of_run")
    print("train: " + json.dumps(run_summary(result, len(train_g), test_m),
                                 allow_nan=False))
    if not dist.is_coordinator():
        print(f"data-parallel: process {rank} leaves --out-dir to "
              f"process 0")
        return 0
    os.makedirs(args.out_dir, exist_ok=True)
    npz = os.path.join(args.out_dir, "params.npz")
    meta = os.path.join(args.out_dir, "meta.json")
    convert.save_params(
        npz, meta, convert.to_flax_variables(state.model.state_dict()),
        model_cfg, data_cfg,
        normalizer_mean=state.normalizer.mean.cpu().numpy(),
        normalizer_std=state.normalizer.std.cpu().numpy(), task=args.task)
    print(f"wrote {npz} and {meta}")
    return 0


def _dp_steps_per_epoch(args, full_train, shard, dense_m) -> int:
    """The training steps every rank runs an epoch, at the whole split's
    capacities: what the milestones count in a data-parallel run. The
    per-step loop runs the least batch count of the ranks' shards; lists
    packed once (``--pack-once``, ``--device-resident``, the epoch
    driver) run, of each size class, the least count of any rank
    (parallel/data_parallel.py ``agree_batches``)."""
    from cgnn_tpu_torch.data.graph import bucket_batch_counts, count_batches
    from cgnn_tpu_torch.parallel import dist
    from cgnn_tpu_torch.train.loop import batch_caps, sharded_caps

    snug = args.packing == "snug"
    dense_m = dense_m or None
    once = args.pack_once or args.device_resident or args.scan_epochs
    if once and args.buckets > 1:
        shards = args.graph_shards
        kw = dict(dense_m=dense_m, snug=snug, fit_graphs=full_train,
                  node_multiple=8 * shards if shards > 1 and dense_m else 1)
        counts = bucket_batch_counts(shard, args.batch_size, args.buckets,
                                     **kw)
        classes = bucket_batch_counts(full_train, args.batch_size,
                                      args.buckets, **kw)
        return sum(dist.min_over_hosts(counts.get(b, 0)) for b in classes)
    caps = sharded_caps(*batch_caps(full_train, args.batch_size,
                                    dense_m, args.node_cap or None,
                                    args.edge_cap or None, snug=snug),
                        dense_m, args.graph_shards)
    return dist.min_over_hosts(count_batches(shard, args.batch_size, *caps,
                                             snug=snug))


def _agree_resume(resumed) -> tuple | None:
    """Process 0's resume decision (``_resume``'s: the first epoch and
    the meta the guard keeps, or a refusal) on every rank."""
    from cgnn_tpu_torch.parallel import dist

    wire = ""
    if resumed is not None:
        start, meta = resumed
        keep = {k: v for k, v in (meta or {}).items()
                if k in ("guard_lr_scale", "guard_rollbacks")}
        wire = json.dumps({"start": start,
                           "meta": keep if meta is not None else None})
    wire = dist.broadcast_str(wire)
    if not wire:
        return None
    got = json.loads(wire)
    return got["start"], got["meta"]


def run_summary(result: dict, n_train: int, test: dict | None = None
                ) -> dict:
    """The run's machine-readable line: per-epoch seconds and train
    structures/s (the epoch's train and validation wall), the step
    graphs' captures and replays, the driver's staging, and the test
    metrics (a NaN, e.g. an AUC with one class present, as null); the
    steps each validation epoch took and the steps the guard skipped,
    each epoch's train loss and validation metric (``best_key``'s); a
    data-parallel run's ``dp`` record (rank, world, backend, data index,
    graph shards, per-epoch state digests); ``edge_bytes`` (the first
    epoch's edge leaves as this rank staged them)."""
    from cgnn_tpu_torch.resilience.guard import skipped_steps

    hist = result["history"]
    out = {"epochs": [h["epoch"] for h in hist],
           "epoch_seconds": [h["seconds"] for h in hist],
           "train_structures_per_s": [n_train / h["seconds"] for h in hist],
           "train_steps": [h["train"]["steps"] for h in hist],
           "eval_steps": [h["val"].get("steps", 0) for h in hist],
           "guard_skipped": [skipped_steps(h["train"]) for h in hist],
           "train_loss": [_finite(h["train"].get("loss")) for h in hist],
           "val_metric": [_finite(h["val"].get(result["best_key"]))
                          for h in hist],
           "graphs": result["graphs"]}
    if "dp" in result:
        out["dp"] = result["dp"]
    if "edge_bytes" in result:
        out["edge_bytes"] = result["edge_bytes"]
    if "padding" in result:
        out["padding"] = result["padding"]
    if "staging" in result:
        out["staging"] = result["staging"]
    if test is not None:
        out["test"] = {k: (None if v != v else v) for k, v in test.items()}
    return out


def _finite(v) -> float | None:
    """``v``, or None where it is missing or not finite (JSON has no
    NaN)."""
    import math

    return v if v is not None and math.isfinite(v) else None


def bad_label(graphs, num_classes: int) -> str | None:
    """Why the first label column does not hold class indices in [0,
    num_classes) (the row that does not, in dataset order), or None. A
    label the step truncates (as train.py's int32 cast) into the range
    passes; an out-of-range index would make a gather on the card
    assert."""
    import numpy as np

    for i, g in enumerate(graphs):
        t = float(np.atleast_1d(g.target)[0])
        if not (np.isfinite(t) and 0 <= int(t) < num_classes):
            return (f"--task classification: row {i} ({g.cif_id!r}) has "
                    f"label {t!r}, outside [0, {num_classes}) "
                    f"(--num-classes {num_classes})")
    return None


def class_eval_on(state, graphs, batch_size: int, node_cap: int,
                    edge_cap: int, dense_m, dev,
                    snug: bool = True) -> tuple[dict, int]:
    """train.py's test ``class_eval``: the predict step's log-probs for
    each test structure, in order, on eager steps -> (class_eval's
    metrics, predict batches run)."""
    import numpy as np

    from cgnn_tpu_torch.data.graph import batch_iterator
    from cgnn_tpu_torch.train.loop import batch_caps, edge_pack_fn
    from cgnn_tpu_torch.train.metrics import class_eval
    from cgnn_tpu_torch.train.step import InferenceState, make_predict_step

    dense_m = dense_m or None
    node_cap, edge_cap = batch_caps(graphs, batch_size, dense_m, node_cap,
                                    edge_cap, snug=snug)
    step = make_predict_step()
    inference = InferenceState(state.model, state.normalizer)
    state.model.eval()
    scores, n_batches = [], 0
    for b in batch_iterator(graphs, batch_size, node_cap, edge_cap,
                            dense_m=dense_m, in_cap=0, snug=snug,
                            pack_fn=edge_pack_fn(state.model.dtype)):
        n_real = int(b.graph_mask.sum())
        scores.append(step(inference, b.to(dev))[:n_real].cpu().numpy())
        n_batches += 1
    labels = np.array([int(np.atleast_1d(g.target)[0]) for g in graphs])
    return class_eval(np.concatenate(scores), labels), n_batches


def _compact_spec(args, graphs, data_cfg, dense_m, edge_dtype):
    """train.py's compact-staging rule: the spec, or None after saying
    why the data cannot stage compactly (``on`` raises instead)."""
    from cgnn_tpu_torch.data.compact import CompactSpec, CompactUnsupported

    try:
        spec = CompactSpec.build(graphs, data_cfg.featurize_config().gdf(),
                                 dense_m=dense_m, edge_dtype=edge_dtype)
    except CompactUnsupported as e:
        if args.compact_staging == "on":
            raise
        print(f"compact staging unavailable ({e}); using full staging",
              file=sys.stderr)
        return None
    print("compact staging: on (raw atoms+distances staged; features "
          "rebuilt on device)")
    return spec


def load_graphs(args, data_cfg):
    """train.py's data rules (module docstring) -> (graphs, the force
    task's trajectory groups or None), or None after printing why there
    are none."""
    from cgnn_tpu_torch.data.cache import (
        featurize_directory_parallel,
        load_graph_cache,
        save_graph_cache,
    )
    from cgnn_tpu_torch.data.dataset import (
        load_cif_directory,
        load_synthetic,
        load_synthetic_oc20,
        load_trajectory,
    )
    from cgnn_tpu_torch.data.trajectory import (
        is_trajectory_path,
        load_trajectory_root,
        regroup_by_trajectory,
    )

    force = args.task == "force"
    traj_groups = None
    t0 = time.perf_counter()
    if args.cache and os.path.exists(args.cache):
        graphs = load_graph_cache(args.cache)
        print(f"loaded {len(graphs)} graphs from {args.cache} "
              f"in {time.perf_counter() - t0:.1f}s")
        if force:
            if any(g.forces is None or g.positions is None for g in graphs):
                print(f"cache {args.cache} lacks force labels/geometry; "
                      f"refeaturize from the trajectory files",
                      file=sys.stderr)
                return None
            traj_groups = regroup_by_trajectory(graphs)
        return graphs, traj_groups
    fcfg = data_cfg.featurize_config()
    if args.synthetic_oc20:
        graphs = load_synthetic_oc20(args.synthetic_oc20, fcfg,
                                     seed=args.seed)
    elif args.synthetic and force:
        graphs = load_trajectory(args.synthetic, fcfg, seed=args.seed,
                                 num_atoms=args.md_atoms,
                                 jitter=args.md_jitter)
        # one trajectory: the contiguous-block split of on-disk ones
        traj_groups = [graphs]
    elif args.synthetic:
        graphs = load_synthetic(args.synthetic, fcfg, seed=args.seed)
    elif force:
        if not args.root_dir or not is_trajectory_path(args.root_dir):
            print("--task force needs --synthetic N or an on-disk "
                  "trajectory dataset: a .npz file or a directory of them, "
                  "one file per trajectory (key conventions: "
                  "cgnn_tpu_torch/data/trajectory.py; MD17/sGDML R/z/E/F "
                  "files load unchanged)", file=sys.stderr)
            return None
        traj_groups = load_trajectory_root(args.root_dir, fcfg)
        graphs = [g for grp in traj_groups for g in grp]
        print(f"loaded {len(traj_groups)} trajectories ({len(graphs)} "
              f"frames) from {args.root_dir}")
    elif args.root_dir:
        if args.workers != 1:
            graphs, failures = featurize_directory_parallel(
                args.root_dir, fcfg, workers=args.workers or None)
            for cif_id, err in failures[:10]:
                print(f"skipped {cif_id}: {err}", file=sys.stderr)
            if not graphs:
                print(f"no usable structures under {args.root_dir}",
                      file=sys.stderr)
                return None
        else:
            graphs = load_cif_directory(args.root_dir, fcfg)
    else:
        print("either DATA_DIR or --synthetic N is required", file=sys.stderr)
        return None
    print(f"featurized {len(graphs)} structures "
          f"in {time.perf_counter() - t0:.1f}s")
    if args.cache:
        save_graph_cache(graphs, args.cache)
        print(f"wrote cache {args.cache}")
    return graphs, traj_groups


def _resume(args, ckpt, state) -> tuple | None:
    """train.py's resume rules -> (the first epoch to run, the restored
    meta or None), or None after printing why the run is refused."""
    from cgnn_tpu_torch.train.checkpoint import (
        CheckpointManager,
        CheckpointRestoreError,
    )

    if not args.resume:
        return args.start_epoch, None
    auto = args.resume == "auto"
    resume_dir = args.ckpt_dir if auto else args.resume
    mgr = (ckpt if os.path.abspath(resume_dir) == ckpt.directory
           else CheckpointManager(resume_dir))
    if auto and not mgr.exists():
        print(f"--resume auto: no checkpoint under {resume_dir}; starting "
              f"fresh")
        return args.start_epoch, None
    try:
        _, meta = mgr.restore(state)
    except CheckpointRestoreError as e:
        print(f"cannot resume from {resume_dir}: {e}", file=sys.stderr)
        if auto:
            print("--resume auto: checkpoint directory is non-empty but "
                  f"unrestorable; inspect or remove {resume_dir} to start "
                  f"fresh", file=sys.stderr)
        return None
    finally:
        if mgr is not ckpt:
            mgr.close()
    if "epoch" not in meta:
        print(f"checkpoint meta under {resume_dir} lacks 'epoch' ({meta!r}) "
              f"— cannot determine the resume point; aborting instead of "
              f"restarting at epoch 0", file=sys.stderr)
        return None
    start_epoch = int(meta["epoch"]) + 1
    print(f"resumed from {resume_dir} at epoch {start_epoch}")
    return start_epoch, meta


if __name__ == "__main__":
    sys.exit(main())
