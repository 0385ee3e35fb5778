#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cgnn_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

It builds the hand-written kernels from ``cgnn_tpu_torch/ops/csrc`` with
nvcc (``fused_cgconv.cu``, ``fused_epilogue.cu``, ``neighbor_search.cu``,
``segment_sum.cu`` and ``windowed_gather.cu``, one nvcc each, in parallel,
into ``build/kernels``), then:

1. kernel phase — holds each of the six kernels against its plain PyTorch
   version on the card and times both beside the card's bound for the
   same work: CUDA events around back-to-back calls (``ms``), the
   profiler's device time (``device_ms``), and the host's time a wrapper
   call (``host_us``, 200 back-to-back calls, no sync inside). The calls
   rotate through copies of their inputs that total over twice the L2,
   so each reads its inputs from device memory, as the bound counts
   them. Kernel 1 (the whole-conv apply pass: a node pass, then a slot
   pass) runs at the flagship CGCNN's top serving rung (N=1784 nodes,
   M=12 slots, F=64, G=41), with its bound counted as the least work (the
   factored z) and, beside it, as z taken whole per slot
   (``bound_ms_before``), and its two launches' device times apart;
   kernels 2-5 (the stats pass, and the fused epilogue's apply,
   reduce and dz passes) at the training shape, a snug batch-256 pack of
   MP-like structures (N=7832), with kernel 1 there too; kernel 2 (kernel
   1's node pass, a stats slot pass, the partials' sum) with its bound
   counted as the least work and as z taken whole per slot, its three
   launches' and kernel 4's two launches' device times apart, and the
   same bits when handed a separate node pass's P; kernel 8 (the raw
   wire's periodic neighbor search) at the top raw rung (72 structure
   slots of S=64 atoms, K=125 images, M=12) on the admitted calibration
   structures plus padding slots (its bound counted as the least work and
   by the earlier count), then, each beside a padding slot, on the
   exact-tie simple cubic cell, on a dense 8-atom cell whose centers
   accept more candidates than the kernel's key queue holds, and on the
   cubic cell with M=8, an exact tie across the M-th slot;
   kernel 1 again on the graph the raw expander builds on the card at that
   rung (N=72x64=4608 node slots, padding and self-loop slots included).
   Seeded random features and conv parameters. Tolerances: elementwise
   outputs rtol 1e-4 / atol 1e-5; kernel 2's and 4's column sums within
   1e-4 / 5e-4 of their row's largest entry (sums of ~10^5 terms in
   another order), and bit-identical when run again; kernel 8's outputs
   (neighbors, distances, edge mask, edge counts) bit-equal to its plain
   version's and to its own on a second run;
2. serve phase — boots ``load_server(wire='raw')`` on seeded random
   weights at full width (``cgconv_impl='pallas'``, batch 64, 3 rungs) and
   answers, from 4 client threads, a burst of 224 featurized MP-like
   graphs (path ``serve``), then one of 32 wire-form ``RawStructure``s
   (path ``serve_raw``: most staged raw, the rest featurized on the
   worker). It checks every answer against the unfused plain model on
   host-featurized copies (rtol 1e-4 / atol 1e-4), that in each run
   kernel 8 launched once per raw flush and kernel 1 ``n_conv`` times per
   flush, and reports each run's requests/s and latency. An overflow leg
   (``raw_precheck=False``, a one-atom 2 A cubic cell) must be answered
   through the featurized fallback, equal to its featurized answer. Then a
   featurized and a raw top-rung flush are broken down into pack, copy
   and step;
3. train phase — the port's ``fit`` at full width with
   ``cgconv_impl='pallas'``: 512 MP-like training structures (64 for
   validation), batch 256, train.py's SGD defaults, 2 epochs. Kernels 2, 4
   and 5 must launch exactly n_conv x train steps times and kernel 1
   n_conv x (train steps + eval batches), and kernel 1's node pass n_conv
   x (train steps + eval batches) times: one a conv, shared by the stats
   and apply passes of a train step; losses and MAEs finite; the
   trained weights are saved, served by ``load_server`` (8 requests, held
   to the trained model's own answers);
4. trajectory check — the same 5 steps on fixed batches from the same
   initial weights through the kernel path and the unfused plain path on
   the card: per-step loss and every final parameter and running statistic
   within rtol 1e-3 / atol 1e-4 (f32, 5 SGD steps). A 3-step run with
   ``fused_epilogue='pallas'`` (then one eval batch) must launch kernels
   3, 4 and 5 and give the plain path's first 3 losses;
5. train breakdown — for the kernel path, the plain path and the COO
   kernel path (``aggregation='pallas'``, below): train
   structures/s of the per-step loop, and a step split into host pack,
   host-to-device copy and step wall, with the device's busy time and
   idle share from a ``torch.profiler`` trace;
6. the flat COO layout — kernel 6 (the sorted segment sum) against its
   plain version and ``torch.segment_reduce`` at the COO training shape
   (a packed batch-256 batch: E=93,920 edges, N=7,832, F=64; seeded
   messages zeroed on padding edges, which all sit on node N-1), at the
   top COO serving rung (E=21,336, N=1,784), and at the training shape
   with the padding edges moved to a real node in the middle (N/2, the
   centers re-sorted, its messages not zeroed), rtol 1e-4 / atol 1e-5 and
   bit-identical run to run; kernel 7 (the windowed gather, which no entry
   point of the JAX package calls) bit-equal to its plain version and to
   ``index_select`` on the dense training batch at N=7,936 (the node
   capacity rounded up to 128), and zeros out of window on shuffled
   indices. Path ``train_coo``: ``fit`` with ``aggregation='pallas'``,
   ``dense_m=0``, same split, batch 256, 2 epochs, kernel 6 launched
   exactly n_conv x (train steps + eval batches) times; a 5-step
   trajectory through ``'pallas'`` and ``'xla'`` aggregation within rtol
   1e-3 / atol 1e-4; the weights saved. Path ``serve_coo``:
   ``load_server(wire='auto')`` on them (it must log featurized-only),
   from 4 threads 224 featurized graphs and 32 ``RawStructure``s
   featurized at admission, every answer within rtol 1e-4 / atol 1e-4 of
   the plain model (``aggregation='xla'``) on host-featurized copies,
   kernel 6 launched n_conv times a flush; a top-rung flush breakdown;
7. checkpoint_predict — the port's train entry point
   (``cgnn_tpu_torch.train.__main__.main``) at full width with
   ``--cgconv-impl pallas``, 640 synthetic structures (512/64/64), batch
   256, 2 epochs into ``build/chip_smoke/ckpt`` (path ``train_main``,
   each kernel's launches exact): 2 committed saves, each verified
   against its manifest, ``best.json`` on the better one. The same run in
   memory through ``fit``, saved every epoch (the save's caller-thread
   ms), restored into a fresh state (the restore ms): every parameter,
   running statistic, optimizer buffer and the count bit-equal. One more
   epoch (``start_epoch=2``, same seed) from the restored and from the
   in-memory state: bit-equal, or else it names the op that breaks it
   (the run repeated from a copy of the in-memory state and again under
   PyTorch's deterministic algorithms) and holds every tensor to rtol
   1e-6 / atol 1e-7. ``--resume`` to 3 epochs prints ``resumed from ...
   at epoch 2`` (path ``train_main_resume``). ``cgnn_tpu_torch.predict``
   on 512 structures with ``--wire raw`` (path ``predict_raw``) and
   ``--wire featurized`` (path ``predict``): CSV ids in input order, each
   prediction within rtol 1e-4 / atol 1e-4 of the plain model
   (``cgconv_impl`` off) on the same graphs on the card, kernel 1 n_conv
   times a batch and kernel 8 once a raw batch; its structures/s;
8. cif_pipeline — real data through the entry points: 1024 MP-like
   synthetic structures written as CIFs with ``id_prop.csv`` under
   ``build/chip_smoke/cif`` (the port's ``write_cif_file``);
   ``python -m cgnn_tpu_torch.data.preprocess`` with ``-j 8`` (its
   structures/s; the cache bit-equal to an in-process
   ``load_cif_directory`` of the directory); the train entry point from
   ``DIR --cache``, batch 256, 2 epochs, ``--cgconv-impl pallas`` (path
   ``train_cif``, launches exact); the per-step loop with the prefetch
   loader and without it, in turns (on, off, off, on: step wall,
   ``loader_wait_ms`` a step, device idle share); the predict entry point
   on the cache at ``-b 16`` (64 batches, so the pooled pinned buffers
   recycle) with ``--compact on --pack-workers 2`` (path
   ``predict_compact``) and ``--compact off`` (path ``predict_cif_full``),
   in turns (on, off, off, on), and ``--wire raw`` from the directory
   (path ``predict_cif_raw``, kernel 8), each CSV within rtol 1e-4 / atol
   1e-4 of the plain model on the card; a ``compact_flush_breakdown`` of
   ``load_server(compact='on')`` on the calibration graphs (pack, copy,
   the expander's device ms, step), the compactability probe's host time
   a graph (one at a time, and batched as the worker runs it), and bursts of the 224 graphs (fresh copies each) through it and
   through the full-packing server in turns (compact, full, full,
   compact): the first compact burst is path ``serve_compact`` (every
   flush packed compact), its answers equal to the full server's.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
summary lines, and as the last line ``{"ok": true, "device": {...}}``. Any
failed check exits non-zero before that line. Without CUDA it exits 2 and
prints no result.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import threading
import time

RTOL, ATOL = 1e-4, 1e-5  # kernel vs plain version: f32 roundoff, reordered sums
STATS_RTOL = 1e-4  # kernel 2's column sums, on their row's largest entry
REDUCE_RTOL = 5e-4  # kernel 4's (the JAX package's tolerance for d_scale/d_bias)
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-4  # model outputs (|y| ~ 10-100)
TRAIN_RTOL, TRAIN_ATOL = 1e-3, 1e-4  # kernel vs plain path: 5 f32 SGD steps
# a resumed epoch vs the uninterrupted one, where not bit-equal (the op
# that breaks it is named in the output)
RESUME_RTOL, RESUME_ATOL = 1e-6, 1e-7
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
L2_BYTES = 50 * 2**20  # H100 SXM L2: the timers rotate inputs past twice this
SEED = 0
N_CLIENTS, N_GRAPHS, N_WIRE = 4, 224, 32
M = 12  # the flagship's max_num_nbr: dense edge slots per node
BATCH, EPOCHS = 256, 2
N_TRAIN_SET = 640  # split 0.8 / 0.1 / 0.1 -> 512 train, 64 val, 64 test
N_PREDICT = 512  # structures through the predict entry point, each wire
N_CIF = 1024  # MP-like structures written as CIFs (cif_pipeline)
CIF_PREDICT_BATCH = 16  # 64 predict batches, so the pooled buffers recycle
PREPROCESS_WORKERS = 8
COO_AGG = "pallas"  # the COO paths' aggregation: kernel 6
NO_PATH = {"windowed_gather": "no entry point of the JAX package calls "
                              "windowed_gather (tests/test_ops.py:548 only)"}
NO_LIBRARY = {
    "neighbor_search": "no single PyTorch call computes the lexicographic "
                       "top-M periodic neighbor search",
    "fused_cgconv_eval": "no PyTorch call computes the gathered, gated conv",
    "fused_cgconv_stats": "no PyTorch call computes masked moments of the "
                          "gathered z without materializing it",
    "epilogue_apply": "no PyTorch call computes BN-apply + gate + masked sum",
    "epilogue_reduce": "no PyTorch call computes the gate's gradient sums",
    "epilogue_dz": "no PyTorch call computes the BN backward on masked slots",
}


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cold(fn, *args):
    """``fn`` on rotating copies of ``args`` (each tensor cloned) that
    together hold more than twice the card's L2, so that every call reads
    its inputs from device memory, as the bound counts them. -> a callable
    of no arguments, for the timers below."""
    import itertools

    import torch

    size = sum(a.nbytes for a in args if isinstance(a, torch.Tensor))
    copies = [args] + [
        tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        for _ in range(-(-2 * L2_BYTES // max(size, 1)) - 1)]
    nxt = itertools.cycle(copies).__next__
    return lambda: fn(*nxt())


def time_ms(fn, calls=20, trials=5, warmup=5):
    """Device time of one call: CUDA events around ``calls`` back-to-back
    calls, divided by ``calls``; the median of ``trials``. Back to back,
    the device runs ahead of the host's launches, so host gaps between
    calls stay out of the time (events around a single short call would
    count them)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def host_us(fn, calls=200):
    """Host time of one call, in microseconds: the wall time of ``calls``
    back-to-back calls (``time.perf_counter``, no sync inside), divided by
    ``calls``. The queue is drained before and after."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / calls * 1e6


def timings(fn, library_fn=None):
    """A kernel's times on its inputs: ``ms`` (CUDA events, ``time_ms``),
    ``device_ms`` (profiler), ``host_us``; the same for ``library_fn``, the
    one PyTorch call computing the same function, under ``library_*``."""
    out = {"ms": time_ms(fn), "device_ms": device_ms(fn),
           "host_us": host_us(fn)}
    if library_fn is not None:
        out.update(library_ms=time_ms(library_fn),
                   library_device_ms=device_ms(library_fn),
                   library_host_us=host_us(library_fn))
    return out


def kernel_wrappers() -> dict:
    """Each kernel's wrapper by name; ``.launches`` is its count."""
    from cgnn_tpu_torch.ops import fused_cgconv as fc
    from cgnn_tpu_torch.ops import fused_epilogue as fe
    from cgnn_tpu_torch.ops import neighbor_search as ns
    from cgnn_tpu_torch.ops import scatter
    from cgnn_tpu_torch.ops import windowed_gather as wg

    return {"fused_cgconv_eval": fc.fused_cgconv_eval_cuda,
            # kernel 1's node pass (also kernel 2's first launch), counted
            # apart: the training forward runs one a conv for both passes
            "fused_cgconv_node": fc.fused_cgconv_node_cuda,
            "fused_cgconv_stats": fc.fused_cgconv_stats_cuda,
            "epilogue_apply": fe.epilogue_apply_cuda,
            "epilogue_reduce": fe.epilogue_reduce_cuda,
            "epilogue_dz": fe.epilogue_dz_cuda,
            "neighbor_search": ns.neighbor_search_cuda,
            "segment_sum_sorted": scatter.segment_sum_sorted_cuda,
            "windowed_gather": wg.windowed_gather_cuda}


def zero_counts() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0


def read_counts() -> dict:
    return {k: w.launches for k, w in kernel_wrappers().items()}


def compare(name, got, want, rtol, atol=0.0, row_scale=False):
    """Hold a kernel's output to its plain version's -> (max abs, max rel)
    error. ``row_scale``: column sums, each row held to rtol of its
    largest entry."""
    import torch

    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: output is not finite")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-6)).max())
    if row_scale:
        scale = want.abs().amax(dim=-1, keepdim=True)
        ok = bool((err <= rtol * scale).all())
        tol = f"rtol {rtol} of each row's largest entry"
    else:
        ok = bool(torch.allclose(got, want, rtol=rtol, atol=atol))
        tol = f"rtol {rtol}, atol {atol}"
    print(f"{name} at {tuple(got.shape)}: max_abs_err={max_abs!r} "
          f"max_rel_err={max_rel!r} ({tol}): {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} kernel disagrees with its plain version")
    return max_abs, max_rel


def bound(cost):
    """-> (ms, 'bytes' or 'operations'): the larger of a cost's compulsory
    bytes at HBM rate and its f32 operations at the non-tensor-core peak."""
    bytes_ms = cost["bytes"] / PEAK_BYTES * 1e3
    ops_ms = cost["flops"] / PEAK_F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms > ops_ms
                                   else "operations")


K1_PARTS = {"node_pass": "eval_node_kernel", "slot_pass": "eval_slot"}
K2_PARTS = {"node_pass": "eval_node_kernel", "slot_pass": "stats_slot",
            "partial_sum": "sum_partials"}
K4_PARTS = {"reduce": "epilogue_reduce_kernel", "partial_sum": "sum_partials"}


def kernel_entry(name, source, replaces, errs, times, plain_ms, cost,
                 library_call=None):
    """One kernel's record for the ``kernels`` line, with its ``bound``;
    ``times`` from ``timings``: where ``library_call`` names the one
    PyTorch call that computes the same function, its ``library_*``
    times."""
    bound_ms, bound_by = bound(cost)
    library_ms = times.get("library_ms")
    lib = (f"library ({library_call}) {library_ms!r} ms" if library_call
           else f"library_ms null: {NO_LIBRARY[name]}")
    print(f"{name}: {times['ms']!r} ms a call (device "
          f"{times['device_ms']!r} ms, host {times['host_us']!r} us), "
          f"{plain_ms!r} ms plain; {cost['flops']} FLOP, {cost['bytes']} B "
          f"-> bound {bound_ms!r} ms; {lib}")
    entry = {
        "name": name,
        "route": "cuda",
        "source": f"cgnn_tpu_torch/ops/csrc/{source}",
        "replaces": replaces,
        "launches": 0,  # set from the main-path runs
        "max_abs_err": errs[0],
        "max_rel_err": errs[1],
        "ms": times["ms"],
        "device_ms": times["device_ms"],
        "host_us": times["host_us"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }
    if library_call:
        entry.update(library_call=library_call,
                     library_device_ms=times["library_device_ms"],
                     library_host_us=times["library_host_us"])
    else:
        entry["library_ms_null_because"] = NO_LIBRARY[name]
    return entry


def conv_inputs(dev, batch, f=64):
    """Seeded random conv inputs on the card for a packed batch: nodes,
    edges, fc_full kernel and bias, bn1 scale and bias, neighbors, the
    [N, M] edge mask, and a running mean and var."""
    import numpy as np
    import torch

    n, m, g = batch.edges.shape
    rng = np.random.default_rng(SEED)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return (
        t(rng.standard_normal((n, f))),  # nodes
        batch.edges.to(dev),
        t(rng.standard_normal((2 * f + g, 2 * f)) / np.sqrt(2 * f + g)),
        t(0.1 * rng.standard_normal(2 * f)),  # fc_full bias
        t(rng.uniform(0.5, 1.5, 2 * f)),  # bn1 scale
        t(0.2 * rng.standard_normal(2 * f)),  # bn1 bias
        batch.neighbors.to(dev),
        batch.edge_mask.reshape(n, m).contiguous().to(dev),
        t(0.3 * rng.standard_normal(2 * f)),  # running mean
        t(rng.uniform(0.5, 2.0, 2 * f)),  # running var
    )


def slot_counts(batch):
    mask = batch.edge_mask.reshape(batch.edges.shape[:2]).cpu().numpy() > 0
    return int(mask.sum()), int(mask.any(axis=1).sum())


def conv_bounds(batch, f=64):
    """Kernel 1's bound on a packed batch, counted as the least work (the
    factored z) and, beside it, as z taken whole per slot (the count
    before the node pass existed) -> (cost, bound_ms, bound_by,
    bound_ms_before, bound_by_before)."""
    from cgnn_tpu_torch.ops import fused_cgconv as fc

    n, m, g = batch.edges.shape
    real_slots, real_rows = slot_counts(batch)
    cost = fc.eval_pass_cost(n, m, g, f, real_slots, fc.touched_nodes(
        batch.neighbors.cpu(), batch.edge_mask.cpu(), n))
    before = {"bytes": cost["bytes"],
              "flops": fc.unfactored_flops(f, g, real_slots, real_rows)}
    return (cost, *bound(cost), *bound(before))


def by_launch(fn, parts) -> dict:
    """Device ms of one call of ``fn`` split by launch: ``parts`` maps a
    part's name to a substring of its kernels' names (profiler, 20 calls)."""
    _, by_kernel, _ = device_busy_ms(fn, 20)
    return {part: sum(v for k, v in by_kernel.items() if key in k)
            for part, key in parts.items()}


def kernel_phase(dev, calibration, shape_set):
    """Kernel 1 at the top serving rung against its plain version, timed
    beside its two bounds, its two launches' device times apart."""
    from cgnn_tpu_torch.ops import fused_cgconv as fc

    batch = shape_set.pack_full(calibration, shape=shape_set.largest)
    args = conv_inputs(dev, batch)
    errs = compare("fused_cgconv_eval", fc.fused_cgconv_eval_cuda(*args),
                   fc.fused_cgconv_eval_reference(*args), RTOL, ATOL)
    cost, _, _, before_ms, before_by = conv_bounds(batch)
    entry = kernel_entry(
        "fused_cgconv_eval", "fused_cgconv.cu",
        "cgnn_tpu/ops/pallas_cgconv.py:305", errs,
        timings(cold(fc.fused_cgconv_eval_cuda, *args)),
        time_ms(cold(fc.fused_cgconv_eval_reference, *args)), cost)
    split = by_launch(cold(fc.fused_cgconv_eval_cuda, *args), K1_PARTS)
    print(f"fused_cgconv_eval: bound before the node pass {before_ms!r} ms "
          f"({before_by}); device ms by launch {split}")
    entry.update(bound_ms_before=before_ms, bound_by_before=before_by,
                 device_ms_by_launch=split)
    return entry


def train_kernel_phase(dev, train_graphs):
    """Kernels 2-5 at the training shape (a snug batch-256 pack) against
    their plain versions; kernels 2 and 4 also against themselves, kernel
    2 also on a shared node pass. Kernel 1 at the same shape, its two
    launches apart. -> (entries of kernels 2-5, kernel 1's record at the
    training shape)."""
    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
    from cgnn_tpu_torch.ops import fused_cgconv as fc
    from cgnn_tpu_torch.ops import fused_epilogue as fe

    node_cap, edge_cap = capacities_for(train_graphs, BATCH, dense_m=M)
    batch = next(iter(batch_iterator(train_graphs, BATCH, node_cap,
                                     edge_cap, dense_m=M, in_cap=0,
                                     snug=True)))
    n, m, g = batch.edges.shape
    f = 64
    cargs = conv_inputs(dev, batch)
    nodes, edges, kernel, bias, scale, bn_bias, nbr, emask, _, _ = cargs
    real_slots, real_rows = slot_counts(batch)
    print(f"training shape: N={n} M={m} F={f} G={g}, {real_slots} real "
          f"slots, {int(batch.graph_mask.sum())} structures")
    entries = []

    # kernel 1 at the training shape (the training forward's apply pass)
    k1_errs = compare("fused_cgconv_eval at the training shape",
                      fc.fused_cgconv_eval_cuda(*cargs),
                      fc.fused_cgconv_eval_reference(*cargs), RTOL, ATOL)
    _, bound_ms, bound_by, before_ms, before_by = conv_bounds(batch)
    k1_train = {"N": n, "max_abs_err": k1_errs[0],
                "max_rel_err": k1_errs[1],
                **timings(cold(fc.fused_cgconv_eval_cuda, *cargs)),
                "plain_ms": time_ms(
                    cold(fc.fused_cgconv_eval_reference, *cargs)),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_ms_before": before_ms, "bound_by_before": before_by,
                "device_ms_by_launch": by_launch(
                    cold(fc.fused_cgconv_eval_cuda, *cargs), K1_PARTS)}
    print(f"fused_cgconv_eval at the training shape (N={n}): "
          f"{k1_train['ms']!r} ms a call (device {k1_train['device_ms']!r}"
          f" ms, by launch {k1_train['device_ms_by_launch']}), bound "
          f"{bound_ms!r} ms")

    # kernel 2, the stats pass: alone, again, and on a shared node pass
    shift = fc._shift_row0(nodes, edges, kernel, bias, nbr, torch.float32)
    sargs = (nodes, edges, kernel, bias, nbr, emask, shift)
    got = fc.fused_cgconv_stats_cuda(*sargs)
    again = fc.fused_cgconv_stats_cuda(*sargs)
    p = fc.fused_cgconv_node_cuda(nodes, kernel, bias)
    shared = fc.fused_cgconv_stats_cuda(*sargs, p=p)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "kernel 2 differs from run to run")
    check(torch.equal(got, shared),
          "kernel 2 on a shared node pass differs from kernel 2 alone")
    compare("the node pass (P)", p,
            fc.node_projections_reference(nodes, kernel, bias), RTOL, ATOL)
    errs = compare("fused_cgconv_stats", got,
                   fc.fused_cgconv_stats_reference(*sargs), STATS_RTOL,
                   row_scale=True)
    touched = fc.touched_nodes(batch.neighbors, batch.edge_mask, n)
    cost = fc.stats_pass_cost(n, m, g, f, real_slots, touched)
    before_ms, before_by = bound(
        {"bytes": cost["bytes"],
         "flops": fc.unfactored_flops(f, g, real_slots, real_rows)
         + 3 * real_slots * 2 * f})
    entry = kernel_entry(
        "fused_cgconv_stats", "fused_cgconv.cu",
        "cgnn_tpu/ops/pallas_cgconv.py:277", errs,
        timings(cold(fc.fused_cgconv_stats_cuda, *sargs)),
        time_ms(cold(fc.fused_cgconv_stats_reference, *sargs)), cost)
    split = by_launch(cold(fc.fused_cgconv_stats_cuda, *sargs), K2_PARTS)
    print(f"fused_cgconv_stats: bound before the factored z {before_ms!r} "
          f"ms ({before_by}); device ms by launch {split}")
    entry.update(bound_ms_before=before_ms, bound_by_before=before_by,
                 device_ms_by_launch=split)
    entries.append(entry)

    # kernels 3-5 on the materialized z of the same conv
    z = fc._z_structured(nodes, edges, kernel, bias, nbr,
                         torch.float32).contiguous()
    mean, var, n_real = fe.masked_stats(z, emask)
    cst = fe.pack_cst(mean, torch.rsqrt(var + 1e-5), scale, bn_bias)
    ct = torch.randn(n, f, device=dev,
                     generator=torch.Generator(dev).manual_seed(SEED))
    errs = compare("epilogue_apply", fe.epilogue_apply_cuda(z, emask, cst),
                   fe.epilogue_apply_reference(z, emask, cst), RTOL, ATOL)
    entries.append(kernel_entry(
        "epilogue_apply", "fused_epilogue.cu",
        "cgnn_tpu/ops/fused_epilogue.py:142", errs,
        timings(cold(fe.epilogue_apply_cuda, z, emask, cst)),
        time_ms(cold(fe.epilogue_apply_reference, z, emask, cst)),
        fe.epilogue_pass_cost("apply", n, m, f, real_slots)))

    got = fe.epilogue_reduce_cuda(z, emask, cst, ct)
    again = fe.epilogue_reduce_cuda(z, emask, cst, ct)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "kernel 4 differs from run to run")
    red = fe.epilogue_reduce_reference(z, emask, cst, ct)
    errs = compare("epilogue_reduce", got, red, REDUCE_RTOL, row_scale=True)
    entry = kernel_entry(
        "epilogue_reduce", "fused_epilogue.cu",
        "cgnn_tpu/ops/fused_epilogue.py:152", errs,
        timings(cold(fe.epilogue_reduce_cuda, z, emask, cst, ct)),
        time_ms(cold(fe.epilogue_reduce_reference, z, emask, cst, ct)),
        fe.epilogue_pass_cost("reduce", n, m, f, real_slots))
    entry["device_ms_by_launch"] = by_launch(
        cold(fe.epilogue_reduce_cuda, z, emask, cst, ct), K4_PARTS)
    print(f"epilogue_reduce: device ms by launch "
          f"{entry['device_ms_by_launch']}")
    entries.append(entry)

    inv_c = torch.full((1, 2 * f), 1.0 / max(float(n_real), 1.0),
                       device=dev)
    red5 = torch.cat([red, inv_c]).contiguous()
    errs = compare("epilogue_dz", fe.epilogue_dz_cuda(z, emask, cst, red5, ct),
                   fe.epilogue_dz_reference(z, emask, cst, red5, ct),
                   RTOL, ATOL)
    entries.append(kernel_entry(
        "epilogue_dz", "fused_epilogue.cu",
        "cgnn_tpu/ops/fused_epilogue.py:175", errs,
        timings(cold(fe.epilogue_dz_cuda, z, emask, cst, red5, ct)),
        time_ms(cold(fe.epilogue_dz_reference, z, emask, cst, red5, ct)),
        fe.epilogue_pass_cost("dz", n, m, f, real_slots)))
    return entries, k1_train


def search_kernel_phase(dev, calibration, shape_set):
    """Kernel 8 at the top raw rung against its plain version (every
    output bit-equal, and the same bits on a second run), then on three
    small cells beside a padding slot (exact ties, a queue that flushes
    mid-search, a tie across the M-th slot); and kernel 1 on the
    graph the raw expander builds on the card at that rung. -> (kernel 8's
    entry, kernel 1's record at the top raw rung)."""
    import numpy as np

    from cgnn_tpu_torch.data.rawbatch import (
        RawStructure,
        pack_raw,
        raw_from_graph,
    )
    from cgnn_tpu_torch.data.structure import Structure
    from cgnn_tpu_torch.ops import fused_cgconv as fc
    from cgnn_tpu_torch.ops import neighbor_search as ns

    spec = shape_set.raw
    raws = [r for r in map(raw_from_graph, calibration) if spec.admits(r)]
    rb = shape_set.pack_raw(raws, shape=shape_set.largest).to(dev)
    g, s = rb.atom_mask.shape
    k, m = spec.n_images, spec.dense_m
    print(f"raw top rung: G={g} S={s} K={k} M={m}, {len(raws)} of "
          f"{len(calibration)} calibration structures admitted")
    args = (rb.frac, rb.lattices, rb.atom_mask, ns.offsets_tensor(spec, dev),
            spec.radius, spec.home_image, m)
    errs, filled = search_equal("neighbor_search", args)
    cubic = RawStructure.from_structure(
        Structure(np.eye(3) * 3.0, [[0.0, 0.0, 0.0]], [29]))
    # 8 atoms in a 4 Å cube: ~270 candidates within 8 Å a center, ~67
    # for each of its four warps, more than a warp's 64-key queue holds:
    # the queue flushes into the lane lists mid-search
    dense = RawStructure.from_structure(Structure(
        np.eye(3) * 4.0, np.random.default_rng(11).random((8, 3)),
        [11, 17] * 4))
    small = dataclasses.replace(spec, snode_cap=8, images=(3, 3, 3))
    for label, item, mm in (
            ("exact-tie cubic cell", cubic, m),
            ("dense cell, the queue flushing mid-search", dense, m),
            # 6 first-shell images, then 2 of the 12 tied second-shell
            # ones: the tie at the M-th slot is decided across lanes' lists
            ("exact tie across the M-th slot (M=8)", cubic, 8)):
        tb = pack_raw([item], 2, dataclasses.replace(small, dense_m=mm)
                      ).to(dev)
        search_equal(f"neighbor_search, {label} + a padding slot",
                     (tb.frac, tb.lattices, tb.atom_mask,
                      ns.offsets_tensor(small, dev), small.radius,
                      small.home_image, mm))
    cost = ns.neighbor_search_cost(
        g, s, k, m, real_pairs=sum(r.num_nodes ** 2 for r in raws),
        real_atoms=sum(r.num_nodes for r in raws), filled=filled)
    entry = kernel_entry(
        "neighbor_search", "neighbor_search.cu",
        "cgnn_tpu/ops/neighbor_search.py:136", errs,
        timings(cold(ns.neighbor_search_cuda, *args)),
        time_ms(cold(ns.neighbor_search_reference, *args), calls=5,
                trials=3, warmup=1), cost)
    entry["bound_ms_before"], entry["bound_by_before"] = bound(
        {"bytes": cost["bytes"], "flops": cost["flops_before"]})

    # kernel 1 on the raw path's own graph: N = G*S node slots, padding
    # rows and self-loop slots included, edges from the card's f32 distances
    gb, _, _ = shape_set.raw_expander(device=dev)(rb)
    cargs = conv_inputs(dev, gb)
    k1_errs = compare("fused_cgconv_eval at the top raw rung",
                      fc.fused_cgconv_eval_cuda(*cargs),
                      fc.fused_cgconv_eval_reference(*cargs), RTOL, ATOL)
    n = gb.edges.shape[0]
    _, bound_ms, bound_by, before_ms, before_by = conv_bounds(gb)
    k1_raw = {"N": n, "max_abs_err": k1_errs[0], "max_rel_err": k1_errs[1],
              **timings(cold(fc.fused_cgconv_eval_cuda, *cargs)),
              "plain_ms": time_ms(
                  cold(fc.fused_cgconv_eval_reference, *cargs)),
              "bound_ms": bound_ms, "bound_by": bound_by,
              "bound_ms_before": before_ms, "bound_by_before": before_by}
    print(f"fused_cgconv_eval at the top raw rung (N={n}): {k1_raw['ms']!r} "
          f"ms a call, {k1_raw['plain_ms']!r} ms plain, bound "
          f"{bound_ms!r} ms; kernel 8 max_abs_err {errs[0]!r}, kernel 1 "
          f"max_abs_err {k1_errs[0]!r}")
    return entry, k1_raw


def search_equal(label, args):
    """Kernel 8 twice and its plain version on ``args``: every output
    bit-equal across the three. -> ((max abs, max rel) distance error
    against the plain version, the filled slots)."""
    import torch

    from cgnn_tpu_torch.ops import neighbor_search as ns

    got = ns.neighbor_search_cuda(*args)
    again = ns.neighbor_search_cuda(*args)
    want = ns.neighbor_search_reference(*args)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("neighbors", "distances", "edge_mask",
                              "n_edges"), got, want, again):
        check(torch.equal(a, b), f"{label}: {name} differ from the plain "
                                 f"version's")
        check(torch.equal(a, c), f"{label}: {name} differ from run to run")
    err = (got[1] - want[1]).abs()
    print(f"{label}: neighbors, distances, edge mask and n_edges bit-equal "
          f"to the plain version and on a second run ({int(got[3].sum())} "
          f"edges): ok")
    return ((float(err.max()),
             float((err / want[1].abs().clamp_min(1e-6)).max())),
            int(want[3].sum()))


def serve_phase(dev, calibration, work_dir):
    """The serving path: load_server(wire='raw') at full width, a burst
    of 224 featurized graphs (path 'serve'), then one of 32 wire-form
    structures (path 'serve_raw'), each a run with its own counts; then
    the overflow leg."""
    import numpy as np

    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.data.dataset import load_synthetic_mp
    from cgnn_tpu_torch.data.rawbatch import RawStructure
    from cgnn_tpu_torch.data.synthetic import synthetic_mp_dataset
    from cgnn_tpu_torch.serve.server import load_server, structure_featurizer
    from cgnn_tpu_torch.train.normalizer import Normalizer
    from cgnn_tpu_torch.train.step import InferenceState, make_predict_step

    model_cfg = ModelConfig(dense_m=M, cgconv_impl="pallas")
    data_cfg = DataConfig()
    os.makedirs(work_dir, exist_ok=True)
    npz = os.path.join(work_dir, "params.npz")
    meta = os.path.join(work_dir, "meta.json")
    variables = convert.init_params(model_cfg, data_cfg, seed=SEED)
    convert.save_params(npz, meta, variables, model_cfg, data_cfg,
                        normalizer_mean=[-1.25], normalizer_std=[0.75])
    t0 = time.perf_counter()
    server, info = load_server(npz, meta, batch_size=64, rungs=3,
                               calibration=calibration, device=dev,
                               default_timeout_ms=60_000.0, wire="raw")
    spec = server.shape_set.raw
    check(spec is not None, "load_server(wire='raw') planned no raw spec")
    print(f"serve: load_server + warm {time.perf_counter() - t0!r} s; "
          f"rungs {[tuple(vars(s).values()) for s in server.shape_set]}; "
          f"raw spec {spec.to_meta()}")
    graphs = load_synthetic_mp(N_GRAPHS, data_cfg.featurize_config(),
                               seed=SEED + 1)
    wire = [RawStructure.from_structure(s, cif_id=sid)
            for sid, s, _ in synthetic_mp_dataset(N_WIRE, seed=SEED + 2)]
    n_admitted = sum(spec.admits(r) for r in wire)
    n_conv = model_cfg.n_conv
    # the featurized path's run, then the raw wire's, each with its counts
    runs = {path: burst(server, reqs)
            for path, reqs in (("serve", graphs), ("serve_raw", wire))}
    feat, raw = runs["serve"], runs["serve_raw"]
    check(feat["wires"] == ["featurized"] * len(graphs)
          and feat["raw_flushes"] == 0
          and feat["launches"]["neighbor_search"] == 0
          and feat["launches"]["fused_cgconv_eval"]
          == n_conv * feat["flushes"] > 0,
          f"featurized run: {feat['flushes']} flushes, launches "
          f"{feat['launches']}: want no raw flush, no kernel-8 launch and "
          f"n_conv {n_conv} kernel-1 launches a flush")
    deferred = raw["wires"].count("featurized")
    print(f"serve_raw: {N_WIRE} wire structures ({n_admitted} admitted raw, "
          f"{deferred} featurized on the worker)")
    check(raw["responses_raw"] == n_admitted == raw["wires"].count("raw")
          and deferred == N_WIRE - n_admitted >= 1,
          f"{raw['responses_raw']} raw answers, {deferred} deferred: want "
          f"{n_admitted} raw and at least one deferred")
    check(raw["raw_flushes"] > 0
          and raw["launches"]["neighbor_search"] == raw["raw_flushes"],
          f"{raw['launches']['neighbor_search']} kernel-8 launches != "
          f"{raw['raw_flushes']} raw flushes")
    check(raw["launches"]["fused_cgconv_eval"] == n_conv * raw["flushes"],
          f"{raw['launches']['fused_cgconv_eval']} kernel-1 launches != "
          f"n_conv {n_conv} x {raw['flushes']} flushes (raw and featurized)")
    requests = graphs + wire
    preds = np.concatenate([feat.pop("preds"), raw.pop("preds")])
    wires = feat.pop("wires") + raw.pop("wires")

    # the same weights through the unfused plain path on the card, on
    # host-featurized copies of the wire structures
    plain = build_model(dataclasses.replace(model_cfg, cgconv_impl=""),
                        data_cfg, device=dev)
    plain.load_state_dict(convert.from_flax_variables(variables))
    state = InferenceState(plain, Normalizer.from_arrays([-1.25], [0.75],
                                                         dev))
    featurize = structure_featurizer(data_cfg)
    ref_graphs = graphs + [featurize(s) for s in wire]
    step = make_predict_step()
    big = server.shape_set.largest
    want, chunk = [], []
    for g in ref_graphs + [None]:
        n = sum(x.num_nodes for x in chunk) + (g.num_nodes if g else 0)
        if chunk and (g is None or not big.fits(len(chunk) + 1, n, n * M)):
            out = step(state, server.shape_set.pack_full(chunk).to(dev))
            want.append(out[:len(chunk)].cpu().numpy())
            chunk = []
        if g is not None:
            chunk.append(g)
    want = np.concatenate(want)
    err = np.abs(preds - want)
    raw_rows = np.array(wires) == "raw"
    ok = bool(np.all(err <= SERVE_ATOL + SERVE_RTOL * np.abs(want)))
    print(f"serve: {len(requests)} answers vs the plain path: max_abs_err "
          f"{float(err.max())!r}, raw-wire answers {float(err[raw_rows].max())!r}"
          f" (rtol {SERVE_RTOL}, atol {SERVE_ATOL}): {'ok' if ok else 'FAIL'}")
    check(ok, "served answers disagree with the plain path")
    summary = dict(runs, deferred_featurized=deferred,
                   max_abs_err_vs_plain=float(err.max()),
                   raw_max_abs_err_vs_plain=float(err[raw_rows].max()))
    summary["overflow_leg"], overflow_counts = overflow_leg(
        dev, npz, meta, calibration, n_conv)
    breakdown = flush_breakdown(dev, server.state, server.shape_set,
                                calibration)
    raw_breakdown = raw_flush_breakdown(dev, server, calibration)
    check(server.drain(timeout_s=60), "the serve worker did not drain")
    counts = {"serve": feat["launches"], "serve_raw": raw["launches"],
              "serve_raw_overflow": overflow_counts}
    return summary, breakdown, raw_breakdown, counts


def burst(server, requests):
    """``requests`` from N_CLIENTS threads at once, kernel counts at 0
    just before and read just after -> the answers, their wire forms and
    the run's flushes, launches, requests/s and latency quantiles."""
    import numpy as np

    results = [None] * len(requests)
    errors = []

    def client(k):
        try:
            futs = [(i, server.submit(requests[i]))
                    for i in range(k, len(requests), N_CLIENTS)]
            for i, fut in futs:
                results[i] = fut.result(timeout=120)
        except Exception as e:  # noqa: BLE001 — reported by the check below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,),
                                name=f"chip-smoke-client-{k}")
               for k in range(N_CLIENTS)]
    zero_counts()
    c0 = dict(server.counts)
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(not any(th.is_alive() for th in threads), "a client hung")
    check(not errors, f"client errors: {errors[:3]}")
    check(all(r is not None for r in results), "unanswered requests")
    preds = np.stack([r.prediction for r in results])
    check(preds.shape == (len(requests), 1), f"bad shape {preds.shape}")
    check(bool(np.isfinite(preds).all()), "non-finite predictions")
    delta = {k: server.counts[k] - c0[k]
             for k in ("batches", "pack_raw", "responses_raw")}
    p50, p99 = np.percentile([r.latency_ms for r in results], [50, 99])
    run = {"requests": len(requests), "flushes": delta["batches"],
           "raw_flushes": delta["pack_raw"],
           "responses_raw": delta["responses_raw"], "launches": counts,
           "wall_s": wall, "requests_per_s": len(requests) / wall,
           "latency_ms_p50": float(p50), "latency_ms_p99": float(p99)}
    print(f"serve burst: {run}")
    run.update(preds=preds, wires=[r.wire for r in results])
    return run


def overflow_leg(dev, npz, meta, calibration, n_conv):
    """A one-atom 2 A cubic cell through a server that skips the host
    image-cap check: the device flags its overflow and it is answered
    through the featurized fallback, equal to its featurized answer."""
    import numpy as np

    from cgnn_tpu_torch.data.rawbatch import RawStructure
    from cgnn_tpu_torch.serve.server import load_server, structure_featurizer

    server, info = load_server(npz, meta, batch_size=8, rungs=1,
                               calibration=calibration, device=dev,
                               default_timeout_ms=60_000.0, wire="raw",
                               raw_precheck=False, log_fn=lambda *a: None)
    tiny = RawStructure(np.zeros((1, 3)), np.eye(3) * 2.0,
                        np.array([6], np.int32))
    try:
        # the overflow path's run: counts at 0 just before, read after
        zero_counts()
        res = server.predict(tiny, timeout_ms=60_000)
        counts = read_counts()
        ref = server.predict(structure_featurizer(info["data_cfg"])(tiny),
                             timeout_ms=60_000)
        c = dict(server.counts)
    finally:
        check(server.drain(timeout_s=60), "the serve worker did not drain")
    err = float(np.abs(res.prediction - ref.prediction).max())
    ok = (res.wire == "featurized" and c["ingest_cap_overflow"] == 1
          and c["pack_raw"] == 1 and counts["neighbor_search"] == 1
          and counts["fused_cgconv_eval"] == 2 * n_conv
          and bool(np.allclose(res.prediction, ref.prediction,
                               rtol=SERVE_RTOL, atol=SERVE_ATOL)))
    print(f"overflow leg: answered via the {res.wire} wire, "
          f"ingest_cap_overflow {c['ingest_cap_overflow']}, launches "
          f"{counts}, max_abs_err vs its featurized answer {err!r}: "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the overflow-flagged structure was not answered through "
              "the featurized fallback")
    return {"wire": res.wire,
            "ingest_cap_overflow": c["ingest_cap_overflow"],
            "max_abs_err_vs_featurized": err}, counts


def flush_breakdown(dev, state, shape_set, graphs, reps=10,
                    kernel_key="fused_cgconv_eval_",
                    kernel_label="fused_kernel"):
    """One top-rung flush of ``graphs`` split into its stages, each the
    median of ``reps``: host pack, host-to-device copy, the predict step
    (host wall with a synchronize), and the copy of the answers back. Then
    the step's device busy time per step, from a torch.profiler trace of
    ``reps`` steps: the sum of its kernels' device time, the share of it
    of the hand-written kernel whose name holds ``kernel_key`` (reported
    as ``<kernel_label>_ms_per_step``), and the share of the step's wall
    the device sits idle."""
    import torch

    from cgnn_tpu_torch.train.step import make_predict_step

    step = make_predict_step()
    top = shape_set.largest
    stages = {"pack_ms": [], "h2d_ms": [], "step_wall_ms": [], "d2h_ms": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        batch = shape_set.pack_full(graphs, shape=top)
        t1 = time.perf_counter()
        on_dev = batch.to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = step(state, on_dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.cpu()
        t4 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[key].append(dt * 1e3)
    res = {"graphs": len(graphs),
           "nodes": sum(g.num_nodes for g in graphs),
           "rung": list(vars(top).values())}
    res.update({k: statistics.median(v) for k, v in stages.items()})
    busy_ms, by_kernel, _ = device_busy_ms(lambda: step(state, on_dev), reps)
    if busy_ms is not None:
        ours_ms = sum(v for k, v in by_kernel.items() if kernel_key in k)
        top_k = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        res["step_device_busy_ms"] = busy_ms
        res[f"{kernel_label}_ms_per_step"] = ours_ms
        res[f"{kernel_label}_share_of_busy"] = ours_ms / busy_ms
        res["device_idle_share_of_step"] = 1.0 - busy_ms / res["step_wall_ms"]
        res["top_kernels_ms_per_step"] = {k[:80]: v for k, v in top_k}
    else:  # the profiler saw no device activity on this machine
        res["step_device_busy_ms"] = None
    return res


def raw_flush_breakdown(dev, server, graphs, reps=10):
    """One top-rung raw flush of the admitted ``graphs`` in wire form,
    split like ``flush_breakdown``: host pack (``pack_raw``), host-to-
    device copy, the raw predict step (the device search, featurization
    and model; host wall with a synchronize) and the copy of (predictions,
    overflow, n_edges) back; then the step's host syncs and, from a
    torch.profiler trace, its device busy time with kernel 8's and kernel
    1's shares and the share of the step's wall the device sits idle."""
    import torch

    from cgnn_tpu_torch.data.rawbatch import raw_from_graph

    ss, step, state = server.shape_set, server.predict_step, server.state
    raws = [r for r in map(raw_from_graph, graphs) if ss.admits_raw(r)]
    top = ss.largest
    stages = {"pack_ms": [], "h2d_ms": [], "step_wall_ms": [], "d2h_ms": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        batch = ss.pack_raw(raws, shape=top)
        t1 = time.perf_counter()
        on_dev = batch.to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = step(state, on_dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for t in out:
            t.cpu()
        t4 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[key].append(dt * 1e3)
    res = {"structures": len(raws),
           "atoms": sum(r.num_nodes for r in raws),
           "rung": list(vars(top).values()),
           "snode_cap": ss.raw.snode_cap, "images": list(ss.raw.images)}
    res.update({k: statistics.median(v) for k, v in stages.items()})
    res.update(host_syncs(lambda: step(state, on_dev)))
    busy_ms, by_kernel, _ = device_busy_ms(lambda: step(state, on_dev), reps)
    if busy_ms is None:  # the profiler saw no device activity
        res["step_device_busy_ms"] = None
        return res
    k8 = sum(v for k, v in by_kernel.items() if "neighbor_search_kernel" in k)
    k1 = sum(v for k, v in by_kernel.items()
             if "fused_cgconv_eval_" in k)
    top_k = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    res.update({
        "step_device_busy_ms": busy_ms,
        "search_kernel_ms_per_step": k8,
        "search_kernel_share_of_busy": k8 / busy_ms,
        "fused_kernel_ms_per_step": k1,
        "fused_kernel_share_of_busy": k1 / busy_ms,
        "device_idle_share_of_step": 1.0 - busy_ms / res["step_wall_ms"],
        "device_kernels": len(by_kernel),
        "top_kernels_ms_per_step": {k[:80]: v for k, v in top_k},
    })
    return res


def device_busy_ms(run_step, reps):
    """A torch.profiler trace of ``reps`` calls of ``run_step`` -> (device
    busy ms per call: the sum of its kernels' device time, {kernel name:
    ms per call}, {host op: self CPU ms per call}); the first is None when
    the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run_step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    by_kernel = {e.key: e.self_device_time_total / reps / 1e3
                 for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA}
    by_host_op = {e.key: e.self_cpu_time_total / reps / 1e3 for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU}
    busy = sum(by_kernel.values())
    return (busy if busy > 0 else None), by_kernel, by_host_op


def device_ms(fn, reps=20) -> float | None:
    """Device time of one call of ``fn`` (all its kernels) from a
    torch.profiler trace of ``reps`` calls after a warm-up: the events
    timing of back-to-back calls (``time_ms``) reads the host instead when
    a call's host work outlasts its kernels. None when the trace holds no
    device time."""
    fn()
    return device_busy_ms(fn, reps)[0]


def host_syncs(run_step) -> dict:
    """The operations of one step (``run_step``, after its host-to-device
    copy) that make the host wait for the device, from CUDA sync debug
    mode: their count and, for each, the innermost line of this repository
    on the Python stack (with the number of syncs there)."""
    import collections
    import traceback
    import warnings

    import torch

    sites = collections.Counter()
    here = os.path.dirname(os.path.abspath(__file__))
    in_step = []  # non-empty while run_step runs (not the mode switches)

    def record(message, category, filename, lineno, file=None, line=None):
        if not in_step or "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack if os.path.abspath(f.filename)
                .startswith(here) and "site-packages" not in f.filename]
        f = (ours or stack)[-1]
        sites[f"{os.path.relpath(f.filename, here)}:{f.lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            in_step.append(True)
            run_step()
        finally:
            in_step.clear()
            torch.cuda.set_sync_debug_mode("default")
    return {"host_syncs_per_step": sum(sites.values()),
            "host_sync_sites": dict(sites)}


def new_state(dev, train_graphs, **model_kw):
    """A fresh flagship TrainState (seed SEED, train.py's SGD defaults),
    dense unless ``model_kw`` sets ``dense_m=0`` -> (config, state,
    node_cap, edge_cap)."""
    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.train.state import init_train_state

    cfg = ModelConfig(**({"dense_m": M} | model_kw))
    state, node_cap, edge_cap = init_train_state(
        cfg, DataConfig(), train_graphs, batch_size=BATCH, device=dev,
        seed=SEED)
    return cfg, state, node_cap, edge_cap


def train_phase(dev, split, work_dir):
    """The training path: the port's fit, kernel path, 2 epochs; then the
    trained weights through load_server."""
    import math

    import numpy as np
    import torch

    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.serve.server import load_server
    from cgnn_tpu_torch.train.loop import fit
    from cgnn_tpu_torch.train.step import InferenceState, make_predict_step

    train_g, val_g, test_g = split
    cfg, state, node_cap, _ = new_state(dev, train_g, cgconv_impl="pallas")
    # the training path's run: counts at 0 just before, read just after
    zero_counts()
    t0 = time.perf_counter()
    state, result = fit(state, train_g, val_g, epochs=EPOCHS,
                        batch_size=BATCH, dense_m=M, device=dev,
                        node_cap=node_cap, seed=SEED,
                        log_fn=lambda s: print(f"train: {s}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    hist = result["history"]
    steps = sum(h["train"]["steps"] for h in hist)
    evals = sum(h["val"]["steps"] for h in hist)
    n_conv = cfg.n_conv
    print(f"train: {steps} train steps, {evals} eval batches, launches "
          f"{counts}")
    for name in ("fused_cgconv_stats", "epilogue_reduce", "epilogue_dz"):
        check(counts[name] == n_conv * steps,
              f"{name}: {counts[name]} launches != n_conv {n_conv} x "
              f"{steps} train steps")
    check(counts["fused_cgconv_eval"] == n_conv * (steps + evals),
          f"fused_cgconv_eval: {counts['fused_cgconv_eval']} launches != "
          f"n_conv x ({steps} train steps + {evals} eval batches)")
    # one node pass a conv: shared by the stats and apply passes in a
    # train step, the apply pass's own in an eval batch
    check(counts["fused_cgconv_node"] == n_conv * (steps + evals),
          f"node pass: {counts['fused_cgconv_node']} launches != n_conv x "
          f"({steps} train steps + {evals} eval batches): the training "
          f"forward does not share one node pass a conv")
    check(counts["epilogue_apply"] == 0, "kernel 3 ran on the cgconv path")
    for h in hist:
        vals = (h["train"]["loss"], h["train"]["mae"], h["val"]["mae"])
        check(all(math.isfinite(v) for v in vals),
              f"epoch {h['epoch']}: non-finite loss or MAE {vals}")

    # the trained weights, served
    out_dir = os.path.join(work_dir, "trained")
    os.makedirs(out_dir, exist_ok=True)
    npz = os.path.join(out_dir, "params.npz")
    meta = os.path.join(out_dir, "meta.json")
    convert.save_params(
        npz, meta, convert.to_flax_variables(state.model.state_dict()), cfg,
        DataConfig(), normalizer_mean=state.normalizer.mean.cpu().numpy(),
        normalizer_std=state.normalizer.std.cpu().numpy())
    server, _ = load_server(npz, meta, batch_size=8, rungs=1,
                            calibration=test_g, device=dev,
                            default_timeout_ms=60_000.0,
                            log_fn=lambda *a: None)
    asked = test_g[:8]
    try:
        futs = [server.submit(g) for g in asked]
        preds = np.stack([f.result(timeout=120).prediction for f in futs])
    finally:
        check(server.drain(timeout_s=60), "the serve worker did not drain")
    state.model.eval()
    predict, inf = make_predict_step(), InferenceState(state.model,
                                                       state.normalizer)
    want = np.concatenate([
        predict(inf, server.shape_set.pack_full([g]).to(dev))[:1].cpu()
        .numpy() for g in asked])
    err = float(np.abs(preds - want).max())
    ok = preds.shape == (8, 1) and bool(np.isfinite(preds).all()) and bool(
        np.all(np.abs(preds - want) <= SERVE_ATOL + SERVE_RTOL * np.abs(want)))
    print(f"train: the trained weights served 8 requests, max_abs_err "
          f"{err!r} vs the trained model (rtol {SERVE_RTOL}, atol "
          f"{SERVE_ATOL}): {'ok' if ok else 'FAIL'}")
    check(ok, "the trained weights do not serve the trained model's answers")
    fit_graphs = len(train_g) * EPOCHS
    summary = {
        "structures": [len(train_g), len(val_g), len(test_g)],
        "batch_size": BATCH, "epochs": EPOCHS, "node_cap": node_cap,
        "train_steps": steps, "eval_batches": evals,
        "launches": counts, "fit_wall_s": wall,
        "fit_structures_per_s_incl_val_and_warmup": fit_graphs / wall,
        "train_loss": [h["train"]["loss"] for h in hist],
        "train_mae": [h["train"]["mae"] for h in hist],
        "val_mae": [h["val"]["mae"] for h in hist],
        "served_max_abs_err_vs_trained": err,
    }
    return summary, counts, node_cap


def fixed_batches(dev, train_g, node_cap, k, edge_cap=None, dense_m=M):
    """The first ``k`` shuffled snug training batches (epochs in turn, one
    seeded generator), on the card; ``dense_m=None``: COO batches of
    ``edge_cap`` edges."""
    import numpy as np

    from cgnn_tpu_torch.data.graph import batch_iterator

    rng = np.random.default_rng(SEED + 5)
    edge_cap = node_cap * dense_m if dense_m else edge_cap
    out = []
    while len(out) < k:
        out += list(batch_iterator(train_g, BATCH, node_cap, edge_cap,
                                   shuffle=True, rng=rng, dense_m=dense_m,
                                   snug=True))
    return [b.to(dev) for b in out[:k]]


def compare_trajectories(dev, train_g, batches, label, kernel_kw, plain_kw):
    """The same steps on ``batches`` from the same initial weights through
    the kernel path (``kernel_kw``) and the plain path (``plain_kw``):
    per-step loss and every parameter and running statistic within
    TRAIN_RTOL / TRAIN_ATOL -> (the plain losses, {max diffs})."""
    import torch

    from cgnn_tpu_torch.train.step import make_train_step

    runs = []
    for kw in (kernel_kw, plain_kw):
        _, state, _, _ = new_state(dev, train_g, **kw)
        step = make_train_step()
        losses = [m["loss_sum"] / m["count"]
                  for m in (step(state, b) for b in batches)]
        runs.append((torch.stack(losses).cpu(),
                     {key: v.detach().clone()
                      for key, v in state.model.state_dict().items()}))
    (loss_k, sd_k), (loss_p, sd_p) = runs
    loss_err = float((loss_k - loss_p).abs().max())
    ok = bool(torch.allclose(loss_k, loss_p, rtol=TRAIN_RTOL,
                             atol=TRAIN_ATOL))
    param_err, worst = 0.0, ""
    for key in sd_p:
        e = float((sd_k[key] - sd_p[key]).abs().max())
        if e > param_err:
            param_err, worst = e, key
        ok = ok and bool(torch.allclose(sd_k[key], sd_p[key],
                                        rtol=TRAIN_RTOL, atol=TRAIN_ATOL))
    print(f"{label}: {len(batches)} steps, kernel path vs plain path: "
          f"losses {loss_k.tolist()} vs {loss_p.tolist()}, max loss diff "
          f"{loss_err!r}, max parameter diff {param_err!r} ({worst}) "
          f"(rtol {TRAIN_RTOL}, atol {TRAIN_ATOL}): {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: the kernel path's trajectory leaves the plain "
              f"path's")
    return loss_p, {"steps": len(batches), "max_loss_diff": loss_err,
                    "max_param_diff": param_err, "worst_param": worst}


def trajectory_phase(dev, train_g, val_g, node_cap, k=5):
    """The same k steps through the kernel path and the plain path; then 3
    steps and one eval batch with fused_epilogue='pallas'."""
    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator
    from cgnn_tpu_torch.train.step import make_eval_step, make_train_step

    batches = fixed_batches(dev, train_g, node_cap, k)
    loss_p, diffs = compare_trajectories(
        dev, train_g, batches, "trajectory", {"cgconv_impl": "pallas"},
        {"cgconv_impl": ""})

    cfg, state, _, _ = new_state(dev, train_g, fused_epilogue="pallas")
    val_batch = next(iter(batch_iterator(
        val_g, BATCH, node_cap, node_cap * M, dense_m=M, in_cap=0,
        snug=True))).to(dev)
    train_step, eval_step = make_train_step(), make_eval_step()
    # the fused-epilogue path's run: counts at 0 just before, read after
    zero_counts()
    losses = [m["loss_sum"] / m["count"]
              for m in (train_step(state, b) for b in batches[:3])]
    ev = eval_step(state, val_batch)
    torch.cuda.synchronize()
    counts = read_counts()
    n = cfg.n_conv
    want = dict.fromkeys(counts, 0) | {"epilogue_apply": n * 4,
                                       "epilogue_reduce": n * 3,
                                       "epilogue_dz": n * 3}
    losses = torch.stack(losses).cpu()
    e_err = float((losses - loss_p[:3]).abs().max())
    ok = (counts == want and bool(torch.isfinite(ev["mae_sum"]))
          and bool(torch.allclose(losses, loss_p[:3], rtol=TRAIN_RTOL,
                                  atol=TRAIN_ATOL)))
    print(f"epilogue: 3 steps + 1 eval batch with fused_epilogue='pallas': "
          f"launches {counts} (want {want}); losses {losses.tolist()}, max "
          f"diff vs the plain path {e_err!r}: {'ok' if ok else 'FAIL'}")
    check(ok, "the fused-epilogue path did not run its kernels or "
              "disagrees with the plain path")
    return diffs | {"epilogue_max_loss_diff": e_err}, counts


def train_breakdown(dev, train_g, label, steps=8, **model_kw):
    """The per-step training loop of one setting at the training shape
    (its layout's snug capacities): train structures/s as the loop runs
    (host pack, copy and the step's launches in turn, no extra
    synchronize), then each stage alone (median of ``steps``,
    synchronized), then the step's device busy time and idle share from a
    torch.profiler trace."""
    import numpy as np
    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator
    from cgnn_tpu_torch.train.step import make_train_step

    cfg, state, node_cap, edge_cap = new_state(dev, train_g, **model_kw)
    step = make_train_step()
    rng = np.random.default_rng(SEED + 7)

    def host_batches():
        while True:
            yield from batch_iterator(train_g, BATCH, node_cap, edge_cap,
                                      shuffle=True, rng=rng,
                                      dense_m=cfg.dense_m or None, snug=True)

    it = host_batches()
    for _ in range(2):  # warm-up
        step(state, next(it).to(dev))
    torch.cuda.synchronize()
    graphs = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        batch = next(it)
        graphs += int(batch.graph_mask.sum())
        step(state, batch.to(dev))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    stages = {"pack_ms": [], "h2d_ms": [], "step_wall_ms": []}
    for _ in range(steps):
        t0 = time.perf_counter()
        batch = next(it)
        t1 = time.perf_counter()
        on_dev = batch.to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        step(state, on_dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[key].append(dt * 1e3)
    res = {"path": label, "steps": steps,
           "structures_per_step": graphs / steps,
           "train_structures_per_s": graphs / loop_s,
           "loop_ms_per_step": loop_s * 1e3 / steps}
    res.update({k: statistics.median(v) for k, v in stages.items()})
    on_dev = next(it).to(dev)
    res.update(host_syncs(lambda: step(state, on_dev)))
    on_dev = [next(it).to(dev) for _ in range(steps)]
    queue = iter(on_dev)
    busy_ms, by_kernel, by_host_op = device_busy_ms(
        lambda: step(state, next(queue)), steps)
    if busy_ms is None:  # the profiler saw no device activity
        res["step_device_busy_ms"] = None
        return res
    ours = ("fused_cgconv", "epilogue_", "sum_partials", "segment_sum")
    ours_ms = sum(v for k, v in by_kernel.items()
                  if any(o in k for o in ours))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    top_host = sorted(by_host_op.items(), key=lambda kv: -kv[1])[:8]
    res.update({
        "step_device_busy_ms": busy_ms,
        "device_idle_share_of_step": 1.0 - busy_ms / res["step_wall_ms"],
        "device_idle_share_of_loop": 1.0 - busy_ms / res["loop_ms_per_step"],
        "hand_kernels_ms_per_step": ours_ms,
        "hand_kernels_share_of_busy": ours_ms / busy_ms,
        "device_kernels": len(by_kernel),
        "top_kernels_ms_per_step": {k[:80]: v for k, v in top},
        "host_ms_per_step": sum(by_host_op.values()),
        "top_host_ops_ms_per_step": {k[:60]: v for k, v in top_host},
    })
    return res


def segment_sum_check(dev, label, batch, seed, hub=None):
    """Kernel 6 on one packed COO batch: seeded [E, 64] messages zeroed on
    the padding edges, against its plain version (rtol/atol), bit-identical
    on a second run; then timed beside its plain version and the library
    call ``torch.segment_reduce`` on the same offsets. ``hub``: a real node
    takes the padding edges instead of node N-1 (the centers re-sorted,
    the messages with them, and not zeroed there). -> its record."""
    import numpy as np
    import torch

    from cgnn_tpu_torch.ops import scatter

    e, f = batch.edge_mask.shape[0], 64
    n = batch.nodes.shape[0]
    rng = np.random.default_rng(seed)
    msgs = rng.standard_normal((e, f))
    centers = batch.centers.numpy()
    if hub is None:
        msgs = msgs * batch.edge_mask.numpy()[:, None]
    else:
        centers = np.where(batch.edge_mask.numpy() > 0, centers, hub)
        order = np.argsort(centers, kind="stable")
        centers, msgs = centers[order], msgs[order]
    msgs = torch.from_numpy(msgs.astype(np.float32)).to(dev)
    centers = torch.from_numpy(centers.astype(np.int32)).to(dev)
    offsets = scatter.segment_offsets(centers, n)
    got = scatter.segment_sum_sorted_cuda(msgs, offsets)
    again = scatter.segment_sum_sorted_cuda(msgs, offsets)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{label}: kernel 6 differs from run to "
                                   f"run")
    errs = compare(f"segment_sum_sorted, {label}", got,
                   scatter.segment_sum_sorted_reference(msgs, offsets),
                   RTOL, ATOL)
    real = int(batch.edge_mask.sum())
    spans = np.diff(offsets.cpu().numpy())
    cost = scatter.segment_sum_cost(e, n, f)
    bound_ms, bound_by = bound(cost)
    big = int(np.argmax(spans))
    rec = {"E": e, "N": n, "F": f, "real_edges": real,
           "longest_node": big, "longest_node_edges": int(spans[big]),
           "node_n_minus_1_edges": int(spans[-1]),
           "max_abs_err": errs[0], "max_rel_err": errs[1],
           **timings(cold(scatter.segment_sum_sorted_cuda, msgs, offsets),
                     cold(lambda x, o: torch.segment_reduce(
                         x, "sum", offsets=o, axis=0, unsafe=True),
                          msgs, offsets)),
           "plain_ms": time_ms(
               cold(scatter.segment_sum_sorted_reference, msgs, offsets)),
           "bound_ms": bound_ms, "bound_by": bound_by, "cost": cost}
    print(f"segment_sum_sorted, {label}: {rec}")
    return rec


def coo_kernel_phase(dev, train_graphs, calibration):
    """Kernel 6 at the COO training shape, at the top COO serving rung and
    at the training shape with its padding edges on a real node in the
    middle (N/2); kernel 7 at the dense training shape. -> their two
    entries."""
    from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
    from cgnn_tpu_torch.serve.shapes import plan_shape_set

    node_cap, edge_cap = capacities_for(train_graphs, BATCH)
    train_batch = next(iter(batch_iterator(train_graphs, BATCH, node_cap,
                                           edge_cap, snug=True)))
    train = segment_sum_check(dev, "COO training shape", train_batch, SEED)
    ss = plan_shape_set(calibration, 64, rungs=3)
    serve = segment_sum_check(dev, "top COO serving rung",
                              ss.pack_full(calibration, shape=ss.largest),
                              SEED + 1)
    mid = train_batch.nodes.shape[0] // 2
    hub = segment_sum_check(dev, f"COO training shape, hub at node {mid}",
                            train_batch, SEED, hub=mid)
    k6 = kernel_entry(
        "segment_sum_sorted", "segment_sum.cu",
        "cgnn_tpu/ops/pallas_scatter.py:52",
        (train["max_abs_err"], train["max_rel_err"]), train,
        train["plain_ms"], train.pop("cost"),
        library_call="torch.segment_reduce(messages, 'sum', offsets=offsets, "
                     "axis=0, unsafe=True)")
    serve.pop("cost")
    hub.pop("cost")
    k6.update(training_shape=train, serve_top_rung=serve,
              training_shape_hub_mid=hub)
    k6["coo_rungs"] = [list(vars(s).values()) for s in ss]
    return k6, gather_kernel_phase(dev, train_graphs)


def gather_kernel_phase(dev, train_graphs):
    """Kernel 7 on the dense training batch packed at the node capacity
    rounded up to 128 (N=7,936): bit-equal to its plain version and to
    ``index_select`` (every neighbor lies in its window on a real graph);
    on shuffled indices, out-of-window slots give zeros, bit-equal to the
    plain version. Then timed beside both. -> its entry, with the
    launches of these checks."""
    import numpy as np
    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator, capacities_for
    from cgnn_tpu_torch.ops import windowed_gather as wg

    node_cap, _ = capacities_for(train_graphs, BATCH, dense_m=M)
    n = -(-node_cap // wg.TN) * wg.TN
    batch = next(iter(batch_iterator(train_graphs, BATCH, n, n * M,
                                     dense_m=M, in_cap=0, snug=True)))
    f = 64
    window = wg.window_width(max(g.num_nodes for g in train_graphs))
    rng = np.random.default_rng(SEED + 2)
    nodes = torch.from_numpy(
        rng.standard_normal((n, f)).astype(np.float32)).to(dev)
    nbr = batch.neighbors.to(dev)
    ws = torch.from_numpy(wg.window_starts(n // wg.TN, n, window)).to(dev)
    before = wg.windowed_gather_cuda.launches
    got = wg.windowed_gather_cuda(nodes, nbr, ws, window)
    want = wg.windowed_gather_reference(nodes, nbr, ws, window)
    lib = nodes.index_select(0, nbr).reshape(n, M, f)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "kernel 7 differs from its plain version")
    check(torch.equal(got, lib), "kernel 7 differs from index_select on a "
                                 "real graph")
    shuffled = nbr[torch.randperm(nbr.numel(), device=dev,
                                  generator=torch.Generator(dev)
                                  .manual_seed(SEED))].contiguous()
    got_s = wg.windowed_gather_cuda(nodes, shuffled, ws, window)
    want_s = wg.windowed_gather_reference(nodes, shuffled, ws, window)
    torch.cuda.synchronize()
    zero_rows = int((got_s == 0).all(dim=-1).sum())
    check(torch.equal(got_s, want_s) and zero_rows > 0,
          f"kernel 7 on shuffled indices: {zero_rows} zero rows, or it "
          f"differs from its plain version")
    launches = wg.windowed_gather_cuda.launches - before
    print(f"windowed_gather at N={n} M={M} F={f}, window {window}: bit-equal "
          f"to its plain version and to index_select; shuffled indices: "
          f"{zero_rows} of {shuffled.numel()} slots out of window, zeros, "
          f"bit-equal: ok")
    entry = kernel_entry(
        "windowed_gather", "windowed_gather.cu",
        "cgnn_tpu/ops/pallas_gather.py:55", (0.0, 0.0),
        timings(cold(wg.windowed_gather_cuda, nodes, nbr, ws, window),
                cold(lambda x, i: x.index_select(0, i), nodes, nbr)),
        time_ms(cold(wg.windowed_gather_reference, nodes, nbr, ws, window)),
        wg.windowed_gather_cost(n, M, f),
        library_call="nodes.index_select(0, neighbors)")
    entry.update(path_note=NO_PATH["windowed_gather"],
                 kernel_phase_launches=launches,
                 shape={"N": n, "M": M, "F": f, "window": window,
                        "out_of_window_slots_shuffled": zero_rows})
    return entry


def train_coo_phase(dev, split, work_dir, k=5):
    """Path 'train_coo': fit at full width in the COO layout with
    aggregation='pallas' (kernel 6), 2 epochs; a k-step trajectory against
    aggregation='xla'; the weights saved. -> (summary, counts, weights)."""
    import math

    import torch

    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.train.loop import fit

    train_g, val_g, _ = split
    cfg, state, node_cap, edge_cap = new_state(dev, train_g, dense_m=0,
                                               aggregation=COO_AGG)
    # the COO training path's run: counts at 0 just before, read after
    zero_counts()
    t0 = time.perf_counter()
    state, result = fit(state, train_g, val_g, epochs=EPOCHS,
                        batch_size=BATCH, dense_m=0, device=dev,
                        node_cap=node_cap, edge_cap=edge_cap, seed=SEED,
                        log_fn=lambda s: print(f"train_coo: {s}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    hist = result["history"]
    steps = sum(h["train"]["steps"] for h in hist)
    evals = sum(h["val"]["steps"] for h in hist)
    want = dict.fromkeys(counts, 0) | {
        "segment_sum_sorted": cfg.n_conv * (steps + evals)}
    print(f"train_coo: caps N={node_cap} E={edge_cap}, {steps} train steps, "
          f"{evals} eval batches, launches {counts}")
    check(counts == want, f"train_coo launches {counts} != {want}")
    for h in hist:
        vals = (h["train"]["loss"], h["train"]["mae"], h["val"]["mae"])
        check(all(math.isfinite(v) for v in vals),
              f"train_coo epoch {h['epoch']}: non-finite loss or MAE {vals}")
    out_dir = os.path.join(work_dir, "trained_coo")
    os.makedirs(out_dir, exist_ok=True)
    npz = os.path.join(out_dir, "params.npz")
    meta = os.path.join(out_dir, "meta.json")
    variables = convert.to_flax_variables(state.model.state_dict())
    convert.save_params(
        npz, meta, variables, cfg, DataConfig(),
        normalizer_mean=state.normalizer.mean.cpu().numpy(),
        normalizer_std=state.normalizer.std.cpu().numpy())
    batches = fixed_batches(dev, train_g, node_cap, k, edge_cap=edge_cap,
                            dense_m=None)
    _, traj = compare_trajectories(
        dev, train_g, batches, "trajectory_coo",
        {"dense_m": 0, "aggregation": COO_AGG},
        {"dense_m": 0, "aggregation": "xla"})
    summary = {
        "node_cap": node_cap, "edge_cap": edge_cap, "train_steps": steps,
        "eval_batches": evals, "launches": counts, "fit_wall_s": wall,
        "fit_structures_per_s_incl_val_and_warmup":
            len(train_g) * EPOCHS / wall,
        "train_loss": [h["train"]["loss"] for h in hist],
        "val_mae": [h["val"]["mae"] for h in hist], "trajectory": traj}
    return summary, counts, (npz, meta, variables, cfg)


def serve_coo_phase(dev, calibration, weights):
    """Path 'serve_coo': load_server on the COO weights (wire='auto' must
    log featurized-only), a burst of 224 featurized graphs and 32
    RawStructures featurized at admission from 4 threads; every answer
    against the plain model (aggregation='xla') on host-featurized copies;
    kernel 6 n_conv times a flush; a top-rung flush breakdown."""
    import dataclasses as dc

    import numpy as np

    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig, build_model
    from cgnn_tpu_torch.data.dataset import load_synthetic_mp
    from cgnn_tpu_torch.data.rawbatch import RawStructure
    from cgnn_tpu_torch.data.synthetic import synthetic_mp_dataset
    from cgnn_tpu_torch.serve.server import load_server, structure_featurizer
    from cgnn_tpu_torch.train.step import InferenceState, make_predict_step

    npz, meta, variables, cfg = weights
    data_cfg = DataConfig()
    logs = []
    server, _ = load_server(npz, meta, batch_size=64, rungs=3,
                            calibration=calibration, device=dev,
                            default_timeout_ms=60_000.0, wire="auto",
                            log_fn=lambda s: (logs.append(s), print(s)))
    ss = server.shape_set
    check(ss.dense_m is None and ss.raw is None
          and any("raw wire requires the dense layout; featurized wire only"
                  in s for s in logs),
          f"load_server on COO weights: dense_m {ss.dense_m}, raw "
          f"{ss.raw}, log {logs}")
    graphs = load_synthetic_mp(N_GRAPHS, data_cfg.featurize_config(),
                               seed=SEED + 1)
    wire = [RawStructure.from_structure(s, cif_id=sid)
            for sid, s, _ in synthetic_mp_dataset(N_WIRE, seed=SEED + 2)]
    run = burst(server, graphs + wire)
    preds, wires = run.pop("preds"), run.pop("wires")
    want_counts = dict.fromkeys(run["launches"], 0) | {
        "segment_sum_sorted": cfg.n_conv * run["flushes"]}
    check(run["launches"] == want_counts and run["flushes"] > 0
          and wires == ["featurized"] * len(wires),
          f"serve_coo: {run['flushes']} flushes, launches "
          f"{run['launches']}, want {want_counts}")
    plain = build_model(dc.replace(cfg, aggregation="xla"), data_cfg,
                        device=dev)
    plain.load_state_dict(convert.from_flax_variables(variables))
    state = InferenceState(plain, server.state.normalizer)
    featurize = structure_featurizer(data_cfg)
    ref = graphs + [featurize(s) for s in wire]
    step = make_predict_step()
    want, chunk = [], []
    for g in ref + [None]:
        fits = g is not None and ss.largest.fits(
            len(chunk) + 1, sum(x.num_nodes for x in chunk) + g.num_nodes,
            sum(x.num_edges for x in chunk) + g.num_edges)
        if chunk and not fits:
            out = step(state, ss.pack_full(chunk).to(dev))
            want.append(out[:len(chunk)].cpu().numpy())
            chunk = []
        if g is not None:
            chunk.append(g)
    want = np.concatenate(want)
    err = np.abs(preds - want)
    ok = bool(np.all(err <= SERVE_ATOL + SERVE_RTOL * np.abs(want)))
    print(f"serve_coo: {len(ref)} answers vs the plain model: max_abs_err "
          f"{float(err.max())!r} (rtol {SERVE_RTOL}, atol {SERVE_ATOL}): "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "serve_coo answers disagree with the plain model")
    breakdown = flush_breakdown(dev, server.state, ss, calibration,
                                kernel_key="segment_sum_sorted_kernel",
                                kernel_label="segment_sum_kernel")
    check(server.drain(timeout_s=60), "the serve worker did not drain")
    run.update(rungs=[list(vars(s).values()) for s in ss],
               max_abs_err_vs_plain=float(err.max()))
    return run, breakdown, run["launches"]


def run_main(entry, argv, label):
    """``entry(argv)`` (a port entry point's ``main``) with its standard
    output captured and echoed -> (exit code, the output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = entry(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"{label}: {line}")
    return rc, out


def state_bits(state) -> dict:
    """Every tensor a TrainState carries, as host copies: parameters and
    running statistics, the optimizer's buffers by parameter name, and
    its count."""
    import torch

    bits = {f"model/{k}": v.detach().cpu().clone()
            for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        for k, v in state.optimizer.inner.state.get(p, {}).items():
            bits[f"opt/{name}/{k}"] = torch.as_tensor(v).detach().cpu().clone()
    bits["opt/count"] = torch.as_tensor(state.optimizer.count)
    return bits


def bits_diff(a: dict, b: dict) -> tuple[bool, float, str]:
    """(bit-equal, max abs difference, the key where it is largest)."""
    import torch

    check(set(a) == set(b), f"state keys differ: {set(a) ^ set(b)}")
    equal, worst, where = True, 0.0, ""
    for k in a:
        if not torch.equal(a[k], b[k]):
            equal = False
            d = float((a[k].double() - b[k].double()).abs().max())
            if d >= worst:
                worst, where = d, k
    return equal, worst, where


def checkpoint_predict_phase(dev, work_dir, card):
    """Paths 'train_main', 'predict' and 'predict_raw': the port's train
    entry point at flagship width with the kernel path commits a
    checkpoint a epoch (manifests verified, the best pointer on the
    better save); a state saved by ``CheckpointManager`` restores
    bit-equal; a resumed epoch equals the uninterrupted one; ``--resume``
    continues the entry point's numbering; bulk predict on both wires
    agrees with the plain model. -> (summary, counts by path)."""
    import copy
    import csv as csvmod
    import dataclasses as dc
    import shutil

    import numpy as np
    import torch

    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.data.dataset import (
        load_synthetic,
        train_val_test_split,
    )
    from cgnn_tpu_torch.data.graph import count_batches
    from cgnn_tpu_torch.predict import main as predict_main
    from cgnn_tpu_torch.resilience.integrity import read_manifest, verify_tree
    from cgnn_tpu_torch.serve.shapes import plan_shape_set
    from cgnn_tpu_torch.train.__main__ import main as train_main
    from cgnn_tpu_torch.train.checkpoint import (
        STATE_FILE,
        CheckpointManager,
        load_tree,
    )
    from cgnn_tpu_torch.train.infer import run_fast_inference
    from cgnn_tpu_torch.train.loop import fit
    from cgnn_tpu_torch.train.normalizer import Normalizer
    from cgnn_tpu_torch.train.state import init_train_state
    from cgnn_tpu_torch.train.step import InferenceState

    data_cfg = DataConfig()
    model_cfg = ModelConfig(dense_m=M, cgconv_impl="pallas")
    n_conv = model_cfg.n_conv
    # the entry point's data and split, for the in-memory run below
    graphs = load_synthetic(N_TRAIN_SET, data_cfg.featurize_config(),
                            seed=SEED)
    train_g, val_g, test_g = train_val_test_split(graphs, 0.8, 0.1,
                                                  seed=SEED)

    def fresh():
        return init_train_state(model_cfg, data_cfg, train_g,
                                batch_size=BATCH, device=dev, seed=SEED)

    _, node_cap, edge_cap = fresh()
    steps, evals = (count_batches(g, BATCH, node_cap, edge_cap, snug=True)
                    for g in (train_g, val_g))
    tests = count_batches(test_g, BATCH, node_cap, edge_cap, snug=True)
    ck, own = (os.path.join(work_dir, d) for d in ("ckpt", "ckpt_own"))
    for d in (ck, own, os.path.join(work_dir, "ckpt_out")):
        shutil.rmtree(d, ignore_errors=True)
    argv = ["--synthetic", str(N_TRAIN_SET), "-b", str(BATCH),
            "--cgconv-impl", "pallas", "--ckpt-dir", ck, "--out-dir",
            os.path.join(work_dir, "ckpt_out"), "--print-freq", "0",
            "--seed", str(SEED)]
    counts = {}
    # 1. the train entry point, 2 epochs: 2 committed saves
    zero_counts()
    rc, out = run_main(train_main, argv + ["--epochs", "2"], "train_main")
    torch.cuda.synchronize()
    counts["train_main"] = read_counts()
    check(rc == 0, f"train entry point exited {rc}")
    mgr = CheckpointManager(ck, log_fn=print)
    saves = sorted(n for n in os.listdir(ck) if n.startswith("ckpt-"))
    check(saves == ["ckpt-00000000", "ckpt-00000001"],
          f"2 epochs committed {saves}")
    maes = []
    for name in saves:
        verify_tree(load_tree(os.path.join(ck, name, STATE_FILE)),
                    read_manifest(os.path.join(ck, name)))
        maes.append(json.load(open(os.path.join(ck, name,
                                                "meta.json")))["best_mae"])
    best = json.load(open(os.path.join(ck, "best.json")))["save"]
    check(best == saves[int(maes[1] < maes[0])],
          f"best.json points at {best}; val MAEs {maes}")
    # 2 epochs of train steps and validation batches, then the test split
    want = dict.fromkeys(counts["train_main"], 0) | {
        "fused_cgconv_stats": 2 * n_conv * steps,
        "epilogue_reduce": 2 * n_conv * steps,
        "epilogue_dz": 2 * n_conv * steps,
        "fused_cgconv_eval": n_conv * (2 * (steps + evals) + tests),
        "fused_cgconv_node": n_conv * (2 * (steps + evals) + tests)}
    check(counts["train_main"] == want,
          f"train entry point: launches {counts['train_main']} != {want}")
    print(f"checkpoint: {saves} verified against their manifests, val MAEs "
          f"{maes}, best.json -> {best}: ok")

    # 2. the same run in memory, saved by its own manager every epoch;
    # the restore of its latest save is bit-equal to it
    state = fresh()[0]
    kw = dict(batch_size=BATCH, dense_m=M, device=dev, node_cap=node_cap,
              edge_cap=edge_cap, seed=SEED, log_fn=lambda s: None)
    own_mgr = CheckpointManager(own, log_fn=print)
    save_ms = []

    def save(s, epoch, val_m, is_best):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        own_mgr.save(s, {"epoch": epoch, "best_mae": val_m["mae"]},
                     is_best=is_best)
        save_ms.append((time.perf_counter() - t0) * 1e3)

    state, _ = fit(state, train_g, val_g, epochs=2, on_epoch_end=save, **kw)
    torch.cuda.synchronize()
    saved = state_bits(state)
    # the fresh state is built, and the finalizer's writes drained,
    # outside the timed window: restore_ms is the load, verification and
    # copies alone; finalize_wait_ms is what the async writes had left
    target = fresh()[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    own_mgr.wait()
    finalize_wait_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    restored, meta = own_mgr.restore(target)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    equal, worst, where = bits_diff(state_bits(restored), saved)
    check(equal and meta["epoch"] == 1,
          f"restore differs from the saved state: {worst!r} at {where}")
    main_equal, main_diff, main_where = bits_diff(
        state_bits(mgr.restore(fresh()[0])[0]), saved)
    print(f"checkpoint: {len(saved)} tensors restored bit-equal (count "
          f"{int(saved['opt/count'])}); save caller-thread ms {save_ms}, "
          f"finalizer drain ms {finalize_wait_ms!r}, restore ms "
          f"{restore_ms!r}; the entry point's save vs this "
          f"run: bit-equal {main_equal} (max diff {main_diff!r} at "
          f"{main_where or '-'}): ok")

    # 3. one more epoch from the restored state and from the in-memory
    # one, start_epoch=2, the same seed
    def epoch2(s):
        s, r = fit(s, train_g, val_g, epochs=3, start_epoch=2, **kw)
        h = r["history"][0]
        return state_bits(s), (h["train"]["loss"], h["val"]["mae"])

    again = copy.deepcopy(state)
    mem_bits, mem_loss = epoch2(state)
    res_bits, res_loss = epoch2(restored)
    equal, worst, where = bits_diff(res_bits, mem_bits)
    resumed = {"bit_equal": equal and res_loss == mem_loss,
               "losses": [mem_loss, res_loss], "max_diff": worst,
               "worst": where}
    if not resumed["bit_equal"]:
        # the same epoch from a copy of the in-memory state: does it
        # repeat its own bits? Then again with PyTorch's deterministic
        # algorithms, which replace the CUDA atomic adds of index_add_
        # (segment_sum of the graph pooling, ops/segment.py) by an
        # ordered sum
        rerun_bits, _ = epoch2(copy.deepcopy(again))
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det = [epoch2(copy.deepcopy(again))[0],
                   epoch2(own_mgr.restore(fresh()[0])[0])[0]]
        finally:
            torch.use_deterministic_algorithms(False)
        resumed.update(
            in_memory_repeats_its_bits=bits_diff(rerun_bits, mem_bits)[0],
            bit_equal_with_deterministic_algorithms=bits_diff(*det)[0],
            op="index_add_ (CUDA atomic adds) of segment_sum in the graph "
               "pooling, cgnn_tpu_torch/ops/segment.py")
        ok = all(torch.allclose(res_bits[k].double(), mem_bits[k].double(),
                                rtol=RESUME_RTOL, atol=RESUME_ATOL)
                 for k in mem_bits)
        check(ok and resumed["bit_equal_with_deterministic_algorithms"]
              and not resumed["in_memory_repeats_its_bits"],
              f"the resumed epoch leaves the uninterrupted one: {resumed}")
    print(f"resume: epoch 2 from the restored state vs the in-memory one: "
          f"{resumed}: ok")

    # 4. --resume continues the entry point's run
    zero_counts()
    rc, out = run_main(train_main, argv + ["--epochs", "3", "--resume", ck],
                       "train_main")
    counts["train_main_resume"] = read_counts()
    check(rc == 0 and f"resumed from {ck} at epoch 2" in out
          and "Epoch 2:" in out and "Epoch 0:" not in out,
          f"--resume: rc {rc}, output {out[-400:]!r}")
    want = dict.fromkeys(want, 0) | {  # 1 epoch, then the test split
        "fused_cgconv_stats": n_conv * steps,
        "epilogue_reduce": n_conv * steps, "epilogue_dz": n_conv * steps,
        "fused_cgconv_eval": n_conv * (steps + evals + tests),
        "fused_cgconv_node": n_conv * (steps + evals + tests)}
    check(counts["train_main_resume"] == want,
          f"--resume: launches {counts['train_main_resume']} != {want}")

    # 5. bulk predict on both wires vs the plain model
    plain = InferenceState(
        build_model(dc.replace(model_cfg, cgconv_impl=""), data_cfg,
                    device=dev),
        Normalizer.identity(1, device=dev))
    plain = mgr.restore_for_inference(plain, "latest")
    pred_graphs = load_synthetic(N_PREDICT, data_cfg.featurize_config())
    want, _ = run_fast_inference(
        plain, pred_graphs, BATCH,
        shape_set=plan_shape_set(pred_graphs, BATCH, rungs=2, dense_m=M))
    runs = {}
    for path, wire in (("predict_raw", "raw"), ("predict", "featurized")):
        out_csv = os.path.join(work_dir, f"{path}.csv")
        zero_counts()
        rc, out = run_main(predict_main, [ck, "--synthetic", str(N_PREDICT),
                                          "-b", str(BATCH), "--wire", wire,
                                          "--out", out_csv], path)
        torch.cuda.synchronize()
        counts[path] = read_counts()
        check(rc == 0, f"predict --wire {wire} exited {rc}")
        info = json.loads(next(line for line in out.splitlines()
                               if line.startswith("predict: "))[9:])
        rows = list(csvmod.reader(open(out_csv)))
        got = np.array([[float(x) for x in r[2:]] for r in rows])
        ids_ok = [r[0] for r in rows] == [g.cif_id for g in pred_graphs]
        err = np.abs(got - want)
        ok = ids_ok and got.shape == want.shape and bool(
            np.all(err <= SERVE_ATOL + SERVE_RTOL * np.abs(want)))
        batches = info["batches_raw"] + info["batches_featurized"]
        want_counts = dict.fromkeys(counts[path], 0) | {
            "fused_cgconv_eval": n_conv * batches,
            "fused_cgconv_node": n_conv * batches,
            "neighbor_search": info["batches_raw"]}
        print(f"{path}: {N_PREDICT} structures ({info['raw']} on the raw "
              f"wire), {batches} batches, launches {counts[path]}; CSV ids "
              f"in input order {ids_ok}, max_abs_err vs the plain model "
              f"{float(err.max())!r} (rtol {SERVE_RTOL}, atol {SERVE_ATOL})"
              f": {'ok' if ok and counts[path] == want_counts else 'FAIL'}")
        check(ok, f"{path}: the CSV disagrees with the plain model")
        check(counts[path] == want_counts and batches > 0
              and (wire == "featurized" or info["batches_raw"] > 0),
              f"{path}: launches {counts[path]} != {want_counts}")
        runs[path] = dict(info, max_abs_err_vs_plain=float(err.max()))
    mgr.close()
    own_mgr.close()
    summary = {
        "card": card, "saves": saves, "val_mae": maes, "best": best,
        "save_caller_thread_ms": save_ms,
        "finalize_wait_ms": finalize_wait_ms, "restore_ms": restore_ms,
        "restored_tensors": len(saved),
        "entry_point_save_bit_equal_to_in_memory_run": main_equal,
        "resumed_epoch": resumed,
        "predict_structures_per_s": {
            w: runs[p]["structures_per_s"]
            for p, w in (("predict", "featurized"), ("predict_raw", "raw"))},
        "predict": runs["predict"], "predict_raw": runs["predict_raw"]}
    return summary, counts


def write_cif_directory(root, n, seed):
    """``n`` MP-like synthetic structures as ``{id}.cif`` + id_prop.csv
    under ``root`` (emptied first), written by the port's
    ``write_cif_file`` -> the ids in order."""
    import shutil

    import numpy as np

    from cgnn_tpu_torch.data.cif import write_cif_file
    from cgnn_tpu_torch.data.synthetic import synthetic_mp_dataset

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ids, rows = [], []
    for sid, s, t in synthetic_mp_dataset(n, seed=seed):
        write_cif_file(s, os.path.join(root, f"{sid}.cif"), name=sid)
        rows.append(f"{sid},{float(np.atleast_1d(t)[0])!r}")
        ids.append(sid)
    with open(os.path.join(root, "id_prop.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return ids


GRAPH_FIELDS = ("atom_fea", "edge_fea", "centers", "neighbors", "target",
                "target_mask", "distances", "positions", "lattice",
                "offsets")


def graphs_bit_equal(got, want) -> bool:
    import numpy as np

    if [g.cif_id for g in got] != [g.cif_id for g in want]:
        return False
    for a, b in zip(got, want):
        for f in GRAPH_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            if (x is None) != (y is None):
                return False
            if x is not None and not (
                    np.asarray(x).dtype == np.asarray(y).dtype
                    and np.array_equal(np.asarray(x), np.asarray(y))):
                return False
    return True


def loader_breakdown(dev, train_g, loader, steps=8):
    """The per-step training loop (kernel path, batch 256) fed through the
    prefetch loader (``loader``) or with each batch packed and copied on
    this thread: loop ms a step, the loader's wait a step, then the
    device's busy time (profiler, copies included) and its idle share of
    the loop."""
    import numpy as np
    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator, count_batches
    from cgnn_tpu_torch.data.loader import LoaderStats, prefetch_to_device
    from cgnn_tpu_torch.train.step import make_train_step

    _, state, node_cap, edge_cap = new_state(dev, train_g,
                                             cgconv_impl="pallas")
    step = make_train_step()
    rng = np.random.default_rng(SEED + 7)

    def host_batches():
        while True:
            yield from batch_iterator(train_g, BATCH, node_cap, edge_cap,
                                      shuffle=True, rng=rng, dense_m=M,
                                      snug=True)

    stats = LoaderStats()
    staged = (prefetch_to_device(host_batches(), dev, size=2, stats=stats)
              if loader else (b.to(dev) for b in host_batches()))
    try:
        for _ in range(2):  # warm-up
            step(state, next(staged))
        torch.cuda.synchronize()
        wait0 = stats.loader_wait_s
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, next(staged))
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        wait_s = stats.loader_wait_s - wait0
        busy_ms, by_kernel, _ = device_busy_ms(
            lambda: step(state, next(staged)), steps)
    finally:
        staged.close()
    per_batch = len(train_g) / count_batches(train_g, BATCH, node_cap,
                                             edge_cap, snug=True)
    res = {"loader": loader, "steps": steps,
           "loop_ms_per_step": loop_s * 1e3 / steps,
           "train_structures_per_s": per_batch * steps / loop_s,
           "loader_wait_ms_per_step": wait_s * 1e3 / steps if loader
           else None,
           "loader_put_ms_per_batch": (stats.loader_put_s * 1e3
                                       / max(stats.batches, 1)) if loader
           else None,
           "step_device_busy_ms": busy_ms}
    if busy_ms is not None:
        res["device_idle_share_of_loop"] = 1.0 - busy_ms / res[
            "loop_ms_per_step"]
        res["top_device_ops_ms_per_step"] = {
            k[:80]: v for k, v in sorted(by_kernel.items(),
                                         key=lambda kv: -kv[1])[:6]}
    print(f"loader_breakdown: {res}")
    return res


def compact_flush_breakdown(dev, server, graphs, reps=10):
    """One top-rung compact flush of ``graphs`` on a compact server, split
    like ``flush_breakdown``: host pack into a pinned staging buffer, the
    asynchronous host-to-device copy (synchronized), the predict step
    (expander and model; host wall with a synchronize), the copy back;
    the bytes staged beside the full form's; the expander's device time
    alone and the step's device busy time and idle share (profiler)."""
    import torch

    ss, step, state = server.shape_set, server.predict_step, server.state
    top = ss.largest
    buf = ss.buffer_factory(top, pin=dev.type == "cuda")()
    stages = {"pack_ms": [], "h2d_ms": [], "step_wall_ms": [], "d2h_ms": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        batch = ss.pack(graphs, shape=top, out=buf)
        t1 = time.perf_counter()
        on_dev = batch.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = step(state, on_dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.cpu()
        t4 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[key].append(dt * 1e3)
    full = ss.pack_full(graphs, shape=top)
    res = {"graphs": len(graphs), "nodes": sum(g.num_nodes for g in graphs),
           "rung": list(vars(top).values()),
           "staged_bytes": sum(t.nbytes for t in batch.tensors()),
           "full_staged_bytes": sum(
               v.nbytes for v in vars(full).values()
               if isinstance(v, torch.Tensor))}
    res.update({k: statistics.median(v) for k, v in stages.items()})
    expander = ss.expander(dev)
    res["expander_device_ms"] = device_ms(lambda: expander(on_dev))
    busy_ms, by_kernel, _ = device_busy_ms(lambda: step(state, on_dev), reps)
    res["step_device_busy_ms"] = busy_ms
    if busy_ms is not None:
        k1 = sum(v for k, v in by_kernel.items() if "fused_cgconv_eval_" in k)
        res.update({
            "fused_kernel_ms_per_step": k1,
            "device_idle_share_of_step": 1.0 - busy_ms / res["step_wall_ms"],
            "top_kernels_ms_per_step": {
                k[:80]: v for k, v in sorted(by_kernel.items(),
                                             key=lambda kv: -kv[1])[:6]}})
    return res


def cif_pipeline_phase(dev, work_dir, card, calibration):
    """Paths 'train_cif', 'predict_compact', 'predict_cif_full',
    'predict_cif_raw' and 'serve_compact': CIF directory -> preprocess ->
    cache -> train -> predict (compact, full, raw) -> compact serving
    (module docstring, item 8). -> (summary, counts by path, the loader
    and compact flush breakdowns)."""
    import csv as csvmod
    import dataclasses as dc
    import shutil

    import numpy as np
    import torch

    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.data.cache import load_graph_cache
    from cgnn_tpu_torch.data.dataset import (
        load_cif_directory,
        load_synthetic_mp,
        train_val_test_split,
    )
    from cgnn_tpu_torch.data.graph import count_batches
    from cgnn_tpu_torch.data.preprocess import main as preprocess_main
    from cgnn_tpu_torch.predict import main as predict_main
    from cgnn_tpu_torch.serve.server import load_server
    from cgnn_tpu_torch.serve.shapes import plan_shape_set
    from cgnn_tpu_torch.train.__main__ import main as train_main
    from cgnn_tpu_torch.train.checkpoint import CheckpointManager
    from cgnn_tpu_torch.train.infer import run_fast_inference
    from cgnn_tpu_torch.train.normalizer import Normalizer
    from cgnn_tpu_torch.train.state import init_train_state
    from cgnn_tpu_torch.train.step import InferenceState

    data_cfg = DataConfig()
    model_cfg = ModelConfig(dense_m=M, cgconv_impl="pallas")
    n_conv = model_cfg.n_conv
    cif_dir = os.path.join(work_dir, "cif")
    cache = os.path.join(work_dir, "cif_graphs.npz")
    counts, summary = {}, {"card": card, "structures": N_CIF}

    # 1. the CIF directory
    t0 = time.perf_counter()
    ids = write_cif_directory(cif_dir, N_CIF, SEED + 11)
    summary["write_cifs_s"] = time.perf_counter() - t0

    # 2. the preprocess entry point, 8 worker processes
    if os.path.exists(cache):
        os.remove(cache)
    t0 = time.perf_counter()
    rc, _ = run_main(preprocess_main, [cif_dir, "-o", cache, "-j",
                                       str(PREPROCESS_WORKERS)],
                     "preprocess")
    pre_s = time.perf_counter() - t0
    check(rc == 0, f"preprocess exited {rc}")
    graphs = load_graph_cache(cache)
    t0 = time.perf_counter()
    direct = load_cif_directory(cif_dir, data_cfg.featurize_config())
    serial_s = time.perf_counter() - t0
    equal = graphs_bit_equal(graphs, direct)
    print(f"preprocess: {len(graphs)} structures, -j {PREPROCESS_WORKERS} "
          f"in {pre_s!r} s "
          f"({len(graphs) / pre_s!r} structures/s), in-process "
          f"load_cif_directory {serial_s!r} s; cache bit-equal to it: "
          f"{'ok' if equal else 'FAIL'}")
    check(equal and [g.cif_id for g in graphs] == ids,
          "the preprocessed cache differs from load_cif_directory")
    summary.update(preprocess_s=pre_s,
                   preprocess_structures_per_s=len(graphs) / pre_s,
                   load_cif_directory_s=serial_s,
                   atoms=sum(g.num_nodes for g in graphs))

    # 3. the train entry point from DIR --cache
    train_g, val_g, test_g = train_val_test_split(graphs, 0.8, 0.1,
                                                  seed=SEED)
    _, node_cap, edge_cap = init_train_state(model_cfg, data_cfg, train_g,
                                             batch_size=BATCH, device=dev,
                                             seed=SEED)
    steps, evals, tests = (count_batches(g, BATCH, node_cap, edge_cap,
                                         snug=True)
                           for g in (train_g, val_g, test_g))
    ck = os.path.join(work_dir, "cif_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    argv = [cif_dir, "--cache", cache, "-b", str(BATCH), "--epochs",
            str(EPOCHS), "--cgconv-impl", "pallas", "--ckpt-dir", ck,
            "--out-dir", os.path.join(work_dir, "cif_out"), "--print-freq",
            "0", "--seed", str(SEED)]
    zero_counts()
    t0 = time.perf_counter()
    rc, out = run_main(train_main, argv, "train_cif")
    torch.cuda.synchronize()
    summary["train_wall_s"] = time.perf_counter() - t0
    counts["train_cif"] = read_counts()
    check(rc == 0 and f"loaded {N_CIF} graphs from {cache}" in out,
          f"train entry point on the cache: rc {rc}")
    want = dict.fromkeys(counts["train_cif"], 0) | {
        "fused_cgconv_stats": EPOCHS * n_conv * steps,
        "epilogue_reduce": EPOCHS * n_conv * steps,
        "epilogue_dz": EPOCHS * n_conv * steps,
        "fused_cgconv_eval": n_conv * (EPOCHS * (steps + evals) + tests),
        "fused_cgconv_node": n_conv * (EPOCHS * (steps + evals) + tests)}
    check(counts["train_cif"] == want,
          f"train_cif: launches {counts['train_cif']} != {want}")
    summary["train"] = {"split": [len(train_g), len(val_g), len(test_g)],
                        "steps_per_epoch": steps, "node_cap": node_cap}

    # 4. the per-step loop with the loader and without it, in turns
    loader = [loader_breakdown(dev, train_g, on)
              for on in (True, False, False, True)]

    # 5. the predict entry point: compact and full on the cache, raw wire
    # from the directory, against the plain model on the card
    plain = InferenceState(
        build_model(dc.replace(model_cfg, cgconv_impl=""), data_cfg,
                    device=dev),
        Normalizer.identity(1, device=dev))
    mgr = CheckpointManager(ck)
    plain = mgr.restore_for_inference(plain, "latest")
    mgr.close()
    want_preds, _ = run_fast_inference(
        plain, graphs, CIF_PREDICT_BATCH,
        shape_set=plan_shape_set(graphs, CIF_PREDICT_BATCH, rungs=2,
                                 dense_m=M))
    runs, preds, rates = {}, {}, {}
    flags_of = {
        "predict_compact": ["--cache", cache, "--wire", "featurized",
                            "--compact", "on"],
        "predict_cif_full": ["--cache", cache, "--wire", "featurized",
                             "--compact", "off"],
        "predict_cif_raw": ["--wire", "raw", "--compact", "on"]}
    # compact and full in turns (A, B, B, A); each path's first run is
    # the one its counts and checks come from
    for path in ("predict_compact", "predict_cif_full", "predict_cif_full",
                 "predict_compact", "predict_cif_raw"):
        flags = flags_of[path]
        out_csv = os.path.join(work_dir, f"{path}.csv")
        head = [ck, cif_dir] if path == "predict_cif_raw" else [ck]
        zero_counts()
        rc, out = run_main(predict_main, head + flags + [
            "--pack-workers", "2", "-b", str(CIF_PREDICT_BATCH), "--out",
            out_csv], path)
        torch.cuda.synchronize()
        if path in runs:  # the repeat: its rate only
            check(rc == 0, f"{path}: predict exited {rc}")
            rates[path].append(json.loads(next(
                line for line in out.splitlines()
                if line.startswith("predict: "))[9:])["structures_per_s"])
            continue
        counts[path] = read_counts()
        check(rc == 0, f"{path}: predict exited {rc}")
        info = json.loads(next(line for line in out.splitlines()
                               if line.startswith("predict: "))[9:])
        rows = list(csvmod.reader(open(out_csv)))
        got = np.array([[float(x) for x in r[2:]] for r in rows])
        err = np.abs(got - want_preds)
        ok = ([r[0] for r in rows] == ids and got.shape == want_preds.shape
              and bool(np.all(err <= SERVE_ATOL
                              + SERVE_RTOL * np.abs(want_preds))))
        batches = info["batches_raw"] + info["batches_featurized"]
        want_counts = dict.fromkeys(counts[path], 0) | {
            "fused_cgconv_eval": n_conv * batches,
            "fused_cgconv_node": n_conv * batches,
            "neighbor_search": info["batches_raw"]}
        print(f"{path}: {N_CIF} structures ({info['raw']} raw-staged, "
              f"compact {info['compact']}), {batches} batches, launches "
              f"{counts[path]}, pipeline {info['pipeline']}; max_abs_err vs "
              f"the plain model {float(err.max())!r}: "
              f"{'ok' if ok and counts[path] == want_counts else 'FAIL'}")
        check(ok, f"{path}: the CSV disagrees with the plain model")
        check(counts[path] == want_counts and batches > 0,
              f"{path}: launches {counts[path]} != {want_counts}")
        check(info["compact"] == (path != "predict_cif_full"),
              f"{path}: compact staging {info['compact']}")
        runs[path] = dict(info, max_abs_err_vs_plain=float(err.max()))
        preds[path] = got
        rates[path] = [info["structures_per_s"]]
    check(runs["predict_compact"]["pipeline"]["buffers_reused"]
          > 4 * runs["predict_compact"]["pipeline"]["buffers_allocated"] > 0,
          f"the pooled buffers did not recycle: "
          f"{runs['predict_compact']['pipeline']}")
    check(runs["predict_cif_raw"]["batches_raw"] > 0,
          "predict --wire raw staged nothing raw")
    compact_vs_full = float(np.abs(preds["predict_compact"]
                                   - preds["predict_cif_full"]).max())
    check(bool(np.allclose(preds["predict_compact"],
                           preds["predict_cif_full"], rtol=SERVE_RTOL,
                           atol=SERVE_ATOL)),
          f"compact and full CSVs differ by {compact_vs_full!r}")

    # 6. compact serving: a flush broken down, then the 224-graph burst
    npz = os.path.join(work_dir, "params.npz")
    meta = os.path.join(work_dir, "meta.json")
    kw = dict(batch_size=64, rungs=3, calibration=calibration, device=dev,
              default_timeout_ms=60_000.0, wire="featurized",
              log_fn=lambda *a: None)
    server, _ = load_server(npz, meta, compact="on", **kw)
    check(server.shape_set.compact is not None,
          "load_server(compact='on') planned no compact spec")
    breakdown = compact_flush_breakdown(dev, server, calibration)
    burst_graphs = load_synthetic_mp(N_GRAPHS, data_cfg.featurize_config(),
                                     seed=SEED + 1)

    def fresh():
        # new graph objects: no admission verdict cached from a burst
        return [dc.replace(g) for g in burst_graphs]

    # the compactability probe's host time a graph: one graph a call (the
    # JAX package's admission probe), then the worker's batched pass
    probe_us = {}
    for how, probe in (("one_at_a_time", fresh()), ("batched", fresh())):
        t0 = time.perf_counter()
        if how == "batched":
            ok = all(server.shape_set.compact.compactable_many(probe))
        else:
            ok = all(server.shape_set.compactable(g) for g in probe)
        probe_us[how] = (time.perf_counter() - t0) / len(probe) * 1e6
        check(ok, "a burst graph cannot stage compactly")
    full_server, _ = load_server(npz, meta, compact="off", **kw)
    c0 = dict(server.counts)
    comp = burst(server, fresh())
    counts["serve_compact"] = comp["launches"]
    packed = {k: server.counts[k] - c0[k] for k in ("pack_compact",
                                                    "pack_full")}
    # then full, full, compact: the A/B in turns, requests/s each
    full = burst(full_server, fresh())
    turns = [("full", full), ("full", burst(full_server, fresh())),
             ("compact", burst(server, fresh()))]
    check(server.drain(timeout_s=60), "the compact server did not drain")
    check(full_server.drain(timeout_s=60), "the full server did not drain")
    err = float(np.abs(comp["preds"] - full["preds"]).max())
    ok = (packed == {"pack_compact": comp["flushes"], "pack_full": 0}
          and comp["launches"]["fused_cgconv_eval"]
          == n_conv * comp["flushes"] > 0
          and comp["launches"]["neighbor_search"] == 0
          and bool(np.allclose(comp["preds"], full["preds"],
                               rtol=SERVE_RTOL, atol=SERVE_ATOL)))
    print(f"serve_compact: {N_GRAPHS} graphs, {comp['flushes']} flushes "
          f"{packed}, launches {comp['launches']}; max_abs_err vs the full "
          f"server {err!r}: {'ok' if ok else 'FAIL'}")
    check(ok, "the compact server's flushes or answers are off")
    for r in [comp] + [r for _, r in turns]:
        r.pop("preds")
        r.pop("wires")
    summary.update(
        predict_structures_per_s=rates,
        predict=runs, predict_compact_vs_full_max_abs_diff=compact_vs_full,
        serve_compact=dict(comp, packed=packed,
                           max_abs_err_vs_full_server=err,
                           probe_us_per_graph=probe_us),
        serve_turns=[(form, {k: r[k] for k in (
            "flushes", "requests_per_s", "latency_ms_p50",
            "latency_ms_p99")}) for form, r in [("compact", comp)] + turns])
    return summary, counts, {"loader_breakdown": loader,
                             "compact_flush_breakdown": breakdown}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.data.dataset import (
        load_synthetic_mp,
        train_val_test_split,
    )
    from cgnn_tpu_torch.data.rawbatch import plan_raw_spec
    from cgnn_tpu_torch.ops import _build
    from cgnn_tpu_torch.serve.shapes import plan_shape_set

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    _build.build(["fused_cgconv", "fused_epilogue", "neighbor_search",
                  "segment_sum", "windowed_gather"])
    print(f"kernel build: {time.perf_counter() - t0!r} s")
    for name, info in _build.build_info.items():
        for line in info["log"].splitlines():
            # each function's properties line names it; then its spills
            # and registers
            if any(key in line for key in ("Function properties",
                                           "registers", "spill")):
                print(f"  {name}: {line.strip()}")
    # geometry kept: the raw wire plans its caps from the lattices
    calibration = load_synthetic_mp(64, seed=SEED, keep_geometry=True)
    fcfg = DataConfig().featurize_config()
    shape_set = plan_shape_set(
        calibration, 64, rungs=3, dense_m=M,
        raw=plan_raw_spec(calibration, fcfg.gdf(), fcfg.radius, M))
    t0 = time.perf_counter()
    split = train_val_test_split(load_synthetic_mp(N_TRAIN_SET,
                                                   seed=SEED + 3),
                                 0.8, 0.1, seed=SEED)
    print(f"featurized {N_TRAIN_SET} training structures in "
          f"{time.perf_counter() - t0!r} s")
    kernels = [kernel_phase(dev, calibration, shape_set)]
    train_entries, kernels[0]["train_shape"] = train_kernel_phase(
        dev, split[0])
    kernels += train_entries
    search_entry, kernels[0]["raw_top_rung"] = search_kernel_phase(
        dev, calibration, shape_set)
    kernels.append(search_entry)
    kernels += coo_kernel_phase(dev, split[0], calibration)
    work_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke")
    summary, breakdown, raw_breakdown, by_path = serve_phase(
        dev, calibration, work_dir)
    train_summary, train_counts, node_cap = train_phase(dev, split, work_dir)
    traj, epi_counts = trajectory_phase(dev, split[0], split[1], node_cap)
    breakdowns = [train_breakdown(dev, split[0], "kernel path",
                                  cgconv_impl="pallas"),
                  train_breakdown(dev, split[0], "plain path"),
                  train_breakdown(dev, split[0], "COO kernel path",
                                  dense_m=0, aggregation=COO_AGG)]
    coo_train, coo_train_counts, coo_weights = train_coo_phase(
        dev, split, work_dir)
    coo_serve, coo_breakdown, coo_serve_counts = serve_coo_phase(
        dev, calibration, coo_weights)
    ckpt_summary, ckpt_counts = checkpoint_predict_phase(dev, work_dir, card)
    cif_summary, cif_counts, cif_breakdowns = cif_pipeline_phase(
        dev, work_dir, card, calibration)
    by_path.update(train_cgconv_pallas=train_counts,
                   train_fused_epilogue_pallas=epi_counts,
                   train_coo=coo_train_counts, serve_coo=coo_serve_counts,
                   **ckpt_counts, **cif_counts)
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        if k["name"] in NO_PATH:  # no path exists: the kernel phase's
            check(k["launches"] == 0 and k["kernel_phase_launches"] > 0,
                  f"{k['name']}: {k['launches_by_path']} on paths, "
                  f"{k['kernel_phase_launches']} in the kernel phase")
            k["launches"] = k["kernel_phase_launches"]
            continue
        check(k["launches"] > 0, f"{k['name']} never launched on a path")
    print(json.dumps({"flush_breakdown": breakdown}, allow_nan=False))
    print(json.dumps({"raw_flush_breakdown": raw_breakdown},
                     allow_nan=False))
    for b in breakdowns:
        print(json.dumps({"train_breakdown": b}, allow_nan=False))
    print(json.dumps({"train": train_summary, "trajectory": traj},
                     allow_nan=False))
    print(json.dumps({"serve": summary}, allow_nan=False))
    print(json.dumps({"coo_flush_breakdown": coo_breakdown},
                     allow_nan=False))
    print(json.dumps({"train_coo": coo_train, "serve_coo": coo_serve},
                     allow_nan=False))
    print(json.dumps({"checkpoint_predict": ckpt_summary}, allow_nan=False))
    print(json.dumps(cif_breakdowns, allow_nan=False))
    print(json.dumps({"cif_pipeline": cif_summary}, allow_nan=False))
    print(f"chip_smoke: {time.perf_counter() - t_start!r} s in all")
    print(json.dumps({"kernels": kernels}, allow_nan=False))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}, allow_nan=False))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
