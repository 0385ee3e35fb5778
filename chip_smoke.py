#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cgnn_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

It builds the hand-written kernels from ``cgnn_tpu_torch/ops/csrc`` with
nvcc (``fused_cgconv.cu`` and ``fused_epilogue.cu``, one nvcc each, in
parallel, into ``build/kernels``), then:

1. kernel phase — holds each of the five kernels against its plain PyTorch
   version on the card and times both with CUDA events beside the card's
   bound for the same work. Kernel 1 (the whole-conv apply pass) runs at
   the flagship CGCNN's top serving rung (N=1784 nodes, M=12 slots, F=64,
   G=41); kernels 2-5 (the stats pass, and the fused epilogue's apply,
   reduce and dz passes) at the training shape, a snug batch-256 pack of
   MP-like structures (N=7408). Seeded random features and conv
   parameters. Tolerances: elementwise outputs rtol 1e-4 / atol 1e-5;
   kernel 2's and 4's column sums within 1e-4 / 5e-4 of their row's
   largest entry (sums of ~10^5 terms in another order), and bit-identical
   when run again;
2. serve phase — boots ``load_server`` on seeded random weights at full
   width (``cgconv_impl='pallas'``, batch 64, 3 rungs), answers 256
   MP-like requests (224 featurized graphs + 32 wire structures) from 4
   client threads, checks every answer against the unfused plain model on
   the card (rtol 1e-4 / atol 1e-4) and that kernel 1 launched exactly
   ``n_conv`` times per flush, and reports requests/s and latency;
3. train phase — the port's ``fit`` at full width with
   ``cgconv_impl='pallas'``: 512 MP-like training structures (64 for
   validation), batch 256, train.py's SGD defaults, 2 epochs. Kernels 2, 4
   and 5 must launch exactly n_conv x train steps times and kernel 1
   n_conv x (train steps + eval batches); losses and MAEs finite; the
   trained weights are saved, served by ``load_server`` (8 requests, held
   to the trained model's own answers);
4. trajectory check — the same 5 steps on fixed batches from the same
   initial weights through the kernel path and the unfused plain path on
   the card: per-step loss and every final parameter and running statistic
   within rtol 1e-3 / atol 1e-4 (f32, 5 SGD steps). A 3-step run with
   ``fused_epilogue='pallas'`` (then one eval batch) must launch kernels
   3, 4 and 5 and give the plain path's first 3 losses;
5. train breakdown — for the kernel path and the plain path: train
   structures/s of the per-step loop, and a step split into host pack,
   host-to-device copy and step wall, with the device's busy time and
   idle share from a ``torch.profiler`` trace.

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
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SEED = 0
N_CLIENTS, N_GRAPHS, N_WIRE = 4, 224, 32
M = 12  # the flagship's max_num_nbr: dense edge slots per node
BATCH, EPOCHS = 256, 2
N_TRAIN_SET = 640  # split 0.8 / 0.1 / 0.1 -> 512 train, 64 val, 64 test
NO_LIBRARY = {
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


def kernel_wrappers() -> dict:
    """Each kernel's wrapper by name; ``.launches`` is its count."""
    from cgnn_tpu_torch.ops import fused_cgconv as fc
    from cgnn_tpu_torch.ops import fused_epilogue as fe

    return {"fused_cgconv_eval": fc.fused_cgconv_eval_cuda,
            "fused_cgconv_stats": fc.fused_cgconv_stats_cuda,
            "epilogue_apply": fe.epilogue_apply_cuda,
            "epilogue_reduce": fe.epilogue_reduce_cuda,
            "epilogue_dz": fe.epilogue_dz_cuda}


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


def kernel_entry(name, source, replaces, errs, ms, plain_ms, cost):
    """One kernel's record for the ``kernels`` line; the bound is the
    larger of its compulsory bytes at HBM rate and its f32 operations at
    the non-tensor-core peak."""
    bytes_ms = cost["bytes"] / PEAK_BYTES * 1e3
    ops_ms = cost["flops"] / PEAK_F32_FLOPS * 1e3
    print(f"{name}: {ms!r} ms a call, {plain_ms!r} ms plain; "
          f"{cost['flops']} FLOP, {cost['bytes']} B -> bound "
          f"{max(bytes_ms, ops_ms)!r} ms; library_ms null: "
          f"{NO_LIBRARY[name]}")
    return {
        "name": name,
        "route": "cuda",
        "source": f"cgnn_tpu_torch/ops/csrc/{source}",
        "replaces": replaces,
        "launches": 0,  # set from the main-path runs
        "max_abs_err": errs[0],
        "max_rel_err": errs[1],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None,
    }


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
    mask = batch.edge_mask.reshape(batch.edges.shape[:2]).numpy() > 0
    return int(mask.sum()), int(mask.any(axis=1).sum())


def kernel_phase(dev, calibration, shape_set):
    """Kernel 1 at the top serving rung against its plain version."""
    from cgnn_tpu_torch.ops import fused_cgconv as fc

    batch = shape_set.pack_full(calibration, shape=shape_set.largest)
    n, m, g = batch.edges.shape
    args = conv_inputs(dev, batch)
    errs = compare("fused_cgconv_eval", fc.fused_cgconv_eval_cuda(*args),
                   fc.fused_cgconv_eval_reference(*args), RTOL, ATOL)
    ms = time_ms(lambda: fc.fused_cgconv_eval_cuda(*args))
    plain_ms = time_ms(lambda: fc.fused_cgconv_eval_reference(*args))
    real_slots, real_rows = slot_counts(batch)
    return kernel_entry(
        "fused_cgconv_eval", "fused_cgconv.cu",
        "cgnn_tpu/ops/pallas_cgconv.py:305", errs, ms, plain_ms,
        fc.eval_pass_cost(n, m, g, 64, real_slots, real_rows))


def train_kernel_phase(dev, train_graphs):
    """Kernels 2-5 at the training shape (a snug batch-256 pack) against
    their plain versions; kernels 2 and 4 also against themselves."""
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
    nodes, edges, kernel, bias, scale, bn_bias, nbr, emask, _, _ = (
        conv_inputs(dev, batch))
    real_slots, real_rows = slot_counts(batch)
    print(f"training shape: N={n} M={m} F={f} G={g}, {real_slots} real "
          f"slots, {int(batch.graph_mask.sum())} structures")
    entries = []

    # kernel 2, the stats pass
    shift = fc._shift_row0(nodes, edges, kernel, bias, nbr, torch.float32)
    sargs = (nodes, edges, kernel, bias, nbr, emask, shift)
    got = fc.fused_cgconv_stats_cuda(*sargs)
    again = fc.fused_cgconv_stats_cuda(*sargs)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "kernel 2 differs from run to run")
    errs = compare("fused_cgconv_stats", got,
                   fc.fused_cgconv_stats_reference(*sargs), STATS_RTOL,
                   row_scale=True)
    entries.append(kernel_entry(
        "fused_cgconv_stats", "fused_cgconv.cu",
        "cgnn_tpu/ops/pallas_cgconv.py:277", errs,
        time_ms(lambda: fc.fused_cgconv_stats_cuda(*sargs)),
        time_ms(lambda: fc.fused_cgconv_stats_reference(*sargs)),
        fc.stats_pass_cost(n, m, g, f, real_slots, real_rows)))

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
        time_ms(lambda: fe.epilogue_apply_cuda(z, emask, cst)),
        time_ms(lambda: fe.epilogue_apply_reference(z, emask, cst)),
        fe.epilogue_pass_cost("apply", n, m, f, real_slots)))

    got = fe.epilogue_reduce_cuda(z, emask, cst, ct)
    again = fe.epilogue_reduce_cuda(z, emask, cst, ct)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "kernel 4 differs from run to run")
    red = fe.epilogue_reduce_reference(z, emask, cst, ct)
    errs = compare("epilogue_reduce", got, red, REDUCE_RTOL, row_scale=True)
    entries.append(kernel_entry(
        "epilogue_reduce", "fused_epilogue.cu",
        "cgnn_tpu/ops/fused_epilogue.py:152", errs,
        time_ms(lambda: fe.epilogue_reduce_cuda(z, emask, cst, ct)),
        time_ms(lambda: fe.epilogue_reduce_reference(z, emask, cst, ct)),
        fe.epilogue_pass_cost("reduce", n, m, f, real_slots)))

    inv_c = torch.full((1, 2 * f), 1.0 / max(float(n_real), 1.0),
                       device=dev)
    red5 = torch.cat([red, inv_c]).contiguous()
    errs = compare("epilogue_dz", fe.epilogue_dz_cuda(z, emask, cst, red5, ct),
                   fe.epilogue_dz_reference(z, emask, cst, red5, ct),
                   RTOL, ATOL)
    entries.append(kernel_entry(
        "epilogue_dz", "fused_epilogue.cu",
        "cgnn_tpu/ops/fused_epilogue.py:175", errs,
        time_ms(lambda: fe.epilogue_dz_cuda(z, emask, cst, red5, ct)),
        time_ms(lambda: fe.epilogue_dz_reference(z, emask, cst, red5, ct)),
        fe.epilogue_pass_cost("dz", n, m, f, real_slots)))
    return entries


def serve_phase(dev, calibration, work_dir):
    """The serving path: load_server at full width, 256 requests."""
    import numpy as np

    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.data.dataset import load_synthetic_mp
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
                               default_timeout_ms=60_000.0)
    print(f"serve: load_server + warm {time.perf_counter() - t0!r} s; "
          f"rungs {[tuple(vars(s).values()) for s in server.shape_set]}")
    graphs = load_synthetic_mp(N_GRAPHS, data_cfg.featurize_config(),
                               seed=SEED + 1)
    wire = [s for _, s, _ in synthetic_mp_dataset(N_WIRE, seed=SEED + 2)]
    requests = graphs + wire
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
    # the serving path's run: counts at 0 just before, read just after
    zero_counts()
    flushes0 = server.counts["batches"]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["fused_cgconv_eval"]
    flushes = server.counts["batches"] - flushes0
    check(not any(th.is_alive() for th in threads), "a client hung")
    lat = server.latency_quantiles()
    check(server.drain(timeout_s=60), "the serve worker did not drain")
    check(not errors, f"client errors: {errors[:3]}")
    check(all(r is not None for r in results), "unanswered requests")
    preds = np.stack([r.prediction for r in results])
    check(preds.shape == (len(requests), 1), f"bad shape {preds.shape}")
    check(bool(np.isfinite(preds).all()), "non-finite predictions")
    check(launches > 0, "the kernel never launched on the serving path")
    check(launches == model_cfg.n_conv * flushes,
          f"{launches} kernel launches != n_conv {model_cfg.n_conv} x "
          f"{flushes} flushes")

    # the same weights through the unfused plain path on the card
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
    ok = bool(np.all(err <= SERVE_ATOL + SERVE_RTOL * np.abs(want)))
    print(f"serve: {len(requests)} answers vs the plain path: max_abs_err "
          f"{float(err.max())!r} (rtol {SERVE_RTOL}, atol {SERVE_ATOL}): "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "served answers disagree with the plain path")
    summary = {
        "requests": len(requests), "flushes": flushes,
        "kernel_launches": launches, "wall_s": wall,
        "requests_per_s": len(requests) / wall,
        "latency_ms_p50": lat["p50"], "latency_ms_p99": lat["p99"],
        "max_abs_err_vs_plain": float(err.max()),
    }
    breakdown = flush_breakdown(dev, server.state, server.shape_set,
                                calibration)
    return summary, breakdown, counts


def flush_breakdown(dev, state, shape_set, graphs, reps=10):
    """One top-rung flush of ``graphs`` split into its stages, each the
    median of ``reps``: host pack, host-to-device copy, the predict step
    (host wall with a synchronize), and the copy of the answers back. Then
    the step's device busy time per step, from a torch.profiler trace of
    ``reps`` steps: the sum of its kernels' device time, the fused
    kernel's share of it, and the share of the step's wall the device
    sits idle."""
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
        fused_ms = sum(v for k, v in by_kernel.items()
                       if "fused_cgconv_eval_kernel" in k)
        res["step_device_busy_ms"] = busy_ms
        res["fused_kernel_ms_per_step"] = fused_ms
        res["fused_kernel_share_of_busy"] = fused_ms / busy_ms
        res["device_idle_share_of_step"] = 1.0 - busy_ms / res["step_wall_ms"]
    else:  # the profiler saw no device activity on this machine
        res["step_device_busy_ms"] = None
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
    """A fresh flagship TrainState (seed SEED, train.py's SGD defaults)."""
    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.train.state import init_train_state

    cfg = ModelConfig(dense_m=M, **model_kw)
    state, node_cap = init_train_state(cfg, DataConfig(), train_graphs,
                                       batch_size=BATCH, device=dev,
                                       seed=SEED)
    return cfg, state, node_cap


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
    cfg, state, node_cap = new_state(dev, train_g, cgconv_impl="pallas")
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


def fixed_batches(dev, train_g, node_cap, k):
    """The first ``k`` shuffled snug training batches (epochs in turn, one
    seeded generator), on the card."""
    import numpy as np

    from cgnn_tpu_torch.data.graph import batch_iterator

    rng = np.random.default_rng(SEED + 5)
    out = []
    while len(out) < k:
        out += list(batch_iterator(train_g, BATCH, node_cap, node_cap * M,
                                   shuffle=True, rng=rng, dense_m=M,
                                   snug=True))
    return [b.to(dev) for b in out[:k]]


def trajectory_phase(dev, train_g, val_g, node_cap, k=5):
    """The same k steps through the kernel path and the plain path; then 3
    steps and one eval batch with fused_epilogue='pallas'."""
    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator
    from cgnn_tpu_torch.train.step import make_eval_step, make_train_step

    batches = fixed_batches(dev, train_g, node_cap, k)
    runs = {}
    for impl in ("pallas", ""):
        _, state, _ = new_state(dev, train_g, cgconv_impl=impl)
        step = make_train_step()
        losses = [m["loss_sum"] / m["count"]
                  for m in (step(state, b) for b in batches)]
        runs[impl] = (torch.stack(losses).cpu(),
                      {key: v.detach().clone()
                       for key, v in state.model.state_dict().items()})
    (loss_k, sd_k), (loss_p, sd_p) = runs["pallas"], runs[""]
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
    print(f"trajectory: {k} steps, kernel path vs plain path: losses "
          f"{loss_k.tolist()} vs {loss_p.tolist()}, max loss diff "
          f"{loss_err!r}, max parameter diff {param_err!r} ({worst}) "
          f"(rtol {TRAIN_RTOL}, atol {TRAIN_ATOL}): {'ok' if ok else 'FAIL'}")
    check(ok, "the kernel path's trajectory leaves the plain path's")

    cfg, state, _ = new_state(dev, train_g, fused_epilogue="pallas")
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
    want = {"fused_cgconv_eval": 0, "fused_cgconv_stats": 0,
            "epilogue_apply": n * 4, "epilogue_reduce": n * 3,
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
    return {"steps": k, "max_loss_diff": loss_err,
            "max_param_diff": param_err, "worst_param": worst,
            "epilogue_max_loss_diff": e_err}, counts


def train_breakdown(dev, train_g, node_cap, label, steps=8, **model_kw):
    """The per-step training loop of one conv setting at the training
    shape: train structures/s as the loop runs (host pack, copy and the
    step's launches in turn, no extra synchronize), then each stage alone
    (median of ``steps``, synchronized), then the step's device busy time
    and idle share from a torch.profiler trace."""
    import numpy as np
    import torch

    from cgnn_tpu_torch.data.graph import batch_iterator
    from cgnn_tpu_torch.train.step import make_train_step

    _, state, _ = new_state(dev, train_g, **model_kw)
    step = make_train_step()
    rng = np.random.default_rng(SEED + 7)

    def host_batches():
        while True:
            yield from batch_iterator(train_g, BATCH, node_cap,
                                      node_cap * M, shuffle=True, rng=rng,
                                      dense_m=M, snug=True)

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
    ours = ("fused_cgconv", "epilogue_", "sum_partials")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cgnn_tpu_torch.data.dataset import (
        load_synthetic_mp,
        train_val_test_split,
    )
    from cgnn_tpu_torch.ops import _build
    from cgnn_tpu_torch.serve.shapes import plan_shape_set

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    _build.build(["fused_cgconv", "fused_epilogue"])
    print(f"kernel build: {time.perf_counter() - t0!r} s")
    for name, info in _build.build_info.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    calibration = load_synthetic_mp(64, seed=SEED)
    shape_set = plan_shape_set(calibration, 64, rungs=3, dense_m=M)
    t0 = time.perf_counter()
    split = train_val_test_split(load_synthetic_mp(N_TRAIN_SET,
                                                   seed=SEED + 3),
                                 0.8, 0.1, seed=SEED)
    print(f"featurized {N_TRAIN_SET} training structures in "
          f"{time.perf_counter() - t0!r} s")
    kernels = [kernel_phase(dev, calibration, shape_set)]
    kernels += train_kernel_phase(dev, split[0])
    work_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke")
    summary, breakdown, serve_counts = serve_phase(dev, calibration,
                                                   work_dir)
    train_summary, train_counts, node_cap = train_phase(dev, split, work_dir)
    traj, epi_counts = trajectory_phase(dev, split[0], split[1], node_cap)
    breakdowns = [train_breakdown(dev, split[0], node_cap, "kernel path",
                                  cgconv_impl="pallas"),
                  train_breakdown(dev, split[0], node_cap, "plain path")]
    by_path = {"serve": serve_counts, "train_cgconv_pallas": train_counts,
               "train_fused_epilogue_pallas": epi_counts}
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        check(k["launches"] > 0, f"{k['name']} never launched on a path")
    print(json.dumps({"flush_breakdown": breakdown}, allow_nan=False))
    for b in breakdowns:
        print(json.dumps({"train_breakdown": b}, allow_nan=False))
    print(json.dumps({"train": train_summary, "trajectory": traj},
                     allow_nan=False))
    print(json.dumps({"serve": summary}, allow_nan=False))
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
