#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cgnn_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

It builds the hand-written kernels from ``cgnn_tpu_torch/ops/csrc`` with
nvcc (into ``build/kernels``), then:

1. kernel phase — at the flagship CGCNN's top serving rung (N=1784 nodes,
   M=12 slots, F=64, G=41, a real packed batch of MP-like structures with
   seeded random features and conv parameters), holds each kernel against
   its plain PyTorch version on the card (rtol 1e-4 / atol 1e-5) and times
   both with CUDA events beside the card's bound for the same work;
2. serve phase — boots ``load_server`` on seeded random weights at full
   width (``cgconv_impl='pallas'``, batch 64, 3 rungs), answers 256
   MP-like requests (224 featurized graphs + 32 wire structures) from 4
   client threads, checks every answer against the unfused plain model on
   the card (rtol 1e-4 / atol 1e-4) and that the kernel launched exactly
   ``n_conv`` times per flush, and reports requests/s and latency.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
a serve summary line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line. Without CUDA it exits 2 and prints no result.
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
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-4  # model outputs (|y| ~ 10-100)
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SEED = 0
N_CLIENTS, N_GRAPHS, N_WIRE = 4, 224, 32


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


def kernel_phase(dev, calibration, shape_set):
    """Each kernel at the main path's shapes against its plain version."""
    import numpy as np
    import torch

    from cgnn_tpu_torch.ops import fused_cgconv as fc

    top = shape_set.largest
    batch = shape_set.pack_full(calibration, shape=top)
    n, m, g = batch.edges.shape
    f = 64
    rng = np.random.default_rng(SEED)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    args = (
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
    got = fc.fused_cgconv_eval_cuda(*args)
    torch.cuda.synchronize()
    want = fc.fused_cgconv_eval_reference(*args)
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-6)).max())
    close = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
    print(f"fused_cgconv_eval at N={n} M={m} F={f} G={g}: max_abs_err="
          f"{max_abs!r} max_rel_err={max_rel!r} "
          f"(rtol {RTOL}, atol {ATOL}): {'ok' if close else 'FAIL'}")
    check(close, "fused_cgconv_eval kernel disagrees with its plain version")
    ms = time_ms(lambda: fc.fused_cgconv_eval_cuda(*args))
    plain_ms = time_ms(lambda: fc.fused_cgconv_eval_reference(*args))
    mask = batch.edge_mask.reshape(n, m).numpy() > 0
    cost = fc.eval_pass_cost(n, m, g, f, real_slots=int(mask.sum()),
                             real_rows=int(mask.any(axis=1).sum()))
    bytes_ms = cost["bytes"] / PEAK_BYTES * 1e3
    ops_ms = cost["flops"] / PEAK_F32_FLOPS * 1e3
    print(f"fused_cgconv_eval: {ms!r} ms a call, {plain_ms!r} ms plain; "
          f"{cost['flops']} FLOP, {cost['bytes']} B -> bound "
          f"{max(bytes_ms, ops_ms)!r} ms")
    return {
        "name": "fused_cgconv_eval",
        "route": "cuda",
        "source": "cgnn_tpu_torch/ops/csrc/fused_cgconv.cu",
        "replaces": "cgnn_tpu/ops/pallas_cgconv.py:305",
        "launches": 0,  # set from the serve phase's main-path run
        "max_abs_err": max_abs,
        "max_rel_err": max_rel,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes this op
    }


def serve_phase(dev, calibration, work_dir):
    """The port's main path: load_server at full width, 256 requests."""
    import numpy as np
    import torch

    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig, ModelConfig, build_model
    from cgnn_tpu_torch.data.dataset import load_synthetic_mp
    from cgnn_tpu_torch.data.synthetic import synthetic_mp_dataset
    from cgnn_tpu_torch.ops.fused_cgconv import fused_cgconv_eval_cuda
    from cgnn_tpu_torch.serve.server import load_server, structure_featurizer
    from cgnn_tpu_torch.train.normalizer import Normalizer
    from cgnn_tpu_torch.train.step import InferenceState, make_predict_step

    model_cfg = ModelConfig(dense_m=12, cgconv_impl="pallas")
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
    # the main path's run: counts at 0 just before, read just after
    fused_cgconv_eval_cuda.launches = 0
    flushes0 = server.counts["batches"]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    wall = time.perf_counter() - t0
    launches = fused_cgconv_eval_cuda.launches
    flushes = server.counts["batches"] - flushes0
    check(not any(th.is_alive() for th in threads), "a client hung")
    lat = server.latency_quantiles()
    check(server.drain(timeout_s=60), "the serve worker did not drain")
    check(not errors, f"client errors: {errors[:3]}")
    check(all(r is not None for r in results), "unanswered requests")
    preds = np.stack([r.prediction for r in results])
    check(preds.shape == (len(requests), 1), f"bad shape {preds.shape}")
    check(bool(np.isfinite(preds).all()), "non-finite predictions")
    check(launches > 0, "the kernel never launched on the main path")
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
        if chunk and (g is None or not big.fits(len(chunk) + 1, n, n * 12)):
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
    return summary, breakdown, launches


def flush_breakdown(dev, state, shape_set, graphs, reps=10):
    """One top-rung flush of ``graphs`` split into its stages, each the
    median of ``reps``: host pack, host-to-device copy, the predict step
    (host wall with a synchronize), and the copy of the answers back. Then
    the step's device busy time per step, from a torch.profiler trace of
    ``reps`` steps: the sum of its kernels' device time, the fused
    kernel's share of it, and the share of the step's wall the device
    sits idle."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step(state, on_dev)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels) / reps
    fused_us = sum(e.self_device_time_total for e in kernels
                   if "fused_cgconv_eval_kernel" in e.key) / reps
    if busy_us > 0:
        res["step_device_busy_ms"] = busy_us / 1e3
        res["fused_kernel_ms_per_step"] = fused_us / 1e3
        res["fused_kernel_share_of_busy"] = fused_us / busy_us
        res["device_idle_share_of_step"] = 1.0 - (busy_us / 1e3
                                                  / res["step_wall_ms"])
    else:  # the profiler saw no device activity on this machine
        res["step_device_busy_ms"] = None
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cgnn_tpu_torch.data.dataset import load_synthetic_mp
    from cgnn_tpu_torch.ops import _build
    from cgnn_tpu_torch.serve.shapes import plan_shape_set

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    _build.build(["fused_cgconv"])
    print(f"kernel build: {time.perf_counter() - t0!r} s")
    for name, info in _build.build_info.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    calibration = load_synthetic_mp(64, seed=SEED)
    shape_set = plan_shape_set(calibration, 64, rungs=3, dense_m=12)
    kernels = [kernel_phase(dev, calibration, shape_set)]
    work_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke")
    summary, breakdown, launches = serve_phase(dev, calibration, work_dir)
    kernels[0]["launches"] = launches
    print(json.dumps({"flush_breakdown": breakdown}, allow_nan=False))
    print(json.dumps({"kernels": kernels}, allow_nan=False))
    print(json.dumps({"serve": summary}, allow_nan=False))
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
