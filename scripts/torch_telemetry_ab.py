#!/usr/bin/env python3
"""Train steps/s of the epoch driver at each telemetry level, in
interleaved turns, in one process on one card.

    python3 scripts/torch_telemetry_ab.py [--n 2048] [--tile 32] \
        [--epochs 4] [--turns 5] \
        [--variants off,step,off_blocking,step_blocking] \
        [--out build/telemetry_ab.json]

The flagship at full width (F=64, 3 convs, h=128, M=12, 8 A, the kernel
path ``cgconv_impl='pallas'``) trains with ``fit`` under the epoch driver
(device-resident, compact staging as the train entry point stages on a
card, one bucket, batch 256, SGD, guard on as the entry point's default,
no checkpoint hook: the deferred pair fetch) on N synthetic structures
featurized once (split 0.8/0.1/0.1), the training split repeated
``--tile`` times (2048 x 0.8 x 32 / 256: 204 train steps an epoch), a
fresh state from one seed each run, no profiler (``--traced``: each run
under ``torch.profiler`` with CUDA activity, as ``chip_smoke.py``'s
paths run; each run then also reports the card's kernel time and
launches over the whole run, warm-up and capture included).

Variants: ``off``, ``epoch``, ``step``; step level's two parts apart,
``health`` (the in-graph grad-health metrics, no tap) and ``tap`` (the
ring write, no grad health); and ``off_blocking`` / ``step_blocking``,
``off`` / ``step`` with every event wait of the pair fetch and the
stream's drain thread a blocking ``Event.synchronize()`` in place of
the polling ``wait_event``. A turn runs each variant once, in the given
order on even turns and reversed on odd ones.

Each run prints one JSON line: train steps/s over epochs 2..E (their
train steps over the sum of their ``fit`` history seconds, which tile
the wall from epoch 1's fetch to the last epoch's: train, eval and the
bookkeeping), the train loss of the last epoch, and at step level the
stream's own device rate (CUDA events at chunk ends) and its records.
Then one summary line: each variant's runs, median, min, max and spread
((max - min) / median), the ratio of its median to ``off``'s, and its
per-turn ratios to the same turn's ``off`` (min, median, max), beside
the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit``). Needs a card (``--device cpu``: a
rehearsal at small sizes, no timing meaning).
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

VARIANTS = ("off", "epoch", "step", "health", "tap", "off_blocking",
            "step_blocking")


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except OSError:
        return "not measured (no nvidia-smi)"


def telemetry_for(variant: str, log_dir: str):
    """The Telemetry of a variant: a level, or step level with one of its
    two parts switched off (``health``: no tap; ``tap``: no grad
    health)."""
    from cgnn_tpu_torch.observe.telemetry import Telemetry

    level = {"health": "step", "tap": "step",
             "off_blocking": "off",
             "step_blocking": "step"}.get(variant, variant)
    tel = Telemetry(level, log_dir)
    if variant == "health":
        tel.stream = None
    elif variant == "tap":
        tel.step_level = False
    return tel


@contextlib.contextmanager
def blocking_waits(on: bool):
    """While on: the pair fetch's and the drain thread's event waits are
    a blocking ``Event.synchronize()``."""
    from cgnn_tpu_torch.observe import stream
    from cgnn_tpu_torch.train import metrics

    saved = stream.wait_event, metrics.wait_event
    if on:
        def blocking(event, poll_s=0.0):
            event.synchronize()

        stream.wait_event = metrics.wait_event = blocking
    try:
        yield
    finally:
        stream.wait_event, metrics.wait_event = saved


def run_once(variant: str, data, epochs: int, seed: int, device: str,
             traced: bool = False) -> dict:
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from cgnn_tpu_torch.config import DataConfig, ModelConfig
    from cgnn_tpu_torch.train.loop import fit
    from cgnn_tpu_torch.train.state import init_train_state

    train_g, val_g, spec, batch = data
    cfg = ModelConfig(dense_m=12, cgconv_impl="pallas")
    state, nc, ec = init_train_state(cfg, DataConfig(), train_g,
                                     batch_size=batch, device=device,
                                     seed=seed)
    prof = (profile(activities=[ProfilerActivity.CUDA]) if traced
            else contextlib.nullcontext())
    with tempfile.TemporaryDirectory() as log_dir, prof, \
            blocking_waits(variant.endswith("_blocking")):
        tel = telemetry_for(variant, log_dir)
        _, res = fit(state, train_g, val_g, epochs=epochs, batch_size=batch,
                     dense_m=12, device=device, node_cap=nc, edge_cap=ec,
                     seed=seed, scan_epochs=True, compact=spec, guard=True,
                     log_fn=lambda *a: None, telemetry=tel)
        recs = tel.stream.records("train") if tel.stream is not None else []
        tel.close()
    kernels = {}
    if traced:
        import torch

        cuda = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = {"device_ms": sum(e.self_device_time_total
                                    for e in cuda) / 1e3,
                   "launches": sum(e.count for e in cuda)}
    hist = res["history"][1:]
    secs = sum(h["seconds"] for h in hist)
    steps = sum(h["train"]["steps"] for h in hist)
    out = {"variant": variant,
           "train_steps_per_s": steps / secs,
           "train_steps": steps,
           "steady_seconds": secs,
           "train_loss_last": res["history"][-1]["train"]["loss"],
           "graphs": res["graphs"], **kernels}
    if recs:
        rates = [r["steps_per_s"] for r in recs if "steps_per_s" in r]
        out.update(stream_records=len(recs),
                   stream_steps_per_s_median=float(np.median(rates)))
    return out


def summarize(runs: list) -> dict:
    by, per_turn = {}, {}
    off = {r["turn"]: r["train_steps_per_s"] for r in runs
           if r["variant"] == "off"}
    for r in runs:
        by.setdefault(r["variant"], []).append(r["train_steps_per_s"])
        if r["turn"] in off:
            per_turn.setdefault(r["variant"], []).append(
                r["train_steps_per_s"] / off[r["turn"]])
    out = {}
    for v, x in by.items():
        med = statistics.median(x)
        out[v] = {"runs": x, "median": med, "min": min(x), "max": max(x),
                  "spread": (max(x) - min(x)) / med}
        if "off" in by:
            out[v]["over_off"] = med / statistics.median(by["off"])
        if v in per_turn:
            t = per_turn[v]
            out[v]["turn_over_off"] = {"min": min(t),
                                       "median": statistics.median(t),
                                       "max": max(t)}
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=2048)
    p.add_argument("--tile", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--turns", type=int, default=5)
    p.add_argument("--variants",
                   default="off,step,off_blocking,step_blocking")
    p.add_argument("--traced", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args()
    variants = args.variants.split(",")
    unknown = sorted(set(variants) - set(VARIANTS))
    if unknown:
        p.error(f"unknown variants {unknown}; choose from {VARIANTS}")
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("torch_telemetry_ab: CUDA is not available", file=sys.stderr)
        return 2
    from cgnn_tpu_torch.config import DataConfig
    from cgnn_tpu_torch.data.compact import CompactSpec
    from cgnn_tpu_torch.data.dataset import (
        load_synthetic,
        train_val_test_split,
    )

    if args.device != "cpu":
        from cgnn_tpu_torch.ops import _build

        _build.build(["fused_cgconv", "fused_epilogue"])
    dcfg = DataConfig()
    train_g, val_g, test_g = train_val_test_split(load_synthetic(
        args.n, dcfg.featurize_config(), seed=args.seed), 0.8, 0.1,
        seed=args.seed)
    spec = CompactSpec.build(train_g + val_g + test_g,
                             dcfg.featurize_config().gdf(), dense_m=12,
                             edge_dtype=torch.float32)
    data = (list(train_g) * args.tile, val_g, spec, args.batch_size)
    card = card_line()
    runs = []
    for turn in range(args.turns):
        for variant in (variants if turn % 2 == 0 else variants[::-1]):
            rec = dict(run_once(variant, data, args.epochs, args.seed,
                                args.device, traced=args.traced),
                       turn=turn, n=args.n, tile=args.tile,
                       epochs=args.epochs, traced=args.traced)
            runs.append(rec)
            print(json.dumps(rec, allow_nan=False), flush=True)
    summary = {"card": card, "n": args.n, "tile": args.tile,
               "batch_size": args.batch_size, "epochs": args.epochs,
               "turns": args.turns, "traced": args.traced,
               "variants": summarize(runs)}
    print(json.dumps(summary, allow_nan=False))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "summary": summary}, f, indent=1,
                      allow_nan=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
