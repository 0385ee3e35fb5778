#!/usr/bin/env python3
"""The port's training-shape kernel phase on two checkouts of the
repository, in turns on one card: each epilogue kernel's times beside its
bound, and the dense kernel path's train step, for a parent-against-change
comparison in one call.

    python3 scripts/torch_kernel_ab.py A_DIR B_DIR [--turns ABBA] \
        [--out FILE]

Each turn runs, in a process of its own from that checkout (its own
package, ``chip_smoke.py`` and kernels, built there), ``chip_smoke.py``'s
``train_kernel_phase`` (kernels 2-5 and kernel 1 at the training shape,
f32) and ``bf16_kernel_phase`` (the bf16 instances) on the same seeded
training split as ``chip_smoke.py`` makes, then ``train_breakdown`` of
the dense kernel path (``cgconv_impl='pallas'``): the step's device busy
ms and the hand kernels' share of it. Both phases check every kernel
against its plain version as ``chip_smoke.py`` does, and a failed check
stops the script with the turn's exit code. One JSON line a turn:
the checkout, the card (``nvidia-smi``'s name and power limit), and
for each kernel row its ``device_ms`` (profiler), ``ms`` (CUDA events),
``host_us``, ``bound_ms`` and ``bound_by``; then one summary line with
each row's device ms by side and B's median over A's. ``--out`` also
writes every turn's full record (all rows) as JSON.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROWS = ("epilogue_apply", "epilogue_apply_bf16", "epilogue_dz",
        "epilogue_dz_bf16", "epilogue_reduce", "epilogue_reduce_bf16")

TURN = r"""
import json, sys, time
import torch
import chip_smoke as c
from cgnn_tpu_torch.config import DataConfig
from cgnn_tpu_torch.data.dataset import load_synthetic_mp, train_val_test_split
from cgnn_tpu_torch.data.rawbatch import plan_raw_spec
from cgnn_tpu_torch.ops import _build
from cgnn_tpu_torch.serve.shapes import plan_shape_set

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda:0")
_build.build(["fused_cgconv", "fused_epilogue", "neighbor_search",
              "segment_sum", "windowed_gather"])
calibration = load_synthetic_mp(64, seed=c.SEED, keep_geometry=True)
fcfg = DataConfig().featurize_config()
shape_set = plan_shape_set(
    calibration, 64, rungs=3, dense_m=c.M,
    raw=plan_raw_spec(calibration, fcfg.gdf(), fcfg.radius, c.M))
split = train_val_test_split(load_synthetic_mp(c.N_TRAIN_SET,
                                               seed=c.SEED + 3),
                             0.8, 0.1, seed=c.SEED)
entries = c.train_kernel_phase(dev, split[0])[0]
entries += c.bf16_kernel_phase(dev, split[0], calibration, shape_set)
step = c.train_breakdown(dev, split[0], "kernel path", cgconv_impl="pallas")
print("KERNEL_AB " + json.dumps({
    "card": c.card_line(), "kernels": entries,
    "step": {k: step.get(k) for k in (
        "step_device_busy_ms", "hand_kernels_ms_per_step",
        "train_structures_per_s", "top_kernels_ms_per_step")}},
    allow_nan=False))
"""


def run_once(checkout: str) -> dict:
    env = dict(os.environ, PYTHONPATH=checkout)
    proc = subprocess.run([sys.executable, "-c", TURN], cwd=checkout,
                          env=env, capture_output=True, text=True,
                          timeout=1800)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        sys.exit(proc.returncode)
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("KERNEL_AB "))
    return json.loads(line[len("KERNEL_AB "):])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--turns", default="ABBA")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    dirs = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    device_ms: dict = {"A": {}, "B": {}}
    records = []
    for i, side in enumerate(args.turns):
        rec = run_once(dirs[side])
        rows = {e["name"]: {k: e.get(k) for k in (
            "device_ms", "ms", "host_us", "bound_ms", "bound_by")}
            for e in rec["kernels"] if e["name"] in ROWS}
        for name, row in rows.items():
            device_ms[side].setdefault(name, []).append(row["device_ms"])
        records.append({"turn": i, "side": side, **rec})
        print(json.dumps({"turn": i, "side": side, "checkout": dirs[side],
                          "card": rec["card"], "rows": rows,
                          "step": rec["step"]}, allow_nan=False),
              flush=True)
    summary = {"device_ms": device_ms, "b_over_a": {}}
    for name in ROWS:
        a, b = device_ms["A"].get(name), device_ms["B"].get(name)
        if a and b and None not in a + b:
            summary["b_over_a"][name] = (statistics.median(b)
                                         / statistics.median(a))
    print(json.dumps(summary, allow_nan=False))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(records, fh, allow_nan=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
