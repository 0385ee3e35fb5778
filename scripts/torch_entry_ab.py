#!/usr/bin/env python3
"""The port's train entry point on two checkouts of the repository, in
turns on one card: the rate each reaches, for a parent-against-change
comparison in one call.

    python3 scripts/torch_entry_ab.py A_DIR B_DIR [--turns ABBAABBA] \
        [--label NAME] [--b-extra "--guard off"] -- --synthetic 2048 \
        --device-resident --buckets 3 -b 256 --epochs 6 --cgconv-impl pallas

Each turn runs ``python -m cgnn_tpu_torch.train`` from that checkout (its
own package and kernels, built there) with the flags after ``--`` (and,
for B, those of ``--b-extra``: a flag the other checkout lacks) and a
fresh ``--ckpt-dir`` and ``--out-dir`` under ``A_DIR/build/entry_ab``,
reads its ``train: {...}`` line and prints one JSON line a run: the
checkout, the turn, train structures/s over the epochs after the first
(their train and validation wall), and the epoch seconds. Then one
summary line: each checkout's runs and median, and B's median over A's.
A run that exits non-zero stops the script with its exit code.
"""

import argparse
import json
import os
import shlex
import shutil
import statistics
import subprocess
import sys


def run_once(checkout: str, flags: list, work: str) -> dict:
    for d in ("ck", "out"):
        shutil.rmtree(os.path.join(work, d), ignore_errors=True)
    argv = [sys.executable, "-m", "cgnn_tpu_torch.train", *flags,
            "--ckpt-dir", os.path.join(work, "ck"),
            "--out-dir", os.path.join(work, "out")]
    env = dict(os.environ, PYTHONPATH=checkout)
    proc = subprocess.run(argv, cwd=checkout, env=env, capture_output=True,
                          text=True, timeout=1800)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
        sys.exit(proc.returncode)
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("train: "))
    return json.loads(line[len("train: "):])


def main() -> int:
    argv = sys.argv[1:]
    flags = argv[argv.index("--") + 1:] if "--" in argv else []
    own = argv[: argv.index("--")] if "--" in argv else argv
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--turns", default="ABBAABBA")
    p.add_argument("--label", default="entry_ab")
    p.add_argument("--b-extra", default="")
    args = p.parse_args(own)
    side_flags = {"A": flags, "B": flags + shlex.split(args.b_extra)}
    dirs = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    work = os.path.join(dirs["A"], "build", "entry_ab")
    rates: dict = {"A": [], "B": []}
    for i, side in enumerate(args.turns):
        info = run_once(dirs[side], side_flags[side], work)
        later = info["epoch_seconds"][1:]
        n_train = info["train_structures_per_s"][0] * info[
            "epoch_seconds"][0]
        rate = n_train * len(later) / sum(later)
        rates[side].append(rate)
        print(json.dumps({"label": args.label, "turn": i, "side": side,
                          "checkout": dirs[side],
                          "steady_train_structures_per_s": rate,
                          "epoch_seconds": info["epoch_seconds"],
                          "graphs": info["graphs"]}, allow_nan=False),
              flush=True)
    med = {k: statistics.median(v) for k, v in rates.items() if v}
    print(json.dumps({"label": args.label, "runs": rates, "median": med,
                      "b_over_a": med["B"] / med["A"]}, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
