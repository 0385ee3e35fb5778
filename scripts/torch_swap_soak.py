#!/usr/bin/env python3
"""The mesh server's hot swap under sharded dispatch, looped on one card
(ROADMAP Queue 3, item 19).

Each round runs the sequence of ``chip_smoke.py``'s
``serve_devices_tiers`` phase after which one run hung: a mesh server
over ``[cuda:0, cuda:0]`` boots and warms from a fresh copy of a
checkpoint, answers requests one a flush and a traced burst (its kernel
launches held exact), takes a changed version under client load
(``chip_smoke.swap_under_sharded_dispatch``: every answer that of the
version it reports, no client given the old version after the new one)
and drains; then a threads server over the same pair boots, warms,
answers a burst and drains. A round that outlasts ``--round-timeout``
seconds dumps every thread's stack and exits 1, so a hang names the
blocked call.

    python3 scripts/torch_swap_soak.py [--rounds 20] [--round-timeout 120]

The checkpoint is the flagship (``chip_smoke.new_state``) at seeded
random weights; the requests are 64 MP-like structures. Prints one JSON
line a round, then a summary line. Exits 2 without a card.
"""

import argparse
import faulthandler
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def flagship_checkpoint(c, dev, calibration, work) -> str:
    """The flagship at seeded random weights as a checkpoint directory
    -> its path."""
    from cgnn_tpu_torch import convert
    from cgnn_tpu_torch.config import DataConfig

    cfg, state, _, _ = c.new_state(dev, calibration, cgconv_impl="pallas")
    npz = os.path.join(work, "params.npz")
    meta = os.path.join(work, "meta.json")
    convert.save_params(
        npz, meta, convert.to_flax_variables(state.model.state_dict()), cfg,
        DataConfig(), normalizer_mean=state.normalizer.mean.cpu().numpy(),
        normalizer_std=state.normalizer.std.cpu().numpy())
    ck = os.path.join(work, "ckpt")
    c.weights_checkpoint(npz, meta, ck)
    return ck


def one_round(c, dev, ck, work, r, graphs, n_conv, kw) -> dict:
    import numpy as np

    from cgnn_tpu_torch.serve.server import load_server

    pair = [dev, dev]
    t0 = time.perf_counter()
    eck = os.path.join(work, f"ckpt_{r}")
    shutil.copytree(ck, eck)
    one, _ = load_server(ck, **kw)
    mesh, _ = load_server(eck, devices=pair, engine="mesh", **kw)
    try:
        for g in graphs[:16]:
            a = mesh.predict(g, timeout_ms=60_000)
            b = one.predict(g, timeout_ms=60_000)
            c.check(np.array_equal(a.prediction, b.prediction),
                    f"round {r}: a mesh answer differs from one entry's")
        c.burst(mesh, graphs + graphs, f"soak_mesh_{r}",
                c.dense_per_step(n_conv), runs_a_flush=2)
        swap = c.swap_under_sharded_dispatch(dev, mesh, eck, graphs)
    finally:
        c.check(mesh.drain(timeout_s=60), f"round {r}: mesh did not drain")
        c.check(one.drain(timeout_s=60), f"round {r}: one did not drain")
    t_mesh = time.perf_counter() - t0
    threads, _ = load_server(ck, devices=pair, engine="threads", **kw)
    try:
        rec = c.burst(threads, graphs + graphs)
    finally:
        c.check(threads.drain(timeout_s=60),
                f"round {r}: threads did not drain")
    shutil.rmtree(eck, ignore_errors=True)
    return {"round": r, "seconds": time.perf_counter() - t0,
            "mesh_leg_s": t_mesh, "swap_answers": swap["answers"],
            "swap_at": swap["at_swap"],
            "threads_requests_per_s": rec["requests_per_s"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--round-timeout", type=float, default=120.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_swap_soak: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as c
    from cgnn_tpu_torch.config import ModelConfig
    from cgnn_tpu_torch.data.dataset import load_synthetic_mp

    dev = torch.device("cuda:0")
    print(f"card: {c.card_line()}")
    work = os.path.join(ROOT, "build", "swap_soak")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    calibration = load_synthetic_mp(64, seed=c.SEED, keep_geometry=True)
    graphs = load_synthetic_mp(64, seed=c.SEED + 5)
    ck = flagship_checkpoint(c, dev, calibration, work)
    n_conv = ModelConfig().n_conv
    kw = dict(batch_size=64, rungs=3, calibration=calibration, device=dev,
              default_timeout_ms=60_000.0, cache_size=0, wire="raw",
              log_fn=lambda *a, **k: None, poll_interval_s=3600.0)
    rounds = []
    try:
        for r in range(args.rounds):
            faulthandler.dump_traceback_later(args.round_timeout, exit=True)
            rounds.append(one_round(c, dev, ck, work, r, graphs, n_conv, kw))
            faulthandler.cancel_dump_traceback_later()
            print(json.dumps(rounds[-1], allow_nan=False), flush=True)
    except c.SmokeFailure as e:
        print(f"torch_swap_soak: FAIL in round {len(rounds)}: {e}",
              file=sys.stderr)
        return 1
    secs = [x["seconds"] for x in rounds]
    print(json.dumps({"rounds": len(rounds), "hangs": 0,
                      "round_s_max": max(secs), "round_s_min": min(secs),
                      "round_timeout_s": args.round_timeout},
                     allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
