"""Online inference server entry point (``serve.py``'s counterpart):

    python -m cgnn_tpu_torch.serve CKPT_DIR [--port 8437] [-b 64] ...
    python -m cgnn_tpu_torch.serve CKPT_DIR --device cpu --port 8437
    curl -s localhost:8437/predict -d '{"structure": {"lattice":
        [[4,0,0],[0,4,0],[0,0,4]], "frac_coords": [[0,0,0],[.5,.5,.5]],
        "numbers": [11, 17]}}'

Loads a checkpoint directory written by ``python -m cgnn_tpu_torch.train``
(or carried over by ``jax_checkpoint_to_torch.py``), plans the shape
ladder, binds and listens (serve/http.py), then captures every rung's
predict graph (``/healthz`` answers ready=false, 503, until that ends),
starts the worker and the hot-reload watcher on the directory, and serves
until SIGTERM or SIGINT. Then it drains with the listener still up
(``/healthz`` reports draining; new requests get 503), shuts the
listener and exits:

- 0 after a clean drain;
- 75 when the drain followed an injected preemption
  (``CGNN_TPU_FAULTS=exit75_at=N``);
- 3, at once (``os._exit``), when the drain outlasts ``--drain-timeout``,
  with the count of accepted requests left unanswered;
- 2 when the arguments ask for what is not ported or the directory holds
  no checkpoint.

The default device is the card, which raises without one; ``--device
cpu`` runs the kernels' plain versions.

Flags refused, exit 2, each naming its ROADMAP item (Queue 1):
``--precision`` other than f32 (item 11); ``--devices`` other than auto/1
and ``--engine mesh`` (items 9 and 11); ``--telemetry-dir``,
``--live-metrics``, ``--profile-dir``, ``--trace-ring``,
``--flightrec-dir``, ``--log-json`` and the SLO flags (``--no-slo``,
``--slo-*``, ``--class-slo-ms``) (item 11); ``--journal`` (item 12).
``--compile-cache`` has no counterpart (nothing is compiled by XLA) and
is refused when set.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import threading
import time

# flags of serve.py whose modules are not ported: (dest, flag, item)
_REFUSED = (
    ("telemetry_dir", "--telemetry-dir", "11"),
    ("live_metrics", "--live-metrics", "11"),
    ("profile_dir", "--profile-dir", "11"),
    ("trace_ring", "--trace-ring", "11"),
    ("flightrec_dir", "--flightrec-dir", "11"),
    ("log_json", "--log-json", "11"),
    ("no_slo", "--no-slo", "11"),
    ("slo_target", "--slo-target", "11"),
    ("slo_latency_ms", "--slo-latency-ms", "11"),
    ("slo_window", "--slo-window", "11"),
    ("slo_fast_s", "--slo-fast-s", "11"),
    ("slo_slow_s", "--slo-slow-s", "11"),
    ("slo_factor", "--slo-factor", "11"),
    ("slo_for_s", "--slo-for-s", "11"),
    ("class_slo_ms", "--class-slo-ms", "11"),
    ("journal", "--journal", "12"),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cgnn_tpu_torch.serve",
        description="Online inference server of the PyTorch/CUDA port.")
    p.add_argument("ckpt_dir", help="checkpoint directory written by "
                                    "python -m cgnn_tpu_torch.train")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8437)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("-b", "--batch-size", type=int, default=64,
                   help="graph budget of the largest serving shape")
    p.add_argument("--rungs", type=int, default=3,
                   help="shape-ladder depth (predict graphs per form)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="micro-batch flush deadline")
    p.add_argument("--class-wait-ms", default="",
                   help="per-priority-class flush budgets, e.g. "
                        "'batch=20,scavenger=80' (ms; unlisted classes "
                        "keep interactive=1x, batch=4x, scavenger=16x "
                        "--max-wait-ms)")
    p.add_argument("--no-backfill", action="store_true",
                   help="no padding-slack backfill of lower-class requests")
    p.add_argument("--wfq-weights", default="",
                   help="weighted-fair-queuing tenant weights, e.g. "
                        "'acme=4,guest=1' (unlisted tenants weigh 1)")
    p.add_argument("--max-queue", type=int, default=256,
                   help="admission bound (reject above this: 429)")
    p.add_argument("--timeout-ms", type=float, default=1000.0,
                   help="default per-request deadline (0 disables)")
    p.add_argument("--cache-size", type=int, default=1024,
                   help="LRU result cache entries (0 disables)")
    p.add_argument("--compact", choices=["auto", "on", "off"],
                   default="auto",
                   help="compact staging of featurized flushes; auto = on "
                        "the card with the dense layout")
    p.add_argument("--wire", choices=["auto", "raw", "featurized"],
                   default="auto",
                   help="'raw' builds wire-form structures' graphs on the "
                        "device; 'auto' is raw on the card")
    p.add_argument("--pack-workers", type=int, default=None,
                   help="packer threads beside the worker (0 = the worker "
                        "packs; default 1 on the card, 0 on the CPU)")
    p.add_argument("--poll-interval", type=float, default=2.0,
                   help="hot-reload checkpoint poll seconds (0 disables)")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="bound on the SIGTERM drain: past it the process "
                        "exits 3 with the unanswered count")
    p.add_argument("--drain-linger", type=float, default=0.0,
                   help="after a clean drain, keep answering /healthz "
                        "(draining=true) this many seconds")
    p.add_argument("--calibrate", type=int, default=256,
                   help="synthetic calibration structures for shape "
                        "planning")
    p.add_argument("--calibration-cache", type=str, default="",
                   help="featurized graph cache to calibrate shapes from")
    p.add_argument("--reload-gated", action="store_true",
                   help="hold the reload watcher at the boot version until "
                        "POST /reload-control raises the gate")
    # not ported: parsed so that asking for them is refused by name
    p.add_argument("--precision", default="f32", metavar="TIERS",
                   help="precision tiers to warm: f32 only")
    p.add_argument("--devices", default="auto", metavar="{auto,N}",
                   help="dispatch devices: one card only")
    p.add_argument("--engine", choices=["auto", "mesh", "threads"],
                   default="auto",
                   help="multi-device execution layer (not ported)")
    p.add_argument("--compile-cache", default="", metavar="DIR",
                   help="no counterpart in the port: refused when set")
    for dest, flag, item in _REFUSED:
        if dest in ("log_json", "no_slo"):
            p.add_argument(flag, action="store_true",
                           help=f"not ported (ROADMAP Queue 1, item {item})")
        else:
            p.add_argument(flag, default=None,
                           help=f"not ported (ROADMAP Queue 1, item {item})")
    return p


def _unported(args) -> str | None:
    """Why these arguments ask for something not ported, or None."""
    tiers = [t.strip() for t in str(args.precision).split(",") if t.strip()]
    if tiers and tiers != ["f32"]:
        return (f"--precision {args.precision}: only the model's own tier, "
                f"f32, is served (the bf16 and int8 tiers of quantize.py: "
                f"ROADMAP Queue 1, item 11)")
    if args.devices not in ("auto", "1") or args.engine == "mesh":
        return ("--devices other than auto/1 and --engine mesh are not "
                "ported yet (ROADMAP Queue 1, items 9 and 11)")
    if args.compile_cache:
        return ("--compile-cache has no counterpart in the port (its "
                "kernels build once into build/kernels)")
    for dest, flag, item in _REFUSED:
        if getattr(args, dest) not in (None, False):
            return (f"{flag} is not ported yet (ROADMAP Queue 1, item "
                    f"{item})")
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    why = _unported(args)
    if why:
        print(why, file=sys.stderr)
        return 2
    from cgnn_tpu_torch.device import resolve_device
    from cgnn_tpu_torch.resilience import faultinject
    from cgnn_tpu_torch.resilience.preempt import RESUMABLE_EXIT_CODE
    from cgnn_tpu_torch.serve.batcher import parse_kv_spec
    from cgnn_tpu_torch.serve.http import make_http_server
    from cgnn_tpu_torch.serve.server import load_server

    log = functools.partial(print, flush=True)
    fault_plan = faultinject.plan()
    if fault_plan is not None:
        print(f"FAULT INJECTION ACTIVE: {fault_plan.describe()}",
              file=sys.stderr)
        ignored = faultinject.unported_keys(fault_plan)
        if ignored:
            print(f"fault injection: {', '.join(ignored)} not ported: "
                  f"ignored", file=sys.stderr)
    dev = resolve_device(args.device)
    calibration = None
    if args.calibration_cache:
        from cgnn_tpu_torch.data.cache import load_graph_cache

        calibration = load_graph_cache(args.calibration_cache)
    try:
        server, parts = load_server(
            args.ckpt_dir,
            batch_size=args.batch_size,
            rungs=args.rungs,
            calibration=calibration,
            calibration_n=args.calibrate,
            max_queue=args.max_queue,
            max_wait_ms=args.max_wait_ms,
            class_max_wait_ms=(parse_kv_spec(args.class_wait_ms)
                               if args.class_wait_ms else None),
            backfill=not args.no_backfill,
            wfq_weights=(parse_kv_spec(args.wfq_weights)
                         if args.wfq_weights else None),
            default_timeout_ms=args.timeout_ms or None,
            cache_size=args.cache_size,
            compact=args.compact,
            wire=args.wire,
            pack_workers=args.pack_workers,
            device=dev,
            watch=args.poll_interval > 0,
            poll_interval_s=args.poll_interval or 2.0,
            # warmed after the listener binds (below): /healthz answers
            # ready=false meanwhile instead of refusing connections
            warm=False,
            log_fn=log,
        )
    except (FileNotFoundError, NotImplementedError) as e:
        # a missing checkpoint, or one whose task is not served (force)
        print(str(e), file=sys.stderr)
        return 2
    if args.reload_gated and server.watcher is not None:
        server.watcher.set_gate(server.version)
        log(f"reload gate held at boot version {server.version} (POST "
            f"/reload-control to promote)")
    httpd = make_http_server(server, host=args.host, port=args.port)
    stop = threading.Event()
    handler = server.install_signal_handlers()
    handler.add_callback(stop.set)
    listener = threading.Thread(target=httpd.serve_forever, daemon=True,
                                name="cgnn-torch-http")
    listener.start()
    log(f"listening on http://{args.host}:{args.port} (warming "
        f"{len(server.shape_set)} shapes; /healthz reports ready=false "
        f"until done)")
    faultinject.boot_point()
    server.warm(parts["template"])
    server.start()
    shapes = ", ".join(f"({s.graph_cap}g/{s.node_cap}n/{s.edge_cap}e)"
                       for s in server.shape_set)
    wire = ("raw+featurized" if server.shape_set.raw is not None
            else "featurized")
    log(f"serving on http://{args.host}:{args.port} (params "
        f"{server.version}; shapes {shapes}; {server.device}; wire: {wire}; "
        f"compact: {server.shape_set.compact is not None}; pack workers: "
        f"{server.stats()['ingest']['pack_workers']})")
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        server.begin_drain()
    # drain with the listener up: /healthz answers draining=true and new
    # requests get the typed 503 until the queue is answered
    clean = server.drain(timeout_s=args.drain_timeout)
    if clean and args.drain_linger > 0:
        time.sleep(args.drain_linger)
    httpd.shutdown()
    httpd.server_close()
    handler.uninstall()
    stats = server.stats()
    lat = stats["latency_ms"]
    if lat:
        log(f"drained: {stats['counts']['responses']} responses, "
            f"{stats['counts']['cache_hits']} cache hits, p50 "
            f"{lat['p50']:.1f} ms / p99 {lat['p99']:.1f} ms")
    if not clean:
        # a wedged flush must not hold shutdown forever: a daemon worker
        # blocked in it could pin interpreter teardown, so exit at once
        c = stats["counts"]
        rejected = sum(v for k, v in c.items() if k.startswith("reject_"))
        unanswered = (c.get("requests", 0) - c.get("responses", 0)
                      - c.get("cache_hits", 0) - rejected)
        print(f"drain timed out after {args.drain_timeout:g} s: "
              f"{max(unanswered, 0)} accepted request(s) unanswered, "
              f"{stats['queue_depth']} still queued; force-exiting 3",
              file=sys.stderr)
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(3)
    if faultinject.exit75_requested():
        return RESUMABLE_EXIT_CODE
    return 0


if __name__ == "__main__":
    sys.exit(main())
