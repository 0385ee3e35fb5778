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
- 2 when the arguments ask for what is not ported, an unknown precision
  tier or more devices than exist, or the directory holds no checkpoint.

The default device is the card, which raises without one; ``--device
cpu`` runs the kernels' plain versions.

Observability, as ``serve.py``: ``GET /metrics`` (serve/http.py) always;
``--telemetry-dir DIR`` writes the serving ``metrics.jsonl`` there (the
``run_summary`` with the latency, pack and occupancy series and the
per-device gauges at exit) and ``trace.json`` (the ``serve.request``,
``serve.pack`` and ``serve.dispatch`` spans); ``--live-metrics SECS``
appends the registry's snapshot to ``metrics_live.jsonl`` (in the
telemetry dir, else the checkpoint dir) every SECS seconds; ``--log-json``
logs one JSON line an event (role, pid, trace id) to stderr. At the
defaults four more planes run, each as ``serve.py`` runs it:

- the trace ring (``--trace-ring 65536``; 0 off) behind ``GET /trace``;
- the flight recorder (``--flightrec-dir auto``: the telemetry dir, else
  ``CKPT_DIR/flightrec``; '' off) behind ``GET /flightrec``, its bundles
  on a 5xx burst, an SLO alert and the drain's forced exit (written
  before the exit 3);
- the SLO engine and time-series store (off with ``--no-slo``):
  objectives from ``--slo-target``, ``--slo-latency-ms``,
  ``--slo-window`` and ``--class-slo-ms``; the rules scaled to the
  window unless ``--slo-fast-s`` and ``--slo-slow-s`` are both given
  (with ``--slo-factor``, ``--slo-for-s``); ``GET /timeseries``;
- on-demand profiling (``--profile-dir auto``: the telemetry dir, else
  ``CKPT_DIR/profiles``; '' off): ``POST /profile`` and SIGUSR2.

``--precision f32,bf16,int8`` warms those tiers (serve/quantize.py; a
request picks one with its ``precision`` field); ``--devices`` ``auto``
(every visible card) or N (the first N; more than exist exits 2, never
clamped); ``--engine`` ``auto`` (mesh over more than one card), ``mesh`` or
``threads``, as ``serve.py`` takes them.

Refused, exit 2: ``--journal`` (ROADMAP Queue 1, item 12);
``--compile-cache``, which has no counterpart (nothing is compiled by
XLA), when set.
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
    p.add_argument("--precision", default="f32", metavar="TIERS",
                   help="comma-separated precision tiers to warm "
                        "(f32,bf16,int8); a request picks one with its "
                        "'precision' field (default f32)")
    p.add_argument("--devices", default="auto", metavar="{auto,N}",
                   help="dispatch devices: 'auto' = every visible card; N "
                        "= the first N (more than exist exits 2)")
    p.add_argument("--engine", choices=["auto", "mesh", "threads"],
                   default="auto",
                   help="multi-device execution layer: 'mesh' (auto with "
                        ">1 device) runs each flush as one sharded dispatch; "
                        "'threads' routes flushes to per-device threads")
    p.add_argument("--telemetry-dir", type=str, default="",
                   help="write serving metrics.jsonl and trace.json here "
                        "('' disables)")
    p.add_argument("--live-metrics", type=float, default=0.0,
                   metavar="SECS",
                   help="append a registry snapshot (counters, gauges, "
                        "rolling quantiles) to metrics_live.jsonl every "
                        "SECS seconds (0 disables); the same live view "
                        "GET /metrics serves in Prometheus format")
    p.add_argument("--log-json", action="store_true",
                   help="one JSON line an event (role, pid, trace id) "
                        "on stderr instead of plain prints")
    p.add_argument("--profile-dir", type=str, default="auto",
                   help="where POST /profile and SIGUSR2 write bounded "
                        "on-demand torch.profiler captures ('auto' = the "
                        "telemetry dir when set, else CKPT_DIR/profiles; "
                        "'' disables)")
    p.add_argument("--trace-ring", type=int, default=65536, metavar="N",
                   help="bounded always-on serving span ring behind GET "
                        "/trace; 0 disables")
    p.add_argument("--flightrec-dir", type=str, default="auto",
                   help="incident flight-recorder bundles land here "
                        "('auto' = the telemetry dir when set, else "
                        "CKPT_DIR/flightrec; '' disables). Triggers: 5xx "
                        "burst, SLO burn, drain force-exit")
    p.add_argument("--no-slo", action="store_true",
                   help="disable the SLO engine, the mergeable histogram "
                        "families and the embedded time-series store")
    p.add_argument("--slo-target", type=float, default=0.999,
                   help="availability objective (fraction of requests "
                        "that must be answered)")
    p.add_argument("--slo-latency-ms", type=float, default=1000.0,
                   help="latency objective threshold: 95%% of answers "
                        "must land under this")
    p.add_argument("--slo-window", type=float, default=300.0,
                   help="error-budget accounting window (seconds)")
    p.add_argument("--slo-fast-s", type=float, default=None,
                   help="burn-rate rule override: fast window seconds "
                        "(set both --slo-fast-s and --slo-slow-s; default: "
                        "the standard pairs scaled to --slo-window)")
    p.add_argument("--slo-slow-s", type=float, default=None,
                   help="burn-rate rule override: slow window seconds")
    p.add_argument("--slo-factor", type=float, default=6.0,
                   help="burn-rate rule override: burn factor")
    p.add_argument("--slo-for-s", type=float, default=0.0,
                   help="burn-rate rule override: hold time before "
                        "pending becomes firing")
    p.add_argument("--class-slo-ms", default="",
                   help="per-class p95 latency SLO objectives, e.g. "
                        "'interactive=250,batch=2000': a class-scoped "
                        "latency objective each")
    # not ported: parsed so that asking for it is refused by name
    p.add_argument("--compile-cache", default="", metavar="DIR",
                   help="no counterpart in the port: refused when set")
    for _, flag, item in _REFUSED:
        p.add_argument(flag, default=None,
                       help=f"not ported (ROADMAP Queue 1, item {item})")
    return p


def _unported(args) -> str | None:
    """Why these arguments ask for something not ported, or None."""
    if args.compile_cache:
        return ("--compile-cache has no counterpart in the port (its "
                "kernels build once into build/kernels)")
    for dest, flag, item in _REFUSED:
        if getattr(args, dest) is not None:
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
    from cgnn_tpu_torch.observe.log import json_log_fn
    from cgnn_tpu_torch.observe.telemetry import Telemetry
    from cgnn_tpu_torch.resilience import faultinject
    from cgnn_tpu_torch.resilience.preempt import RESUMABLE_EXIT_CODE
    from cgnn_tpu_torch.serve.batcher import parse_kv_spec
    from cgnn_tpu_torch.serve.devices import resolve_devices
    from cgnn_tpu_torch.serve.http import make_http_server
    from cgnn_tpu_torch.serve.quantize import parse_precisions
    from cgnn_tpu_torch.serve.server import load_server

    # one sink for what this process logs: JSON lines (role, pid, trace
    # id) under --log-json, plain prints otherwise
    log = (json_log_fn("replica") if args.log_json
           else functools.partial(print, flush=True))
    fault_plan = faultinject.plan()
    if fault_plan is not None:
        print(f"FAULT INJECTION ACTIVE: {fault_plan.describe()}",
              file=sys.stderr)
        ignored = faultinject.unported_keys(fault_plan)
        if ignored:
            print(f"fault injection: {', '.join(ignored)} not ported: "
                  f"ignored", file=sys.stderr)
    dev = resolve_device(args.device)
    try:
        precisions = parse_precisions(args.precision)
        devices = resolve_devices(args.devices, dev)
    except ValueError as e:  # an unknown tier; more devices than exist
        print(str(e), file=sys.stderr)
        return 2
    telemetry = (Telemetry(level="epoch", log_dir=args.telemetry_dir)
                 if args.telemetry_dir else Telemetry.disabled())
    calibration = None
    if args.calibration_cache:
        from cgnn_tpu_torch.data.cache import load_graph_cache

        calibration = load_graph_cache(args.calibration_cache)
    profile_dir = args.profile_dir
    if profile_dir == "auto":
        profile_dir = args.telemetry_dir or os.path.join(args.ckpt_dir,
                                                         "profiles")
    try:
        slo_objectives, slo_rules = _slo_from_args(args)
    except ValueError as e:  # a target outside (0, 1), a bad window
        print(str(e), file=sys.stderr)
        return 2
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
            devices=devices,
            engine=args.engine,
            precision=precisions,
            watch=args.poll_interval > 0,
            poll_interval_s=args.poll_interval or 2.0,
            # warmed after the listener binds (below): /healthz answers
            # ready=false meanwhile instead of refusing connections
            warm=False,
            log_fn=log,
            telemetry=telemetry,
            trace_ring=args.trace_ring,
            slo_layer=not args.no_slo,
            slo_objectives=slo_objectives,
            slo_rules=slo_rules,
            profile_dir=profile_dir,
        )
    except (FileNotFoundError, NotImplementedError) as e:
        # a missing checkpoint, or one whose task is not served (force)
        print(str(e), file=sys.stderr)
        return 2
    recorder = None
    flightrec_dir = args.flightrec_dir
    if flightrec_dir == "auto":
        flightrec_dir = args.telemetry_dir or os.path.join(args.ckpt_dir,
                                                           "flightrec")
    if flightrec_dir:
        from cgnn_tpu_torch.observe.flightrec import FlightRecorder

        recorder = FlightRecorder(
            flightrec_dir, role="replica", name=f"replica:{args.port}",
            registry=server.registry, tracer=server.tracer,
            manifest={"ckpt_dir": args.ckpt_dir,
                      "param_version": server.version, "port": args.port,
                      "engine": server.engine,
                      "precisions": list(server.precisions)},
            log_fn=log)
        server.attach_flight_recorder(recorder)
    if server.profiler is not None:
        from cgnn_tpu_torch.observe.profile import install_sigusr2

        install_sigusr2(server.profiler, log_fn=log)
    if args.reload_gated and server.watcher is not None:
        server.watcher.set_gate(server.version)
        log(f"reload gate held at boot version {server.version} (POST "
            f"/reload-control to promote)")
    live_writer = None
    if args.live_metrics > 0:
        from cgnn_tpu_torch.observe.export import LiveMetricsWriter

        live_writer = LiveMetricsWriter(
            server.registry,
            os.path.join(args.telemetry_dir or args.ckpt_dir,
                         "metrics_live.jsonl"),
            interval_s=args.live_metrics).start()
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
        f"{server.version}; shapes {shapes}; {len(server.device_set)} "
        f"device(s) from {server.device}, {server.engine} engine; tiers "
        f"{','.join(server.precisions)}; wire: {wire}; "
        f"compact: {server.shape_set.compact is not None}; pack workers: "
        f"{server.stats()['ingest']['pack_workers']}; live plane: GET "
        f"/metrics"
        + (", GET /trace" if server.tracer is not None else "")
        + (f", flightrec -> {flightrec_dir}" if recorder else "")
        + (f", POST /profile -> {profile_dir}" if profile_dir else "")
        + ")")
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
    if live_writer is not None:
        live_writer.stop()
    stats = server.stats()
    lat = stats["latency_ms"]
    if lat:
        log(f"drained: {stats['counts']['responses']} responses, "
            f"{stats['counts']['cache_hits']} cache hits, p50 "
            f"{lat['p50']:.1f} ms / p99 {lat['p99']:.1f} ms")
    telemetry.close()
    if not clean:
        # a wedged flush must not hold shutdown forever: a daemon worker
        # blocked in it could pin interpreter teardown, so exit at once
        c = stats["counts"]
        rejected = sum(v for k, v in c.items() if k.startswith("reject_"))
        unanswered = (c.get("requests", 0) - c.get("responses", 0)
                      - c.get("cache_hits", 0) - rejected)
        if recorder is not None:
            # the bundle for this incident, written before the hard exit
            # (wait), whatever the rate limit (force)
            recorder.trigger(
                "drain_force_exit",
                f"{max(unanswered, 0)} unanswered after "
                f"{args.drain_timeout:g} s drain", wait=True, force=True)
        print(f"drain timed out after {args.drain_timeout:g} s: "
              f"{max(unanswered, 0)} accepted request(s) unanswered, "
              f"{stats['queue_depth']} still queued; force-exiting 3",
              file=sys.stderr)
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(3)
    if recorder is not None:
        recorder.wait_idle(timeout_s=10.0)
    if faultinject.exit75_requested():
        return RESUMABLE_EXIT_CODE
    return 0


def _slo_from_args(args) -> tuple:
    """serve.py's objectives and rules from the flags -> (objectives,
    rules), both None under --no-slo; rules None unless --slo-fast-s and
    --slo-slow-s are both given."""
    if args.no_slo:
        return None, None
    from cgnn_tpu_torch.observe.slo import BurnRateRule, SLOObjective
    from cgnn_tpu_torch.serve.batcher import parse_kv_spec

    objectives = (
        SLOObjective("availability", target=args.slo_target,
                     window_s=args.slo_window),
        SLOObjective("latency", target=0.95,
                     latency_threshold_ms=args.slo_latency_ms,
                     window_s=args.slo_window),
    )
    if args.class_slo_ms:
        # class-scoped: only the class's events feed these windows
        objectives += tuple(
            SLOObjective(f"latency_{kl}", target=0.95,
                         latency_threshold_ms=ms, window_s=args.slo_window,
                         klass=kl)
            for kl, ms in parse_kv_spec(args.class_slo_ms).items())
    rules = None
    if args.slo_fast_s is not None and args.slo_slow_s is not None:
        rules = (BurnRateRule(fast_s=args.slo_fast_s,
                              slow_s=args.slo_slow_s,
                              factor=args.slo_factor,
                              for_s=args.slo_for_s),)
    return objectives, rules


if __name__ == "__main__":
    sys.exit(main())
