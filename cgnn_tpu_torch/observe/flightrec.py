"""The incident flight recorder (``cgnn_tpu/observe/flightrec.py``):
bounded always-on state, dumped on a trigger.

A process keeps a small ring of recent per-request records (trace id,
stages, status, param version, tier and wire) beside its live metrics
registry and span ring, and a TRIGGER (a 5xx burst, an SLO burn alert,
a drain's forced exit) dumps one bundle directory for the postmortem::

    bundle-<utc>-p<pid>-<nn>-<reason>/
      manifest.json    who dumped, why, when, argv, the config manifest
      requests.jsonl   the recent-request ring (grep by trace id)
      metrics.json     the registry snapshot at dump time
      trace.json       the span window, joined across ``peers`` when set
      peers.json       each peer's own /flightrec ring and metrics

Triggers are rate-limited (``min_interval_s``) and bounded
(``max_bundles``): an incident storm leaves a few bundles, not a full
disk. The request path pays one lock and a deque append; all IO runs on a
one-shot named dump thread. Host-side only: served answers are bit-equal
with the recorder on or off.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Callable

from cgnn_tpu_torch.observe.metrics_io import jsonfinite


def _write_json(path: str, payload) -> None:
    try:
        body = json.dumps(payload, allow_nan=False, indent=1)
    except ValueError:
        body = json.dumps(jsonfinite(payload), indent=1)
    with open(path, "w") as f:
        f.write(body)


class FlightRecorder:
    """One process's black box; see the module docstring.

    ``registry`` (observe/export.py MetricsRegistry), ``tracer``
    (observe/spans.py SpanTracer), and ``peers`` (base urls whose
    ``/trace`` + ``/flightrec`` a dump pulls) are all optional — the
    recorder degrades to whatever surfaces its process actually has.
    """

    def __init__(
        self,
        out_dir: str,
        *,
        role: str = "process",
        name: str = "",
        ring: int = 512,
        burst_threshold: int = 20,
        burst_window_s: float = 10.0,
        min_interval_s: float = 30.0,
        max_bundles: int = 16,
        registry=None,
        tracer=None,
        peers=(),
        manifest: dict | None = None,
        log_fn: Callable = print,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.out_dir = out_dir
        self.role = str(role)
        self.name = str(name) or f"{role}-{os.getpid()}"
        self.registry = registry
        self.tracer = tracer
        self.peers = list(peers)
        self.manifest = dict(manifest or {})
        self.burst_threshold = int(burst_threshold)
        self.burst_window_s = float(burst_window_s)
        self.min_interval_s = float(min_interval_s)
        self.max_bundles = int(max_bundles)
        self._log = log_fn
        self._clock = clock
        # a plain lock (the JAX recorder's instrumented lock belongs to
        # the audit tooling, ROADMAP item 13); all below mutated under it
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=int(ring))
        self._errors: collections.deque = collections.deque(maxlen=4096)
        self._last_dump = -1e18
        self._burst_fired = False
        self.bundles = 0
        self.suppressed = 0
        self.triggers: dict[str, int] = {}
        self.last_bundle = ""
        self._dump_thread: threading.Thread | None = None
        # the trigger subscription: ``on_trigger(reason, detail,
        # bundle_dir_or_None)`` after every trigger, the rate-limited
        # ones too (bundle None); called outside the lock, its errors
        # logged and swallowed
        self.on_trigger: Callable | None = None

    # ---- the always-on cheap path ----

    def note_request(self, record: dict) -> None:
        """Remember one finished request (answered OR failed): the
        caller supplies whatever it knows — trace_id, status, stamps,
        param_version, precision/wire/rung, latency_ms, replica/device.
        One lock + append; the hot-path whole cost."""
        record = dict(record)
        record.setdefault("t_unix", time.time())
        with self._lock:
            self._ring.append(record)

    def note_status(self, status: int) -> None:
        """Feed the 5xx burst detector with one response status. A
        burst (``burst_threshold`` server errors inside
        ``burst_window_s``) fires the ``5xx_burst`` trigger ONCE per
        quiet period — it re-arms only after the window drains below
        half the threshold, so a sustained error plateau produces one
        bundle, not one per request."""
        if status < 500:
            return
        now = self._clock()
        fire = False
        with self._lock:
            self._errors.append(now)
            cutoff = now - self.burst_window_s
            while self._errors and self._errors[0] < cutoff:
                self._errors.popleft()
            n = len(self._errors)
            if n >= self.burst_threshold and not self._burst_fired:
                self._burst_fired = True
                fire = True
            elif n <= self.burst_threshold // 2:
                self._burst_fired = False
        if fire:
            self.trigger("5xx_burst",
                         f"{self.burst_threshold}+ server errors in "
                         f"{self.burst_window_s:.0f} s")

    def recent_requests(self) -> list:
        with self._lock:
            return list(self._ring)

    def snapshot(self) -> dict:
        """The ``GET /flightrec`` body: ring + live metrics + identity
        (what a PEER's dump pulls to correlate this process)."""
        with self._lock:
            bundles = self.bundles
            triggers = dict(self.triggers)
            requests = list(self._ring)
        snap = {
            "role": self.role,
            "name": self.name,
            "pid": os.getpid(),
            "time_unix": time.time(),
            "bundles": bundles,
            "triggers": triggers,
            "requests": requests,
            "manifest": self.manifest,
        }
        if self.registry is not None:
            try:
                snap["metrics"] = self.registry.snapshot()
            except Exception as e:  # noqa: BLE001 — a broken gauge must
                snap["metrics_error"] = repr(e)  # not kill the bundle
        return snap

    # ---- triggers ----

    def trigger(self, reason: str, detail: str = "",
                wait: bool = False, force: bool = False) -> str | None:
        """Fire one incident dump; returns the bundle dir (None when
        rate-limited/bounded away). The dump's IO runs on a one-shot
        named daemon thread so a trigger on the request path costs a
        thread spawn, not a fleet-wide /trace pull — ``wait=True``
        blocks for it. ``force=True`` bypasses the rate limit and the
        bundle cap, first waiting out any in-flight dump — the
        drain-force-exit path, where the process is about to ``os._exit``
        and the promised final bundle must not be suppressed because a
        5xx burst happened to dump 10 s earlier."""
        now = self._clock()
        with self._lock:
            self.triggers[reason] = self.triggers.get(reason, 0) + 1
            t_busy = self._dump_thread
        busy = t_busy is not None and t_busy.is_alive()
        if force and busy:
            t_busy.join(timeout=60.0)
            busy = t_busy.is_alive()  # still alive = wedged dump
        with self._lock:
            limited = (now - self._last_dump < self.min_interval_s
                       or self.bundles >= self.max_bundles)
            if busy or (limited and not force):
                self.suppressed += 1
                bundle = t = None
            else:
                self._last_dump = now
                self.bundles += 1
                # pid in the name: replicas sharing one --flightrec-dir
                # (the serve.py 'auto' default under a shared ckpt dir)
                # firing in the same second must land in DISTINCT dirs,
                # never interleave files inside one
                stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
                bundle = os.path.join(
                    self.out_dir,
                    f"bundle-{stamp}-p{os.getpid()}"
                    f"-{self.bundles:02d}-{reason}")
                self.last_bundle = bundle
                t = threading.Thread(
                    target=self._dump, args=(bundle, reason, detail),
                    daemon=True, name=f"flightrec-dump-{self.bundles}",
                )
                self._dump_thread = t
        if t is None:
            self._notify(reason, detail, None)
            return None
        t.start()
        self._notify(reason, detail, bundle)
        if wait:
            t.join(timeout=60.0)
        return bundle

    def _notify(self, reason: str, detail: str,
                bundle: str | None) -> None:
        cb = self.on_trigger
        if cb is None:
            return
        try:
            cb(reason, detail, bundle)
        except Exception as e:  # noqa: BLE001 — see on_trigger contract
            self._log(f"flightrec: on_trigger subscriber failed: {e!r}")

    def wait_idle(self, timeout_s: float = 60.0) -> None:
        with self._lock:
            t = self._dump_thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)

    # ---- the dump (one-shot thread; all IO lives here) ----

    def _dump(self, bundle: str, reason: str, detail: str) -> None:
        try:
            os.makedirs(bundle, exist_ok=True)
            with self._lock:
                requests = list(self._ring)
                triggers = dict(self.triggers)
            _write_json(os.path.join(bundle, "manifest.json"), {
                "reason": reason,
                "detail": detail,
                "role": self.role,
                "name": self.name,
                "pid": os.getpid(),
                "time_unix": time.time(),
                "argv": list(sys.argv),
                "triggers": triggers,
                "peers": self.peers,
                **self.manifest,
            })
            with open(os.path.join(bundle, "requests.jsonl"), "w") as f:
                for r in requests:
                    try:
                        f.write(json.dumps(r, allow_nan=False) + "\n")
                    except ValueError:
                        f.write(json.dumps(jsonfinite(r)) + "\n")
            if self.registry is not None:
                try:
                    _write_json(os.path.join(bundle, "metrics.json"),
                                self.registry.snapshot())
                except Exception as e:  # noqa: BLE001 — partial bundle
                    _write_json(os.path.join(bundle, "metrics.json"),
                                {"error": repr(e)})
            self._dump_trace(bundle)
            self._dump_peers(bundle)
            self._log(f"flightrec: {reason} -> {bundle} "
                      f"({len(requests)} recent requests, "
                      f"{len(self.peers)} peers)")
        except Exception as e:  # noqa: BLE001 — a failing dump must not
            # take the serving process with it; the trigger count
            # already recorded that the incident happened
            self._log(f"flightrec: dump for {reason!r} failed: {e!r}")

    def _dump_trace(self, bundle: str) -> None:
        from cgnn_tpu_torch.observe import trace_join

        windows = []
        if self.tracer is not None:
            w = self.tracer.window()
            w["role"] = self.role
            windows.append(w)
        errors = {}
        if self.peers:
            peer_windows, errors = trace_join.collect_windows(self.peers)
            windows.extend(peer_windows)
        if windows:
            doc = trace_join.write_joined(
                os.path.join(bundle, "trace.json"), windows)
            if errors:
                _write_json(os.path.join(bundle, "trace_errors.json"),
                            errors)
            n_cross = len(trace_join.cross_process_traces(doc))
            self._log(f"flightrec: joined trace over "
                      f"{len(windows)} window(s), {n_cross} "
                      f"cross-process request(s)")

    def _dump_peers(self, bundle: str) -> None:
        if not self.peers:
            return
        import urllib.request

        out = {}
        for url in self.peers:
            try:
                with urllib.request.urlopen(
                        url.rstrip("/") + "/flightrec",
                        timeout=5.0) as resp:
                    out[url] = json.loads(resp.read())
            except Exception as e:  # noqa: BLE001 — a dead peer is
                out[url] = {"error": repr(e)}  # itself evidence
        _write_json(os.path.join(bundle, "peers.json"), out)

    def stats(self) -> dict:
        with self._lock:
            return {
                "bundles": self.bundles,
                "suppressed": self.suppressed,
                "triggers": dict(self.triggers),
                "last_bundle": self.last_bundle,
                "ring": len(self._ring),
            }
