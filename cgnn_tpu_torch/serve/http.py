"""Thin stdlib HTTP front end over the in-process InferenceServer
(``cgnn_tpu/serve/http.py``, the same wire protocol).

``http.server.ThreadingHTTPServer`` + JSON; all serving logic (batching,
deadlines, backpressure, the cache, reload) lives in serve/server.py:

- ``POST /predict``: body ``{"graph": {...}}`` (featurized arrays:
  atom_fea [N,D], edge_fea [E,G], centers [E], neighbors [E]; ``id``) or
  ``{"structure": {...}}`` (frac_coords [N,3], lattice [3,3], numbers
  [N]; ``id``), the wire form, staged raw for the device neighbor search
  or featurized on a packer, never on this handler thread. Optional body
  keys: ``class`` (or ``priority``), ``tenant``, ``timeout_ms``,
  ``precision`` (a tier the server warmed: ``f32``, ``bf16``, ``int8``;
  another is refused 400 at admission; the response reports the tier),
  ``fingerprint`` (or the ``X-Fingerprint`` header), ``trace_id`` (or
  ``X-Request-Id``, echoed in the response's ``X-Request-Id``) and
  ``trace_parent`` (or ``X-Trace-Parent``). Any other key of a graph is
  ignored, ``distances`` too: a client's graph always stages full, from
  the ``edge_fea`` it sent (compact staging is for graphs the server
  featurizes itself). Response: ``{"prediction": [T], "param_version",
  "latency_ms", "cached", "batch_occupancy", "device_id", "precision",
  "wire", "trace_id", "flush_id", "stamps", "class", "backfilled",
  "coalesced"}``.
- ``GET /healthz``: ``ok`` (the process is up) and ``ready`` (warmed and
  not draining): 200 when ready, else 503 with ``Retry-After``; the
  entry point binds before ``warm()``, so a warming server answers
  ready=false instead of refusing connections.
- ``GET /stats``: the server's ``stats()``.
- ``GET /metrics``: the Prometheus scrape, ``server.registry.
  prometheus_text()`` (text exposition format 0.0.4): the request
  counters, the queue, device and edge-occupancy gauges, the rolling
  latency and occupancy summaries and the mergeable histograms.
- ``POST /reload-control``: ``{"pin": name|null, "gate": name|null}``
  drives the reload watcher (serve/reload.py); 501 without one.

Rejections map to HTTP codes: 400 malformed (or an unknown class), 413
oversize, 429 queue full, 503 draining or warming, 504 deadline; 429 and
503 carry ``Retry-After`` (1 s and 5 s). A flush that fails answers its
members 500 (``dispatch_failed``).

A ``/predict`` is answered with its trace id bound
(``observe.log.bind_trace``), so a ``--log-json`` line logged on the
handler's thread meanwhile carries it.

Routes whose modules are not ported answer as the JAX handler answers a
path it does not serve (404): ``GET /timeseries``, ``/trace``,
``/flightrec`` and ``POST /profile`` (ROADMAP Queue 1, item 11);
``POST /label`` and ``/cache-fill`` (item 12).
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from cgnn_tpu_torch.data.graph import CrystalGraph
from cgnn_tpu_torch.data.rawbatch import RawStructure
from cgnn_tpu_torch.observe.log import bind_trace
from cgnn_tpu_torch.observe.metrics_io import jsonfinite
from cgnn_tpu_torch.observe.tracectx import TRACE_PARENT_HEADER, parse_parent
from cgnn_tpu_torch.resilience import faultinject
from cgnn_tpu_torch.serve.batcher import (
    HTTP_STATUS,
    QUEUE_FULL,
    SHUTDOWN,
    TIMEOUT,
    ServeRejection,
)

# backpressure answers name a concrete back-off: a full queue clears
# within a few flushes, a draining server needs its restart window
_RETRY_AFTER_S = {QUEUE_FULL: 1, SHUTDOWN: 5}


def graph_from_json(payload: dict) -> CrystalGraph:
    """A featurized CrystalGraph from its JSON arrays."""
    try:
        return CrystalGraph(
            atom_fea=np.asarray(payload["atom_fea"], np.float32),
            edge_fea=np.asarray(payload["edge_fea"], np.float32),
            centers=np.asarray(payload["centers"], np.int32),
            neighbors=np.asarray(payload["neighbors"], np.int32),
            target=np.zeros(1, np.float32),
            cif_id=str(payload.get("id", "")),
        )
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise ValueError(f"malformed graph payload: {e}") from None


def structure_from_json(payload: dict) -> RawStructure:
    """A JSON structure -> a wire-form RawStructure (no featurization
    here: the server stages it raw or featurizes it on a packer)."""
    try:
        return RawStructure(
            np.asarray(payload["frac_coords"], np.float64),
            np.asarray(payload["lattice"], np.float64),
            np.asarray(payload["numbers"], np.int32),
            cif_id=str(payload.get("id", "")),
        )
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise ValueError(f"malformed structure payload: {e}") from None


def make_handler(server):
    """The request-handler class bound to ``server``."""

    class ServeHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: ARG002 — quiet under load
            pass

        def _reply(self, status: int, payload: dict,
                   headers: dict | None = None) -> None:
            # strict JSON: a NaN prediction reaches the client as null
            try:
                body = json.dumps(payload, allow_nan=False).encode()
            except ValueError:
                body = json.dumps(jsonfinite(payload),
                                  allow_nan=False).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply_text(self, status: int, text: str,
                        content_type: str) -> None:
            body = text.encode()
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            if self.path == "/healthz":
                draining = server.draining
                ready = server.warmed and not draining
                payload = {"ok": True, "ready": ready,
                           "warmed": server.warmed, "draining": draining,
                           "param_version": server.version,
                           "queue_depth": server.batcher.depth}
                if ready:
                    self._reply(200, payload)
                else:
                    self._reply(503, payload, headers={
                        "Retry-After": str(_RETRY_AFTER_S[SHUTDOWN])})
            elif self.path == "/stats":
                self._reply(200, server.stats())
            elif self.path == "/metrics":
                # the live registry, in the text exposition format
                self._reply_text(
                    200, server.registry.prometheus_text(),
                    "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def _do_reload_control(self, payload: dict) -> None:
            # keys absent = untouched; present and null = cleared
            w = server.watcher
            if w is None:
                self._reply(501, {"error": "no reload watcher attached "
                                           "(a weight file, or "
                                           "--poll-interval 0)"})
                return
            try:
                if "pin" in payload:
                    w.set_pin(payload["pin"])
                if "gate" in payload:
                    w.set_gate(payload["gate"])
            except (TypeError, ValueError) as e:
                self._reply(400, {"error": str(e)})
                return
            self._reply(200, w.control())

        def do_POST(self):  # noqa: N802
            # the fault point: close the socket unanswered, the way a
            # dying server presents (every N-th /predict only)
            if self.path == "/predict" and faultinject.drop_connection():
                self.close_connection = True
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("the body is not a JSON object")
            except ValueError as e:
                self._reply(400, {"error": f"malformed JSON body: {e}"})
                return
            if self.path == "/reload-control":
                self._do_reload_control(payload)
                return
            if self.path != "/predict":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            if not server.warmed:
                self._reply(503, {
                    "error": "server is warming (capturing its predict "
                             "graphs)", "reason": SHUTDOWN,
                }, headers={"Retry-After": str(_RETRY_AFTER_S[SHUTDOWN])})
                return
            try:
                if "graph" in payload:
                    graph = graph_from_json(payload["graph"])
                elif "structure" in payload:
                    graph = structure_from_json(payload["structure"])
                else:
                    raise ValueError(
                        "payload needs 'graph' (featurized arrays) or "
                        "'structure' (positions/lattice/numbers)")
                timeout_ms = payload.get("timeout_ms")
                if timeout_ms is not None:
                    timeout_ms = float(timeout_ms)
            except (TypeError, ValueError) as e:
                self._reply(400, {"error": str(e)})
                return
            trace_id = (self.headers.get("X-Request-Id")
                        or payload.get("trace_id"))
            _, trace_parent = parse_parent(
                self.headers.get(TRACE_PARENT_HEADER)
                or payload.get("trace_parent"))
            fingerprint = (self.headers.get("X-Fingerprint")
                           or payload.get("fingerprint"))
            try:
                with bind_trace(trace_id or ""):
                    result = server.predict(
                        graph, timeout_ms=timeout_ms, trace_id=trace_id,
                        precision=payload.get("precision"),
                        trace_parent=trace_parent,
                        klass=(payload.get("class")
                               or payload.get("priority")),
                        tenant=payload.get("tenant"),
                        fingerprint=fingerprint)
            except ServeRejection as e:
                headers = None
                if e.reason in _RETRY_AFTER_S:
                    headers = {
                        "Retry-After": str(_RETRY_AFTER_S[e.reason])}
                self._reply(HTTP_STATUS.get(e.reason, 500), {
                    "error": str(e), "reason": e.reason,
                }, headers=headers)
                return
            except TimeoutError:
                self._reply(504, {"error": "result wait timed out",
                                  "reason": TIMEOUT})
                return
            except Exception as e:  # noqa: BLE001 — a failed flush: typed 500
                self._reply(500, {"error": repr(e),
                                  "reason": "dispatch_failed"})
                return
            self._reply(200, {
                "prediction": np.asarray(result.prediction).tolist(),
                "param_version": result.param_version,
                "latency_ms": result.latency_ms,
                "cached": result.cached,
                "batch_occupancy": result.batch_occupancy,
                "device_id": result.device_id,
                "precision": result.precision,
                "wire": result.wire,
                "trace_id": result.trace_id,
                "flush_id": result.flush_id,
                "stamps": result.stamps,
                "class": result.klass,
                "backfilled": result.backfilled,
                "coalesced": result.coalesced,
            }, headers={"X-Request-Id": result.trace_id})

    return ServeHandler


class _ServeHTTPServer(ThreadingHTTPServer):
    # the stdlib's listen backlog is 5: a burst's sixth connection would
    # be reset by the kernel, where the batcher's own 429 should refuse
    request_queue_size = 128


def make_http_server(server, host: str = "127.0.0.1",
                     port: int = 8437) -> ThreadingHTTPServer:
    """Bind the front end (``.serve_forever()`` on the result serves;
    ``.shutdown()`` from another thread stops it)."""
    return _ServeHTTPServer((host, port), make_handler(server))
