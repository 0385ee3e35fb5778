"""Streaming metrics export (``cgnn_tpu/observe/export.py``): scrape a
live run instead of its post-mortem.

The telemetry facade buffers counters, gauges and series and flushes one
``run_summary`` record at ``close()``. This module is the live half:

- :class:`RollingSeries` — a time-windowed value series (latencies,
  occupancies) with explicit eviction: samples older than ``window_s``
  (and beyond ``max_samples``) are dropped on every append and every
  read, so a days-long server holds a bounded, recent window, and its
  quantiles describe the last minute.
- :class:`MetricsRegistry` — one scrape point over the ``Telemetry``
  buffers (counters, gauges, series, read live) plus provider callbacks
  (the server registers one with its request counts, rolling latency
  and per-device in-flight depth). ``snapshot()`` returns the merged
  dict; ``prometheus_text()`` renders the Prometheus exposition format
  that ``GET /metrics`` serves (counters -> ``*_total`` counter
  families, series -> summary families with quantile labels,
  ``device{i}_*`` gauges -> one ``device`` label a device).
- :class:`LiveMetricsWriter` — a periodic appender of registry snapshots
  to ``metrics_live.jsonl``, so a training run is observable mid-flight
  with no HTTP endpoint (the train and serve entry points'
  ``--live-metrics N``).

Host-side bookkeeping only: nothing here runs on a device, so
trajectories and served numbers are bit-identical with it on or off.
"""
from __future__ import annotations

import collections
import json
import os
import re
import threading
import time
from typing import Callable

from cgnn_tpu_torch.observe import hist as _hist
from cgnn_tpu_torch.observe.metrics_io import jsonfinite

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_:]")
# device{i}_metric / replica{i}_metric gauges become one labeled family
# per metric (the per-device and per-replica series in /metrics)
_DEVICE_GAUGE = re.compile(r"^device(\d+)_(\w+)$")
_REPLICA_GAUGE = re.compile(r"^replica(\d+)_(\w+)$")


class RollingSeries:
    """Bounded, time-windowed samples with on-demand quantiles.

    Retention is the AND of two bounds — ``max_samples`` (a hard memory
    cap, like the old deque) and ``window_s`` (age) — and eviction is
    explicit: ``evict()`` runs on every ``add`` and every read, so the
    structure never holds samples it would not report. ``clock`` is
    injectable for deterministic eviction tests.
    """

    def __init__(self, window_s: float = 900.0, max_samples: int = 8192,
                 clock: Callable[[], float] = time.monotonic):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self.max_samples = int(max_samples)
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: collections.deque = collections.deque(
            maxlen=self.max_samples
        )  # (monotonic t, value)
        self.total_count = 0   # lifetime appends (the _count a scraper sums)
        self.total_sum = 0.0
        self.evicted = 0

    def add(self, value: float, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        with self._lock:
            if (self._samples
                    and len(self._samples) == self._samples.maxlen):
                self.evicted += 1  # deque drop (count bound)
            self._samples.append((now, float(value)))
            self.total_count += 1
            self.total_sum += float(value)
            self._evict_locked(now)

    def _evict_locked(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()
            self.evicted += 1

    def evict(self, now: float | None = None) -> None:
        """Drop samples older than the window (also runs on add/read)."""
        now = self._clock() if now is None else now
        with self._lock:
            self._evict_locked(now)

    def values(self, now: float | None = None,
               window_s: float | None = None) -> list:
        """Samples inside the window (optionally a narrower one)."""
        now = self._clock() if now is None else now
        with self._lock:
            self._evict_locked(now)
            if window_s is None:
                return [v for _, v in self._samples]
            cutoff = now - min(window_s, self.window_s)
            return [v for t, v in self._samples if t >= cutoff]

    def __len__(self) -> int:
        with self._lock:
            self._evict_locked(self._clock())
            return len(self._samples)

    def reseed_from(self, old: "RollingSeries") -> "RollingSeries":
        """Carry another series' samples AND lifetime totals into this
        one (the keep-change migration path in Telemetry.observe_value)
        — totals must survive, they are the cumulative _count/_sum a
        Prometheus scraper rates over."""
        with old._lock:
            samples = list(old._samples)
            count, total, evicted = (old.total_count, old.total_sum,
                                     old.evicted)
        with self._lock:
            self._samples.extend(samples)
            self.total_count += count
            self.total_sum += total
            self.evicted += evicted
        return self

    def quantiles(self, now: float | None = None,
                  window_s: float | None = None) -> dict:
        """{p50, p95, p99, mean, count, count_total, sum_total} over the
        (sub-)window; {} when empty. ``count``/``mean`` describe the
        window; ``count_total``/``sum_total`` are LIFETIME cumulative
        (what a Prometheus summary's _count/_sum must be — they may
        never decrease, while a windowed count shrinks as samples age
        out)."""
        vals = self.values(now, window_s=window_s)
        if not vals:
            return {}
        import numpy as np

        arr = np.asarray(vals, np.float64)
        p50, p95, p99 = np.percentile(arr, [50, 95, 99])
        with self._lock:
            count_total, sum_total = self.total_count, self.total_sum
        return {
            "p50": float(p50), "p95": float(p95), "p99": float(p99),
            "mean": float(arr.mean()), "count": len(vals),
            "count_total": count_total, "sum_total": sum_total,
        }


def sanitize_metric_name(name: str) -> str:
    """A Prometheus-legal metric name (invalid chars -> '_')."""
    name = _NAME_FIX.sub("_", str(name))
    if not name or not _NAME_OK.match(name):
        name = "_" + name
    return name


class MetricsRegistry:
    """The scrape point: telemetry buffers + provider callbacks, merged.

    Providers are zero-arg callables returning any of
    ``{"counters": {...}, "gauges": {...}, "series": {name: quantiles},
    "histograms": {name: snapshot}}`` — evaluated at snapshot time, so
    every scrape sees live values. Histogram snapshots are
    ``observe.hist.Histogram.snapshot()`` dicts and render as Prometheus
    histogram families (cumulative ``_bucket``/``le`` + ``_sum`` +
    ``_count``) — the MERGEABLE cross-process complement to the
    per-process summary quantiles. A provider that raises is skipped for
    that scrape (a broken gauge must not take down ``/metrics``); the
    error is remembered in ``last_provider_errors``.
    """

    def __init__(self, namespace: str = "cgnn",
                 window_s: float = 60.0):
        self.namespace = sanitize_metric_name(namespace)
        self.window_s = float(window_s)
        self._telemetry = None
        self._providers: list[tuple[str, Callable[[], dict]]] = []
        self._lock = threading.Lock()
        self.last_provider_errors: dict[str, str] = {}

    def attach_telemetry(self, telemetry) -> "MetricsRegistry":
        """Expose a ``Telemetry``'s live counters/gauges/series (no-op
        buffers at level 'off' simply contribute nothing)."""
        self._telemetry = telemetry
        return self

    def add_provider(self, name: str, fn: Callable[[], dict]) -> None:
        with self._lock:
            self._providers.append((name, fn))

    # ---- snapshot ----

    def snapshot(self, window_s: float | None = None) -> dict:
        """Merged live view: {"time", "counters", "gauges", "series",
        "histograms"}.

        Series quantiles cover the rolling window (``window_s`` defaults
        to the registry's, 60 s) — NOT the run lifetime; that is the
        whole point of the live plane.
        """
        window_s = self.window_s if window_s is None else window_s
        out = {"time": time.time(), "counters": {}, "gauges": {},
               "series": {}, "histograms": {}}
        t = self._telemetry
        if t is not None and getattr(t, "enabled", False):
            out["counters"].update(t.counters())
            out["gauges"].update(t.gauges())
            for name in t.series_names():
                q = t.series_quantiles(name, window_s=window_s)
                if q:
                    out["series"][name] = q
        with self._lock:
            providers = list(self._providers)
        for name, fn in providers:
            try:
                part = fn() or {}
            except Exception as e:  # noqa: BLE001 — scrape must survive
                self.last_provider_errors[name] = repr(e)
                continue
            self.last_provider_errors.pop(name, None)
            out["counters"].update(part.get("counters", {}))
            out["gauges"].update(part.get("gauges", {}))
            out["series"].update(part.get("series", {}))
            out["histograms"].update(part.get("histograms", {}))
        return out

    # ---- Prometheus exposition ----

    def prometheus_text(self, window_s: float | None = None) -> str:
        """The ``GET /metrics`` body (text exposition format 0.0.4)."""
        snap = self.snapshot(window_s=window_s)
        ns = self.namespace
        lines: list[str] = []

        def emit(name: str, kind: str, samples: list[tuple[str, float]],
                 help_text: str = "") -> None:
            full = f"{ns}_{sanitize_metric_name(name)}"
            if help_text:
                lines.append(f"# HELP {full} {help_text}")
            lines.append(f"# TYPE {full} {kind}")
            for labels, value in samples:
                if value != value:  # NaN: Prometheus accepts it, but a
                    continue        # poisoned gauge is noise, not signal
                lines.append(f"{full}{labels} {value:g}")

        for name, value in sorted(snap["counters"].items()):
            cname = name if name.endswith("_total") else f"{name}_total"
            emit(cname, "counter", [("", float(value))])

        # fold device{i}_* / replica{i}_* gauges into labeled families
        labeled_fams: dict[str, list[tuple[str, float]]] = {}
        plain: list[tuple[str, float]] = []
        for name, value in sorted(snap["gauges"].items()):
            for pattern, label in ((_DEVICE_GAUGE, "device"),
                                   (_REPLICA_GAUGE, "replica")):
                m = pattern.match(name)
                if m:
                    labeled_fams.setdefault(
                        f"{label}_{m.group(2)}", []).append(
                        (f'{{{label}="{m.group(1)}"}}', float(value))
                    )
                    break
            else:
                plain.append((name, float(value)))
        for name, value in plain:
            emit(name, "gauge", [("", value)])
        for fam, samples in sorted(labeled_fams.items()):
            emit(fam, "gauge", samples)

        for name, q in sorted(snap["series"].items()):
            samples = [(f'{{quantile="{lbl}"}}', q[key])
                       for lbl, key in (("0.5", "p50"), ("0.95", "p95"),
                                        ("0.99", "p99"))
                       if key in q]
            emit(name, "summary", samples)
            full = f"{ns}_{sanitize_metric_name(name)}"
            # _count/_sum MUST be cumulative (a windowed count shrinks
            # as samples age out, which rate()/increase() reads as a
            # counter reset); fall back to the window only for provider
            # series that carry no lifetime totals
            if "count_total" in q:
                lines.append(f"{full}_count {int(q['count_total'])}")
                lines.append(f"{full}_sum {q['sum_total']:g}")
            else:
                if "count" in q:
                    lines.append(f"{full}_count {int(q['count'])}")
                if "mean" in q and "count" in q:
                    lines.append(f"{full}_sum {q['mean'] * q['count']:g}")

        # mergeable histogram families (observe/hist.py): cumulative
        # _bucket/le + _sum/_count, bounds and sums rendered at full
        # round-trip precision, the cross-process truth. A provider key
        # may carry a label set (`name{param_version="..."}`): labeled
        # members group under ONE family declaration, labels riding
        # every sample — the per-version serve latency families.
        hist_fams: dict[str, list[tuple[dict | None, dict]]] = {}
        for key, hsnap in sorted(snap["histograms"].items()):
            name, labels = key, None
            if "{" in key:
                name, _, rest = key.partition("{")
                labels = _hist.parse_labels("{" + rest)
            full = f"{ns}_{sanitize_metric_name(name)}"
            hist_fams.setdefault(full, []).append((labels, hsnap))
        for full, members in sorted(hist_fams.items()):
            body: list[str] = []
            ok = True
            for labels, hsnap in members:
                try:
                    body.extend(_hist.snapshot_exposition_lines(
                        full, hsnap, labels=labels))
                except Exception as e:  # noqa: BLE001 — a malformed
                    # provider snapshot must not take down the scrape
                    self.last_provider_errors[f"histogram:{full}"] = repr(e)
                    ok = False
            if body or ok:
                lines.append(f"# TYPE {full} histogram")
                lines.extend(body)
        return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict:
    """Strict-enough parser for the exposition format (the validator
    lives with the emitter so they cannot drift).

    Returns {family: {"type": str, "samples": [(labels, value), ...]}}.
    Raises ValueError on a line that is neither a comment, blank, nor a
    ``name[{labels}] value`` sample, or on an unparseable value.

    Histogram families round-trip STRUCTURALLY: every declared-histogram
    family is validated on parse (each ``_bucket`` carries ``le``,
    cumulative counts are monotone non-decreasing in le order, ``+Inf``
    equals ``_count``) and its reconstructed per-label-set snapshots —
    ``observe.hist.Histogram.from_snapshot``-ready — land under the
    family's ``"histogram"`` key.
    """
    fams: dict[str, dict] = {}
    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)(\s+\d+)?$"
    )
    declared_type: dict[str, str] = {}
    for i, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                declared_type[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        m = sample_re.match(line)
        if not m:
            raise ValueError(f"line {i} is not a valid sample: {line!r}")
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        try:
            fval = float(value)
        except ValueError:
            raise ValueError(
                f"line {i}: unparseable value {value!r} for {name}"
            ) from None
        # summary _sum/_count samples belong to their base family
        base = name
        for suffix in ("_sum", "_count", "_bucket"):
            if name.endswith(suffix) and name[: -len(suffix)] in declared_type:
                base = name[: -len(suffix)]
                break
        fam = fams.setdefault(
            base, {"type": declared_type.get(base, "untyped"), "samples": []}
        )
        fam["samples"].append((name + labels, fval))
    for fname, fam in fams.items():
        if fam["type"] == "histogram":
            try:
                fam["histogram"] = _hist.snapshots_from_family(fam)
            except ValueError as e:
                raise ValueError(
                    f"invalid histogram family {fname!r}: {e}"
                ) from None
    return fams


class LiveMetricsWriter:
    """Periodic registry snapshots -> ``metrics_live.jsonl``.

    One JSON object per line (``{"time", "counters", "gauges",
    "series"}``), appended every ``interval_s`` by a daemon thread —
    the scrape path for runs with no HTTP surface (training). The file
    is opened lazily and append-mode, so a restarted run extends it.
    """

    def __init__(self, registry: MetricsRegistry, path: str,
                 interval_s: float = 10.0):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.registry = registry
        self.path = path
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self.writes = 0

    def write_once(self) -> dict:
        """Append one snapshot now; returns it (the testable core)."""
        snap = self.registry.snapshot()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with self._lock:
            with open(self.path, "a") as f:
                # non-finite floats -> null: a diverging run's NaN val
                # gauge must not make the line unparseable to strict
                # consumers
                f.write(json.dumps(jsonfinite(snap)) + "\n")
            self.writes += 1
        return snap

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.write_once()
            except Exception:  # noqa: BLE001 — the appender must outlive
                pass           # transient fs hiccups on a days-long run

    def start(self) -> "LiveMetricsWriter":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="cgnn-metrics-live"
            )
            self._thread.start()
        return self

    def stop(self, final_write: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if final_write:
            try:
                self.write_once()
            except Exception:  # noqa: BLE001 — best-effort at teardown
                pass
