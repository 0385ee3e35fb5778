"""The embedded multi-resolution time-series store
(``cgnn_tpu/observe/tsdb.py``): bounded history for the live plane.

``GET /metrics`` says what the p99 is now; ``GET /timeseries?name=&res=``
says what it was ten minutes ago. A ``TimeSeriesStore`` holds, for each
metric name and resolution tier (default 10s / 1m / 10m), a ring of
time-aligned aggregate buckets ``{t, count, sum, min, max, last}``.
``points_per_tier`` bounds each ring (the oldest bucket is evicted) and
``max_series`` the name space (novel names past it are dropped and
counted in ``dropped_series``). Every tier folds the same appends, so a
1m bucket is exactly the fold of its 10s buckets.

``TsdbCollector`` feeds it: a daemon thread that appends flattened
``MetricsRegistry`` snapshots every ``interval_s``, with ``on_tick``
callbacks on the same heartbeat (the server's SLO evaluation).
Injectable clock; host-side bookkeeping only.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from cgnn_tpu_torch.observe.hist import quantile_from_snapshot

DEFAULT_RESOLUTIONS = (("10s", 10.0), ("1m", 60.0), ("10m", 600.0))


class TimeSeriesStore:
    """Per-name, per-resolution rings of time-aligned aggregate buckets."""

    def __init__(self, resolutions=DEFAULT_RESOLUTIONS,
                 points_per_tier: int = 360, max_series: int = 512,
                 clock: Callable[[], float] = time.time):
        if points_per_tier < 1 or max_series < 1:
            raise ValueError(
                f"bad bounds: points_per_tier={points_per_tier}, "
                f"max_series={max_series}"
            )
        res = [(str(n), float(s)) for n, s in resolutions]
        if not res or any(s <= 0 for _, s in res):
            raise ValueError(f"bad resolutions: {resolutions!r}")
        if len({n for n, _ in res}) != len(res):
            raise ValueError(f"duplicate resolution names: {resolutions!r}")
        self._resolutions = dict(res)
        self.points_per_tier = int(points_per_tier)
        self.max_series = int(max_series)
        self._clock = clock
        self._lock = threading.Lock()
        # name -> res_name -> list of bucket dicts (ring, newest last)
        self._series: dict = {}
        self.dropped_series = 0
        self.appends = 0

    # ---- write ----

    def observe(self, name: str, value: float, now: float | None = None
                ) -> None:
        """Fold one scalar point into every resolution tier."""
        value = float(value)
        if value != value:  # NaN: history must stay aggregatable
            return
        now = self._clock() if now is None else float(now)
        with self._lock:
            tiers = self._series.get(name)
            if tiers is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return
                tiers = {res: [] for res in self._resolutions}
                self._series[name] = tiers
            self.appends += 1
            for res, step in self._resolutions.items():
                ring = tiers[res]
                t0 = (now // step) * step
                if ring and t0 <= ring[-1]["t"]:
                    # same bucket (or clock skew: fold rather than
                    # rewrite history)
                    b = ring[-1]
                    b["count"] += 1
                    b["sum"] += value
                    b["min"] = min(b["min"], value)
                    b["max"] = max(b["max"], value)
                    b["last"] = value
                else:
                    ring.append({"t": t0, "count": 1, "sum": value,
                                 "min": value, "max": value,
                                 "last": value})
                    if len(ring) > self.points_per_tier:
                        del ring[0]  # the ring bound: oldest evicted

    def append_snapshot(self, snap: dict, now: float | None = None) -> int:
        """Flatten one MetricsRegistry snapshot into scalar series.

        Counters keep their cumulative value (rate() is the reader's
        job), gauges their level, series quantiles fan out to
        ``<name>_p50/p95/p99``, histograms contribute their cumulative
        ``<name>_count``/``_sum`` plus a bucket-resolution ``_p99``
        estimate. Returns the number of points folded.
        """
        now = self._clock() if now is None else float(now)
        n = 0
        for name, value in snap.get("counters", {}).items():
            self.observe(name, float(value), now)
            n += 1
        for name, value in snap.get("gauges", {}).items():
            self.observe(name, float(value), now)
            n += 1
        for name, q in snap.get("series", {}).items():
            for key in ("p50", "p95", "p99"):
                if key in q:
                    self.observe(f"{name}_{key}", float(q[key]), now)
                    n += 1
        for name, hsnap in snap.get("histograms", {}).items():
            self.observe(f"{name}_count", float(hsnap["count"]), now)
            self.observe(f"{name}_sum", float(hsnap["sum"]), now)
            n += 2
            if hsnap["count"]:
                self.observe(f"{name}_p99",
                             quantile_from_snapshot(hsnap, 0.99), now)
                n += 1
        return n

    # ---- read ----

    def resolutions(self) -> dict:
        return dict(self._resolutions)

    def names(self) -> list:
        with self._lock:
            return sorted(self._series)

    def query(self, name: str, res: str) -> list:
        """The ring for (name, res), oldest first, each bucket
        ``{t, count, sum, min, max, last, mean}``. Unknown resolution
        raises (a typo must 400, not silently return []); an unknown
        name returns [] (the series may simply not have traffic yet).
        """
        if res not in self._resolutions:
            raise KeyError(
                f"unknown resolution {res!r} "
                f"(have: {sorted(self._resolutions)})"
            )
        with self._lock:
            ring = self._series.get(name, {}).get(res, [])
            out = []
            for b in ring:
                d = dict(b)
                d["mean"] = d["sum"] / d["count"] if d["count"] else 0.0
                out.append(d)
            return out

    def stats(self) -> dict:
        with self._lock:
            points = sum(len(ring) for tiers in self._series.values()
                         for ring in tiers.values())
            return {
                "series": len(self._series),
                "points": points,
                "appends": self.appends,
                "dropped_series": self.dropped_series,
                "resolutions": dict(self._resolutions),
                "points_per_tier": self.points_per_tier,
                "max_series": self.max_series,
            }


class TsdbCollector:
    """Daemon heartbeat: registry snapshot -> store, every interval.

    ``on_tick`` callbacks run after each append on the same thread —
    the serving layers use this for periodic SLO evaluation so the
    whole quantitative plane shares ONE timer. A callback that raises
    is swallowed per-tick (the collector must outlive a broken hook on
    a days-long server), like LiveMetricsWriter's appender.
    """

    def __init__(self, registry, store: TimeSeriesStore,
                 interval_s: float = 2.0):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.registry = registry
        self.store = store
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._ticks_cbs: list = []
        self.ticks = 0

    def add_on_tick(self, fn: Callable[[], None]) -> None:
        self._ticks_cbs.append(fn)

    def tick_once(self) -> int:
        """One collect cycle now (the testable core); returns points."""
        n = self.store.append_snapshot(self.registry.snapshot())
        for fn in list(self._ticks_cbs):
            try:
                fn()
            except Exception:  # noqa: BLE001 — heartbeat must survive
                pass
        self.ticks += 1
        return n

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick_once()
            except Exception:  # noqa: BLE001 — outlive transient hiccups
                pass

    def start(self) -> "TsdbCollector":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="cgnn-tsdb-collect"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
