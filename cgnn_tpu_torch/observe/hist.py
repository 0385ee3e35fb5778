"""Mergeable fixed-bucket histograms (``cgnn_tpu/observe/hist.py``).

A quantile of one process's samples cannot be combined with another
process's quantile; per-bucket counts over a fixed, shared bucket layout
can: integer addition is associative and commutative, so merging the
histograms of several processes equals the histogram of all their
observations pooled, bit for bit in the counts.

Bucket layouts are log-spaced (:func:`log_bounds`) and frozen per metric
family (the module constants): :meth:`Histogram.merge` refuses
mismatched bounds. Rendering follows the Prometheus histogram
convention: cumulative ``_bucket`` samples labelled with their inclusive
upper bound ``le``, a ``+Inf`` bucket equal to ``_count``, and ``_sum``.
Bounds and sums render via ``repr`` (the shortest round-trip float), so
parsing the text reconstructs the exact snapshot.

Host-side integer bookkeeping only: nothing here touches a device.
"""

from __future__ import annotations

import bisect
import math
import re
import threading

_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_labels(labels: str) -> dict:
    """``{a="1",le="0.5"}`` -> {"a": "1", "le": "0.5"} ("" -> {})."""
    return dict(_LABEL_RE.findall(labels or ""))


def format_labels(labels: dict) -> str:
    """The inverse of :func:`parse_labels` (sorted, stable)."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt(value: float) -> str:
    """Shortest exact round-trip rendering (float(_fmt(v)) == v)."""
    return repr(float(value))


def log_bounds(lo: float, hi: float, per_decade: int = 6) -> tuple:
    """Log-spaced inclusive upper bounds from ``lo`` up past ``hi``.

    Deterministic given the arguments — every process computing the same
    ``log_bounds(...)`` call gets bit-identical floats, which is what
    makes the bounds a cross-process contract rather than a local
    choice. The last bound is the first grid point >= ``hi``.
    """
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError(f"bad log_bounds({lo}, {hi}, {per_decade})")
    start = round(math.log10(lo) * per_decade)
    bounds = []
    i = start
    while True:
        b = 10.0 ** (i / per_decade)
        bounds.append(b)
        if b >= hi:
            return tuple(bounds)
        i += 1


# the frozen per-family layouts: latency and queue-wait share one grid
# (both are milliseconds of request time), flush occupancy is a fraction
# in (0, 1]
LATENCY_MS_BOUNDS = log_bounds(0.1, 60_000.0, per_decade=6)
QUEUE_WAIT_MS_BOUNDS = LATENCY_MS_BOUNDS
OCCUPANCY_BOUNDS = log_bounds(0.01, 1.0, per_decade=8)


class Histogram:
    """Fixed-bucket histogram with associative, bit-exact count merge.

    ``bounds`` are strictly increasing inclusive upper bounds; values
    above the last bound land in the implicit ``+Inf`` bucket. Counts
    are integers (merge is exact); ``sum`` is a float accumulated in
    observation order (exact whenever the observed values are exactly
    representable and their running sum stays exact — the pooled-equals-
    merged test uses dyadic values for precisely this reason; real
    traffic compares sums within bucket resolution instead).

    Thread-safe; observation is O(log buckets) (bisect).
    """

    def __init__(self, bounds=LATENCY_MS_BOUNDS):
        bounds = tuple(float(b) for b in bounds)
        if not bounds:
            raise ValueError("histogram needs at least one bound")
        for a, b in zip(bounds, bounds[1:]):
            if not a < b:
                raise ValueError(f"bounds not increasing: {a} !< {b}")
        if any(not math.isfinite(b) for b in bounds):
            raise ValueError("bounds must be finite (+Inf is implicit)")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # [+Inf] last
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    # ---- observation ----

    def observe(self, value: float) -> None:
        value = float(value)
        if value != value:  # NaN: a poisoned sample is noise, not signal
            return
        i = self._bucket_index(value)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += value

    def _bucket_index(self, value: float) -> int:
        # first bound >= value (le is INCLUSIVE: v == bound stays in it)
        return bisect.bisect_left(self.bounds, value)

    # ---- views ----

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> dict:
        """One consistent ``{"bounds", "counts", "count", "sum"}`` view
        (``counts`` per-bucket, NOT cumulative; +Inf bucket last)."""
        with self._lock:
            return {
                "bounds": list(self.bounds),
                "counts": list(self._counts),
                "count": self._count,
                "sum": self._sum,
            }

    def cumulative(self) -> list:
        """Cumulative counts per bound + the +Inf total (len bounds+1)."""
        snap = self.snapshot()
        out, running = [], 0
        for c in snap["counts"]:
            running += c
            out.append(running)
        return out

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (linear within bucket).

        A derived convenience: its precision is one bucket; the
        bucket counts are the truth.
        Returns nan when empty.
        """
        return quantile_from_snapshot(self.snapshot(), q)

    # ---- merge (the whole point) ----

    @classmethod
    def from_snapshot(cls, snap: dict) -> "Histogram":
        h = cls(snap["bounds"])
        counts = [int(c) for c in snap["counts"]]
        if len(counts) != len(h._counts):
            raise ValueError(
                f"snapshot has {len(counts)} buckets for "
                f"{len(h._counts)} bounds(+Inf)"
            )
        if any(c < 0 for c in counts):
            raise ValueError("negative bucket count in snapshot")
        h._counts = counts
        h._count = int(snap["count"])
        h._sum = float(snap["sum"])
        if h._count != sum(counts):
            raise ValueError(
                f"snapshot count {h._count} != bucket total {sum(counts)}"
            )
        return h

    def merge(self, other: "Histogram") -> "Histogram":
        """A NEW histogram = self + other (inputs untouched).

        Refuses mismatched bucket layouts: merging differently-bucketed
        families silently would produce numbers that look valid and mean
        nothing — the exact failure mode this module exists to prevent.
        """
        if self.bounds != other.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds "
                f"({len(self.bounds)} vs {len(other.bounds)} buckets; "
                f"first diff at "
                f"{next((i for i, (a, b) in enumerate(zip(self.bounds, other.bounds)) if a != b), 'length')})"
            )
        a, b = self.snapshot(), other.snapshot()
        out = Histogram(self.bounds)
        out._counts = [x + y for x, y in zip(a["counts"], b["counts"])]
        out._count = a["count"] + b["count"]
        out._sum = a["sum"] + b["sum"]
        return out

    @classmethod
    def merge_all(cls, hists) -> "Histogram":
        hists = list(hists)
        if not hists:
            raise ValueError("merge_all of no histograms")
        out = hists[0]
        for h in hists[1:]:
            out = out.merge(h)
        return out

    # ---- Prometheus exposition ----

    def exposition_lines(self, fullname: str, labels: dict | None = None
                         ) -> list:
        """The family body (no # TYPE line — the registry emits that):
        cumulative ``_bucket`` samples, ``+Inf``, ``_sum``, ``_count``.
        Extra ``labels`` (e.g. a preserved replica label) ride every
        sample beside ``le``."""
        return snapshot_exposition_lines(fullname, self.snapshot(),
                                         labels=labels)


def snapshot_exposition_lines(fullname: str, snap: dict,
                              labels: dict | None = None) -> list:
    """Render a histogram snapshot as Prometheus sample lines.

    Bounds and sums render via ``repr`` so the sibling parser
    reconstructs the exact floats — the round-trip contract.
    """
    labels = dict(labels or {})
    lines = []
    running = 0
    for b, c in zip(snap["bounds"], snap["counts"]):
        running += c
        lbl = format_labels({**labels, "le": _fmt(b)})
        lines.append(f"{fullname}_bucket{lbl} {running}")
    running += snap["counts"][-1]
    lbl = format_labels({**labels, "le": "+Inf"})
    lines.append(f"{fullname}_bucket{lbl} {running}")
    base = format_labels(labels)
    lines.append(f"{fullname}_sum{base} {_fmt(snap['sum'])}")
    lines.append(f"{fullname}_count{base} {int(snap['count'])}")
    return lines


def quantile_from_snapshot(snap: dict, q: float) -> float:
    """Bucket-resolution quantile from a histogram snapshot (nan when
    empty). Linear interpolation inside the landing bucket; the first
    bucket interpolates from 0, the +Inf bucket reports the last finite
    bound (there is no upper edge to interpolate toward)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = int(snap["count"])
    if total <= 0:
        return float("nan")
    rank = q * total
    running = 0
    bounds = snap["bounds"]
    for i, c in enumerate(snap["counts"]):
        prev_running = running
        running += c
        if running >= rank and c > 0:
            if i >= len(bounds):  # +Inf bucket
                return float(bounds[-1])
            lo = 0.0 if i == 0 else float(bounds[i - 1])
            hi = float(bounds[i])
            frac = (rank - prev_running) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    return float(bounds[-1])


def snapshots_from_family(family: dict) -> dict:
    """Reconstruct histogram snapshots from ONE parsed exposition family
    (:func:`~cgnn_tpu_torch.observe.export.parse_prometheus_text` output for a
    ``# TYPE ... histogram`` family).

    Returns ``{label_key: snapshot}`` where ``label_key`` is the
    non-``le`` label set rendered via :func:`format_labels` ("" for an
    unlabeled family) — labels are PRESERVED through a merge, so
    e.g. per-rung histograms merge per rung, never across rungs.

    Validates the Prometheus histogram invariants and raises ValueError
    on violation: every ``_bucket`` carries ``le``, cumulative counts
    are monotone non-decreasing in le order, and the ``+Inf`` bucket
    equals ``_count``.
    """
    by_key: dict = {}
    for name_labels, value in family["samples"]:
        brace = name_labels.find("{")
        name = name_labels if brace < 0 else name_labels[:brace]
        labels = parse_labels("" if brace < 0 else name_labels[brace:])
        if name.endswith("_bucket"):
            le = labels.pop("le", None)
            if le is None:
                raise ValueError(
                    f"histogram bucket sample without le label: "
                    f"{name_labels!r}"
                )
            key = format_labels(labels)
            entry = by_key.setdefault(
                key, {"buckets": [], "sum": None, "count": None})
            ub = float("inf") if le == "+Inf" else float(le)
            entry["buckets"].append((ub, value))
        elif name.endswith("_sum"):
            by_key.setdefault(format_labels(labels),
                              {"buckets": [], "sum": None, "count": None}
                              )["sum"] = value
        elif name.endswith("_count"):
            by_key.setdefault(format_labels(labels),
                              {"buckets": [], "sum": None, "count": None}
                              )["count"] = value
    out = {}
    for key, entry in by_key.items():
        buckets = sorted(entry["buckets"])
        if not buckets or not math.isinf(buckets[-1][0]):
            raise ValueError(f"histogram series {key!r} has no +Inf bucket")
        cum = [c for _, c in buckets]
        for a, b in zip(cum, cum[1:]):
            if b < a:
                raise ValueError(
                    f"histogram series {key!r} cumulative counts "
                    f"decrease ({a} -> {b}) — not a valid histogram"
                )
        if entry["count"] is not None and cum[-1] != entry["count"]:
            raise ValueError(
                f"histogram series {key!r}: +Inf bucket {cum[-1]} != "
                f"_count {entry['count']}"
            )
        counts = [int(cum[0])] + [int(b - a)
                                  for a, b in zip(cum, cum[1:])]
        out[key] = {
            "bounds": [ub for ub, _ in buckets[:-1]],
            "counts": counts,
            "count": int(cum[-1]),
            "sum": float(entry["sum"] if entry["sum"] is not None
                         else 0.0),
        }
    return out


def merge_snapshot_maps(maps) -> dict:
    """Merge N ``{label_key: snapshot}`` maps (one per scraped process)
    into one, label-set by label-set. A label
    set present in only some processes merges what exists (a replica
    that never saw rung-2 traffic contributes nothing to rung 2)."""
    merged: dict = {}
    for m in maps:
        for key, snap in m.items():
            if key in merged:
                merged[key] = merged[key].merge(
                    Histogram.from_snapshot(snap))
            else:
                merged[key] = Histogram.from_snapshot(snap)
    return {k: h.snapshot() for k, h in merged.items()}
