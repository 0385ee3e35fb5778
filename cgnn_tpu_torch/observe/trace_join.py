"""Trace joining (``cgnn_tpu/observe/trace_join.py``): N processes' span
rings -> one Chrome-trace/Perfetto document.

Every server keeps a bounded span ring (observe/spans.py) and serves it as
a self-describing window over ``GET /trace``. This module pulls the
windows, rebases each process's relative-microsecond timestamps onto one
wall-clock anchor (``SpanTracer.t0_unix``) and emits one document in
which a request reads as one tree: spans linked by the propagated span
ids (observe/tracectx.py) are joined by flow arrows.

Every source window carries its ring's ``dropped`` count and retained
bounds; ``incomplete_processes`` lists the rings that evicted events, and
the per-trace index marks a chain whose root may be gone, so a truncated
join is never mistaken for a complete one. Alignment across processes
rides ``time.time()`` sampled once a tracer (wall-clock skew; sub-ms on
one host); within a process the order is exact ``perf_counter``.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.parse
import urllib.request
import zlib

from cgnn_tpu_torch.observe.metrics_io import jsonfinite

# joined-trace span names that root a request's tree in their process
_ROOT_NAMES = ("fleet.request", "serve.request")


def parse_since_query(path: str) -> tuple[float | None, str]:
    """``/trace?since=...`` request path -> ``(since_s, "")``, or
    ``(None, error_message)`` on a malformed value; ``(None, "")``
    when the parameter is absent. Shared by the serve and fleet HTTP
    handlers so the query contract cannot drift between them."""
    query = urllib.parse.parse_qs(urllib.parse.urlsplit(path).query)
    if "since" not in query:
        return None, ""
    try:
        return float(query["since"][0]), ""
    except ValueError:
        return None, "since must be a unix timestamp in seconds"


def fetch_window(base_url: str, since_s: float | None = None,
                 timeout_s: float = 5.0) -> dict:
    """GET one process's ``/trace`` window; raises on wire failure or a
    non-JSON body (the caller decides whether a missing process fails
    the join or just shrinks it)."""
    url = base_url.rstrip("/") + "/trace"
    if since_s is not None:
        url += "?" + urllib.parse.urlencode({"since": f"{since_s:.6f}"})
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read())


def collect_windows(base_urls, since_s: float | None = None,
                    timeout_s: float = 5.0) -> tuple[list, dict]:
    """Pull ``/trace`` from every url; -> (windows, {url: error}).

    Unreachable processes shrink the join instead of failing it — an
    incident bundle wants whatever the survivors still hold (the dead
    replica's window died with it; that absence IS the finding)."""
    windows, errors = [], {}
    for url in base_urls:
        try:
            windows.append(fetch_window(url, since_s=since_s,
                                        timeout_s=timeout_s))
        except Exception as e:  # noqa: BLE001 — collector must survive
            errors[url] = repr(e)
    return windows, errors


def _flow_id(span_id: str) -> int:
    # Chrome-trace flow events want an integer id; crc32 of the
    # process-unique span id is stable and collision-tolerant at ring
    # scale (a colliding arrow draws wrong, it cannot corrupt spans)
    return zlib.crc32(span_id.encode())


def join_windows(windows: list) -> dict:
    """N ``SpanTracer.window()`` dicts -> one Chrome-trace document.

    Each window becomes one pid (its real OS pid + role in the process
    name metadata); timestamps rebase onto the earliest window's
    ``t0_unix``. Span-id/parent args become flow arrows so Perfetto
    draws the cross-process tree. The document additionally carries a
    ``traces`` index (trace id -> pids/spans/rooted/complete) — the
    machine-checkable join."""
    windows = [w for w in windows if w and w.get("events") is not None]
    if not windows:
        return {"traceEvents": [], "traces": {},
                "incomplete_processes": []}
    anchor = min(float(w.get("t0_unix", 0.0)) for w in windows)
    events: list[dict] = []
    incomplete: list[str] = []
    span_ends: dict[str, tuple[int, int, float]] = {}  # sid -> (pid,tid,ts)
    children: list[tuple[str, dict]] = []              # (parent sid, event)
    traces: dict[str, dict] = {}
    for i, w in enumerate(windows):
        pid = int(w.get("pid", i))
        name = str(w.get("process", f"process-{i}"))
        role = str(w.get("role", ""))
        label = f"{role}:{name}" if role else name
        offset_us = (float(w.get("t0_unix", anchor)) - anchor) * 1e6
        dropped = int(w.get("dropped", 0))
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": label}})
        events.append({
            "name": "process_labels", "ph": "M", "pid": pid,
            "args": {"labels": f"dropped={dropped} "
                               f"window_us=[{w.get('begin_us', 0):.0f},"
                               f"{w.get('end_us', 0):.0f}]"},
        })
        if dropped:
            incomplete.append(label)
        for e in w["events"]:
            ev = dict(e)
            ev["pid"] = pid
            ev["ts"] = float(ev.get("ts", 0.0)) + offset_us
            events.append(ev)
            args = ev.get("args") or {}
            tid = args.get("trace_id")
            if tid:
                t = traces.setdefault(tid, {
                    "pids": set(), "spans": [], "rooted": False,
                    "from_truncated_ring": False,
                })
                t["pids"].add(pid)
                t["spans"].append(ev.get("name", ""))
                if ev.get("name") in _ROOT_NAMES and not args.get("parent"):
                    t["rooted"] = True
                if dropped:
                    t["from_truncated_ring"] = True
            sid = args.get("span_id")
            if sid:
                span_ends[sid] = (pid, ev.get("tid", 0),
                                  ev["ts"] + float(ev.get("dur", 0.0)))
            parent = args.get("parent")
            if parent:
                children.append((parent, ev))
    # flow arrows: parent span end -> child span start, one id per edge
    for parent, ev in children:
        src = span_ends.get(parent)
        if src is None:
            continue  # the parent's ring evicted it — the incomplete
            #           marking above already says so
        fid = _flow_id(parent + "->" + str(ev.get("args", {})
                                           .get("span_id", ev["ts"])))
        spid, stid, sts = src
        events.append({"name": "trace_parent", "cat": "trace", "ph": "s",
                       "id": fid, "pid": spid, "tid": stid,
                       "ts": max(sts - 1.0, 0.0)})
        events.append({"name": "trace_parent", "cat": "trace", "ph": "f",
                       "bp": "e", "id": fid, "pid": ev["pid"],
                       "tid": ev.get("tid", 0), "ts": ev["ts"]})
    index = {
        tid: {
            "pids": sorted(t["pids"]),
            "spans": sorted(set(t["spans"])),
            "span_count": len(t["spans"]),
            "rooted": t["rooted"],
            # complete = we saw its root AND no contributing ring had
            # evicted events; anything else renders, but marked
            "complete": t["rooted"] and not t["from_truncated_ring"],
        }
        for tid, t in traces.items()
    }
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "t0_unix": anchor,
        "incomplete_processes": incomplete,
        "traces": index,
    }


def cross_process_traces(doc: dict, min_pids: int = 2,
                         span_name: str = "fleet.attempt",
                         min_spans: int = 2) -> list:
    """Trace ids whose joined tree spans >= ``min_pids`` processes and
    carries >= ``min_spans`` ``span_name`` spans — the retried/hedged
    requests a fleet's router produces."""
    out = []
    counts: dict[str, int] = {}
    for e in doc.get("traceEvents", []):
        if e.get("name") == span_name:
            tid = (e.get("args") or {}).get("trace_id")
            if tid:
                counts[tid] = counts.get(tid, 0) + 1
    for tid, t in doc.get("traces", {}).items():
        if len(t["pids"]) >= min_pids and counts.get(tid, 0) >= min_spans:
            out.append(tid)
    return sorted(out)


def write_joined(path: str, windows: list) -> dict:
    """Join + write; returns the document (``traces`` index included).

    The ``traces``/``incomplete_processes`` keys ride inside the same
    JSON — Perfetto ignores unknown top-level keys, so one file serves
    both the human (open it) and the assertion (parse it)."""
    doc = join_windows(windows)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        body = json.dumps(doc, allow_nan=False)
    except ValueError:
        body = json.dumps(jsonfinite(doc))
    with open(path, "w") as f:
        f.write(body)
    return doc
