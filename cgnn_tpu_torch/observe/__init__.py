"""The port's observability core (``cgnn_tpu/observe``): the telemetry
facade (``Telemetry``: ``metrics.jsonl``, ``trace.json``,
``manifest.json``), the per-step stream out of replayed step graphs
(``StepStream``), in-graph grad health, gauges, mergeable histograms, the
live export plane (``MetricsRegistry``, ``GET /metrics``,
``LiveMetricsWriter``), JSON log lines with trace ids, and the
``X-Trace-Parent`` wire. Not ported yet (ROADMAP Queue 1, item 11):
``profile`` (part 3); ``flightrec`` and ``trace_join`` (part 4);
``slo`` and ``tsdb`` (part 5).
"""

from cgnn_tpu_torch.observe.export import (
    LiveMetricsWriter,
    MetricsRegistry,
    RollingSeries,
    parse_prometheus_text,
)
from cgnn_tpu_torch.observe.gauges import (
    device_hbm_table_bytes,
    hbm_gauges,
    padding_gauges,
)
from cgnn_tpu_torch.observe.health import grad_health_metrics
from cgnn_tpu_torch.observe.hist import (
    LATENCY_MS_BOUNDS,
    OCCUPANCY_BOUNDS,
    QUEUE_WAIT_MS_BOUNDS,
    Histogram,
    log_bounds,
    merge_snapshot_maps,
    quantile_from_snapshot,
    snapshots_from_family,
)
from cgnn_tpu_torch.observe.log import (
    bind_trace,
    current_trace_id,
    json_log_fn,
    setup_json_logging,
)
from cgnn_tpu_torch.observe.manifest import write_manifest
from cgnn_tpu_torch.observe.metrics_io import MetricsLogger, jsonfinite, read_jsonl
from cgnn_tpu_torch.observe.spans import SpanTracer
from cgnn_tpu_torch.observe.stream import StepStream
from cgnn_tpu_torch.observe.telemetry import Telemetry
from cgnn_tpu_torch.observe.tracectx import TRACE_PARENT_HEADER, parse_parent

__all__ = [
    "Histogram",
    "LATENCY_MS_BOUNDS",
    "LiveMetricsWriter",
    "MetricsLogger",
    "MetricsRegistry",
    "OCCUPANCY_BOUNDS",
    "QUEUE_WAIT_MS_BOUNDS",
    "RollingSeries",
    "SpanTracer",
    "StepStream",
    "TRACE_PARENT_HEADER",
    "Telemetry",
    "bind_trace",
    "current_trace_id",
    "device_hbm_table_bytes",
    "grad_health_metrics",
    "hbm_gauges",
    "json_log_fn",
    "jsonfinite",
    "log_bounds",
    "merge_snapshot_maps",
    "padding_gauges",
    "parse_parent",
    "parse_prometheus_text",
    "quantile_from_snapshot",
    "read_jsonl",
    "setup_json_logging",
    "snapshots_from_family",
    "write_manifest",
]
