"""The port's observability core (``cgnn_tpu/observe``): the telemetry
facade (``Telemetry``: ``metrics.jsonl``, ``trace.json``,
``manifest.json``), the per-step stream out of replayed step graphs
(``StepStream``), in-graph grad health, gauges, mergeable histograms, the
live export plane (``MetricsRegistry``, ``GET /metrics``,
``LiveMetricsWriter``), JSON log lines with trace ids, the
``X-Trace-Parent`` wire, on-demand ``torch.profiler`` captures
(``ProfileCapture``, SIGUSR2, ``profile_trace``), the incident flight
recorder (``FlightRecorder``) with the trace joiner (``trace_join``),
the SLO engine (``SLOEngine``) and the embedded time-series store
(``TimeSeriesStore``, ``TsdbCollector``).
"""

from cgnn_tpu_torch.observe.export import (
    LiveMetricsWriter,
    MetricsRegistry,
    RollingSeries,
    parse_prometheus_text,
)
from cgnn_tpu_torch.observe.flightrec import FlightRecorder
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
from cgnn_tpu_torch.observe.metrics_io import (
    MetricsLogger,
    enable_debug_nans,
    jsonfinite,
    profile_trace,
    read_jsonl,
)
from cgnn_tpu_torch.observe.profile import (
    ProfileBusy,
    ProfileCapture,
    install_sigusr2,
)
from cgnn_tpu_torch.observe.slo import (
    BurnRateRule,
    SLOEngine,
    SLOObjective,
    default_rules,
)
from cgnn_tpu_torch.observe.spans import SpanTracer
from cgnn_tpu_torch.observe.stream import StepStream
from cgnn_tpu_torch.observe.telemetry import Telemetry
from cgnn_tpu_torch.observe.tracectx import (
    TRACE_PARENT_HEADER,
    format_parent,
    mint_span_id,
    parse_parent,
)
from cgnn_tpu_torch.observe.tsdb import TimeSeriesStore, TsdbCollector

__all__ = [
    "BurnRateRule",
    "FlightRecorder",
    "Histogram",
    "LATENCY_MS_BOUNDS",
    "LiveMetricsWriter",
    "MetricsLogger",
    "MetricsRegistry",
    "OCCUPANCY_BOUNDS",
    "ProfileBusy",
    "ProfileCapture",
    "QUEUE_WAIT_MS_BOUNDS",
    "RollingSeries",
    "SLOEngine",
    "SLOObjective",
    "SpanTracer",
    "StepStream",
    "TRACE_PARENT_HEADER",
    "Telemetry",
    "TimeSeriesStore",
    "TsdbCollector",
    "bind_trace",
    "current_trace_id",
    "default_rules",
    "device_hbm_table_bytes",
    "enable_debug_nans",
    "format_parent",
    "grad_health_metrics",
    "hbm_gauges",
    "install_sigusr2",
    "json_log_fn",
    "jsonfinite",
    "log_bounds",
    "merge_snapshot_maps",
    "mint_span_id",
    "padding_gauges",
    "parse_parent",
    "parse_prometheus_text",
    "profile_trace",
    "quantile_from_snapshot",
    "read_jsonl",
    "setup_json_logging",
    "snapshots_from_family",
    "write_manifest",
]
