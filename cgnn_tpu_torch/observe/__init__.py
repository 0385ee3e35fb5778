"""The port's copies of the JAX package's observability helpers that
import no JAX (``cgnn_tpu/observe``): what the serving front door and
the checkpoints need (``metrics_io.jsonfinite``, ``tracectx``). The rest
of ``observe/`` (the JSON log lines and their trace ids, telemetry,
spans, export, flight recorder, SLOs) is ROADMAP Queue 1, item 11."""
