"""Observability (the JAX package's ``obs``):

- :mod:`.spans`: thread-safe ring-buffered host spans (the train loop's
  stages, the serving stack's per-request stages) with a Chrome-trace export
  that overlays ``utils.profiling.trace``'s device captures; merged offline
  by ``obs summarize``.
- :mod:`.attribution`: static per-step FLOPs, bytes and per-kind collective
  wire bytes from a trace on tensors without storage, and the roofline
  ``mfu_est`` on every train metrics line; the step trace the lint reads
  (``trace_ops``) and ``step_config_attribution`` (imports torch when
  called).
- :mod:`.health`: the host-side NaN/Inf and loss-spike watchdog, and the
  flight recorder that dumps the last N metrics lines on a crash, a
  divergence or SIGTERM.
- :mod:`.metrics_schema`: the declared registry of every train-metrics and
  serve-stats field, checked at emit by ``MetricsLogger``.
- :mod:`.ledger`: the append-only run ledger (``build/ledger.jsonl``) that
  ``serve-bench`` and ``data-bench`` append to; ``obs ledger`` / ``obs
  diff``.
- :mod:`.telemetry`: the ``/metrics`` exporter the serving stack mounts and
  the telemetry file ``train --obs-dir`` writes.
- :mod:`.lockwatch`: the ``named_lock`` factories every host-stack lock goes
  through, and the potential-deadlock witness under ``DSL_LOCKWATCH=1``.
- :mod:`.regress`: ``obs regress``, the proxy regression gate of the step
  configs' attribution and the loss islands' bytes against the committed
  ``regress_baseline.json`` (imports torch when called; not imported here).

Everything imported here is standard library only.
"""

from distributed_sigmoid_loss_tpu_torch.obs.health import (
    FlightRecorder,
    HealthEvent,
    HealthWatchdog,
)
from distributed_sigmoid_loss_tpu_torch.obs.ledger import (
    append_record,
    diff_records,
    environment_fingerprint,
    read_ledger,
    record_status,
    trajectory,
    trajectory_summary,
)
from distributed_sigmoid_loss_tpu_torch.obs.lockwatch import (
    WATCHED_LOCKS,
    WitnessGraph,
    lockwatch_enabled,
    named_condition,
    named_lock,
    named_rlock,
    watched_lock,
    witness,
)
from distributed_sigmoid_loss_tpu_torch.obs.metrics_schema import (
    HEALTH_EVENT_FIELDS,
    SERVE_STATS_FIELDS,
    TRAIN_METRICS_FIELDS,
    TRAIN_METRICS_PREFIXES,
    validate_metrics,
)
from distributed_sigmoid_loss_tpu_torch.obs.spans import (
    Span,
    SpanRecorder,
    merge_chrome_traces,
    summarize_spans,
)
from distributed_sigmoid_loss_tpu_torch.obs.telemetry import (
    TelemetryExporter,
    render_openmetrics,
    write_telemetry_file,
)

__all__ = [
    "Span",
    "SpanRecorder",
    "summarize_spans",
    "merge_chrome_traces",
    "HealthWatchdog",
    "HealthEvent",
    "FlightRecorder",
    "TRAIN_METRICS_FIELDS",
    "TRAIN_METRICS_PREFIXES",
    "SERVE_STATS_FIELDS",
    "HEALTH_EVENT_FIELDS",
    "validate_metrics",
    "append_record",
    "read_ledger",
    "record_status",
    "trajectory",
    "trajectory_summary",
    "diff_records",
    "environment_fingerprint",
    "TelemetryExporter",
    "render_openmetrics",
    "write_telemetry_file",
    "WATCHED_LOCKS",
    "WitnessGraph",
    "lockwatch_enabled",
    "named_lock",
    "named_rlock",
    "named_condition",
    "watched_lock",
    "witness",
]
