"""Observability: the declared metrics registry (``metrics_schema``) and the
live ``/metrics`` exporter (``telemetry``), both standard library only."""

from distributed_sigmoid_loss_tpu_torch.obs.metrics_schema import (
    HEALTH_EVENT_FIELDS,
    SERVE_STATS_FIELDS,
    TRAIN_METRICS_FIELDS,
    TRAIN_METRICS_PREFIXES,
    validate_metrics,
)
from distributed_sigmoid_loss_tpu_torch.obs.telemetry import TelemetryExporter, render_openmetrics

__all__ = [
    "HEALTH_EVENT_FIELDS",
    "SERVE_STATS_FIELDS",
    "TRAIN_METRICS_FIELDS",
    "TRAIN_METRICS_PREFIXES",
    "TelemetryExporter",
    "render_openmetrics",
    "validate_metrics",
]
