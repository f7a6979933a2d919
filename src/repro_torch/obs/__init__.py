"""Observability of the port (port of ``repro.obs``): for now the passive
recorder of :mod:`repro_torch.obs.metrics` — counters, gauges, histograms,
spans and the structured event log, behind a no-op :class:`NullRecorder`
default so instrumentation never perturbs an unobserved run. Streaming
aggregation, alerting, incident reconstruction and the exporters wait for
their port.
"""

from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    NULL_RECORDER,
    Event,
    Histogram,
    MetricsRecorder,
    MetricsSnapshot,
    NullRecorder,
    SpanStats,
    get_recorder,
    recording,
    set_recorder,
)

__all__ = [
    "DEFAULT_BUCKETS",
    "Event",
    "Histogram",
    "MetricsRecorder",
    "MetricsSnapshot",
    "NULL_RECORDER",
    "NullRecorder",
    "SpanStats",
    "get_recorder",
    "recording",
    "set_recorder",
]
