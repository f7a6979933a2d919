"""Observability of the port (port of ``repro.obs``).

The passive recorder of :mod:`repro_torch.obs.metrics` — counters, gauges,
histograms, spans and the structured event log, behind a no-op
:class:`NullRecorder` default so instrumentation never perturbs an
unobserved run — and the *online* half on top of it: ``stream``
(O(1)-state windowed aggregation — P² quantile digests, EWMA slope over the
40 s OOB horizon, tumbling/sliding windows — fed by the fleet telemetry
tick) and ``alerts`` (the registered :class:`AlertSpec` rule family an
:class:`AlertEngine` evaluates per tick, with engage/release hysteresis).
Recorder-on/off and alerts-on/off simulations are bit-identical:
observability observes, never perturbs. Incident reconstruction, the
exporters and the logging setup wait for their port.
"""

from repro_torch.obs.alerts import (
    ALERT_BUILDERS,
    AlertEngine,
    AlertEvent,
    AlertSpec,
    coerce_alerts,
    default_alert_pack,
)
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
from repro_torch.obs.stream import (
    OOB_HORIZON_S,
    EwmaSlope,
    FleetStream,
    P2Quantile,
    SlidingCounter,
    TumblingWindow,
    WindowStats,
)

__all__ = [
    "ALERT_BUILDERS",
    "AlertEngine",
    "AlertEvent",
    "AlertSpec",
    "DEFAULT_BUCKETS",
    "Event",
    "EwmaSlope",
    "FleetStream",
    "Histogram",
    "MetricsRecorder",
    "MetricsSnapshot",
    "NULL_RECORDER",
    "NullRecorder",
    "OOB_HORIZON_S",
    "P2Quantile",
    "SlidingCounter",
    "SpanStats",
    "TumblingWindow",
    "WindowStats",
    "coerce_alerts",
    "default_alert_pack",
    "get_recorder",
    "recording",
    "set_recorder",
]
