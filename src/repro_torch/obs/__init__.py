"""First-class observability for the POLCA power-plane stack (port of
``repro.obs``, every module copied in full; DESIGN.md §14–15).

The telemetry substrate the paper argues oversubscription control depends
on: ``metrics`` (counters/gauges/histograms with labels and snapshot/merge,
a ``span()`` wall-clock profiler, and a structured event log — all behind a
no-op :class:`NullRecorder` default so instrumentation never perturbs an
unobserved run), ``export`` (Prometheus text exposition, JSONL event
traces, per-run manifests under an ``--artifacts`` dir; the port's manifest
records torch, CUDA and the card), and ``log`` (the shared stderr
stdlib-logging setup the launchers route prints through).

A recorder's spans are also kept as a **timeline** (``metrics.SpanRecord``:
name, labels, host start and end in ``time.time_ns()``, the clock of
``torch.profiler``'s timestamps, the parent span and the request or step
id). ``device`` (imported as ``repro_torch.obs.device``, the one module
here that needs torch) opens the port's spans inside its prefill and
train steps: they record into the installed recorder while it is enabled,
and into a recorder the module keeps for the session while
``torch.profiler`` is on; each gets its device start and end from CUDA
events. Otherwise a site costs one check and records nothing.

On top of the passive recorder sits the *online* half: ``stream``
(O(1)-state windowed aggregation — P² quantile digests, EWMA slope over
the 40 s OOB horizon, tumbling/sliding windows — fed by the fleet telemetry
tick), ``alerts`` (the registered :class:`AlertSpec` rule family an
:class:`AlertEngine` evaluates per tick, with engage/release hysteresis),
and ``incidents`` (offline incident reconstruction from the exported event
trace: fault → detection → mitigation → clear timelines).

The hard guarantee, asserted in tier-1 tests: recorder-on/off and
alerts-on/off simulations are **bit-identical** — observability observes,
never perturbs.
"""

from repro_torch.obs.alerts import (
    ALERT_BUILDERS,
    AlertEngine,
    AlertEvent,
    AlertSpec,
    coerce_alerts,
    default_alert_pack,
)
from repro_torch.obs.export import (
    EVENTS_NAME,
    MANIFEST_NAME,
    METRICS_NAME,
    event_lines,
    prometheus_text,
    read_events,
    read_manifest,
    read_prometheus,
    run_manifest,
    write_artifacts,
)
from repro_torch.obs.incidents import (
    INCIDENTS_NAME,
    AttributedAlert,
    Incident,
    IncidentReport,
    incidents_json,
    reconstruct_incidents,
    render_incidents_markdown,
)
from repro_torch.obs.log import get_logger, setup_logging
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
    "AttributedAlert",
    "DEFAULT_BUCKETS",
    "EVENTS_NAME",
    "Event",
    "EwmaSlope",
    "FleetStream",
    "Histogram",
    "INCIDENTS_NAME",
    "Incident",
    "IncidentReport",
    "MANIFEST_NAME",
    "METRICS_NAME",
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
    "event_lines",
    "get_logger",
    "get_recorder",
    "incidents_json",
    "prometheus_text",
    "read_events",
    "read_manifest",
    "read_prometheus",
    "reconstruct_incidents",
    "recording",
    "render_incidents_markdown",
    "run_manifest",
    "set_recorder",
    "setup_logging",
    "write_artifacts",
]
