"""The record types of the event-driven row simulator (``repro.core.simulator``).

The event-driven ``RowSimulator`` itself is not ported yet. The tick engine
needs only the types that cross its boundary: ``WorkloadClass`` (built by
``core.traces``), ``Request`` (the trace record) and ``SimResult`` (what
``provisioning.batched._to_ensemble_result`` hands the ensemble statistics).
"""

from __future__ import annotations

from dataclasses import dataclass, field
import numpy as np

from repro_torch.core.slo import LatencyStats
from repro_torch.core.workload import RequestTiming


@dataclass(frozen=True)
class Request:
    t_arrival: float
    wl: int  # workload-class index
    prompt: int
    out_tokens: int
    priority: str  # "high" | "low"
    rid: int


@dataclass(frozen=True)
class WorkloadClass:
    name: str
    timing: RequestTiming  # from core.workload.request_timing
    priority_mix: float  # fraction of requests that are high priority


@dataclass
class SimResult:
    latency: LatencyStats
    n_brakes: int
    n_dropped: int
    n_completed: int
    served_tokens: float
    peak_power_frac: float
    mean_power_frac: float
    power_t: np.ndarray = field(default=None, repr=False)
    power_w: np.ndarray = field(default=None, repr=False)
