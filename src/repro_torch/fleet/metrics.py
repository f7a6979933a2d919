"""Routing-decision attribution: which dispatch choices cost latency (port
of ``repro.fleet.metrics``, copied in full).

Joins the fleet's decision log (:class:`~repro_torch.fleet.fleet.RoutingDecision`)
with per-row completion records to attribute SLO impact and queueing delay
to each routing decision group — per target row, and per router reason tag
(e.g. ``cap-aware/uncapped`` vs ``cap-aware/t2``), per priority. Impact here
is relative to the unqueued, uncapped ideal latency of the request's
workload class (the row simulator's own ideal), so attribution works on a
single policy run; experiment-level SLO gates still use the paired
uncapped-reference comparison from ``run_experiment``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from repro_torch.core.simulator import Request, WorkloadClass
from repro_torch.core.slo import LatencyStats
from repro_torch.fleet.fleet import FleetResult, RoutingDecision


@dataclass
class DecisionGroupStats:
    """Latency accounting for one group of routing decisions."""

    n_routed: int = 0
    n_completed: int = 0
    stats: LatencyStats = field(default_factory=LatencyStats)
    queue_delays_hp: List[float] = field(default_factory=list, repr=False)
    queue_delays_lp: List[float] = field(default_factory=list, repr=False)

    def queue_delay_mean(self, priority: str) -> float:
        xs = self.queue_delays_hp if priority == "high" else self.queue_delays_lp
        return float(np.mean(xs)) if xs else 0.0

    def queue_delay_p99(self, priority: str) -> float:
        xs = self.queue_delays_hp if priority == "high" else self.queue_delays_lp
        return float(np.percentile(np.asarray(xs), 99)) if xs else 0.0


@dataclass
class RoutingAttribution:
    """SLO impact and queueing delay per routing decision group."""

    per_row: Dict[int, DecisionGroupStats]
    per_reason: Dict[str, DecisionGroupStats]
    n_offered: int
    n_admitted: int
    n_shed: Dict[str, int]

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "n_offered": float(self.n_offered),
            "n_admitted": float(self.n_admitted),
            "shed_hp": float(self.n_shed.get("high", 0)),
            "shed_lp": float(self.n_shed.get("low", 0)),
        }
        for row, g in sorted(self.per_row.items()):
            out[f"row{row}_hp_p99"] = g.stats.percentile("high", 99)
            out[f"row{row}_qdelay_hp_mean"] = g.queue_delay_mean("high")
        return out


def _ideal_latency(req: Request, workloads: List[WorkloadClass]) -> float:
    timing = workloads[req.wl].timing
    return timing.t_prefill + req.out_tokens * timing.t_token


def attribute_routing(fres: FleetResult, requests: List[Request],
                      workloads: List[WorkloadClass]) -> RoutingAttribution:
    """Per-row and per-reason latency attribution for one fleet run.

    Requests that were shed or still in flight at the end of the run appear
    in ``n_routed`` but not ``n_completed``; conservation over the decision
    log (offered == admitted + shed) is the fleet driver's invariant.
    """
    by_rid = {r.rid: r for r in requests}
    latencies = fres.merged_latencies()
    qdelays = fres.merged_queue_delays()
    per_row: Dict[int, DecisionGroupStats] = {}
    per_reason: Dict[str, DecisionGroupStats] = {}

    def groups_for(d: RoutingDecision):
        yield per_row.setdefault(d.row, DecisionGroupStats())
        yield per_reason.setdefault(d.reason, DecisionGroupStats())

    for d in fres.decisions:
        if d.row < 0:
            g = per_reason.setdefault(d.reason, DecisionGroupStats())
            g.n_routed += 1
            continue
        req = by_rid[d.rid]
        lat = latencies.get(d.rid)
        for g in groups_for(d):
            g.n_routed += 1
            if lat is None:
                continue
            g.n_completed += 1
            g.stats.add(d.priority, lat, _ideal_latency(req, workloads))
            qd = qdelays.get(d.rid)
            if qd is not None:
                (g.queue_delays_hp if d.priority == "high"
                 else g.queue_delays_lp).append(qd)
    return RoutingAttribution(
        per_row=per_row,
        per_reason=per_reason,
        n_offered=fres.n_offered,
        n_admitted=fres.n_admitted,
        n_shed=dict(fres.n_shed),
    )
