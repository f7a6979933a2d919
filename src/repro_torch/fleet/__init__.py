"""Fleet serving layer: power-aware request routing, admission control, and
dynamic power rebalancing over oversubscribed clusters (port of
``repro.fleet``; DESIGN.md §10–§11).

``FleetSimulator`` drives M rows from one cluster-wide arrival process;
``router`` provides pluggable routing policies (round-robin, join-shortest-
queue, power-headroom, cap-state-aware, forecast-aware) plus priority-aware
admission control; ``controller`` re-balances per-row power budgets under
the fixed rack/cluster envelope (static / proportional / predictive);
``metrics`` attributes SLO impact and queueing delay per routing decision.
Scenarios opt in declaratively via
:class:`~repro_torch.experiments.scenario.RoutingSpec` and
:class:`~repro_torch.experiments.scenario.ControllerSpec`.
"""

from repro_torch.fleet.controller import (
    REBALANCE_BUILDERS,
    FleetController,
    PowerForecaster,
    ProportionalDemandPolicy,
    PredictiveRebalancePolicy,
    RebalanceEvent,
    RebalancePolicy,
    StaticBudgetPolicy,
    build_controller,
    build_rebalance_policy,
)
from repro_torch.fleet.fleet import (
    FleetResult,
    FleetSimulator,
    RoutingDecision,
    as_sim_result,
    build_fleet,
    fleet_trace,
    row_budgets,
)
from repro_torch.fleet.metrics import (
    DecisionGroupStats,
    RoutingAttribution,
    attribute_routing,
)
from repro_torch.fleet.router import (
    ADMISSION_BUILDERS,
    ROUTER_BUILDERS,
    AdmissionController,
    AdmitAll,
    CapAwareRouter,
    FleetView,
    ForecastAwareRouter,
    JoinShortestQueueRouter,
    PowerHeadroomRouter,
    RoundRobinRouter,
    Router,
    RowView,
    ShedLowPriority,
    ShedTokenBudget,
    build_admission,
    build_router,
)

__all__ = [
    "ADMISSION_BUILDERS",
    "REBALANCE_BUILDERS",
    "ROUTER_BUILDERS",
    "AdmissionController",
    "AdmitAll",
    "CapAwareRouter",
    "DecisionGroupStats",
    "FleetController",
    "FleetResult",
    "FleetSimulator",
    "FleetView",
    "ForecastAwareRouter",
    "JoinShortestQueueRouter",
    "PowerForecaster",
    "PowerHeadroomRouter",
    "PredictiveRebalancePolicy",
    "ProportionalDemandPolicy",
    "RebalanceEvent",
    "RebalancePolicy",
    "RoundRobinRouter",
    "Router",
    "RoutingAttribution",
    "RoutingDecision",
    "RowView",
    "ShedLowPriority",
    "ShedTokenBudget",
    "StaticBudgetPolicy",
    "as_sim_result",
    "attribute_routing",
    "build_admission",
    "build_controller",
    "build_fleet",
    "build_rebalance_policy",
    "build_router",
    "fleet_trace",
    "row_budgets",
]
