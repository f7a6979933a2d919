"""Unified Scenario/Experiment API for the POLCA power plane (port of
``repro.experiments``).

Declare an experiment as a :class:`Scenario` (fleet x workload x policy x
telemetry x seed), run it with :func:`run_experiment`, and read a structured
:class:`ExperimentResult`. Multi-row fleets run under the hierarchical
:class:`ClusterSimulator`; policies consume structured
:class:`~repro_torch.core.telemetry.Telemetry` samples; routed fleets
(``RoutingSpec``, ``ControllerSpec``) run under
:class:`~repro_torch.fleet.fleet.FleetSimulator`.
"""

from repro_torch.chaos import FaultEvent, FaultSpec
from repro_torch.core.hierarchy import PowerHierarchy
from repro_torch.core.telemetry import Telemetry, TelemetryPolicy, dispatch
from repro_torch.experiments.cluster import ClusterResult, ClusterSimulator, RackHierarchy
from repro_torch.experiments.runner import (
    BASELINE_PEAK_UTIL,
    ExperimentResult,
    build_workloads,
    calibrated_budget,
    resolve_budget,
    row_budgets,
    row_sim,
    row_trace,
    run_experiment,
    threshold_search,
)
from repro_torch.experiments.scenario import (
    CHAOS_SCENARIO_FAMILY,
    DAY,
    FLEET_SCENARIO_FAMILY,
    SITE_SCENARIO_FAMILY,
    WEEK,
    ControllerSpec,
    FleetSpec,
    HierarchySpec,
    PolicySpec,
    RoutingSpec,
    Scenario,
    TelemetryConfig,
    TrafficSpec,
    get_scenario,
    list_scenarios,
    register_scenario,
)

__all__ = [
    "BASELINE_PEAK_UTIL",
    "CHAOS_SCENARIO_FAMILY",
    "ClusterResult",
    "ClusterSimulator",
    "ControllerSpec",
    "DAY",
    "ExperimentResult",
    "FLEET_SCENARIO_FAMILY",
    "FaultEvent",
    "FaultSpec",
    "FleetSpec",
    "HierarchySpec",
    "PowerHierarchy",
    "RackHierarchy",
    "SITE_SCENARIO_FAMILY",
    "PolicySpec",
    "RoutingSpec",
    "Scenario",
    "Telemetry",
    "TelemetryConfig",
    "TelemetryPolicy",
    "TrafficSpec",
    "WEEK",
    "build_workloads",
    "calibrated_budget",
    "dispatch",
    "get_scenario",
    "list_scenarios",
    "register_scenario",
    "resolve_budget",
    "row_budgets",
    "row_sim",
    "row_trace",
    "run_experiment",
    "threshold_search",
]
