"""Unified Scenario/Experiment API for the POLCA power plane (port of
``repro.experiments``).

Declare an experiment as a :class:`Scenario` (fleet x workload x policy x
telemetry x seed), run it with :func:`run_experiment`, and read a structured
:class:`ExperimentResult`. Multi-row fleets run under the hierarchical
:class:`ClusterSimulator`; policies consume structured
:class:`~repro_torch.core.telemetry.Telemetry` samples. Routed fleets, budget
rebalancing and alerting (``RoutingSpec``, ``ControllerSpec`` and the fleet,
site and chaos scenario families) wait for their port.
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
    DAY,
    WEEK,
    FleetSpec,
    HierarchySpec,
    PolicySpec,
    Scenario,
    TelemetryConfig,
    TrafficSpec,
    get_scenario,
    list_scenarios,
    register_scenario,
)

__all__ = [
    "BASELINE_PEAK_UTIL",
    "ClusterResult",
    "ClusterSimulator",
    "DAY",
    "ExperimentResult",
    "FaultEvent",
    "FaultSpec",
    "FleetSpec",
    "HierarchySpec",
    "PowerHierarchy",
    "RackHierarchy",
    "PolicySpec",
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
