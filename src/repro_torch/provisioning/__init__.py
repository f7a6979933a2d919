"""Provisioning planner on the PyTorch port: trace-ensemble generators, the
batched Monte-Carlo tick engines (the CUDA kernel and the torch scan
engine), the event-driven Monte-Carlo engine on the host, and the
risk-constrained capacity search (port of ``repro.provisioning``).

Importing this package registers the scenario-family trace generators
(bursty, colocated, failover-surge, rack-incident, nighttime) and the named
``mc-*`` scenarios alongside the figure scenarios.
"""

from repro_torch.provisioning.batched import (
    BatchedRun,
    TickModel,
    lower_ensemble,
    run_batched_ensemble,
    run_batched_grid,
    run_tick_model,
    run_tick_models,
)
from repro_torch.provisioning.ensembles import (
    GENERATOR_FAMILY,
    MC_BASE_NAME,
    MC_SCENARIO_FAMILY,
    SiteTrace,
    compose_rows,
    compose_site,
)
from repro_torch.provisioning.montecarlo import (
    EnsembleResult,
    EnsembleSpec,
    MemberStats,
    resolve_ensemble_budget,
    run_ensemble,
    run_ensemble_grid,
    run_ensemble_sequential,
)
from repro_torch.provisioning.planner import (
    PlanPoint,
    PlanResult,
    RiskConstraints,
    plan_capacity,
    plan_scenarios,
)

__all__ = [
    "BatchedRun",
    "EnsembleResult",
    "EnsembleSpec",
    "GENERATOR_FAMILY",
    "MC_BASE_NAME",
    "MC_SCENARIO_FAMILY",
    "MemberStats",
    "PlanPoint",
    "PlanResult",
    "RiskConstraints",
    "SiteTrace",
    "TickModel",
    "compose_rows",
    "compose_site",
    "lower_ensemble",
    "plan_capacity",
    "plan_scenarios",
    "resolve_ensemble_budget",
    "run_batched_ensemble",
    "run_batched_grid",
    "run_ensemble",
    "run_ensemble_grid",
    "run_ensemble_sequential",
    "run_tick_model",
    "run_tick_models",
]
