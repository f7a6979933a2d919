"""Provisioning planner on the PyTorch port: trace-ensemble generators, the
batched Monte-Carlo tick engine on the CUDA kernel, and the risk-constrained
capacity search (port of ``repro.provisioning``).

Importing this package registers the scenario-family trace generators
(bursty, colocated, failover-surge, rack-incident, nighttime).
"""

from repro_torch.provisioning.batched import (
    BatchedRun,
    TickModel,
    lower_ensemble,
    run_batched_ensemble,
    run_tick_model,
)
from repro_torch.provisioning.ensembles import GENERATOR_FAMILY, compose_rows
from repro_torch.provisioning.montecarlo import (
    EnsembleResult,
    EnsembleSpec,
    MemberStats,
    resolve_ensemble_budget,
    run_ensemble,
)
from repro_torch.provisioning.planner import (
    PlanPoint,
    PlanResult,
    RiskConstraints,
    plan_capacity,
)

__all__ = [
    "BatchedRun",
    "EnsembleResult",
    "EnsembleSpec",
    "GENERATOR_FAMILY",
    "MemberStats",
    "PlanPoint",
    "PlanResult",
    "RiskConstraints",
    "TickModel",
    "compose_rows",
    "lower_ensemble",
    "plan_capacity",
    "resolve_ensemble_budget",
    "run_batched_ensemble",
    "run_ensemble",
    "run_tick_model",
]
