"""The scenario helpers the tick engine reads (port of ``repro.experiments.runner``).

``run_experiment`` and the event-driven row/cluster/fleet runs wait for the
port of the event-driven simulator. What the batched lowering needs is here:
the Table-4 workload classes of a scenario, its per-row budgets, and the
budget resolution rule.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.core.simulator import WorkloadClass
from repro_torch.core.traces import build_workload_classes
from repro_torch.experiments.scenario import Scenario


def build_workloads(scenario: Scenario) -> Tuple[List[WorkloadClass], List[float]]:
    """Table-4 workload classes for the scenario's model/device, with the
    scenario's priority-mix override applied (Fig. 15b sweeps)."""
    server = scenario.fleet.server()
    wls, shares = build_workload_classes(scenario.fleet.model, server)
    mix = scenario.traffic.priority_mix_override
    if mix is not None:
        wls = [WorkloadClass(w.name, w.timing, mix) for w in wls]
    return wls, shares


def row_budgets(scenario: Scenario, budget_w: Optional[float],
                server) -> List[float]:
    """Per-row budgets in watts (``budget_w=None`` resolves to the nominal
    ``n_provisioned x server rating`` — the single copy of that rule).
    ``FleetSpec.row_budget_fracs`` scales each row's share of the envelope
    (heterogeneous PDU headroom)."""
    fleet = scenario.fleet
    base = (budget_w if budget_w is not None
            else fleet.n_provisioned * server.provisioned_w)
    fracs = fleet.row_budget_fracs
    if fracs is None:
        return [float(base)] * fleet.n_rows
    if len(fracs) != fleet.n_rows:
        raise ValueError(
            f"row_budget_fracs has {len(fracs)} entries for "
            f"{fleet.n_rows} rows")
    return [float(base) * float(f) for f in fracs]


def resolve_budget(scenario: Scenario, workloads, shares, server) -> Optional[float]:
    """The row budget in watts, or None for the nominal default
    (n_provisioned x server rating). ``budget="calibrated"`` runs the
    event-driven simulator, which is not ported yet, and raises."""
    if isinstance(scenario.budget, (int, float)):
        return float(scenario.budget)
    if scenario.budget == "nominal":
        return None
    if scenario.budget == "calibrated":
        raise NotImplementedError(
            f"scenario {scenario.name!r} uses budget='calibrated', which "
            "calibrates on the event-driven simulator (repro_torch.core."
            "simulator.RowSimulator): not ported to PyTorch yet; pass "
            "budget='nominal' or explicit watts")
    raise ValueError(f"unknown budget spec {scenario.budget!r}")
