"""Back-compat shims over the experiments API (Fig 13 capacity planning;
port of ``repro.core.oversubscription``).

``evaluate(...)`` builds the equivalent ``Scenario`` and delegates to
``run_experiment``; ``threshold_search(...)`` does the same for the Fig-13
(T1, T2) sweep. Results are identical bit for bit to the declarative call
on the same seed. New code should construct a ``Scenario`` and call
``repro_torch.experiments.run_experiment`` directly.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.power_model import ServerPower
from repro_torch.core.simulator import SimConfig
from repro_torch.core.slo import DEFAULT_SLO, SLO
from repro_torch.experiments.runner import BASELINE_PEAK_UTIL  # noqa: F401 (re-export)
from repro_torch.experiments.runner import ExperimentResult
from repro_torch.experiments.runner import calibrated_budget  # noqa: F401 (re-export)
from repro_torch.experiments.runner import run_experiment
from repro_torch.experiments.runner import threshold_search as _threshold_search
from repro_torch.experiments.scenario import (
    FleetSpec,
    Scenario,
    TelemetryConfig,
    TrafficSpec,
)

# the old result type is the new one under its old name
EvalOutcome = ExperimentResult


def _scenario_from_args(name: str, n_provisioned: int, n_servers: int,
                        duration: float, *, seed: int, power_scale: float,
                        occ_peak: float, slo: SLO, sim_cfg: Optional[SimConfig],
                        provisioned_w: Optional[float]) -> Scenario:
    cfg = sim_cfg or SimConfig()
    return Scenario(
        name=name,
        duration_s=duration,
        fleet=FleetSpec(n_provisioned=n_provisioned,
                        added_frac=n_servers / n_provisioned - 1.0),
        traffic=TrafficSpec(occ_peak=occ_peak),
        telemetry=TelemetryConfig(telemetry_s=cfg.telemetry_s,
                                  oob_latency_s=cfg.oob_latency_s,
                                  brake_latency_s=cfg.brake_latency_s),
        slo=slo,
        power_scale=power_scale,
        seed=seed,
        budget="calibrated" if provisioned_w is None else float(provisioned_w),
    )


def evaluate(policy_factory: Callable, workloads, shares, server: ServerPower,
             n_provisioned: int, n_servers: int, duration: float,
             *, seed: int = 7, power_scale: float = 1.0, occ_peak: float = 0.62,
             slo: SLO = DEFAULT_SLO, sim_cfg: SimConfig = None,
             provisioned_w: float = None) -> EvalOutcome:
    """Legacy signature: runs a policy on a trace at N servers against the
    uncapped reference on the same trace. Delegates to ``run_experiment``."""
    sc = _scenario_from_args("legacy-evaluate", n_provisioned, n_servers, duration,
                             seed=seed, power_scale=power_scale, occ_peak=occ_peak,
                             slo=slo, sim_cfg=sim_cfg, provisioned_w=provisioned_w)
    return run_experiment(sc, workloads=(workloads, shares),
                          policy_factory=policy_factory, server=server)


def threshold_search(combos: List[Tuple[float, float]], workloads, shares, server,
                     n_provisioned: int, duration: float,
                     added_grid: List[float], **kw) -> Dict[Tuple[float, float], dict]:
    """Legacy signature for the Fig-13 (T1,T2) sweep."""
    sc = _scenario_from_args("legacy-threshold-search", n_provisioned,
                             n_provisioned, duration,
                             seed=kw.get("seed", 7),
                             power_scale=kw.get("power_scale", 1.0),
                             occ_peak=kw.get("occ_peak", 0.62),
                             slo=kw.get("slo", DEFAULT_SLO),
                             sim_cfg=kw.get("sim_cfg"),
                             provisioned_w=kw.get("provisioned_w"))
    return _threshold_search(sc, combos, added_grid,
                             workloads=(workloads, shares), server=server)
