"""Risk-constrained capacity planner (port of ``repro.provisioning.planner``).

POLCA §7: with the T1/T2 controller, the same row power envelope safely
hosts ~30% more inference servers. :func:`plan_capacity` turns that figure
into a *search*: it bisects over the number of added servers, evaluating
each candidate fleet with a Monte-Carlo ensemble of seeded traffic
realizations, and keeps the largest fleet whose ensemble satisfies the risk
constraints:

* ``max_brake_prob`` — bound on P[a traffic realization exceeds
  ``max_brakes`` hardware powerbrakes] (the paper plans for zero);
* ``max_slo_violation_prob`` — bound on P[a realization misses the Table-5
  latency SLOs] (percentile gates from ``core.slo``);
* ``slo_cvar_alpha`` / ``max_slo_cvar`` — the dense-tail CVaR gate on the
  per-member SLO impact.

SLO impacts are measured the way the paper measures them: each member diffs
per-request latencies against an uncapped reference run on the same trace
(``EnsembleSpec(with_reference=True)``; the batched engines' fluid proxy is
reference-free), so the gate isolates capping impact from queueing noise.
The budget is resolved once from the provisioned baseline and held fixed
across candidates and members: the question is "how far can THIS envelope
stretch". Every probe is recorded so the frontier is auditable, and with a
recorder installed (:mod:`repro_torch.obs.metrics`) each probe is a
``planner/probe`` span, event and counter. The survivability gate
(``RiskConstraints.survive``) runs the routed fleet under a fault timeline
and waits for the ports of the fleet and the chaos injector (the fault
timelines themselves are ported: ``Scenario.with_faults`` runs on both
batched engines).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.slo import DEFAULT_SLO, SLO
from repro_torch.device import resolve_device
from repro_torch.experiments.scenario import Scenario
from repro_torch.obs.metrics import get_recorder
from repro_torch.provisioning.montecarlo import (
    EnsembleResult,
    EnsembleSpec,
    resolve_ensemble_budget,
    run_ensemble,
)

_EPS = 1e-12


@dataclass(frozen=True)
class RiskConstraints:
    """What the planner is allowed to risk across traffic realizations.

    ``max_brakes`` is a per-horizon brake-count budget: a realization is
    brake-feasible while its powerbrake count stays <= ``max_brakes`` (0
    keeps the paper's zero-tolerance), and ``max_brake_prob`` bounds the
    probability of exceeding that budget.

    ``slo_cvar_alpha`` activates the dense-tail CVaR gate: each probe
    additionally requires CVaR_alpha over the per-member P``slo_cvar_q``
    SLO impact of ``slo_cvar_priority`` requests to stay <=
    ``max_slo_cvar``. It needs enough members for the ``(1 - alpha)`` tail
    to hold one full sample, so ``plan_capacity`` validates ``n_seeds >=
    ceil(1 / (1 - alpha))``.

    ``survive`` is the JAX package's survivability gate (a fault timeline
    every probe must ride through); it needs the routed fleet and the chaos
    injector, which are not ported yet, so it must stay None here."""

    max_brake_prob: float = 0.0  # P[member exceeds the brake budget]
    max_brakes: int = 0  # brakes tolerated per realization/horizon
    max_slo_violation_prob: float = 0.0  # P[member misses the SLO]
    slo: SLO = DEFAULT_SLO
    survive: Optional[Any] = None  # fault timeline: not ported yet
    slo_cvar_alpha: Optional[float] = None  # None: CVaR gate off
    max_slo_cvar: float = 0.0  # bound on CVaR_alpha[per-member Pq impact]
    slo_cvar_priority: str = "high"  # which priority class the gate watches
    slo_cvar_q: float = 99.0  # per-member tail percentile fed into CVaR


@dataclass
class PlanPoint:
    """One bisection probe: a candidate fleet and its ensemble verdict."""

    added_servers: int
    added_frac: float
    feasible: bool
    brake_prob: float
    slo_violation_prob: float
    peak_frac_max: float
    slo_cvar: Optional[float] = None  # CVaR gate value (slo_cvar_alpha set)
    ensemble: Optional[EnsembleResult] = field(default=None, repr=False)


@dataclass
class PlanResult:
    """Outcome of one capacity search."""

    scenario_name: str
    n_provisioned: int
    budget_w: float
    safe_added_servers: int
    probes: List[PlanPoint]
    capped: bool = False  # search hit max_added_frac while still feasible
    feasible_at_zero: bool = True

    @property
    def safe_added_frac(self) -> float:
        return self.safe_added_servers / self.n_provisioned

    @property
    def safe_n_servers(self) -> int:
        return self.n_provisioned + self.safe_added_servers

    def summary(self) -> Dict[str, float]:
        """The search verdict in one flat dict (benchmark rows)."""
        return {"safe_added_frac": self.safe_added_frac,
                "safe_n_servers": float(self.safe_n_servers),
                "budget_w": self.budget_w,
                "n_probes": float(len(self.probes))}


def _violation_prob(ens: EnsembleResult, slo: SLO) -> float:
    """P[member misses the SLO], powerbrakes excluded (they are constrained
    separately by ``max_brake_prob``). Delegates to the EnsembleResult so
    dense-tail results (``member_stats=False``, no per-member python
    objects) gate identically to member-object ones."""
    return ens.slo_violation_prob(slo)


def plan_capacity(base: Scenario, *,
                  constraints: RiskConstraints = RiskConstraints(),
                  n_seeds: int = 4, seed0: int = 1000,
                  max_added_frac: float = 0.60,
                  budget_w: Optional[float] = None,
                  n_workers: Optional[int] = None,
                  keep_ensembles: bool = False,
                  engine: str = "cuda", device=None,
                  **engine_opts) -> PlanResult:
    """Maximum deployable fleet for ``base``'s traffic family under
    ``constraints``.

    Bisects over integer added-server counts in ``[0, n_provisioned *
    max_added_frac]``; each probe runs an ``n_seeds``-member Monte-Carlo
    ensemble at a pinned budget (resolved from ``base`` once unless
    ``budget_w`` pins it externally). ``engine`` and ``device`` select the
    ensemble backend per :func:`~repro_torch.provisioning.montecarlo.
    run_ensemble` (``engine="torch"`` for predictive policies on the card;
    ``engine="numpy"``, asked for by name, the event-driven host engine,
    which takes ``n_workers`` and no device); ``engine_opts`` forward there
    (``member_chunk``, ``devices``, ...).
    """
    if constraints.survive is not None:
        raise ValueError(
            "RiskConstraints.survive needs the event-driven routed-fleet "
            "engine with the chaos injector (repro_torch.fleet): not ported "
            "to PyTorch yet, and the batched tick engines do not model it "
            f"(got engine={engine!r})")
    if engine != "numpy":
        device = resolve_device(device)
    n_prov = base.fleet.n_provisioned
    cvar_alpha = constraints.slo_cvar_alpha
    if cvar_alpha is not None:
        min_seeds = int(math.ceil(1.0 / (1.0 - cvar_alpha)))
        if n_seeds < min_seeds:
            raise ValueError(
                f"slo_cvar_alpha={cvar_alpha} needs n_seeds >= {min_seeds} "
                f"for the (1 - alpha) tail to hold a full member (got "
                f"n_seeds={n_seeds}); dense tails are what engine='cuda' "
                f"and engine='torch' are for")
    budget = resolve_ensemble_budget(base) if budget_w is None else float(budget_w)
    probes: List[PlanPoint] = []

    def probe(k: int) -> PlanPoint:
        sc = base.with_fleet(added_frac=k / n_prov).with_(budget=budget)
        rec = get_recorder()
        with rec.span("planner/probe", scenario=base.name, added=k):
            ens = run_ensemble(EnsembleSpec(sc, n_seeds=n_seeds, seed0=seed0,
                                            n_workers=n_workers,
                                            with_reference=True),
                               budget_w=budget, engine=engine, device=device,
                               **engine_opts)
            brake_p = ens.brake_prob(constraints.max_brakes)
            slo_p = _violation_prob(ens, constraints.slo)
            cvar: Optional[float] = None
            if cvar_alpha is not None:
                cvar = ens.slo_cvar(constraints.slo_cvar_priority,
                                    cvar_alpha, q=constraints.slo_cvar_q)
        pt = PlanPoint(
            added_servers=k, added_frac=k / n_prov,
            feasible=(brake_p <= constraints.max_brake_prob + _EPS
                      and slo_p <= constraints.max_slo_violation_prob + _EPS
                      and (cvar is None
                           or cvar <= constraints.max_slo_cvar + _EPS)),
            brake_prob=brake_p, slo_violation_prob=slo_p,
            peak_frac_max=float(ens.peak_fracs.max()) if len(ens.peak_fracs) else 0.0,
            slo_cvar=cvar, ensemble=ens if keep_ensembles else None)
        probes.append(pt)
        if rec.enabled:
            # probe outcome: logical time is the probe ordinal (the planner
            # has no simulation clock of its own)
            rec.event("planner", "probe", t=float(len(probes)),
                      scenario=base.name, added=k,
                      feasible=pt.feasible,
                      brake_prob=round(brake_p, 6),
                      slo_violation_prob=round(slo_p, 6))
            rec.counter("planner_probes_total",
                        outcome="feasible" if pt.feasible else "infeasible")
        return pt

    hi = max(1, int(math.floor(n_prov * max_added_frac)))
    top = probe(hi)
    if top.feasible:
        return PlanResult(base.name, n_prov, budget, hi, probes, capped=True)
    bottom = probe(0)
    if not bottom.feasible:
        return PlanResult(base.name, n_prov, budget, 0, probes,
                          feasible_at_zero=False)
    lo = 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if probe(mid).feasible:
            lo = mid
        else:
            hi = mid
    return PlanResult(base.name, n_prov, budget, lo, probes)


def plan_scenarios(bases: Sequence[Scenario], *,
                   constraints: RiskConstraints = RiskConstraints(),
                   n_seeds: int = 4, seed0: int = 1000,
                   max_added_frac: float = 0.60,
                   budget_w: Optional[float] = None,
                   n_workers: Optional[int] = None,
                   engine: str = "cuda", device=None,
                   **engine_opts) -> Dict[str, PlanResult]:
    """Per-scenario safe oversubscription ratios for a generator family, all
    planned against the same power envelope (resolved from the first base
    unless pinned): how far the envelope stretches under nominal, bursty,
    colocated, failover, incident and nighttime traffic. ``engine``,
    ``device`` and ``engine_opts`` forward to :func:`plan_capacity`."""
    if not bases:
        return {}
    budget = (resolve_ensemble_budget(bases[0]) if budget_w is None
              else float(budget_w))
    return {b.name: plan_capacity(b, constraints=constraints, n_seeds=n_seeds,
                                  seed0=seed0, max_added_frac=max_added_frac,
                                  budget_w=budget, n_workers=n_workers,
                                  engine=engine, device=device,
                                  **engine_opts)
            for b in bases}
