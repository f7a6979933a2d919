"""Monte-Carlo ensembles of one scenario (port of ``repro.provisioning.montecarlo``).

An :class:`EnsembleSpec` names N seeded traffic realizations of a base
scenario. ``run_ensemble`` evaluates them in one batched pass on a tick
engine of :mod:`repro_torch.provisioning.batched` (``engine="cuda"``, whose
tick loop is the hand-written CUDA kernel in ``kernels/csrc/tick.cu``, or
``engine="torch"``, the scan engine that also runs predictive policies) and
returns an :class:`EnsembleResult`: powerbrake-count CDFs and CVaR,
peak-power exceedance, pooled SLO percentiles — every statistic a
vectorized reduction over per-member arrays. ``run_ensemble_grid``
evaluates N seeds x M scenarios, one lane tensor per geometry bucket on
the torch engine.

The row power budget is resolved **once** from the base scenario and pinned
across every member: Monte-Carlo asks how one fixed infrastructure design
behaves under traffic uncertainty.

The event-driven fork-pool engine (``engine="numpy"`` in the JAX package)
waits for the port of the event-driven simulator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.simulator import SimResult
from repro_torch.core.slo import DEFAULT_SLO, SLO, LatencyStats, meets_slo
from repro_torch.experiments.runner import build_workloads, resolve_budget
from repro_torch.experiments.scenario import Scenario

import repro_torch.provisioning.ensembles  # noqa: F401  (registers trace generators)


@dataclass(frozen=True)
class EnsembleSpec:
    """N seeded members of one base scenario.

    ``seed0 + k`` seeds member ``k``'s traffic realization.
    ``with_reference=True`` marks members for the paper's paired uncapped
    reference comparison (the planner sets it); the tick engine's fluid SLO
    proxy is reference-free, so it only changes the member scenarios. The
    event-driven engine's ``n_workers``/``lockstep_stride_s`` come with its
    port.
    """

    base: Scenario
    n_seeds: int = 8
    seed0: int = 1000
    with_reference: bool = False

    def seeds(self) -> List[int]:
        """The member seeds, in member order: ``seed0 + k`` for member k."""
        return [self.seed0 + k for k in range(self.n_seeds)]

    def member_scenarios(self, budget_w: Optional[float] = None) -> List[Scenario]:
        """The concrete per-member scenarios: pinned explicit budget, one
        seed each."""
        budget = self.base.budget if budget_w is None else float(budget_w)
        return [self.base.with_(name=f"{self.base.name}@s{s}", seed=s,
                                budget=budget,
                                compare_to_reference=self.with_reference)
                for s in self.seeds()]


@dataclass
class MemberStats:
    """One ensemble member: its scenario, its SimResult, and the SLO-impact
    stats."""

    scenario: Scenario
    result: SimResult
    stats: LatencyStats

    @property
    def meets(self) -> bool:
        """Whether this member meets its scenario's SLO (brakes included)."""
        return meets_slo(self.stats, self.result.n_brakes, self.scenario.slo)


@dataclass
class EnsembleResult:
    """Distributional telemetry over one ensemble (vectorized accounting)."""

    base_name: str
    budget_w: float
    members: List[MemberStats]
    power_t: np.ndarray = field(repr=False)  # [T] telemetry grid
    power_frac: np.ndarray = field(repr=False)  # [N, T] of row budget
    brake_counts: np.ndarray = field(repr=False)  # [N]
    peak_fracs: np.ndarray = field(repr=False)  # [N]
    mean_fracs: np.ndarray = field(repr=False)  # [N]
    # dense-tail mode (``member_stats=False``): ``members`` stays empty and
    # per-member SLO impact samples ride as [N, K] arrays — the statistics
    # below fall back to vectorized paths over these, so a 10^5-member
    # result carries no per-member python objects
    member_impacts_hp: Optional[np.ndarray] = field(default=None, repr=False)
    member_impacts_lp: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def n_members(self) -> int:
        if self.members:
            return len(self.members)
        return int(len(self.brake_counts))

    def _dense_impacts(self, priority: str) -> Optional[np.ndarray]:
        """[N, K] impact samples in dense-tail mode, else None."""
        if self.members:
            return None
        return (self.member_impacts_hp if priority == "high"
                else self.member_impacts_lp)

    def _member_percentiles(self, priority: str, q: float) -> np.ndarray:
        """Per-member q-th percentile impact, [N] — member-object path and
        dense path produce bit-identical values (same np.percentile on the
        same samples; empty members are 0.0 like LatencyStats)."""
        dense = self._dense_impacts(priority)
        if dense is not None:
            if dense.shape[1] == 0:
                return np.zeros(dense.shape[0])
            return np.percentile(dense, q, axis=1)
        key = "hp_impacts" if priority == "high" else "lp_impacts"
        return np.asarray([
            float(np.percentile(np.asarray(getattr(m.stats, key)), q))
            if len(getattr(m.stats, key)) else 0.0
            for m in self.members])

    # -- powerbrake distribution -------------------------------------------
    def brake_prob(self, max_brakes: int = 0) -> float:
        """P[a member experiences more than ``max_brakes`` powerbrakes].
        The default (0) is the zero-tolerance P[>= 1 brake]; the planner
        passes its ``RiskConstraints.max_brakes`` budget here."""
        return float(np.mean(self.brake_counts > max_brakes))

    def brake_cdf(self) -> Tuple[np.ndarray, np.ndarray]:
        """(counts, P[brakes <= count]) — the powerbrake-count CDF."""
        counts = np.sort(self.brake_counts)
        return counts, np.arange(1, len(counts) + 1) / len(counts)

    def brake_cvar(self, alpha: float) -> float:
        """CVaR_alpha of the per-member powerbrake count: the expected count
        over the worst ``(1 - alpha)`` fraction of members.  Fractional tail
        mass is interpolated so the estimator is continuous in alpha."""
        return _cvar(np.asarray(self.brake_counts, float), alpha)

    def slo_cvar(self, priority: str, alpha: float, q: float = 99.0) -> float:
        """CVaR_alpha over the per-member P``q`` SLO impact of ``priority``.
        Each member contributes one tail statistic (its own q-th percentile
        impact); CVaR then averages the worst ``(1 - alpha)`` of those —
        the dense-tail gate behind ``RiskConstraints.slo_cvar_alpha``."""
        return _cvar(np.asarray(self._member_percentiles(priority, q),
                                float), alpha)

    # -- power distribution -------------------------------------------------
    def peak_exceedance(self, levels: Sequence[float]) -> np.ndarray:
        """P[member peak power > level] per level (fractions of budget)."""
        lv = np.asarray(levels, float)
        return (self.peak_fracs[None, :] > lv[:, None]).mean(axis=1)

    def power_exceedance(self, levels: Sequence[float]) -> np.ndarray:
        """Time-pooled P[instantaneous row power > level] over all members."""
        lv = np.asarray(levels, float)
        if self.power_frac.size == 0:
            return np.zeros_like(lv)
        # sort once + searchsorted per level: O(NT log NT), no [L, NT] matrix
        flat = np.sort(self.power_frac, axis=None)
        return 1.0 - np.searchsorted(flat, lv, side="right") / flat.size

    # -- SLO distribution ---------------------------------------------------
    def slo_impacts(self, priority: str) -> np.ndarray:
        """All per-request latency impacts of ``priority``, pooled."""
        dense = self._dense_impacts(priority)
        if dense is not None:
            return dense.ravel() if dense.size else np.zeros(0)
        key = "hp_impacts" if priority == "high" else "lp_impacts"
        xs = [getattr(m.stats, key) for m in self.members]
        return np.concatenate([np.asarray(x) for x in xs]) if any(
            len(x) for x in xs) else np.zeros(0)

    def slo_percentile(self, priority: str, q: float) -> float:
        xs = self.slo_impacts(priority)
        return float(np.percentile(xs, q)) if len(xs) else 0.0

    def _meets_mask(self, slo: SLO, include_brakes: bool) -> np.ndarray:
        """[N] bool per-member SLO gate, vectorized over both storage modes
        (same strict-< percentile comparisons as :func:`core.slo.meets_slo`)."""
        ok = ((self._member_percentiles("high", 50) < slo.hp_p50)
              & (self._member_percentiles("high", 99) < slo.hp_p99)
              & (self._member_percentiles("low", 50) < slo.lp_p50)
              & (self._member_percentiles("low", 99) < slo.lp_p99))
        if include_brakes:
            ok = ok & (np.asarray(self.brake_counts) <= slo.max_powerbrakes)
        return ok

    def meets_fraction(self, slo: Optional[SLO] = None) -> float:
        """Fraction of members meeting the SLO (per-member gate). ``slo=None``
        uses each member's own scenario SLO (dense-tail results, which carry
        no scenarios, fall back to :data:`~repro_torch.core.slo.DEFAULT_SLO`)."""
        if self.members:
            if slo is None:
                return float(np.mean([m.meets for m in self.members]))
            return float(np.mean([
                meets_slo(m.stats, m.result.n_brakes, slo)
                for m in self.members]))
        if self.n_members == 0:
            return float("nan")
        return float(np.mean(self._meets_mask(slo or DEFAULT_SLO, True)))

    def slo_violation_prob(self, slo: Optional[SLO] = None) -> float:
        """P[member misses the SLO], powerbrakes *excluded* (the planner
        constrains those separately via ``max_brake_prob``). Works in both
        member-object and dense-tail modes."""
        if self.n_members == 0:
            return 0.0
        return float(1.0 - np.mean(self._meets_mask(slo or DEFAULT_SLO,
                                                    False)))

    def summary(self) -> Dict[str, float]:
        """Headline distributional stats in one flat dict (benchmark rows)."""
        return {
            "n_members": float(self.n_members),
            "brake_prob": self.brake_prob(),
            "meets_frac": self.meets_fraction(),
            "peak_p50": float(np.median(self.peak_fracs)),
            "peak_max": float(self.peak_fracs.max()) if len(self.peak_fracs) else 0.0,
            "hp_p99": self.slo_percentile("high", 99),
            "lp_p99": self.slo_percentile("low", 99),
        }


def _cvar(xs: np.ndarray, alpha: float) -> float:
    """Interpolated upper-tail CVaR: mean of the worst ``(1 - alpha)``
    probability mass of ``xs``.  ``alpha=0`` degenerates to the plain mean,
    ``alpha -> 1`` to the sample maximum."""
    if not 0.0 <= alpha < 1.0:
        raise ValueError(f"alpha must be in [0, 1), got {alpha}")
    n = xs.size
    if n == 0:
        return 0.0
    ordered = np.sort(xs)[::-1]  # descending: worst first
    mass = (1.0 - alpha) * n  # tail size in member units, may be fractional
    if mass <= 1.0:
        return float(ordered[0])
    whole = int(math.floor(mass))
    total = float(ordered[:whole].sum())
    if whole < n and mass > whole:
        total += (mass - whole) * float(ordered[whole])
    return total / mass


_WLS_CACHE: Dict[tuple, tuple] = {}


def _cached_workloads(scenario: Scenario):
    key = (scenario.fleet.model, scenario.fleet.device,
           scenario.fleet.n_devices_per_server,
           scenario.traffic.priority_mix_override)
    if key not in _WLS_CACHE:
        _WLS_CACHE[key] = build_workloads(scenario)
    return _WLS_CACHE[key]


def resolve_ensemble_budget(base: Scenario) -> float:
    """The pinned row budget (watts) shared by every ensemble member."""
    wls, shares = _cached_workloads(base)
    server = base.fleet.server()
    budget = resolve_budget(base, wls, shares, server)
    if budget is None:  # "nominal": pin the explicit equivalent
        budget = base.fleet.n_provisioned * server.provisioned_w
    return float(budget)


def run_ensemble(spec: EnsembleSpec, *, budget_w: Optional[float] = None,
                 engine: str = "cuda", device=None,
                 **engine_opts) -> EnsembleResult:
    """Evaluate all members of ``spec`` in one batched pass.

    ``engine="cuda"`` is the tick engine whose inner loop is the hand-written
    CUDA kernel (the counterpart of the JAX package's ``"pallas"``,
    non-predictive policies); ``engine="torch"`` the scan engine (the
    counterpart of ``"jax"``). Both run on ``device`` (default: the CUDA
    card; raises when there is none unless ``device="cpu"`` is passed, which
    takes the kernel's plain PyTorch version or runs the scan engine on the
    CPU). ``engine_opts`` forward to
    :func:`~repro_torch.provisioning.batched.run_batched_ensemble`
    (``keep_series``, ``keep_brake_fire``, ``member_stats``, and for the
    torch engine ``member_chunk`` and ``devices``).
    """
    from repro_torch.provisioning.batched import run_batched_ensemble
    return run_batched_ensemble(spec, budget_w=budget_w, engine=engine,
                                device=device, **engine_opts)


def run_ensemble_grid(bases: Sequence[Scenario], *, n_seeds: int = 8,
                      seed0: int = 1000, budget_w: Optional[float] = None,
                      engine: str = "torch", device=None,
                      **engine_opts) -> Dict[str, EnsembleResult]:
    """N seeds x M scenarios in one batched pass, one
    :class:`EnsembleResult` per base scenario, keyed by its name.

    Dispatches to :func:`~repro_torch.provisioning.batched.run_batched_grid`:
    ``engine="torch"`` buckets the scenarios by tick geometry and runs each
    bucket as one lane tensor; ``engine="cuda"`` runs one kernel launch per
    scenario. ``engine_opts`` forward there (``member_chunk``, ``devices``,
    ``member_stats``, ...)."""
    from repro_torch.provisioning.batched import run_batched_grid
    specs = [EnsembleSpec(b, n_seeds=n_seeds, seed0=seed0) for b in bases]
    results = run_batched_grid(specs, budget_w=budget_w, engine=engine,
                               device=device, **engine_opts)
    return {s.base.name: r for s, r in zip(specs, results)}
