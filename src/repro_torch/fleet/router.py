"""Pluggable fleet routing policies and priority-aware admission control
(port of ``repro.fleet.router``, copied in full).

A :class:`Router` picks the row each admitted request lands on, from a list
of :class:`RowView` snapshots (what a real cluster dispatcher observes: queue
depth of the request's server pool, row power against its budget, and the
controller's *commanded* cap state — the dispatcher and the rack manager
share a control plane, so cap commands are visible before they actuate
through the 40 s out-of-band path). An :class:`AdmissionController` decides
first whether the request runs at all: under a power emergency (cluster power
near the envelope, or any row powerbraked) low-priority work is shed instead
of queued, trading LP goodput for HP latency — the POLCA priority contract
applied at the fleet door rather than per-server. ``shed-lp`` sheds the
whole LP stream for the duration; ``shed-tokens`` meters the shedding to a
configured token relief rate (non-boolean shedding, same LP-first ordering).

Routers and admission controllers are registered by name so
:class:`~repro_torch.experiments.scenario.RoutingSpec` stays JSON-serializable:

  | router           | decision                                             |
  | round-robin      | next row, state-blind                                |
  | jsq              | fewest pending requests in the request's server pool |
  | power-headroom   | most watts of headroom against the row budget        |
  | cap-aware        | least cap-severe tier for the request's priority,    |
  |                  | join-shortest-queue within the tier                  |
  | forecast-aware   | cap-aware cost plus a graded penalty on rows whose   |
  |                  | forecast power crosses the budget over the 40 s OOB  |
  |                  | horizon (consumes the shared PowerForecaster)        |
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.simulator import Request


@dataclass(frozen=True)
class RowView:
    """One row's dispatcher-visible state at an arrival instant. Pool fields
    describe the request's candidate server pool (same candidate rule the row
    applies internally: workload class + priority, falling back to the whole
    class when the priority sub-pool is empty)."""

    index: int
    power_frac: float  # row power / row budget
    headroom_w: float  # row budget - row power (watts)
    braked: bool
    t1_capped: bool
    t2_capped: bool
    hp_capped: bool
    pool_size: int
    pool_idle: int  # idle servers in the pool
    pool_queued: int  # requests waiting in pool buffers
    # predicted row power / row budget over the 40 s OOB horizon, from the
    # fleet's shared PowerForecaster (one-tick-stale, like the group fracs);
    # None when no forecast consumer is configured
    forecast_frac: Optional[float] = None

    @property
    def pool_pending(self) -> int:
        """In-flight + buffered work the pool already owes."""
        return self.pool_queued + (self.pool_size - self.pool_idle)


@dataclass(frozen=True)
class FleetView:
    """Fleet-level state for admission decisions (cluster fraction is the
    one-tick-stale aggregate the rack managers publish)."""

    t: float = 0.0
    cluster_frac: float = 0.0
    n_braked: int = 0


class Router:
    """Protocol: ``route(req, views) -> (row_index, reason)``. ``reason`` is
    a short tag carried into the per-decision telemetry so SLO impact can be
    attributed to routing behavior (``fleet.metrics``). Routers that never
    read row state set ``needs_views = False`` and the fleet driver skips
    the per-arrival pool scans (it passes index-only placeholder views)."""

    name: str = "router"
    needs_views: bool = True
    # routers that read RowView.forecast_frac set this; the fleet driver
    # then maintains a shared PowerForecaster on the telemetry grid
    needs_forecast: bool = False

    def route(self, req: Request, views: List[RowView]) -> Tuple[int, str]:
        raise NotImplementedError


@dataclass
class RoundRobinRouter(Router):
    """State-blind baseline: rows in cyclic order."""

    name: str = "round-robin"
    needs_views: bool = False
    _next: int = 0

    def route(self, req: Request, views: List[RowView]) -> Tuple[int, str]:
        i = self._next % len(views)
        self._next += 1
        return views[i].index, "round-robin"


@dataclass
class JoinShortestQueueRouter(Router):
    """Fewest pending requests in the request's server pool; ties go to the
    lowest row index (deterministic)."""

    name: str = "jsq"

    def route(self, req: Request, views: List[RowView]) -> Tuple[int, str]:
        best = min(views, key=lambda v: (v.pool_pending, v.index))
        return best.index, "jsq"


@dataclass
class PowerHeadroomRouter(Router):
    """Most watts of slack against the row budget — spreads *power*, not
    queue depth, so hot rows shed load before they cross a cap threshold."""

    name: str = "power-headroom"

    def route(self, req: Request, views: List[RowView]) -> Tuple[int, str]:
        best = max(views, key=lambda v: (v.headroom_w, -v.index))
        return best.index, "power-headroom"


def _severity_tag(v: RowView, priority: str) -> str:
    if v.braked:
        return "braked"
    if v.hp_capped and priority == "high":
        return "hp-capped"
    if v.t2_capped:
        return "t2"
    if v.t1_capped:
        return "t1"
    return "uncapped"


@dataclass
class CapAwareRouter(Router):
    """Steer work away from frequency-capped and braked rows *proportionally
    to how much they would hurt*: each row is scored by its normalized pool
    load plus a cap-severity penalty for the request's priority, and the
    cheapest row wins. Braked rows carry a prohibitive penalty (288 MHz
    service is catastrophic — they are a last resort); T1/T2/HP caps carry
    graded penalties measured in pool-load units, so a capped row is still
    used once the uncapped rows queue deeper than the cap would cost. A
    strict avoid-capped-tiers preference instead collapses load onto the
    uncapped rows and oscillates their caps; the graded cost is what recovers
    the HP SLO under an oversubscribed, partially-capped cluster (the
    fleet_routing benchmark's headline)."""

    # penalties in units of pool load (pending work per pool server); the
    # defaults mirror how much each state actually slows service: a brake
    # (288 MHz) is ~5x slowdown — prohibitive — while T1/T2/HP frequency
    # caps cost <= ~10% and should only tip near-tie decisions (heavier
    # penalties over-divert, saturating the healthy rows' pools and costing
    # more in queueing than the caps cost in service speed)
    brake_penalty: float = 10.0
    hp_cap_penalty: float = 0.3  # HP work on an HP-capped row
    t2_penalty: float = 0.05
    t1_penalty: float = 0.02
    name: str = "cap-aware"

    def _cost(self, v: RowView, priority: str) -> float:
        load = v.pool_pending / max(1, v.pool_size)
        if v.braked:
            return load + self.brake_penalty
        pen = 0.0
        if v.hp_capped and priority == "high":
            pen = self.hp_cap_penalty
        elif v.t2_capped:
            pen = self.t2_penalty
        elif v.t1_capped:
            pen = self.t1_penalty
        return load + pen

    def route(self, req: Request, views: List[RowView]) -> Tuple[int, str]:
        best = min(views, key=lambda v: (self._cost(v, req.priority), v.index))
        return best.index, f"cap-aware/{_severity_tag(best, req.priority)}"


@dataclass
class ForecastAwareRouter(CapAwareRouter):
    """Cap-aware routing that also consumes the fleet's power *forecast*
    (ROADMAP item: routers that consume the predictive policy's power
    forecast). On top of the cap-severity cost, a row whose predicted power
    over the 40 s OOB horizon crosses ``forecast_threshold`` of its budget
    pays a penalty proportional to the predicted overshoot — load is steered
    away *before* the row's controller has to cap, which is 40 s earlier
    than the commanded-cap-state signal can react. The penalty is graded for
    the same reason the cap penalties are: a hard avoid-predicted-hot rule
    collapses load onto the cold rows and makes the forecast self-defeating.

    Pairs naturally with the predictive :class:`~repro_torch.fleet.controller.
    FleetController` (both read the same shared forecaster): the controller
    moves budget toward predicted demand while this router moves marginal
    demand away from predicted congestion."""

    # predicted crossings of T2 start costing; a predicted brake (>= 1.0 of
    # budget) costs forecast_penalty * (1 - threshold) ~ 1.1 pool-load units
    forecast_threshold: float = 0.89
    forecast_penalty: float = 10.0
    name: str = "forecast-aware"
    needs_forecast: bool = True

    def _cost(self, v: RowView, priority: str) -> float:
        cost = super()._cost(v, priority)
        if v.forecast_frac is not None and v.forecast_frac > self.forecast_threshold:
            cost += self.forecast_penalty * (v.forecast_frac
                                             - self.forecast_threshold)
        return cost

    def route(self, req: Request, views: List[RowView]) -> Tuple[int, str]:
        best = min(views, key=lambda v: (self._cost(v, req.priority), v.index))
        tag = _severity_tag(best, req.priority)
        if (tag == "uncapped" and best.forecast_frac is not None
                and best.forecast_frac > self.forecast_threshold):
            tag = "forecast-hot"
        return best.index, f"forecast-aware/{tag}"


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

class AdmissionController:
    """Protocol: ``admit(req, fleet_view) -> bool``. Shed requests never
    reach a row; the fleet driver counts them per priority (conservation:
    admitted + shed == offered, tier-1-asserted). ``needs_view = False``
    declares the controller admits unconditionally: the driver then skips
    both the per-arrival :class:`FleetView` scan and the ``admit`` call."""

    name: str = "admission"
    needs_view: bool = True

    def admit(self, req: Request, fleet: FleetView) -> bool:
        raise NotImplementedError


@dataclass
class AdmitAll(AdmissionController):
    name: str = "admit-all"
    needs_view: bool = False

    def admit(self, req: Request, fleet: FleetView) -> bool:
        return True


@dataclass
class ShedLowPriority(AdmissionController):
    """Priority-aware load shedding: during a power emergency — cluster power
    at/above ``shed_above`` of the envelope, or any row powerbraked — LP
    requests are dropped at the fleet door instead of adding load a capped
    cluster cannot serve. HP requests are always admitted."""

    shed_above: float = 0.97
    shed_when_braked: bool = True
    name: str = "shed-lp"

    def admit(self, req: Request, fleet: FleetView) -> bool:
        if req.priority == "high":
            return True
        emergency = (fleet.cluster_frac >= self.shed_above
                     or (self.shed_when_braked and fleet.n_braked > 0))
        return not emergency


@dataclass
class ShedTokenBudget(AdmissionController):
    """Token-budget shedding: meter *how much* work is shed instead of
    shedding everything low-priority (``shed-lp``'s boolean contract).

    While a power emergency holds — same trigger as ``shed-lp``: cluster
    power at/above ``shed_above`` of the envelope, or any row powerbraked —
    the controller accrues a token *debt* at ``relief_tokens_per_s`` (plus a
    ``burst_tokens`` down payment when the emergency window opens, so relief
    starts immediately) and sheds arriving requests while the debt is
    positive, debiting each shed request's ``out_tokens`` — overshoot banks
    as signed credit, so one large shed buys admission for the arrivals
    after it. Load beyond the configured relief rate is admitted even
    mid-emergency — the non-boolean upgrade: the shed stream tracks
    ``relief_tokens_per_s`` instead of swallowing the whole LP stream.
    Ordering is shared with ``shed-lp``: LP is shed
    first and HP is never shed (the POLCA priority contract); the debt is
    capped at ``max_debt_tokens`` so a long emergency cannot bank unbounded
    shedding against the recovery, and it resets the moment the emergency
    clears."""

    shed_above: float = 0.97
    shed_when_braked: bool = True
    relief_tokens_per_s: float = 1500.0  # shed rate the emergency demands
    burst_tokens: float = 4000.0  # immediate relief when the window opens
    max_debt_tokens: float = 20000.0
    name: str = "shed-tokens"
    _debt: float = field(default=0.0, repr=False)
    _last_t: Optional[float] = field(default=None, repr=False)

    def admit(self, req: Request, fleet: FleetView) -> bool:
        emergency = (fleet.cluster_frac >= self.shed_above
                     or (self.shed_when_braked and fleet.n_braked > 0))
        if emergency:
            if self._last_t is None:  # window opens: immediate down payment
                self._debt = min(self.max_debt_tokens, self._debt
                                 + self.burst_tokens)
            else:
                self._debt = min(self.max_debt_tokens, self._debt
                                 + (fleet.t - self._last_t)
                                 * self.relief_tokens_per_s)
            self._last_t = fleet.t
        else:
            self._debt = 0.0
            self._last_t = None
        if req.priority == "high":
            return True  # LP-first, and LP always covers: HP is never shed
        if emergency and self._debt > 0.0:
            self._debt -= float(req.out_tokens)  # overshoot banks as credit
            return False
        return True


# ---------------------------------------------------------------------------
# registries (RoutingSpec round-trips through these by name)
# ---------------------------------------------------------------------------

ROUTER_BUILDERS: Dict[str, Callable[..., Router]] = {
    "round-robin": RoundRobinRouter,
    "jsq": JoinShortestQueueRouter,
    "power-headroom": PowerHeadroomRouter,
    "cap-aware": CapAwareRouter,
    "forecast-aware": ForecastAwareRouter,
}

ADMISSION_BUILDERS: Dict[str, Callable[..., AdmissionController]] = {
    "admit-all": AdmitAll,
    "shed-lp": ShedLowPriority,
    "shed-tokens": ShedTokenBudget,
}


def build_router(kind: str, params: Dict[str, Any] = None) -> Router:
    try:
        builder = ROUTER_BUILDERS[kind]
    except KeyError:
        known = ", ".join(sorted(ROUTER_BUILDERS))
        raise KeyError(f"unknown router {kind!r}; registered: {known}") from None
    return builder(**(params or {}))


def build_admission(kind: str, params: Dict[str, Any] = None) -> AdmissionController:
    try:
        builder = ADMISSION_BUILDERS[kind]
    except KeyError:
        known = ", ".join(sorted(ADMISSION_BUILDERS))
        raise KeyError(
            f"unknown admission controller {kind!r}; registered: {known}") from None
    return builder(**(params or {}))
