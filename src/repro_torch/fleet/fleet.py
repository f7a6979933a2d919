"""Request-level fleet serving: one arrival process, M rows, a router (port
of ``repro.fleet.fleet``, copied in full: plain Python and numpy, the same
float operations and heap order, so its results equal the JAX package's bit
for bit).

The provisioning layer answers "how many servers fit the envelope"; this
layer answers "how does traffic *land* on those rows once some of them are
frequency-capped". :class:`FleetSimulator` drives M
:class:`~repro_torch.core.simulator.RowSimulator`\\ s from a single cluster-wide
arrival stream (seeded through the same ``core.traces`` generator registry
the per-row path uses): each arrival is first passed through an admission
controller (LP shedding under power emergencies), then placed on a row by a
pluggable :class:`~repro_torch.fleet.router.Router`, and injected into that row's
event queue via ``RowSimulator.inject``. Rows keep their own policies,
budgets, and event queues; the fleet driver interleaves arrival dispatch
with the telemetry-grid lockstep the ClusterSimulator established, publishing
one-tick-stale rack/cluster power fractions into every row before each tick.

Drive modes mirror ``RowSimulator``: ``run()`` is ``start`` +
``advance_to(duration)`` + ``finalize``, and ``advance_to`` is
stride-invariant, so the Monte-Carlo engine locksteps fleet members exactly
like row members. A single-row fleet under any router replays the standalone
``RowSimulator`` bit-for-bit on the same scenario (the cluster-wide trace
degenerates to the row trace, and injected arrivals reproduce the trace-fed
event order — tier-1-asserted).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.chaos.injector import ChaosInjector, FaultRecord
from repro_torch.core.hierarchy import PowerHierarchy
from repro_torch.core.simulator import Request, RowSimulator, SimConfig, SimResult
from repro_torch.core.slo import LatencyStats
# row_budgets lives with the other budget-resolution rules in the
# experiments layer; re-exported here because fleet callers reach for it
# next to build_fleet
from repro_torch.experiments.runner import row_budgets  # noqa: F401
from repro_torch.fleet.controller import FleetController, PowerForecaster, RebalanceEvent
from repro_torch.obs.alerts import AlertEngine, AlertEvent, AlertSpec, coerce_alerts
from repro_torch.obs.metrics import get_recorder
from repro_torch.fleet.router import (
    AdmissionController,
    AdmitAll,
    FleetView,
    Router,
    RowView,
)


@dataclass(frozen=True)
class RoutingDecision:
    """One dispatch: which row got the request (``row == -1`` means shed) and
    the router's reason tag. This is the join key for per-decision SLO and
    queueing-delay attribution (``fleet.metrics``)."""

    rid: int
    t: float
    wl: int
    priority: str
    row: int
    reason: str


@dataclass
class FleetResult:
    """Structured fleet telemetry: per-row results, the full decision log,
    shed accounting, and cluster-level power series on the telemetry grid."""

    row_results: List[SimResult]
    decisions: List[RoutingDecision] = field(repr=False)
    n_offered: int = 0
    n_admitted: int = 0
    n_shed: Dict[str, int] = field(default_factory=dict)  # per priority
    power_t: np.ndarray = field(default=None, repr=False)  # [T]
    row_power_frac: np.ndarray = field(default=None, repr=False)  # [T, R]
    rack_power_frac: np.ndarray = field(default=None, repr=False)  # [T, K]
    cluster_power_frac: np.ndarray = field(default=None, repr=False)  # [T]
    shed_cum: np.ndarray = field(default=None, repr=False)  # [T] total shed
    n_brakes: int = 0
    peak_cluster_frac: float = 0.0
    mean_cluster_frac: float = 0.0
    # dynamic rebalancing telemetry (empty without a FleetController): the
    # per-tick row budgets the row fractions were measured against, and the
    # applied rebalance events (fleet.controller.RebalanceEvent)
    row_budget_w: np.ndarray = field(default=None, repr=False)  # [T, R]
    rebalances: List[RebalanceEvent] = field(default_factory=list, repr=False)
    # full budget-tree telemetry (leaves first, root last; see
    # core.hierarchy.PowerHierarchy): per-node power fractions and the
    # per-tick node budgets they were measured against. rack_power_frac /
    # cluster_power_frac above are the leaf-parent / root slices of this.
    node_power_frac: np.ndarray = field(default=None, repr=False)  # [T, N]
    node_budget_w: np.ndarray = field(default=None, repr=False)  # [T, N]
    node_names: tuple = ()
    # chaos-engine audit (empty without an injector): every applied fault
    # phase with full before/after node budgets (chaos.injector.FaultRecord),
    # and the per-tick row-liveness mask crashes/revivals toggled
    fault_events: List[FaultRecord] = field(default_factory=list, repr=False)
    row_alive: np.ndarray = field(default=None, repr=False)  # [T, R] bool
    # online alerting audit (empty without Scenario.alerts): every
    # engage/release transition the AlertEngine fired on the tick lockstep
    # (obs.alerts.AlertEvent) — write-only, so carrying alerts never
    # changes any other field (tier-1-asserted)
    alert_events: List[AlertEvent] = field(default_factory=list, repr=False)

    @property
    def n_rebalances(self) -> int:
        return len(self.rebalances)

    @property
    def n_fault_events(self) -> int:
        return len(self.fault_events)

    @property
    def n_alert_events(self) -> int:
        return len(self.alert_events)

    def alerts_of(self, phase: Optional[str] = None,
                  kind: Optional[str] = None) -> List[AlertEvent]:
        return [a for a in self.alert_events
                if (phase is None or a.phase == phase)
                and (kind is None or a.kind == kind)]

    def budget_moved_w(self) -> float:
        """Total watts of budget the controller moved over the run."""
        return float(sum(ev.moved_w() for ev in self.rebalances))

    @property
    def n_rows(self) -> int:
        return len(self.row_results)

    @property
    def n_shed_total(self) -> int:
        return sum(self.n_shed.values())

    def merged_latencies(self) -> Dict[int, float]:
        """rid -> latency across all rows (rids are unique cluster-wide: the
        fleet serves one arrival stream)."""
        out: Dict[int, float] = {}
        for rr in self.row_results:
            out.update(rr.latencies)
        return out

    def merged_queue_delays(self) -> Dict[int, float]:
        out: Dict[int, float] = {}
        for rr in self.row_results:
            out.update(rr.queue_delays)
        return out


def as_sim_result(fres: FleetResult) -> SimResult:
    """Collapse a fleet run into the row-shaped ``SimResult`` the ensemble
    engine and SLO gates consume: pooled latencies, summed counters, and the
    cluster-level power series (fractions of the cluster budget)."""
    lat = LatencyStats(
        hp_impacts=[x for rr in fres.row_results for x in rr.latency.hp_impacts],
        lp_impacts=[x for rr in fres.row_results for x in rr.latency.lp_impacts])
    # fleet-level brake state: any row braked at that sample (rows share the
    # telemetry grid, but a revived row can have a ragged tail — skip then)
    braked = [rr.braked_series for rr in fres.row_results]
    if braked and all(b is not None and len(b) == len(braked[0])
                      for b in braked):
        braked_series = np.any(np.stack(braked), axis=0)
    else:
        braked_series = None
    return SimResult(
        latency=lat,
        n_brakes=fres.n_brakes,
        n_dropped=sum(rr.n_dropped for rr in fres.row_results) + fres.n_shed_total,
        n_completed=sum(rr.n_completed for rr in fres.row_results),
        served_tokens=sum(rr.served_tokens for rr in fres.row_results),
        peak_power_frac=fres.peak_cluster_frac,
        mean_power_frac=fres.mean_cluster_frac,
        power_t=fres.power_t,
        power_w=fres.cluster_power_frac,
        braked_series=braked_series,
        latencies=fres.merged_latencies(),
        cap_events=sum(rr.cap_events for rr in fres.row_results),
        queue_delays=fres.merged_queue_delays(),
    )


class FleetSimulator:
    """Dispatch one cluster-wide arrival stream over M rows.

    ``rows`` must be constructed with empty request lists (arrivals come from
    the dispatcher); ``requests`` must be sorted by arrival time (the trace
    generators emit them sorted). Budgets above the row default to the sum of
    their children's budgets, exactly like :class:`ClusterSimulator`; pass an
    explicit ``hierarchy`` (:class:`~repro_torch.core.hierarchy.PowerHierarchy`)
    for arbitrary-depth site topologies — the default is the classic
    two-level row -> rack -> cluster split.
    """

    def __init__(self, rows: List[RowSimulator], requests: List[Request],
                 router: Router, admission: Optional[AdmissionController] = None,
                 *, rows_per_rack: int = 2,
                 rack_budget_w: Optional[List[float]] = None,
                 cluster_budget_w: Optional[float] = None,
                 telemetry_s: Optional[float] = None,
                 controller: Optional[FleetController] = None,
                 hierarchy: Optional[PowerHierarchy] = None,
                 chaos: Optional[ChaosInjector] = None,
                 alerts: Optional[List[AlertSpec]] = None):
        if not rows:
            raise ValueError("FleetSimulator needs at least one row")
        from repro_torch.experiments.cluster import resolve_row_hierarchy
        self.rows = rows
        self.requests = requests
        self.router = router
        self.admission = admission if admission is not None else AdmitAll()
        self.hierarchy = resolve_row_hierarchy(
            rows, hierarchy, rows_per_rack=rows_per_rack,
            rack_budget_w=rack_budget_w, cluster_budget_w=cluster_budget_w)
        self.telemetry_s = float(telemetry_s or rows[0].cfg.telemetry_s)
        self.duration = max(r.duration for r in rows)
        self.controller = controller
        if controller is not None:
            controller.bind(self.hierarchy)
        # one shared forecaster feeds both the predictive controller and
        # forecast-consuming routers; None when nothing reads forecasts, so
        # controller-less fleets skip the per-tick estimator entirely
        need_fc = (getattr(router, "needs_forecast", False)
                   or (controller is not None and controller.needs_forecast))
        self._forecaster = (PowerForecaster(len(rows),
                                            horizon_s=rows[0].cfg.oob_latency_s)
                            if need_fc else None)
        self._forecast_frac: Optional[np.ndarray] = None  # [R], one-tick-stale

        # chaos engine: the injector rides the tick lockstep (polled after
        # the controller's pass) and toggles row_alive on crash/revive. The
        # mask gates *dispatch only*: dead rows drain their in-flight work
        # and keep reporting telemetry (a crashed row still draws power
        # until it winds down).
        self.row_alive = np.ones(len(rows), dtype=bool)
        self._any_dead = False
        self._alive_samples: List[np.ndarray] = []
        self.chaos = chaos
        if chaos is not None:
            chaos.bind(self)  # validates the timeline before anything runs

        # online alerting: the engine evaluates its rule set against each
        # tick's already-sampled telemetry, after the chaos poll. Strictly
        # write-only (events out, nothing read back into control flow), so
        # an alerted fleet replays an unalerted one bit for bit.
        specs = coerce_alerts(alerts)
        self.alert_engine = (
            AlertEngine(specs, tick_s=self.telemetry_s,
                        horizon_s=rows[0].cfg.oob_latency_s)
            if specs else None)
        if self.alert_engine is not None:
            self.alert_engine.bind(self)  # validates node targets up front

        self.decisions: List[RoutingDecision] = []
        self.n_shed: Dict[str, int] = {"high": 0, "low": 0}
        self._started = False
        self._i = 0  # next undispatched request
        self._next_tick = self.telemetry_s
        self._prev_row_w: Optional[np.ndarray] = None
        self._stale_cluster_frac = 0.0
        self._ticks: List[float] = []
        self._samples: List[np.ndarray] = []
        self._budget_samples: List[np.ndarray] = []
        self._interior_budget_samples: List[np.ndarray] = []
        self._shed_cum: List[int] = []
        # index-only placeholder views for routers with needs_views=False
        self._blind_views = [
            RowView(index=i, power_frac=0.0, headroom_w=0.0, braked=False,
                    t1_capped=False, t2_capped=False, hp_capped=False,
                    pool_size=1, pool_idle=1, pool_queued=0)
            for i in range(len(rows))]

    # ------------------------------------------------------------------
    def _advance_rows(self, t: float):
        # no alive-gating: a drained row returns immediately, and inject()
        # can revive one inside the final partial telemetry window
        for r in self.rows:
            r.advance_to(min(t, r.duration))

    def _publish_group_fracs(self, row_w: np.ndarray):
        frac = self.hierarchy.publish(self.rows, row_w)
        self._stale_cluster_frac = float(frac[self.hierarchy.root])

    def _view(self, i: int, req: Request) -> RowView:
        row = self.rows[i]
        cands = row.candidates(req.wl, req.priority)
        pol = row.policy
        return RowView(
            index=i,
            power_frac=row.row_power / row.provisioned_w,
            headroom_w=row.provisioned_w - row.row_power,
            braked=bool(getattr(pol, "braked", False)),
            t1_capped=bool(getattr(pol, "t1_capped", False)),
            t2_capped=bool(getattr(pol, "t2_capped", False)),
            hp_capped=bool(getattr(pol, "hp_capped", False)),
            pool_size=len(cands),
            pool_idle=sum(1 for s in cands if s.state == "idle"),
            pool_queued=sum(len(s.queue) for s in cands),
            forecast_frac=(float(self._forecast_frac[i])
                           if self._forecast_frac is not None else None),
        )

    def _fleet_view(self, t: float) -> FleetView:
        n_braked = sum(1 for r in self.rows
                       if getattr(r.policy, "braked", False))
        return FleetView(t=t, cluster_frac=self._stale_cluster_frac,
                         n_braked=n_braked)

    @property
    def n_processed(self) -> int:
        """Arrivals the dispatcher has consumed so far (dispatched or
        shed) — the alert engine's offered-traffic denominator."""
        return self._i

    def set_row_alive(self, i: int, alive: bool) -> None:
        """Fence (or unfence) row ``i`` from dispatch — the chaos engine's
        crash/revive primitive. Idempotent; budgets are untouched."""
        self.row_alive[int(i)] = bool(alive)
        self._any_dead = not bool(self.row_alive.all())

    def _dispatch(self, req: Request):
        # rows are current as of req.t_arrival (the driver advances them to
        # the arrival instant before routing)
        if self.admission.needs_view and not self.admission.admit(
                req, self._fleet_view(req.t_arrival)):
            self.n_shed[req.priority] = self.n_shed.get(req.priority, 0) + 1
            self.decisions.append(RoutingDecision(
                req.rid, req.t_arrival, req.wl, req.priority, -1,
                f"shed/{self.admission.name}"))
            get_recorder().counter("fleet_shed_total",
                                   reason=f"shed/{self.admission.name}",
                                   priority=req.priority)
            return
        if self._any_dead:
            # crashed rows are invisible to the router; with none left the
            # arrival is shed (counted, so admitted + shed == offered holds
            # through any outage)
            alive = [i for i in range(len(self.rows)) if self.row_alive[i]]
            if not alive:
                self.n_shed[req.priority] = self.n_shed.get(req.priority, 0) + 1
                self.decisions.append(RoutingDecision(
                    req.rid, req.t_arrival, req.wl, req.priority, -1,
                    "shed/row-crash"))
                get_recorder().counter("fleet_shed_total",
                                       reason="shed/row-crash",
                                       priority=req.priority)
                return
            views = ([self._view(i, req) for i in alive]
                     if self.router.needs_views
                     else [self._blind_views[i] for i in alive])
        else:
            # state-blind routers skip the per-pool snapshot scans entirely
            views = ([self._view(i, req) for i in range(len(self.rows))]
                     if self.router.needs_views else self._blind_views)
        row, reason = self.router.route(req, views)
        self.decisions.append(RoutingDecision(
            req.rid, req.t_arrival, req.wl, req.priority, row, reason))
        get_recorder().counter_k("fleet_dispatch_total", 1.0,
                                 (("reason", reason), ("row", str(row))))
        self.rows[row].inject(req)

    # ------------------------------------------------------------------
    def start(self):
        """Seed every row's event queue (idempotent). Part of the
        ``start`` / ``advance_to`` / ``finalize`` drive protocol the
        Monte-Carlo engine locksteps; ``run()`` composes all three."""
        if self._started:
            return
        self._started = True
        for r in self.rows:
            r.start()

    def advance_to(self, t_target: float) -> bool:
        """Process every arrival and telemetry tick with t <= t_target, in
        time order. Returns False once all arrivals are dispatched and the
        tick grid is past the fleet duration (no more driver work)."""
        t_target = min(t_target, self.duration)
        while True:
            t_arr = (self.requests[self._i].t_arrival
                     if self._i < len(self.requests) else math.inf)
            t_next = min(t_arr, self._next_tick)
            if t_next > t_target:
                break
            if t_arr <= self._next_tick:
                self._advance_rows(t_arr)
                self._dispatch(self.requests[self._i])
                self._i += 1
            else:
                # telemetry tick: publish the previous tick's aggregates
                # (one tick stale, matching ClusterSimulator), advance rows
                # through the tick, then sample
                if self._prev_row_w is not None:
                    self._publish_group_fracs(self._prev_row_w)
                self._advance_rows(self._next_tick)
                row_w = np.asarray([r.row_power for r in self.rows], float)
                budgets = np.asarray([r.provisioned_w for r in self.rows], float)
                self._ticks.append(self._next_tick)
                self._samples.append(row_w)
                self._budget_samples.append(budgets)
                # interior node budgets in force this tick (the tree-scope
                # controller re-divides these; static otherwise)
                self._interior_budget_samples.append(
                    self.hierarchy.node_budget_w[self.hierarchy.n_leaves:].copy())
                self._shed_cum.append(sum(self.n_shed.values()))
                rec = get_recorder()
                if rec.enabled:
                    rec.counter_k("fleet_ticks_total")
                    rec.gauge("fleet_cluster_power_frac",
                              self._stale_cluster_frac)
                fc_w = None
                if self._forecaster is not None:
                    self._forecaster.observe(self._next_tick, row_w)
                    fc_w = self._forecaster.forecast_w()
                    self._forecast_frac = fc_w / budgets
                if self.controller is not None:
                    # budget changes land between ticks: each row's policy
                    # sees them at its own next telemetry sample (one-tick
                    # actuation delay, like every other control-plane path)
                    self.controller.maybe_rebalance(self._next_tick, self.rows,
                                                    row_w, fc_w)
                if self.chaos is not None:
                    # faults land between ticks too, after the controller's
                    # pass: the control plane always acts on pre-fault state
                    # and discovers the fault at the next sample — the same
                    # actuation delay a real OOB plane has
                    self.chaos.poll(self._next_tick, self)
                    self._alive_samples.append(self.row_alive.copy())
                if self.alert_engine is not None:
                    # alert evaluation closes the tick: it sees the budgets
                    # this tick's fractions were measured against (pre-
                    # controller, matching FleetResult.node_power_frac) and
                    # the post-poll chaos state, and writes nothing back
                    self.alert_engine.on_tick(
                        self._next_tick, self, row_w, budgets,
                        self._interior_budget_samples[-1])
                self._prev_row_w = row_w
                self._next_tick += self.telemetry_s
        return not (self._i >= len(self.requests)
                    and self._next_tick > self.duration)

    def finalize(self) -> FleetResult:
        """Drain every row to its duration and assemble the structured
        :class:`FleetResult` (per-row results, decision log, shed accounting,
        folded power series, and — under a controller — the per-tick budget
        matrix plus applied rebalance events). Call exactly once, after the
        driver loop is done."""
        for r in self.rows:  # drain events between the last tick and duration
            r.advance_to(r.duration)
        row_results = [r.finalize() for r in self.rows]
        h = self.hierarchy
        power = (np.stack(self._samples) if self._samples
                 else np.zeros((0, len(self.rows))))  # [T, R] watts
        budgets = (np.stack(self._budget_samples) if self._budget_samples
                   else np.zeros((0, len(self.rows))))  # [T, R] watts
        interior = (np.stack(self._interior_budget_samples)
                    if self._interior_budget_samples
                    else np.zeros((0, h.n_nodes - h.n_leaves)))
        power_t = np.asarray(self._ticks)
        # every node fraction is measured against the budget actually in
        # force at that tick: per-row budgets move under any rebalancing
        # controller, interior budgets only under scope="tree" (identical to
        # the static fold when nothing ever moved)
        node_budget = np.concatenate([budgets, interior], axis=1)  # [T, N]
        node_frac = h.fold(power, node_budget_w=node_budget)
        rack_frac = node_frac[:, h.leaf_parents]
        cluster_frac = node_frac[:, h.root]
        row_frac = node_frac[:, :h.n_leaves]
        return FleetResult(
            row_results=row_results,
            decisions=self.decisions,
            n_offered=len(self.requests),
            n_admitted=len(self.requests) - sum(self.n_shed.values()),
            n_shed=dict(self.n_shed),
            power_t=power_t,
            row_power_frac=row_frac,
            rack_power_frac=rack_frac,
            cluster_power_frac=cluster_frac,
            shed_cum=np.asarray(self._shed_cum),
            n_brakes=sum(rr.n_brakes for rr in row_results),
            peak_cluster_frac=float(cluster_frac.max()) if len(cluster_frac) else 0.0,
            mean_cluster_frac=float(cluster_frac.mean()) if len(cluster_frac) else 0.0,
            row_budget_w=budgets,
            rebalances=(list(self.controller.events)
                        if self.controller is not None else []),
            node_power_frac=node_frac,
            node_budget_w=node_budget,
            node_names=h.names,
            fault_events=(list(self.chaos.records)
                          if self.chaos is not None else []),
            row_alive=(np.stack(self._alive_samples)
                       if self._alive_samples else None),
            alert_events=(list(self.alert_engine.events)
                          if self.alert_engine is not None else []),
        )

    def run(self) -> FleetResult:
        """Standalone drive: ``start`` + ``advance_to(duration)`` +
        ``finalize`` — bit-identical to any other stride over the same
        span (the drive protocol is stride-invariant)."""
        self.start()
        self.advance_to(self.duration)
        return self.finalize()


# ---------------------------------------------------------------------------
# scenario-driven construction (shared by run_experiment and the MC engine,
# so batched fleet members stay bit-identical with sequential runs)
# ---------------------------------------------------------------------------

def fleet_trace(scenario, workloads, shares) -> List[Request]:
    """The single cluster-wide arrival stream for a fleet scenario: the
    row-trace generator sized for the whole fleet (n_rows x n_servers busy
    servers drive the occupancy-matched Poisson rates). A one-row fleet
    therefore gets exactly the standalone row trace."""
    from repro_torch.experiments.runner import row_trace
    n_total = scenario.fleet.n_rows * scenario.fleet.n_servers
    return row_trace(scenario, workloads, shares, n_total, seed=scenario.seed)


def build_fleet(scenario, workloads, shares, server,
                budget_w: Optional[float], policy_factory,
                requests: List[Request], *, reference: bool = False) -> FleetSimulator:
    """A FleetSimulator for ``scenario`` (which must carry a RoutingSpec).

    A scenario carrying a :class:`~repro_torch.experiments.scenario.ControllerSpec`
    additionally gets a :class:`~repro_torch.fleet.controller.FleetController`
    rebalancing row budgets on the telemetry grid; one carrying a
    :class:`~repro_torch.experiments.scenario.HierarchySpec` runs under that
    arbitrary-depth budget tree (interior derates propagate down to the row
    budgets, keeping the tree conservative) instead of the default two-level
    rack split.

    ``reference=True`` builds the uncapped twin: NoCap policies on
    effectively-infinite row budgets, same router and admission spec (no
    emergency ever triggers, so nothing is shed) — the paper's
    capping-impact-only baseline, fleet-shaped. References never carry a
    controller or a shaped hierarchy: with nothing capped there is no
    headroom to move, and the baseline must isolate power-management impact.

    A scenario carrying a :class:`~repro_torch.chaos.faults.FaultSpec`
    (``Scenario.faults``) gets a fresh
    :class:`~repro_torch.chaos.injector.ChaosInjector` riding the tick lockstep
    (fresh per fleet — Monte-Carlo members must not share actuation state;
    the timeline is validated here, before anything runs). References carry
    only the row-crash/revive subset: a crash is an environmental capacity
    loss both twins must see, while budget derates are power-plane events
    the uncapped baseline by definition doesn't have.

    A scenario carrying ``Scenario.alerts`` gets an
    :class:`~repro_torch.obs.alerts.AlertEngine` evaluating those rules on the
    tick lockstep (write-only: transitions land in
    ``FleetResult.alert_events`` and the recorder, never in control flow).
    References never carry alerts — the uncapped twin has no power plane
    to alarm on.
    """
    from repro_torch.core.policy import NoCap
    from repro_torch.experiments.runner import row_sim
    from repro_torch.fleet.controller import build_controller
    from repro_torch.fleet.router import build_admission, build_router

    spec = scenario.routing
    if spec is None:
        raise ValueError(f"scenario {scenario.name!r} has no RoutingSpec")
    fleet = scenario.fleet
    hspec = getattr(scenario, "hierarchy", None)
    n = fleet.n_servers
    rows = []
    hierarchy = None
    if reference:
        for i in range(fleet.n_rows):
            rows.append(RowSimulator(
                workloads, server, n, 10 * n, NoCap(), [], shares,
                SimConfig(power_scale=scenario.power_scale, record_power=False),
                duration=scenario.duration_s, row_index=i))
    else:
        budgets = row_budgets(scenario, budget_w, server)
        if hspec is not None:
            # shape the per-row base budgets through the tree: derated
            # interior nodes shrink their rows' budgets
            hierarchy = hspec.build(budgets)
            budgets = [float(b) for b in hierarchy.leaf_budget_w]
        for i in range(fleet.n_rows):
            rows.append(row_sim(scenario, workloads, shares, server,
                                budgets[i], policy_factory(), [], row_index=i))
    cspec = getattr(scenario, "controller", None)
    controller = (build_controller(cspec)
                  if cspec is not None and not reference else None)
    fspec = getattr(scenario, "faults", None)
    if fspec is not None and reference:
        fspec = fspec.routing_only()
    chaos = (ChaosInjector(fspec)
             if fspec is not None and not fspec.is_noop else None)
    aspecs = getattr(scenario, "alerts", None)
    return FleetSimulator(
        rows, requests,
        router=build_router(spec.router, spec.params),
        admission=build_admission(spec.admission, spec.admission_params),
        rows_per_rack=fleet.rows_per_rack,
        telemetry_s=scenario.telemetry.telemetry_s,
        controller=controller,
        hierarchy=hierarchy,
        chaos=chaos,
        alerts=None if reference else aspecs)
