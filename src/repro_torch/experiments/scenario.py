"""Declarative experiment specification (port of ``repro.experiments.scenario``).

A ``Scenario`` is a serializable description of one POLCA experiment: fleet
composition (rows x servers, model, device), workload mix knobs, the policy
to run (by name + params, so it round-trips through JSON), telemetry/latency
constants, SLOs, seeds, and how the row power budget is set. Every sweep
constructs a ``Scenario`` and hands it to
:func:`repro_torch.experiments.runner.run_experiment` or to the Monte-Carlo
engines of :mod:`repro_torch.provisioning`.

Named scenarios live in a registry (``get_scenario`` / ``register_scenario``)
so benchmarks, tests and the CLI can share exact configurations by name.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.chaos.faults import FaultEvent, FaultSpec
from repro_torch.obs.alerts import AlertSpec, coerce_alerts, default_alert_pack
from repro_torch.core.policy import NoCap, OneThreshold, PolcaPolicy, PredictivePolcaPolicy
from repro_torch.core.power_model import A100, TPU_V5E, DevicePower, ServerPower
from repro_torch.core.slo import DEFAULT_SLO, SLO

DAY = 86_400.0
WEEK = 7 * DAY

DEVICE_PROFILES: Dict[str, DevicePower] = {
    A100.name: A100,
    TPU_V5E.name: TPU_V5E,
}

POLICY_BUILDERS: Dict[str, Callable[..., Any]] = {
    "polca": PolcaPolicy,
    "polca-predictive": PredictivePolcaPolicy,
    "one-threshold": OneThreshold,
    "no-cap": NoCap,
}


@dataclass(frozen=True)
class PolicySpec:
    """A policy by registry name + constructor params (JSON-serializable)."""

    kind: str = "polca"
    params: Dict[str, Any] = field(default_factory=dict)

    def build(self):
        """A fresh (stateless) policy instance for one simulation run."""
        return POLICY_BUILDERS[self.kind](**self.params)


@dataclass(frozen=True)
class FleetSpec:
    """What hardware hosts the experiment, and how oversubscribed it is."""

    n_provisioned: int = 40  # servers the row budget was provisioned for
    added_frac: float = 0.0  # oversubscription: the row hosts (1+added) * n
    n_rows: int = 1  # >1: ClusterSimulator composes rows
    rows_per_rack: int = 2
    model: str = "bloom-176b"
    device: str = A100.name
    n_devices_per_server: int = 8
    # per-row budget multipliers (heterogeneous PDU headroom) for routed
    # fleet runs; None = every row gets the full resolved budget
    row_budget_fracs: Optional[Tuple[float, ...]] = None

    @property
    def n_servers(self) -> int:
        return int(round(self.n_provisioned * (1.0 + self.added_frac)))

    def server(self) -> ServerPower:
        return ServerPower(DEVICE_PROFILES[self.device],
                           n_devices=self.n_devices_per_server)


@dataclass(frozen=True)
class TrafficSpec:
    """Workload-mix knobs over the Table-4 classes.

    ``generator`` names an occupancy-curve family in the
    ``core.traces`` generator registry ("diurnal" is built in; the scenario
    families — bursty, colocated, failover-surge, rack-incident, nighttime —
    register on ``import repro_torch.provisioning``). ``gen_params`` are passed to
    the generator verbatim, so scenarios stay JSON-serializable.
    """

    occ_peak: float = 0.62  # diurnal occupancy peak (busy-server fraction)
    priority_mix_override: Optional[float] = None  # force every class's HP mix
    generator: str = "diurnal"
    gen_params: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class RoutingSpec:
    """Fleet serving configuration: how a cluster-wide arrival process lands
    on rows. ``router``/``admission`` name entries in the ``repro_torch.fleet``
    registries (round-robin, jsq, power-headroom, cap-aware / admit-all,
    shed-lp); params pass to the builders verbatim, so the spec round-trips
    through JSON. A Scenario carrying a RoutingSpec runs the
    :class:`~repro_torch.fleet.fleet.FleetSimulator` path in ``run_experiment``
    instead of per-row pre-baked traces."""

    router: str = "round-robin"
    params: Dict[str, Any] = field(default_factory=dict)
    admission: str = "admit-all"
    admission_params: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class HierarchySpec:
    """A serializable arbitrary-depth power-budget tree over a fleet's rows
    (built into a :class:`~repro_torch.core.hierarchy.PowerHierarchy` at run
    time). ``shape`` lists the fan-out per interior level root-down —
    ``(2, 2, 3)`` is a site with 2 PDU sets x 2 racks x 3 rows = 12 rows
    (``prod(shape)`` must equal ``FleetSpec.n_rows``). ``level_names``
    labels the interior levels root-down (defaults to site/pdu/rack...).
    ``budget_fracs`` derates interior nodes by root-down path (``"0/1"`` =
    the second rack of the first PDU set); a derate multiplies every
    descendant row's budget, so planner-shaped budgets stay conservative —
    each node's budget is exactly the sum of its children's. A Scenario
    carrying a HierarchySpec runs its fleet (or cluster) under this tree
    instead of the default two-level ``rows_per_rack`` split; with a
    ``ControllerSpec(scope="tree")`` the rebalancing controller re-divides
    budgets recursively at every interior node."""

    shape: Tuple[int, ...] = (2, 2)
    level_names: Optional[Tuple[str, ...]] = None
    budget_fracs: Dict[str, float] = field(default_factory=dict)

    @property
    def n_rows(self) -> int:
        return int(math.prod(self.shape))

    def build(self, row_budget_w: Sequence[float]):
        """The live :class:`~repro_torch.core.hierarchy.PowerHierarchy` for these
        per-row base budgets (derates applied, interior sums filled in)."""
        from repro_torch.core.hierarchy import PowerHierarchy
        return PowerHierarchy.from_shape(
            self.shape, row_budget_w, level_names=self.level_names,
            budget_fracs=self.budget_fracs)


@dataclass(frozen=True)
class ControllerSpec:
    """Fleet-level power-rebalancing configuration. ``kind`` names a
    rebalance policy in the ``repro_torch.fleet.controller`` registry (``static``
    — budgets never move, bit-identical to controller-less fleets;
    ``proportional`` — envelope split by measured row power; ``predictive``
    — split by the 40 s OOB-horizon power forecast); ``params`` pass to the
    policy builder verbatim. The controller re-divides the fixed ``scope``
    envelope every ``interval_s`` — ``"rack"``: each leaf-parent's rows
    share that rack's envelope; ``"cluster"``: all rows share the root
    envelope as one flat pool; ``"tree"``: the policy runs recursively at
    every interior node of the scenario's budget hierarchy (the site
    re-divides across PDU sets, PDU sets across racks, racks across rows;
    only the root envelope is frozen) — stepping
    ``alpha`` of the way to the target and never dropping a row below
    ``min_share`` of its group's equal split. A Scenario carrying a
    ControllerSpec (and a RoutingSpec — the controller rides the fleet
    driver's telemetry lockstep) gets a
    :class:`~repro_torch.fleet.controller.FleetController`. Rebalances that would
    move fewer than ``deadband_w`` watts in total are skipped."""

    kind: str = "static"
    params: Dict[str, Any] = field(default_factory=dict)
    interval_s: float = 60.0
    scope: str = "rack"
    alpha: float = 0.5
    min_share: float = 0.5
    deadband_w: float = 1.0


@dataclass(frozen=True)
class TelemetryConfig:
    """Controller-plane constants (paper Table 1)."""

    telemetry_s: float = 2.0
    oob_latency_s: float = 40.0
    brake_latency_s: float = 5.0
    record_power: bool = True


@dataclass(frozen=True)
class Scenario:
    """One fully-specified experiment. Immutable; vary with ``with_()``."""

    name: str
    duration_s: float
    fleet: FleetSpec = field(default_factory=FleetSpec)
    policy: PolicySpec = field(default_factory=PolicySpec)
    traffic: TrafficSpec = field(default_factory=TrafficSpec)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    slo: SLO = DEFAULT_SLO
    power_scale: float = 1.0  # robustness runs: x1.05 = +5% workload power
    seed: int = 7
    # row power budget: "calibrated" (Table-2 79%-peak operating point),
    # "nominal" (n_provisioned x server rating), or explicit watts
    budget: Union[str, float] = "calibrated"
    compare_to_reference: bool = True  # diff latencies vs an uncapped run
    # fleet serving: a cluster-wide arrival process dispatched by a router
    # (repro_torch.fleet) instead of pre-baked per-row traces
    routing: Optional[RoutingSpec] = None
    # fleet-level dynamic power rebalancing (requires routing; None = static
    # per-row budgets, exactly the pre-controller behavior)
    controller: Optional[ControllerSpec] = None
    # the power-budget tree over the rows (None = the classic two-level
    # rows_per_rack split, exactly the pre-hierarchy behavior)
    hierarchy: Optional[HierarchySpec] = None
    # chaos engine: an injectable fault timeline (row crashes, PDU loss,
    # thermal derates, demand-response) applied between telemetry ticks by
    # repro_torch.chaos.ChaosInjector. Requires routing; None or an empty spec is
    # exactly the fault-free fleet (bit-identical, tier-1-asserted)
    faults: Optional[FaultSpec] = None
    # online alerting: AlertSpec rules evaluated per telemetry tick by an
    # obs.alerts.AlertEngine on the fleet lockstep. Requires routing;
    # write-only (alerts-on is bit-identical to alerts-off except for
    # FleetResult.alert_events, tier-1-asserted); None or () disables
    alerts: Optional[Tuple[AlertSpec, ...]] = None

    def with_(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)

    def with_fleet(self, **kw) -> "Scenario":
        return self.with_(fleet=dataclasses.replace(self.fleet, **kw))

    def with_policy(self, kind: str, **params) -> "Scenario":
        return self.with_(policy=PolicySpec(kind, params))

    def with_routing(self, router: str, **params) -> "Scenario":
        """Same scenario under a different routing policy (admission spec is
        preserved when one is already set)."""
        prev = self.routing or RoutingSpec()
        return self.with_(routing=dataclasses.replace(
            prev, router=router, params=params))

    def with_controller(self, kind: str, **kw) -> "Scenario":
        """Same scenario under a different rebalance policy. Keyword args
        matching ControllerSpec fields (``interval_s``, ``scope``,
        ``alpha``, ``min_share``) configure the controller; the rest pass to
        the policy builder as ``params``."""
        fields = {f.name for f in dataclasses.fields(ControllerSpec)} - {"kind", "params"}
        spec_kw = {k: v for k, v in kw.items() if k in fields}
        params = {k: v for k, v in kw.items() if k not in fields}
        prev = self.controller or ControllerSpec()
        return self.with_(controller=dataclasses.replace(
            prev, kind=kind, params=params, **spec_kw))

    def with_faults(self, faults) -> "Scenario":
        """Same scenario under a fault timeline: a
        :class:`~repro_torch.chaos.faults.FaultSpec`, an iterable of
        :class:`~repro_torch.chaos.faults.FaultEvent`, or ``None`` to clear."""
        if faults is not None and not isinstance(faults, FaultSpec):
            faults = FaultSpec(tuple(faults))
        return self.with_(faults=faults)

    def with_alerts(self, alerts) -> "Scenario":
        """Same scenario under an alert rule set: an iterable of
        :class:`~repro_torch.obs.alerts.AlertSpec` (or their dicts), or ``None``
        to clear. Alerting is write-only, so every variant replays the
        unalerted scenario bit for bit."""
        return self.with_(alerts=coerce_alerts(alerts))

    def with_hierarchy(self, shape: Tuple[int, ...], **kw) -> "Scenario":
        """Same scenario under an explicit budget tree (and a fleet sized to
        match: ``n_rows`` is set to ``prod(shape)``). Keyword args pass to
        :class:`HierarchySpec` (``level_names``, ``budget_fracs``)."""
        spec = HierarchySpec(shape=tuple(shape), **kw)
        return (self.with_(hierarchy=spec)
                .with_fleet(n_rows=spec.n_rows))

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        d = dict(d)
        fleet = dict(d.get("fleet", {}))
        if fleet.get("row_budget_fracs") is not None:
            fleet["row_budget_fracs"] = tuple(fleet["row_budget_fracs"])
        d["fleet"] = FleetSpec(**fleet)
        d["policy"] = PolicySpec(**d.get("policy", {}))
        d["traffic"] = TrafficSpec(**d.get("traffic", {}))
        d["telemetry"] = TelemetryConfig(**d.get("telemetry", {}))
        d["slo"] = SLO(**d.get("slo", {}))
        if d.get("routing") is not None:
            d["routing"] = RoutingSpec(**d["routing"])
        if d.get("controller") is not None:
            d["controller"] = ControllerSpec(**d["controller"])
        if d.get("hierarchy") is not None:
            h = dict(d["hierarchy"])
            h["shape"] = tuple(h.get("shape", ()))
            if h.get("level_names") is not None:
                h["level_names"] = tuple(h["level_names"])
            d["hierarchy"] = HierarchySpec(**h)
        if d.get("faults") is not None:
            d["faults"] = FaultSpec.from_dict(d["faults"])
        if d.get("alerts") is not None:
            d["alerts"] = coerce_alerts(d["alerts"])
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Scenario":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(scenario: Scenario, *, overwrite: bool = False) -> Scenario:
    if scenario.name in _REGISTRY and not overwrite:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _REGISTRY[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown scenario {name!r}; registered: {known}") from None


def list_scenarios() -> List[str]:
    return sorted(_REGISTRY)


# Named configurations shared with the JAX package's registry (the same
# fields, registered in the same order). Benchmarks shorten durations with
# ``with_()``. The ``mc-*`` family registers on ``import
# repro_torch.provisioning``.
register_scenario(Scenario(
    name="table2-baseline",
    duration_s=WEEK,
    policy=PolicySpec("no-cap"),
    seed=11,
    budget="nominal",
    compare_to_reference=False,
))
register_scenario(Scenario(
    name="fig13-search-base",
    duration_s=WEEK / 2,
    fleet=FleetSpec(added_frac=0.30),
))
register_scenario(Scenario(
    name="fig14-plus30",
    duration_s=WEEK / 2,
    fleet=FleetSpec(added_frac=0.30),
))
register_scenario(Scenario(
    name="fig16-six-week",
    duration_s=6 * WEEK,
    policy=PolicySpec("no-cap"),
    traffic=TrafficSpec(occ_peak=0.97),
    seed=23,
    budget="nominal",
    compare_to_reference=False,
))
register_scenario(Scenario(
    name="fig17-comparison",
    duration_s=WEEK / 2,
    fleet=FleetSpec(added_frac=0.30),
))
register_scenario(Scenario(
    name="quickstart-plus30",
    duration_s=3 * 3600.0,
    fleet=FleetSpec(added_frac=0.30),
))
register_scenario(Scenario(
    name="cluster-2rack",
    duration_s=DAY / 4,
    fleet=FleetSpec(n_provisioned=20, added_frac=0.30, n_rows=4, rows_per_rack=2),
    budget="nominal",
    traffic=TrafficSpec(occ_peak=0.9),
    compare_to_reference=False,
))
register_scenario(Scenario(
    name="cluster-six-week",
    duration_s=6 * WEEK,
    fleet=FleetSpec(added_frac=0.30, n_rows=8, rows_per_rack=2),
    traffic=TrafficSpec(occ_peak=0.97),
    budget="nominal",
    compare_to_reference=False,
))

# Fleet serving scenarios (repro_torch.fleet): one cluster-wide arrival process
# dispatched over an oversubscribed 6-row cluster whose last row sits on a
# 30%-derated PDU (row_budget_fracs) under sustained near-peak traffic — the
# configuration where routing policy decides whether the HP SLO survives:
# round-robin keeps feeding the derated row (brakes, blown HP p99) while
# cap-state-aware routing water-fills around it inside the same envelope.
# Variants swap the router only, so policy comparisons share the exact same
# trace and envelope.
_FLEET_BASE = Scenario(
    name="fleet-round-robin",
    duration_s=DAY / 4,
    fleet=FleetSpec(n_provisioned=20, added_frac=0.05, n_rows=6,
                    rows_per_rack=2,
                    row_budget_fracs=(1.0, 1.0, 1.0, 1.0, 1.0, 0.7)),
    policy=PolicySpec("polca"),
    traffic=TrafficSpec(occ_peak=0.62, gen_params={"trough": 0.55}),
    routing=RoutingSpec("round-robin"),
    budget="calibrated",
)
register_scenario(_FLEET_BASE)
register_scenario(_FLEET_BASE.with_routing("jsq").with_(name="fleet-jsq"))
register_scenario(_FLEET_BASE.with_routing("power-headroom")
                  .with_(name="fleet-power-headroom"))
register_scenario(_FLEET_BASE.with_routing("cap-aware")
                  .with_(name="fleet-cap-aware"))
# admission-control variant: round-robin keeps overloading the derated row
# (power emergencies), so LP shedding actually engages — the demo that shed
# accounting is exact and HP is never shed
register_scenario(_FLEET_BASE.with_(
    name="fleet-rr-shed",
    routing=RoutingSpec("round-robin", admission="shed-lp",
                        admission_params={"shed_above": 0.97})))

# Fleet rebalancing scenarios (repro_torch.fleet.controller): the derated-row
# cluster pushed past the point where routing alone saves it — traffic high
# enough that even cap-aware dispatch powerbrakes the 0.7x row under static
# per-row budgets, while its rack partner holds slack it never spends. The
# variants differ ONLY in the ControllerSpec (same trace, envelope, router),
# so they measure exactly what dynamic rebalancing buys: `static` reproduces
# pre-controller behavior bit-for-bit, `proportional` follows measured
# demand, `predictive` follows the 40s OOB-horizon forecast, and the
# forecast-router variant pairs the predictive controller with the
# forecast-aware router (budget moves toward predicted demand while marginal
# load steers away from predicted congestion).
_REBALANCE_BASE = _FLEET_BASE.with_routing("cap-aware").with_(
    name="fleet-rebalance-static",
    traffic=TrafficSpec(occ_peak=0.70, gen_params={"trough": 0.62}),
    controller=ControllerSpec("static"),
)
register_scenario(_REBALANCE_BASE)
register_scenario(_REBALANCE_BASE.with_controller("proportional")
                  .with_(name="fleet-rebalance-proportional"))
register_scenario(_REBALANCE_BASE.with_controller("predictive")
                  .with_(name="fleet-rebalance-predictive"))
register_scenario(_REBALANCE_BASE.with_controller("predictive")
                  .with_routing("forecast-aware")
                  .with_(name="fleet-rebalance-forecast-router"))

# The routed-fleet scenario family (one trace + envelope, router swapped):
# the set the provisioning planner sweeps in benchmarks/capacity_planning.py
# ("how far does the envelope stretch under each dispatch policy").
FLEET_SCENARIO_FAMILY: List[str] = [
    "fleet-round-robin",
    "fleet-jsq",
    "fleet-power-headroom",
    "fleet-cap-aware",
    "fleet-rr-shed",
]

# Site-scale hierarchy scenarios (repro_torch.core.hierarchy): a 12-row site — 2
# PDU sets x 2 racks x 3 rows — whose second rack (path "0/1") sits on a
# 30%-derated PDU, under the same stressed traffic as the fleet-rebalance
# family. The derate is *planner-shaped*: it propagates down to the rack's
# three row budgets (the tree stays conservative), so every row of that rack
# powerbrakes under load while the sibling rack and the entire second PDU
# set hold slack a flat per-row (or per-rack) rebalance can never reach —
# rack-scope rebalancing is structurally useless here (all three siblings
# are equally starved). Only the tree-scope controller, re-dividing the site
# envelope across PDU sets and racks recursively, moves that headroom to
# where the demand is. Variants differ ONLY in the ControllerSpec.
_SITE_BASE = Scenario(
    name="site-static",
    duration_s=DAY / 4,
    fleet=FleetSpec(n_provisioned=20, added_frac=0.05, n_rows=12),
    policy=PolicySpec("polca"),
    traffic=TrafficSpec(occ_peak=0.70, gen_params={"trough": 0.62}),
    routing=RoutingSpec("cap-aware"),
    controller=ControllerSpec("static"),
    hierarchy=HierarchySpec(shape=(2, 2, 3), budget_fracs={"0/1": 0.7}),
    budget="calibrated",
)
register_scenario(_SITE_BASE)
register_scenario(_SITE_BASE.with_controller("predictive", scope="rack")
                  .with_(name="site-rack-predictive"))
register_scenario(_SITE_BASE.with_controller("predictive", scope="tree")
                  .with_(name="site-tree-predictive"))

SITE_SCENARIO_FAMILY: List[str] = [
    "site-static",
    "site-rack-predictive",
    "site-tree-predictive",
]

# Chaos scenarios (repro_torch.chaos): the 12-row site under injected fault
# timelines. Unlike the site-* family the site starts *healthy* (no
# budget_fracs derate) — the fault is the only stress, so every variant
# isolates how the unchanged control plane handles one emergency:
#
# * chaos-noop         — site-static plus an empty FaultSpec: the tier-1
#                        bit-parity anchor (must be identical to the
#                        fault-free fleet, byte for byte).
# * chaos-pdu-loss-*   — pdu0 (half the site) loses 30% of its feed for a
#                        40 min window mid-trace (the OOB budget step-down
#                        ramps over 2 min as the redundant feed saturates).
#                        `static` + admit-all holds budgets where
#                        provisioning put them and powerbrakes; `tree`
#                        re-divides the shrunk site envelope around the
#                        capacity cap every interval while shed-lp sheds LP
#                        load during the emergency. The family pins an
#                        explicit thin-headroom row budget (105 kW, ~98% of
#                        nominal) — the operating point where a 30% PDU
#                        derate is survivable by rebalancing but not by
#                        static budgets (benchmarks/chaos_resilience.py).
# * chaos-row-crash    — one row crashes and later revives: the
#                        conservation demo (admitted + shed == offered
#                        across the outage; in-flight work drains; revival
#                        re-enters via inject()).
# * chaos-demand-response — a grid event ramps the *site* envelope down 15%
#                        over 10 min and restores it later; tree-scope
#                        rebalancing follows the shrinking root.
#
# The whole family carries the default alert pack (obs.alerts): alerting is
# write-only, so the rules ride along without moving a bit of any series —
# chaos-noop doubles as the zero-false-alarm anchor, and the pdu-loss
# variants are the detection-latency yardstick (benchmarks/alerting.py).
_CHAOS_BASE = Scenario(
    name="chaos-pdu-loss-static",
    duration_s=DAY / 4,
    fleet=FleetSpec(n_provisioned=20, added_frac=0.05, n_rows=12),
    policy=PolicySpec("polca"),
    traffic=TrafficSpec(occ_peak=0.70, gen_params={"trough": 0.62}),
    routing=RoutingSpec("cap-aware"),
    controller=ControllerSpec("static"),
    hierarchy=HierarchySpec(shape=(2, 2, 3)),
    budget=105_000.0,
    faults=FaultSpec((FaultEvent("node-derate", t=2400.0, node="pdu0",
                                 factor=0.7, until=4800.0, ramp_s=120.0),)),
    alerts=default_alert_pack(),
)
register_scenario(_SITE_BASE.with_(name="chaos-noop", faults=FaultSpec(),
                                   alerts=default_alert_pack()))
register_scenario(_CHAOS_BASE)
register_scenario(_CHAOS_BASE.with_controller("predictive", scope="tree")
                  .with_(name="chaos-pdu-loss-tree",
                         routing=RoutingSpec(
                             "cap-aware", admission="shed-lp",
                             admission_params={"shed_above": 0.97})))
register_scenario(_CHAOS_BASE.with_(
    name="chaos-row-crash",
    faults=FaultSpec((FaultEvent("row-crash", t=1800.0, row=3),
                      FaultEvent("row-revive", t=4500.0, row=3)))))
register_scenario(_CHAOS_BASE.with_controller("predictive", scope="tree")
                  .with_(name="chaos-demand-response",
                         faults=FaultSpec((FaultEvent(
                             "site-demand-response", t=2400.0, factor=0.85,
                             ramp_s=600.0, until=5400.0),))))

CHAOS_SCENARIO_FAMILY: List[str] = [
    "chaos-noop",
    "chaos-pdu-loss-static",
    "chaos-pdu-loss-tree",
    "chaos-row-crash",
    "chaos-demand-response",
]
