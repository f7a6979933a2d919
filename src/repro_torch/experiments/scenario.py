"""Declarative experiment specification (port of ``repro.experiments.scenario``).

A ``Scenario`` is a serializable description of one POLCA experiment: fleet
composition (rows x servers, model, device), workload mix knobs, the policy
to run (by name + params, so it round-trips through JSON), telemetry/latency
constants, SLOs, seeds, and how the row power budget is set.

``hierarchy`` (a :class:`HierarchySpec`, the power-budget tree over the
rows) and ``faults`` (a :class:`~repro_torch.chaos.faults.FaultSpec`
timeline) are ported: the batched lowering turns them into per-row leaf
budgets, a node fold matrix, and per-tick row-alive masks and budget
scales. The fields ``routing``, ``controller`` and ``alerts`` belong to
subsystems this port does not carry yet (routed fleets, budget
rebalancing, alerting). They stay on the dataclass, so a scenario
serialized by the JAX package loads here, but a scenario that sets one
raises ``NotImplementedError`` naming the missing port.

Named scenarios live in a registry (``get_scenario`` / ``register_scenario``)
so benchmarks, tests and the CLI can share exact configurations by name.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.chaos.faults import FaultSpec
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

# Scenario fields whose subsystems are not ported yet, and the port each
# one waits for
UNPORTED_FIELDS: Dict[str, str] = {
    "routing": "repro_torch.fleet (routed fleets)",
    "controller": "repro_torch.fleet.controller (budget rebalancing)",
    "alerts": "repro_torch.obs.alerts (online alerting)",
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
    n_rows: int = 1
    rows_per_rack: int = 2
    model: str = "bloom-176b"
    device: str = A100.name
    n_devices_per_server: int = 8
    # per-row budget multipliers (heterogeneous PDU headroom); None = every
    # row gets the full resolved budget
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
    register on ``import repro_torch.provisioning``). ``gen_params`` are
    passed to the generator verbatim, so scenarios stay JSON-serializable.
    """

    occ_peak: float = 0.62  # diurnal occupancy peak (busy-server fraction)
    priority_mix_override: Optional[float] = None  # force every class's HP mix
    generator: str = "diurnal"
    gen_params: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class HierarchySpec:
    """A serializable arbitrary-depth power-budget tree over a fleet's rows
    (built into a :class:`~repro_torch.core.hierarchy.PowerHierarchy` at
    lowering time). ``shape`` lists the fan-out per interior level
    root-down — ``(2, 2, 3)`` is a site with 2 PDU sets x 2 racks x 3 rows =
    12 rows (``prod(shape)`` must equal ``FleetSpec.n_rows``).
    ``level_names`` labels the interior levels root-down (defaults to
    site/pdu/rack...). ``budget_fracs`` derates interior nodes by root-down
    path (``"0/1"`` = the second rack of the first PDU set); a derate
    multiplies every descendant row's budget, so each node's budget is
    exactly the sum of its children's."""

    shape: Tuple[int, ...] = (2, 2)
    level_names: Optional[Tuple[str, ...]] = None
    budget_fracs: Dict[str, float] = field(default_factory=dict)

    @property
    def n_rows(self) -> int:
        return int(math.prod(self.shape))

    def build(self, row_budget_w: Sequence[float]):
        """The :class:`~repro_torch.core.hierarchy.PowerHierarchy` for these
        per-row base budgets (derates applied, interior sums filled in)."""
        from repro_torch.core.hierarchy import PowerHierarchy
        return PowerHierarchy.from_shape(
            self.shape, row_budget_w, level_names=self.level_names,
            budget_fracs=self.budget_fracs)


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
    # subsystems not ported yet: each must stay None (see UNPORTED_FIELDS)
    routing: Optional[Any] = None
    controller: Optional[Any] = None
    # the power-budget tree over the rows (None = flat per-row budgets)
    hierarchy: Optional[HierarchySpec] = None
    # a fault timeline (row crashes, node derates, demand response); None or
    # an empty spec is the fault-free run
    faults: Optional[FaultSpec] = None
    alerts: Optional[Any] = None

    def __post_init__(self):
        for name, port in UNPORTED_FIELDS.items():
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"scenario {self.name!r} sets {name}=, which needs "
                    f"{port}: not ported to PyTorch yet")

    def with_(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)

    def with_fleet(self, **kw) -> "Scenario":
        return self.with_(fleet=dataclasses.replace(self.fleet, **kw))

    def with_policy(self, kind: str, **params) -> "Scenario":
        return self.with_(policy=PolicySpec(kind, params))

    def with_faults(self, faults) -> "Scenario":
        """Same scenario under a fault timeline: a
        :class:`~repro_torch.chaos.faults.FaultSpec`, an iterable of
        :class:`~repro_torch.chaos.faults.FaultEvent`, or ``None`` to clear."""
        if faults is not None and not isinstance(faults, FaultSpec):
            faults = FaultSpec(tuple(faults))
        return self.with_(faults=faults)

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
        if d.get("hierarchy") is not None:
            h = dict(d["hierarchy"])
            h["shape"] = tuple(h.get("shape", ()))
            if h.get("level_names") is not None:
                h["level_names"] = tuple(h["level_names"])
            d["hierarchy"] = HierarchySpec(**h)
        if d.get("faults") is not None:
            d["faults"] = FaultSpec.from_dict(d["faults"])
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
# fields): the figure and table scenarios and the two cluster scenarios.
# Benchmarks shorten durations with ``with_()``. The ``mc-*`` family
# registers on ``import repro_torch.provisioning``; the fleet, rebalance,
# site and chaos families wait for their subsystems.
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
