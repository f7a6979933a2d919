"""Serializable fault timelines: the chaos engine's data model (port of
``repro.chaos.faults``, copied in full).

POLCA's safety argument is that the control plane *reacts* to rare power
emergencies, yet every healthy-fleet benchmark measures steady state. A
:class:`FaultSpec` makes the emergency itself a first-class, JSON-round-
trippable part of a :class:`~repro_torch.experiments.scenario.Scenario`
(``Scenario.faults`` / ``with_faults``): an ordered timeline of
:class:`FaultEvent`\\ s the :class:`~repro_torch.chaos.injector.ChaosInjector`
applies between fleet telemetry ticks. Four event kinds are registered (the
``FAULT_EVENT_BUILDERS`` registry backs docs/registries.md exactly like the
policy/router registries):

  * ``row-crash`` / ``row-revive`` — a row is fenced from the dispatcher
    (in-flight work drains; arrivals route around it, or are shed when no
    row is left) and later returns through the existing
    ``RowSimulator.inject()`` revival path;
  * ``node-derate`` — a step- or ramp-derate of any budget-tree node's
    deliverable capacity (a PDU losing a feed, a thermally throttled rack):
    the target's subtree budgets scale down and the lost watts leave every
    ancestor envelope, so the budget tree stays conservative; a hard
    capacity cap (``PowerHierarchy.node_cap_w``) stops rebalancing
    controllers from promising the node watts the hardware can no longer
    carry;
  * ``site-demand-response`` — a grid event shrinking the *root* (site)
    envelope on a schedule; exactly a ``node-derate`` targeting the root.

Budget events with ``until`` restore at that time: the removed watts are
returned to the node's subtree and every ancestor, so the root envelope
round-trips exactly even if a controller moved budgets in between. The
batched lowering (``provisioning.batched._lower_faults``) turns the same
timeline into per-tick row-alive masks and budget scales.

Validation is two-stage: structural checks run at construction
(``__post_init__``), and :meth:`FaultSpec.validate` — called when the fleet
is *built*, before any event is simulated — checks the timeline against the
concrete run (events beyond the trace duration, rows that don't exist, node
names absent from the scenario's hierarchy) and raises ``ValueError``
naming the offending event instead of surfacing as a mid-run error.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

_ROW_KINDS = ("row-crash", "row-revive")
_BUDGET_KINDS = ("node-derate", "site-demand-response")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``kind`` names an entry in
    ``FAULT_EVENT_BUILDERS``; which other fields apply depends on it:

    * row events (``row-crash`` / ``row-revive``) target ``row`` (a leaf /
      row index) at time ``t``;
    * ``node-derate`` targets ``node`` (a hierarchy node *name*, e.g.
      ``"pdu0"`` or ``"rack0.1"``) and multiplies its deliverable capacity
      by ``factor`` (0 < factor <= 1), stepping instantly or ramping
      linearly over ``ramp_s`` (thermal derates ramp; breaker trips step);
    * ``site-demand-response`` is a ``node-derate`` whose target is
      implicitly the root — ``node`` must be left ``None``.

    Budget events with ``until`` restore the removed watts at that time;
    ``until=None`` is permanent for the rest of the trace.
    """

    kind: str
    t: float
    row: Optional[int] = None
    node: Optional[str] = None
    factor: float = 1.0
    until: Optional[float] = None
    ramp_s: float = 0.0

    def describe(self) -> str:
        """Compact human-readable form, used by validation errors and the
        audit log."""
        if self.kind in _ROW_KINDS:
            return f"{self.kind}(t={self.t:g}, row={self.row})"
        target = self.node if self.node is not None else "<root>"
        txt = f"{self.kind}(t={self.t:g}, node={target}, factor={self.factor:g}"
        if self.ramp_s:
            txt += f", ramp_s={self.ramp_s:g}"
        if self.until is not None:
            txt += f", until={self.until:g}"
        return txt + ")"


# ---------------------------------------------------------------------------
# registry: one marker class per event kind. The classes carry the docstring
# the registry reference (docs/registries.md) renders, and the per-kind
# structural validation — the same name-keyed pattern as the policy/router/
# rebalance registries, so FaultSpec stays JSON-serializable.
# ---------------------------------------------------------------------------

def _require(cond: bool, event: FaultEvent, why: str) -> None:
    if not cond:
        raise ValueError(f"invalid fault event {event.describe()}: {why}")


class RowCrash:
    """A row drops out of the serving pool: the dispatcher fences it (in-flight work drains, arrivals route around it or shed), budgets untouched."""

    @staticmethod
    def check(e: FaultEvent) -> None:
        _require(e.row is not None and int(e.row) >= 0, e,
                 "row events need a non-negative row index")
        _require(e.node is None, e, "row events target rows, not nodes")
        _require(e.until is None and e.ramp_s == 0.0, e,
                 "row events are instantaneous; schedule an explicit "
                 "row-revive instead of until/ramp_s")


class RowRevive:
    """A crashed row returns to the routing pool; a row drained past its duration re-enters through the RowSimulator.inject() revival path."""

    check = RowCrash.check


class NodeDerate:
    """Step- or ramp-derate of a budget-tree node's deliverable capacity (PDU feed loss, thermal throttle): subtree budgets scale down, the lost watts leave every ancestor envelope, and a capacity cap blocks controllers from re-growing the node until the optional restore."""

    @staticmethod
    def check(e: FaultEvent) -> None:
        _require(e.row is None, e, "budget events target nodes, not rows")
        _require(isinstance(e.node, str) and bool(e.node), e,
                 "node-derate needs a hierarchy node name")
        _check_budget_common(e)


class SiteDemandResponse:
    """Grid demand-response: the root (site) envelope shrinks by ``factor`` on a schedule and restores at ``until`` — a node-derate whose target is the root."""

    @staticmethod
    def check(e: FaultEvent) -> None:
        _require(e.row is None, e, "budget events target nodes, not rows")
        _require(e.node is None, e,
                 "site-demand-response targets the root implicitly; use "
                 "node-derate to name an interior node")
        _check_budget_common(e)


def _check_budget_common(e: FaultEvent) -> None:
    import math
    _require(math.isfinite(e.factor) and 0.0 < e.factor <= 1.0, e,
             "factor must be a capacity multiplier in (0, 1] — a 0 W budget "
             "divides telemetry by zero")
    _require(e.ramp_s >= 0.0, e, "ramp_s must be >= 0")
    _require(e.until is None or e.until > e.t + e.ramp_s, e,
             "until must come after the derate has fully applied "
             "(t + ramp_s)")


FAULT_EVENT_BUILDERS: Dict[str, type] = {
    "row-crash": RowCrash,
    "row-revive": RowRevive,
    "node-derate": NodeDerate,
    "site-demand-response": SiteDemandResponse,
}


@dataclass(frozen=True)
class FaultSpec:
    """An ordered, serializable fault timeline (``Scenario.faults``).

    Structural validity is checked at construction; run-shape validity
    (durations, row indices, node names) in :meth:`validate`, which the
    fleet builder calls before the simulation starts. An empty spec is a
    guaranteed no-op: the fleet driver skips the injector entirely, so a
    ``chaos-*`` scenario with ``FaultSpec()`` is bit-identical to its
    fault-free counterpart (tier-1-asserted)."""

    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        events = tuple(e if isinstance(e, FaultEvent) else FaultEvent(**e)
                       for e in self.events)
        object.__setattr__(self, "events", events)
        import math
        for e in events:
            try:
                builder = FAULT_EVENT_BUILDERS[e.kind]
            except KeyError:
                known = ", ".join(sorted(FAULT_EVENT_BUILDERS))
                raise ValueError(
                    f"invalid fault event {e!r}: unknown kind {e.kind!r} "
                    f"(registered: {known})") from None
            _require(math.isfinite(e.t) and e.t >= 0.0, e,
                     "t must be a non-negative time")
            builder.check(e)

    # -- views ---------------------------------------------------------------
    @property
    def is_noop(self) -> bool:
        return not self.events

    def routing_only(self) -> "FaultSpec":
        """The row-crash/row-revive subset. Uncapped reference twins carry
        exactly this: a crash is an environmental capacity loss both runs
        must see (so SLO diffs isolate power management), while budget
        derates *are* power management and never touch a reference."""
        return FaultSpec(tuple(e for e in self.events if e.kind in _ROW_KINDS))

    def budget_events(self) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.kind in _BUDGET_KINDS)

    def row_events(self) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.kind in _ROW_KINDS)

    # -- run-shape validation ------------------------------------------------
    def validate(self, *, duration_s: float, n_rows: int,
                 node_names: Optional[Sequence[str]] = None) -> None:
        """Check the timeline against a concrete run, raising ``ValueError``
        naming the offending event. Called at fleet-build time — before any
        event is simulated — so a bad timeline never surfaces as a mid-run
        ``RuntimeError`` from ``inject()``."""
        names = set(node_names) if node_names is not None else None
        for e in self.events:
            _require(e.t <= duration_s, e,
                     f"event time is beyond the trace duration "
                     f"({duration_s:g} s)")
            _require(e.t + e.ramp_s <= duration_s, e,
                     f"ramp ends beyond the trace duration ({duration_s:g} s)")
            _require(e.until is None or e.until <= duration_s, e,
                     f"restore time is beyond the trace duration "
                     f"({duration_s:g} s)")
            if e.kind in _ROW_KINDS:
                _require(0 <= int(e.row) < n_rows, e,
                         f"row index out of range for a {n_rows}-row fleet")
            elif e.kind == "node-derate" and names is not None:
                _require(e.node in names, e,
                         f"no hierarchy node named {e.node!r} "
                         f"(known: {sorted(names)})")

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d) -> "FaultSpec":
        if isinstance(d, FaultSpec):
            return d
        events: Iterable = d.get("events", ()) if isinstance(d, dict) else d
        return cls(tuple(FaultEvent(**e) if isinstance(e, dict) else e
                         for e in events))
