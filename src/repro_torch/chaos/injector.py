"""Runtime fault application: the ChaosInjector rides the fleet lockstep
(port of ``repro.chaos.injector``, copied in full).

``FleetSimulator`` polls its injector once per telemetry tick, *after* the
controller's rebalance pass, so fault actuation has exactly the same
between-ticks semantics as a ``scope="tree"`` rebalance commit: budgets
change on the tick boundary, and the next row telemetry sample (and every
policy, router, admission controller, and forecaster downstream) observes
the fault-perturbed state with no special cases — the point of the chaos
engine is to ask whether the *unchanged* control plane recovers.

Three primitives implement the four registered event kinds:

* **fence/unfence** (``row-crash`` / ``row-revive``): flips the fleet's
  ``row_alive`` mask. The dispatcher routes new arrivals around dead rows
  (shedding when none are left); the crashed row's in-flight work drains
  naturally, and revival re-enters through ``RowSimulator.inject()`` —
  which already clears the drained-past-end state.
* **derate** (``node-derate`` / ``site-demand-response``): multiplies the
  target node's budget by ``g``, scaling its whole subtree uniformly
  (leaf budgets commit through ``RowSimulator.set_budget`` exactly like a
  rebalance) and subtracting the removed watts from every ancestor, so
  `conservation_errors` stays empty at every node. The node's physical
  capacity cap (``PowerHierarchy.node_cap_w``) drops with it, which is
  what stops a tree-scope controller from "healing" the fault by
  re-growing the derated subtree on its next pass. Ramps apply the same
  primitive incrementally on each tick until the target factor is reached.
* **restore**: returns the exact watts each event removed (tracked per
  event, summed over ramp steps) to the node's subtree and ancestors, so
  the root envelope round-trips even if a controller re-divided budgets
  while the fault was active.

Every *phase transition* (crash, revive, derate fully applied, restore)
appends a :class:`FaultRecord` with full before/after budget vectors to
``FleetResult.fault_events`` — the audit log the resilience benchmark and
tier-1 tests assert on. Per-tick ramp increments do not spam the log; the
apply record carries the pre-ramp snapshot.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.chaos.faults import FaultEvent, FaultSpec
from repro_torch.obs.metrics import get_recorder

_CUM_ATOL = 1e-12


@dataclass(frozen=True, eq=False)
class FaultRecord:
    """One applied fault phase in the ``FleetResult.fault_events`` audit
    log: what happened, to which target, at which telemetry tick, and the
    full node-budget vector immediately before and after."""

    t: float
    kind: str
    target: str
    phase: str  # "apply" | "restore"
    factor: float
    node_budgets_before_w: np.ndarray = field(repr=False)
    node_budgets_after_w: np.ndarray = field(repr=False)
    detail: str = ""

    def __eq__(self, other) -> bool:
        # dataclass eq would ambiguously compare the budget arrays
        if not isinstance(other, FaultRecord):
            return NotImplemented
        return ((self.t, self.kind, self.target, self.phase, self.factor,
                 self.detail)
                == (other.t, other.kind, other.target, other.phase,
                    other.factor, other.detail)
                and np.array_equal(self.node_budgets_before_w,
                                   other.node_budgets_before_w)
                and np.array_equal(self.node_budgets_after_w,
                                   other.node_budgets_after_w))


class _DerateState:
    """Mutable runtime state for one budget event: cumulative applied
    factor (1.0 → event.factor during a ramp) and the net watts removed
    from the target node, which the restore hands back."""

    def __init__(self, event: FaultEvent, node: int):
        self.event = event
        self.node = node
        self.cum = 1.0
        self.applied_delta_w = 0.0
        self.before: Optional[np.ndarray] = None
        self.done = False
        self.restored = False


class ChaosInjector:
    """Applies a :class:`FaultSpec` to a running ``FleetSimulator``.

    One injector drives one fleet: ``bind()`` (called by the fleet's
    constructor) validates the timeline against the concrete run and
    resets all runtime state, then ``poll(t, fleet)`` fires on every
    telemetry tick. Build a fresh injector per fleet (``build_fleet``
    does) — Monte-Carlo members must not share actuation state.
    """

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.records: List[FaultRecord] = []
        self._bound = False

    # -- lifecycle -----------------------------------------------------------
    def bind(self, fleet) -> None:
        """Validate the timeline against the fleet and compile the event
        schedule. Raises ``ValueError`` naming any event that falls beyond
        the trace, targets a missing row, or names an unknown node."""
        h = fleet.hierarchy
        self.spec.validate(duration_s=fleet.duration, n_rows=len(fleet.rows),
                           node_names=list(h.names))
        self.records = []
        self._base_budget_w = h.node_budget_w.copy()
        name_to_idx = {n: i for i, n in enumerate(h.names)}
        self._row_events = sorted(self.spec.row_events(), key=lambda e: e.t)
        self._row_next = 0
        self._derates: List[_DerateState] = []
        for e in self.spec.budget_events():
            node = h.root if e.node is None else name_to_idx[e.node]
            self._derates.append(_DerateState(e, node))
        self._ancestors: Dict[int, List[int]] = {}
        self._subtree: Dict[int, np.ndarray] = {}
        for d in self._derates:
            if d.node not in self._subtree:
                self._ancestors[d.node] = self._node_ancestors(h, d.node)
                self._subtree[d.node] = self._subtree_nodes(h, d.node)
        self._bound = True

    @staticmethod
    def _node_ancestors(h, node: int) -> List[int]:
        out, p = [], int(h.parent[node])
        while p >= 0:
            out.append(p)
            p = int(h.parent[p])
        return out

    @staticmethod
    def _subtree_nodes(h, node: int) -> np.ndarray:
        """All node indices under (and including) ``node`` — interior and
        leaf — found by a children-walk."""
        out, stack = [], [node]
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(int(c) for c in h.children[n])
        return np.asarray(sorted(out), dtype=np.int64)

    # -- tick hook -----------------------------------------------------------
    def poll(self, t: float, fleet) -> None:
        """Apply every event scheduled at or before ``t``. Runs between
        telemetry ticks (after the controller's rebalance pass), so budget
        changes land with rebalance actuation semantics."""
        assert self._bound, "ChaosInjector.poll before bind"
        h = fleet.hierarchy
        while (self._row_next < len(self._row_events)
               and self._row_events[self._row_next].t <= t):
            e = self._row_events[self._row_next]
            self._row_next += 1
            before = h.node_budget_w.copy()
            fleet.set_row_alive(int(e.row), e.kind == "row-revive")
            self.records.append(FaultRecord(
                t=t, kind=e.kind, target=h.names[int(e.row)], phase="apply",
                factor=1.0, node_budgets_before_w=before,
                node_budgets_after_w=h.node_budget_w.copy(),
                detail=f"scheduled t={e.t:g}s"))
            self._record_transition(t, e.kind, h.names[int(e.row)], "apply",
                                    e.t)
        for d in self._derates:
            self._poll_derate(d, t, fleet)

    def _poll_derate(self, d: _DerateState, t: float, fleet) -> None:
        h = fleet.hierarchy
        e = d.event
        if not d.done and t >= e.t:
            if d.before is None:
                d.before = h.node_budget_w.copy()
            frac = 1.0 if e.ramp_s <= 0.0 else min(1.0, (t - e.t) / e.ramp_s)
            f_t = 1.0 + (e.factor - 1.0) * frac
            if f_t < d.cum - _CUM_ATOL:
                d.applied_delta_w += self._scale_subtree(
                    fleet, d.node, f_t / d.cum, t)
                d.cum = f_t
                self._update_cap(h, d.node)
            if d.cum <= e.factor + _CUM_ATOL:
                d.done = True
                self.records.append(FaultRecord(
                    t=t, kind=e.kind, target=h.names[d.node], phase="apply",
                    factor=e.factor, node_budgets_before_w=d.before,
                    node_budgets_after_w=h.node_budget_w.copy(),
                    detail=(f"-{d.applied_delta_w:.0f} W"
                            + (f" over {e.ramp_s:g}s ramp" if e.ramp_s else ""))))
                self._record_transition(t, e.kind, h.names[d.node], "apply",
                                        e.t)
        if d.done and not d.restored and e.until is not None and t >= e.until:
            before = h.node_budget_w.copy()
            self._restore(fleet, d, t)
            d.restored = True
            self._update_cap(h, d.node)
            self.records.append(FaultRecord(
                t=t, kind=e.kind, target=h.names[d.node], phase="restore",
                factor=e.factor, node_budgets_before_w=before,
                node_budgets_after_w=h.node_budget_w.copy(),
                detail=f"+{d.applied_delta_w:.0f} W returned"))
            self._record_transition(t, e.kind, h.names[d.node], "restore",
                                    e.until)

    def n_active_derates(self) -> int:
        """Budget derates currently in force: started (a ramp in progress
        counts) and not yet restored. Fenced rows are tracked by the
        fleet's ``row_alive`` mask, not here. Read-only — the fault-active
        alert rule polls this as its ground-truth signal."""
        return sum(1 for d in self._derates
                   if not d.restored
                   and (d.done or d.cum < 1.0 - _CUM_ATOL))

    @staticmethod
    def _record_transition(t: float, kind: str, target: str,
                           phase: str, t_sched: float) -> None:
        """Mirror a fault phase transition into the observability event
        trace — one event + counter per FaultRecord, write-only.
        ``t_sched`` is the timeline's scheduled time for this phase (the
        event's ``t``, or ``until`` for restores): incident reconstruction
        measures detection latency against it, since a ramped derate's
        apply record only lands when the ramp completes."""
        rec = get_recorder()
        if rec.enabled:
            rec.event("chaos",
                      "fault_apply" if phase == "apply" else "fault_restore",
                      t=t, fault=kind, target=target, phase=phase,
                      t_sched=round(t_sched, 6))
            rec.counter("chaos_fault_transitions_total",
                        kind=kind, phase=phase)

    # -- budget primitives ---------------------------------------------------
    def _scale_subtree(self, fleet, node: int, g: float, t: float) -> float:
        """Multiply ``node``'s budget (and its whole subtree, uniformly) by
        ``g``, committing leaf budgets through ``set_budget`` and removing
        the delta from every ancestor envelope. Returns the watts removed
        from ``node`` (negative g>1 deltas flow back on restore)."""
        h = fleet.hierarchy
        old = float(h.node_budget_w[node])
        h.node_budget_w[self._subtree[node]] *= g
        for li in h.subtree_leaves(node):
            fleet.rows[int(li)].set_budget(float(h.node_budget_w[int(li)]), t)
        delta = old - float(h.node_budget_w[node])
        for a in self._ancestors[node]:
            h.node_budget_w[a] -= delta
        return delta

    def _restore(self, fleet, d: _DerateState, t: float) -> None:
        """Give back exactly the watts this event removed: the subtree
        scales up so the target node regains ``applied_delta_w``, and every
        ancestor (root included) grows by the same amount — the site
        envelope round-trips even if a controller re-divided in between."""
        h = fleet.hierarchy
        cur = float(h.node_budget_w[d.node])
        g = (cur + d.applied_delta_w) / cur
        h.node_budget_w[self._subtree[d.node]] *= g
        for li in h.subtree_leaves(d.node):
            fleet.rows[int(li)].set_budget(float(h.node_budget_w[int(li)]), t)
        for a in self._ancestors[d.node]:
            h.node_budget_w[a] += d.applied_delta_w
        d.cum = 1.0

    def _update_cap(self, h, node: int) -> None:
        """Physical capacity cap = base budget x product of active derate
        factors on this node; lifted back to +inf once every event on the
        node has restored."""
        active = 1.0
        for d in self._derates:
            if d.node == node and not d.restored:
                active *= d.cum
        h.node_cap_w[node] = (self._base_budget_w[node] * active
                              if active < 1.0 - _CUM_ATOL else np.inf)
