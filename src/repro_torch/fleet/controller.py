"""Dynamic fleet power-rebalancing: move budget slack to where load lands
(port of ``repro.fleet.controller``, copied in full).

Static per-row budgets strand headroom: in the derated-row ``fleet-*``
scenarios one row runs against a 30%-smaller envelope while its neighbors
hold slack they never use, so the derated row powerbrakes at load points the
rack as a whole could absorb. :class:`FleetController` closes that gap — it
runs on the same telemetry-grid lockstep as the rack managers and
periodically re-divides a *fixed* power envelope across the budget tree
(:class:`~repro_torch.core.hierarchy.PowerHierarchy`): per rack, per cluster, or —
``scope="tree"`` — recursively at every interior node, so a site re-divides
across PDU sets, PDU sets across racks, and racks across rows, reaching
headroom stranded on a sibling *rack*, not just a sibling row. Conservation
is structural: every division re-normalizes the new budgets to its node's
envelope and asserts the sums match (tier-1-asserted every rebalance tick,
per node).

Rebalance policies are registered by name so
:class:`~repro_torch.experiments.scenario.ControllerSpec` stays JSON-serializable:

  | policy       | target budgets                                          |
  | static       | never moves a watt (bit-identical to controller-less    |
  |              | fleets — asserted in tests and the benchmark)           |
  | proportional | envelope split proportional to measured row power       |
  | predictive   | envelope split proportional to *forecast* row power     |
  |              | over the 40 s OOB horizon (the same slope extrapolation |
  |              | ``PredictivePolcaPolicy`` caps on), so budget arrives   |
  |              | before the demand does                                  |

The forecast comes from a shared :class:`PowerForecaster` the fleet driver
feeds once per telemetry tick; the forecast-aware router
(:class:`~repro_torch.fleet.router.ForecastAwareRouter`) consumes the same
per-row forecasts, closing the loop from the other side: the controller
moves budget toward predicted demand while the router steers marginal load
away from rows predicted to cross their (possibly just-rebalanced) budget.

Actuation semantics mirror the real control plane: new budgets take effect
at the *next* row telemetry sample (the rebalance lands between grid ticks),
and a row's POLCA policy sees the change only through its own
``power_frac`` — no policy state is touched, so hysteresis and escalation
counters survive rebalances unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.obs.metrics import get_recorder
from repro_torch.obs.stream import OOB_HORIZON_S

CONSERVATION_ATOL = 1e-6  # watts; rebalances re-normalize exactly


@dataclass(frozen=True)
class RebalanceEvent:
    """One applied rebalance: when, and the per-row budgets before/after.
    ``demand_w`` is the signal the policy split the envelope by (measured or
    forecast row power). Under ``scope="tree"`` the full per-node budget
    vectors (leaves first, root last — see
    :class:`~repro_torch.core.hierarchy.PowerHierarchy`) are carried too, so
    interior budget motion (a site re-dividing across racks) is auditable
    next to the power series; they are ``None`` for the flat scopes.
    Carried in ``FleetResult.rebalances``."""

    t: float
    budgets_before_w: np.ndarray  # [R]
    budgets_after_w: np.ndarray  # [R]
    demand_w: np.ndarray  # [R]
    policy: str
    node_budgets_before_w: Optional[np.ndarray] = None  # [N] (tree scope)
    node_budgets_after_w: Optional[np.ndarray] = None  # [N] (tree scope)

    def moved_w(self) -> float:
        """Total watts that changed hands between rows (half the L1 delta)."""
        return float(np.abs(self.budgets_after_w - self.budgets_before_w).sum() / 2.0)


class PowerForecaster:
    """Per-row power forecast over the OOB horizon, shared by the predictive
    rebalance policy and the forecast-aware router.

    Maintains a sliding window of telemetry-grid samples per row and
    extrapolates each row's least-squares slope ``horizon_s`` ahead — the
    same estimator :class:`~repro_torch.core.policy.PredictivePolcaPolicy` uses for
    predictive capping, vectorized over rows. Forecasts are clamped from
    below at the current measurement (a falling trend never *frees* budget
    early; rising trends claim it early), matching the policy's
    cap-early-never-uncap-early asymmetry. The default horizon is the
    shared :data:`~repro_torch.obs.stream.OOB_HORIZON_S` constant, so the
    controller's forecast and the alerting stream's EWMA projection
    (:class:`~repro_torch.obs.stream.EwmaSlope`) always reason about the same
    future instant.
    """

    def __init__(self, n_rows: int, *,
                 horizon_s: float = OOB_HORIZON_S, window: int = 8):
        self.horizon_s = float(horizon_s)
        self.window = int(window)
        self._t: List[float] = []
        self._w: List[np.ndarray] = []  # each [R]
        self._n_rows = n_rows

    def observe(self, t: float, row_w: np.ndarray) -> None:
        """Feed one telemetry-grid sample of per-row watts."""
        self._t.append(float(t))
        self._w.append(np.asarray(row_w, float).copy())
        if len(self._t) > self.window:
            del self._t[0]
            del self._w[0]

    def forecast_w(self) -> np.ndarray:
        """Predicted per-row watts ``horizon_s`` after the latest sample,
        ``max(current, extrapolated)`` per row. With < 3 samples the forecast
        is the latest measurement (no trend yet)."""
        if not self._w:
            return np.zeros(self._n_rows)
        cur = self._w[-1]
        if len(self._t) < 3:
            return cur.copy()
        t = np.asarray(self._t)
        w = np.stack(self._w)  # [S, R]
        dt = t - t.mean()
        den = float((dt * dt).sum())
        if den <= 0.0:
            return cur.copy()
        slope = (dt[:, None] * (w - w.mean(axis=0))).sum(axis=0) / den  # [R]
        return np.maximum(cur, cur + slope * self.horizon_s)


class RebalancePolicy:
    """Protocol: ``target_budgets(demand_w, budgets_w, envelope_w) ->
    targets | None`` for one scope group (a rack, or the whole cluster).
    ``None`` means "leave this group alone"; targets need not sum to the
    envelope — the controller floors, smooths, and re-normalizes them.
    ``needs_forecast`` declares whether ``demand_w`` should be the
    forecaster's prediction instead of the measured row power."""

    name: str = "rebalance"
    needs_forecast: bool = False

    def target_budgets(self, demand_w: np.ndarray, budgets_w: np.ndarray,
                       envelope_w: float) -> Optional[np.ndarray]:
        raise NotImplementedError


@dataclass
class StaticBudgetPolicy(RebalancePolicy):
    """Today's behavior: budgets stay exactly where provisioning put them.
    A static-controller fleet is bit-identical to a controller-less fleet
    (asserted in tier-1 and the benchmark parity row) — this is the seam
    that makes the controller a safe default-off feature."""

    name: str = "static"

    def target_budgets(self, demand_w, budgets_w, envelope_w):
        return None


@dataclass
class ProportionalDemandPolicy(RebalancePolicy):
    """Split the envelope proportional to measured row power. Reactive: it
    moves budget *after* demand has landed, so a fast-rising row can still
    spend the 40 s OOB window capped (or braked) before relief arrives —
    the gap the predictive policy closes."""

    name: str = "proportional"

    def target_budgets(self, demand_w, budgets_w, envelope_w):
        total = float(demand_w.sum())
        if total <= 0.0:
            return None
        return envelope_w * demand_w / total


@dataclass
class PredictiveRebalancePolicy(RebalancePolicy):
    """Split the envelope proportional to *forecast* row power over the OOB
    horizon (``PowerForecaster``): budget moves toward where demand is
    heading, so it lands before the row's POLCA policy would have had to
    cap — the fleet-level twin of ``PredictivePolcaPolicy``'s predictive
    capping."""

    name: str = "predictive"
    needs_forecast: bool = True

    def target_budgets(self, demand_w, budgets_w, envelope_w):
        total = float(demand_w.sum())
        if total <= 0.0:
            return None
        return envelope_w * demand_w / total


class FleetController:
    """Periodically re-divide a power envelope across the budget hierarchy.

    Bound to a :class:`~repro_torch.core.hierarchy.PowerHierarchy` by the fleet
    driver; every ``interval_s`` it asks the policy for target budgets and
    applies the floored, low-passed, exactly-re-normalized result. Three
    scopes:

    * ``scope="rack"`` — each leaf-parent ("rack") node's rows share that
      node's frozen envelope (the classic per-rack rebalance);
    * ``scope="cluster"`` — all rows share the root envelope in one flat
      pool, ignoring interior budgets;
    * ``scope="tree"`` — the policy runs **recursively at every interior
      node**, top-down: the site re-divides its envelope across PDU sets,
      each PDU set across its racks, each rack across its rows — so
      headroom stranded on a sibling *rack* (not just a sibling row) flows
      to where demand is. Only the root envelope is frozen; interior node
      budgets move (committed back into ``hierarchy.node_budget_w``, so
      published group fractions track the budgets in force). A node's
      demand is the sum of its descendant rows' demand.

    Every division floors children at ``min_share`` of the node's equal
    split (a starved row still draws idle power — a zero budget would
    powerbrake it instantly), low-passes the step with ``alpha`` (full jumps
    oscillate against the 40 s actuation delay, the same failure mode strict
    cap-avoidance routing has), and re-normalizes exactly to the node's
    envelope. Conservation — children sums equal to each node's envelope —
    is asserted on every applied rebalance, per node.
    """

    def __init__(self, policy: RebalancePolicy, *, interval_s: float = 60.0,
                 scope: str = "rack", alpha: float = 0.5,
                 min_share: float = 0.5, deadband_w: float = 1.0):
        if scope not in ("rack", "cluster", "tree"):
            raise ValueError(
                f"scope must be 'rack', 'cluster', or 'tree', got {scope!r}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if not 0.0 < min_share < 1.0:
            # a zero floor lets a zero-demand row's budget reach 0 W, which
            # divides its next telemetry sample by zero
            raise ValueError(f"min_share must be in (0, 1), got {min_share}")
        self.policy = policy
        self.interval_s = float(interval_s)
        self.scope = scope
        self.alpha = float(alpha)
        self.min_share = float(min_share)
        self.deadband_w = float(deadband_w)
        self.events: List[RebalanceEvent] = []
        self._hierarchy = None
        self._groups: List[np.ndarray] = []  # row-index arrays per scope group
        self._group_nodes: List[int] = []  # hierarchy node owning each group
        self._next_t: Optional[float] = None

    @property
    def needs_forecast(self) -> bool:
        return self.policy.needs_forecast

    def bind(self, hierarchy) -> None:
        """Attach the fleet's budget hierarchy (a
        :class:`~repro_torch.core.hierarchy.PowerHierarchy`; called by
        FleetSimulator). Scope groups are fixed here, but each group's
        envelope is read *live* from its owning node's budget on every pass:
        rebalancing never changes those budgets under a flat scope (so this
        is bit-identical to the old frozen-at-bind envelopes on healthy
        fleets, tier-1-asserted), but a chaos-engine derate does — the
        controller must re-divide the watts actually deliverable *now*, not
        the watts provisioning promised. Under ``scope="tree"`` only the
        root envelope is read; interior envelopes are re-divided
        recursively. Binding resets the controller's schedule and event
        log, so one controller instance reused across fleets starts each
        run fresh."""
        self._next_t = None
        self.events = []
        self._hierarchy = hierarchy
        if self.scope == "rack":
            self._groups = [hierarchy.subtree_leaves(p)
                            for p in hierarchy.leaf_parents]
            self._group_nodes = [int(p) for p in hierarchy.leaf_parents]
        elif self.scope == "cluster":
            self._groups = [np.arange(hierarchy.n_leaves)]
            self._group_nodes = [hierarchy.root]
        else:  # tree: recursion walks the hierarchy itself
            self._groups = []
            self._group_nodes = []

    def _settle(self, target: np.ndarray, before_g: np.ndarray,
                envelope: float,
                caps: Optional[np.ndarray] = None) -> np.ndarray:
        """Floor, low-pass, and exactly re-normalize one division of
        ``envelope`` across a sibling group (rows of a rack, racks of a PDU
        set, ...). ``caps`` are the group's physical capacity ceilings
        (``PowerHierarchy.node_cap_w``, +inf when healthy): a chaos-derated
        member never receives more than its hardware can deliver, and the
        clipped watts go to siblings with headroom instead. Conservation
        against the envelope is asserted here, so every node division in
        every scope is checked; only a group capped *in its entirety* below
        the envelope may fall short (the shortfall is physically stranded —
        simultaneous sibling derates — and shows up in
        ``conservation_errors``)."""
        n = len(before_g)
        floor = self.min_share * envelope / n
        stepped = before_g + self.alpha * (np.maximum(target, floor)
                                           - before_g)
        stepped = np.maximum(stepped, floor)
        # exact conservation: scale the above-floor slack to the envelope
        slack = stepped - floor
        total_slack = float(slack.sum())
        budget_slack = envelope - floor * n
        if total_slack > 0.0:
            new = floor + slack * (budget_slack / total_slack)
        else:
            new = np.full(n, envelope / n)
        if caps is not None and bool(np.any(new > caps)):
            new = self._clamp_to_caps(new, np.asarray(caps, float),
                                      envelope, floor)
        total = float(new.sum())
        assert total <= envelope + CONSERVATION_ATOL, \
            (f"rebalance broke conservation: group sum {total:.6f} "
             f"> envelope {envelope:.6f}")
        assert (total >= envelope - CONSERVATION_ATOL
                or (caps is not None
                    and bool(np.all(new >= caps - CONSERVATION_ATOL)))), \
            (f"rebalance broke conservation: group sum {total:.6f} != "
             f"envelope {envelope:.6f} with capacity headroom left")
        get_recorder().counter("controller_conservation_checks_total")
        return new

    @staticmethod
    def _clamp_to_caps(new: np.ndarray, caps: np.ndarray, envelope: float,
                       floor: float) -> np.ndarray:
        """Clip each member to its capacity cap and hand the clipped watts
        to siblings with headroom (proportional to remaining headroom, or to
        current size among uncapped members), iterating to a fixed point —
        each round pins at least one more member at its cap, so the loop is
        bounded by the group size."""
        new = np.minimum(new, caps)
        for _ in range(len(new)):
            deficit = envelope - float(new.sum())
            if deficit <= CONSERVATION_ATOL:
                break
            head = caps - new
            open_ = head > CONSERVATION_ATOL
            if not bool(open_.any()):
                break  # every member pinned at a finite cap: watts stranded
            if bool(np.isinf(head[open_]).any()):
                weight = np.where(np.isinf(head), np.maximum(new, floor), 0.0)
            else:
                weight = np.where(open_, head, 0.0)
            new = np.minimum(new + deficit * weight / float(weight.sum()),
                             caps)
        return new

    def _tree_divide(self, demand_leaf: np.ndarray,
                     before_leaf: np.ndarray) -> Optional[np.ndarray]:
        """One recursive top-down pass over every interior node: each node
        re-divides its envelope across its children, the root's envelope
        frozen, every child's new budget becoming the envelope its own
        division runs under. Returns the full ``[N]`` post-pass node budget
        vector, or None when the policy declined to move anything."""
        h = self._hierarchy
        node_demand = h.node_w(demand_leaf)
        cur = h.node_budget_w.copy()
        cur[:h.n_leaves] = before_leaf
        node_after = cur.copy()
        any_target = False
        # parents always carry higher indices than their children, so a
        # descending walk over the interior nodes is exactly top-down
        for i in range(h.n_nodes - 1, h.n_leaves - 1, -1):
            kids = h.children[i]
            envelope = float(node_after[i])
            if len(kids) < 2:
                # an only child inherits it all, up to its capacity cap
                node_after[kids] = np.minimum(envelope, h.node_cap_w[kids])
                continue
            target = self.policy.target_budgets(node_demand[kids], cur[kids],
                                                envelope)
            if target is not None:
                any_target = True
            elif envelope == float(cur[kids].sum()):
                continue  # nothing moved here or above: keep shares exactly
            else:
                target = cur[kids]  # rescale shares to the moved envelope
            node_after[kids] = self._settle(np.asarray(target, float),
                                            cur[kids], envelope,
                                            caps=h.node_cap_w[kids])
        return node_after if any_target else None

    def maybe_rebalance(self, t: float, rows, row_w: np.ndarray,
                        forecast_w: Optional[np.ndarray]) -> Optional[RebalanceEvent]:
        """One controller tick. Returns the applied :class:`RebalanceEvent`,
        or None when the interval hasn't elapsed or no budget moved."""
        if self._hierarchy is None:
            raise RuntimeError("FleetController.maybe_rebalance before bind()")
        if self._next_t is None:
            self._next_t = t + self.interval_s  # first interval measures
            return None
        if t < self._next_t:
            return None
        self._next_t += self.interval_s
        demand = forecast_w if (self.policy.needs_forecast
                                and forecast_w is not None) else row_w
        h = self._hierarchy
        before = np.asarray([r.provisioned_w for r in rows], float)
        node_before = node_after = None
        if self.scope == "tree":
            node_after = self._tree_divide(demand, before)
            if node_after is None:
                return None
            node_before = h.node_budget_w.copy()
            node_before[:h.n_leaves] = before
            after = node_after[:h.n_leaves].copy()
        else:
            after = before.copy()
            for idx, node in zip(self._groups, self._group_nodes):
                if len(idx) < 2:
                    continue  # a one-row group has nothing to trade
                # live envelope: flat scopes never move interior budgets,
                # but a chaos-engine derate does — divide what the node can
                # actually deliver now
                envelope = float(h.node_budget_w[node])
                target = self.policy.target_budgets(demand[idx], before[idx],
                                                    envelope)
                if target is None:
                    continue
                after[idx] = self._settle(target, before[idx], envelope,
                                          caps=h.node_cap_w[idx])
        moved_w = float(np.abs(after - before).sum()) / 2.0
        if moved_w <= self.deadband_w:
            return None
        for r, b in zip(rows, after):
            if b != r.provisioned_w:
                r.set_budget(float(b), t)
        # commit the new budgets into the hierarchy so published group
        # fractions (and the next pass) see the budgets actually in force
        if node_after is not None:
            h.node_budget_w[:] = node_after
        else:
            h.node_budget_w[:h.n_leaves] = after
        ev = RebalanceEvent(t=t, budgets_before_w=before, budgets_after_w=after,
                            demand_w=np.asarray(demand, float).copy(),
                            policy=self.policy.name,
                            node_budgets_before_w=node_before,
                            node_budgets_after_w=node_after)
        self.events.append(ev)
        rec = get_recorder()
        if rec.enabled:
            rec.counter("controller_rebalance_total",
                        policy=self.policy.name, scope=self.scope)
            rec.observe("controller_moved_watts", moved_w)
            rec.event("controller", "rebalance", t=t,
                      policy=self.policy.name, scope=self.scope,
                      moved_w=round(moved_w, 6))
            # per-node budget deltas: the post-rebalance budget in force at
            # every named node (leaves carry row budgets; under tree scope
            # the interior nodes move too)
            names = h.names
            node_b = node_after if node_after is not None else None
            if node_b is None:
                node_b = h.node_budget_w
            for name, b in zip(names, node_b):
                rec.gauge("controller_node_budget_w", float(b), node=name)
        return ev


# ---------------------------------------------------------------------------
# registry (ControllerSpec round-trips through these by name)
# ---------------------------------------------------------------------------

REBALANCE_BUILDERS: Dict[str, Callable[..., RebalancePolicy]] = {
    "static": StaticBudgetPolicy,
    "proportional": ProportionalDemandPolicy,
    "predictive": PredictiveRebalancePolicy,
}


def build_rebalance_policy(kind: str, params: Dict[str, Any] = None) -> RebalancePolicy:
    """A fresh rebalance policy instance by registry name."""
    try:
        builder = REBALANCE_BUILDERS[kind]
    except KeyError:
        known = ", ".join(sorted(REBALANCE_BUILDERS))
        raise KeyError(
            f"unknown rebalance policy {kind!r}; registered: {known}") from None
    return builder(**(params or {}))


def build_controller(spec) -> FleetController:
    """A :class:`FleetController` from a serializable
    :class:`~repro_torch.experiments.scenario.ControllerSpec`."""
    return FleetController(
        build_rebalance_policy(spec.kind, spec.params),
        interval_s=spec.interval_s, scope=spec.scope,
        alpha=spec.alpha, min_share=spec.min_share,
        deadband_w=spec.deadband_w)
