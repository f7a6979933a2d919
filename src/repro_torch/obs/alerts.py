"""Online alerting over the fleet telemetry stream (port of
``repro.obs.alerts``, copied in full; DESIGN.md §15).

POLCA's deployment story is alert-driven mitigation: the control plane
watches cap proximity through a 40 s out-of-band telemetry path and reacts
before breakers do. This module is that alarm surface for the simulated
fleet: a registered, serializable rule family (:class:`AlertSpec`, carried
end-to-end on ``Scenario.alerts``) evaluated once per telemetry tick by an
:class:`AlertEngine` riding the fleet lockstep, against the streaming
window state of :class:`~repro_torch.obs.stream.FleetStream`.

Five rule kinds are registered (``ALERT_BUILDERS`` backs
docs/registries.md exactly like the policy/router/fault registries):

* ``cap-proximity`` — a node's power fraction crosses distinct engage /
  release thresholds (hysteresis, so a fraction oscillating on one
  threshold cannot flap); optionally evaluated on the EWMA-slope value
  *projected one OOB horizon ahead*, the streaming twin of the
  controller's ``PowerForecaster``;
* ``brake-storm`` — brake edges per sliding window exceed a rate floor;
* ``slo-burn`` — shed arrivals as a fraction of offered over a sliding
  window (burn-rate alerting on the shed budget);
* ``conservation-violation`` — an interior node's budget drifts from the
  sum of its children's (watchdog; should never engage in a healthy run);
* ``fault-active`` — the chaos engine has a fault in force (ground truth,
  for measuring detection latency of the telemetry-driven rules).

Every engage/release transition appends an :class:`AlertEvent` to the
engine's log (surfaced as ``FleetResult.alert_events``) and mirrors into
the observability recorder as paired ``alert_engage`` / ``alert_release``
events — write-only, RNG-free: the engine reads fleet state and never
writes any back, so alerts-on and alerts-off runs are bit-identical
(tier-1-asserted), exactly like the recorder's own contract.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.metrics import get_recorder
from repro_torch.obs.stream import OOB_HORIZON_S, FleetStream, SlidingCounter

#: target name for "the worst (maximum-fraction) node" in cap-proximity
ANY_NODE = "*"


@dataclass(frozen=True)
class AlertSpec:
    """One alert rule (JSON-serializable; ``Scenario.alerts`` carries a
    tuple of these). ``kind`` names an entry in ``ALERT_BUILDERS``;
    ``target`` scopes it — ``""`` is the root/site (or fleet-wide for rate
    rules), ``"*"`` the worst node, any other string a hierarchy node name
    (validated against the concrete run at bind time, like fault specs).

    Hysteresis: the rule engages after the signal holds at or above
    ``engage`` for ``for_ticks`` consecutive telemetry ticks, and releases
    after it holds *below* ``release`` for the same streak — ``engage >=
    release``, and the gap is the flap guard. ``window_s`` sizes the
    sliding window for rate rules (brake-storm, slo-burn). ``projected``
    (cap-proximity, root target only) evaluates the EWMA-slope projection
    one OOB actuation horizon (40 s) ahead instead of the instantaneous
    fraction."""

    kind: str
    target: str = ""
    engage: float = 1.0
    release: float = 0.9
    window_s: float = 60.0
    for_ticks: int = 1
    projected: bool = False
    name: str = ""

    def __post_init__(self):
        try:
            builder = ALERT_BUILDERS[self.kind]
        except KeyError:
            known = ", ".join(sorted(ALERT_BUILDERS))
            raise ValueError(
                f"invalid alert spec: unknown kind {self.kind!r} "
                f"(registered: {known})") from None
        if not self.name:
            auto = self.kind + (f":{self.target}" if self.target else "")
            object.__setattr__(self, "name", auto)
        _require(math.isfinite(self.engage) and math.isfinite(self.release),
                 self, "engage/release must be finite")
        _require(self.engage >= self.release, self,
                 "engage must be >= release (the hysteresis band)")
        _require(self.window_s > 0.0, self, "window_s must be positive")
        _require(int(self.for_ticks) >= 1, self, "for_ticks must be >= 1")
        builder.check(self)

    def describe(self) -> str:
        txt = (f"{self.kind}(target={self.target or '<root>'}, "
               f"engage={self.engage:g}, release={self.release:g}")
        if self.projected:
            txt += ", projected"
        return txt + ")"

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d) -> "AlertSpec":
        return d if isinstance(d, AlertSpec) else cls(**d)


def _require(cond: bool, spec, why: str) -> None:
    if not cond:
        what = spec.describe() if hasattr(spec, "describe") else repr(spec)
        raise ValueError(f"invalid alert spec {what}: {why}")


# ---------------------------------------------------------------------------
# registry: one marker class per rule kind — docstrings feed the registry
# reference (docs/registries.md), ``check`` the structural validation,
# exactly like FAULT_EVENT_BUILDERS.
# ---------------------------------------------------------------------------

class CapProximity:
    """A node's power fraction crosses engage/release thresholds with hysteresis; target a node name, the root (``""``), or the worst node (``"*"``) — optionally on the 40 s OOB-horizon EWMA projection instead of the instantaneous value."""

    @staticmethod
    def check(spec: AlertSpec) -> None:
        _require(spec.engage > 0.0, spec,
                 "cap-proximity engage must be a positive power fraction")
        _require(not spec.projected or spec.target == "", spec,
                 "projected cap-proximity tracks the root slope only — "
                 "use target=\"\"")


class BrakeStorm:
    """Brake edges (engage or release, any row) per sliding window exceed a rate floor — the thrash detector for controllers fighting their own actuation delay."""

    @staticmethod
    def check(spec: AlertSpec) -> None:
        _require(spec.target == "", spec,
                 "brake-storm is fleet-wide; leave target empty")
        _require(spec.release >= 0.0, spec,
                 "brake-storm thresholds are edge counts, must be >= 0")


class SloBurn:
    """Shed arrivals as a fraction of offered arrivals over a sliding window — burn-rate alerting on the shed budget (engages only once real traffic was offered in the window)."""

    @staticmethod
    def check(spec: AlertSpec) -> None:
        _require(spec.target == "", spec,
                 "slo-burn is fleet-wide; leave target empty")
        _require(0.0 <= spec.release and spec.engage <= 1.0, spec,
                 "slo-burn thresholds are shed fractions in [0, 1]")


class ConservationViolation:
    """An interior node's budget drifts from the sum of its children's by more than ``engage`` watts — the invariant watchdog (a healthy run never engages it; chaos derates and rebalances both preserve conservation)."""

    @staticmethod
    def check(spec: AlertSpec) -> None:
        _require(spec.target != ANY_NODE, spec,
                 "conservation-violation targets a node name or \"\" "
                 "(= every interior node)")
        _require(spec.engage > 0.0, spec,
                 "engage is a watts tolerance, must be positive")


class FaultActive:
    """The chaos engine has a fault in force (a fenced row, or a derate applied and not yet restored) — ground truth, the yardstick detection latency of the telemetry-driven rules is measured against."""

    @staticmethod
    def check(spec: AlertSpec) -> None:
        _require(spec.target == "", spec,
                 "fault-active is fleet-wide; leave target empty")
        _require(spec.release >= 0.0, spec,
                 "fault-active thresholds are fault counts, must be >= 0")


ALERT_BUILDERS: Dict[str, type] = {
    "cap-proximity": CapProximity,
    "brake-storm": BrakeStorm,
    "slo-burn": SloBurn,
    "conservation-violation": ConservationViolation,
    "fault-active": FaultActive,
}


def coerce_alerts(alerts) -> Optional[Tuple[AlertSpec, ...]]:
    """Normalize ``Scenario.alerts`` input: None stays None; an iterable of
    AlertSpec / dicts becomes a tuple of AlertSpec."""
    if alerts is None:
        return None
    return tuple(AlertSpec.from_dict(a) for a in alerts)


def default_alert_pack() -> Tuple[AlertSpec, ...]:
    """The standing rule set the ``chaos-*`` scenarios carry: cap
    proximity on the fault-domain PDU, the worst node, and the projected
    site envelope; a brake-storm rate floor; slo-burn on shed traffic; the
    conservation watchdog; and the fault-active ground truth.

    Thresholds are tuned to the chaos family's operating point (105 kW
    rows, (2, 2, 3) site — the ``pdu0`` target binds only on hierarchies
    that have one): healthy steady state never crosses them (zero false
    alarms on ``chaos-noop``, benchmark-gated: its interior nodes stay
    under 0.87 of budget, its brake-edge rate under 8/120 s), while the
    30% PDU derate crosses cap-proximity within one telemetry tick of
    landing (the fraction jumps past 1.0 on a step; a ramp is caught just
    before its apply record as the fraction passes 0.96)."""
    return (
        AlertSpec("cap-proximity", target="pdu0", engage=0.96,
                  release=0.90),
        AlertSpec("cap-proximity", target=ANY_NODE, engage=1.10,
                  release=1.02),
        AlertSpec("cap-proximity", target="", engage=0.92, release=0.85,
                  projected=True, name="cap-proximity:site-projected"),
        AlertSpec("brake-storm", engage=10.0, release=2.0, window_s=120.0),
        AlertSpec("slo-burn", engage=0.05, release=0.005, window_s=300.0),
        AlertSpec("conservation-violation", engage=1.0, release=0.5),
        AlertSpec("fault-active", engage=0.5, release=0.5),
    )


@dataclass(frozen=True)
class AlertEvent:
    """One engage/release transition in the engine's audit log
    (``FleetResult.alert_events``): when, which rule, which phase, the
    signal value that crossed, and the threshold it crossed."""

    t: float
    name: str
    kind: str
    target: str
    phase: str  # "engage" | "release"
    value: float
    threshold: float


class _RuleState:
    """Mutable runtime state for one rule: hysteresis streaks, active
    flag, resolved node index, any sliding counters it owns, and the
    integer opcode ``bind`` resolves for per-tick signal dispatch."""

    __slots__ = ("spec", "node", "active", "streak", "t_engaged",
                 "edges", "shed", "offered", "op")

    def __init__(self, spec: AlertSpec):
        self.spec = spec
        self.node: Optional[int] = None
        self.active = False
        self.streak = 0
        self.t_engaged = 0.0
        self.edges: Optional[SlidingCounter] = None
        self.shed: Optional[SlidingCounter] = None
        self.offered: Optional[SlidingCounter] = None
        self.op = -1


# signal opcodes, resolved once at bind so the per-tick dispatch is an
# integer compare chain instead of repeated string equality
_OP_CAP_NODE = 0
_OP_CAP_ANY = 1
_OP_CAP_PROJ = 2
_OP_BRAKE = 3
_OP_SLO = 4
_OP_CONS_NODE = 5
_OP_CONS_ALL = 6
_OP_FAULT = 7


class AlertEngine:
    """Evaluates a rule set once per fleet telemetry tick.

    One engine drives one fleet: the fleet constructor calls :meth:`bind`
    (validating node targets against the concrete hierarchy, like
    ``ChaosInjector.bind``), then :meth:`on_tick` fires after the
    controller and chaos passes with the tick's already-sampled telemetry.
    The engine computes node fractions from the same sampled vectors
    ``FleetResult.node_power_frac`` folds — via one precomputed
    descendant-aggregation matmul, so per-node values agree with the
    offline result arrays to float round-off (the default pack's
    thresholds sit orders of magnitude above that).

    Strictly read-only against the simulation: signals come from sampled
    arrays and read-only scans; output goes to :attr:`events` and the
    current recorder. No RNG, no writes into rows/hierarchy/router state.
    """

    def __init__(self, specs: Sequence[AlertSpec], *, tick_s: float,
                 horizon_s: float = OOB_HORIZON_S):
        self.specs: Tuple[AlertSpec, ...] = tuple(specs)
        names = [s.name for s in self.specs]
        dup = {n for n in names if names.count(n) > 1}
        if dup:
            raise ValueError(f"duplicate alert names: {sorted(dup)} — "
                             f"set AlertSpec.name to disambiguate")
        # rates + root slope only: per-node tumbling windows are a stream
        # feature no rule consumes, and the engine must stay cheap per tick
        self.stream = FleetStream(tick_s, horizon_s=horizon_s,
                                  window_nodes=())
        self.events: List[AlertEvent] = []
        self._rules = [_RuleState(s) for s in self.specs]
        self._bound = False
        # per-tick work gates, resolved at bind from the rule set
        self._need_cons = any(s.kind == "conservation-violation"
                              for s in self.specs)
        self._need_faults = any(s.kind == "fault-active" for s in self.specs)
        self._track_queues = False  # no registered rule reads queue ages yet
        self._child_mat: Optional[np.ndarray] = None
        self._cons_buf: Optional[np.ndarray] = None
        self._empty_errs = np.zeros(0)
        # bind() fills these: per-tick scratch buffers + the (nodes x
        # leaves) aggregation matrix (the engine runs once per telemetry
        # tick on the hot path — no per-tick allocations beyond what
        # numpy reductions need)
        self._agg: Optional[np.ndarray] = None
        self._budget_buf: Optional[np.ndarray] = None
        self._node_w_buf: Optional[np.ndarray] = None
        self._frac_buf: Optional[np.ndarray] = None

    @property
    def n_active(self) -> int:
        return sum(1 for r in self._rules if r.active)

    def bind(self, fleet) -> None:
        """Resolve node targets against the fleet's hierarchy and size the
        per-rule sliding windows. Raises ``ValueError`` naming any rule
        whose target is not a node of this run."""
        h = fleet.hierarchy
        name_to_idx = {n: i for i, n in enumerate(h.names)}
        for r in self._rules:
            s = r.spec
            if s.kind == "cap-proximity":
                if s.target == "":
                    r.node = h.root
                elif s.target != ANY_NODE:
                    if s.target not in name_to_idx:
                        raise ValueError(
                            f"alert {s.describe()}: no hierarchy node named "
                            f"{s.target!r} (known: {sorted(h.names)})")
                    r.node = name_to_idx[s.target]
            elif s.kind == "conservation-violation" and s.target:
                idx = name_to_idx.get(s.target)
                if idx is None or idx < h.n_leaves:
                    raise ValueError(
                        f"alert {s.describe()}: target must name an "
                        f"interior node of this run "
                        f"(interior: {sorted(h.names[h.n_leaves:])})")
                r.node = idx
            elif s.kind == "brake-storm":
                r.edges = self.stream.sliding("brake_edges", s.window_s)
            elif s.kind == "slo-burn":
                r.shed = self.stream.sliding("shed", s.window_s)
                r.offered = self.stream.sliding("offered", s.window_s)
        if self._need_cons:
            # one (interior x nodes) child-sum matrix: the per-tick
            # conservation check becomes a single small matmul
            n_int = h.n_nodes - h.n_leaves
            mat = np.zeros((n_int, h.n_nodes))
            for i in range(h.n_leaves, h.n_nodes):
                mat[i - h.n_leaves, h.children[i]] = 1.0
            self._child_mat = mat
            self._cons_buf = np.empty(n_int)
        # aggregation matrix + scratch: node watts = agg @ row watts (leaf
        # rows are an identity block, interiors sum their leaf
        # descendants). One matmul per tick replaces a Python loop of
        # per-node reductions; values agree with Hierarchy.fold_w to
        # float round-off.
        agg = np.zeros((h.n_nodes, h.n_leaves))
        agg[:h.n_leaves, :h.n_leaves] = np.eye(h.n_leaves)
        for i in range(h.n_leaves, h.n_nodes):
            agg[i, h.leaf_desc[i]] = 1.0
        self._agg = agg
        self._budget_buf = np.empty(h.n_nodes)
        self._node_w_buf = np.empty(h.n_nodes)
        self._frac_buf = np.empty(h.n_nodes)
        # double-buffered brake flags: the stream keeps a reference to the
        # previous tick's vector for edge detection, so alternate buffers
        self._braked_bufs = (np.empty(h.n_leaves, dtype=bool),
                             np.empty(h.n_leaves, dtype=bool))
        self._braked_flip = 0
        # resolve signal opcodes now that node targets are resolved
        for r in self._rules:
            s = r.spec
            if s.kind == "cap-proximity":
                r.op = (_OP_CAP_PROJ if s.projected
                        else _OP_CAP_ANY if r.node is None and
                        s.target == ANY_NODE else _OP_CAP_NODE)
            elif s.kind == "brake-storm":
                r.op = _OP_BRAKE
            elif s.kind == "slo-burn":
                r.op = _OP_SLO
            elif s.kind == "conservation-violation":
                r.op = _OP_CONS_NODE if r.node is not None else _OP_CONS_ALL
            else:
                r.op = _OP_FAULT
        self._bound = True

    # -- tick hook -----------------------------------------------------------
    def on_tick(self, t: float, fleet, row_w: np.ndarray,
                leaf_budget_w: np.ndarray,
                interior_budget_w: np.ndarray) -> None:
        """Fold this tick into the stream and evaluate every rule.

        ``row_w`` / ``leaf_budget_w`` / ``interior_budget_w`` are the
        arrays the fleet driver just sampled (pre-controller budgets — the
        same vectors ``finalize()`` measures fractions against), so the
        engine adds no pass over history and no new reads of mutable
        control-plane state beyond the chaos/brake flags it scans."""
        assert self._bound, "AlertEngine.on_tick before bind"
        h = fleet.hierarchy
        nl = h.n_leaves
        budget = self._budget_buf
        budget[:nl] = leaf_budget_w
        budget[nl:] = interior_budget_w
        # the per-tick fold FleetResult.node_power_frac records, as one
        # matmul into reused scratch (round-off-equivalent to fold_w)
        node_w = self._node_w_buf
        np.matmul(self._agg, row_w, out=node_w)
        node_frac = np.divide(node_w, budget, out=self._frac_buf)
        braked = self._braked_bufs[self._braked_flip]
        self._braked_flip ^= 1
        for j, row in enumerate(fleet.rows):
            braked[j] = getattr(row.policy, "braked", False)
        queue_depth, max_age = (_queue_state(fleet.rows, t)
                                if self._track_queues else (0, None))
        self.stream.observe(
            t, node_frac, braked,
            shed_total=sum(fleet.n_shed.values()),
            offered_total=fleet.n_processed,
            queue_depth=queue_depth, max_queue_age_s=max_age)
        if self._need_cons:
            cons_err = self._cons_buf
            np.matmul(self._child_mat, budget, out=cons_err)
            np.subtract(budget[nl:], cons_err, out=cons_err)
            np.abs(cons_err, out=cons_err)
        else:
            cons_err = self._empty_errs
        faults = _faults_in_force(fleet) if self._need_faults else 0
        for r in self._rules:
            v = self._signal(r, node_frac, cons_err, faults)
            self._step(r, t, v)

    def _signal(self, r: _RuleState, node_frac: np.ndarray,
                cons_err: np.ndarray, faults: int) -> float:
        op = r.op
        if op == _OP_CAP_NODE:
            return float(node_frac[r.node])
        if op == _OP_CAP_ANY:
            return float(node_frac.max())
        if op == _OP_CAP_PROJ:
            v = self.stream.projected_root_frac()
            return v if not math.isnan(v) else float(node_frac[-1])
        if op == _OP_BRAKE:
            return r.edges.total
        if op == _OP_SLO:
            offered = r.offered.total
            return r.shed.total / offered if offered > 0.0 else 0.0
        if op == _OP_CONS_NODE:
            h0 = len(node_frac) - len(cons_err)
            return float(cons_err[r.node - h0])
        if op == _OP_CONS_ALL:
            return float(cons_err.max()) if len(cons_err) else 0.0
        if op == _OP_FAULT:
            return float(faults)
        raise AssertionError(f"unreachable: {r.spec.kind}")  # bind-resolved

    def _step(self, r: _RuleState, t: float, v: float) -> None:
        s = r.spec
        if not r.active:
            r.streak = r.streak + 1 if v >= s.engage else 0
            if r.streak >= s.for_ticks:
                r.active, r.streak, r.t_engaged = True, 0, t
                self._emit(r, t, "engage", v, s.engage)
        else:
            r.streak = r.streak + 1 if v < s.release else 0
            if r.streak >= s.for_ticks:
                r.active, r.streak = False, 0
                self._emit(r, t, "release", v, s.release)

    def _emit(self, r: _RuleState, t: float, phase: str, v: float,
              threshold: float) -> None:
        s = r.spec
        self.events.append(AlertEvent(
            t=t, name=s.name, kind=s.kind, target=s.target, phase=phase,
            value=float(v), threshold=float(threshold)))
        rec = get_recorder()
        if rec.enabled:
            labels = dict(alert=s.name, rule=s.kind, target=s.target or "-",
                          value=round(float(v), 6),
                          threshold=round(float(threshold), 6))
            if phase == "release":
                labels["engaged_s"] = round(t - r.t_engaged, 6)
            rec.event("alert", f"alert_{phase}", t=t, **labels)
            rec.counter("alert_transitions_total", kind=s.kind, phase=phase)


def _queue_state(rows, t: float) -> Tuple[int, float]:
    """Total queued requests and the oldest queued request's age — a pure
    read over server pools (ages are relative to the tick time, so this
    scan is deterministic and run-order-free)."""
    depth, oldest = 0, 0.0
    for row in rows:
        for srv in row.servers:
            q = srv.queue
            if q:
                depth += len(q)
                age = t - q[0].t_arrival
                if age > oldest:
                    oldest = age
    return depth, oldest


def _faults_in_force(fleet) -> int:
    """Ground-truth active fault count: fenced rows plus chaos derates
    that have started (ramping counts) and not yet restored."""
    alive = fleet.row_alive
    n = alive.size - int(np.count_nonzero(alive))
    chaos = fleet.chaos
    if chaos is not None:
        n += chaos.n_active_derates()
    return n
