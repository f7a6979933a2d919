"""The port's chaos injector, streaming windows and alerting against the JAX
package's, and the planner's survivability gate.

``repro_torch.chaos.injector``, ``repro_torch.obs.stream`` and
``repro_torch.obs.alerts`` are copies of the reference's numpy modules.
Each registered ``chaos-*`` scenario runs in both packages with its fault
timeline compressed into a 1500 s horizon, and every result — the
``FaultRecord`` audit log with its before/after node budgets, the
per-tick row-alive mask, the alert transitions — is held exactly equal
(:func:`_torch_parity.assert_same`). The streaming primitives run on
seeded streams; the survivability gate's ``PlanResult`` equals JAX's
probe for probe. The batched engines refuse routed scenarios with the
reference's message, on the CPU, without a kernel launch.
"""

import dataclasses
import math

import numpy as np
import pytest

import repro.provisioning  # noqa: F401
from repro.chaos.faults import FaultEvent as JaxFaultEvent
from repro.chaos.faults import FaultSpec as JaxFaultSpec
from repro.experiments import runner as jax_runner
from repro.experiments.scenario import CHAOS_SCENARIO_FAMILY as JAX_CHAOS_FAMILY
from repro.experiments.scenario import ControllerSpec as JaxControllerSpec
from repro.experiments.scenario import FleetSpec as JaxFleetSpec
from repro.experiments.scenario import HierarchySpec as JaxHierarchySpec
from repro.experiments.scenario import PolicySpec as JaxPolicySpec
from repro.experiments.scenario import RoutingSpec as JaxRoutingSpec
from repro.experiments.scenario import Scenario as JaxScenario
from repro.experiments.scenario import TrafficSpec as JaxTrafficSpec
from repro.experiments.scenario import get_scenario as jax_get_scenario
from repro.obs import alerts as jax_alerts
from repro.obs import stream as jax_stream
from repro.obs.metrics import MetricsRecorder as JaxRecorder
from repro.obs.metrics import recording as jax_recording
from repro.provisioning import planner as jax_planner
from repro.provisioning.batched import lower_ensemble as jax_lower_ensemble
from repro.provisioning.montecarlo import EnsembleSpec as JaxEnsembleSpec

import repro_torch.provisioning  # noqa: F401
from repro_torch.chaos import ChaosInjector, FaultEvent, FaultRecord, FaultSpec
from repro_torch.experiments import runner
from repro_torch.experiments.scenario import CHAOS_SCENARIO_FAMILY, Scenario
from repro_torch.kernels import tick
from repro_torch.obs import alerts, stream
from repro_torch.obs.metrics import MetricsRecorder, recording
from repro_torch.provisioning import planner
from repro_torch.provisioning.montecarlo import (
    EnsembleSpec,
    run_ensemble,
    run_ensemble_grid,
)

from _torch_parity import assert_same
from test_torch_simulator import _snapshot_without_spans

HORIZON_S = 1500.0
# the registered chaos timelines end by 5400 s of their 6 h trace
REGISTERED_SPAN_S = 6000.0


def _port(sc: JaxScenario) -> Scenario:
    return Scenario.from_dict(sc.to_dict())


def _compressed(name: str, duration_s: float = HORIZON_S) -> JaxScenario:
    """A registered chaos-* scenario cut to ``duration_s``, its fault
    timeline (times, restores, ramps) scaled by the same factor so every
    phase still lands inside the horizon."""
    sc = jax_get_scenario(name)
    k = duration_s / REGISTERED_SPAN_S
    events = tuple(dataclasses.replace(
        e, t=e.t * k, ramp_s=e.ramp_s * k,
        until=None if e.until is None else e.until * k)
        for e in sc.faults.events)
    return sc.with_(duration_s=duration_s, faults=JaxFaultSpec(events))


def _chaos_scenario(faults=None, **kw) -> JaxScenario:
    """Eight rows under a (2, 2, 2) tree with tree-scope predictive
    rebalancing (the reference's own chaos test site)."""
    base = dict(
        name="chaos-test", duration_s=HORIZON_S,
        fleet=JaxFleetSpec(n_provisioned=16, added_frac=0.25, n_rows=8),
        policy=JaxPolicySpec("polca"), traffic=JaxTrafficSpec(occ_peak=0.9),
        routing=JaxRoutingSpec("cap-aware"),
        controller=JaxControllerSpec("predictive", interval_s=30.0,
                                     scope="tree"),
        hierarchy=JaxHierarchySpec(shape=(2, 2, 2)), budget="nominal",
        compare_to_reference=False, faults=faults)
    base.update(kw)
    return JaxScenario(**base)


def _run_both(jax_sc: JaxScenario, *, record: bool = False):
    want_rec, got_rec = JaxRecorder(), MetricsRecorder()
    with jax_recording(want_rec if record else None):
        want = jax_runner.run_experiment(jax_sc)
    with recording(got_rec if record else None):
        got = runner.run_experiment(_port(jax_sc))
    assert_same(got, want)
    if record:
        assert _snapshot_without_spans(got_rec) == \
            _snapshot_without_spans(want_rec)
    return got, want


# ---------------------------------------------------------------------------
# the registered chaos family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", JAX_CHAOS_FAMILY)
def test_chaos_family_equals_jax(name):
    """Each chaos-* scenario at 1500 s with its uncapped reference twin:
    fault records, row-alive mask, alert events and every other field of
    ExperimentResult equal JAX's."""
    assert CHAOS_SCENARIO_FAMILY == JAX_CHAOS_FAMILY
    got, want = _run_both(_compressed(name))
    f = got.fleet
    assert_same(f.fault_events, want.fleet.fault_events, "fault_events")
    assert all(isinstance(r, FaultRecord) for r in f.fault_events)
    if name == "chaos-noop":
        assert f.fault_events == [] and f.row_alive is None
    else:
        phases = {r.phase for r in f.fault_events}
        assert phases == ({"apply"} if name == "chaos-row-crash"
                          else {"apply", "restore"})
        assert f.row_alive.shape == f.row_power_frac.shape
    assert f.n_offered == f.n_admitted + f.n_shed_total


def test_alert_engine_events_equal_jax_on_pdu_loss():
    """chaos-pdu-loss-static under the default alert pack, recorded: the
    AlertEvent list and the recorder's alert events and counters equal
    JAX's, the fault-active ground truth engages and releases, and the
    alerts are write-only (the unalerted run is the same fleet)."""
    jax_sc = _compressed("chaos-pdu-loss-static").with_(
        compare_to_reference=False)
    got, want = _run_both(jax_sc, record=True)
    events = got.fleet.alert_events
    assert_same(events, want.fleet.alert_events, "alert_events")
    fault = [(a.phase, a.kind) for a in events if a.kind == "fault-active"]
    assert fault == [("engage", "fault-active"), ("release", "fault-active")]
    off = runner.run_experiment(_port(jax_sc).with_alerts(None))
    assert off.fleet.alert_events == []
    assert_same(dataclasses.replace(got.fleet, alert_events=[]), off.fleet)


def test_default_alert_pack_and_specs_equal_jax():
    pack = alerts.default_alert_pack()
    assert_same(pack, jax_alerts.default_alert_pack(), "pack")
    assert list(alerts.ALERT_BUILDERS) == list(jax_alerts.ALERT_BUILDERS)
    assert alerts.ANY_NODE == jax_alerts.ANY_NODE
    assert alerts.coerce_alerts([s.to_dict() for s in pack]) == pack
    assert alerts.coerce_alerts(None) is None
    for kw in (dict(kind="nope"), dict(kind="cap-proximity", engage=0.5,
                                       release=0.9),
               dict(kind="cap-proximity", target="pdu0", projected=True),
               dict(kind="brake-storm", target="pdu0"),
               dict(kind="conservation-violation", target="*")):
        with pytest.raises(ValueError) as want:
            jax_alerts.AlertSpec(**kw)
        with pytest.raises(ValueError) as got:
            alerts.AlertSpec(**kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the injector: conservation, restore, validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ramp_s", [0.0, 300.0], ids=["step", "ramp"])
def test_derate_conserves_every_node_and_restores_root_exactly(ramp_s):
    """A 30 % pdu0 derate from 300 s to 1200 s (a step, or a 300 s ramp under
    a static controller): every interior node's budget is the sum of its
    children's on every tick, the root dips while the fault holds and
    returns to its value to 1e-6 after the restore, and all of it equals
    JAX's."""
    spec = JaxFaultSpec((JaxFaultEvent("node-derate", t=300.0, node="pdu0",
                                       factor=0.7, until=1200.0,
                                       ramp_s=ramp_s),))
    kw = {} if ramp_s == 0.0 else dict(controller=JaxControllerSpec("static"))
    jax_sc = _chaos_scenario(spec, **kw)
    got, _ = _run_both(jax_sc)
    f = got.fleet
    h = _port(jax_sc).hierarchy.build(np.ones(8))
    for i in range(h.n_leaves, h.n_nodes):
        np.testing.assert_allclose(
            f.node_budget_w[:, h.children[i]].sum(axis=1),
            f.node_budget_w[:, i], rtol=0.0, atol=1e-3)
    root = f.node_budget_w[:, h.root]
    assert float(root.min()) < float(root[0]) - 1.0
    assert abs(float(root[-1]) - float(root[0])) < 1e-6
    assert [(r.kind, r.phase) for r in f.fault_events] == \
        [("node-derate", "apply"), ("node-derate", "restore")]
    pdu0 = f.node_budget_w[:, list(f.node_names).index("pdu0")]
    inside = pdu0[(f.power_t > 300.0 + ramp_s + 10.0) & (f.power_t < 1200.0)]
    np.testing.assert_allclose(inside, pdu0[0] * 0.7, rtol=1e-6, atol=0.0)
    if ramp_s:
        ramp = pdu0[(f.power_t >= 300.0) & (f.power_t <= 300.0 + ramp_s)]
        assert np.all(np.diff(ramp) <= 1e-9)


def test_crash_revive_and_all_rows_dead_equal_jax():
    """Crash every row at 400 s, revive them at 800 s: arrivals in between
    are shed with reason "shed/row-crash", admitted + shed == offered, no
    decision reaches a dead row, and the fleet equals JAX's."""
    events = ([JaxFaultEvent("row-crash", t=400.0, row=i) for i in range(8)]
              + [JaxFaultEvent("row-revive", t=800.0, row=i)
                 for i in range(8)])
    got, _ = _run_both(_chaos_scenario(JaxFaultSpec(tuple(events)),
                                       duration_s=1200.0))
    f = got.fleet
    assert f.n_offered == f.n_admitted + f.n_shed_total
    shed = [d for d in f.decisions if d.reason == "shed/row-crash"]
    assert shed and all(400.0 < d.t <= 802.0 for d in shed)
    dead = ~f.row_alive.any(axis=1)
    assert dead.any() and not dead.all()


def test_injector_rebinds_fresh_state():
    """bind() resets the actuation state: one injector drives two fleets
    to the same records."""
    from repro_torch.experiments.runner import build_workloads, resolve_budget
    from repro_torch.fleet.fleet import build_fleet, fleet_trace

    sc = _port(_chaos_scenario(JaxFaultSpec((JaxFaultEvent(
        "node-derate", t=300.0, node="pdu0", factor=0.7, until=900.0),)),
        duration_s=1000.0))
    wls, shares = build_workloads(sc)
    server = sc.fleet.server()
    budget = resolve_budget(sc, wls, shares, server)
    reqs = fleet_trace(sc, wls, shares)
    runs = []
    for _ in range(2):
        fleet = build_fleet(sc, wls, shares, server, budget, sc.policy.build,
                            reqs)
        runs.append(fleet.run().fault_events)
    assert len(runs[0]) == 2 and runs[0] == runs[1]
    inj = ChaosInjector(sc.faults)
    assert inj.records == [] and not inj._bound


@pytest.mark.parametrize("event", [
    dict(kind="row-crash", t=99999.0, row=0),
    dict(kind="node-derate", t=100.0, node="no-such-node", factor=0.8),
    dict(kind="row-crash", t=100.0, row=99),
], ids=["beyond-duration", "unknown-node", "missing-row"])
def test_bind_time_validation_messages_equal_jax(event):
    """A timeline that does not fit the concrete run fails when the fleet is
    built, with JAX's message naming the offending event."""
    jax_sc = _chaos_scenario(JaxFaultSpec((JaxFaultEvent(**event),)))
    with pytest.raises(ValueError) as want:
        jax_runner.run_experiment(jax_sc)
    with pytest.raises(ValueError) as got:
        runner.run_experiment(_port(jax_sc))
    assert str(got.value) == str(want.value)
    assert "invalid fault event" in str(got.value)


def test_faults_without_routing_refused_like_jax():
    jax_sc = _chaos_scenario(
        JaxFaultSpec((JaxFaultEvent("row-crash", t=100.0, row=0),)),
        routing=None, controller=None, hierarchy=None)
    with pytest.raises(ValueError) as want:
        jax_runner.run_experiment(jax_sc)
    with pytest.raises(ValueError) as got:
        runner.run_experiment(_port(jax_sc))
    assert str(got.value) == str(want.value)
    spec = FaultSpec((FaultEvent("row-crash", t=1.0, row=0),
                      FaultEvent("node-derate", t=2.0, node="pdu0",
                                 factor=0.8)))
    assert [e.kind for e in spec.routing_only().events] == ["row-crash"]


# ---------------------------------------------------------------------------
# streaming primitives on seeded streams
# ---------------------------------------------------------------------------

def _stream(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(0.0, 1.0, n // 2),
                           rng.normal(5.0, 2.0, n - n // 2)])


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def test_p2_quantile_equals_jax(q):
    ours, theirs = stream.P2Quantile(q), jax_stream.P2Quantile(q)
    assert math.isnan(ours.value()) and math.isnan(theirs.value())
    for x in _stream(3, 2000):
        ours.observe(x)
        theirs.observe(x)
        assert ours.value() == theirs.value()
    assert abs(ours.value() - np.quantile(_stream(3, 2000), q)) < 1.0


def test_ewma_slope_equals_jax():
    """An irregular tick stream with duplicate ticks, projected at the
    default horizon and at 10 s after every observation."""
    rng = np.random.default_rng(11)
    ours, theirs = stream.EwmaSlope(), jax_stream.EwmaSlope()
    assert ours.horizon_s == theirs.horizon_s == stream.OOB_HORIZON_S
    t = 0.0
    for k in range(1500):
        t += float(rng.choice([0.0, 2.0, 2.0, 4.0]))
        x = 0.6 + 1e-4 * k + float(rng.normal(0.0, 0.01))
        ours.observe(t, x)
        theirs.observe(t, x)
        assert ours.projected() == theirs.projected()
        assert ours.projected(10.0) == theirs.projected(10.0)
    assert ours.slope > 0.0


def test_sliding_counter_and_tumbling_window_equal_jax():
    rng = np.random.default_rng(13)
    sc, jsc = stream.SlidingCounter(60.0, 2.0), jax_stream.SlidingCounter(60.0, 2.0)
    tw = stream.TumblingWindow(60.0, (0.5, 0.9, 0.99))
    jtw = jax_stream.TumblingWindow(60.0, (0.5, 0.9, 0.99))
    n_closed = 0
    for k in range(3000):
        x = float(rng.poisson(3.0))
        sc.push(x)
        jsc.push(x)
        assert (sc.total, sc.filled) == (jsc.total, jsc.filled)
        closed, jclosed = tw.observe(2.0 * k, x), jtw.observe(2.0 * k, x)
        assert_same(closed, jclosed, f"window@{k}")
        n_closed += closed is not None
        assert tw.live_count == jtw.live_count
    assert n_closed == 99 and sc.total > 0.0
    assert tw.last.quantile(0.9) == jtw.last.quantile(0.9)


def test_fleet_stream_equals_jax():
    """Per-tick node fractions, brake flags and shed/offered totals through
    FleetStream with every channel registered: the windows, deltas and the
    projected root fraction equal JAX's on every tick."""
    rng = np.random.default_rng(21)
    ours, theirs = stream.FleetStream(2.0), jax_stream.FleetStream(2.0)
    chans = [(ours.sliding(c, 30.0), theirs.sliding(c, 30.0))
             for c in stream.FleetStream.CHANNELS]
    shed = offered = 0
    for k in range(900):
        fr = rng.uniform(0.4, 1.05, 7)
        braked = rng.random(4) < 0.1
        offered += int(rng.integers(0, 20))
        shed += int(rng.integers(0, 3))
        age = float(rng.exponential(2.0))
        for st in (ours, theirs):
            st.observe(2.0 * (k + 1), fr, braked, shed, offered,
                       queue_depth=k % 5, max_queue_age_s=age)
        assert ours.projected_root_frac() == theirs.projected_root_frac()
        assert (ours.brake_edges_tick, ours.shed_tick, ours.offered_tick) == \
            (theirs.brake_edges_tick, theirs.shed_tick, theirs.offered_tick)
        for a, b in chans:
            assert a.total == b.total
    assert sorted(ours.node_windows) == sorted(theirs.node_windows)
    for i, w in ours.node_windows.items():
        assert_same(w.last, theirs.node_windows[i].last, f"node{i}")
    assert_same(ours.queue_age.last, theirs.queue_age.last, "queue_age")


# ---------------------------------------------------------------------------
# the survivability gate
# ---------------------------------------------------------------------------

def _plan_base() -> JaxScenario:
    """Four rows under a (2, 2) tree at +0 %, 900 s: the reference's own
    survivability test fleet."""
    return _chaos_scenario(None, duration_s=900.0,
                           fleet=JaxFleetSpec(n_provisioned=8, added_frac=0.0,
                                              n_rows=4),
                           hierarchy=JaxHierarchySpec(shape=(2, 2)),
                           traffic=JaxTrafficSpec(occ_peak=0.62))


# two rows crash mid-trace and revive (kind, t, row)
_CRASH2 = (("row-crash", 300.0, 0), ("row-crash", 350.0, 1),
           ("row-revive", 800.0, 0), ("row-revive", 800.0, 1))


def _crash2(pkg_event, pkg_spec):
    return pkg_spec(tuple(pkg_event(k, t=t, row=r) for k, t, r in _CRASH2))


def test_survive_gate_plan_equals_jax():
    """plan_capacity with RiskConstraints(survive=two-row crash) on
    engine="numpy": the PlanResult (fault_brake_prob on every probe) equals
    JAX's, sits at or below the fault-free plan, and an empty timeline is
    no gate at all."""
    base = _plan_base()
    kw = dict(n_seeds=1, max_added_frac=0.5, n_workers=1)
    want = jax_planner.plan_capacity(
        base, constraints=jax_planner.RiskConstraints(
            survive=_crash2(JaxFaultEvent, JaxFaultSpec)), **kw)
    got = planner.plan_capacity(
        _port(base), constraints=planner.RiskConstraints(
            survive=_crash2(FaultEvent, FaultSpec)), engine="numpy", **kw)
    assert_same(got, want)
    assert all(p.fault_brake_prob is not None for p in got.probes)
    free = planner.plan_capacity(_port(base), engine="numpy", **kw)
    assert all(p.fault_brake_prob is None for p in free.probes)
    assert got.safe_added_servers <= free.safe_added_servers
    noop = planner.plan_capacity(
        _port(base), constraints=planner.RiskConstraints(survive=FaultSpec()),
        engine="numpy", **kw)
    assert noop.safe_added_servers == free.safe_added_servers


def test_survive_gate_refusals_equal_jax():
    """A survive gate on an unrouted scenario, or on a batched engine,
    raises JAX's message."""
    crash = planner.RiskConstraints(survive=_crash2(FaultEvent, FaultSpec))
    jax_crash = jax_planner.RiskConstraints(
        survive=_crash2(JaxFaultEvent, JaxFaultSpec))
    unrouted = _plan_base().with_(routing=None, controller=None,
                                  hierarchy=None)
    for sc, engine in ((unrouted, "numpy"), (_plan_base(), "torch")):
        with pytest.raises(ValueError) as want:
            jax_planner.plan_capacity(sc, constraints=jax_crash, n_seeds=1,
                                      engine=engine)
        with pytest.raises(ValueError) as got:
            planner.plan_capacity(_port(sc), constraints=crash, n_seeds=1,
                                  engine=engine)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the batched engines refuse routed scenarios, with no fallback
# ---------------------------------------------------------------------------

def _routed_refusal_message() -> str:
    base = jax_get_scenario("fleet-cap-aware")
    with pytest.raises(ValueError) as err:
        jax_lower_ensemble(JaxEnsembleSpec(base, n_seeds=1))
    return str(err.value)


@pytest.mark.parametrize("case", ["run_ensemble-cuda", "run_ensemble-torch",
                                  "run_ensemble_grid-default",
                                  "plan_capacity-survive-cuda"])
def test_batched_engines_refuse_routed_scenarios(case):
    """fleet-cap-aware on the batched engines (device="cpu" here, where the
    card is missing): ValueError with the reference's message, naming
    engine='numpy', and no tick kernel launched."""
    base = _port(jax_get_scenario("fleet-cap-aware"))
    spec = EnsembleSpec(base, n_seeds=2)
    launches = tick.polca_tick_loop.launches
    if case == "plan_capacity-survive-cuda":
        crash = planner.RiskConstraints(survive=_crash2(FaultEvent, FaultSpec))
        with pytest.raises(ValueError) as got:
            planner.plan_capacity(base, constraints=crash, n_seeds=1,
                                  engine="cuda")
        with pytest.raises(ValueError) as want:
            jax_planner.plan_capacity(
                jax_get_scenario("fleet-cap-aware"), n_seeds=1, engine="cuda",
                constraints=jax_planner.RiskConstraints(
                    survive=_crash2(JaxFaultEvent, JaxFaultSpec)))
        assert str(got.value) == str(want.value)
    else:
        with pytest.raises(ValueError) as got:
            if case == "run_ensemble-cuda":
                run_ensemble(spec, engine="cuda", device="cpu")
            elif case == "run_ensemble-torch":
                run_ensemble(spec, engine="torch", device="cpu")
            else:
                run_ensemble_grid([base], n_seeds=2, device="cpu")
        assert str(got.value) == _routed_refusal_message()
    assert "engine='numpy'" in str(got.value)
    assert tick.polca_tick_loop.launches == launches
