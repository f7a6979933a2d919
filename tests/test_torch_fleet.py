"""The port's routed fleet (``repro_torch.fleet``) against the JAX package's.

``repro_torch.fleet`` is a copy of the reference's plain-Python fleet driver:
one cluster-wide arrival stream, a router and an admission controller per
fleet, ``heapq`` row simulators underneath. The same scenario — built by the
JAX package and carried to the port through ``to_dict``/``from_dict`` —
runs through both packages, and every result is held **exactly** equal
(:func:`_torch_parity.assert_same`: ``==`` on floats, arrays by dtype, shape
and value): routers' choices, ``ExperimentResult`` with its ``FleetResult``
and decision log, ``RoutingAttribution``, routed ensemble members on one and
two workers with the recorder, and planner decisions over fleet members.
Horizons are cut to 900-1200 s.
"""

import dataclasses

import numpy as np
import pytest

import repro.provisioning  # noqa: F401  (registers the JAX mc-* scenarios)
from repro.core.simulator import Request as JaxRequest
from repro.experiments import runner as jax_runner
from repro.experiments.scenario import FLEET_SCENARIO_FAMILY as JAX_FLEET_FAMILY
from repro.experiments.scenario import FleetSpec as JaxFleetSpec
from repro.experiments.scenario import PolicySpec as JaxPolicySpec
from repro.experiments.scenario import RoutingSpec as JaxRoutingSpec
from repro.experiments.scenario import Scenario as JaxScenario
from repro.experiments.scenario import TrafficSpec as JaxTrafficSpec
from repro.experiments.scenario import get_scenario as jax_get_scenario
from repro.fleet import metrics as jax_fleet_metrics
from repro.fleet import router as jax_router
from repro.fleet.fleet import fleet_trace as jax_fleet_trace
from repro.obs.metrics import MetricsRecorder as JaxRecorder
from repro.obs.metrics import recording as jax_recording
from repro.provisioning import montecarlo as jax_mc
from repro.provisioning import planner as jax_planner

import repro_torch.provisioning  # noqa: F401
from repro_torch.core.simulator import Request
from repro_torch.experiments import runner
from repro_torch.experiments.scenario import FLEET_SCENARIO_FAMILY, RoutingSpec, Scenario
from repro_torch.fleet import metrics as fleet_metrics
from repro_torch.fleet import router
from repro_torch.fleet.fleet import fleet_trace
from repro_torch.obs.metrics import MetricsRecorder, recording
from repro_torch.provisioning import montecarlo as mc
from repro_torch.provisioning import planner

from _torch_parity import assert_same
from test_torch_simulator import _snapshot_without_spans


def _port(sc: JaxScenario) -> Scenario:
    return Scenario.from_dict(sc.to_dict())


def _fleet_scenario(duration_s=1200.0, **kw) -> JaxScenario:
    """A small routed fleet with a derated row (the reference's own test
    fleet): 3 rows x 20 servers on nominal budgets."""
    base = dict(
        name="fleet-test", duration_s=duration_s,
        fleet=JaxFleetSpec(n_provisioned=16, added_frac=0.25, n_rows=3,
                           rows_per_rack=2, row_budget_fracs=(1.0, 1.0, 0.7)),
        policy=JaxPolicySpec("polca"), traffic=JaxTrafficSpec(occ_peak=0.9),
        routing=JaxRoutingSpec("cap-aware"), budget="nominal",
        compare_to_reference=False)
    base.update(kw)
    return JaxScenario(**base)


# ---------------------------------------------------------------------------
# routers and admission controllers on hand-built views
# ---------------------------------------------------------------------------

def _random_views(rng, n_rows: int, view_cls, with_forecast: bool):
    views = []
    for i in range(n_rows):
        size = int(rng.integers(1, 9))
        idle = int(rng.integers(0, size + 1))
        flags = rng.random(4) < 0.25
        views.append(view_cls(
            index=i, power_frac=float(rng.uniform(0.3, 1.1)),
            headroom_w=float(rng.uniform(-2e3, 2e4)), braked=bool(flags[0]),
            t1_capped=bool(flags[1]), t2_capped=bool(flags[2]),
            hp_capped=bool(flags[3]), pool_size=size, pool_idle=idle,
            pool_queued=int(rng.integers(0, 6)),
            forecast_frac=(float(rng.uniform(0.6, 1.2))
                           if with_forecast else None)))
    return views


def _random_request(rng, rid: int, req_cls):
    return req_cls(t_arrival=float(rid), wl=int(rng.integers(0, 3)),
                   prompt=int(rng.integers(16, 2048)),
                   out_tokens=int(rng.integers(1, 1024)),
                   priority="high" if rng.random() < 0.4 else "low", rid=rid)


@pytest.mark.parametrize("kind", list(jax_router.ROUTER_BUILDERS))
def test_router_choices_equal_jax(kind):
    """400 seeded dispatches over 1-6 rows of random views (ties included:
    pool fields are small integers): the same (row, reason) sequence."""
    assert list(router.ROUTER_BUILDERS) == list(jax_router.ROUTER_BUILDERS)
    ours, theirs = router.build_router(kind), jax_router.build_router(kind)
    assert (ours.needs_views, ours.needs_forecast) == \
        (theirs.needs_views, theirs.needs_forecast)
    got, want = [], []
    for pkg, rt, out in ((router, ours, got), (jax_router, theirs, want)):
        rng = np.random.default_rng(17)
        req_cls = Request if pkg is router else JaxRequest
        for rid in range(400):
            n = int(rng.integers(1, 7))
            views = _random_views(rng, n, pkg.RowView, kind == "forecast-aware")
            out.append(rt.route(_random_request(rng, rid, req_cls), views))
    assert got == want
    assert len({r for r, _ in want}) > 1


@pytest.mark.parametrize("kind", list(jax_router.ADMISSION_BUILDERS))
def test_admission_decisions_equal_jax(kind):
    """A seeded stream of arrivals against fleet views that enter and leave
    emergencies (cluster fraction around ``shed_above``, braked rows): the
    same admit/shed sequence, including the token-budget controller's
    debt state."""
    assert list(router.ADMISSION_BUILDERS) == \
        list(jax_router.ADMISSION_BUILDERS)
    got, want = [], []
    for pkg, out in ((router, got), (jax_router, want)):
        adm = pkg.build_admission(kind)
        rng = np.random.default_rng(5)
        req_cls = Request if pkg is router else JaxRequest
        t = 0.0
        for rid in range(600):
            t += float(rng.exponential(0.5))
            fv = pkg.FleetView(t=t, cluster_frac=float(rng.uniform(0.9, 1.0)),
                               n_braked=int(rng.random() < 0.1))
            out.append(adm.admit(_random_request(rng, rid, req_cls), fv))
    assert got == want
    if kind != "admit-all":
        assert 0 < sum(want) < len(want)


def test_registry_builders_equal_jax():
    for kind in jax_router.ROUTER_BUILDERS:
        assert dataclasses.asdict(router.build_router(kind)) == \
            dataclasses.asdict(jax_router.build_router(kind))
    for kind in jax_router.ADMISSION_BUILDERS:
        assert dataclasses.asdict(router.build_admission(kind)) == \
            dataclasses.asdict(jax_router.build_admission(kind))
    for build in (router.build_router, router.build_admission):
        with pytest.raises(KeyError, match="registered"):
            build("nope")


# ---------------------------------------------------------------------------
# run_experiment on the registered fleet family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", JAX_FLEET_FAMILY)
def test_fleet_family_run_experiment_equals_jax(name):
    """Each fleet-* scenario cut to 1200 s with its uncapped reference twin:
    ExperimentResult (fleet included) and RoutingAttribution field by field."""
    assert FLEET_SCENARIO_FAMILY == JAX_FLEET_FAMILY
    jax_sc = jax_get_scenario(name).with_(duration_s=1200.0)
    want = jax_runner.run_experiment(jax_sc)
    got = runner.run_experiment(_port(jax_sc))
    assert want.fleet is not None and want.ref_result is not None
    assert want.fleet.n_offered > 1000
    assert_same(got, want)

    wls, shares = runner.build_workloads(got.scenario)
    jwls, jshares = jax_runner.build_workloads(jax_sc)
    reqs = fleet_trace(got.scenario, wls, shares)
    jreqs = jax_fleet_trace(jax_sc, jwls, jshares)
    assert_same(reqs, jreqs, "trace")
    assert_same(fleet_metrics.attribute_routing(got.fleet, reqs, wls),
                jax_fleet_metrics.attribute_routing(want.fleet, jreqs, jwls),
                "attribution")


def test_shed_lp_fleet_equals_jax_and_conserves():
    """The shed-lp admission on the small fleet at an aggressive threshold:
    LP is shed, HP never is, admitted + shed == offered, and the result
    equals JAX's."""
    jax_sc = _fleet_scenario(routing=JaxRoutingSpec(
        "cap-aware", admission="shed-lp",
        admission_params={"shed_above": 0.5}))
    want = jax_runner.run_experiment(jax_sc)
    got = runner.run_experiment(_port(jax_sc))
    assert_same(got, want)
    f = got.fleet
    assert f.n_shed["low"] > 0 and f.n_shed["high"] == 0
    assert f.n_admitted + f.n_shed_total == f.n_offered == len(f.decisions)


def test_single_row_round_robin_fleet_equals_standalone_row():
    """A one-row round-robin fleet replays the port's standalone row bit for
    bit (the reference's own acceptance check, on the port)."""
    base = _port(jax_get_scenario("fig14-plus30").with_(duration_s=1800.0))
    solo = runner.run_experiment(base)
    fleet = runner.run_experiment(
        base.with_(routing=RoutingSpec("round-robin")))
    fr, sr = fleet.fleet.row_results[0], solo.result
    assert fr.latencies == sr.latencies
    assert fr.queue_delays == sr.queue_delays
    np.testing.assert_array_equal(fr.power_w, sr.power_w)
    assert (fr.n_brakes, fr.cap_events, fr.n_completed, fr.n_dropped) == \
        (sr.n_brakes, sr.cap_events, sr.n_completed, sr.n_dropped)
    assert fleet.stats.summary() == solo.stats.summary()
    assert fleet.meets == solo.meets


# ---------------------------------------------------------------------------
# routed members on the event-driven engine, and the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_reference", [False, True],
                         ids=["no-reference", "with-reference"])
@pytest.mark.parametrize("n_workers", [1, 2])
def test_routed_ensemble_equals_jax(n_workers, with_reference):
    """run_ensemble(engine="numpy") over routed members (900 s, 3 seeds),
    recorded: the EnsembleResult and the recorder's counters, histograms,
    gauges and events equal JAX's at the same worker count."""
    base = _fleet_scenario(duration_s=900.0)
    jax_spec = jax_mc.EnsembleSpec(base, n_seeds=3, seed0=500,
                                   n_workers=n_workers,
                                   with_reference=with_reference)
    want_rec = JaxRecorder()
    with jax_recording(want_rec):
        want = jax_mc.run_ensemble(jax_spec)
    spec = mc.EnsembleSpec(_port(base), n_seeds=3, seed0=500,
                           n_workers=n_workers, with_reference=with_reference)
    got_rec = MetricsRecorder()
    with recording(got_rec):
        got = mc.run_ensemble(spec, engine="numpy")
    assert_same(got, want)
    assert _snapshot_without_spans(got_rec) == \
        _snapshot_without_spans(want_rec)
    assert int(want.brake_counts.sum()) > 0
    assert any(k[0] == "fleet_dispatch_total"
               for k in got_rec.snapshot().counters)


def test_plan_capacity_over_fleet_members_equals_jax():
    """plan_capacity(engine="numpy") over routed members (900 s, 2 seeds):
    every probe (verdicts, probabilities, peak) and the decision."""
    base = _fleet_scenario(duration_s=900.0).with_fleet(added_frac=0.0)
    kw = dict(n_seeds=2, seed0=650, max_added_frac=0.25, n_workers=2)
    want = jax_planner.plan_capacity(base, **kw)
    got = planner.plan_capacity(_port(base), engine="numpy", **kw)
    assert_same(got, want)
    assert len(want.probes) >= 3 and not want.capped
