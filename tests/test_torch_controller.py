"""The port's budget-rebalancing controller (``repro_torch.fleet.controller``)
against the JAX package's.

The forecaster runs on seeded series; the controller rides routed fleets
(cut to 900-1200 s) in both packages. Every ``RebalanceEvent`` list —
times, budgets before and after, demand, per-node budgets under the tree
scope — equals JAX's exactly, conservation holds on every applied rebalance
and every telemetry tick in each scope, a static controller replays a
controller-less fleet bit for bit, and ``plan_controller_comparison``
gives JAX's plans probe for probe.
"""

import numpy as np
import pytest

from repro.experiments import runner as jax_runner
from repro.experiments.scenario import ControllerSpec as JaxControllerSpec
from repro.experiments.scenario import FleetSpec as JaxFleetSpec
from repro.experiments.scenario import HierarchySpec as JaxHierarchySpec
from repro.experiments.scenario import PolicySpec as JaxPolicySpec
from repro.experiments.scenario import RoutingSpec as JaxRoutingSpec
from repro.experiments.scenario import SITE_SCENARIO_FAMILY as JAX_SITE_FAMILY
from repro.experiments.scenario import Scenario as JaxScenario
from repro.experiments.scenario import TrafficSpec as JaxTrafficSpec
from repro.experiments.scenario import get_scenario as jax_get_scenario
from repro.fleet import controller as jax_controller
from repro.provisioning import planner as jax_planner

from repro_torch.experiments import runner
from repro_torch.experiments.scenario import SITE_SCENARIO_FAMILY, Scenario
from repro_torch.fleet import controller
from repro_torch.provisioning import planner

from _torch_parity import assert_same

REBALANCE_FAMILY = ["fleet-rebalance-static", "fleet-rebalance-proportional",
                    "fleet-rebalance-predictive",
                    "fleet-rebalance-forecast-router"]


def _port(sc: JaxScenario) -> Scenario:
    return Scenario.from_dict(sc.to_dict())


def _run_both(jax_sc: JaxScenario):
    want = jax_runner.run_experiment(jax_sc)
    got = runner.run_experiment(_port(jax_sc))
    return got, want


def _fleet_scenario(**kw) -> JaxScenario:
    """Four rows in two racks, the last derated (the reference's own
    controller test fleet)."""
    base = dict(
        name="controller-test", duration_s=1200.0,
        fleet=JaxFleetSpec(n_provisioned=16, added_frac=0.25, n_rows=4,
                           rows_per_rack=2,
                           row_budget_fracs=(1.0, 1.0, 1.0, 0.7)),
        policy=JaxPolicySpec("polca"), traffic=JaxTrafficSpec(occ_peak=0.9),
        routing=JaxRoutingSpec("cap-aware"),
        controller=JaxControllerSpec("predictive", interval_s=30.0),
        budget="nominal", compare_to_reference=False)
    base.update(kw)
    return JaxScenario(**base)


def _site_scenario(scope: str) -> JaxScenario:
    """Eight rows under a (2, 2, 2) tree with the rack "0/1" derated."""
    return _fleet_scenario(
        name="hier-test",
        fleet=JaxFleetSpec(n_provisioned=16, added_frac=0.25, n_rows=8),
        controller=JaxControllerSpec("predictive", interval_s=30.0,
                                     scope=scope),
        hierarchy=JaxHierarchySpec(shape=(2, 2, 2),
                                   budget_fracs={"0/1": 0.7}))


# ---------------------------------------------------------------------------
# the forecaster
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("horizon_s,window", [(40.0, 8), (10.0, 3),
                                              (120.0, 20)])
def test_forecaster_equals_jax(horizon_s, window):
    """Seeded rising, falling and noisy per-row series observed on a 2 s
    grid: every forecast along the way equals JAX's bit for bit (the first
    two are the latest sample; a falling trend clamps at the current
    value)."""
    rng = np.random.default_rng(9)
    n_rows, n = 5, 60
    trend = np.array([40.0, -25.0, 0.0, 5.0, -3.0])
    series = (1e4 + trend * np.arange(n)[:, None]
              + rng.normal(0.0, 50.0, (n, n_rows)))
    ours = controller.PowerForecaster(n_rows, horizon_s=horizon_s,
                                      window=window)
    theirs = jax_controller.PowerForecaster(n_rows, horizon_s=horizon_s,
                                            window=window)
    np.testing.assert_array_equal(ours.forecast_w(), theirs.forecast_w())
    n_raised = n_clamped = 0
    for k in range(n):
        t = 2.0 * (k + 1)
        ours.observe(t, series[k])
        theirs.observe(t, series[k])
        got, want = ours.forecast_w(), theirs.forecast_w()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert np.all(got >= series[k])
        n_raised += int((got > series[k]).sum())
        n_clamped += int((got == series[k]).sum())
    assert n_raised > 0 and n_clamped > 0


def test_forecaster_default_horizon_is_the_oob_horizon():
    from repro_torch.obs.stream import OOB_HORIZON_S

    assert controller.PowerForecaster(1).horizon_s == OOB_HORIZON_S == \
        jax_controller.PowerForecaster(1).horizon_s
    assert controller.CONSERVATION_ATOL == jax_controller.CONSERVATION_ATOL
    assert list(controller.REBALANCE_BUILDERS) == \
        list(jax_controller.REBALANCE_BUILDERS)


def test_controller_validation_messages_equal_jax():
    policy = controller.StaticBudgetPolicy()
    jax_policy = jax_controller.StaticBudgetPolicy()
    for kw in (dict(scope="pdu"), dict(alpha=0.0), dict(min_share=1.0)):
        with pytest.raises(ValueError) as want:
            jax_controller.FleetController(jax_policy, **kw)
        with pytest.raises(ValueError) as got:
            controller.FleetController(policy, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(KeyError, match="registered"):
        controller.build_rebalance_policy("nope")


# ---------------------------------------------------------------------------
# conservation on every rebalance and every tick, per scope
# ---------------------------------------------------------------------------

def _groups(scope: str, f):
    """Row index groups whose budget sum each rebalance must conserve."""
    n = f.row_budget_w.shape[1]
    if scope == "cluster":
        return [list(range(n))]
    return [[i, i + 1] for i in range(0, n, 2)]  # two rows a rack


@pytest.mark.parametrize("case", ["row-pairs-rack", "cluster", "site-rack",
                                  "site-tree"])
def test_conservation_every_rebalance_tick(case):
    """Row budgets under rack scope (pairs of rows), one flat cluster pool,
    and a (2, 2, 2) site under rack and tree scope: each applied rebalance
    conserves its group's envelope (every interior node's under the tree
    scope, the root frozen), the per-tick budget matrix conserves the root
    on every tick, and the events equal JAX's."""
    if case == "row-pairs-rack":
        jax_sc = _fleet_scenario()
    elif case == "cluster":
        jax_sc = _fleet_scenario(controller=JaxControllerSpec(
            "proportional", interval_s=30.0, scope="cluster"))
    else:
        jax_sc = _site_scenario(case.removeprefix("site-"))
    got, want = _run_both(jax_sc)
    assert_same(got, want)
    f = got.fleet
    assert f.n_rebalances > 0
    atol = controller.CONSERVATION_ATOL
    if case == "site-tree":
        h = _port(jax_sc).hierarchy.build(np.ones(8))
        for ev in f.rebalances:
            na, nb = ev.node_budgets_after_w, ev.node_budgets_before_w
            for i in range(h.n_leaves, h.n_nodes):
                kids = h.children[i]
                assert abs(float(na[kids].sum()) - float(na[i])) <= atol
            assert float(na[h.root]) == float(nb[h.root])
        for i in range(h.n_leaves, h.n_nodes):
            np.testing.assert_allclose(
                f.node_budget_w[:, h.children[i]].sum(axis=1),
                f.node_budget_w[:, i], rtol=0.0, atol=1e-3)
    else:
        for ev in f.rebalances:
            assert ev.node_budgets_after_w is None
            for g in _groups(jax_sc.controller.scope, f):
                assert abs(float(ev.budgets_after_w[g].sum())
                           - float(ev.budgets_before_w[g].sum())) <= atol
            assert ev.moved_w() > 0.0
    totals = f.row_budget_w.sum(axis=1)
    np.testing.assert_allclose(totals, totals[0], rtol=0.0, atol=atol)


# ---------------------------------------------------------------------------
# the registered rebalance and site families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", REBALANCE_FAMILY + JAX_SITE_FAMILY)
def test_registered_rebalance_events_equal_jax(name):
    """The four fleet-rebalance-* and three site-* scenarios cut to 1200 s:
    the RebalanceEvent list and the rest of ExperimentResult equal JAX's."""
    assert SITE_SCENARIO_FAMILY == JAX_SITE_FAMILY
    jax_sc = jax_get_scenario(name).with_(duration_s=1200.0)
    got, want = _run_both(jax_sc)
    assert_same(got.fleet.rebalances, want.fleet.rebalances, "rebalances")
    assert_same(got, want)
    static = jax_sc.controller.kind == "static"
    assert (want.fleet.n_rebalances == 0) == static
    assert got.fleet.budget_moved_w() == want.fleet.budget_moved_w()


def test_static_controller_equals_no_controller():
    """A static ControllerSpec replays the controller-less fleet bit for bit
    on the port (budgets recorded but never moved), as on JAX."""
    sc = _port(jax_get_scenario("fleet-rebalance-static").with_(
        duration_s=1200.0, compare_to_reference=False))
    a = runner.run_experiment(sc)
    b = runner.run_experiment(sc.with_(controller=None))
    assert a.fleet.n_rebalances == 0
    assert np.all(a.fleet.row_budget_w == a.fleet.row_budget_w[0])
    assert_same(a.fleet, b.fleet, "fleet")
    assert_same(a.result, b.result, "result")


def test_plan_controller_comparison_equals_jax():
    """fleet-rebalance-static cut to 900 s, static vs predictive, one seed,
    up to +10 %: both plans equal JAX's probe for probe."""
    base = jax_get_scenario("fleet-rebalance-static").with_(duration_s=900.0)
    kw = dict(n_seeds=1, seed0=1000, max_added_frac=0.10, n_workers=1)
    want = jax_planner.plan_controller_comparison(base, **kw)
    got = planner.plan_controller_comparison(_port(base), **kw)
    assert list(got) == ["static", "predictive"]
    assert_same(got, want)
    with pytest.raises(ValueError, match="RoutingSpec") as err:
        planner.plan_controller_comparison(_port(base).with_(routing=None))
    with pytest.raises(ValueError) as jax_err:
        jax_planner.plan_controller_comparison(base.with_(routing=None))
    assert str(err.value) == str(jax_err.value)
