"""Calibrated budgets, ``run_experiment``, sweeps, the event-driven
Monte-Carlo engine and the planner on the port, against the JAX package.

Scenarios come from the JAX package (its registry or its dataclasses) and
reach the port through ``to_dict``/``from_dict``; both packages then run
them on their own copies of the numpy layers. Budgets are held equal bit
for bit, every result exactly, planner decisions identically. Horizons are
cut to 900-3600 s and run hot (power_scale >= 1.1, +30 % servers) so that
caps and brakes fire.
"""

import dataclasses

import numpy as np
import pytest

import repro.provisioning  # noqa: F401  (registers the JAX mc-* scenarios)
from repro.core import oversubscription as jax_oversubscription
from repro.core import phase_aware as jax_phase_aware
from repro.core.policy import PolcaPolicy as JaxPolcaPolicy
from repro.experiments import runner as jax_runner
from repro.experiments.scenario import FleetSpec as JaxFleetSpec
from repro.experiments.scenario import Scenario as JaxScenario
from repro.experiments.scenario import TrafficSpec as JaxTrafficSpec
from repro.experiments.scenario import get_scenario as jax_get_scenario
from repro.obs.metrics import MetricsRecorder as JaxRecorder
from repro.obs.metrics import recording as jax_recording
from repro.provisioning import ensembles as jax_ensembles
from repro.provisioning import montecarlo as jax_mc
from repro.provisioning import planner as jax_planner

import repro_torch.provisioning  # noqa: F401  (registers the port's mc-* scenarios)
from repro_torch.core import oversubscription, phase_aware
from repro_torch.core.policy import PolcaPolicy
from repro_torch.experiments import runner
from repro_torch.experiments.scenario import Scenario, get_scenario
from repro_torch.obs.metrics import MetricsRecorder, recording
from repro_torch.provisioning import ensembles, montecarlo as mc, planner

from _torch_parity import assert_same
from test_torch_simulator import (
    _setup,
    _snapshot_without_spans,
    assert_sim_results_equal,
)

# the calibrated budgets of the six mc-* scenarios at their registered size
# (12 h, 40 provisioned servers, one row), as the JAX package resolves them
MC_BUDGETS_W = {
    "mc-diurnal": 193691.10817394112,
    "mc-bursty": 196711.22511730078,
    "mc-colocated": 196236.14538973392,
    "mc-failover": 199998.71063530064,
    "mc-rack-incident": 202525.5266415967,
    "mc-nighttime": 179126.04096475872,
}


def _port(sc: JaxScenario) -> Scenario:
    return Scenario.from_dict(sc.to_dict())


def _hot(duration_s=1800.0, **kw) -> JaxScenario:
    """A small oversubscribed row on the default calibrated budget."""
    fleet = dict(n_provisioned=20, added_frac=0.30)
    fleet.update(kw.pop("fleet", {}))
    return JaxScenario(name="hot", duration_s=duration_s,
                       fleet=JaxFleetSpec(**fleet),
                       traffic=JaxTrafficSpec(occ_peak=kw.pop("occ_peak", 0.95)),
                       power_scale=kw.pop("power_scale", 1.15), **kw)


def assert_stats_equal(got, want):
    assert got.hp_impacts == want.hp_impacts
    assert got.lp_impacts == want.lp_impacts


def assert_experiments_equal(got, want):
    """Two ExperimentResults field for field."""
    assert_stats_equal(got.stats, want.stats)
    for name in ("n_servers", "added_frac", "meets", "throughput_ratio_hp",
                 "throughput_ratio_lp", "budget_w"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.scenario.to_dict() == want.scenario.to_dict()
    assert_sim_results_equal(got.result, want.result)
    assert (got.ref_result is None) == (want.ref_result is None)
    if want.ref_result is not None:
        assert_sim_results_equal(got.ref_result, want.ref_result)
    assert (got.cluster is None) == (want.cluster is None)
    if want.cluster is not None:
        for f in dataclasses.fields(want.cluster):
            a, b = getattr(got.cluster, f.name), getattr(want.cluster, f.name)
            if f.name == "row_results":
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    assert_sim_results_equal(x, y)
            elif isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert (got.fleet is None) == (want.fleet is None)
    if want.fleet is not None:
        assert_same(got.fleet, want.fleet, "fleet")


# ---------------------------------------------------------------------------
# budgets and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [*MC_BUDGETS_W, "fig14-plus30"])
def test_calibrated_budget_bit_for_bit(name):
    want = jax_mc.resolve_ensemble_budget(jax_get_scenario(name))
    assert get_scenario(name).to_dict() == jax_get_scenario(name).to_dict()
    got = mc.resolve_ensemble_budget(_port(jax_get_scenario(name)))
    assert got == want
    if name in MC_BUDGETS_W:
        assert got == MC_BUDGETS_W[name]


def test_mc_family_equals_jax():
    assert ensembles.MC_BASE_NAME == jax_ensembles.MC_BASE_NAME
    assert ensembles.MC_SCENARIO_FAMILY == jax_ensembles.MC_SCENARIO_FAMILY


def test_default_scenario_resolves_a_calibrated_budget():
    """``Scenario(name=..., duration_s=...)`` takes budget="calibrated" and
    runs through run_experiment and both batched engines' lowering."""
    sc = Scenario(name="default", duration_s=1800.0)
    assert sc.budget == "calibrated"
    jax_sc = JaxScenario(name="default", duration_s=1800.0)
    assert sc.to_dict() == jax_sc.to_dict()
    want = jax_mc.resolve_ensemble_budget(jax_sc)
    assert mc.resolve_ensemble_budget(sc) == want
    assert runner.run_experiment(sc).budget_w == want
    res = mc.run_ensemble(mc.EnsembleSpec(sc, n_seeds=2), engine="torch",
                          device="cpu")
    assert res.budget_w == want and res.n_members == 2


def test_scenario_json_round_trip_equals_jax():
    for name in (*MC_BUDGETS_W, "table2-baseline", "fig16-six-week"):
        jax_sc = jax_get_scenario(name)
        sc = Scenario.from_json(jax_sc.to_json())
        assert sc.to_json() == jax_sc.to_json() == get_scenario(name).to_json()
        assert Scenario.from_json(sc.to_json()) == sc


# ---------------------------------------------------------------------------
# run_experiment, sweeps, legacy wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["polca", "one-threshold"])
def test_run_experiment_row_path_equals_jax(policy):
    """The row path with the uncapped reference comparison on."""
    jax_sc = _hot().with_policy(policy)
    want = jax_runner.run_experiment(jax_sc)
    got = runner.run_experiment(_port(jax_sc))
    assert want.ref_result is not None and want.stats.hp_impacts
    assert want.result.cap_events > 0
    assert_experiments_equal(got, want)


@pytest.mark.parametrize("hierarchy", [None, (2, 2)],
                         ids=["two-level", "hierarchy-2x2"])
def test_run_experiment_cluster_path_equals_jax(hierarchy):
    """cluster-2rack cut to 1800 s; the (2, 2) tree derates its second rack
    and turns the per-row reference comparison on."""
    jax_sc = jax_get_scenario("cluster-2rack").with_(duration_s=1800.0)
    if hierarchy is not None:
        jax_sc = jax_sc.with_hierarchy(hierarchy, budget_fracs={"1": 0.85}) \
                       .with_(compare_to_reference=True)
    want = jax_runner.run_experiment(jax_sc)
    got = runner.run_experiment(_port(jax_sc))
    assert want.cluster.n_brakes > 0 or want.result.cap_events > 0
    assert_experiments_equal(got, want)


def test_run_experiment_refuses_fault_timelines_like_jax():
    from repro_torch.chaos import FaultEvent

    sc = _port(_hot()).with_faults([FaultEvent("row-crash", t=60.0, row=0)])
    with pytest.raises(ValueError, match="fault timeline"):
        runner.run_experiment(sc)


def test_threshold_search_equals_jax():
    """Fig. 13's sweep on a 2 x 2 (T1, T2) x added-fraction grid."""
    base = _hot(duration_s=1200.0, fleet=dict(added_frac=0.0))
    combos, grid = [(0.85, 0.95), (0.9, 0.97)], [0.1, 0.3]
    want = jax_runner.threshold_search(base, combos, grid)
    got = runner.threshold_search(_port(base), combos, grid)
    assert list(got) == list(want)
    for key in want:
        assert got[key]["max_added_no_brake"] == want[key]["max_added_no_brake"]
        assert got[key]["max_added_slo"] == want[key]["max_added_slo"]
        for (ga, go), (wa, wo) in zip(got[key]["rows"], want[key]["rows"]):
            assert ga == wa
            assert_experiments_equal(go, wo)


def test_legacy_evaluate_and_threshold_search_equal_jax():
    """``core.oversubscription``'s positional wrappers (calibrated budget,
    a bare policy factory) and ``core.phase_aware.sweep``."""
    results = []
    for port, mod, policy, pa in (
            (True, oversubscription, PolcaPolicy, phase_aware),
            (False, jax_oversubscription, JaxPolcaPolicy, jax_phase_aware)):
        server, _, wls, shares = _setup(port)
        ev = mod.evaluate(policy, wls, shares, server, 20, 26, 1200.0, seed=4,
                          power_scale=1.15, occ_peak=0.95)
        ts = mod.threshold_search([(0.88, 0.96)], wls, shares, server, 20,
                                  1200.0, [0.2], power_scale=1.15,
                                  occ_peak=0.95)
        sweep = pa.sweep(wls[0].timing, server, 150.0, [0.6, 0.8, 1.0])
        results.append((ev, ts, sweep))
    (gev, gts, gsw), (wev, wts, wsw) = results
    assert_experiments_equal(gev, wev)
    assert gts[(0.88, 0.96)]["max_added_slo"] == wts[(0.88, 0.96)]["max_added_slo"]
    assert_experiments_equal(gts[(0.88, 0.96)]["rows"][0][1],
                             wts[(0.88, 0.96)]["rows"][0][1])
    assert [dataclasses.astuple(o) for o in gsw] == \
        [dataclasses.astuple(o) for o in wsw]


# ---------------------------------------------------------------------------
# the event-driven Monte-Carlo engine
# ---------------------------------------------------------------------------

def assert_ensembles_equal(got, want):
    assert got.base_name == want.base_name and got.budget_w == want.budget_w
    for name in ("power_t", "power_frac", "brake_counts", "peak_fracs",
                 "mean_fracs"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert len(got.members) == len(want.members)
    for g, w in zip(got.members, want.members):
        assert g.scenario.to_dict() == w.scenario.to_dict()
        assert_sim_results_equal(g.result, w.result)
        assert_stats_equal(g.stats, w.stats)
        assert g.meets == w.meets
    assert got.summary() == want.summary()
    assert got.brake_cvar(0.5) == want.brake_cvar(0.5)
    assert got.slo_violation_prob() == want.slo_violation_prob()


def _jax_ensemble(n_workers: int, with_reference: bool):
    """JAX's run_ensemble(engine="numpy"), recorded. Histogram sums are
    float sums in shard-merge order, so each worker count is held against
    JAX's at the same count."""
    spec = jax_mc.EnsembleSpec(_hot(), n_seeds=3, seed0=40,
                               n_workers=n_workers,
                               with_reference=with_reference)
    rec = JaxRecorder()
    with jax_recording(rec):
        res = jax_mc.run_ensemble(spec)
    return res, _snapshot_without_spans(rec)


@pytest.mark.parametrize("with_reference", [False, True],
                         ids=["no-reference", "with-reference"])
@pytest.mark.parametrize("n_workers", [1, 2])
def test_run_ensemble_numpy_equals_jax(n_workers, with_reference):
    want, want_snap = _jax_ensemble(n_workers, with_reference)
    spec = mc.EnsembleSpec(_port(_hot()), n_seeds=3, seed0=40,
                           n_workers=n_workers, with_reference=with_reference)
    rec = MetricsRecorder()
    with recording(rec):
        got = mc.run_ensemble(spec, engine="numpy")
    assert_ensembles_equal(got, want)
    assert int(want.brake_counts.sum()) > 0
    assert _snapshot_without_spans(rec) == want_snap
    spans = {k[0] for k in rec.snapshot().spans}
    assert {"mc/run_ensemble", "mc/shard"} <= spans


def test_run_ensemble_grid_numpy_and_sequential_equal_jax():
    bases = [_hot(duration_s=900.0),
             _hot(duration_s=900.0).with_(name="hot-bursty",
                                         traffic=JaxTrafficSpec(
                                             occ_peak=0.95, generator="bursty"))]
    want = jax_mc.run_ensemble_grid(bases, n_seeds=2, seed0=7, n_workers=1)
    got = mc.run_ensemble_grid([_port(b) for b in bases], n_seeds=2, seed0=7,
                               n_workers=2, engine="numpy")
    assert list(got) == list(want)
    for name in want:
        assert_ensembles_equal(got[name], want[name])
    spec = jax_mc.EnsembleSpec(bases[0], n_seeds=2, seed0=7)
    want_seq = jax_mc.run_ensemble_sequential(spec, n_members=1)
    got_seq = mc.run_ensemble_sequential(
        mc.EnsembleSpec(_port(bases[0]), n_seeds=2, seed0=7), n_members=1)
    assert len(got_seq) == len(want_seq) == 1
    assert_experiments_equal(got_seq[0], want_seq[0])


# ---------------------------------------------------------------------------
# planner decisions
# ---------------------------------------------------------------------------

def assert_plans_equal(got, want, *, peak_rtol=0.0):
    """Identical decisions and probe verdicts; the probes' peak power
    exactly, or within the batched engines' power contract (1e-6)."""
    assert got.scenario_name == want.scenario_name
    assert got.budget_w == want.budget_w
    assert got.safe_added_servers == want.safe_added_servers
    assert got.capped == want.capped
    assert got.feasible_at_zero == want.feasible_at_zero
    assert [(p.added_servers, p.feasible, p.brake_prob, p.slo_violation_prob)
            for p in got.probes] == \
        [(p.added_servers, p.feasible, p.brake_prob, p.slo_violation_prob)
         for p in want.probes]
    np.testing.assert_allclose([p.peak_frac_max for p in got.probes],
                               [p.peak_frac_max for p in want.probes],
                               rtol=peak_rtol, atol=0.0)


def test_plan_capacity_numpy_equals_jax():
    """plan_capacity(engine="numpy") on mc-diurnal cut to 1800 s, 2 seeds:
    the same probes, verdicts and decision; the recorder's probe events and
    counters too."""
    base = jax_get_scenario("mc-diurnal").with_(duration_s=1800.0,
                                                power_scale=1.1)
    kw = dict(n_seeds=2, seed0=11, max_added_frac=0.5, n_workers=1)
    want_rec = JaxRecorder()
    with jax_recording(want_rec):
        want = jax_planner.plan_capacity(base, **kw)
    got_rec = MetricsRecorder()
    with recording(got_rec):
        got = planner.plan_capacity(_port(base), engine="numpy", **kw)
    assert_plans_equal(got, want)
    assert 0 < want.safe_added_servers < 10 and not want.capped
    assert _snapshot_without_spans(got_rec) == _snapshot_without_spans(want_rec)


def test_plan_scenarios_torch_equals_jax_batched_numpy():
    """Two mc-* scenarios cut to 900 s with 8 seeds under the envelope
    calibrated from the first: the port's plan_scenarios on the torch
    engine (CPU) against JAX's plan_capacity(engine="batched-numpy") per
    scenario."""
    names = ["mc-diurnal", "mc-bursty"]
    bases = [jax_get_scenario(n).with_(duration_s=900.0, power_scale=1.1)
             for n in names]
    kw = dict(n_seeds=8, seed0=21, max_added_frac=0.6)
    budget = jax_mc.resolve_ensemble_budget(bases[0])
    want = {b.name: jax_planner.plan_capacity(b, budget_w=budget,
                                              engine="batched-numpy", **kw)
            for b in bases}
    got = planner.plan_scenarios([_port(b) for b in bases], engine="torch",
                                 device="cpu", **kw)
    assert list(got) == names
    for name in names:
        assert got[name].budget_w == budget
        assert_plans_equal(got[name], want[name], peak_rtol=1e-6)
