"""The port's lowering (``repro_torch.provisioning.batched.lower_ensemble``)
against the JAX package's.

The same scenario, built by the JAX package's parity helper and carried to
the port through ``Scenario.to_dict``/``from_dict``, is lowered by both
packages. The port keeps its own copy of the numpy layers (generators,
power plane, policies), so this is what holds the copies to the reference:
every array of the two ``TickModel``s is exactly equal and every scalar is
equal.
"""

import dataclasses

import numpy as np
import pytest

from conftest import PARITY_GENERATORS, parity_scenario

from repro.chaos.faults import FaultEvent, FaultSpec
from repro.experiments.scenario import HierarchySpec
from repro.provisioning.batched import lower_ensemble as jax_lower_ensemble
from repro.provisioning.montecarlo import EnsembleSpec as JaxEnsembleSpec
from repro_torch.chaos import FaultEvent as PortFaultEvent
from repro_torch.chaos import FaultSpec as PortFaultSpec
from repro_torch.experiments.scenario import HierarchySpec as PortHierarchySpec
from repro_torch.experiments.scenario import Scenario
from repro_torch.provisioning.batched import lower_ensemble
from repro_torch.provisioning.montecarlo import EnsembleSpec


@pytest.mark.parametrize("policy", ["polca", "polca-predictive"])
@pytest.mark.parametrize("generator", PARITY_GENERATORS)
def test_lowering_equals_jax(generator, policy):
    sc = parity_scenario(generator=generator, n_rows=3, occ_peak=0.95,
                         duration_s=3600.0, policy=policy)
    want, want_members, want_budget = jax_lower_ensemble(
        JaxEnsembleSpec(sc, n_seeds=3, seed0=77))
    got, got_members, got_budget = lower_ensemble(
        EnsembleSpec(Scenario.from_dict(sc.to_dict()), n_seeds=3, seed0=77))
    assert got_budget == want_budget
    assert [m.to_dict() for m in got_members] == \
        [m.to_dict() for m in want_members]
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b and type(a) is type(b), f.name


@pytest.mark.parametrize("name", ["cluster-2rack", "cluster-six-week"])
def test_registered_scenarios_equal_jax(name):
    from repro.experiments.scenario import get_scenario as jax_get_scenario
    from repro_torch.experiments.scenario import get_scenario, list_scenarios

    assert name in list_scenarios()
    assert get_scenario(name).to_dict() == jax_get_scenario(name).to_dict()


@pytest.mark.parametrize("field,value", [
    pytest.param("routing", {"router": "round-robin"}, id="routing-value0"),
    pytest.param("controller", {"kind": "static"}, id="controller-value3"),
    pytest.param("alerts", [], id="alerts-value4"),
])
def test_unported_scenario_fields_raise(field, value):
    d = parity_scenario().to_dict()
    d[field] = value
    with pytest.raises(NotImplementedError, match=field):
        Scenario.from_dict(d)


def _assert_models_equal(got, want):
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), f.name
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b and type(a) is type(b), f.name


def _lower_both(sc, n_seeds=2, seed0=5):
    want = jax_lower_ensemble(JaxEnsembleSpec(sc, n_seeds=n_seeds,
                                              seed0=seed0))
    got = lower_ensemble(EnsembleSpec(Scenario.from_dict(sc.to_dict()),
                                      n_seeds=n_seeds, seed0=seed0))
    return got, want


# fault timelines over a two-level tree whose interior nodes are "site",
# "pdu0", "pdu1": every event kind, derates with and without ramp and until
FAULT_TIMELINES = {
    "crash-revive": [
        FaultEvent("row-crash", t=300.0, row=1),
        FaultEvent("row-revive", t=900.0, row=1),
        FaultEvent("row-crash", t=1500.0, row=0)],
    "derate-step": [FaultEvent("node-derate", t=600.0, node="pdu1",
                               factor=0.7)],
    "derate-ramp-until": [FaultEvent("node-derate", t=400.0, node="pdu0",
                                     factor=0.6, until=1300.0, ramp_s=240.0)],
    "derate-until": [FaultEvent("node-derate", t=200.0, node="site",
                                factor=0.8, until=1000.0)],
    "demand-response": [
        FaultEvent("site-demand-response", t=1200.0, factor=0.9,
                   until=1600.0),
        FaultEvent("site-demand-response", t=100.0, factor=0.95,
                   ramp_s=300.0)],
    "all": [
        FaultEvent("node-derate", t=700.0, node="pdu1", factor=0.5,
                   until=1400.0, ramp_s=120.0),
        FaultEvent("row-crash", t=300.0, row=2),
        FaultEvent("row-revive", t=900.0, row=2),
        FaultEvent("site-demand-response", t=1200.0, factor=0.9,
                   until=1600.0)],
}


@pytest.mark.parametrize("timeline", sorted(FAULT_TIMELINES))
@pytest.mark.parametrize("shape", [(2, 2), (2, 3)])
def test_lowering_with_hierarchy_and_faults_equals_jax(shape, timeline):
    """alive, budget_scale, row_budget_w, node_matrix, node_names and every
    other field of the port's lowering equal the JAX package's."""
    sc = parity_scenario(
        n_rows=shape[0] * shape[1], occ_peak=0.95, duration_s=1800.0,
        hierarchy=HierarchySpec(shape=shape, budget_fracs={"1": 0.9}),
        faults=FaultSpec(tuple(FAULT_TIMELINES[timeline])))
    (got, _, got_budget), (want, _, want_budget) = _lower_both(sc)
    assert got_budget == want_budget
    _assert_models_equal(got, want)
    assert got.node_matrix is not None and got.node_names == want.node_names
    assert (got.alive != 1.0).any() or (got.budget_scale != 1.0).any()


def test_lowering_with_three_level_hierarchy_equals_jax():
    sc = parity_scenario(n_rows=12, duration_s=1800.0, hierarchy=HierarchySpec(
        shape=(2, 2, 3), budget_fracs={"0/1": 0.8, "1": 0.9}))
    (got, _, _), (want, _, _) = _lower_both(sc)
    _assert_models_equal(got, want)
    assert got.node_names[-1] == "site" and len(got.node_names) == 12 + 7


def test_lowering_rejects_bad_faults_and_hierarchies():
    derate = PortFaultSpec((PortFaultEvent("node-derate", t=60.0, node="pdu0",
                                   factor=0.5),))
    base = Scenario.from_dict(parity_scenario(duration_s=1800.0).to_dict())
    with pytest.raises(ValueError, match="no HierarchySpec"):
        lower_ensemble(EnsembleSpec(base.with_faults(derate), n_seeds=1))
    with pytest.raises(ValueError, match="implies 6 rows"):
        lower_ensemble(EnsembleSpec(
            base.with_(hierarchy=PortHierarchySpec(shape=(2, 3))), n_seeds=1))
    late = [PortFaultEvent("row-crash", t=5000.0, row=0)]
    with pytest.raises(ValueError, match="beyond the trace duration"):
        lower_ensemble(EnsembleSpec(base.with_faults(late), n_seeds=1))
    ghost = PortFaultSpec((PortFaultEvent("node-derate", t=60.0, node="pdu9",
                                  factor=0.5),))
    with pytest.raises(ValueError, match="pdu9"):
        lower_ensemble(EnsembleSpec(
            base.with_hierarchy((2, 2)).with_faults(ghost), n_seeds=1))
    # an empty timeline is the fault-free lowering
    a = lower_ensemble(EnsembleSpec(base.with_faults(()), n_seeds=1))[0]
    assert (a.alive == 1.0).all() and (a.budget_scale == 1.0).all()


def test_compose_site_conserves_and_equals_jax():
    from repro.core.hierarchy import PowerHierarchy as JaxHierarchy
    from repro.provisioning.ensembles import compose_site as jax_compose_site
    from repro_torch.core.hierarchy import PowerHierarchy
    from repro_torch.provisioning import compose_site

    rows = np.random.default_rng(3).uniform(1e3, 2e4, (6, 50))
    for kw in (dict(rows_per_rack=2), dict(rows_per_rack=3)):
        got, want = compose_site(rows, **kw), jax_compose_site(rows, **kw)
        for name in ("row_w", "rack_w", "site_w", "rack_of", "node_w"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
        assert got.node_names == want.node_names
        np.testing.assert_allclose(got.site_w, rows.sum(axis=0), rtol=1e-12)
    tree = PowerHierarchy.from_shape((3, 2), np.ones(6))
    got = compose_site(rows, hierarchy=tree)
    want = jax_compose_site(rows, hierarchy=JaxHierarchy.from_shape(
        (3, 2), np.ones(6)))
    np.testing.assert_array_equal(got.node_w, want.node_w)
    np.testing.assert_array_equal(got.rack_w, want.rack_w)
    np.testing.assert_array_equal(tree.node_w(rows[:, 7]),
                                  got.node_w[:, 7])
    with pytest.raises(ValueError, match="ragged"):
        compose_site(rows[:5], rows_per_rack=2)


def test_calibrated_budget_raises_until_simulator_is_ported():
    """The event-driven simulator is ported, so a calibrated budget no
    longer raises: it lowers, pinned to the budget the JAX package's
    lowering resolves, bit for bit. Nominal and explicit watts lower too."""
    jax_sc = parity_scenario().with_(budget="calibrated")
    sc = Scenario.from_dict(jax_sc.to_dict())
    model, _, pinned = lower_ensemble(EnsembleSpec(sc, n_seeds=2))
    assert pinned == jax_lower_ensemble(JaxEnsembleSpec(jax_sc, n_seeds=2))[2]
    assert model.row_budget_w.tolist() == [pinned] * model.n_rows
    for budget in ("nominal", 90_000.0):
        model, _, pinned = lower_ensemble(
            EnsembleSpec(sc.with_(budget=budget), n_seeds=2))
        assert model.row_budget_w.tolist() == [pinned] * model.n_rows


def test_lowering_rejects_short_scenarios():
    sc = Scenario.from_dict(parity_scenario(duration_s=60.0).to_dict())
    with pytest.raises(ValueError, match="duration"):
        lower_ensemble(EnsembleSpec(sc, n_seeds=2))
