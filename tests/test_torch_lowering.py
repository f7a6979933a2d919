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

from repro.provisioning.batched import lower_ensemble as jax_lower_ensemble
from repro.provisioning.montecarlo import EnsembleSpec as JaxEnsembleSpec
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
    ("routing", {"router": "round-robin"}),
    ("hierarchy", {"shape": (2, 2)}),
    ("faults", {"events": []}),
    ("controller", {"kind": "static"}),
    ("alerts", []),
])
def test_unported_scenario_fields_raise(field, value):
    d = parity_scenario().to_dict()
    d[field] = value
    with pytest.raises(NotImplementedError, match=field):
        Scenario.from_dict(d)


def test_calibrated_budget_raises_until_simulator_is_ported():
    sc = Scenario.from_dict(parity_scenario().to_dict()).with_(
        budget="calibrated")
    with pytest.raises(NotImplementedError, match="calibrated"):
        lower_ensemble(EnsembleSpec(sc, n_seeds=2))
    # nominal and explicit watts lower
    for budget in ("nominal", 90_000.0):
        model, _, pinned = lower_ensemble(
            EnsembleSpec(sc.with_(budget=budget), n_seeds=2))
        assert model.row_budget_w.tolist() == [pinned] * model.n_rows


def test_lowering_rejects_short_scenarios():
    sc = Scenario.from_dict(parity_scenario(duration_s=60.0).to_dict())
    with pytest.raises(ValueError, match="duration"):
        lower_ensemble(EnsembleSpec(sc, n_seeds=2))
