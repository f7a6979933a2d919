"""The port's planner path end to end, on ``device="cpu"``, against the JAX
package.

* ``engine="cuda"`` (which takes the kernel's plain version on CPU tensors)
  against the numpy tick oracle that drives the real policy objects, on the
  *same* model: lowered by the JAX package and carried across by
  ``TickModel.from_numpy``.
* ``engine="torch"`` (the scan engine) against the same oracle, the port
  lowering the scenario itself: every generator family under ``polca`` and
  ``polca-predictive``, predictive brakes that fire, the hierarchy node
  fold, fault timelines (the cases of tests/test_batched_parity.py).

The contract is DESIGN.md §15's: brake-tick sets and counts bit-identical,
power series within 1e-6 relative, SLO impacts within 1e-6 (atol 1e-9).
``EnsembleResult`` statistics and ``plan_capacity`` decisions are held
against JAX's ``engine="batched-numpy"`` on both engines.
"""

import dataclasses

import numpy as np
import pytest

from conftest import (
    PARITY_GENERATORS,
    PARITY_POWER_RTOL,
    assert_engine_parity,
    parity_scenario,
)

from repro.chaos.faults import FaultEvent, FaultSpec
from repro.experiments.scenario import HierarchySpec
from repro.provisioning.batched import lower_ensemble as jax_lower_ensemble
from repro.provisioning.batched import run_tick_model as jax_run_tick_model
from repro.provisioning.montecarlo import EnsembleSpec as JaxEnsembleSpec
from repro.provisioning.montecarlo import run_ensemble as jax_run_ensemble
from repro.provisioning.planner import RiskConstraints as JaxRiskConstraints
from repro.provisioning.planner import plan_capacity as jax_plan_capacity
from repro_torch.experiments.scenario import Scenario
from repro_torch.provisioning import (
    EnsembleSpec,
    RiskConstraints,
    TickModel,
    lower_ensemble,
    plan_capacity,
    run_ensemble,
    run_tick_model,
)

HALF_HOUR = 1800.0


def _port_scenario(sc) -> Scenario:
    return Scenario.from_dict(sc.to_dict())


def _oracle_and_port(sc, *, n_seeds=2, seed0=1000):
    """Lower once with the JAX package, run its numpy tick oracle, carry the
    model across and run the port's engine on the CPU."""
    model, members, _ = jax_lower_ensemble(
        JaxEnsembleSpec(sc, n_seeds=n_seeds, seed0=seed0))
    oracle = jax_run_tick_model(model, members, engine="numpy")
    port_model = TickModel.from_numpy(
        {f.name: getattr(model, f.name) for f in dataclasses.fields(model)})
    return oracle, run_tick_model(port_model, engine="cuda", device="cpu")


@pytest.mark.parametrize("generator", PARITY_GENERATORS)
def test_engine_matches_numpy_oracle(generator):
    sc = parity_scenario(generator=generator, occ_peak=0.97,
                         power_scale=1.15, duration_s=HALF_HOUR)
    oracle, port = _oracle_and_port(sc, seed0=11)
    assert port.engine == "cuda"
    assert_engine_parity(oracle, port)


def test_brakes_actually_fire_and_match():
    """At power_scale=1.30 the fleet must brake, and the brake-tick sets
    still match the oracle bit for bit."""
    sc = parity_scenario(occ_peak=0.99, power_scale=1.30,
                         duration_s=HALF_HOUR)
    oracle, port = _oracle_and_port(sc)
    assert oracle.n_brakes.sum() > 0, "scenario failed to exercise brakes"
    np.testing.assert_array_equal(port.brake_ticks(), oracle.brake_ticks())
    assert_engine_parity(oracle, port)


def test_fault_and_hierarchy_model_matches_oracle():
    """A model the port cannot lower yet (fault timeline + hierarchy), made
    by the JAX package: the engine applies its row-alive mask, per-tick
    budget scales and node fold like the oracle."""
    faults = FaultSpec((
        FaultEvent("node-derate", t=600.0, node="pdu1", factor=0.6,
                   until=1200.0, ramp_s=120.0),
        FaultEvent("row-crash", t=300.0, row=1),
        FaultEvent("row-revive", t=900.0, row=1),
    ))
    sc = parity_scenario(n_rows=4, occ_peak=0.95, power_scale=1.15,
                         duration_s=HALF_HOUR,
                         hierarchy=HierarchySpec(shape=(2, 2)), faults=faults)
    oracle, port = _oracle_and_port(sc)
    assert port.node_w is not None
    assert_engine_parity(oracle, port)


def test_predictive_policy_is_rejected():
    """The kernel runs the non-predictive tick loop, as the Pallas kernel
    does; a predictive model raises instead of running the wrong policy."""
    sc = parity_scenario(duration_s=HALF_HOUR, policy="polca-predictive")
    with pytest.raises(ValueError, match="predictive"):
        run_ensemble(EnsembleSpec(_port_scenario(sc), n_seeds=2),
                     device="cpu")


def _assert_statistics_match(got, want):
    assert got.budget_w == want.budget_w
    np.testing.assert_array_equal(got.brake_counts, want.brake_counts)
    np.testing.assert_array_equal(got.power_t, want.power_t)
    for name in ("peak_fracs", "mean_fracs", "power_frac"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=PARITY_POWER_RTOL, err_msg=name)
    assert got.brake_prob() == want.brake_prob()
    for alpha in (0.0, 0.5, 0.75):
        assert got.brake_cvar(alpha) == want.brake_cvar(alpha)
        for prio in ("high", "low"):
            np.testing.assert_allclose(got.slo_cvar(prio, alpha),
                                       want.slo_cvar(prio, alpha),
                                       rtol=PARITY_POWER_RTOL, atol=1e-9)
    levels = [0.8, 0.9, 1.0]
    np.testing.assert_array_equal(got.peak_exceedance(levels),
                                  want.peak_exceedance(levels))
    sg, sw = got.summary(), want.summary()
    assert sg.keys() == sw.keys()
    for k in sw:
        np.testing.assert_allclose(sg[k], sw[k], rtol=PARITY_POWER_RTOL,
                                   atol=1e-9, err_msg=k)


@pytest.mark.parametrize("generator", ["diurnal", "bursty", "failover-surge"])
def test_ensemble_statistics_match_jax(generator):
    sc = parity_scenario(generator=generator, occ_peak=0.97,
                         power_scale=1.12, duration_s=HALF_HOUR)
    want = jax_run_ensemble(JaxEnsembleSpec(sc, n_seeds=4, seed0=5),
                            engine="batched-numpy")
    got = run_ensemble(EnsembleSpec(_port_scenario(sc), n_seeds=4, seed0=5),
                       engine="cuda", device="cpu")
    _assert_statistics_match(got, want)


@pytest.mark.parametrize("generator", ["diurnal", "bursty"])
def test_torch_ensemble_statistics_match_jax_predictive(generator):
    sc = parity_scenario(generator=generator, occ_peak=0.98,
                         power_scale=1.2, duration_s=HALF_HOUR,
                         policy="polca-predictive")
    want = jax_run_ensemble(JaxEnsembleSpec(sc, n_seeds=4, seed0=5),
                            engine="batched-numpy")
    got = run_ensemble(EnsembleSpec(_port_scenario(sc), n_seeds=4, seed0=5),
                       engine="torch", device="cpu")
    _assert_statistics_match(got, want)


def test_dense_tail_mode_matches_member_objects():
    """member_stats=False (the mode a 10^5-member tail takes) gives the same
    statistics as the per-member objects."""
    sc = _port_scenario(parity_scenario(occ_peak=0.97, power_scale=1.12,
                                        duration_s=HALF_HOUR))
    spec = EnsembleSpec(sc, n_seeds=6, seed0=3)
    objs = run_ensemble(spec, device="cpu", member_stats=True)
    dense = run_ensemble(spec, device="cpu", member_stats=False,
                         keep_series=False, keep_brake_fire=False)
    assert len(objs.members) == 6 and dense.members == []
    assert dense.power_frac.size == 0
    np.testing.assert_array_equal(dense.brake_counts, objs.brake_counts)
    for prio in ("high", "low"):
        assert dense.slo_cvar(prio, 0.5) == objs.slo_cvar(prio, 0.5)
        assert dense.slo_percentile(prio, 99) == objs.slo_percentile(prio, 99)
    assert dense.slo_violation_prob() == objs.slo_violation_prob()


def test_planner_decisions_identical_to_jax():
    """plan_capacity lands on the same safe_added_servers with the same
    per-probe verdicts as the JAX package's batched-numpy engine (the case
    of test_batched_parity.py::test_planner_decisions_identical_across_engines)."""
    sc = parity_scenario(occ_peak=0.95, duration_s=HALF_HOUR,
                         n_provisioned=10, added_frac=0.0)
    gate = dict(max_brakes=0, max_slo_violation_prob=1.0, slo_cvar_alpha=0.5,
                max_slo_cvar=2.0, slo_cvar_priority="low")
    want = jax_plan_capacity(sc, n_seeds=4, seed0=42, engine="batched-numpy",
                             constraints=JaxRiskConstraints(**gate),
                             max_added_frac=0.4)
    got = plan_capacity(_port_scenario(sc), n_seeds=4, seed0=42,
                        engine="cuda", device="cpu",
                        constraints=RiskConstraints(**gate),
                        max_added_frac=0.4)
    assert got.safe_added_servers == want.safe_added_servers
    assert got.budget_w == want.budget_w
    assert [(p.added_servers, p.feasible) for p in got.probes] == \
        [(p.added_servers, p.feasible) for p in want.probes]
    for pg, pw in zip(got.probes, want.probes):
        assert pg.brake_prob == pw.brake_prob
        np.testing.assert_allclose(pg.slo_cvar, pw.slo_cvar, rtol=1e-6)
        np.testing.assert_allclose(pg.peak_frac_max, pw.peak_frac_max,
                                   rtol=PARITY_POWER_RTOL)


def test_torch_planner_decisions_identical_to_jax_predictive():
    """plan_capacity(engine="torch") on a predictive scenario: the same
    safe_added_servers and per-probe verdicts as JAX batched-numpy."""
    sc = parity_scenario(occ_peak=0.95, power_scale=1.2,
                         duration_s=HALF_HOUR, n_provisioned=10,
                         added_frac=0.0, policy="polca-predictive")
    gate = dict(max_brakes=0, max_slo_violation_prob=1.0, slo_cvar_alpha=0.5,
                max_slo_cvar=2.0, slo_cvar_priority="low")
    want = jax_plan_capacity(sc, n_seeds=4, seed0=42, engine="batched-numpy",
                             constraints=JaxRiskConstraints(**gate),
                             max_added_frac=0.4)
    got = plan_capacity(_port_scenario(sc), n_seeds=4, seed0=42,
                        engine="torch", device="cpu",
                        constraints=RiskConstraints(**gate),
                        max_added_frac=0.4)
    assert len(got.probes) >= 3
    assert got.safe_added_servers == want.safe_added_servers
    assert [(p.added_servers, p.feasible) for p in got.probes] == \
        [(p.added_servers, p.feasible) for p in want.probes]
    for pg, pw in zip(got.probes, want.probes):
        assert pg.brake_prob == pw.brake_prob
        np.testing.assert_allclose(pg.slo_cvar, pw.slo_cvar, rtol=1e-6)


def _torch_and_oracle(sc, *, n_seeds=2, seed0=1000):
    """The JAX package lowers ``sc`` and runs its numpy tick oracle; the
    port lowers the same scenario itself and runs engine="torch" on the
    CPU."""
    model, members, _ = jax_lower_ensemble(
        JaxEnsembleSpec(sc, n_seeds=n_seeds, seed0=seed0))
    oracle = jax_run_tick_model(model, members, engine="numpy")
    port_model, _, _ = lower_ensemble(
        EnsembleSpec(_port_scenario(sc), n_seeds=n_seeds, seed0=seed0))
    return oracle, run_tick_model(port_model, engine="torch", device="cpu")


@pytest.mark.parametrize("policy", ["polca", "polca-predictive"])
@pytest.mark.parametrize("generator", PARITY_GENERATORS)
def test_torch_engine_matches_numpy_oracle(generator, policy):
    sc = parity_scenario(generator=generator, occ_peak=0.97,
                         power_scale=1.15, duration_s=HALF_HOUR,
                         policy=policy)
    oracle, port = _torch_and_oracle(sc, seed0=11)
    assert port.engine == "torch"
    assert_engine_parity(oracle, port)


def test_torch_predictive_brakes_actually_fire_and_match():
    """At power_scale=1.30 the predictive policy must brake (brakes are
    never predicted), and the brake-tick sets match the oracle bit for
    bit. On a cooler scenario its early caps change the power series from
    the reactive policy's, so the slope window is exercised."""
    sc = parity_scenario(occ_peak=0.99, power_scale=1.30,
                         duration_s=HALF_HOUR, policy="polca-predictive")
    oracle, port = _torch_and_oracle(sc)
    assert oracle.n_brakes.sum() > 0, "scenario failed to exercise brakes"
    np.testing.assert_array_equal(port.brake_ticks(), oracle.brake_ticks())
    assert_engine_parity(oracle, port)
    runs = [_torch_and_oracle(parity_scenario(
        occ_peak=0.95, power_scale=1.1, duration_s=HALF_HOUR, policy=pol))
        for pol in ("polca", "polca-predictive")]
    assert not np.array_equal(runs[0][1].row_w, runs[1][1].row_w)
    assert_engine_parity(*runs[1])


@pytest.mark.parametrize("shape,generator,policy", [
    ((2, 2), "diurnal", "polca"),
    ((2, 3), "bursty", "polca-predictive"),
    ((3, 2), "colocated", "polca"),
])
def test_torch_hierarchy_node_fold_matches_oracle(shape, generator, policy):
    """The node fold of a lowered hierarchy matches the oracle, and the
    site fold conserves the row total."""
    sc = parity_scenario(generator=generator, n_rows=shape[0] * shape[1],
                         occ_peak=0.93, duration_s=HALF_HOUR, policy=policy,
                         hierarchy=HierarchySpec(shape=shape,
                                                 budget_fracs={"0": 0.85}))
    oracle, port = _torch_and_oracle(sc, seed0=3)
    assert_engine_parity(oracle, port)
    site = port.model.node_names.index("site")
    np.testing.assert_allclose(port.node_w[:, :, site],
                               port.row_w.sum(axis=2), rtol=1e-9)


@pytest.mark.parametrize("factor,t_fault,ramp,policy", [
    (0.6, 600, True, "polca"),
    (0.8, 250, False, "polca-predictive"),
    (0.5, 1000, True, "polca-predictive"),
])
def test_torch_fault_timeline_matches_oracle(factor, t_fault, ramp, policy):
    """Interior derates with and without a ramp, a row crash and revive,
    and site demand response, lowered by the port."""
    faults = FaultSpec((
        FaultEvent("node-derate", t=float(t_fault), node="pdu1",
                   factor=factor, until=float(t_fault + 600),
                   ramp_s=120.0 if ramp else 0.0),
        FaultEvent("row-crash", t=300.0, row=1),
        FaultEvent("row-revive", t=900.0, row=1),
        FaultEvent("site-demand-response", t=1200.0, factor=0.9,
                   until=1600.0),
    ))
    sc = parity_scenario(n_rows=4, occ_peak=0.95, power_scale=1.15,
                         duration_s=HALF_HOUR, policy=policy,
                         hierarchy=HierarchySpec(shape=(2, 2)), faults=faults)
    oracle, port = _torch_and_oracle(sc, seed0=t_fault)
    assert_engine_parity(oracle, port)


def test_planner_rejects_survivability_gate():
    """The survive gate runs the routed fleet: on an unrouted scenario it
    raises, as on the batched engines, before any probe runs."""
    from repro_torch.chaos import FaultEvent, FaultSpec

    sc = _port_scenario(parity_scenario(duration_s=HALF_HOUR))
    crash = FaultSpec((FaultEvent("row-crash", t=60.0, row=0),))
    with pytest.raises(ValueError, match="survive"):
        plan_capacity(sc, device="cpu",
                      constraints=RiskConstraints(survive=crash))


def _main_path_model(n_seeds: int):
    """The dense-tail bench scenario of benchmarks/batched_engine.py (the
    main path of chip_smoke.py), lowered by the port at ``n_seeds``
    members."""
    from repro_torch.experiments.scenario import FleetSpec, TrafficSpec
    from repro_torch.provisioning.batched import lower_ensemble

    sc = Scenario(
        name="batched-bench-diurnal", duration_s=HALF_HOUR,
        fleet=FleetSpec(n_provisioned=20, added_frac=0.30, n_rows=2,
                        rows_per_rack=2),
        traffic=TrafficSpec(occ_peak=0.97, generator="diurnal"),
        budget="nominal", power_scale=1.15, compare_to_reference=False)
    return lower_ensemble(EnsembleSpec(sc, n_seeds=n_seeds, seed0=1))[0]


def test_effective_occupancy_is_time_major_and_bit_equal():
    """effective_occupancy returns an [N, T, R] view of time-major storage,
    bit-equal to the [N, T, R] contiguous expression it replaced."""
    import torch

    from repro_torch.provisioning.batched import (
        _interp_weights,
        effective_occupancy,
    )

    model = _main_path_model(7)
    occ = effective_occupancy(model, "cpu")
    assert tuple(occ.shape) == (7, model.n_ticks, model.n_rows)
    assert occ.permute(1, 0, 2).is_contiguous()
    i_idx, i_w = _interp_weights(model)
    occ60 = torch.as_tensor(model.occ60).transpose(1, 2)  # [N, T60, R]
    ii = torch.as_tensor(i_idx)
    w = torch.as_tensor(i_w)[:, None]
    want = ((occ60[:, ii] * (1.0 - w) + occ60[:, ii + 1] * w)
            * torch.as_tensor(model.alive)).contiguous()
    assert torch.equal(occ, want)


def test_freq_table_holds_main_path_frequencies():
    """On the main path's scenario (a few hundred members, brakes firing at
    a hotter power scale), every frequency of the plain version's planes is
    in the kernel's table, and the engine's planes are time-major."""
    import torch

    from repro_torch.kernels import tick
    from repro_torch.provisioning.batched import (
        effective_occupancy,
        tick_consts,
    )

    model = dataclasses.replace(_main_path_model(300), power_scale=1.30)
    occ = effective_occupancy(model, "cpu")
    consts = tick_consts(model)
    out = tick.polca_tick_plain(
        occ, torch.as_tensor(model.budget_scale),
        torch.as_tensor(model.row_budget_w), consts,
        oob_ticks=model.oob_ticks, brake_ticks=model.brake_ticks,
        ring_depth=model.ring_depth, esc=model.escalation_ticks)
    assert int(out["n_brakes"].sum()) > 0
    seen = set(np.unique(out["f_lp"].numpy())) | set(
        np.unique(out["f_hp"].numpy()))
    assert len(seen) > 2 and seen <= set(tick.freq_table(consts))
    assert all(out[k].permute(1, 0, 2).is_contiguous()
               for k in ("row_w", "fire", "f_lp", "f_hp"))
