"""Grid semantics of the port's torch scan engine (DESIGN.md §16), on
``device="cpu"``: the scenario axis, member chunking, member sharding over
devices, dense-tail statistics, and ``plan_scenarios``. Mirrors
``tests/test_grid_engine.py`` with ``engine="torch"``.

The contract is bit-identity, not closeness: a grid, a chunked run and a
sharded run do the same elementwise float64 operations on every lane, so
their results must be identical to the per-scenario, flat, one-device run.

``test_grid_engine.py::test_plan_capacity_probe_count_does_not_multiply_
compiles`` (``jax_trace_count``) has no counterpart here: the torch engine
is eager PyTorch and compiles nothing.
"""

import numpy as np
import pytest

from conftest import parity_scenario

from repro.provisioning.montecarlo import resolve_ensemble_budget as jax_budget
from repro.provisioning.planner import RiskConstraints as JaxRiskConstraints
from repro.provisioning.planner import plan_capacity as jax_plan_capacity
from repro_torch.experiments.scenario import Scenario
from repro_torch.provisioning import (
    EnsembleSpec,
    RiskConstraints,
    lower_ensemble,
    plan_scenarios,
    run_batched_ensemble,
    run_batched_grid,
    run_ensemble,
    run_ensemble_grid,
    run_tick_model,
    run_tick_models,
)
from repro_torch.provisioning import batched

HALF_HOUR = 1800.0
GRID_GENERATORS = ("diurnal", "bursty", "colocated", "nighttime")
CPU = dict(engine="torch", device="cpu")


def _scenario(generator="diurnal", **kw) -> Scenario:
    kw.setdefault("duration_s", HALF_HOUR)
    return Scenario.from_dict(parity_scenario(generator=generator,
                                              **kw).to_dict())


def _grid_specs(n_seeds=4, **kw):
    return [EnsembleSpec(_scenario(g, **kw), n_seeds=n_seeds)
            for g in GRID_GENERATORS]


def _assert_results_identical(a, b):
    assert a.base_name == b.base_name
    np.testing.assert_array_equal(a.brake_counts, b.brake_counts)
    np.testing.assert_array_equal(a.peak_fracs, b.peak_fracs)
    np.testing.assert_array_equal(a.mean_fracs, b.mean_fracs)
    np.testing.assert_array_equal(a.power_frac, b.power_frac)
    for prio in ("high", "low"):
        np.testing.assert_array_equal(a.slo_impacts(prio),
                                      b.slo_impacts(prio))


def _assert_runs_identical(a, b):
    for name in ("brake_fire", "n_brakes", "peak_frac", "mean_frac",
                 "impacts_hp", "impacts_lp", "total_frac", "row_w", "node_w"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=name)


def _count_buckets(monkeypatch):
    calls = []
    real = batched._run_torch_models

    def counting(models, **kw):
        calls.append(len(models))
        return real(models, **kw)

    monkeypatch.setattr(batched, "_run_torch_models", counting)
    return calls


def test_grid_bit_identical_to_per_scenario_loop(monkeypatch):
    """M scenarios sharing tick geometry: one lane tensor, results
    bit-identical to M independent run_ensemble calls."""
    specs = _grid_specs()
    calls = _count_buckets(monkeypatch)
    grid = run_batched_grid(specs, **CPU)
    assert calls == [len(specs)], "a same-geometry grid must run as one bucket"
    loop = [run_ensemble(s, **CPU) for s in specs]
    for g, l in zip(grid, loop):
        _assert_results_identical(g, l)


def test_mixed_policies_bucket_apart_and_match_the_loop(monkeypatch):
    """Predictive and reactive scenarios differ in geometry key, so they run
    as two buckets; each result still equals its own run."""
    specs = [EnsembleSpec(_scenario("diurnal", occ_peak=0.97), n_seeds=3),
             EnsembleSpec(_scenario("bursty", occ_peak=0.97,
                                    policy="polca-predictive"), n_seeds=3),
             EnsembleSpec(_scenario("colocated", occ_peak=0.97), n_seeds=3)]
    calls = _count_buckets(monkeypatch)
    grid = run_batched_grid(specs, **CPU)
    assert sorted(calls) == [1, 2]
    for g, s in zip(grid, specs):
        _assert_results_identical(g, run_ensemble(s, **CPU))


def test_run_tick_models_equals_run_tick_model():
    """The model-level grid entry: every BatchedRun field of the stacked run
    equals the single-model run, bit for bit (hierarchy and predictive
    policy included)."""
    from repro_torch.experiments.scenario import HierarchySpec

    models = [lower_ensemble(EnsembleSpec(_scenario(
        g, n_rows=4, occ_peak=0.97, power_scale=1.2,
        policy="polca-predictive", hierarchy=HierarchySpec((2, 2))),
        n_seeds=3))[0] for g in GRID_GENERATORS[:3]]
    grid = run_tick_models(models, device="cpu")
    for m, g in zip(models, grid):
        assert g.engine == "torch" and g.node_w is not None
        _assert_runs_identical(g, run_tick_model(m, **CPU))


def test_run_ensemble_grid_dispatch():
    """run_ensemble_grid keys results by base name, with the numbers of
    run_ensemble, on both engines."""
    bases = [_scenario(g) for g in GRID_GENERATORS[:2]]
    for engine in ("torch", "cuda"):
        out = run_ensemble_grid(bases, n_seeds=3, engine=engine,
                                device="cpu")
        assert set(out) == {b.name for b in bases}
        for b in bases:
            single = run_ensemble(EnsembleSpec(b, n_seeds=3), engine=engine,
                                  device="cpu")
            _assert_results_identical(out[b.name], single)


@pytest.mark.parametrize("chunk", [3, 5, 12])
def test_member_chunk_invariance(chunk):
    """Members in blocks (a non-dividing chunk pads with cyclic members and
    slices back) are bit-identical to all members at once."""
    spec = EnsembleSpec(_scenario("bursty", occ_peak=0.97), n_seeds=12)
    flat = run_ensemble(spec, member_chunk=0, **CPU)
    chunked = run_ensemble(spec, member_chunk=chunk, **CPU)
    _assert_results_identical(flat, chunked)


@pytest.mark.parametrize("n_dev", [1, 2, 3])
def test_device_count_invariance(n_dev):
    """Members sharded over n devices (here n CPU shards) give the bits of
    one device."""
    spec = EnsembleSpec(_scenario("diurnal", occ_peak=0.97,
                                  policy="polca-predictive"), n_seeds=8)
    base = run_ensemble(spec, **CPU)
    sharded = run_ensemble(spec, engine="torch", devices=["cpu"] * n_dev)
    _assert_results_identical(base, sharded)


def test_sharded_and_chunked_compose():
    spec = EnsembleSpec(_scenario("colocated", occ_peak=0.97), n_seeds=10)
    base = run_ensemble(spec, **CPU)
    both = run_ensemble(spec, engine="torch", devices=["cpu", "cpu"],
                        member_chunk=2)
    _assert_results_identical(base, both)


def test_auto_chunk_rule_and_its_invariance(monkeypatch):
    """member_chunk=None keeps a shard in one block while it fits the
    memory budget and splits it into the fewest equal blocks past it; the
    result does not change."""
    spec = EnsembleSpec(_scenario("nighttime"), n_seeds=7)
    model = lower_ensemble(spec)[0]
    per_member = batched._lane_bytes(model, 1, True, True)
    assert batched._member_chunk(None, [model], 1, True, True) == 0
    monkeypatch.setattr(batched, "_AUTO_CHUNK_BYTES", 3 * per_member)
    assert batched._member_chunk(None, [model], 1, True, True) == 3
    assert batched._member_chunk(None, [model], 2, True, True) == 2
    assert batched._member_chunk(None, [model, model], 1, True, True) == 1
    auto = run_ensemble(spec, **CPU)
    monkeypatch.setattr(batched, "_AUTO_CHUNK_BYTES", 8 << 30)
    _assert_results_identical(auto, run_ensemble(spec, **CPU))
    with pytest.raises(ValueError, match="member_chunk"):
        run_ensemble(spec, member_chunk=-1, **CPU)


def test_dense_member_stats_equivalent():
    """member_stats=False drops the per-member python objects but every
    distributional statistic returns the same numbers."""
    spec = EnsembleSpec(_scenario("bursty", occ_peak=0.97), n_seeds=12)
    rich = run_batched_ensemble(spec, member_stats=True, **CPU)
    dense = run_batched_ensemble(spec, member_stats=False, **CPU)
    assert rich.n_members == dense.n_members == 12
    assert len(dense.members) == 0 and dense.member_impacts_hp is not None
    for prio in ("high", "low"):
        np.testing.assert_array_equal(rich.slo_impacts(prio),
                                      dense.slo_impacts(prio))
        for q in (50.0, 99.0):
            assert rich.slo_percentile(prio, q) == dense.slo_percentile(prio, q)
        for alpha in (0.0, 0.5, 0.9):
            assert rich.slo_cvar(prio, alpha) == dense.slo_cvar(prio, alpha)
    assert rich.meets_fraction() == dense.meets_fraction()
    assert rich.slo_violation_prob() == dense.slo_violation_prob()
    assert rich.summary() == dense.summary()


def test_keep_brake_fire_false_drops_plane_keeps_counts():
    model = lower_ensemble(EnsembleSpec(
        _scenario("diurnal", occ_peak=0.99, power_scale=1.3), n_seeds=3))[0]
    full = run_tick_model(model, **CPU)
    lean = run_tick_model(model, keep_brake_fire=False, keep_series=False,
                          **CPU)
    assert full.n_brakes.sum() > 0
    assert lean.brake_fire is None and lean.row_w is None
    np.testing.assert_array_equal(full.n_brakes, lean.n_brakes)
    np.testing.assert_array_equal(full.impacts_lp, lean.impacts_lp)
    with pytest.raises(ValueError, match="keep_brake_fire"):
        lean.brake_ticks()


def test_cuda_engine_rejects_predictive_and_torch_options():
    """The tick kernel runs the non-predictive loop, as the Pallas kernel
    does: a predictive scenario raises naming the engine that runs it, and
    the torch engine's knobs are refused."""
    spec = EnsembleSpec(_scenario(policy="polca-predictive"), n_seeds=2)
    with pytest.raises(ValueError, match="engine='torch'"):
        run_ensemble(spec, engine="cuda", device="cpu")
    with pytest.raises(ValueError, match="engine='torch'"):
        run_ensemble(EnsembleSpec(_scenario(), n_seeds=2), engine="cuda",
                     device="cpu", member_chunk=4)
    with pytest.raises(ValueError, match="engine='cuda'"):
        run_ensemble_grid([_scenario()], engine="jax", device="cpu")


def test_plan_scenarios_equals_a_loop_of_jax_plans():
    """plan_scenarios on the torch engine: every scenario's decisions equal
    JAX plan_capacity(engine="batched-numpy") at the envelope pinned from
    the first scenario."""
    kw = dict(occ_peak=0.95, power_scale=1.15, n_provisioned=10,
              added_frac=0.0, duration_s=HALF_HOUR)
    jax_bases = [parity_scenario(generator="diurnal", **kw),
                 parity_scenario(generator="bursty",
                                 policy="polca-predictive", **kw)]
    gate = dict(max_brakes=0, max_slo_violation_prob=1.0)
    got = plan_scenarios([Scenario.from_dict(b.to_dict()) for b in jax_bases],
                         constraints=RiskConstraints(**gate), n_seeds=3,
                         seed0=42, max_added_frac=0.4, **CPU)
    assert list(got) == [b.name for b in jax_bases]
    budget = jax_budget(jax_bases[0])
    for b in jax_bases:
        want = jax_plan_capacity(b, n_seeds=3, seed0=42, budget_w=budget,
                                 engine="batched-numpy", max_added_frac=0.4,
                                 constraints=JaxRiskConstraints(**gate))
        g = got[b.name]
        assert g.budget_w == want.budget_w == budget
        assert g.safe_added_servers == want.safe_added_servers
        assert [(p.added_servers, p.feasible, p.brake_prob)
                for p in g.probes] == \
            [(p.added_servers, p.feasible, p.brake_prob) for p in want.probes]
    assert plan_scenarios([], **CPU) == {}
