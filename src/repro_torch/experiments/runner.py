"""Experiment execution: ``run_experiment(scenario)`` and sweeps (port of
``repro.experiments.runner``).

Build the Table-4 workload classes for the scenario's model/device, generate
the seeded arrival trace, calibrate the row power budget to the paper's
Table-2 operating point (unless the scenario pins it), run an uncapped
reference plus the policy run (row or multi-row cluster) on the event-driven
simulator, and gate the outcome against the SLOs. The budget rule and the
per-row construction points here are shared with the batched lowering
(``repro_torch.provisioning.batched``) and the event-driven Monte-Carlo
engine, so every path resolves budgets and builds rows the same way.

A routed fleet (``Scenario.routing``) is not ported: such a scenario raises
when it is built, so ``run_experiment`` runs rows and clusters only.
``core.oversubscription`` keeps the legacy positional wrappers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policy import NoCap
from repro_torch.core.simulator import Request, RowSimulator, SimConfig, SimResult, WorkloadClass
from repro_torch.core.slo import LatencyStats, impact_vs_reference, meets_slo
from repro_torch.core.traces import (
    build_workload_classes,
    generate_requests,
    get_occupancy_generator,
)
from repro_torch.experiments.cluster import ClusterResult, ClusterSimulator
from repro_torch.experiments.scenario import PolicySpec, Scenario

BASELINE_PEAK_UTIL = 0.79  # Table 2: inference rows peak at 79% of provisioned


@dataclass
class ExperimentResult:
    """Outcome of one scenario run (field-compatible with the old
    ``EvalOutcome`` for the row path; cluster runs add ``cluster``, whose
    ``result`` is row 0's)."""

    n_servers: int
    added_frac: float
    stats: LatencyStats
    result: SimResult  # policy run (row 0's result for cluster runs)
    ref_result: Optional[SimResult]
    meets: bool
    throughput_ratio_hp: Optional[float]
    throughput_ratio_lp: Optional[float]
    scenario: Optional[Scenario] = None
    budget_w: Optional[float] = None
    cluster: Optional[ClusterResult] = None


def build_workloads(scenario: Scenario) -> Tuple[List[WorkloadClass], List[float]]:
    """Table-4 workload classes for the scenario's model/device, with the
    scenario's priority-mix override applied (Fig. 15b sweeps)."""
    server = scenario.fleet.server()
    wls, shares = build_workload_classes(scenario.fleet.model, server)
    mix = scenario.traffic.priority_mix_override
    if mix is not None:
        wls = [WorkloadClass(w.name, w.timing, mix) for w in wls]
    return wls, shares


def _sim_config(scenario: Scenario, **overrides) -> SimConfig:
    tc = scenario.telemetry
    kw = dict(power_scale=scenario.power_scale, telemetry_s=tc.telemetry_s,
              oob_latency_s=tc.oob_latency_s, brake_latency_s=tc.brake_latency_s,
              record_power=tc.record_power)
    kw.update(overrides)
    return SimConfig(**kw)


def _generated_occupancy(scenario: Scenario, duration_s: float,
                         row: int = 0) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(t_grid, occupancy) from the scenario's registered generator, or None
    for the built-in diurnal default (which ``generate_requests`` produces
    itself — kept on the original code path so legacy traces replay
    bit-identically)."""
    tr = scenario.traffic
    if tr.generator == "diurnal" and not tr.gen_params:
        return None
    gen = get_occupancy_generator(tr.generator)
    t_grid = np.arange(0.0, duration_s, 60.0)
    occ = gen(t_grid, seed=scenario.seed, peak=tr.occ_peak,
              n_rows=scenario.fleet.n_rows, row=row, **tr.gen_params)
    return t_grid, occ


def row_trace(scenario: Scenario, workloads, shares, n_servers: int, *,
              seed: int, row: int = 0) -> List[Request]:
    """The seeded arrival trace for one row of the scenario. The occupancy
    curve comes from the scenario's trace generator (seeded by
    ``scenario.seed`` so correlated multi-row structure is preserved); the
    arrival sampling uses ``seed`` (per-row decorrelation in clusters)."""
    grid = _generated_occupancy(scenario, scenario.duration_s, row=row)
    if grid is None:
        return generate_requests(scenario.duration_s, n_servers, workloads,
                                 shares, seed=seed,
                                 occ_kwargs={"peak": scenario.traffic.occ_peak})
    t_grid, occ = grid
    return generate_requests(scenario.duration_s, n_servers, workloads, shares,
                             occupancy=occ, t_grid=t_grid, seed=seed)


def row_budgets(scenario: Scenario, budget_w: Optional[float],
                server) -> List[float]:
    """Per-row budgets in watts (``budget_w=None`` resolves to the nominal
    ``n_provisioned x server rating`` — the single copy of that rule).
    ``FleetSpec.row_budget_fracs`` scales each row's share of the envelope
    (heterogeneous PDU headroom)."""
    fleet = scenario.fleet
    base = (budget_w if budget_w is not None
            else fleet.n_provisioned * server.provisioned_w)
    fracs = fleet.row_budget_fracs
    if fracs is None:
        return [float(base)] * fleet.n_rows
    if len(fracs) != fleet.n_rows:
        raise ValueError(
            f"row_budget_fracs has {len(fracs)} entries for "
            f"{fleet.n_rows} rows")
    return [float(base) * float(f) for f in fracs]


def row_sim(scenario: Scenario, workloads, shares, server,
            budget_w: Optional[float], policy, reqs: List[Request], *,
            row_index: int = 0) -> RowSimulator:
    """The policy-run RowSimulator for one row of the scenario — the single
    construction point shared by ``run_experiment`` and the event-driven
    Monte-Carlo engine (``repro_torch.provisioning.montecarlo``), so
    ensemble members stay bit-identical with sequential runs by
    construction."""
    fleet = scenario.fleet
    return RowSimulator(workloads, server, fleet.n_servers, fleet.n_provisioned,
                        policy, reqs, shares, _sim_config(scenario),
                        duration=scenario.duration_s, provisioned_w=budget_w,
                        row_index=row_index)


def calibrated_budget(workloads, shares, server, n_provisioned: int,
                      duration: float, *, seed: int = 7, occ_peak: float = 0.62,
                      power_scale: float = 1.0, occupancy: np.ndarray = None,
                      t_grid: np.ndarray = None) -> float:
    """Row power budget such that the n_provisioned baseline peaks at 79% of
    it (the paper's Table-2 operating point — budgets are PDU limits, not the
    sum of server ratings). Pass ``occupancy``/``t_grid`` to calibrate
    against a generated (non-diurnal) occupancy curve."""
    reqs = generate_requests(duration, n_provisioned, workloads, shares, seed=seed,
                             occupancy=occupancy, t_grid=t_grid,
                             occ_kwargs={"peak": occ_peak})
    base = RowSimulator(workloads, server, n_provisioned, 100 * n_provisioned,
                        NoCap(), reqs, shares,
                        SimConfig(power_scale=power_scale, record_power=False),
                        duration=duration).run()
    peak_w = base.peak_power_frac * 100 * n_provisioned * server.provisioned_w
    return peak_w / BASELINE_PEAK_UTIL


def resolve_budget(scenario: Scenario, workloads, shares, server) -> Optional[float]:
    """The row budget in watts, or None for the nominal RowSimulator default
    (n_provisioned x server rating)."""
    if isinstance(scenario.budget, (int, float)):
        return float(scenario.budget)
    if scenario.budget == "nominal":
        return None
    if scenario.budget == "calibrated":
        cal_dur = min(scenario.duration_s, 2 * 86400.0)
        grid = _generated_occupancy(scenario, cal_dur)
        t_grid, occ = grid if grid is not None else (None, None)
        return calibrated_budget(
            workloads, shares, server, scenario.fleet.n_provisioned, cal_dur,
            seed=scenario.seed, occ_peak=scenario.traffic.occ_peak,
            power_scale=1.0, occupancy=occ, t_grid=t_grid)
    raise ValueError(f"unknown budget spec {scenario.budget!r}")


def run_experiment(scenario: Scenario, *,
                   workloads: Optional[Tuple[List[WorkloadClass], List[float]]] = None,
                   policy_factory=None, server=None) -> ExperimentResult:
    """Run one scenario end to end.

    ``workloads``, ``policy_factory``, and ``server`` are escape hatches for
    legacy call sites that already built (non-declarative) workload classes,
    pass a bare policy callable, or carry a custom ``ServerPower``;
    everything else resolves from the scenario itself.
    """
    if scenario.duration_s <= 0:
        raise ValueError(f"scenario {scenario.name!r}: duration_s must be > 0, "
                         f"got {scenario.duration_s}")
    faults = scenario.faults
    if faults is not None and not faults.is_noop:
        # the JAX package's ChaosInjector rides the routed fleet's tick
        # lockstep; the per-row/cluster paths have no dispatcher to fence
        # rows from (the batched lowering models faults on its own)
        raise ValueError(
            f"scenario {scenario.name!r} carries a fault timeline but no "
            f"RoutingSpec; the chaos engine needs a routed fleet (not ported "
            f"yet; the batched engines 'cuda' and 'torch' run fault "
            f"timelines)")
    server = server if server is not None else scenario.fleet.server()
    wls, shares = workloads if workloads is not None else build_workloads(scenario)
    budget_w = resolve_budget(scenario, wls, shares, server)
    mk = policy_factory if policy_factory is not None else scenario.policy.build
    if scenario.fleet.n_rows > 1:
        return _run_cluster(scenario, wls, shares, server, budget_w, mk)
    return _run_row(scenario, wls, shares, server, budget_w, mk)


def _throughput(reqs, prios, res: SimResult, prio: str) -> float:
    tot = sum(r.out_tokens for r in reqs if prios[r.rid] == prio)
    got = sum(r.out_tokens for r in reqs
              if prios[r.rid] == prio and r.rid in res.latencies)
    return got / max(1, tot)


def _reference_stats(reqs, res: SimResult, ref: Optional[SimResult]):
    """(stats, throughput_ratio_hp, throughput_ratio_lp) for a policy run,
    against its paired uncapped reference when one ran (the paper's
    capping-impact-only comparison), else raw ideal-relative stats."""
    if ref is None:
        return res.latency, None, None
    prios = {r.rid: r.priority for r in reqs}
    stats = impact_vs_reference(res.latencies, ref.latencies, prios)
    tr_hp = (_throughput(reqs, prios, res, "high")
             / max(1e-9, _throughput(reqs, prios, ref, "high")))
    tr_lp = (_throughput(reqs, prios, res, "low")
             / max(1e-9, _throughput(reqs, prios, ref, "low")))
    return stats, tr_hp, tr_lp


def _run_row(scenario: Scenario, wls, shares, server,
             budget_w: Optional[float], policy_factory) -> ExperimentResult:
    fleet = scenario.fleet
    n = fleet.n_servers
    reqs = row_trace(scenario, wls, shares, n, seed=scenario.seed)

    ref = None
    if scenario.compare_to_reference:
        # uncapped reference (infinite power budget: never brakes, never caps)
        ref = RowSimulator(wls, server, n, 10 * n, NoCap(), reqs, shares,
                           SimConfig(power_scale=scenario.power_scale,
                                     record_power=False),
                           duration=scenario.duration_s).run()
    res = row_sim(scenario, wls, shares, server, budget_w, policy_factory(),
                  reqs).run()

    stats, tr_hp, tr_lp = _reference_stats(reqs, res, ref)
    return ExperimentResult(
        n_servers=n,
        added_frac=n / fleet.n_provisioned - 1.0,
        stats=stats, result=res, ref_result=ref,
        meets=meets_slo(stats, res.n_brakes, scenario.slo),
        throughput_ratio_hp=tr_hp, throughput_ratio_lp=tr_lp,
        scenario=scenario, budget_w=budget_w,
    )


def _run_cluster(scenario: Scenario, wls, shares, server,
                 budget_w: Optional[float], policy_factory) -> ExperimentResult:
    fleet = scenario.fleet
    n = fleet.n_servers
    hspec = scenario.hierarchy
    hierarchy = None
    per_row_budget = [budget_w] * fleet.n_rows
    if hspec is not None:
        # planner-shaped budget tree: interior derates propagate down to the
        # per-row budgets (the tree stays conservative), exactly as in the
        # batched lowering — base budgets resolved by the same row_budgets
        # rule
        hierarchy = hspec.build(row_budgets(scenario, budget_w, server))
        per_row_budget = [float(b) for b in hierarchy.leaf_budget_w]
    rows = []
    traces = []
    for i in range(fleet.n_rows):
        # each row gets its own arrival trace (decorrelated arrivals; the
        # occupancy generator controls cross-row correlation structure)
        reqs = row_trace(scenario, wls, shares, n, seed=scenario.seed + i, row=i)
        traces.append(reqs)
        rows.append(row_sim(scenario, wls, shares, server, per_row_budget[i],
                            policy_factory(), reqs, row_index=i))
    cres = ClusterSimulator(rows, rows_per_rack=fleet.rows_per_rack,
                            telemetry_s=scenario.telemetry.telemetry_s,
                            hierarchy=hierarchy).run()
    if scenario.compare_to_reference:
        # per-row uncapped references on the same traces, merged cluster-wide
        stats = LatencyStats()
        for reqs, rr in zip(traces, cres.row_results):
            ref = RowSimulator(wls, server, n, 10 * n, NoCap(), reqs, shares,
                               SimConfig(power_scale=scenario.power_scale,
                                         record_power=False),
                               duration=scenario.duration_s).run()
            st = impact_vs_reference(rr.latencies, ref.latencies,
                                     {r.rid: r.priority for r in reqs})
            stats.hp_impacts.extend(st.hp_impacts)
            stats.lp_impacts.extend(st.lp_impacts)
    else:
        stats = LatencyStats(
            hp_impacts=[x for rr in cres.row_results for x in rr.latency.hp_impacts],
            lp_impacts=[x for rr in cres.row_results for x in rr.latency.lp_impacts])
    return ExperimentResult(
        n_servers=n * fleet.n_rows,
        added_frac=n / fleet.n_provisioned - 1.0,
        stats=stats, result=cres.row_results[0], ref_result=None,
        meets=meets_slo(stats, cres.n_brakes, scenario.slo),
        throughput_ratio_hp=None, throughput_ratio_lp=None,
        scenario=scenario, budget_w=budget_w, cluster=cres,
    )


def threshold_search(base: Scenario, combos: Sequence[Tuple[float, float]],
                     added_grid: Sequence[float], *,
                     workloads=None, server=None) -> Dict[Tuple[float, float], dict]:
    """Fig 13: per (T1,T2), the max added-server fraction that (a) avoids
    powerbrakes and (b) meets SLOs. The budget is calibrated once from the
    base scenario and pinned across the sweep."""
    server = server if server is not None else base.fleet.server()
    wls, shares = workloads if workloads is not None else build_workloads(base)
    budget = resolve_budget(base, wls, shares, server)
    if budget is None:  # "nominal": pin the explicit equivalent
        budget = base.fleet.n_provisioned * server.provisioned_w
    out = {}
    for (t1, t2) in combos:
        rows = []
        max_no_brake = 0.0
        max_slo = 0.0
        for add in added_grid:
            sc = (base.with_fleet(added_frac=add)
                      .with_policy("polca", t1=t1, t2=t2)
                      .with_(budget=budget))
            o = run_experiment(sc, workloads=(wls, shares), server=server)
            rows.append((add, o))
            if o.result.n_brakes == 0:
                max_no_brake = max(max_no_brake, add)
            if o.meets:
                max_slo = max(max_slo, add)
        out[(t1, t2)] = {"rows": rows, "max_added_no_brake": max_no_brake,
                         "max_added_slo": max_slo}
    return out
