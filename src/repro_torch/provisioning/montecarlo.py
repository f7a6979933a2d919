"""Monte-Carlo ensembles of one scenario (port of ``repro.provisioning.montecarlo``).

An :class:`EnsembleSpec` names N seeded traffic realizations of a base
scenario, and ``run_ensemble`` evaluates them in one pass on one of three
engines, returning an :class:`EnsembleResult`: powerbrake-count CDFs and
CVaR, peak-power exceedance, pooled SLO percentiles — every statistic a
vectorized reduction over per-member arrays.

* ``engine="cuda"`` (the default) and ``engine="torch"`` are the batched
  tick engines of :mod:`repro_torch.provisioning.batched`: the first's tick
  loop is the hand-written CUDA kernel in ``kernels/csrc/tick.cu``, the
  second is the scan engine that also runs predictive policies. They run on
  ``device`` (the card unless ``device="cpu"``).
* ``engine="numpy"`` is the event-driven engine, the JAX package's default
  and the reference semantics the batched engines are held against: members
  run as a lockstep pool of :class:`~repro_torch.core.simulator.RowSimulator`
  objects (advanced on a shared stride grid, the drive mode of the cluster
  simulator), sharded across a small fork-based process pool on the host.
  A member whose scenario carries a ``RoutingSpec`` runs as a whole routed
  fleet (:class:`~repro_torch.fleet.fleet.FleetSimulator`, with its
  rebalancing controller and a fresh chaos injector per member) through the
  same lockstep protocol; this is the only engine that runs routed fleets,
  and the batched engines refuse them.
  Members are built through the same
  :func:`~repro_torch.experiments.runner.row_trace` / ``row_sim`` path as
  ``run_experiment``, so results are bit-identical to a sequential
  ``run_experiment`` loop over :meth:`EnsembleSpec.member_scenarios`.
  ``EnsembleSpec(with_reference=True)`` pairs each member with an uncapped
  reference run on the same trace (the paper's SLO comparison). It takes no
  device and no batched-engine option, and a missing card does not route
  here: it is asked for by name.

``run_ensemble_grid`` evaluates N seeds x M scenarios: one lane tensor per
geometry bucket on the torch engine (its default), one kernel launch per
scenario on the CUDA engine, one flat work list over the fork pool on the
event-driven engine.

The row power budget is resolved **once** from the base scenario and pinned
across every member: Monte-Carlo asks how one fixed infrastructure design
behaves under traffic uncertainty.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policy import NoCap
from repro_torch.core.simulator import RowSimulator, SimConfig, SimResult
from repro_torch.core.slo import (
    DEFAULT_SLO,
    SLO,
    LatencyStats,
    impact_vs_reference,
    meets_slo,
)
from repro_torch.experiments.runner import (
    ExperimentResult,
    build_workloads,
    resolve_budget,
    row_sim,
    row_trace,
    run_experiment,
)
from repro_torch.experiments.scenario import Scenario
from repro_torch.obs.metrics import (
    MetricsRecorder,
    MetricsSnapshot,
    NULL_RECORDER,
    get_recorder,
    recording,
)

import repro_torch.provisioning.ensembles  # noqa: F401  (registers trace generators)


@dataclass(frozen=True)
class EnsembleSpec:
    """N seeded members of one base scenario.

    ``seed0 + k`` seeds member ``k``'s traffic realization. ``n_workers``
    and ``lockstep_stride_s`` apply to the event-driven engine
    (``engine="numpy"``): ``n_workers`` defaults to the available CPUs
    (capped by the member count), pass 1 to force a single-process run;
    ``lockstep_stride_s`` only controls how often the lockstep driver yields
    between members — results are stride-invariant (the row event queues are
    exact regardless of drive granularity).

    ``with_reference=True`` pairs every member with an uncapped reference run
    on the same trace, so SLO stats are the paper's capping-impact-only
    comparison (what the planner gates on) instead of ideal-relative impacts
    that fold queueing noise in; it doubles the event-driven engine's cost.
    The batched engines' fluid SLO proxy is reference-free, so there it only
    changes the member scenarios.
    """

    base: Scenario
    n_seeds: int = 8
    seed0: int = 1000
    n_workers: Optional[int] = None
    lockstep_stride_s: float = 120.0
    with_reference: bool = False

    def seeds(self) -> List[int]:
        """The member seeds, in member order: ``seed0 + k`` for member k."""
        return [self.seed0 + k for k in range(self.n_seeds)]

    def member_scenarios(self, budget_w: Optional[float] = None) -> List[Scenario]:
        """The concrete per-member scenarios the engine simulates: pinned
        explicit budget, one seed each."""
        budget = self.base.budget if budget_w is None else float(budget_w)
        return [self.base.with_(name=f"{self.base.name}@s{s}", seed=s,
                                budget=budget,
                                compare_to_reference=self.with_reference)
                for s in self.seeds()]


@dataclass
class MemberStats:
    """One ensemble member: its scenario, the policy-run SimResult, and the
    SLO-impact stats (reference-relative when the member ran with a paired
    uncapped reference, ideal-relative otherwise)."""

    scenario: Scenario
    result: SimResult
    stats: LatencyStats

    @property
    def meets(self) -> bool:
        """Whether this member meets its scenario's SLO (brakes included)."""
        return meets_slo(self.stats, self.result.n_brakes, self.scenario.slo)


@dataclass
class EnsembleResult:
    """Distributional telemetry over one ensemble (vectorized accounting)."""

    base_name: str
    budget_w: float
    members: List[MemberStats]
    power_t: np.ndarray = field(repr=False)  # [T] telemetry grid
    power_frac: np.ndarray = field(repr=False)  # [N, T] of row budget
    brake_counts: np.ndarray = field(repr=False)  # [N]
    peak_fracs: np.ndarray = field(repr=False)  # [N]
    mean_fracs: np.ndarray = field(repr=False)  # [N]
    # dense-tail mode (``member_stats=False``): ``members`` stays empty and
    # per-member SLO impact samples ride as [N, K] arrays — the statistics
    # below fall back to vectorized paths over these, so a 10^5-member
    # result carries no per-member python objects
    member_impacts_hp: Optional[np.ndarray] = field(default=None, repr=False)
    member_impacts_lp: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def n_members(self) -> int:
        if self.members:
            return len(self.members)
        return int(len(self.brake_counts))

    def _dense_impacts(self, priority: str) -> Optional[np.ndarray]:
        """[N, K] impact samples in dense-tail mode, else None."""
        if self.members:
            return None
        return (self.member_impacts_hp if priority == "high"
                else self.member_impacts_lp)

    def _member_percentiles(self, priority: str, q: float) -> np.ndarray:
        """Per-member q-th percentile impact, [N] — member-object path and
        dense path produce bit-identical values (same np.percentile on the
        same samples; empty members are 0.0 like LatencyStats)."""
        dense = self._dense_impacts(priority)
        if dense is not None:
            if dense.shape[1] == 0:
                return np.zeros(dense.shape[0])
            return np.percentile(dense, q, axis=1)
        key = "hp_impacts" if priority == "high" else "lp_impacts"
        return np.asarray([
            float(np.percentile(np.asarray(getattr(m.stats, key)), q))
            if len(getattr(m.stats, key)) else 0.0
            for m in self.members])

    # -- powerbrake distribution -------------------------------------------
    def brake_prob(self, max_brakes: int = 0) -> float:
        """P[a member experiences more than ``max_brakes`` powerbrakes].
        The default (0) is the zero-tolerance P[>= 1 brake]; the planner
        passes its ``RiskConstraints.max_brakes`` budget here."""
        return float(np.mean(self.brake_counts > max_brakes))

    def brake_cdf(self) -> Tuple[np.ndarray, np.ndarray]:
        """(counts, P[brakes <= count]) — the powerbrake-count CDF."""
        counts = np.sort(self.brake_counts)
        return counts, np.arange(1, len(counts) + 1) / len(counts)

    def brake_cvar(self, alpha: float) -> float:
        """CVaR_alpha of the per-member powerbrake count: the expected count
        over the worst ``(1 - alpha)`` fraction of members.  Fractional tail
        mass is interpolated so the estimator is continuous in alpha."""
        return _cvar(np.asarray(self.brake_counts, float), alpha)

    def slo_cvar(self, priority: str, alpha: float, q: float = 99.0) -> float:
        """CVaR_alpha over the per-member P``q`` SLO impact of ``priority``.
        Each member contributes one tail statistic (its own q-th percentile
        impact); CVaR then averages the worst ``(1 - alpha)`` of those —
        the dense-tail gate behind ``RiskConstraints.slo_cvar_alpha``."""
        return _cvar(np.asarray(self._member_percentiles(priority, q),
                                float), alpha)

    # -- power distribution -------------------------------------------------
    def peak_exceedance(self, levels: Sequence[float]) -> np.ndarray:
        """P[member peak power > level] per level (fractions of budget)."""
        lv = np.asarray(levels, float)
        return (self.peak_fracs[None, :] > lv[:, None]).mean(axis=1)

    def power_exceedance(self, levels: Sequence[float]) -> np.ndarray:
        """Time-pooled P[instantaneous row power > level] over all members."""
        lv = np.asarray(levels, float)
        if self.power_frac.size == 0:
            return np.zeros_like(lv)
        # sort once + searchsorted per level: O(NT log NT), no [L, NT] matrix
        flat = np.sort(self.power_frac, axis=None)
        return 1.0 - np.searchsorted(flat, lv, side="right") / flat.size

    # -- SLO distribution ---------------------------------------------------
    def slo_impacts(self, priority: str) -> np.ndarray:
        """All per-request latency impacts of ``priority``, pooled."""
        dense = self._dense_impacts(priority)
        if dense is not None:
            return dense.ravel() if dense.size else np.zeros(0)
        key = "hp_impacts" if priority == "high" else "lp_impacts"
        xs = [getattr(m.stats, key) for m in self.members]
        return np.concatenate([np.asarray(x) for x in xs]) if any(
            len(x) for x in xs) else np.zeros(0)

    def slo_percentile(self, priority: str, q: float) -> float:
        xs = self.slo_impacts(priority)
        return float(np.percentile(xs, q)) if len(xs) else 0.0

    def _meets_mask(self, slo: SLO, include_brakes: bool) -> np.ndarray:
        """[N] bool per-member SLO gate, vectorized over both storage modes
        (same strict-< percentile comparisons as :func:`core.slo.meets_slo`)."""
        ok = ((self._member_percentiles("high", 50) < slo.hp_p50)
              & (self._member_percentiles("high", 99) < slo.hp_p99)
              & (self._member_percentiles("low", 50) < slo.lp_p50)
              & (self._member_percentiles("low", 99) < slo.lp_p99))
        if include_brakes:
            ok = ok & (np.asarray(self.brake_counts) <= slo.max_powerbrakes)
        return ok

    def meets_fraction(self, slo: Optional[SLO] = None) -> float:
        """Fraction of members meeting the SLO (per-member gate). ``slo=None``
        uses each member's own scenario SLO (dense-tail results, which carry
        no scenarios, fall back to :data:`~repro_torch.core.slo.DEFAULT_SLO`)."""
        if self.members:
            if slo is None:
                return float(np.mean([m.meets for m in self.members]))
            return float(np.mean([
                meets_slo(m.stats, m.result.n_brakes, slo)
                for m in self.members]))
        if self.n_members == 0:
            return float("nan")
        return float(np.mean(self._meets_mask(slo or DEFAULT_SLO, True)))

    def slo_violation_prob(self, slo: Optional[SLO] = None) -> float:
        """P[member misses the SLO], powerbrakes *excluded* (the planner
        constrains those separately via ``max_brake_prob``). Works in both
        member-object and dense-tail modes."""
        if self.n_members == 0:
            return 0.0
        return float(1.0 - np.mean(self._meets_mask(slo or DEFAULT_SLO,
                                                    False)))

    def summary(self) -> Dict[str, float]:
        """Headline distributional stats in one flat dict (benchmark rows)."""
        return {
            "n_members": float(self.n_members),
            "brake_prob": self.brake_prob(),
            "meets_frac": self.meets_fraction(),
            "peak_p50": float(np.median(self.peak_fracs)),
            "peak_max": float(self.peak_fracs.max()) if len(self.peak_fracs) else 0.0,
            "hp_p99": self.slo_percentile("high", 99),
            "lp_p99": self.slo_percentile("low", 99),
        }


def _cvar(xs: np.ndarray, alpha: float) -> float:
    """Interpolated upper-tail CVaR: mean of the worst ``(1 - alpha)``
    probability mass of ``xs``.  ``alpha=0`` degenerates to the plain mean,
    ``alpha -> 1`` to the sample maximum."""
    if not 0.0 <= alpha < 1.0:
        raise ValueError(f"alpha must be in [0, 1), got {alpha}")
    n = xs.size
    if n == 0:
        return 0.0
    ordered = np.sort(xs)[::-1]  # descending: worst first
    mass = (1.0 - alpha) * n  # tail size in member units, may be fractional
    if mass <= 1.0:
        return float(ordered[0])
    whole = int(math.floor(mass))
    total = float(ordered[:whole].sum())
    if whole < n and mass > whole:
        total += (mass - whole) * float(ordered[whole])
    return total / mass


_WLS_CACHE: Dict[tuple, tuple] = {}


def _cached_workloads(scenario: Scenario):
    key = (scenario.fleet.model, scenario.fleet.device,
           scenario.fleet.n_devices_per_server,
           scenario.traffic.priority_mix_override)
    if key not in _WLS_CACHE:
        _WLS_CACHE[key] = build_workloads(scenario)
    return _WLS_CACHE[key]


# ---------------------------------------------------------------------------
# the event-driven engine (engine="numpy")
# ---------------------------------------------------------------------------

def _member_budget_w(sc: Scenario) -> Optional[float]:
    if sc.budget == "nominal":
        return None  # RowSimulator default: n_provisioned x rating
    if isinstance(sc.budget, (int, float)):
        return float(sc.budget)
    raise ValueError(
        f"member {sc.name!r} reached the batch runner with budget="
        f"{sc.budget!r}; resolve it to watts first (run_ensemble "
        "pins the base scenario's resolved budget across members)")


def _finalize_member(sim) -> SimResult:
    """Row members finalize to a SimResult directly; fleet members collapse
    their FleetResult into the cluster-shaped equivalent."""
    res = sim.finalize()
    if isinstance(res, SimResult):
        return res
    from repro_torch.fleet.fleet import as_sim_result
    return as_sim_result(res)


def _run_shard(payload: Tuple[List[Scenario], float, int]
               ) -> Tuple[List[Tuple[SimResult, LatencyStats]],
                          Optional[MetricsSnapshot]]:
    """Worker: run one shard of members as a lockstep pool (the cluster
    drive mode: start all, advance all on a stride grid, finalize all).
    Members whose scenario requests a reference comparison get a paired
    uncapped reference simulation in the same lockstep pass. Members whose
    scenario carries a RoutingSpec run as whole routed fleets
    (:class:`~repro_torch.fleet.fleet.FleetSimulator`) — multi-row ensemble
    members lockstep next to single-row ones through the same drive
    protocol, with any declared ControllerSpec rebalancing their row budgets
    in-run. Workers run numpy and Python only: a pool forked from a process
    that has initialized CUDA never touches ``torch.cuda``.

    Observability: with a recorder installed (inherited across the fork),
    each member records into its **own** fresh recorder — member snapshots
    merge back in member order regardless of sharding, so event traces are
    worker-count-invariant. Reference twins record under the null recorder
    (they are a measurement baseline, not part of the observed run). The
    shard itself is timed by one ``mc/shard`` span, the fork-pool skew
    signal (wall-clock; excluded from determinism by nature). Returns
    ``(results, snapshot-or-None)``."""
    scenarios, stride, shard_idx = payload
    member_recs: Optional[List[MetricsRecorder]] = (
        [MetricsRecorder() for _ in scenarios]
        if get_recorder().enabled else None)
    shard_rec = MetricsRecorder() if member_recs is not None else NULL_RECORDER
    with shard_rec.span("mc/shard", shard=shard_idx,
                        members=len(scenarios)):
        out = _run_shard_pool(scenarios, stride, member_recs)
    if member_recs is None:
        return out, None
    snap = shard_rec.snapshot()
    for r in member_recs:
        snap.merge(r.snapshot())
    return out, snap


def _run_shard_pool(scenarios: List[Scenario], stride: float,
                    member_recs: Optional[List[MetricsRecorder]]
                    ) -> List[Tuple[SimResult, LatencyStats]]:
    sims: List[object] = []
    refs: List[Optional[object]] = []
    traces = []
    for sc in scenarios:
        wls, shares = _cached_workloads(sc)
        server = sc.fleet.server()
        n = sc.fleet.n_servers
        budget = _member_budget_w(sc)
        if sc.routing is not None:
            from repro_torch.fleet.fleet import build_fleet, fleet_trace
            reqs = fleet_trace(sc, wls, shares)
            traces.append(reqs)
            sims.append(build_fleet(sc, wls, shares, server, budget,
                                    sc.policy.build, reqs))
            refs.append(build_fleet(sc, wls, shares, server, budget,
                                    sc.policy.build, reqs, reference=True)
                        if sc.compare_to_reference else None)
            continue
        reqs = row_trace(sc, wls, shares, n, seed=sc.seed)
        traces.append(reqs)
        sims.append(row_sim(sc, wls, shares, server, budget,
                            sc.policy.build(), reqs))
        if sc.compare_to_reference:
            # uncapped twin, constructed exactly as run_experiment's _run_row
            refs.append(RowSimulator(wls, server, n, 10 * n, NoCap(), reqs,
                                     shares,
                                     SimConfig(power_scale=sc.power_scale,
                                               record_power=False),
                                     duration=sc.duration_s))
        else:
            refs.append(None)
    pool = sims + [r for r in refs if r is not None]
    # per-pool-slot recorder: member i records into its own recorder,
    # reference twins into the no-op null recorder
    pool_recs = ((list(member_recs)
                  + [NULL_RECORDER] * (len(pool) - len(sims)))
                 if member_recs is not None else [NULL_RECORDER] * len(pool))
    for s in pool:
        s.start()
    duration = max((s.duration for s in pool), default=0.0)
    alive = [True] * len(pool)
    t = stride
    while t <= duration and any(alive):
        for i, s in enumerate(pool):
            if alive[i]:
                with recording(pool_recs[i]):
                    alive[i] = s.advance_to(min(t, s.duration))
        t += stride
    for i, s in enumerate(pool):
        with recording(pool_recs[i]):
            s.advance_to(s.duration)
    out = []
    for k, (sim, ref, reqs) in enumerate(zip(sims, refs, traces)):
        with recording(pool_recs[k]):
            res = _finalize_member(sim)
        if ref is None:
            stats = res.latency
        else:
            with recording(NULL_RECORDER):
                ref_latencies = _finalize_member(ref).latencies
            stats = impact_vs_reference(res.latencies, ref_latencies,
                                        {r.rid: r.priority for r in reqs})
        out.append((res, stats))
    return out


def _map_shards(shards: List[Tuple[List[Scenario], float, int]],
                n_workers: int
                ) -> List[Tuple[List[Tuple[SimResult, LatencyStats]],
                                Optional[MetricsSnapshot]]]:
    if n_workers <= 1 or len(shards) <= 1:
        return [_run_shard(sh) for sh in shards]
    try:
        ctx = multiprocessing.get_context("fork")
        with ctx.Pool(processes=n_workers) as pool:
            return pool.map(_run_shard, shards)
    except (OSError, ValueError) as e:  # restricted sandboxes: no fork/sem
        warnings.warn(f"process pool unavailable ({e}); running inline")
        return [_run_shard(sh) for sh in shards]


def _default_workers(n_members: int, n_workers: Optional[int]) -> int:
    if n_workers is not None:
        return max(1, n_workers)
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:  # non-linux
        cpus = os.cpu_count() or 1
    return max(1, min(cpus, n_members))


def _run_members(members: List[Scenario], stride: float,
                 n_workers: int) -> List[Tuple[SimResult, LatencyStats]]:
    """One batched pass over concrete member scenarios, order-preserving.
    Worker metric snapshots fold back into the ambient recorder in shard
    (i.e. member) order, so the merged trace is identical for any worker
    count."""
    w = _default_workers(len(members), n_workers)
    bounds = np.linspace(0, len(members), w + 1).astype(int)
    spans = [(a, b) for a, b in zip(bounds, bounds[1:]) if b > a]
    shards = [(members[a:b], stride, si) for si, (a, b) in enumerate(spans)]
    rec = get_recorder()
    out: List[Tuple[SimResult, LatencyStats]] = []
    for results, snap in _map_shards(shards, len(shards)):
        out.extend(results)
        if snap is not None and rec.enabled:
            rec.merge_snapshot(snap)
    return out


def _ensemble_result(base: Scenario, budget_w: float, members: List[Scenario],
                     pairs: List[Tuple[SimResult, LatencyStats]]) -> EnsembleResult:
    stats = [MemberStats(sc, res, st) for sc, (res, st) in zip(members, pairs)]
    results = [res for res, _ in pairs]
    series = [res.power_w for res in results if res.power_w is not None]
    if series and all(len(s) == len(series[0]) for s in series):
        power = np.stack(series)
        power_t = results[0].power_t
    else:  # record_power off, or ragged (heterogeneous durations)
        power = np.zeros((0, 0))
        power_t = np.zeros(0)
    return EnsembleResult(
        base_name=base.name,
        budget_w=budget_w,
        members=stats,
        power_t=power_t,
        power_frac=power,
        brake_counts=np.asarray([r.n_brakes for r in results]),
        peak_fracs=np.asarray([r.peak_power_frac for r in results]),
        mean_fracs=np.asarray([r.mean_power_frac for r in results]),
    )


def resolve_ensemble_budget(base: Scenario) -> float:
    """The pinned row budget (watts) shared by every ensemble member."""
    wls, shares = _cached_workloads(base)
    server = base.fleet.server()
    budget = resolve_budget(base, wls, shares, server)
    if budget is None:  # "nominal": pin the explicit equivalent
        budget = base.fleet.n_provisioned * server.provisioned_w
    return float(budget)


def _refuse_batched_options(device, engine_opts: dict) -> None:
    """engine="numpy" runs on the host: a device or a batched-engine
    option is a caller's mistake, not something to ignore."""
    opts = sorted(engine_opts) + (["device"] if device is not None else [])
    if opts:
        raise ValueError(
            f"engine options {opts} only apply to the batched engines "
            "('cuda', 'torch'), not engine='numpy' (the event-driven engine "
            "runs on the host)")


def run_ensemble(spec: EnsembleSpec, *, budget_w: Optional[float] = None,
                 engine: str = "cuda", device=None,
                 **engine_opts) -> EnsembleResult:
    """Evaluate all members of ``spec`` in one pass.

    ``engine="cuda"`` is the tick engine whose inner loop is the hand-written
    CUDA kernel (the counterpart of the JAX package's ``"pallas"``,
    non-predictive policies); ``engine="torch"`` the scan engine (the
    counterpart of ``"jax"``). Both run on ``device`` (default: the CUDA
    card; raises when there is none unless ``device="cpu"`` is passed, which
    takes the kernel's plain PyTorch version or runs the scan engine on the
    CPU). ``engine_opts`` forward to
    :func:`~repro_torch.provisioning.batched.run_batched_ensemble`
    (``keep_series``, ``keep_brake_fire``, ``member_stats``, and for the
    torch engine ``member_chunk`` and ``devices``).

    ``engine="numpy"`` is the event-driven fork-pool engine above (the JAX
    package's default): it runs on the host, honours ``spec.n_workers``,
    ``spec.lockstep_stride_s`` and ``spec.with_reference``, and refuses
    ``device`` and every batched-engine option with ``ValueError``. A routed
    scenario (``Scenario.routing``) runs on it only: the batched engines
    refuse a ``RoutingSpec`` (``batched.lower_ensemble``).
    """
    if engine != "numpy":
        from repro_torch.provisioning.batched import run_batched_ensemble
        return run_batched_ensemble(spec, budget_w=budget_w, engine=engine,
                                    device=device, **engine_opts)
    _refuse_batched_options(device, engine_opts)
    with get_recorder().span("mc/run_ensemble", base=spec.base.name,
                             members=spec.n_seeds):
        budget = (resolve_ensemble_budget(spec.base) if budget_w is None
                  else float(budget_w))
        members = spec.member_scenarios(budget)
        results = _run_members(members, spec.lockstep_stride_s,
                               _default_workers(len(members), spec.n_workers))
        return _ensemble_result(spec.base, budget, members, results)


def run_ensemble_grid(bases: Sequence[Scenario], *, n_seeds: int = 8,
                      seed0: int = 1000, n_workers: Optional[int] = None,
                      budget_w: Optional[float] = None,
                      lockstep_stride_s: float = 120.0,
                      engine: str = "torch", device=None,
                      **engine_opts) -> Dict[str, EnsembleResult]:
    """N seeds x M scenarios in one batched pass, one
    :class:`EnsembleResult` per base scenario, keyed by its name.

    The batched engines dispatch to
    :func:`~repro_torch.provisioning.batched.run_batched_grid`:
    ``engine="torch"`` (the default) buckets the scenarios by tick geometry
    and runs each bucket as one lane tensor; ``engine="cuda"`` runs one
    kernel launch per scenario. ``engine_opts`` forward there
    (``member_chunk``, ``devices``, ``member_stats``, ...).
    ``engine="numpy"`` flattens all M*N members into a single work list,
    shards it across the fork pool together (``n_workers``,
    ``lockstep_stride_s``), and re-groups into one result per base
    scenario; it refuses ``device`` and the batched-engine options."""
    specs = [EnsembleSpec(b, n_seeds=n_seeds, seed0=seed0,
                          n_workers=n_workers,
                          lockstep_stride_s=lockstep_stride_s) for b in bases]
    if engine != "numpy":
        from repro_torch.provisioning.batched import run_batched_grid
        results = run_batched_grid(specs, budget_w=budget_w, engine=engine,
                                   device=device, **engine_opts)
        return {s.base.name: r for s, r in zip(specs, results)}
    _refuse_batched_options(device, engine_opts)
    budgets = [resolve_ensemble_budget(s.base) if budget_w is None
               else float(budget_w) for s in specs]
    member_lists = [s.member_scenarios(bw) for s, bw in zip(specs, budgets)]
    flat = [m for ml in member_lists for m in ml]
    results = _run_members(flat, lockstep_stride_s,
                           _default_workers(len(flat), n_workers))
    out: Dict[str, EnsembleResult] = {}
    i = 0
    for spec, bw, ml in zip(specs, budgets, member_lists):
        out[spec.base.name] = _ensemble_result(spec.base, bw, ml,
                                               results[i:i + len(ml)])
        i += len(ml)
    return out


def run_ensemble_sequential(spec: EnsembleSpec, *,
                            n_members: Optional[int] = None) -> List[ExperimentResult]:
    """The naive alternative the engines replace: a Python loop calling
    ``run_experiment`` per seed with the base scenario's declared semantics
    (so per-member budget calibration and reference runs are repeated N
    times). Kept as the speed-comparison baseline; ``n_members`` limits how
    many seeds are actually run."""
    seeds = spec.seeds()[:n_members if n_members is not None else spec.n_seeds]
    return [run_experiment(spec.base.with_(seed=s)) for s in seeds]
