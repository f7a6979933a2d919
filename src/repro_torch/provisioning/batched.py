"""Batched ensemble tick engine (port of ``repro.provisioning.batched``).

Runs N ensemble members x T telemetry ticks of the POLCA state machine as
one device program (DESIGN.md §15):

* **Lowering** — :func:`lower_ensemble` compiles a
  :class:`~repro_torch.experiments.scenario.Scenario` + member seeds into a
  :class:`TickModel`: per-member occupancy on the 60 s trace grid (the same
  numpy RNG streams as the JAX package, so the lowering is bit-identical),
  closed-form power coefficients from the Table-4 workload mix, and the
  POLCA thresholds/frequencies. This is host numpy work.

* **The engine** — ``engine="cuda"`` is the counterpart of the JAX
  package's ``"pallas"`` backend. On the device it interpolates the
  occupancy onto the tick grid, runs the tick loop (power fold, latch
  update, actuation ring) as the hand-written CUDA kernel of
  ``kernels/csrc/tick.cu`` through :func:`repro_torch.kernels.ops.
  polca_tick`, sums rows into budget fractions, and runs the fluid SLO
  proxy. Only what :class:`BatchedRun` keeps is copied to the host. On
  ``device="cpu"`` the same path takes the kernel's plain PyTorch version.

* **Actuation ring** — out-of-band cap commands apply ``ceil(40/2)=20``
  ticks after issue and powerbrakes ``ceil(5/2)=3`` ticks after, modeled as
  a ``[D, 2]`` ring per lane (NaN = no command); later-issued commands
  overwrite earlier ones per frequency field, the event-driven simulator's
  same-due-time resolution.

The oracle contract is the JAX package's: brake-tick sets bit-identical to
the numpy tick oracle that drives the real policy objects, power series
within 1e-6 relative. Predictive policies, fault timelines, the power
hierarchy, grids, chunking and sharding wait for later slices of the port;
:meth:`TickModel.from_numpy` carries a model lowered by the JAX package
across, so the tests hold this engine against that oracle on the same model.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.policy import PolcaPolicy, PredictivePolcaPolicy
from repro_torch.core.simulator import SimResult
from repro_torch.core.slo import LatencyStats
from repro_torch.core.traces import TABLE4, get_occupancy_generator
from repro_torch.device import resolve_device
from repro_torch.experiments.runner import build_workloads, row_budgets
from repro_torch.experiments.scenario import Scenario
from repro_torch.kernels import ops as kops
from repro_torch.kernels.tick import TickConsts
from repro_torch.provisioning.montecarlo import (
    EnsembleResult,
    EnsembleSpec,
    MemberStats,
    resolve_ensemble_budget,
)

# members x ticks above which run_batched_ensemble drops per-tick series by
# default (a [N, T] float64 matrix; 4e6 ~ 32 MB)
_SERIES_CELL_LIMIT = 4_000_000
# per-member SLO-impact samples are decimated onto at most this many slots
_IMPACT_SLOTS = 256
_JITTER_SALT = 9173  # member-occupancy jitter stream, disjoint from arrivals
# dense-tail cutover: above this member count run_batched_ensemble stops
# materializing per-member python MemberStats/LatencyStats objects
_MEMBER_STATS_LIMIT = 20_000

ENGINES = ("cuda",)


@dataclass(frozen=True)
class TickModel:
    """A Scenario + member seeds lowered to the batched tick program.

    Static arrays on the tick/trace grids plus closed-form scalars, all
    numpy/python on the host; the engine moves what it needs to the
    device."""

    base_name: str
    n_members: int
    n_rows: int
    n_ticks: int  # T
    dt: float  # telemetry_s
    occ60: np.ndarray = field(repr=False)  # [N, R, T60] occupancy, 60 s grid
    alive: np.ndarray = field(repr=False)  # [T, R] 0/1 row-crash mask
    budget_scale: np.ndarray = field(repr=False)  # [T, R] fault derates
    row_budget_w: np.ndarray = field(repr=False)  # [R] static budgets
    # power plane (closed form over the Table-4 mix; watts per server)
    p0_srv_w: float  # idle server watts
    k_lp_w: float  # LP busy-power coefficient (x f_lp^gamma)
    k_hp_w: float  # HP busy-power coefficient (x f_hp^gamma)
    lp_share: float  # LP fraction of the server pool
    gamma: float
    n_servers: int
    power_scale: float
    # policy constants (resolved from the PolicySpec)
    predictive: bool
    t1: float
    t2: float
    t1_buffer: float
    t2_buffer: float
    lp_freq_t1: float
    lp_freq_t2: float
    hp_freq_t2: float
    brake_freq: float
    escalation_ticks: int
    horizon_s: float
    window: int
    # actuation ring
    oob_ticks: int
    brake_ticks: int
    ring_depth: int  # D = max(oob, brake) + 1
    # SLO fluid proxy (per-priority clock-sensitive fraction + service time)
    a_hp: float
    a_lp: float
    svc_hp: float
    svc_lp: float
    has_hp: bool
    has_lp: bool
    # impact decimation
    stride: int
    n_slots: int  # S = ceil(T / stride)
    # hierarchy segment-sum fold (None = flat row accounting)
    node_matrix: Optional[np.ndarray] = field(default=None, repr=False)  # [n_nodes, R]
    node_names: Tuple[str, ...] = ()
    seeds: Tuple[int, ...] = ()

    @property
    def total_budget_w(self) -> float:
        return float(self.row_budget_w.sum())

    def tick_times(self) -> np.ndarray:
        """Telemetry timestamps: tick k samples t = (k+1) * dt."""
        return (np.arange(self.n_ticks, dtype=np.float64) + 1.0) * self.dt

    @classmethod
    def from_numpy(cls, fields: Mapping[str, Any]) -> "TickModel":
        """A model from the fields of a ``TickModel`` lowered elsewhere (the
        JAX package's, read as ``{f.name: getattr(m, f.name)}``): numpy
        arrays are copied, scalars and tuples taken as they are. Every
        field must be present; unknown names raise."""
        names = [f.name for f in dataclasses.fields(cls)]
        extra = sorted(set(fields) - set(names))
        if extra:
            raise ValueError(f"TickModel.from_numpy: unknown fields {extra}")
        kw = {}
        for name in names:
            v = fields[name]
            kw[name] = np.array(v) if isinstance(v, np.ndarray) else v
        return cls(**kw)


@dataclass
class BatchedRun:
    """Raw output of one tick-program run, on the host.

    ``brake_fire[m, k, r]`` marks the policy firing a powerbrake on row r at
    tick k of member m — the brake-tick set the differential harness compares
    bit-for-bit. Series fields are ``None`` when the run dropped them
    (``keep_series=False``)."""

    engine: str
    model: TickModel
    # [N, T, R] bool; None when the run dropped the per-tick plane
    # (keep_brake_fire=False — dense tails keep only the n_brakes counts)
    brake_fire: Optional[np.ndarray] = field(repr=False)
    n_brakes: np.ndarray = field(repr=False)  # [N, R] int
    peak_frac: np.ndarray = field(repr=False)  # [N]
    mean_frac: np.ndarray = field(repr=False)  # [N]
    impacts_hp: np.ndarray = field(repr=False)  # [N, R, S]
    impacts_lp: np.ndarray = field(repr=False)  # [N, R, S]
    total_frac: Optional[np.ndarray] = field(default=None, repr=False)  # [N, T]
    row_w: Optional[np.ndarray] = field(default=None, repr=False)  # [N, T, R]
    node_w: Optional[np.ndarray] = field(default=None, repr=False)  # [N, T, nodes]

    def brake_ticks(self) -> np.ndarray:
        """Sorted (member, tick, row) index triples of every brake firing —
        the bit-compared set of the oracle contract."""
        if self.brake_fire is None:
            raise ValueError(
                "this run dropped the per-tick brake plane "
                "(keep_brake_fire=False); only n_brakes counts survive")
        return np.argwhere(self.brake_fire)

    def member_stats(self, m: int) -> LatencyStats:
        hp = self.impacts_hp[m].ravel() if self.model.has_hp else np.zeros(0)
        lp = self.impacts_lp[m].ravel() if self.model.has_lp else np.zeros(0)
        return LatencyStats(hp_impacts=[float(x) for x in hp],
                            lp_impacts=[float(x) for x in lp])


# ---------------------------------------------------------------------------
# lowering (host numpy, bit-identical to the JAX package's)
# ---------------------------------------------------------------------------

def _policy_constants(sc: Scenario) -> Dict[str, object]:
    pol = sc.policy.build()
    if isinstance(pol, PredictivePolcaPolicy):
        predictive = True
    elif isinstance(pol, PolcaPolicy):
        predictive = False
    else:
        raise ValueError(
            f"batched engine supports polca/polca-predictive policies; "
            f"scenario {sc.name!r} uses {sc.policy.kind!r}")
    return dict(
        predictive=predictive,
        t1=float(pol.t1), t2=float(pol.t2),
        t1_buffer=float(pol.t1_buffer), t2_buffer=float(pol.t2_buffer),
        lp_freq_t1=float(pol.lp_freq_t1), lp_freq_t2=float(pol.lp_freq_t2),
        hp_freq_t2=float(pol.hp_freq_t2), brake_freq=float(pol.brake_freq),
        escalation_ticks=int(pol.escalation_ticks),
        horizon_s=float(getattr(pol, "horizon_s", 40.0)),
        window=int(getattr(pol, "window", 8)),
    )


_POWER_CONSTS_CACHE: Dict[tuple, Dict[str, float]] = {}


def _power_constants(sc: Scenario) -> Dict[str, float]:
    """Closed-form power/SLO coefficients over the Table-4 workload mix.

    A busy server running class w draws ``idle + k_w * f^gamma`` watts where
    ``k_w = n_dev * (p_peak - idle) * u_eff_w`` and ``u_eff_w`` is the
    prefill/decode-time-weighted roofline utilization — exactly
    ``DevicePower.power`` evaluated at the class's two
    :class:`~repro_torch.core.workload.PhasePoint` operating points. Classes
    then collapse into one LP and one HP coefficient via share x priority
    mix. Per-server coefficients are independent of fleet *size*, so the
    result is cached on the (model, device, devices/server, mix) key."""
    key = (sc.fleet.model, sc.fleet.device, sc.fleet.n_devices_per_server,
           sc.traffic.priority_mix_override)
    hit = _POWER_CONSTS_CACHE.get(key)
    if hit is not None:
        return hit
    wls, shares = build_workloads(sc)
    server = sc.fleet.server()
    dev = server.device
    k_lp = k_hp = lp_share = 0.0
    a_num = {"high": 0.0, "low": 0.0}
    svc_num = {"high": 0.0, "low": 0.0}
    wgt_tot = {"high": 0.0, "low": 0.0}
    for wl, share, spec in zip(wls, shares, TABLE4):
        mean_out = 0.5 * (spec.out_range[0] + spec.out_range[1])
        t_total = wl.timing.t_prefill + mean_out * wl.timing.t_token
        f_pre = wl.timing.t_prefill / t_total
        u_eff = 0.0
        cf_eff = 0.0
        for frac, pt in ((f_pre, wl.timing.prefill_point),
                         (1.0 - f_pre, wl.timing.token_point)):
            u = min(1.0, dev.w_compute * min(pt.u_compute, 1.0)
                    + dev.w_memory * min(pt.u_memory, 1.0))
            u_eff += frac * u
            cf_eff += frac * pt.compute_frac
        k_srv = server.n_devices * (dev.p_peak - dev.idle_w) * u_eff
        mix = wl.priority_mix
        k_hp += share * mix * k_srv
        k_lp += share * (1.0 - mix) * k_srv
        lp_share += share * (1.0 - mix)
        for prio, wgt in (("high", share * mix), ("low", share * (1.0 - mix))):
            wgt_tot[prio] += wgt
            a_num[prio] += wgt * cf_eff
            svc_num[prio] += wgt * t_total
    out = dict(p0_srv_w=float(server.idle_power), k_lp_w=float(k_lp),
               k_hp_w=float(k_hp), lp_share=float(lp_share),
               gamma=float(dev.gamma))
    for prio, pkey in (("high", "hp"), ("low", "lp")):
        has = wgt_tot[prio] > 0.0
        out[f"has_{pkey}"] = bool(has)
        out[f"a_{pkey}"] = float(a_num[prio] / wgt_tot[prio]) if has else 0.0
        out[f"svc_{pkey}"] = float(svc_num[prio] / wgt_tot[prio]) if has else 1.0
    _POWER_CONSTS_CACHE[key] = out
    return out


# base generator curves are independent of fleet size (only the CLT jitter
# scales with n_servers), so a plan_capacity bisection — which re-lowers per
# probe because fleets differ — reuses them across every probe
_BASE_OCC_CACHE: Dict[tuple, np.ndarray] = {}
# entries are short 60 s-grid curves (a few KB each): ~100 MB worst case
_BASE_OCC_CACHE_MAX = 16384


def _member_occupancy(sc: Scenario, seeds: Sequence[int], t60: np.ndarray,
                      n_rows: int, n_servers: int) -> np.ndarray:
    """[N, R, T60] occupancy: the scenario's registered generator per member
    seed + row, plus a member-seeded CLT busy-fraction jitter
    (sigma = sqrt(occ(1-occ)/n_servers)) standing in for the arrival-sampling
    noise of the event-driven simulator."""
    gen = get_occupancy_generator(sc.traffic.generator)
    gkey = (sc.traffic.generator, len(t60),
            float(t60[-1]) if len(t60) else 0.0,
            float(sc.traffic.occ_peak), n_rows,
            tuple(sorted((k, repr(v))
                         for k, v in sc.traffic.gen_params.items())))
    occ = np.empty((len(seeds), n_rows, len(t60)), dtype=np.float64)
    for mi, seed in enumerate(seeds):
        for r in range(n_rows):
            ck = gkey + (int(seed), r)
            base = _BASE_OCC_CACHE.get(ck)
            if base is None:
                base = np.asarray(
                    gen(t60, seed=int(seed), peak=sc.traffic.occ_peak,
                        n_rows=n_rows, row=r, **sc.traffic.gen_params),
                    dtype=np.float64)
                if len(_BASE_OCC_CACHE) < _BASE_OCC_CACHE_MAX:
                    _BASE_OCC_CACHE[ck] = base
            rng = np.random.default_rng([int(seed), r, _JITTER_SALT])
            sigma = np.sqrt(np.clip(base * (1.0 - base), 0.0, None) / n_servers)
            occ[mi, r] = np.clip(base + rng.standard_normal(len(t60)) * sigma,
                                 0.0, 1.0)
    return occ


def lower_ensemble(spec: EnsembleSpec, *, budget_w: Optional[float] = None
                   ) -> Tuple[TickModel, List[Scenario], float]:
    """Lower an EnsembleSpec to the batched tick program. Returns
    ``(model, member_scenarios, resolved_budget_w)`` — members carry the
    same pinned budget ``run_ensemble`` pins."""
    sc = spec.base
    if sc.duration_s < 120.0:
        raise ValueError(
            f"batched engine needs duration_s >= 120 (two 60 s occupancy "
            f"samples to interpolate); {sc.name!r} has {sc.duration_s:g}")
    dt = float(sc.telemetry.telemetry_s)
    n_ticks = int(math.floor(sc.duration_s / dt))
    t60 = np.arange(0.0, sc.duration_s, 60.0)
    fleet = sc.fleet
    server = fleet.server()
    budget = (resolve_ensemble_budget(sc) if budget_w is None
              else float(budget_w))
    members = spec.member_scenarios(budget)
    row_budget = np.asarray(row_budgets(sc, budget, server), dtype=np.float64)
    # no fault timeline (the chaos engine is not ported): every row alive,
    # budgets unscaled
    alive = np.ones((n_ticks, fleet.n_rows), dtype=np.float64)
    bscale = np.ones((n_ticks, fleet.n_rows), dtype=np.float64)
    occ60 = _member_occupancy(sc, spec.seeds(), t60, fleet.n_rows,
                              fleet.n_servers)
    stride = max(1, math.ceil(n_ticks / _IMPACT_SLOTS))
    tc = sc.telemetry
    oob_ticks = max(1, math.ceil(tc.oob_latency_s / dt))
    brake_ticks = max(1, math.ceil(tc.brake_latency_s / dt))
    model = TickModel(
        base_name=sc.name, n_members=spec.n_seeds, n_rows=fleet.n_rows,
        n_ticks=n_ticks, dt=dt, occ60=occ60, alive=alive, budget_scale=bscale,
        row_budget_w=row_budget, n_servers=fleet.n_servers,
        power_scale=float(sc.power_scale),
        oob_ticks=oob_ticks, brake_ticks=brake_ticks,
        ring_depth=max(oob_ticks, brake_ticks) + 1,
        stride=stride, n_slots=math.ceil(n_ticks / stride),
        seeds=tuple(spec.seeds()),
        **_policy_constants(sc), **_power_constants(sc))
    return model, members, budget


def _interp_weights(model: TickModel) -> Tuple[np.ndarray, np.ndarray]:
    """Per-tick (left index, right weight) into the 60 s occupancy grid."""
    t = model.tick_times()
    g = t / 60.0
    n60 = model.occ60.shape[2]
    i = np.clip(np.floor(g).astype(np.int64), 0, n60 - 2)
    w = np.clip(g - i, 0.0, 1.0)
    return i, w


# ---------------------------------------------------------------------------
# the engine on the device
# ---------------------------------------------------------------------------

def effective_occupancy(model: TickModel, device) -> torch.Tensor:
    """[N, T, R] per-tick occupancy on ``device``: the 60 s grid
    interpolated onto the tick grid, times the row-alive mask. The numpy
    oracle's expression, elementwise, so bit-identical to it.

    The result is a view of time-major ``[T, N, R]`` storage, built that
    way (only the small 60 s grid is transposed), so the tick kernel reads a
    tick's lanes contiguously and no ``[N, T, R]`` plane is copied to change
    its layout."""
    i_idx, i_w = _interp_weights(model)
    f64 = dict(dtype=torch.float64, device=device)
    occ60 = torch.as_tensor(model.occ60, **f64).permute(2, 0, 1).contiguous()
    ii = torch.as_tensor(i_idx, device=device)  # occ60 is [T60, N, R]
    w = torch.as_tensor(i_w, **f64)[:, None, None]
    alive = torch.as_tensor(model.alive, **f64)[:, None, :]  # [T, 1, R]
    occ = (occ60[ii] * (1.0 - w) + occ60[ii + 1] * w) * alive  # [T, N, R]
    return occ.permute(1, 0, 2)


def tick_consts(model: TickModel) -> TickConsts:
    """The kernel's scalar constants of a lowered model."""
    return TickConsts(
        t1=model.t1, t2=model.t2, t1_buf=model.t1_buffer,
        t2_buf=model.t2_buffer, lp_t1=model.lp_freq_t1,
        lp_t2=model.lp_freq_t2, hp_t2=model.hp_freq_t2,
        brake_freq=model.brake_freq, p0_srv_w=model.p0_srv_w,
        k_lp_w=model.k_lp_w, k_hp_w=model.k_hp_w, lp_share=model.lp_share,
        gamma=model.gamma, n_servers=float(model.n_servers),
        power_scale=model.power_scale)


def _slo_impacts(model: TickModel, occ, f_lp, f_hp):
    """The per-priority fluid SLO proxy, decimated: ``[N, R, S]`` impact
    planes for HP and LP.

    Per tick, slowdown ``a/f + (1-a)`` from the DVFS perf model plus a
    queue-delay backlog integrator (occupancy x slowdown > 1 means the row
    can't keep up and delay accrues). The elementwise part runs over all
    ticks at once; only the backlog recurrence steps through the T ticks.
    Scalars that divide tensors are 0-d tensors, so the quotient is a true
    division (``float / tensor`` in PyTorch multiplies by a reciprocal)."""
    N, T, R = occ.shape
    f64 = dict(dtype=torch.float64, device=occ.device)
    out = []
    for a, svc, f in ((model.a_hp, model.svc_hp, f_hp),
                      (model.a_lp, model.svc_lp, f_lp)):
        sd = (torch.tensor(a, **f64) / torch.clamp_min(f, 1e-3)
              + (1.0 - a))  # [N, T, R]
        # [T, N, R]: contiguous ticks when occ and f are time-major views
        inflow = ((occ * sd - 1.0) * model.dt).transpose(0, 1)
        svc = torch.tensor(svc, **f64)
        backlog = torch.zeros((N, R), **f64)
        imp = torch.empty((N, R, model.n_slots), **f64)
        for k in range(T):
            backlog = torch.clamp_min(backlog + inflow[k], 0.0)
            if k % model.stride == 0:
                imp[:, :, k // model.stride] = (sd[:, k] - 1.0) + backlog / svc
        out.append(imp)
    return out[0], out[1]


def _run_cuda(model: TickModel, keep_series: bool, keep_brake_fire: bool,
              device: torch.device) -> BatchedRun:
    """The tick loop through ``kernels.ops.polca_tick`` on ``device``."""
    if model.predictive:
        raise ValueError(
            "engine='cuda' runs the non-predictive PolcaPolicy tick loop; "
            f"{model.base_name!r} lowered a predictive policy (the scan "
            "engine that carries the slope window is not ported yet)")
    f64 = dict(dtype=torch.float64, device=device)
    occ = effective_occupancy(model, device)
    out = kops.polca_tick(
        occ, torch.as_tensor(model.budget_scale, **f64),
        torch.as_tensor(model.row_budget_w, **f64),
        consts=tick_consts(model), oob_ticks=model.oob_ticks,
        brake_ticks=model.brake_ticks, ring_depth=model.ring_depth,
        esc=model.escalation_ticks)
    frac = out["row_w"].sum(dim=2) / model.total_budget_w  # [N, T]
    imp_hp, imp_lp = _slo_impacts(model, occ, out["f_lp"], out["f_hp"])
    run = BatchedRun(
        engine="cuda", model=model,
        brake_fire=out["fire"].cpu().numpy() if keep_brake_fire else None,
        n_brakes=out["n_brakes"].cpu().numpy().astype(np.int64),
        peak_frac=frac.amax(dim=1).cpu().numpy(),
        mean_frac=frac.mean(dim=1).cpu().numpy(),
        impacts_hp=imp_hp.cpu().numpy(), impacts_lp=imp_lp.cpu().numpy())
    if keep_series:
        run.total_frac = frac.cpu().numpy()
        run.row_w = out["row_w"].cpu().numpy()
        if model.node_matrix is not None:
            run.node_w = np.einsum("ntr,mr->ntm", run.row_w, model.node_matrix)
    return run


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(
            f"unknown batched engine {engine!r}: this port runs "
            f"engine='cuda' (the JAX package's 'pallas' counterpart); the "
            f"'torch' scan engine and the event-driven engine are not "
            f"ported yet")


def run_tick_model(model: TickModel, *, engine: str = "cuda",
                   keep_series: bool = True, keep_brake_fire: bool = True,
                   device=None) -> BatchedRun:
    """Run a lowered tick program on the CUDA kernel engine, on the card
    unless ``device="cpu"`` (the kernel's plain PyTorch version)."""
    _check_engine(engine)
    return _run_cuda(model, keep_series, keep_brake_fire,
                     resolve_device(device))


def _to_ensemble_result(model: TickModel, members: List[Scenario],
                        budget_w: float, run: BatchedRun,
                        member_stats: bool = True) -> EnsembleResult:
    """Adapt a BatchedRun to the EnsembleResult shape the planner and the
    distributional statistics consume. ``power_frac`` rows are member
    total-budget fractions.

    ``member_stats=False`` is the dense-tail mode: the members list stays
    empty and per-member SLO impacts ride as ``[N, K]`` arrays — every
    distributional statistic on EnsembleResult falls back to the
    vectorized path (same numbers, no 10^5 python objects)."""
    t = model.tick_times()
    if run.total_frac is not None:
        power = np.asarray(run.total_frac)
        power_t = t
    else:
        power = np.zeros((0, 0))
        power_t = np.zeros(0)
    common = dict(
        base_name=model.base_name, budget_w=budget_w,
        power_t=power_t, power_frac=power,
        brake_counts=np.asarray(run.n_brakes.sum(axis=1)),
        peak_fracs=np.asarray(run.peak_frac),
        mean_fracs=np.asarray(run.mean_frac))
    if not member_stats:
        N = run.impacts_hp.shape[0]
        return EnsembleResult(
            members=[],
            member_impacts_hp=(run.impacts_hp.reshape(N, -1)
                               if model.has_hp else np.zeros((N, 0))),
            member_impacts_lp=(run.impacts_lp.reshape(N, -1)
                               if model.has_lp else np.zeros((N, 0))),
            **common)
    stats: List[MemberStats] = []
    for m, sc in enumerate(members):
        series = (run.total_frac[m] if run.total_frac is not None else None)
        res = SimResult(
            latency=run.member_stats(m),
            n_brakes=int(run.n_brakes[m].sum()),
            n_dropped=0, n_completed=0, served_tokens=0.0,
            peak_power_frac=float(run.peak_frac[m]),
            mean_power_frac=float(run.mean_frac[m]),
            power_t=(t if series is not None else None),
            power_w=series)
        stats.append(MemberStats(sc, res, res.latency))
    return EnsembleResult(members=stats, **common)


def _auto_flags(model: TickModel, keep_series: Optional[bool],
                keep_brake_fire: Optional[bool],
                member_stats: Optional[bool]) -> Tuple[bool, bool, bool]:
    """Resolve the None-means-auto memory knobs from the model's size."""
    cells = model.n_members * model.n_ticks
    if keep_series is None:
        keep_series = cells <= _SERIES_CELL_LIMIT
    if keep_brake_fire is None:
        # the bool [N, T, R] plane; 50x the f64 series budget in cells
        keep_brake_fire = cells * model.n_rows <= 50 * _SERIES_CELL_LIMIT
    if member_stats is None:
        member_stats = model.n_members <= _MEMBER_STATS_LIMIT
    return keep_series, keep_brake_fire, member_stats


def run_batched_ensemble(spec: EnsembleSpec, *,
                         budget_w: Optional[float] = None,
                         engine: str = "cuda", device=None,
                         keep_series: Optional[bool] = None,
                         keep_brake_fire: Optional[bool] = None,
                         member_stats: Optional[bool] = None) -> EnsembleResult:
    """Evaluate an ensemble on the batched tick engine: lower on the host,
    run on ``device`` (the card unless ``device="cpu"``), summarize.

    The ``None``-default knobs auto-scale with ensemble size:
    ``keep_series`` keeps per-tick power series under 4e6 member-tick
    cells; ``keep_brake_fire`` drops the [N, T, R] brake plane (counts
    survive) past 2e8 cells; ``member_stats`` switches to dense [N, K]
    impact arrays past 2e4 members."""
    _check_engine(engine)
    device = resolve_device(device)
    model, members, budget = lower_ensemble(spec, budget_w=budget_w)
    keep_series, keep_fire, member_stats = _auto_flags(
        model, keep_series, keep_brake_fire, member_stats)
    run = _run_cuda(model, keep_series, keep_fire, device)
    return _to_ensemble_result(model, members, budget, run,
                               member_stats=member_stats)
