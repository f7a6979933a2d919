"""Batched ensemble tick engines (port of ``repro.provisioning.batched``).

Runs N ensemble members x T telemetry ticks of the POLCA state machine as
one device program (DESIGN.md §15-16):

* **Lowering** — :func:`lower_ensemble` compiles a
  :class:`~repro_torch.experiments.scenario.Scenario` + member seeds into a
  :class:`TickModel`: per-member occupancy on the 60 s trace grid (the same
  numpy RNG streams as the JAX package, so the lowering is bit-identical),
  closed-form power coefficients from the Table-4 workload mix, the POLCA
  thresholds/frequencies, fault timelines lowered to per-tick budget scales
  and row-alive masks (:func:`_lower_faults`), and the ``PowerHierarchy``
  leaf budgets and node matrix. This is host numpy work.

* **Two engines, one contract** — ``engine="cuda"`` is the counterpart of
  the JAX package's ``"pallas"`` backend: on the device it interpolates the
  occupancy onto the tick grid, runs the non-predictive tick loop (power
  fold, latch update, actuation ring) as the hand-written CUDA kernel of
  ``kernels/csrc/tick.cu`` through :func:`repro_torch.kernels.ops.
  polca_tick`, sums rows into budget fractions, and runs the fluid SLO
  proxy; on ``device="cpu"`` the same path takes the kernel's plain
  PyTorch version. ``engine="torch"`` is the counterpart of ``"jax"``: an
  eager float64 tick loop over a ``[M, N, R]`` lane tensor (M same-geometry
  scenarios, N members, R rows) built from the shared step math of
  :mod:`repro_torch.kernels.tick`, which also carries the
  :class:`~repro_torch.core.policy.PredictivePolcaPolicy` slope window
  (:meth:`_Lanes._predict`).

* **Grids, chunks, shards** — :func:`run_tick_models` /
  :func:`run_batched_grid` stack the scenarios of a geometry bucket
  (:func:`_geometry_key`) on the lane tensor's scenario axis; a single
  model is the grid of one, through the same code. ``member_chunk`` runs
  members in blocks, ``devices`` shards them over CUDA devices (no
  collectives). Results are bit-identical across all three knobs.

* **Actuation ring** — out-of-band cap commands apply ``ceil(40/2)=20``
  ticks after issue and powerbrakes ``ceil(5/2)=3`` ticks after, modeled as
  a ``[D, 2]`` ring per lane (NaN = no command); later-issued commands
  overwrite earlier ones per frequency field, the event-driven simulator's
  same-due-time resolution.

The oracle contract is the JAX package's: brake-tick sets bit-identical to
the numpy tick oracle that drives the real policy objects, power series
within 1e-6 relative. The event-driven engine (``engine="numpy"``) lives
in :mod:`repro_torch.provisioning.montecarlo`; :meth:`TickModel.from_numpy`
carries a model lowered by the JAX package across, so the tests hold both
engines against that oracle on the same model.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.policy import PolcaPolicy, PredictivePolcaPolicy
from repro_torch.core.simulator import SimResult
from repro_torch.core.slo import LatencyStats
from repro_torch.core.traces import TABLE4, get_occupancy_generator
from repro_torch.device import resolve_devices
from repro_torch.experiments.runner import build_workloads, row_budgets
from repro_torch.experiments.scenario import Scenario
from repro_torch.kernels import ops as kops
from repro_torch.kernels.tick import (
    PolcaLatches,
    TickConsts,
    apply_ring_tick,
    lp_power_from_pow,
    polca_latch_step,
    push_ring_commands,
    row_power_from_pows,
)
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

ENGINES = ("cuda", "torch")


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


def _lower_faults(sc: Scenario, n_ticks: int, dt: float, n_rows: int,
                  hierarchy) -> Tuple[np.ndarray, np.ndarray]:
    """Fault timeline -> ([T, R] alive mask, [T, R] budget scale).

    Row crashes zero a row's occupancy (it idles until revived); budget
    events scale the *derated subtree's* row budgets per tick, ramping
    linearly over ``ramp_s`` and restoring at ``until``. The tick model has
    no dispatcher to fence, so the masks are the whole story."""
    alive = np.ones((n_ticks, n_rows), dtype=np.float64)
    bscale = np.ones((n_ticks, n_rows), dtype=np.float64)
    faults = sc.faults
    if faults is None or faults.is_noop:
        return alive, bscale
    names = list(hierarchy.names) if hierarchy is not None else None
    faults.validate(duration_s=sc.duration_s, n_rows=n_rows, node_names=names)
    t_ticks = (np.arange(n_ticks, dtype=np.float64) + 1.0) * dt
    for e in sorted(faults.row_events(), key=lambda e: e.t):
        alive[t_ticks >= e.t, int(e.row)] = (
            0.0 if e.kind == "row-crash" else 1.0)
    for e in faults.budget_events():
        if e.kind == "site-demand-response" or hierarchy is None:
            if e.kind == "node-derate" and hierarchy is None:
                raise ValueError(
                    f"fault event {e.describe()} targets a hierarchy node "
                    f"but scenario {sc.name!r} has no HierarchySpec")
            rows = np.arange(n_rows)
        else:
            rows = hierarchy.subtree_leaves(list(hierarchy.names).index(e.node))
        ramp = (np.clip((t_ticks - e.t) / e.ramp_s, 0.0, 1.0) if e.ramp_s > 0
                else (t_ticks >= e.t).astype(np.float64))
        scale = 1.0 - (1.0 - e.factor) * ramp
        if e.until is not None:
            scale = np.where(t_ticks >= e.until, 1.0, scale)
        bscale[:, rows] *= scale[:, None]
    return alive, bscale


def lower_ensemble(spec: EnsembleSpec, *, budget_w: Optional[float] = None
                   ) -> Tuple[TickModel, List[Scenario], float]:
    """Lower an EnsembleSpec to the batched tick program. Returns
    ``(model, member_scenarios, resolved_budget_w)`` — members carry the
    same pinned budget ``run_ensemble`` pins. A routed fleet
    (``Scenario.routing``) is refused: the tick program lowers rows, and
    the fleet runs on the event-driven engine only."""
    sc = spec.base
    if sc.routing is not None:
        raise ValueError(
            f"batched engine runs unrouted row/cluster scenarios; "
            f"{sc.name!r} carries a RoutingSpec (use engine='numpy' — the "
            f"event-driven fleet path)")
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

    hierarchy = None
    node_matrix = None
    node_names: Tuple[str, ...] = ()
    base_budgets = row_budgets(sc, budget, server)
    if sc.hierarchy is not None:
        if sc.hierarchy.n_rows != fleet.n_rows:
            raise ValueError(
                f"hierarchy shape {sc.hierarchy.shape} implies "
                f"{sc.hierarchy.n_rows} rows; fleet has {fleet.n_rows}")
        hierarchy = sc.hierarchy.build(base_budgets)
        row_budget = np.asarray(hierarchy.leaf_budget_w, dtype=np.float64)
        node_matrix = np.zeros((hierarchy.n_nodes, fleet.n_rows))
        for n in range(hierarchy.n_nodes):
            node_matrix[n, hierarchy.leaf_desc[n]] = 1.0
        node_names = tuple(hierarchy.names)
    else:
        row_budget = np.asarray(base_budgets, dtype=np.float64)

    alive, bscale = _lower_faults(sc, n_ticks, dt, fleet.n_rows, hierarchy)
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
        node_matrix=node_matrix, node_names=node_names,
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
    occ = _grid_occupancy(model.occ60[None], model.alive[None],
                          *_interp_weights(model), device)
    return occ[:, 0].permute(1, 0, 2)


def _grid_occupancy(occ60: np.ndarray, alive: np.ndarray, i_idx: np.ndarray,
                    i_w: np.ndarray, device) -> torch.Tensor:
    """Time-major ``[T, M, N, R]`` occupancy of M scenarios from their
    ``[M, N, R, T60]`` 60 s grids and ``[M, T, R]`` alive masks (the
    interpolation of :func:`effective_occupancy`)."""
    f64 = dict(dtype=torch.float64, device=device)
    occ60 = torch.as_tensor(occ60, **f64).permute(3, 0, 1, 2).contiguous()
    ii = torch.as_tensor(i_idx, device=device)  # occ60 is [T60, M, N, R]
    w = torch.as_tensor(i_w, **f64)[:, None, None, None]
    alive = torch.as_tensor(alive, **f64).permute(1, 0, 2)[:, :, None, :]
    return (occ60[ii] * (1.0 - w) + occ60[ii + 1] * w) * alive


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
            f"{model.base_name!r} lowered a predictive policy (use "
            "engine='torch', which carries the slope window in its lane "
            "state)")
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
# the "torch" scan engine: M scenarios x N members x R rows of lanes, one
# tick at a time
# ---------------------------------------------------------------------------

# member_chunk=None (auto) keeps a shard's members in one block until the
# engine's device memory for them (lane state, occupancy, kept planes)
# passes this many bytes, then runs equal blocks under it one after another
_AUTO_CHUNK_BYTES = 8 << 30
# float64 words of lane state a (member, row) lane holds besides its ring,
# window, occupancy and planes: frequencies, latches, backlogs, and the
# temporaries one tick's step allocates
_LANE_STATE_WORDS = 48

# The engine's ring and frequency state carry codes in place of frequencies,
# the codes of kernels/tick.py::freq_table (1 = uncapped, then lp_t1, lp_t2,
# hp_t2, brake_freq); f ** gamma and the SLO slowdown are looked up per code
# in per-scenario tables, so every lane at a frequency reads the same bits
_CODES = dict(lp_t1=2.0, lp_t2=3.0, hp_t2=4.0, brake_freq=5.0)
_N_CODES = 6  # code 0 is unused


class _Consts(NamedTuple):
    """Per-scenario constants of the torch engine: ``[M, 1, 1]`` float64
    tensors on the lanes' device (``row_budget``: ``[M, 1, R]``). Field
    names follow :class:`~repro_torch.kernels.tick.TickConsts`, so the
    shared step math reads them; the four command frequencies hold their
    codes (:data:`_CODES`). Constants that divide are device tensors, so
    every quotient is a true division."""

    t1: object
    t2: object
    t1_buf: object
    t2_buf: object
    lp_t1: float
    lp_t2: float
    hp_t2: float
    brake_freq: float
    p0_srv_w: object
    k_lp_w: object
    k_hp_w: object
    lp_share: object
    n_servers: object
    power_scale: object
    horizon: object
    svc_hp: object
    svc_lp: object
    total_budget: object
    row_budget: object


_CONST_SCALARS = (
    "t1", "t2", "t1_buf", "t2_buf", "p0_srv_w", "k_lp_w", "k_hp_w",
    "lp_share", "n_servers", "power_scale", "horizon", "svc_hp",
    "svc_lp", "total_budget")

_MODEL_FIELD = dict(t1_buf="t1_buffer", t2_buf="t2_buffer",
                    horizon="horizon_s", total_budget="total_budget_w")


def _model_const(model: TickModel, name: str) -> float:
    return float(getattr(model, _MODEL_FIELD.get(name, name)))


def _geometry_key(model: TickModel) -> tuple:
    """The bucket key of a grid: models sharing it have the same tick,
    ring, window and member geometry, so they stack on the scenario axis of
    one lane tensor."""
    return (model.n_ticks, model.n_rows, model.ring_depth,
            max(1, model.window), model.n_slots, model.stride,
            model.oob_ticks, model.brake_ticks, model.escalation_ticks,
            model.predictive, model.n_members, model.occ60.shape[2],
            float(model.dt))


def _code_tables(model: TickModel) -> Dict[str, np.ndarray]:
    """What a lane reads per frequency code, ``[_N_CODES]`` each: ``pow``
    = f ** gamma as numpy's array power (the oracle's expression), and per
    priority the SLO slowdown ``sd`` = a / max(f, 1e-3) + (1 - a) and
    ``sd - 1``, the oracle's expressions."""
    f = np.array([1.0, 1.0, model.lp_freq_t1, model.lp_freq_t2,
                  model.hp_freq_t2, model.brake_freq])
    out = {"pow": f ** model.gamma}
    for prio in ("hp", "lp"):
        a = getattr(model, f"a_{prio}")
        sd = a / np.maximum(f, 1e-3) + (1.0 - a)
        out[f"sd_{prio}"] = sd
        out[f"sdm1_{prio}"] = sd - 1.0
    return out


def _window_plan(model: TickModel) -> Tuple[list, list]:
    """The slope window of :class:`~repro_torch.core.policy.
    PredictivePolcaPolicy` per tick. Every lane of a tick shares its sample
    times, so what depends on time alone is computed here once, in Python
    floats and in the policy's order: per tick k, the ring slots of the
    window's samples oldest first, ``t_j - mean(t)`` for each, and whether
    the policy extrapolates (three samples or more, a positive
    denominator); and per tick the denominator ``sum((t_j - mean(t))**2)``."""
    W = max(1, model.window)
    t = [float(x) for x in model.tick_times()]
    plan, den = [], []
    for k in range(model.n_ticks):
        hist = t[max(0, k - W + 1):k + 1]
        tm = sum(hist) / len(hist)
        d = sum((ti - tm) ** 2 for ti in hist)
        slots = [j % W for j in range(k - len(hist) + 1, k + 1)]
        plan.append((slots, [ti - tm for ti in hist],
                     len(hist) >= 3 and d > 0.0))
        den.append(d)
    return plan, den


def _numpy_order_sum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum the tensors ``xs`` in the order numpy's pairwise summation adds
    a contiguous run of ``len(xs)`` values (sequential below 8; eight
    running sums combined pairwise up to 128; halves beyond), so the row
    total of a tick rounds as the oracle's ``rw.sum()`` does."""
    n = len(xs)
    if n < 8:
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x
        return acc
    if n <= 128:
        r = list(xs[:8])
        i = 8
        while i < n - n % 8:
            r = [r[j] + xs[i + j] for j in range(8)]
            i += 8
        acc = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for x in xs[i:]:
            acc = acc + x
        return acc
    half = n // 2
    half -= half % 8
    return _numpy_order_sum(xs[:half]) + _numpy_order_sum(xs[half:])


class _Lanes:
    """One block of the torch engine on one device: ``[M, n, R]`` lanes of
    M same-geometry scenarios x n members x R rows, advanced a tick at a
    time by :meth:`step` (JAX ``_jax_runner``'s scan body, eager).

    The step is built from the shared step math of
    :mod:`repro_torch.kernels.tick`: the ring pop, the power fold, the
    latch update (with the predictive branch), the ring push. The fluid SLO
    proxy is a backlog carry that writes an impact slot every ``stride``
    ticks, so no per-tick frequency plane exists. Elementwise float64 only,
    one operation a launch, in the numpy oracle's order: a lane's numbers
    do not depend on where it sits in the block, which is what makes grids,
    chunks and shards bit-identical to one flat run."""

    def __init__(self, models: Sequence[TickModel], members: np.ndarray,
                 device: torch.device, *, keep_series: bool, keep_fire: bool):
        m0 = models[0]
        M, n, R = len(models), len(members), m0.n_rows
        self.T, self.D, self.W = m0.n_ticks, m0.ring_depth, max(1, m0.window)
        self.stride, self.dt = m0.stride, float(m0.dt)
        self.oob, self.brake, self.esc = (m0.oob_ticks, m0.brake_ticks,
                                          m0.escalation_ticks)
        self.predictive = m0.predictive
        f64 = dict(dtype=torch.float64, device=device)

        def col(name):
            vals = [_model_const(m, name) for m in models]
            return torch.tensor(vals, **f64).view(M, 1, 1)

        self.c = _Consts(
            **{name: col(name) for name in _CONST_SCALARS}, **_CODES,
            row_budget=torch.as_tensor(
                np.stack([m.row_budget_w for m in models]), **f64)[:, None, :])
        tables = [_code_tables(m) for m in models]
        self.tab = {k: torch.as_tensor(np.stack([t[k] for t in tables]),
                                       **f64).reshape(-1)
                    for k in tables[0]}
        self.code_off = (torch.arange(M, device=device)
                         * _N_CODES).view(M, 1, 1)
        self.occ = _grid_occupancy(
            np.stack([m.occ60[members] for m in models]),
            np.stack([m.alive for m in models]), *_interp_weights(m0),
            device)  # [T, M, n, R]
        bscale = torch.as_tensor(np.stack([m.budget_scale for m in models]),
                                 **f64).permute(1, 0, 2)[:, :, None, :]
        self.tick_budget = self.c.row_budget * bscale  # [T, M, 1, R]
        self.n_ticks = torch.tensor(float(self.T), **f64)
        if self.predictive:
            self.window, den = _window_plan(m0)
            self.den = torch.tensor(den, **f64)
            self.n_samples = torch.arange(self.W + 1, **f64)
            self.hist = torch.empty((self.W, M, n, R), **f64)

        shape = (M, n, R)
        self.f_lp = torch.ones(shape, **f64)  # code 1: uncapped
        self.f_hp = torch.ones(shape, **f64)
        self.ring = torch.full((self.D, 2) + shape, float("nan"), **f64)
        flag = dict(dtype=torch.bool, device=device)
        self.lat = PolcaLatches(
            t1c=torch.zeros(shape, **flag), t2c=torch.zeros(shape, **flag),
            hpc=torch.zeros(shape, **flag), brk=torch.zeros(shape, **flag),
            t2s=torch.zeros(shape, dtype=torch.int32, device=device))
        self.nbr = torch.zeros(shape, dtype=torch.int32, device=device)
        self.backlog_hp = torch.zeros(shape, **f64)
        self.backlog_lp = torch.zeros(shape, **f64)
        self.peak = torch.zeros((M, n), **f64)
        self.fsum = torch.zeros((M, n), **f64)
        self.imp_hp = torch.empty((m0.n_slots,) + shape, **f64)
        self.imp_lp = torch.empty((m0.n_slots,) + shape, **f64)
        self.fire = (torch.empty((self.T,) + shape, **flag) if keep_fire
                     else None)
        self.frac = (torch.empty((self.T, M, n), **f64) if keep_series
                     else None)
        self.row_w = (torch.empty((self.T,) + shape, **f64) if keep_series
                      else None)

    def _predict(self, k: int, p):
        """``PredictivePolcaPolicy._predict`` and its clamp on ``[M, n, R]``
        lanes: the raw sample enters a W-slot ring, the least-squares slope
        over the window extrapolates ``horizon_s`` ahead, and a row that has
        not breached is held below 1.0. Sums run slot by slot, oldest first,
        as the policy's Python ``sum`` does."""
        self.hist[k % self.W] = p
        slots, dts, fit = self.window[k]
        p_ext = p
        if fit:
            h = self.hist
            acc = h[slots[0]]
            for s in slots[1:]:
                acc = acc + h[s]
            pm = acc / self.n_samples[len(slots)]
            num = (h[slots[0]] - pm) * dts[0]
            for s, d in zip(slots[1:], dts[1:]):
                num = num + (h[s] - pm) * d
            slope = num / self.den[k]
            p_ext = torch.maximum(p, p + slope * self.c.horizon)
        return torch.where(p <= 1.0, torch.clamp_max(p_ext, 1.0 - 1e-9),
                           p_ext)

    def step(self, k: int) -> None:
        c = self.c
        self.ring, self.f_lp, self.f_hp = apply_ring_tick(
            self.ring, self.f_lp, self.f_hp, k, ring_depth=self.D)
        i_lp = self.f_lp.long() + self.code_off
        i_hp = self.f_hp.long() + self.code_off
        pow_lp = self.tab["pow"].take(i_lp)
        occ = self.occ[k]
        rw = row_power_from_pows(c, occ, pow_lp, self.tab["pow"].take(i_hp))
        frac = (_numpy_order_sum(rw.unbind(2))
                / c.total_budget[:, :, 0])  # [M, n]
        self.peak = torch.maximum(self.peak, frac)
        self.fsum = self.fsum + frac
        budget = self.tick_budget[k]
        p_raw = rw / budget
        if self.predictive:
            lp_frac = lp_power_from_pow(c, occ, pow_lp) / budget
            p_obs = self._predict(k, p_raw)
        else:
            lp_frac, p_obs = None, p_raw
        self.lat, fire, lp_cmd, hp_cmd = polca_latch_step(
            self.lat, p_obs, p_raw, lp_frac, c, esc=self.esc,
            predictive=self.predictive)
        push_ring_commands(self.ring, fire, lp_cmd, hp_cmd, c.brake_freq, k,
                           oob_ticks=self.oob, brake_ticks=self.brake,
                           ring_depth=self.D)
        self.nbr += fire
        for prio, idx in (("hp", i_hp), ("lp", i_lp)):
            backlog = getattr(self, f"backlog_{prio}")
            sd = self.tab[f"sd_{prio}"].take(idx)
            backlog = torch.clamp_min(backlog + (occ * sd - 1.0) * self.dt,
                                      0.0)
            setattr(self, f"backlog_{prio}", backlog)
            if k % self.stride == 0:
                torch.add(self.tab[f"sdm1_{prio}"].take(idx),
                          backlog / getattr(c, f"svc_{prio}"),
                          out=getattr(self, f"imp_{prio}")[k // self.stride])
        if self.fire is not None:
            self.fire[k] = fire
        if self.frac is not None:
            self.frac[k] = frac
            self.row_w[k] = rw

    def results(self) -> Dict[str, np.ndarray]:
        """The block's outputs on the host, member-major: ``[M, n, ...]``."""
        def host(t, *order):
            return t.permute(*order).contiguous().cpu().numpy()
        out = dict(nbr=self.nbr.cpu().numpy().astype(np.int64),
                   peak=self.peak.cpu().numpy(),
                   mean=(self.fsum / self.n_ticks).cpu().numpy(),
                   imp_hp=host(self.imp_hp, 1, 2, 3, 0),
                   imp_lp=host(self.imp_lp, 1, 2, 3, 0))
        if self.fire is not None:
            out["fire"] = host(self.fire, 1, 2, 0, 3)
        if self.frac is not None:
            out["frac"] = host(self.frac, 1, 2, 0)
            out["row_w"] = host(self.row_w, 1, 2, 0, 3)
        return out


def _lane_bytes(model: TickModel, n_models: int, keep_series: bool,
                keep_fire: bool) -> int:
    """Device bytes of the torch engine per member of a block: per lane its
    occupancy, ring, slope window, impact slots and state, the kept planes;
    times rows and scenarios."""
    T, R = model.n_ticks, model.n_rows
    words = (T + 2 * model.ring_depth + 2 * model.n_slots + _LANE_STATE_WORDS
             + (max(1, model.window) if model.predictive else 0)
             + (T if keep_series else 0))
    per_member = R * (8 * words + (T if keep_fire else 0))
    if keep_series:
        per_member += 8 * T
    return n_models * per_member


def _member_chunk(member_chunk: Optional[int], models: Sequence[TickModel],
                  n_dev: int, keep_series: bool, keep_fire: bool) -> int:
    """Members a block (0 = a shard's members in one block). ``None`` is
    the card's auto rule: one block per shard while it fits
    :data:`_AUTO_CHUNK_BYTES`, else the fewest equal blocks that do."""
    if member_chunk is not None:
        chunk = int(member_chunk)
        if chunk < 0:
            raise ValueError(f"member_chunk must be >= 0, got {member_chunk}")
        return chunk
    per = math.ceil(models[0].n_members / n_dev)
    member = _lane_bytes(models[0], len(models), keep_series, keep_fire)
    if per * member <= _AUTO_CHUNK_BYTES:
        return 0
    n_blocks = math.ceil(per / max(1, _AUTO_CHUNK_BYTES // member))
    return math.ceil(per / n_blocks)


def _run_torch_models(models: Sequence[TickModel], *, keep_series: bool,
                      keep_fire: bool, member_chunk: Optional[int],
                      devices: Sequence[torch.device]) -> List[BatchedRun]:
    """Run one geometry bucket of models on the torch engine and return one
    :class:`BatchedRun` per model, in order.

    Members are padded cyclically to a multiple of chunk x devices (padding
    members are independent lanes, sliced off after), split into equal
    contiguous shards, one per device, and each shard into blocks of
    ``member_chunk`` members. Block b of every shard runs at once: one tick
    loop steps each shard's lanes on its own device in turn (launches are
    asynchronous, so the devices overlap; no collectives). Results come back
    to the host in member order."""
    m0 = models[0]
    key0 = _geometry_key(m0)
    for m in models[1:]:
        if _geometry_key(m) != key0:
            raise ValueError(
                f"grid bucket mixes tick geometries: {_geometry_key(m)} vs "
                f"{key0} (bucket specs with run_batched_grid)")
    N = m0.n_members
    if N < 1:
        raise ValueError(f"{m0.base_name!r} lowered no members")
    n_dev = len(devices)
    chunk = _member_chunk(member_chunk, models, n_dev, keep_series, keep_fire)
    n_pad = (-N) % (n_dev * max(1, chunk))
    idx = np.resize(np.arange(N), N + n_pad)
    per = len(idx) // n_dev
    block = chunk if chunk > 0 else per
    parts: List[List[Dict[str, np.ndarray]]] = [[] for _ in devices]
    for b0 in range(0, per, block):
        lanes = [_Lanes(models, idx[s * per + b0:s * per + b0 + block], dev,
                        keep_series=keep_series, keep_fire=keep_fire)
                 for s, dev in enumerate(devices)]
        for k in range(m0.n_ticks):
            for ln in lanes:
                ln.step(k)
        for s, res in enumerate([ln.results() for ln in lanes]):
            parts[s].append(res)
        del lanes
    flat = [p for shard in parts for p in shard]
    out = {}
    for key in flat[0]:
        arrs = [p[key] for p in flat]
        out[key] = (arrs[0] if len(arrs) == 1
                    else np.concatenate(arrs, axis=1))[:, :N]
    runs = []
    for i, m in enumerate(models):
        run = BatchedRun(
            engine="torch", model=m,
            brake_fire=out["fire"][i] if keep_fire else None,
            n_brakes=out["nbr"][i], peak_frac=out["peak"][i],
            mean_frac=out["mean"][i], impacts_hp=out["imp_hp"][i],
            impacts_lp=out["imp_lp"][i])
        if keep_series:
            run.total_frac = out["frac"][i]
            run.row_w = out["row_w"][i]
            if m.node_matrix is not None:
                run.node_w = np.einsum("ntr,mr->ntm", run.row_w, m.node_matrix)
        runs.append(run)
    return runs


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _check_engine(engine: str, member_chunk=None, devices=None) -> None:
    if engine not in ENGINES:
        raise ValueError(
            f"unknown batched engine {engine!r}: this port runs "
            f"engine='cuda' (the tick kernel, the JAX package's 'pallas' "
            f"counterpart) and engine='torch' (the scan engine, the JAX "
            f"package's 'jax' counterpart); the event-driven engine "
            f"engine='numpy' is run_ensemble's and run_ensemble_grid's")
    if engine == "cuda" and (member_chunk is not None or devices is not None):
        raise ValueError(
            "member_chunk and devices apply to engine='torch'; "
            "engine='cuda' runs one kernel launch on one device")


def _engine_devices(device, devices) -> List[torch.device]:
    """``devices`` when given (the member shards' devices), else the one
    ``device``."""
    return resolve_devices([device] if devices is None else devices)


def _run_models(models: Sequence[TickModel], engine: str, keep_series: bool,
                keep_fire: bool, member_chunk: Optional[int],
                devices: Sequence[torch.device]) -> List[BatchedRun]:
    if engine == "torch":
        return _run_torch_models(models, keep_series=keep_series,
                                 keep_fire=keep_fire,
                                 member_chunk=member_chunk, devices=devices)
    return [_run_cuda(m, keep_series, keep_fire, devices[0]) for m in models]


def run_tick_model(model: TickModel, *, engine: str = "cuda",
                   keep_series: bool = True, keep_brake_fire: bool = True,
                   device=None, member_chunk: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> BatchedRun:
    """Run a lowered tick program, on the card unless ``device="cpu"``.

    ``engine="cuda"`` is the tick kernel (non-predictive policies; on the
    CPU its plain PyTorch version); ``engine="torch"`` the scan engine, a
    grid of one (:func:`run_tick_models`), which also runs predictive
    policies and takes ``member_chunk`` and ``devices``."""
    _check_engine(engine, member_chunk, devices)
    return _run_models([model], engine, keep_series, keep_brake_fire,
                       member_chunk, _engine_devices(device, devices))[0]


def run_tick_models(models: Sequence[TickModel], *,
                    keep_series: bool = True, keep_brake_fire: bool = True,
                    device=None, member_chunk: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> List[BatchedRun]:
    """Run a same-geometry bucket of lowered models on the torch engine as
    one lane tensor (the scenario axis on top of the member axis) and
    return one :class:`BatchedRun` per model, in order.

    ``member_chunk``: ``None`` = auto (:func:`_member_chunk`), ``0`` = all
    of a shard's members at once, ``k > 0`` = blocks of k members.
    ``devices``: a sequence of torch devices (``"cuda:0"``, ``"cuda:1"``,
    or ``"cpu"``) over which the members shard; it replaces ``device``.
    Results do not depend on either knob, bit for bit."""
    return _run_torch_models(list(models), keep_series=keep_series,
                             keep_fire=keep_brake_fire,
                             member_chunk=member_chunk,
                             devices=_engine_devices(device, devices))


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
                         member_stats: Optional[bool] = None,
                         member_chunk: Optional[int] = None,
                         devices: Optional[Sequence] = None) -> EnsembleResult:
    """Evaluate an ensemble on the batched tick engine: lower on the host,
    run on ``device`` (the card unless ``device="cpu"``), summarize.

    The ``None``-default knobs auto-scale with ensemble size:
    ``keep_series`` keeps per-tick power series under 4e6 member-tick
    cells; ``keep_brake_fire`` drops the [N, T, R] brake plane (counts
    survive) past 2e8 cells; ``member_stats`` switches to dense [N, K]
    impact arrays past 2e4 members. ``member_chunk`` and ``devices`` go to
    the torch engine (:func:`run_tick_models`)."""
    _check_engine(engine, member_chunk, devices)
    devs = _engine_devices(device, devices)
    model, members, budget = lower_ensemble(spec, budget_w=budget_w)
    keep_series, keep_fire, member_stats = _auto_flags(
        model, keep_series, keep_brake_fire, member_stats)
    run = _run_models([model], engine, keep_series, keep_fire, member_chunk,
                      devs)[0]
    return _to_ensemble_result(model, members, budget, run,
                               member_stats=member_stats)


def run_batched_grid(specs: Sequence[EnsembleSpec], *,
                     budget_w: Optional[float] = None,
                     engine: str = "torch", device=None,
                     keep_series: Optional[bool] = None,
                     keep_brake_fire: Optional[bool] = None,
                     member_stats: Optional[bool] = None,
                     member_chunk: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> List[EnsembleResult]:
    """Evaluate M ensembles, one :class:`EnsembleResult` per spec, in spec
    order.

    Specs are lowered individually (per-spec budget resolution unless
    ``budget_w`` pins one envelope). On ``engine="torch"`` they are
    bucketed by tick geometry (:func:`_geometry_key`) and the keep flags,
    and each bucket runs as one lane tensor (:func:`run_tick_models`);
    ``engine="cuda"`` runs one kernel launch per scenario."""
    _check_engine(engine, member_chunk, devices)
    devs = _engine_devices(device, devices)
    lowered = [lower_ensemble(s, budget_w=budget_w) for s in specs]
    flags = [_auto_flags(m, keep_series, keep_brake_fire, member_stats)
             for m, _, _ in lowered]
    buckets: Dict[tuple, List[int]] = {}
    for i, (m, _, _) in enumerate(lowered):
        key = (_geometry_key(m) + flags[i][:2] if engine == "torch"
               else (i,))
        buckets.setdefault(key, []).append(i)
    runs: List[Optional[BatchedRun]] = [None] * len(lowered)
    for idxs in buckets.values():
        ks, kf, _ = flags[idxs[0]]
        bruns = _run_models([lowered[i][0] for i in idxs], engine, ks, kf,
                            member_chunk, devs)
        for i, r in zip(idxs, bruns):
            runs[i] = r
    return [_to_ensemble_result(m, mem, budget, run, member_stats=flags[i][2])
            for i, ((m, mem, budget), run) in enumerate(zip(lowered, runs))]
