"""Occupancy-generator families for trace ensembles
(port of ``repro.provisioning.ensembles``).

Seeded, parameterized scenario families beyond the single diurnal baseline:
``bursty`` (flash crowds), ``colocated`` (training + inference on one row),
``failover-surge`` (regional failover absorbs a neighbor's traffic),
``rack-incident`` (capacity loss + redistribution), and ``nighttime``
(low-entropy trough traffic). Each registers in the ``core.traces``
generator registry on import, so any
:class:`~repro_torch.experiments.scenario.Scenario` selects one
declaratively via ``TrafficSpec(generator=..., gen_params=...)``.
:func:`compose_rows` mixes a shared fleet-wide component with per-row noise
under a correlation knob ``rho`` for multi-row scenarios.
:func:`compose_site` folds per-row power series into rack and site series
through a :class:`~repro_torch.core.hierarchy.PowerHierarchy`, preserving
``sum(rows) == rack`` / ``sum(racks) == site``.

Named Monte-Carlo scenarios (``mc-*``, :data:`MC_SCENARIO_FAMILY`)
register alongside the Scenario registry on import.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.hierarchy import PowerHierarchy
from repro_torch.core.traces import DAY, occupancy_curve, register_occupancy_generator
from repro_torch.experiments.scenario import (
    FleetSpec,
    PolicySpec,
    Scenario,
    TrafficSpec,
    register_scenario,
)

OCC_LO, OCC_HI = 0.05, 0.98  # same clip band as the diurnal baseline


def _slow_noise(rng: np.ndarray, t: np.ndarray, sigma: float) -> np.ndarray:
    """Smooth low-frequency noise (coarse gaussian knots, interpolated)."""
    knots = t[:: max(1, len(t) // 200)]
    return np.interp(t, knots, rng.normal(0.0, sigma, size=len(knots)))


def compose_rows(base: np.ndarray, n_rows: int, *, rho: float, seed: int,
                 sigma: float = 0.04, t_grid: np.ndarray = None) -> np.ndarray:
    """[n_rows, T] row occupancy curves sharing ``base`` with correlation
    ``rho``: each row is ``base + rho*shared_noise + (1-rho)*own_noise``.
    ``rho=1`` makes every row identical (synchronized peaks), ``rho=0``
    decorrelates them fully."""
    t = np.arange(len(base), dtype=float) if t_grid is None else t_grid
    rho = float(np.clip(rho, 0.0, 1.0))
    shared = _slow_noise(np.random.default_rng(seed), t, sigma)
    rows = np.empty((n_rows, len(base)))
    for r in range(n_rows):
        own = _slow_noise(np.random.default_rng((seed + 1) * 7919 + r), t, sigma)
        rows[r] = base + rho * shared + (1.0 - rho) * own
    return np.clip(rows, OCC_LO, OCC_HI)


def _row_view(base: np.ndarray, t_grid: np.ndarray, *, seed: int, n_rows: int,
              row: int, rho: float, sigma: float = 0.04) -> np.ndarray:
    """One row's curve out of the correlated composition (single-row
    scenarios skip the composition entirely)."""
    if n_rows <= 1:
        return np.clip(base, OCC_LO, OCC_HI)
    return compose_rows(base, n_rows, rho=rho, seed=seed, sigma=sigma,
                        t_grid=t_grid)[row]


# ---------------------------------------------------------------------------
# scenario-family generators
# ---------------------------------------------------------------------------

def bursty(t_grid: np.ndarray, *, seed: int = 1, peak: float = 0.62,
           n_rows: int = 1, row: int = 0, rho: float = 0.8,
           bursts_per_day: float = 3.0, burst_amp_lo: float = 0.15,
           burst_amp_hi: float = 0.35, burst_rise_s: float = 120.0,
           burst_decay_s: float = 1500.0) -> np.ndarray:
    """Flash-crowd traffic: the diurnal baseline plus Poisson-arriving
    occupancy spikes with a fast rise and exponential decay. Bursts are
    fleet-wide events (a viral prompt hits every row), so they ride the
    shared component regardless of ``rho``."""
    rng = np.random.default_rng(seed)
    base = occupancy_curve(t_grid, peak=peak, seed=seed)
    duration = float(t_grid[-1]) if len(t_grid) else 0.0
    n_bursts = rng.poisson(bursts_per_day * duration / DAY)
    spikes = np.zeros_like(base)
    for _ in range(n_bursts):
        t0 = rng.uniform(0.0, duration)
        amp = rng.uniform(burst_amp_lo, burst_amp_hi)
        dt = t_grid - t0
        rise = np.clip(dt / burst_rise_s, 0.0, 1.0)
        spikes += np.where(dt >= 0.0, amp * rise * np.exp(-dt / burst_decay_s), 0.0)
    return _row_view(base + spikes, t_grid, seed=seed, n_rows=n_rows, row=row,
                     rho=rho)


def colocated(t_grid: np.ndarray, *, seed: int = 1, peak: float = 0.62,
              n_rows: int = 1, row: int = 0, rho: float = 0.5,
              train_share: float = 0.45, inference_share: float = 0.50,
              n_jobs: int = 8, job_util_lo: float = 0.55,
              job_util_hi: float = 0.95) -> np.ndarray:
    """Training + inference colocated on one row: a piecewise-constant
    training floor (back-to-back jobs at different utilizations, seeded) under
    a scaled diurnal inference layer. High mean, low diurnal swing — the
    profile POLCA §5.2 treats as the hard case for oversubscription."""
    rng = np.random.default_rng(seed)
    inference = occupancy_curve(t_grid, peak=peak, seed=seed) * inference_share
    duration = float(t_grid[-1]) if len(t_grid) else 0.0
    edges = np.sort(rng.uniform(0.0, duration, size=max(0, n_jobs - 1)))
    utils = rng.uniform(job_util_lo, job_util_hi, size=n_jobs)
    train = utils[np.searchsorted(edges, t_grid)] * train_share
    return _row_view(inference + train, t_grid, seed=seed, n_rows=n_rows,
                     row=row, rho=rho)


def failover_surge(t_grid: np.ndarray, *, seed: int = 1, peak: float = 0.62,
                   n_rows: int = 1, row: int = 0, rho: float = 0.9,
                   surge_frac: float = 0.45, surge_hours_lo: float = 1.0,
                   surge_hours_hi: float = 4.0,
                   ramp_s: float = 600.0) -> np.ndarray:
    """Regional-failover surge: baseline diurnal traffic, plus one window
    (seeded start, 1-4 h) where this site absorbs a failed region's load —
    occupancy steps up by ``surge_frac`` with a DNS-drain-speed ramp."""
    rng = np.random.default_rng(seed)
    base = occupancy_curve(t_grid, peak=peak, seed=seed)
    duration = float(t_grid[-1]) if len(t_grid) else 0.0
    span = rng.uniform(surge_hours_lo, surge_hours_hi) * 3600.0
    t0 = rng.uniform(0.0, max(1.0, duration - span))
    up = np.clip((t_grid - t0) / ramp_s, 0.0, 1.0)
    down = np.clip((t0 + span - t_grid) / ramp_s, 0.0, 1.0)
    window = np.minimum(up, down)
    return _row_view(base * (1.0 + surge_frac * window), t_grid, seed=seed,
                     n_rows=n_rows, row=row, rho=rho)


def rack_incident(t_grid: np.ndarray, *, seed: int = 1, peak: float = 0.62,
                  n_rows: int = 1, row: int = 0, rho: float = 0.8,
                  rows_per_rack: int = 2, repair_hours: float = 6.0) -> np.ndarray:
    """Capacity incident: at a seeded time one rack drops off (its rows go to
    the idle floor) and the surviving rows absorb its traffic until repair —
    load-conserving redistribution. With a single row, the row plays the
    survivor: it absorbs a failed neighbor rack's share."""
    rng = np.random.default_rng(seed)
    base = occupancy_curve(t_grid, peak=peak, seed=seed)
    duration = float(t_grid[-1]) if len(t_grid) else 0.0
    t0 = rng.uniform(0.0, max(1.0, duration * 0.8))
    window = (t_grid >= t0) & (t_grid < t0 + repair_hours * 3600.0)
    n_lost = max(1, min(rows_per_rack, max(1, n_rows - 1)))
    if n_rows > 1:
        lost_rack = int(rng.integers(0, max(1, -(-n_rows // rows_per_rack))))
        lost = range(lost_rack * rows_per_rack,
                     min(n_rows, lost_rack * rows_per_rack + rows_per_rack))
        n_lost = len(list(lost))
        curve = _row_view(base, t_grid, seed=seed, n_rows=n_rows, row=row,
                          rho=rho)
        if row in lost:
            return np.where(window, OCC_LO, curve)
        absorb = n_lost / max(1, n_rows - n_lost)
        return np.clip(np.where(window, curve * (1.0 + absorb), curve),
                       OCC_LO, OCC_HI)
    # single row: survivor absorbing one lost rack's worth of traffic
    absorb = n_lost / max(1, rows_per_rack)
    return np.clip(np.where(window, base * (1.0 + absorb), base),
                   OCC_LO, OCC_HI)


def nighttime(t_grid: np.ndarray, *, seed: int = 1, peak: float = 0.62,
              n_rows: int = 1, row: int = 0, rho: float = 0.3,
              level_frac: float = 0.45, noise: float = 0.01) -> np.ndarray:
    """Low-entropy nighttime traffic: a flat trough at ``level_frac * peak``
    with tiny noise — the regime where oversubscription headroom is largest
    and a planner should push far past the daytime-safe ratio."""
    rng = np.random.default_rng(seed)
    base = np.full_like(np.asarray(t_grid, float), level_frac * peak)
    base = base + _slow_noise(rng, np.asarray(t_grid, float), noise)
    return _row_view(base, t_grid, seed=seed, n_rows=n_rows, row=row, rho=rho,
                     sigma=noise)


GENERATOR_FAMILY = {
    "bursty": bursty,
    "colocated": colocated,
    "failover-surge": failover_surge,
    "rack-incident": rack_incident,
    "nighttime": nighttime,
}

for _name, _gen in GENERATOR_FAMILY.items():
    register_occupancy_generator(_name, _gen, overwrite=True)



# ---------------------------------------------------------------------------
# site-trace composition
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SiteTrace:
    """Row -> rack -> ... -> site power composition (watts, [.., T] arrays).
    ``rack_w`` is the leaf-parent level; ``node_w`` carries the full
    per-node series (leaves first, root last, node order of the folding
    :class:`~repro_torch.core.hierarchy.PowerHierarchy`)."""

    row_w: np.ndarray  # [R, T]
    rack_w: np.ndarray  # [K, T]
    site_w: np.ndarray  # [T]
    rack_of: np.ndarray  # [R] rack index per row
    node_w: Optional[np.ndarray] = field(default=None, repr=False)  # [N, T]
    node_names: Tuple[str, ...] = ()


def compose_site(row_w: np.ndarray, *, rows_per_rack: int = 2,
                 hierarchy: Optional[PowerHierarchy] = None) -> SiteTrace:
    """Fold per-row power series through the planning hierarchy — one
    :meth:`~repro_torch.core.hierarchy.PowerHierarchy.fold_w`. Every node's
    series is the sum of its rows.

    By default the tree is the two-level row -> rack -> site split, which
    requires ``n_rows`` divisible by ``rows_per_rack`` (a ragged tail rack
    raises). Pass an explicit ``hierarchy`` for arbitrary-depth (or ragged)
    site topologies.
    """
    row_w = np.atleast_2d(np.asarray(row_w, float))
    n_rows = row_w.shape[0]
    if hierarchy is None:
        if rows_per_rack < 1:
            raise ValueError(f"rows_per_rack must be >= 1, got {rows_per_rack}")
        if n_rows % rows_per_rack:
            raise ValueError(
                f"compose_site: {n_rows} rows do not divide into racks of "
                f"{rows_per_rack} — a ragged tail rack would be silently "
                f"mis-sized; pass a divisible n_rows or an explicit "
                f"PowerHierarchy for ragged topologies")
        # budgets are irrelevant for a watts fold; ones keep the tree valid
        hierarchy = PowerHierarchy.two_level(
            np.ones(n_rows), rows_per_rack=rows_per_rack)
    elif hierarchy.n_leaves != n_rows:
        raise ValueError(f"hierarchy has {hierarchy.n_leaves} leaves for "
                         f"{n_rows} rows")
    node_w = hierarchy.fold_w(row_w.T).T  # [N, T]
    ordinal = {int(p): k for k, p in enumerate(hierarchy.leaf_parents)}
    rack_of = np.asarray([ordinal[int(hierarchy.parent[i])]
                          for i in range(n_rows)])
    return SiteTrace(row_w=row_w, rack_w=node_w[hierarchy.leaf_parents],
                     site_w=node_w[hierarchy.root], rack_of=rack_of,
                     node_w=node_w, node_names=hierarchy.names)


# ---------------------------------------------------------------------------
# named Monte-Carlo scenarios (registered alongside the figure scenarios)
# ---------------------------------------------------------------------------

MC_BASE_NAME = "mc-diurnal"
MC_SCENARIO_FAMILY: List[str] = [
    MC_BASE_NAME,
    "mc-bursty",
    "mc-colocated",
    "mc-failover",
    "mc-rack-incident",
    "mc-nighttime",
]


def _mc_scenario(name: str, generator: str, **gen_params) -> Scenario:
    return register_scenario(Scenario(
        name=name,
        duration_s=DAY / 2,
        fleet=FleetSpec(n_provisioned=40, added_frac=0.0),
        policy=PolicySpec("polca"),
        traffic=TrafficSpec(occ_peak=0.62, generator=generator,
                            gen_params=gen_params),
        budget="calibrated",
        compare_to_reference=False,
    ), overwrite=True)


_mc_scenario(MC_BASE_NAME, "diurnal")
_mc_scenario("mc-bursty", "bursty")
_mc_scenario("mc-colocated", "colocated")
_mc_scenario("mc-failover", "failover-surge")
_mc_scenario("mc-rack-incident", "rack-incident")
_mc_scenario("mc-nighttime", "nighttime")
