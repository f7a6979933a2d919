"""Multi-row cluster simulation under hierarchical power budgets (port of
``repro.experiments.cluster``, copied in full).

``ClusterSimulator`` composes N :class:`~repro_torch.core.simulator.RowSimulator`
instances under a :class:`~repro_torch.core.hierarchy.PowerHierarchy` — by default
the classic row -> rack -> cluster split, but any arbitrary-depth budget tree
(row -> rack -> PDU set -> site) plugs in via the ``hierarchy`` parameter.
Rows keep their own event queues, policies, and budgets; the cluster layer
locksteps them on the telemetry grid and, before each tick, publishes
one-tick-stale ancestor power fractions into every row's ``group_fracs``
vector (a real rack manager aggregates with exactly this delay). Row policies
therefore see the full hierarchical
:class:`~repro_torch.core.telemetry.Telemetry` sample; policies that ignore the
group fields behave exactly as on a standalone row — a cluster run whose
per-row budget equals the single-row budget reproduces the standalone
``RowSimulator`` results bit-for-bit on the same trace.

Power accounting is vectorized: per-tick row powers land in a [T, R] numpy
array, and every aggregation level is one fold over it
(:meth:`~repro_torch.core.hierarchy.PowerHierarchy.fold`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.hierarchy import PowerHierarchy
from repro_torch.core.simulator import RowSimulator, SimResult


@dataclass
class ClusterResult:
    row_results: List[SimResult]
    power_t: np.ndarray = field(repr=False)  # [T] tick times
    row_power_frac: np.ndarray = field(repr=False)  # [T, R] of each row budget
    rack_power_frac: np.ndarray = field(repr=False)  # [T, n_racks] (leaf parents)
    cluster_power_frac: np.ndarray = field(repr=False)  # [T] of the root budget
    n_brakes: int = 0
    peak_cluster_frac: float = 0.0
    mean_cluster_frac: float = 0.0
    # full per-node telemetry (leaves first, root last) — the two fields
    # above are views into this for the rack level and the root
    node_power_frac: Optional[np.ndarray] = field(default=None, repr=False)  # [T, N]
    node_names: Tuple[str, ...] = ()

    @property
    def n_rows(self) -> int:
        return len(self.row_results)

    def spike(self, window_s: float) -> float:
        """Max cluster-power rise (fraction of cluster budget) in any window."""
        w = self.cluster_power_frac
        if len(w) < 3:
            return 0.0
        dt = float(self.power_t[1] - self.power_t[0])
        k = max(1, int(round(window_s / dt)))
        diffs = w[k:] - w[:-k]
        return float(diffs.max()) if len(diffs) else 0.0


class RackHierarchy(PowerHierarchy):
    """Thin two-level constructor over :class:`PowerHierarchy`: the classic
    row -> rack -> cluster split of :class:`ClusterSimulator` (and of the
    JAX package's routed-fleet driver). Rack assignment
    (consecutive runs of ``rows_per_rack``), budget defaulting (each level
    the sum of its children), stale group-fraction publishing, and the
    vectorized fold all live in the base class now — this subclass only
    keeps the legacy construction signature and attribute names."""

    def __init__(self, rows: List[RowSimulator], *, rows_per_rack: int = 2,
                 rack_budget_w: Optional[List[float]] = None,
                 cluster_budget_w: Optional[float] = None):
        proto = PowerHierarchy.two_level(
            [r.provisioned_w for r in rows], rows_per_rack=rows_per_rack,
            rack_budget_w=rack_budget_w, cluster_budget_w=cluster_budget_w)
        super().__init__(proto.parent, proto.node_budget_w, proto.n_leaves,
                         proto.names)
        self.rows_per_rack = max(1, rows_per_rack)
        self.n_racks = len(self.leaf_parents)
        self.rack_of = self.parent[:self.n_leaves] - self.n_leaves

    # legacy attribute names (tests and external callers)
    @property
    def row_budget_w(self) -> np.ndarray:
        return self.node_budget_w[:self.n_leaves]

    @property
    def rack_budget_w(self) -> np.ndarray:
        return self.node_budget_w[self.leaf_parents]

    @property
    def cluster_budget_w(self) -> float:
        return self.root_budget_w

    def publish_group_fracs(self, rows: List[RowSimulator], row_w: np.ndarray):
        """Legacy-shaped publish: push ancestor fracs into every row (the
        base-class :meth:`~repro_torch.core.hierarchy.PowerHierarchy.publish`) and
        return ``(rack_frac [K], cluster_frac)`` like the pre-hierarchy
        code."""
        frac = self.publish(rows, row_w)
        return frac[self.leaf_parents], float(frac[self.root])


def resolve_row_hierarchy(rows: List[RowSimulator],
                          hierarchy: Optional[PowerHierarchy], *,
                          rows_per_rack: int = 2,
                          rack_budget_w: Optional[List[float]] = None,
                          cluster_budget_w: Optional[float] = None) -> PowerHierarchy:
    """The budget tree a row-driving simulator runs under — shared by
    :class:`ClusterSimulator` and the fleet driver. An explicit
    ``hierarchy`` must match the row count and excludes the two-level
    budget arguments (they would be silently ignored otherwise); without
    one, the classic :class:`RackHierarchy` split is built from the rows."""
    if hierarchy is not None:
        if hierarchy.n_leaves != len(rows):
            raise ValueError(f"hierarchy has {hierarchy.n_leaves} leaves "
                             f"for {len(rows)} rows")
        if rack_budget_w is not None or cluster_budget_w is not None:
            raise ValueError(
                "pass either an explicit hierarchy or rack_budget_w/"
                "cluster_budget_w, not both — the hierarchy carries every "
                "level's budget")
        return hierarchy
    return RackHierarchy(rows, rows_per_rack=rows_per_rack,
                         rack_budget_w=rack_budget_w,
                         cluster_budget_w=cluster_budget_w)


class ClusterSimulator:
    """Lockstep N rows under a hierarchical power budget tree.

    With the default two-level tree, ``rack_budget_w``/``cluster_budget_w``
    default to the sum of their children's budgets (no extra
    oversubscription at the aggregation levels); pass smaller values to
    model oversubscribed PDUs above the row, or pass an explicit
    ``hierarchy`` (:class:`~repro_torch.core.hierarchy.PowerHierarchy`) for
    arbitrary-depth site topologies.
    """

    def __init__(self, rows: List[RowSimulator], *, rows_per_rack: int = 2,
                 rack_budget_w: Optional[List[float]] = None,
                 cluster_budget_w: Optional[float] = None,
                 telemetry_s: Optional[float] = None,
                 hierarchy: Optional[PowerHierarchy] = None):
        if not rows:
            raise ValueError("ClusterSimulator needs at least one row")
        self.rows = rows
        self.hierarchy = resolve_row_hierarchy(
            rows, hierarchy, rows_per_rack=rows_per_rack,
            rack_budget_w=rack_budget_w, cluster_budget_w=cluster_budget_w)
        self.telemetry_s = float(telemetry_s or rows[0].cfg.telemetry_s)

    def _publish_group_fracs(self, row_w: np.ndarray):
        return self.hierarchy.publish(self.rows, row_w)

    def run(self) -> ClusterResult:
        rows = self.rows
        for r in rows:
            r.start()
        duration = max(r.duration for r in rows)
        alive = [True] * len(rows)
        t = self.telemetry_s
        ticks: List[float] = []
        samples: List[np.ndarray] = []
        prev_row_w: Optional[np.ndarray] = None
        while t <= duration and any(alive):
            if prev_row_w is not None:
                # one tick stale: what the rack manager aggregated last sample
                self._publish_group_fracs(prev_row_w)
            for i, r in enumerate(rows):
                if alive[i]:
                    alive[i] = r.advance_to(min(t, r.duration))
            row_w = np.asarray([r.row_power for r in rows], float)
            ticks.append(t)
            samples.append(row_w)
            prev_row_w = row_w
            t += self.telemetry_s
        for r in rows:  # drain any events between the last tick and duration
            r.advance_to(r.duration)
        row_results = [r.finalize() for r in rows]

        power = (np.stack(samples) if samples
                 else np.zeros((0, len(rows))))  # [T, R] watts
        power_t = np.asarray(ticks)
        h = self.hierarchy
        node_frac = h.fold(power)  # [T, N] fractions of each node's budget
        cluster_frac = node_frac[:, h.root]
        return ClusterResult(
            row_results=row_results,
            power_t=power_t,
            row_power_frac=node_frac[:, :h.n_leaves],
            rack_power_frac=node_frac[:, h.leaf_parents],
            cluster_power_frac=cluster_frac,
            n_brakes=sum(rr.n_brakes for rr in row_results),
            peak_cluster_frac=float(cluster_frac.max()) if len(cluster_frac) else 0.0,
            mean_cluster_frac=float(cluster_frac.mean()) if len(cluster_frac) else 0.0,
            node_power_frac=node_frac,
            node_names=h.names,
        )
