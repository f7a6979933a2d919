"""Power-budget trees over a fleet's rows (port of ``repro.core.hierarchy``,
copied in full).

POLCA's oversubscription argument is hierarchical: headroom exists at the
row, rack, PDU-set and site levels, and production clusters enforce a power
budget at each. :class:`PowerHierarchy` is that structure:

* **Topology** — a rooted tree whose leaves are rows (leaf index ==
  ``RowSimulator`` list index) and whose interior nodes (racks, PDU sets,
  the site root, any depth) each hold a power budget. Budgets default to the
  sum of their children's budgets, level by level.

* **Accounting** — :meth:`fold_w` turns a ``[T, R]`` per-row power matrix
  into a ``[T, N]`` per-node matrix; every interior node's series is the
  sum of its descendant-leaf columns in leaf order, the root's the direct
  row sum. :meth:`node_w` is the same fold for one ``[R]`` sample, and
  :meth:`fold` the per-node fractions of each node's budget.

* **Telemetry publishing** — :meth:`publish` pushes each leaf's *ancestor*
  budget fractions into its row as a level-indexed vector (immediate parent
  first, root last); on a two-level tree that is the ``(rack_frac,
  cluster_frac)`` 2-tuple. :class:`~repro_torch.experiments.cluster.
  ClusterSimulator` publishes before each lockstep tick.

``node_cap_w`` (physical capacity ceilings, +inf by default) and
:meth:`conservation_errors` are what the JAX package's budget-rebalancing
controller and chaos injector read; the port carries them unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class PowerHierarchy:
    """An arbitrary-depth power-budget tree over ``n_leaves`` rows.

    Nodes are indexed ``0 .. n_nodes-1`` with the leaves first
    (``0 .. n_leaves-1``, matching the row order) and interior nodes after,
    children always before their parent (the root is the last node). This
    bottom-up ordering makes "sum children into parents" a single forward
    pass over the interior nodes.

    ``parent[i]`` is the parent node index (``-1`` for the root);
    ``node_budget_w[i]`` the node's power budget in watts (mutable — the
    fleet controller re-divides interior budgets under ``scope="tree"``);
    ``names[i]`` a human-readable label carried into telemetry and docs.
    """

    def __init__(self, parent: Sequence[int], node_budget_w: Sequence[float],
                 n_leaves: int, names: Optional[Sequence[str]] = None):
        self.parent = np.asarray(parent, dtype=int)
        self.node_budget_w = np.asarray(node_budget_w, dtype=float).copy()
        self.n_leaves = int(n_leaves)
        self.n_nodes = len(self.parent)
        if len(self.node_budget_w) != self.n_nodes:
            raise ValueError(
                f"{len(self.node_budget_w)} budgets for {self.n_nodes} nodes")
        if not 0 < self.n_leaves <= self.n_nodes:
            raise ValueError(
                f"n_leaves={self.n_leaves} out of range for {self.n_nodes} nodes")
        roots = np.flatnonzero(self.parent < 0)
        if len(roots) != 1:
            raise ValueError(f"need exactly one root, got {len(roots)}")
        self.root = int(roots[0])
        # children before parents: a forward pass over interior nodes folds
        # leaves upward without an explicit toposort
        for i, p in enumerate(self.parent):
            if p >= 0 and p <= i:
                raise ValueError(
                    f"node {i} has parent {p} <= itself; order children first")
            if 0 <= p < self.n_leaves:
                raise ValueError(f"leaf {p} cannot be a parent (of node {i})")
        self.names: Tuple[str, ...] = tuple(
            names if names is not None
            else [f"row{i}" for i in range(self.n_leaves)]
            + [f"node{i}" for i in range(self.n_leaves, self.n_nodes)])
        if len(self.names) != self.n_nodes:
            raise ValueError(f"{len(self.names)} names for {self.n_nodes} nodes")
        # physical capacity ceilings, +inf by default. Distinct from budgets:
        # a budget is the *planner's* division of the envelope and moves
        # freely under rebalancing; a cap is what the hardware can currently
        # deliver. The chaos engine lowers a node's cap on a derate (PDU feed
        # loss, thermal throttle) and the rebalancing controller clamps its
        # divisions to it — otherwise a tree-scope pass would "heal" the
        # fault by growing the derated subtree back on its next interval.
        self.node_cap_w = np.full(self.n_nodes, np.inf)

        self.children: List[np.ndarray] = [
            np.flatnonzero(self.parent == i) for i in range(self.n_nodes)]
        for i in range(self.n_leaves):
            if len(self.children[i]):
                raise ValueError(f"leaf {i} has children")
        for i in range(self.n_leaves, self.n_nodes):
            if not len(self.children[i]):
                raise ValueError(f"interior node {i} ({self.names[i]}) is "
                                 "childless — every interior node needs rows "
                                 "under it")
        # descendant leaves per node, in leaf-index order (the summation
        # order every fold uses — this is what makes two-level folds
        # bit-identical to the legacy flat expressions)
        self.leaf_desc: List[np.ndarray] = [np.asarray([i], dtype=int)
                                            for i in range(self.n_leaves)]
        for i in range(self.n_leaves, self.n_nodes):
            self.leaf_desc.append(np.sort(np.concatenate(
                [self.leaf_desc[int(c)] for c in self.children[i]])))
        if len(self.leaf_desc[self.root]) != self.n_leaves:
            raise ValueError("root does not cover every leaf")
        # ancestors per leaf, leaf-upward (immediate parent first, root last)
        self.ancestors: List[np.ndarray] = []
        for i in range(self.n_leaves):
            chain = []
            p = int(self.parent[i])
            while p >= 0:
                chain.append(p)
                p = int(self.parent[p])
            self.ancestors.append(np.asarray(chain, dtype=int))
        self.depth = max(len(a) for a in self.ancestors)
        # interior nodes grouped by level, counted from the leaves: level 0 =
        # leaf parents ("racks" on a two-level tree), the last level = root
        self.levels: List[np.ndarray] = []
        for lv in range(self.depth):
            seen: List[int] = []
            for a in self.ancestors:
                if len(a) > lv and int(a[lv]) not in seen:
                    seen.append(int(a[lv]))
            self.levels.append(np.asarray(seen, dtype=int))

    # -- constructors -------------------------------------------------------
    @classmethod
    def two_level(cls, row_budget_w: Sequence[float], *, rows_per_rack: int = 2,
                  rack_budget_w: Optional[Sequence[float]] = None,
                  cluster_budget_w: Optional[float] = None) -> "PowerHierarchy":
        """The legacy row -> rack -> cluster split (``RackHierarchy``'s
        topology and budget defaulting, bit for bit): racks take consecutive
        runs of ``rows_per_rack`` rows (the last rack may be ragged), rack
        budgets default to the sum of their rows, the cluster budget to the
        sum of the racks."""
        row_budget_w = np.asarray(row_budget_w, dtype=float)
        n_rows = len(row_budget_w)
        rows_per_rack = max(1, int(rows_per_rack))
        n_racks = math.ceil(n_rows / rows_per_rack)
        rack_of = np.asarray([i // rows_per_rack for i in range(n_rows)])
        if rack_budget_w is None:
            rack_budget_w = [float(row_budget_w[rack_of == k].sum())
                             for k in range(n_racks)]
        rack_budget_w = np.asarray(rack_budget_w, dtype=float)
        if len(rack_budget_w) != n_racks:
            raise ValueError(
                f"{len(rack_budget_w)} rack budgets for {n_racks} racks")
        cluster = float(cluster_budget_w if cluster_budget_w is not None
                        else rack_budget_w.sum())
        parent = ([n_rows + k for k in rack_of]
                  + [n_rows + n_racks] * n_racks + [-1])
        budgets = np.concatenate([row_budget_w, rack_budget_w, [cluster]])
        names = ([f"row{i}" for i in range(n_rows)]
                 + [f"rack{k}" for k in range(n_racks)] + ["cluster"])
        return cls(parent, budgets, n_rows, names)

    @classmethod
    def from_shape(cls, shape: Sequence[int], row_budget_w: Sequence[float], *,
                   level_names: Optional[Sequence[str]] = None,
                   budget_fracs: Optional[Dict[str, float]] = None
                   ) -> "PowerHierarchy":
        """A uniform tree from root-down fan-outs: ``shape=(2, 2, 3)`` is a
        root with 2 children (PDU sets), each with 2 children (racks), each
        hosting 3 rows — ``prod(shape)`` leaves total.

        ``level_names`` labels the *interior* levels root-down (default
        ``site`` / ``pduN`` / ``rackN`` style); ``budget_fracs`` derates
        nodes by root-down path (``"0/1"`` = second child of the root's
        first child). A derate multiplies every descendant leaf's budget —
        planner-shaped budgets stay *conservative*: each node's budget is
        exactly the sum of its children's, so a derated rack shrinks its
        rows' budgets rather than promising watts the PDU can't deliver.
        """
        shape = tuple(int(s) for s in shape)
        if not shape or any(s < 1 for s in shape):
            raise ValueError(f"shape must be positive fan-outs, got {shape}")
        n_rows = int(np.prod(shape))
        row_budget_w = np.asarray(row_budget_w, dtype=float)
        if len(row_budget_w) != n_rows:
            raise ValueError(
                f"shape {shape} implies {n_rows} rows, got "
                f"{len(row_budget_w)} row budgets")
        budget_fracs = dict(budget_fracs or {})
        if level_names is None:
            defaults = ["site", "pdu", "rack", "subrack", "shelf"]
            level_names = (defaults[:len(shape)] if len(shape) <= len(defaults)
                           else [f"l{d}" for d in range(len(shape))])
        level_names = tuple(level_names)
        if len(level_names) != len(shape):
            raise ValueError(f"{len(level_names)} level names for "
                             f"{len(shape)} interior levels")

        # enumerate interior nodes per level, root-down; leaves come first in
        # the node index space, then the deepest interior level, ..., root
        # (children always precede parents)
        counts = [1]
        for s in shape[:-1]:
            counts.append(counts[-1] * s)  # nodes at interior level d
        n_interior = sum(counts)
        n_nodes = n_rows + n_interior
        # interior node index for (level d root-down, ordinal j at that
        # level): deepest level sits right after the leaves
        offsets = {}
        base = n_rows
        for d in range(len(shape) - 1, -1, -1):
            offsets[d] = base
            base += counts[d]

        parent = np.empty(n_nodes, dtype=int)
        names: List[str] = [f"row{i}" for i in range(n_rows)] + [""] * n_interior
        paths: Dict[int, str] = {}
        leaf_derate = np.ones(n_rows)
        for d in range(len(shape)):
            for j in range(counts[d]):
                node = offsets[d] + j
                parent[node] = -1 if d == 0 else offsets[d - 1] + j // shape[d - 1]
                path = "/".join(str(x) for x in _path_digits(j, shape[:d]))
                paths[node] = path
                label = level_names[d] if d == 0 and counts[d] == 1 else \
                    f"{level_names[d]}{path.replace('/', '.')}"
                names[node] = label
        # leaves hang off the deepest interior level
        deepest = len(shape) - 1
        for i in range(n_rows):
            parent[i] = offsets[deepest] + i // shape[deepest]
        # derates: multiply every descendant leaf's budget
        known_paths = set(paths.values())
        for path, frac in budget_fracs.items():
            if path not in known_paths:
                raise ValueError(
                    f"budget_fracs path {path!r} names no interior node of "
                    f"shape {shape} (known: {sorted(known_paths)})")
            if not (np.isfinite(frac) and frac > 0.0):
                # a 0 W row budget divides telemetry by zero (and the
                # RowSimulator nominal fallback would silently *undo* it)
                raise ValueError(
                    f"budget_fracs[{path!r}] must be a positive finite "
                    f"multiplier, got {frac!r}")
            digits = [int(x) for x in path.split("/")] if path else []
            lo, hi = _leaf_span(digits, shape)
            leaf_derate[lo:hi] *= float(frac)
        budgets = np.empty(n_nodes)
        budgets[:n_rows] = row_budget_w * leaf_derate
        # interior budgets: sum of children, filled deepest level first
        for d in range(len(shape) - 1, -1, -1):
            for j in range(counts[d]):
                node = offsets[d] + j
                kids = (np.arange(j * shape[d], (j + 1) * shape[d])
                        if d == len(shape) - 1
                        else offsets[d + 1] + np.arange(j * shape[d],
                                                        (j + 1) * shape[d]))
                budgets[node] = float(budgets[kids].sum())
        return cls(parent, budgets, n_rows, names)

    # -- views --------------------------------------------------------------
    @property
    def leaf_budget_w(self) -> np.ndarray:
        """Budgets of the leaves (rows), in row order — a view."""
        return self.node_budget_w[:self.n_leaves]

    @property
    def interior(self) -> np.ndarray:
        """Interior node indices, children-first (root last)."""
        return np.arange(self.n_leaves, self.n_nodes)

    @property
    def leaf_parents(self) -> np.ndarray:
        """The leaf-parent ("rack") nodes, first-leaf order — level 0."""
        return self.levels[0]

    @property
    def root_budget_w(self) -> float:
        return float(self.node_budget_w[self.root])

    def subtree_leaves(self, node: int) -> np.ndarray:
        """Descendant-leaf indices of ``node``, in leaf order."""
        return self.leaf_desc[int(node)]

    # -- accounting ---------------------------------------------------------
    def node_w(self, row_w: np.ndarray) -> np.ndarray:
        """Per-node watts ``[N]`` from per-row watts ``[R]`` — the *publish*
        accumulation. Matches the legacy publish path bit for bit at any
        rack width: leaves accumulate into their parents via ``np.add.at``
        (strictly sequential in leaf order, exactly the legacy rack
        expression), interior totals then propagate upward children-first,
        and the root uses the direct ``row_w.sum()`` the legacy cluster
        expression used. (A pairwise ``row_w[desc].sum()``
        diverges from ``np.add.at`` in the last bits once a node spans > 8
        rows — the distinction is load-bearing for parity.)"""
        row_w = np.asarray(row_w, dtype=float)
        out = np.zeros(self.n_nodes)
        out[:self.n_leaves] = row_w
        np.add.at(out, self.parent[:self.n_leaves], row_w)
        for i in range(self.n_leaves, self.n_nodes - 1):
            p = int(self.parent[i])
            if p >= 0:
                out[p] += out[i]
        # the root alone uses the direct sum (the legacy *cluster*
        # expression); a full-cover rack keeps the accumulated value — the
        # legacy rack and cluster series were computed by different
        # expressions even when they covered the same rows
        out[self.root] = row_w.sum()
        return out

    def fold_w(self, power: np.ndarray) -> np.ndarray:
        """``[T, R]`` per-row watts -> ``[T, N]`` per-node watts, one
        vectorized masked sum per interior node."""
        power = np.asarray(power, dtype=float)
        out = np.empty((power.shape[0], self.n_nodes))
        out[:, :self.n_leaves] = power
        for i in range(self.n_leaves, self.n_nodes):
            # masked-column reductions for interior nodes (the legacy rack
            # expression — fancy and boolean masks reduce identically); the
            # root alone uses the direct sum (the legacy cluster
            # expression), which diverges from a masked copy in the last
            # bits once it spans > 8 rows
            out[:, i] = (power.sum(axis=1) if i == self.root
                         else power[:, self.leaf_desc[i]].sum(axis=1))
        return out

    def fold(self, power: np.ndarray,
             node_budget_w: Optional[np.ndarray] = None) -> np.ndarray:
        """``[T, R]`` per-row watts -> ``[T, N]`` per-node *fractions* of
        each node's budget. ``node_budget_w`` may be ``[N]`` (static budgets,
        default: the hierarchy's current budgets) or ``[T, N]`` (per-tick
        budgets recorded under a rebalancing controller)."""
        folded = self.fold_w(power)
        if not len(folded):
            return folded
        budgets = (self.node_budget_w if node_budget_w is None
                   else np.asarray(node_budget_w, dtype=float))
        if budgets.ndim == 1:
            return folded / budgets[None, :]
        return folded / budgets

    def publish(self, rows, row_w: np.ndarray) -> np.ndarray:
        """Compute per-node budget fractions from current per-row watts and
        push each leaf's ancestor fractions (parent first, root last) into
        its row's ``group_fracs`` vector. Returns the ``[N]`` fraction
        vector (callers read the root entry as the stale cluster frac)."""
        frac = self.node_w(row_w) / self.node_budget_w
        for i, r in enumerate(rows):
            r.group_fracs = tuple(float(frac[a]) for a in self.ancestors[i])
        return frac

    def conservation_errors(self, atol: float = 1e-6) -> List[str]:
        """Budget-tree consistency: every interior node's budget must equal
        the sum of its children's (the structural invariant rebalancing
        preserves). Returns human-readable violations (empty = consistent)."""
        errs = []
        for i in range(self.n_leaves, self.n_nodes):
            kids = float(self.node_budget_w[self.children[i]].sum())
            own = float(self.node_budget_w[i])
            if abs(kids - own) > atol:
                errs.append(f"{self.names[i]}: budget {own:.3f} W != "
                            f"children sum {kids:.3f} W")
        return errs


def _path_digits(ordinal: int, fanouts: Sequence[int]) -> List[int]:
    """Root-down path digits of the ``ordinal``-th node at a level whose
    ancestor fan-outs are ``fanouts`` (mixed-radix decomposition)."""
    digits: List[int] = []
    for f in reversed(fanouts):
        digits.append(ordinal % f)
        ordinal //= f
    return list(reversed(digits))


def _leaf_span(digits: Sequence[int], shape: Sequence[int]) -> Tuple[int, int]:
    """The contiguous leaf-index range under the interior node at root-down
    path ``digits`` in a uniform tree of ``shape`` (mixed-radix ordinal at
    the node's level, times leaves per node at that level)."""
    ordinal = 0
    for d, digit in enumerate(digits):
        ordinal = ordinal * shape[d] + digit
    leaves_per = int(np.prod(shape[len(digits):]))
    return ordinal * leaves_per, (ordinal + 1) * leaves_per
