"""Structured controller telemetry (the experiments-API policy protocol).

The paper's rack manager samples one number — row power — every 2 s and feeds
it to Algorithm 1. The redesigned protocol hands policies a full ``Telemetry``
sample instead: the row-power fraction Algorithm 1 consumed, plus the
per-priority power split, the phase split (prompt vs token power), the
currently-commanded cap state, the sample timestamp, and — in cluster runs —
the enclosing rack/cluster power fractions. Policies that only need the bare
fraction read ``tel.power_frac`` and behave exactly as before; richer policies
(predictive, phase-aware, cluster-aware) read the rest.

``step(p)`` on every policy wraps a bare fraction via
``Telemetry.from_power_frac``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.power_model import FREQ_UNCAPPED


@dataclass(frozen=True)
class Telemetry:
    """One controller sample. All power fields are fractions of the *row*
    budget except ``rack_power_frac``/``cluster_power_frac`` (fractions of the
    rack/cluster budgets, one tick stale in cluster runs — aggregation delay).
    ``None`` means "not observable on this deployment" (e.g. the legacy
    single-float path)."""

    t: float = 0.0
    power_frac: float = 0.0  # row power / row budget: Algorithm 1's `p`
    hp_power_frac: Optional[float] = None  # high-priority servers' share
    lp_power_frac: Optional[float] = None  # low-priority servers' share
    prefill_power_frac: Optional[float] = None  # servers in prompt phase
    lp_freq: float = FREQ_UNCAPPED  # currently-commanded cap state
    hp_freq: float = FREQ_UNCAPPED
    braked: bool = False
    row_index: int = 0
    rack_power_frac: Optional[float] = None
    cluster_power_frac: Optional[float] = None
    # budget fractions of every enclosing hierarchy level, nearest first
    # (rack), root last (cluster/site) — the full vector behind the two
    # convenience fields above; None outside hierarchy-driven runs. On the
    # classic two-level tree this is exactly (rack_power_frac,
    # cluster_power_frac); deeper site trees (row -> rack -> pdu-set ->
    # site) expose the intermediate levels here.
    group_power_fracs: Optional[Tuple[float, ...]] = None

    @classmethod
    def from_power_frac(cls, p: float, t: float = 0.0) -> "Telemetry":
        """Wrap the legacy bare row-power fraction."""
        return cls(t=t, power_frac=p)


class TelemetryPolicy:
    """Policy protocol: consume a ``Telemetry`` sample, emit cap commands.

    Subclasses implement ``observe``. ``step`` is the legacy protocol (bare
    row-power fraction) kept as a shim so pre-redesign call sites and traces
    replay identically.
    """

    def observe(self, tel: Telemetry) -> List:
        raise NotImplementedError

    def step(self, p: float) -> List:
        return self.observe(Telemetry.from_power_frac(p))


def dispatch(policy, tel: Telemetry) -> List:
    """Feed a sample to either protocol: ``observe(Telemetry)`` when the
    policy implements it, else the legacy ``step(p)``."""
    observe = getattr(policy, "observe", None)
    if observe is not None:
        return observe(tel)
    return policy.step(tel.power_frac)
