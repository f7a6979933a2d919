"""Service-level objectives (paper Table 5) and their evaluation."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass(frozen=True)
class SLO:
    hp_p50: float = 0.01  # < 1% latency impact
    hp_p99: float = 0.05  # < 5%
    lp_p50: float = 0.05  # < 5%
    lp_p99: float = 0.50  # < 50%
    max_powerbrakes: int = 0


DEFAULT_SLO = SLO()


@dataclass
class LatencyStats:
    """Relative latency impact vs the uncapped ideal, per priority class."""
    hp_impacts: List[float] = field(default_factory=list)
    lp_impacts: List[float] = field(default_factory=list)

    def add(self, priority: str, actual: float, ideal: float):
        impact = max(0.0, actual / ideal - 1.0)
        (self.hp_impacts if priority == "high" else self.lp_impacts).append(impact)

    def percentile(self, priority: str, q: float) -> float:
        xs = self.hp_impacts if priority == "high" else self.lp_impacts
        if not xs:
            return 0.0
        return float(np.percentile(np.asarray(xs), q))

    def summary(self) -> Dict[str, float]:
        return {
            "hp_p50": self.percentile("high", 50),
            "hp_p99": self.percentile("high", 99),
            "lp_p50": self.percentile("low", 50),
            "lp_p99": self.percentile("low", 99),
            "n_hp": len(self.hp_impacts),
            "n_lp": len(self.lp_impacts),
        }


def impact_vs_reference(latencies: Dict[int, float],
                        ref_latencies: Dict[int, float],
                        priorities: Dict[int, str]) -> "LatencyStats":
    """Per-request latency impact of a policy run vs the uncapped reference
    run on the same trace (the paper's comparison in §6). Requests missing
    from either run (dropped) are skipped."""
    st = LatencyStats()
    for rid, lat in latencies.items():
        ref = ref_latencies.get(rid)
        if ref is None or ref <= 0:
            continue
        st.add(priorities[rid], lat, ref)
    return st


def meets_slo(stats: LatencyStats, n_powerbrakes: int, slo: SLO = DEFAULT_SLO) -> bool:
    s = stats.summary()
    return (s["hp_p50"] < slo.hp_p50 and s["hp_p99"] < slo.hp_p99
            and s["lp_p50"] < slo.lp_p50 and s["lp_p99"] < slo.lp_p99
            and n_powerbrakes <= slo.max_powerbrakes)
