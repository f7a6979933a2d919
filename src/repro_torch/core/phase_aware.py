"""Beyond-paper extension (paper §7 'Phase-aware power management'; port of
``repro.core.phase_aware``, copied in full).

The serving engine knows which phase each server is in (the paper's
controller does not — it caps per priority class only). A phase-aware policy
down-clocks the *token phase only*: decode is memory-bound, so a frequency
cap reclaims ~f^gamma dynamic power for only ~CLOCK_SENSITIVE_FLOOR * df
latency. Prompt phases run uncapped, so TTFT is untouched.

``phase_aware_headroom`` quantifies the reclaimed average+peak power and the
resulting extra servers at iso-SLO — the §Perf 'beyond paper' row for the
power plane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from repro_torch.core.power_model import DevicePower, ServerPower
from repro_torch.core.workload import RequestTiming


@dataclass
class PhaseAwareOutcome:
    f_token: float
    avg_power_saving: float  # fraction of busy-server power saved
    peak_power_saving: float
    token_latency_impact: float
    ttft_impact: float  # always 0 by construction


def phase_aware_headroom(timing: RequestTiming, server: ServerPower,
                         mean_out_tokens: float, f_token: float) -> PhaseAwareOutcome:
    dev = server.device
    t_pre = timing.t_prefill
    t_tok_base = mean_out_tokens * timing.t_token
    t_tok_capped = t_tok_base * dev.perf_scale(timing.token_point.compute_frac, f_token)

    p_pre = timing.prefill_point.power_at(server, 1.0)
    p_tok = timing.token_point.power_at(server, 1.0)
    p_tok_capped = timing.token_point.power_at(server, f_token)

    e_base = p_pre * t_pre + p_tok * t_tok_base
    e_capped = p_pre * t_pre + p_tok_capped * t_tok_capped
    avg_base = e_base / (t_pre + t_tok_base)
    avg_capped = e_capped / (t_pre + t_tok_capped)

    return PhaseAwareOutcome(
        f_token=f_token,
        avg_power_saving=1.0 - avg_capped / avg_base,
        # row peak is set by overlapping token phases (prompt spikes are
        # uncorrelated); token-phase power drop moves the peak directly
        peak_power_saving=1.0 - p_tok_capped / p_tok,
        token_latency_impact=t_tok_capped / t_tok_base - 1.0,
        ttft_impact=0.0,
    )


def sweep(timing: RequestTiming, server: ServerPower, mean_out_tokens: float,
          freqs: List[float]) -> List[PhaseAwareOutcome]:
    return [phase_aware_headroom(timing, server, mean_out_tokens, f) for f in freqs]
