"""POLCA power-management policy (paper Algorithm 1 + Table 3) and baselines.

The controller consumes *delayed* row-power telemetry and emits frequency-cap
commands that take effect after the out-of-band latency (Table 1). It is a
pure state machine: the simulator (or a real rack manager) owns time.

Policies implement the structured protocol ``observe(Telemetry)`` (see
``core.telemetry``); the legacy ``step(p: float)`` survives as a shim that
wraps the bare row-power fraction, so old traces replay bit-identically.

Power modes (Table 3, A100 MHz normalized to 1410):
  | mode        | low priority        | high priority       |
  | uncapped    | uncapped            | uncapped            |
  | T1          | 1275 MHz            | uncapped            |
  | T2          | 1110 MHz            | 1305 MHz            |
  | powerbrake  | 288 MHz             | 288 MHz             |
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional

from repro_torch.core.power_model import (
    FREQ_BRAKE,
    FREQ_HP_T2,
    FREQ_LP_T1,
    FREQ_LP_T2,
    FREQ_UNCAPPED,
)
from repro_torch.core.telemetry import Telemetry, TelemetryPolicy


@dataclass(frozen=True)
class CapCommand:
    """Set (lp_freq, hp_freq) across the row; None = leave unchanged."""
    lp_freq: Optional[float] = None
    hp_freq: Optional[float] = None
    brake: bool = False
    reason: str = ""


@dataclass
class PolcaPolicy(TelemetryPolicy):
    """Dual-threshold, priority-aware frequency capping with hysteresis."""

    t1: float = 0.80  # thresholds as fractions of provisioned row power
    t2: float = 0.89
    t1_buffer: float = 0.05  # uncap hysteresis (§5.1: 5% below threshold)
    t2_buffer: float = 0.05
    lp_freq_t1: float = FREQ_LP_T1
    lp_freq_t2: float = FREQ_LP_T2
    hp_freq_t2: float = FREQ_HP_T2
    brake_freq: float = FREQ_BRAKE
    # HP escalation waits for the LP T2 cap to actuate through the slow OOB
    # path (40 s) and verifiably fail before touching HP (Algorithm 1's
    # "subsequently if needed"); 25 ticks x 2 s > 40 s + settling.
    escalation_ticks: int = 25

    # state
    t1_capped: bool = False
    t2_capped: bool = False
    hp_capped: bool = False
    braked: bool = False
    n_brakes: int = 0
    _t2_since: int = 0

    name: str = "polca"

    def observe(self, tel: Telemetry) -> List[CapCommand]:
        """One telemetry sample. Algorithm 1 over ``tel.power_frac``."""
        p = tel.power_frac
        cmds: List[CapCommand] = []
        if p > 1.0:
            if not self.braked:
                self.braked = True
                self.n_brakes += 1
                cmds.append(CapCommand(self.brake_freq, self.brake_freq, brake=True,
                                       reason="powerbrake"))
            self.t1_capped = True
            self.t2_capped = True
            self.hp_capped = True
            return cmds
        if self.braked:
            # leaving brake: fall back to the T2 mode caps
            self.braked = False
            cmds.append(CapCommand(self.lp_freq_t2, self.hp_freq_t2,
                                   reason="brake-release->T2"))
        if p > self.t2:
            if not self.t2_capped:
                self.t2_capped = True
                self.t1_capped = True
                self._t2_since = 0
                cmds.append(CapCommand(lp_freq=self.lp_freq_t2, reason="T2: cap LP"))
            elif not self.hp_capped:
                self._t2_since += 1
                if self._t2_since >= self.escalation_ticks:
                    # LP capping verifiably insufficient: cap HP (Algorithm 1)
                    self.hp_capped = True
                    cmds.append(CapCommand(hp_freq=self.hp_freq_t2, reason="T2: cap HP"))
        elif p > self.t1:
            if not self.t1_capped:
                self.t1_capped = True
                cmds.append(CapCommand(lp_freq=self.lp_freq_t1, reason="T1: cap LP"))
        # uncap with hysteresis
        if self.t2_capped and p < self.t2 - self.t2_buffer:
            self.t2_capped = False
            self.hp_capped = False
            cmds.append(CapCommand(lp_freq=self.lp_freq_t1, hp_freq=FREQ_UNCAPPED,
                                   reason="T2 release -> T1 caps"))
        if self.t1_capped and not self.t2_capped and p < self.t1 - self.t1_buffer:
            self.t1_capped = False
            cmds.append(CapCommand(lp_freq=FREQ_UNCAPPED, reason="T1 release"))
        return cmds


@dataclass
class PredictivePolcaPolicy(PolcaPolicy):
    """Telemetry-enabled POLCA variant (beyond paper, enabled by the richer
    protocol):

    * **predictive capping** — least-squares slope over the last ``window``
      samples extrapolates row power ``horizon_s`` ahead (default = the 40 s
      out-of-band actuation latency, Table 1) and caps on the *predicted*
      crossing, so caps land when the threshold is actually reached instead
      of 40 s late;
    * **informed escalation** — the per-priority power split tells the
      controller when LP capping *cannot* shed enough power (LP share smaller
      than the excess over T2), so it escalates to the HP cap immediately
      instead of waiting ``escalation_ticks`` for the LP cap to verifiably
      fail.

    The powerbrake path is never predicted: brakes fire on measured overload
    only, so ``n_brakes`` keeps its physical meaning.
    """

    horizon_s: float = 40.0
    window: int = 8
    name: str = "polca-predictive"
    _hist_t: List[float] = field(default_factory=list)
    _hist_p: List[float] = field(default_factory=list)

    def _predict(self, t: float, p: float) -> float:
        self._hist_t.append(t)
        self._hist_p.append(p)
        if len(self._hist_t) > self.window:
            del self._hist_t[0]
            del self._hist_p[0]
        if len(self._hist_t) < 3:
            return p
        tm = sum(self._hist_t) / len(self._hist_t)
        pm = sum(self._hist_p) / len(self._hist_p)
        num = sum((ti - tm) * (pi - pm) for ti, pi in zip(self._hist_t, self._hist_p))
        den = sum((ti - tm) ** 2 for ti in self._hist_t)
        if den <= 0.0:
            return p
        slope = num / den
        return max(p, p + slope * self.horizon_s)

    def observe(self, tel: Telemetry) -> List[CapCommand]:
        p = tel.power_frac
        p_eff = self._predict(tel.t, p)
        if p <= 1.0:
            # prediction may cap early but must never fake a powerbrake
            p_eff = min(p_eff, 1.0 - 1e-9)
        if (tel.lp_power_frac is not None and self.t2_capped and not self.hp_capped
                and p > self.t2 and tel.lp_power_frac < p - self.t2):
            # even shutting LP off entirely cannot bring the row below T2:
            # skip the wait-and-verify loop and cap HP on the next decision
            self._t2_since = self.escalation_ticks
        return super().observe(replace(tel, power_frac=p_eff))


@dataclass
class OneThreshold(TelemetryPolicy):
    """Baselines: single threshold at ``t`` (Fig. 17): cap LP only or all."""

    t: float = 0.89
    buffer: float = 0.05
    cap_hp: bool = False  # False: 1-Thresh-Low-Pri; True: 1-Thresh-All
    freq: float = FREQ_LP_T2
    brake_freq: float = FREQ_BRAKE

    capped: bool = False
    braked: bool = False
    n_brakes: int = 0

    @property
    def name(self) -> str:
        return "1-thresh-all" if self.cap_hp else "1-thresh-low-pri"

    def observe(self, tel: Telemetry) -> List[CapCommand]:
        p = tel.power_frac
        cmds: List[CapCommand] = []
        if p > 1.0:
            if not self.braked:
                self.braked = True
                self.n_brakes += 1
                cmds.append(CapCommand(self.brake_freq, self.brake_freq, brake=True,
                                       reason="powerbrake"))
            self.capped = True
            return cmds
        if self.braked:
            self.braked = False
            cmds.append(CapCommand(self.freq, self.freq if self.cap_hp else FREQ_UNCAPPED,
                                   reason="brake-release"))
        if p > self.t and not self.capped:
            self.capped = True
            cmds.append(CapCommand(self.freq, self.freq if self.cap_hp else None,
                                   reason="threshold cap"))
        elif self.capped and p < self.t - self.buffer:
            self.capped = False
            cmds.append(CapCommand(FREQ_UNCAPPED, FREQ_UNCAPPED, reason="release"))
        return cmds


@dataclass
class NoCap(TelemetryPolicy):
    """No-cap baseline (with the hardware powerbrake as the only backstop)."""

    brake_freq: float = FREQ_BRAKE
    braked: bool = False
    n_brakes: int = 0
    name: str = "no-cap"

    def observe(self, tel: Telemetry) -> List[CapCommand]:
        p = tel.power_frac
        if p > 1.0:
            if not self.braked:
                self.braked = True
                self.n_brakes += 1
                return [CapCommand(self.brake_freq, self.brake_freq, brake=True,
                                   reason="powerbrake")]
            return []
        if self.braked:
            self.braked = False
            return [CapCommand(FREQ_UNCAPPED, FREQ_UNCAPPED, reason="brake-release")]
        return []
