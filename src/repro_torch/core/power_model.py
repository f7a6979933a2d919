"""Device/server power model driven by roofline utilization (paper §2).

The paper measures GPU power with DCGM; this container has no power meter, so
POLCA's power plane is closed mechanistically instead (DESIGN.md §2): each
inference phase gets a (compute-util, membw-util) operating point from the
same analytic/compiled roofline terms the dry-run produces, and utilization
maps to watts via a DVFS model:

    P(u_c, u_m, f) = P_idle + (P_peak - P_idle) * (w_c*u_c + w_m*u_m) * (f/f_max)^gamma

with gamma ~ 2.4 (dynamic power ~ C f V^2, V tracking f near the top of the
DVFS range). This reproduces the paper's two central observations by
construction rather than by curve-fitting:

  * prompt (prefill) phases are compute-bound: u_c ~ 1 -> spiky power at or
    above TDP (P_peak = spike_frac * TDP > TDP, Fig. 4/5);
  * token (decode) phases are memory-bound: u_c << 1, u_m ~ 1 -> flat power
    around ~half of TDP (Fig. 4);
  * frequency capping is superlinear (Fig. 7): power drops ~ f^gamma while
    only the compute-bound fraction of the workload slows down ~ f.

Two device profiles ship, copied unchanged from ``repro.core.power_model``:
A100-80GB (to replicate the paper's published characterization and
production patterns) and TPU v5e. Both are inputs of the simulated power
plane, not measurements of the card this package runs on.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DevicePower:
    name: str
    peak_flops: float  # per chip, bf16
    hbm_bw: float  # bytes/s
    tdp_w: float
    idle_w: float
    spike_frac: float = 1.25  # instantaneous peak above TDP (paper Fig 11: up to +500W/8)
    gamma: float = 2.4  # DVFS exponent
    f_max: float = 1.0  # normalized frequency range
    f_base: float = 1275.0 / 1410.0  # A100: base/boost clock
    f_brake: float = 288.0 / 1410.0  # powerbrake clock
    # dynamic-power shares (calibrated so BLOOM prompt ~= 1.0-1.1 TDP and
    # token ~= 0.55 TDP as in paper Fig. 4; they may sum > 1 — the power-virus
    # point u_c = u_m = 1 hits p_peak = spike_frac * TDP)
    w_compute: float = 0.77
    w_memory: float = 0.32

    @property
    def p_peak(self) -> float:
        return self.tdp_w * self.spike_frac

    def power(self, u_compute: float, u_memory: float, f: float = 1.0) -> float:
        """Watts at (utilization, normalized frequency)."""
        u = min(1.0, self.w_compute * min(u_compute, 1.0)
                + self.w_memory * min(u_memory, 1.0))
        return self.idle_w + (self.p_peak - self.idle_w) * u * (f / self.f_max) ** self.gamma

    def perf_scale(self, compute_frac: float, f: float) -> float:
        """Relative execution-time multiplier at capped frequency.

        ``compute_frac``: fraction of (uncapped) step time that is
        compute-bound. Memory-bound time is frequency-insensitive until the
        slowed compute exceeds it; this max() is what makes the paper's
        power/perf trade superlinear.
        """
        f = max(f, 1e-3)
        return compute_frac / f + (1.0 - compute_frac)


# The paper's measurement platform: DGX A100-80GB.
A100 = DevicePower(
    name="a100-80g",
    peak_flops=312e12,
    hbm_bw=2039e9,
    tdp_w=400.0,
    idle_w=90.0,
)

# The JAX package's simulated deployment profile (same constants as
# repro.parallel.roofline).
TPU_V5E = DevicePower(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    tdp_w=220.0,
    idle_w=55.0,
    f_base=0.9,
    f_brake=0.2,
)

# A100 frequency levels used by POLCA's modes (Table 3), normalized to 1410 MHz.
FREQ_UNCAPPED = 1.0
FREQ_LP_T1 = 1275.0 / 1410.0  # 1275 MHz: A100 base clock
FREQ_LP_T2 = 1110.0 / 1410.0
FREQ_HP_T2 = 1305.0 / 1410.0
FREQ_BRAKE = 288.0 / 1410.0


@dataclass(frozen=True)
class ServerPower:
    """A GPU server: n_devices accelerators ~ 60% of server power (Fig 11)."""

    device: DevicePower
    n_devices: int = 8
    gpu_power_share: float = 0.6  # GPUs / total server power (consumed)

    @property
    def other_w(self) -> float:
        # non-GPU components, sized so GPUs at TDP are `gpu_power_share`
        return self.n_devices * self.device.tdp_w * (1 - self.gpu_power_share) / self.gpu_power_share

    @property
    def provisioned_w(self) -> float:
        """Per-server power rating: GPUs at TDP + the rest of the box.

        Instantaneous GPU spikes may exceed TDP (Fig. 11: up to +500 W per
        server), so row power can transiently exceed 100% of provisioned —
        that is exactly the excursion the powerbrake backstop exists for.
        """
        return self.n_devices * self.device.tdp_w + self.other_w

    def power(self, u_compute: float, u_memory: float, f: float = 1.0) -> float:
        return self.n_devices * self.device.power(u_compute, u_memory, f) + self.other_w

    @property
    def idle_power(self) -> float:
        return self.n_devices * self.device.idle_w + self.other_w
