"""Per-(model, request-config, frequency) performance/power characterization.

Bridges the model zoo to the power plane: ``analytic.step_cost`` supplies the
exact FLOPs/bytes of prefill and per-token decode for any ``ModelConfig``;
this module turns them into phase timings (roofline with an achievable-
efficiency derate), per-phase power operating points, and request latencies —
the quantities the paper measures in Figures 4-7 and feeds its simulator.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.core.power_model import DevicePower, ServerPower
from repro_torch.parallel import analytic


# achievable fraction of peak (kernel efficiency; typical well-tuned serving)
COMPUTE_EFF = 0.55
MEMBW_EFF = 0.75
# fixed per-step launch/sync overhead (s): bounds decode rate at tiny batches
STEP_OVERHEAD = 0.004
# fraction of even a memory-bound step that scales with clock (launch overhead,
# softmax/pointwise work, small gemms). Calibrated so BLOOM shows ~5% perf loss
# at ~13% peak-power reduction (paper Fig. 7).
CLOCK_SENSITIVE_FLOOR = 0.30


@dataclass(frozen=True)
class PhasePoint:
    """One phase's roofline operating point on a server."""
    t_seconds: float  # duration at f=1
    u_compute: float
    u_memory: float
    compute_frac: float  # fraction of time compute-bound (for perf_scale)

    def time_at(self, dev: DevicePower, f: float) -> float:
        return self.t_seconds * dev.perf_scale(self.compute_frac, f)

    def power_at(self, server: ServerPower, f: float) -> float:
        # utilization of the *limiting* resource stays ~1 under capping;
        # the non-limiting one rises as compute slows
        return server.power(self.u_compute, self.u_memory, f)


def _phase_point(flops: float, bytes_: float, server: ServerPower) -> PhasePoint:
    dev = server.device
    n = server.n_devices
    t_c = flops / n / (dev.peak_flops * COMPUTE_EFF)
    t_m = bytes_ / n / (dev.hbm_bw * MEMBW_EFF)
    t = max(t_c, t_m) + STEP_OVERHEAD
    return PhasePoint(
        t_seconds=t,
        # even fully compute-bound phases sit slightly below the power-virus
        # point; 0.95 reproduces the paper's 'at-or-just-above TDP' spikes
        u_compute=min(1.0, t_c / t) * 0.95,
        u_memory=min(1.0, t_m / t),
        compute_frac=max(CLOCK_SENSITIVE_FLOOR, min(1.0, t_c / t)),
    )


@lru_cache(maxsize=4096)
def characterize(cfg: ModelConfig, prompt: int, batch: int,
                 server: ServerPower) -> Tuple[PhasePoint, PhasePoint]:
    """(prefill phase, per-token decode phase) for one request batch."""
    # pad the KV/context length decode works against to prompt size (output
    # grows it further; we use prompt + half a typical output as the operating
    # context — the sensitivity is small because decode is weight-bound)
    prefill_shape = ShapeConfig("wl_prefill", max(prompt, 16), batch, "prefill")
    decode_shape = ShapeConfig("wl_decode", max(prompt, 16), batch, "decode")
    enc_S, dec_S = (0, prefill_shape.seq_len)
    if cfg.is_encoder_decoder:
        enc_S = int(prefill_shape.seq_len * cfg.encoder_seq_frac)
        if cfg.max_encoder_len:
            enc_S = min(enc_S, cfg.max_encoder_len)
        dec_S = prefill_shape.seq_len - enc_S
    pre = analytic.step_cost(cfg, prefill_shape, enc_S, dec_S)
    dec = analytic.step_cost(cfg, decode_shape, enc_S, dec_S)
    return (_phase_point(pre.flops, pre.hbm_bytes + pre.attn_score_bytes, server),
            _phase_point(dec.flops, dec.hbm_bytes, server))


@dataclass(frozen=True)
class RequestTiming:
    t_prefill: float  # seconds at f=1
    t_token: float  # per output token at f=1
    prefill_point: PhasePoint
    token_point: PhasePoint

    def latency(self, out_tokens: int, dev: DevicePower, f_prefill: float = 1.0,
                f_token: float = 1.0) -> float:
        return (self.prefill_point.time_at(dev, f_prefill)
                + out_tokens * self.token_point.time_at(dev, f_token))


def request_timing(cfg: ModelConfig, prompt: int, batch: int,
                   server: ServerPower) -> RequestTiming:
    pre, tok = characterize(cfg, prompt, batch, server)
    return RequestTiming(pre.t_seconds, tok.t_seconds, pre, tok)


# ---------------------------------------------------------------------------
# Training phases (paper §2.4): compute burst / communication trough
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainProfile:
    """One training iteration as (compute phase, sync trough) — the paper's
    power-swing structure. ``trough_util``: GPU compute utilization during the
    gradient-sync bubble (RoBERTa ~high, Flan-T5 ~idle; Fig. 8)."""
    t_iter: float
    compute_point: PhasePoint
    trough_frac: float  # fraction of the iteration spent in the trough
    trough_util: float

    def phases(self):
        return [(self.t_iter * (1 - self.trough_frac), self.compute_point),
                (self.t_iter * self.trough_frac, None)]


def train_profile(cfg: ModelConfig, batch: int, seq: int, server: ServerPower,
                  trough_frac: float = 0.15, trough_util: float = 0.2) -> TrainProfile:
    shape = ShapeConfig("wl_train", seq, batch, "train")
    enc_S, dec_S = 0, seq
    if cfg.is_encoder_decoder:
        enc_S = min(int(seq * cfg.encoder_seq_frac), cfg.max_encoder_len or seq)
        dec_S = seq - enc_S
    c = analytic.step_cost(cfg, shape, enc_S, dec_S)
    pt = _phase_point(c.flops, c.hbm_bytes + c.attn_score_bytes, server)
    return TrainProfile(t_iter=pt.t_seconds / (1 - trough_frac),
                        compute_point=pt, trough_frac=trough_frac,
                        trough_util=trough_util)
