"""Exact analytic FLOP counts + HBM-traffic lower bounds per (arch x shape).

A copy of ``repro.parallel.analytic``: the linear algebra of every block is
counted in closed form from the ``ModelConfig``. ``core.workload`` turns
``step_cost`` into prefill/decode phase timings and power operating points,
which is all the power plane of the tick engine needs from the model.

All counts are GLOBAL; divide by n_devices for per-chip terms.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import LOCAL, MAMBA, ModelConfig, ShapeConfig


def _dtype_bytes(dt: torch.dtype) -> int:
    return dt.itemsize


def _causal_ctx_total(S: int, window: int) -> float:
    """Sum over query positions of attended context length."""
    if not window or window >= S:
        return S * (S + 1) / 2.0
    # positions < window attend i+1; the rest attend `window`
    w = window
    return w * (w + 1) / 2.0 + (S - w) * w


@dataclass
class StepCost:
    flops: float  # global FLOPs for one step
    hbm_bytes: float  # global HBM traffic lower bound (Pallas/fused-attn path)
    # extra traffic when attention scores materialize in HBM (the XLA einsum
    # path); the dry-run adds this unless cfg.use_pallas — reporting both makes
    # the flash-kernel win visible in §Roofline
    attn_score_bytes: float

    def per_device(self, n: int) -> "StepCost":
        return StepCost(self.flops / n, self.hbm_bytes / n, self.attn_score_bytes / n)


def _attn_flops(cfg: ModelConfig, T_tok: float, ctx_total: float, B: float) -> float:
    """One attention block: projections + scores + AV."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    proj = 2 * T_tok * D * (2 * H * hd + 2 * KV * hd)  # q,o + k,v
    core = 4 * B * ctx_total * H * hd  # QK^T + PV (2 matmuls x 2 flops)
    return proj + core


def _ssd_flops(cfg: ModelConfig, T_tok: float) -> float:
    D = cfg.d_model
    d_in = cfg.ssm_expand * D
    Hs = d_in // cfg.ssm_headdim
    G, N, P = cfg.ssm_n_groups, cfg.ssm_d_state, cfg.ssm_headdim
    Q = cfg.ssm_chunk
    proj = 2 * T_tok * D * (2 * d_in + 2 * G * N + Hs) + 2 * T_tok * d_in * D
    conv = 2 * T_tok * cfg.ssm_conv_width * (d_in + 2 * G * N)
    core = 2 * T_tok * (Q * G * N + Q * Hs * P + 2 * Hs * N * P)
    return proj + conv + core


def _ssd_decode_flops(cfg: ModelConfig, B: float) -> float:
    D = cfg.d_model
    d_in = cfg.ssm_expand * D
    Hs = d_in // cfg.ssm_headdim
    G, N, P = cfg.ssm_n_groups, cfg.ssm_d_state, cfg.ssm_headdim
    proj = 2 * B * D * (2 * d_in + 2 * G * N + Hs) + 2 * B * d_in * D
    core = 2 * B * 2 * Hs * N * P
    return proj + core


def _mlp_flops(cfg: ModelConfig, T_tok: float, d_ff: int) -> float:
    n_mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    return 2 * T_tok * cfg.d_model * d_ff * n_mats


def _moe_flops(cfg: ModelConfig, T_tok: float) -> float:
    n_mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    routed = 2 * T_tok * cfg.moe_top_k * cfg.moe_capacity_factor * \
        cfg.d_model * cfg.moe_d_ff * n_mats
    router = 2 * T_tok * cfg.d_model * cfg.moe_num_experts
    shared = _mlp_flops(cfg, T_tok, cfg.moe_shared_expert_ff) if cfg.moe_shared_expert_ff else 0
    return routed + router + shared


def _block_is_moe(cfg: ModelConfig, i: int, kind: str) -> bool:
    has_ffn = kind != MAMBA or cfg.ffn_every_block
    if not cfg.moe_num_experts or not has_ffn:
        return False
    return cfg.moe_layer_period == 1 or i % cfg.moe_layer_period == cfg.moe_layer_period - 1


def forward_flops(cfg: ModelConfig, B: int, S: int, enc_S: int, *,
                  decode: bool = False, cache_len: int = 0) -> float:
    """One forward pass (prefill/train fwd if not decode; one token if decode)."""
    T = float(B) * (1 if decode else S)
    total = 0.0
    # decoder blocks
    for i, kind in enumerate(cfg.pattern):
        if kind == MAMBA:
            total += _ssd_decode_flops(cfg, B) if decode else _ssd_flops(cfg, T)
        else:
            window = cfg.window_size if kind == LOCAL else 0
            if decode:
                ctx = min(cache_len, window) if window else cache_len
                ctx_total = float(ctx)  # per query token
            else:
                ctx_total = _causal_ctx_total(S, window)
            total += _attn_flops(cfg, T, ctx_total, B)
            if cfg.is_encoder_decoder:
                # cross attention: q/o projections + scores over enc_S
                D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
                total += 2 * T * D * 2 * H * hd + 4 * B * (1 if decode else S) * enc_S * H * hd
                if not decode:  # cross kv projected at prefill/train
                    total += 2 * (B * enc_S) * D * 2 * KV * hd
        if kind != MAMBA or cfg.ffn_every_block:
            if _block_is_moe(cfg, i, kind):
                total += _moe_flops(cfg, T)
            else:
                total += _mlp_flops(cfg, T, cfg.d_ff)
    total *= cfg.num_groups
    # encoder (not re-run at decode)
    if cfg.is_encoder_decoder and not decode:
        T_e = float(B) * enc_S
        enc = _attn_flops(cfg, T_e, enc_S * enc_S, B) + _mlp_flops(cfg, T_e, cfg.d_ff)
        total += enc * cfg.num_encoder_layers
    # unembed
    total += 2 * T * cfg.d_model * cfg.vocab_size
    return total


REMAT_FACTOR = {"none": 3.0, "dots": 10.0 / 3.0, "full": 4.0}


def step_cost(cfg: ModelConfig, shape: ShapeConfig, enc_S: int, dec_S: int) -> StepCost:
    """Global analytic cost for the cell's step."""
    B = shape.global_batch
    act = _dtype_bytes(cfg.dtype)
    wb = _dtype_bytes(cfg.param_dtype)
    n_params = cfg.total_params()
    n_active = cfg.active_params()

    # --- attention-score HBM traffic for the XLA (non-Pallas) path ---------
    def score_bytes(S, fwd_only):
        b = 0.0
        for i, kind in enumerate(cfg.pattern):
            if kind == MAMBA:
                continue
            window = cfg.window_size if kind == LOCAL else 0
            ctx = _causal_ctx_total(S, window)
            # fp32 scores written+read once (fused softmax), fwd (+1 recompute in bwd)
            b += B * ctx * cfg.num_heads * 4 * 2 * (1 if fwd_only else 2)
        return b * cfg.num_groups

    if shape.kind == "train":
        fl = forward_flops(cfg, B, dec_S, enc_S) * REMAT_FACTOR[cfg.remat_policy]
        # params 2x read + 1 write (fwd+bwd read, update write), grads r/w,
        # optimizer state r/w, saved layer-boundary activations w+r
        opt_bytes = n_params * (8 if cfg.optimizer == "adamw" else 2)
        act_saved = B * dec_S * cfg.d_model * act * cfg.num_layers
        hbm = (3 * n_params * wb + 2 * n_params * 4 + 2 * opt_bytes
               + 2 * act_saved)
        return StepCost(fl, hbm, score_bytes(dec_S, fwd_only=False))

    if shape.kind == "prefill":
        fl = forward_flops(cfg, B, dec_S, enc_S)
        kv_write = 2 * B * dec_S * cfg.num_kv_heads * cfg.head_dim * act * \
            sum(1 for k in cfg.pattern if k != MAMBA) * cfg.num_groups
        hbm = n_active * wb + B * dec_S * cfg.d_model * act * cfg.num_layers * 2 \
            + kv_write
        return StepCost(fl, hbm, score_bytes(dec_S, fwd_only=True))

    # decode: one token against a cache of dec_S
    fl = forward_flops(cfg, B, dec_S, enc_S, decode=True, cache_len=dec_S)
    # weights: dense-active read once; MoE: experts actually touched
    if cfg.moe_num_experts:
        moe_blocks = sum(1 for i, k in enumerate(cfg.pattern) if _block_is_moe(cfg, i, k))
        moe_blocks *= cfg.num_groups
        n_mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
        per_expert = n_mats * cfg.d_model * cfg.moe_d_ff
        touched = min(cfg.moe_num_experts, B * cfg.moe_top_k)
        w_bytes = (n_active - moe_blocks * cfg.moe_top_k * per_expert) * wb \
            + moe_blocks * touched * per_expert * wb
    else:
        w_bytes = n_active * wb
    # KV cache read (+ tiny new-token write)
    kv = 0.0
    for i, kind in enumerate(cfg.pattern):
        if kind == MAMBA:
            d_in = cfg.ssm_expand * cfg.d_model
            Hs = d_in // cfg.ssm_headdim
            kv += B * Hs * cfg.ssm_d_state * cfg.ssm_headdim * 4 * 2  # state r+w
        else:
            window = cfg.window_size if kind == LOCAL else 0
            ctx = min(dec_S, window) if window else dec_S
            kv += B * ctx * 2 * cfg.num_kv_heads * cfg.head_dim * act
            if cfg.is_encoder_decoder:
                kv += B * enc_S * 2 * cfg.num_kv_heads * cfg.head_dim * act
    kv *= cfg.num_groups
    hbm = w_bytes + kv
    return StepCost(fl, hbm, 0.0)
