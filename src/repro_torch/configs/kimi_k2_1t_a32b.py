"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 (+1 shared expert), ~1T total params.
Paper-table config. [arXiv:2501.kimi2; unverified]

Its parameters are stored in bf16 (and its optimizer is factored Adafactor,
as in the reference, whose training path reads it). On one card the port
serves 1 of its 61 layers at the published widths (``chip_smoke.py`` phase
(i)).
"""

import torch

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    pattern=(ATTN,),
    moe_num_experts=384,
    moe_top_k=8,
    moe_d_ff=2048,
    moe_shared_expert_ff=2048,
    param_dtype=torch.bfloat16,
    optimizer="adafactor",
)

SMOKE = CONFIG.replace(
    name="kimi-k2-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=32, moe_d_ff=32, moe_shared_expert_ff=32, vocab_size=256,
    moe_num_experts=8, moe_top_k=2,
)
