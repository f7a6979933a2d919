"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2, Mamba+attention 1:7 interleave.
[arXiv:2403.19887; hf]

Structure: 9 scanned groups of 8 blocks; attention at group position 4 (as in
the Jamba paper), every block followed by an FFN, MoE on every other block.
Jamba proper uses Mamba-1 mixers; the reference uses the Mamba2/SSD mixer
(its chunked matmul form), and so does the port. No RoPE (Jamba relies on
the Mamba layers for position).

Parameters in bf16, optimizer Adafactor (as kimi-k2). One pattern group at
these widths is ~90 GB of bf16, more than one card holds: the port serves
its smoke config on the card (``chip_smoke.py`` phase (i)).
"""

import torch

from repro_torch.models.config import ATTN, MAMBA, ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
    ffn_every_block=True,
    use_rope=False,
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=24576,
    moe_layer_period=2,
    ssm_d_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    param_dtype=torch.bfloat16,
    optimizer="adafactor",
)

SMOKE = CONFIG.replace(
    name="jamba-1.5-smoke",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, moe_d_ff=128, vocab_size=256,
    moe_num_experts=4, moe_top_k=2,
    ssm_d_state=16, ssm_headdim=16, ssm_chunk=16,
)
