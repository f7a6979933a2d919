"""bloom-176b (paper Fig. 3, decoder, inference-only; the paper's worst-case
evaluation workload) — 70L d_model=14336 112H d_ff=57344 vocab=250880.
ALiBi approximated by RoPE (backbone flops/bytes are what the power model
consumes). [arXiv:2211.05100]"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="bloom-176b",
    family="dense",
    num_layers=70,
    d_model=14336,
    num_heads=112,
    num_kv_heads=112,
    head_dim=128,
    d_ff=57344,
    vocab_size=250880,
    pattern=(ATTN,),
    mlp_type="gelu",
)

SMOKE = CONFIG.replace(
    name="bloom-176b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
)
