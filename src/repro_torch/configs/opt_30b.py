"""opt-30b (paper Fig. 3, decoder, inference-only) — 48L d_model=7168 56H
d_ff=28672 vocab=50272. [arXiv:2205.01068]"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="opt-30b",
    family="dense",
    num_layers=48,
    d_model=7168,
    num_heads=56,
    num_kv_heads=56,
    head_dim=128,
    d_ff=28672,
    vocab_size=50272,
    pattern=(ATTN,),
    mlp_type="gelu",
)

SMOKE = CONFIG.replace(
    name="opt-30b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
)
