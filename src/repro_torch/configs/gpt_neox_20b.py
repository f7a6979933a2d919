"""gpt-neox-20b (paper Fig. 3, decoder) — 44L d_model=6144 64H d_ff=24576
vocab=50432. [arXiv:2204.06745]"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gpt-neox-20b",
    family="dense",
    num_layers=44,
    d_model=6144,
    num_heads=64,
    num_kv_heads=64,
    head_dim=96,
    d_ff=24576,
    vocab_size=50432,
    pattern=(ATTN,),
    mlp_type="gelu",
)

SMOKE = CONFIG.replace(
    name="gpt-neox-20b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
)
