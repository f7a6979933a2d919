"""roberta-large (paper Fig. 3, encoder) — 24L d_model=1024 16H d_ff=4096
vocab=50265. Bidirectional encoder; MLM-style loss; no decode step."""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="roberta-large",
    family="encoder",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=50265,
    pattern=(ATTN,),
    mlp_type="gelu",
)

SMOKE = CONFIG.replace(
    name="roberta-large-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
)
