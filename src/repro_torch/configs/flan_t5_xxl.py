"""flan-t5-xxl (paper Fig. 3, encoder-decoder) — 24+24L d_model=4096 64H
head_dim=64 d_ff=10240 vocab=32128, gated-GELU. [arXiv:2210.11416]"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="flan-t5-xxl",
    family="encdec",
    num_layers=24,
    num_encoder_layers=24,
    d_model=4096,
    num_heads=64,
    num_kv_heads=64,
    head_dim=64,
    d_ff=10240,
    vocab_size=32128,
    pattern=(ATTN,),
    mlp_type="geglu",
    frontend="none",
    encoder_seq_frac=0.5,
)

SMOKE = CONFIG.replace(
    name="flan-t5-xxl-smoke",
    num_layers=2, num_encoder_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
)
