"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]"""

from repro_torch.models.config import LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    pattern=(LOCAL,),  # SWA on every layer
    window_size=4096,
    moe_num_experts=8,
    moe_top_k=2,
    moe_d_ff=14336,
)

SMOKE = CONFIG.replace(
    name="mixtral-8x7b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, moe_d_ff=128, vocab_size=256, window_size=16,
    moe_num_experts=4, moe_top_k=2,
)
