"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B; unverified]"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    train_strategy="fsdp",  # H1: small models are TP-collective-bound on 256 chips
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    pattern=(ATTN,),
    rope_theta=500_000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="llama3.2-1b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
)
