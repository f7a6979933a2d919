"""mamba2-370m [ssm] — 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128. SSD (state-space duality). [arXiv:2405.21060; unverified]"""

from repro_torch.models.config import MAMBA, ModelConfig

CONFIG = ModelConfig(
    train_strategy="fsdp",  # the reference's training strategy for it
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=16,  # unused (attention-free); placeholder for generic plumbing
    num_kv_heads=16,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    pattern=(MAMBA,),
    ssm_d_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="mamba2-370m-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    vocab_size=256, ssm_d_state=16, ssm_headdim=16, ssm_chunk=16,
)
