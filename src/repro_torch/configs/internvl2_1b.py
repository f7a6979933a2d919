"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
InternViT + InternLM2/Qwen2 backbone; the ViT frontend is a STUB:
the batch's ``image_embeds`` are precomputed patch embeddings. [arXiv:2404.16821; hf]"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    train_strategy="fsdp",  # H1: small models are TP-collective-bound on 256 chips
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    pattern=(ATTN,),
    tie_embeddings=True,
    frontend="vision_stub",
    num_image_embeds=256,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.replace(
    name="internvl2-1b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, num_image_embeds=8,
)
