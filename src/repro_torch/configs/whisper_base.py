"""whisper-base [audio] — 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865.
Encoder-decoder; the conv audio frontend is a STUB: the batch's ``enc_embeds``
are precomputed frame embeddings for the encoder. [arXiv:2212.04356; unverified]

Backbone approximations (noted per assignment: backbone only): GELU MLP as in
Whisper; RoPE in place of learned absolute positions; RMSNorm in place of
LayerNorm.
"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    train_strategy="fsdp",  # H1: small models are TP-collective-bound on 256 chips
    name="whisper-base",
    family="audio",
    num_layers=6,
    num_encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    pattern=(ATTN,),
    mlp_type="gelu",
    frontend="audio_stub",
    encoder_seq_frac=0.5,
    max_encoder_len=1500,
)

SMOKE = CONFIG.replace(
    name="whisper-base-smoke",
    num_layers=2, num_encoder_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
)
