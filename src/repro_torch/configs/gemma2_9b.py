"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
Local+global alternating attention, logit softcaps, post-norms, GeGLU.
[arXiv:2408.00118; hf]"""

from repro_torch.models.config import ATTN, LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    pattern=(LOCAL, ATTN),  # alternating sliding-window / global
    window_size=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    use_post_norm=True,
    mlp_type="geglu",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="gemma2-9b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, window_size=16,
)
