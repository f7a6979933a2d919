"""yi-34b [dense] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
Llama-arch GQA. [arXiv:2403.04652; hf]"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    pattern=(ATTN,),
    rope_theta=5_000_000.0,
    # 56 q heads cannot shard over the 16-way model axis; pad each GQA group
    # 7->8 query heads (zero wo rows -> exact outputs). See EXPERIMENTS §Perf H3.
    pad_heads_multiple=16,
)

SMOKE = CONFIG.replace(
    name="yi-34b-smoke",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=160, vocab_size=256,
)
