"""Model/architecture configuration (PyTorch port of ``repro.models.config``).

Every architecture is an instance of ``ModelConfig``. Three parts of the
port read it: the power plane (``parallel.analytic.step_cost`` turns a
config into the FLOPs/bytes behind ``core.workload``'s phase timings), the
model stack (``models.model`` builds parameters, caches and the forward
passes from it) and the dry run (``launch.dryrun``), which walks the shape
table below: every ``ShapeConfig`` of :data:`ALL_SHAPES` that
:func:`shape_applicable` admits for an architecture. The dtype fields are
``torch.dtype`` values.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

# Block kinds that may appear in a layer pattern.
ATTN = "attn"  # self attention (causal unless encoder), optionally sliding window
LOCAL = "local"  # sliding-window self attention
MAMBA = "mamba"  # Mamba2 SSD block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio | encoder
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- block pattern -----------------------------------------------------
    # The decoder is ``num_layers`` deep; it is built as
    # ``num_layers // len(pattern)`` scanned groups, each executing ``pattern``.
    pattern: Tuple[str, ...] = (ATTN,)
    window_size: int = 0  # sliding window for LOCAL blocks

    # --- attention variants -------------------------------------------------
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    use_rope: bool = True
    rope_theta: float = 10_000.0
    use_post_norm: bool = False  # gemma2-style post-sublayer norms

    # --- MLP ------------------------------------------------------------------
    mlp_type: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    # jamba-style: every block (incl. mamba) is followed by an FFN/MoE sublayer;
    # otherwise only attention blocks carry an FFN and mamba blocks stand alone.
    ffn_every_block: bool = False

    # --- MoE ------------------------------------------------------------------
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # expert hidden dim (defaults to d_ff)
    moe_shared_expert_ff: int = 0  # shared (always-on) expert hidden dim
    moe_layer_period: int = 1  # every n-th block in the pattern is MoE
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01

    # --- SSM (Mamba2 / SSD) ---------------------------------------------------
    ssm_d_state: int = 128
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_n_groups: int = 1

    # --- encoder-decoder --------------------------------------------------------
    num_encoder_layers: int = 0  # >0 -> encoder-decoder model
    # fraction of a shape's seq_len given to the encoder (rest to decoder)
    encoder_seq_frac: float = 0.5
    # cap on encoder context (whisper: 1500 audio frames = 30 s); 0 = no cap
    max_encoder_len: int = 0

    # --- modality frontends (STUBS: input_specs provide embeddings) -----------
    frontend: str = "none"  # none | audio_stub | vision_stub
    num_image_embeds: int = 0  # VLM: patch embeddings prepended to the text

    # --- numerics ---------------------------------------------------------------
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16  # activation/compute dtype
    param_dtype: torch.dtype = torch.float32  # parameter storage dtype
    logits_fp32: bool = True

    # training parallelism strategy: "tp_fsdp" (TP over model + FSDP over data)
    # or "fsdp" (pure FSDP/ZeRO-3 over ALL axes — wins for small dense models
    # where TP collectives dominate; see EXPERIMENTS.md §Perf)
    train_strategy: str = "tp_fsdp"

    # --- runtime / perf knobs ---------------------------------------------------
    # "full" by default: saving per-matmul outputs ("dots") costs ~3.7 GB/layer
    # per device at train_4k scale and blows HBM (measured in EXPERIMENTS.md §Perf)
    remat_policy: str = "full"  # none | dots | full
    optimizer: str = "adamw"  # adamw | adafactor
    use_pallas: bool = False  # Pallas kernels (TPU target); XLA path otherwise
    # Unroll the layer-group scans (dry-run only): XLA's cost analysis counts
    # while-loop bodies once, so rooflines must be measured unrolled.
    unroll_layers: bool = False
    # decode KV-cache sequence sharding over the model axis (flash-decoding style)
    decode_seq_shard: bool = True
    # optimization barrier on the residual stream at block boundaries (see
    # model._group_forward): keeps TP activation collectives in bf16
    grad_barrier: int = 0

    # pad attention q/o heads up to a multiple (0 = off): yi-34b's 56 heads
    # cannot shard over a 16-way axis; padding to 64 shards cleanly and the
    # padded wo rows are zero-initialized so outputs are exact. Padding is
    # per-KV-group (each group grows 7->8 query heads for yi) so the GQA
    # head->kv mapping of the real checkpoint is preserved. GQA only: do not
    # enable for MHA archs (KV==H) — the kv grouping would shift.
    pad_heads_multiple: int = 0

    @property
    def padded_heads(self) -> int:
        if not self.pad_heads_multiple:
            return self.num_heads
        m = self.pad_heads_multiple
        return -(-self.num_heads // m) * m

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.moe_num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        assert self.num_layers % len(self.pattern) == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern length {len(self.pattern)}"
        )

    # ------------------------------------------------------------------------
    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.num_encoder_layers > 0

    @property
    def is_encoder_only(self) -> bool:
        return self.family == "encoder"

    @property
    def attention_free(self) -> bool:
        return all(k == MAMBA for k in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True when decode-time context cost is bounded (SSM/SWA-only/hybrid-light)."""
        kinds = set(self.pattern)
        if kinds == {MAMBA}:
            return True
        if ATTN not in kinds:  # only LOCAL (+ MAMBA)
            return True
        # hybrid: bounded number of global-attention layers per group is still
        # linear in context, but the *memory* is dominated by a handful of
        # layers; we follow the assignment and run hybrids.
        return MAMBA in kinds

    @property
    def activation_dtype(self) -> torch.dtype:
        return self.dtype

    @property
    def weight_dtype(self) -> torch.dtype:
        return self.param_dtype

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # --- analytic parameter counts (for roofline MODEL_FLOPS) -----------------
    def param_counts(self) -> dict:
        D, H, KV, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D  # q,k,v,o
        if self.qk_norm:
            attn += 2 * hd
        mlp_dense = (3 if self.mlp_type in ("swiglu", "geglu") else 2) * D * self.d_ff
        n_mats = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        counts = {"embed": self.vocab_size * D}
        if not self.tie_embeddings and not self.is_encoder_only:
            counts["unembed"] = self.vocab_size * D
        # Per-pattern accounting. Attention blocks always carry an FFN/MoE slot;
        # mamba blocks do so only when ffn_every_block (jamba-style).
        per_group = 0.0
        for i, kind in enumerate(self.pattern):
            if kind == MAMBA:
                d_in = self.ssm_expand * D
                nheads = d_in // self.ssm_headdim
                per_group += D * (2 * d_in + 2 * self.ssm_n_groups * self.ssm_d_state + nheads)
                per_group += d_in * D  # out proj
                per_group += (self.ssm_conv_width) * (d_in + 2 * self.ssm_n_groups * self.ssm_d_state)
                per_group += 2 * nheads + d_in  # A, D, dt_bias (+ gate norm)
            else:
                per_group += attn
            if kind != MAMBA or self.ffn_every_block:
                moe_here = self.moe_num_experts and (
                    self.moe_layer_period == 1
                    or i % self.moe_layer_period == self.moe_layer_period - 1
                )
                if moe_here:
                    per_group += self.moe_num_experts * n_mats * D * self.moe_d_ff
                    per_group += D * self.moe_num_experts  # router
                    if self.moe_shared_expert_ff:
                        per_group += n_mats * D * self.moe_shared_expert_ff
                else:
                    per_group += mlp_dense
        counts["blocks"] = per_group * self.num_groups
        if self.is_encoder_decoder:
            # encoder layers: attn + dense mlp; decoder cross-attn extra
            enc = (attn + mlp_dense) * self.num_encoder_layers
            cross = attn * self.num_layers
            counts["encoder"] = enc
            counts["cross_attn"] = cross
        return counts

    def total_params(self) -> float:
        return float(sum(self.param_counts().values()))

    def active_params(self) -> float:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if not self.moe_num_experts:
            return self.total_params()
        n_mats = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        total = self.total_params()
        # subtract non-active expert weight
        moe_blocks = 0
        for i, kind in enumerate(self.pattern):
            if kind == MAMBA and not self.ffn_every_block:
                continue
            if self.moe_layer_period == 1 or (i % self.moe_layer_period == self.moe_layer_period - 1):
                moe_blocks += 1
        moe_blocks *= self.num_groups
        all_experts = moe_blocks * self.moe_num_experts * n_mats * self.d_model * self.moe_d_ff
        active_experts = moe_blocks * self.moe_top_k * n_mats * self.d_model * self.moe_d_ff
        return total - all_experts + active_experts


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, per the assignment rules."""
    if shape.is_decode and cfg.is_encoder_only:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "pure full-attention arch: 500k dense-attention decode is the "
            "quadratic regime excluded by the assignment (see DESIGN.md)"
        )
    return True, ""
