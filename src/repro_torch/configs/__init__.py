"""Architecture registry (PyTorch port of ``repro.configs``).

The port carries every architecture of the JAX package's registry, and
the serving path runs each of them:

* dense decoders: llama3.2-1b, qwen3-8b (qk-norm), yi-34b (padded query
  heads), the paper's own gpt-neox-20b (head dim 96), opt-30b and
  BLOOM-176B (the paper's evaluation workload, whose roofline terms set
  the power plane of the Table-4 mix), and gemma2-9b (alternating
  sliding-window and global layers with a ring-buffer cache, softcaps,
  post-norms, GeGLU);
* mixture of experts: mixtral-8x7b (8 experts top-2, a 4096 sliding
  window on every layer) and kimi-k2-1t-a32b (384 experts top-8 and a
  shared expert, bf16 weights);
* state space: mamba2-370m (Mamba2/SSD blocks only, tied embeddings);
* hybrid: jamba-1.5-large-398b (Mamba2 and attention 7:1 without RoPE, an
  FFN after every block, MoE on every other one);
* encoders: the paper's roberta-large (encoder-only, an MLM head), the
  paper's flan-t5-xxl and whisper-base (encoder-decoder with
  cross-attention; whisper's audio frontend is a stub, its encoder input
  the frame embeddings themselves) and internvl2-1b (a decoder whose
  vision frontend is a stub: patch embeddings prepended to the text).
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

# the ten assigned architectures of the dry run's grid, in the JAX
# package's order
ASSIGNED = ("whisper-base", "mixtral-8x7b", "kimi-k2-1t-a32b", "internvl2-1b",
            "llama3.2-1b", "gemma2-9b", "yi-34b", "qwen3-8b", "mamba2-370m",
            "jamba-1.5-large-398b")

ALL = {
    "bloom-176b": "bloom_176b",
    "flan-t5-xxl": "flan_t5_xxl",
    "gemma2-9b": "gemma2_9b",
    "gpt-neox-20b": "gpt_neox_20b",
    "internvl2-1b": "internvl2_1b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama3.2-1b": "llama3_2_1b",
    "mamba2-370m": "mamba2_370m",
    "mixtral-8x7b": "mixtral_8x7b",
    "opt-30b": "opt_30b",
    "qwen3-8b": "qwen3_8b",
    "roberta-large": "roberta_large",
    "whisper-base": "whisper_base",
    "yi-34b": "yi_34b",
}


def _module(name: str):
    if name not in ALL:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALL)}")
    return importlib.import_module(f"repro_torch.configs.{ALL[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).SMOKE


def assigned_archs() -> List[str]:
    """The architectures of the dry run's grid (:data:`ASSIGNED`); the rest
    of the registry are the paper's own workloads."""
    return list(ASSIGNED)
