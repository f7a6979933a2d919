"""Deterministic synthetic data pipeline (PyTorch port of
``repro.data.pipeline``).

Real deployments stream tokenized corpora; this pipeline makes seeded
synthetic token batches with the same interface, so every layer above it
(the train loop, checkpoint-resume, crash replay) runs as it would in
production: ``batch_at(step)`` is a pure function of (seed, step), so a
resumed run replays exactly.

The batches are the JAX package's, bit for bit: the same numpy generator
(``default_rng(seed + step)``) and the same draws in the same order. Where
the reference rounds a float32 draw to bf16 through numpy
(``.astype(jnp.bfloat16)``), the port rounds it with
``torch.from_numpy(x).to(torch.bfloat16)``: round to nearest even on both
sides, and no ``ml_dtypes`` needed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.launch.inputs import split_seq
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import distribute, pspec


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 1234


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


class SyntheticTokenPipeline:
    """Seeded LM batches; ``batch_at(step)`` is pure, so resume == replay."""

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        self.enc_S, self.dec_S = split_seq(cfg, data.seq_len)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The batch of ``step`` as CPU tensors: ``tokens`` int32 [B, S]
        (an encoder-decoder model's decoder share, a vision stub's text
        after its image positions), bf16 ``enc_embeds`` [B, enc_S, D] or
        ``image_embeds`` [B, Ni, D], and an encoder-only model's MLM
        ``targets`` int32."""
        cfg, d = self.cfg, self.data
        rng = np.random.default_rng(np.uint64(d.seed) + np.uint64(step))
        B = d.global_batch
        out: Dict[str, torch.Tensor] = {}
        if cfg.is_encoder_decoder:
            out["enc_embeds"] = _bf16(rng.standard_normal(
                (B, self.enc_S, cfg.d_model), dtype=np.float32))
            out["tokens"] = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (B, self.dec_S), dtype=np.int32))
        elif cfg.frontend == "vision_stub":
            n_img = cfg.num_image_embeds
            out["image_embeds"] = _bf16(rng.standard_normal(
                (B, n_img, cfg.d_model), dtype=np.float32))
            out["tokens"] = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (B, d.seq_len - n_img), dtype=np.int32))
        else:
            out["tokens"] = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (B, d.seq_len), dtype=np.int32))
        if cfg.is_encoder_only:
            out["targets"] = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, tuple(out["tokens"].shape), dtype=np.int32))
        return out

    def iter_from(self, step: int) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            yield self.batch_at(step)
            step += 1


def device_put_batch(batch: Dict[str, torch.Tensor], device, mesh=None,
                     rules=None) -> Dict[str, torch.Tensor]:
    """Place a host batch on ``device``; with a ``DeviceMesh`` and the
    training ``rules``, as DTensors split over the rules' batch axes on
    their first dim (the reference's ``device_put_batch``): each rank keeps
    its rows of the same global batch."""
    out = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    if mesh is None:
        return out
    return {k: distribute(v, pspec(rules.get("batch"), *([None] * (v.dim() - 1))), mesh)
            for k, v in out.items()}
