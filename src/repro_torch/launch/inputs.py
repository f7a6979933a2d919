"""Sequence split between encoder and decoder (PyTorch port of the part of
``repro.launch.inputs`` the serving path reads)."""

from __future__ import annotations

from typing import Tuple

from repro_torch.models.config import ModelConfig


def split_seq(cfg: ModelConfig, seq_len: int) -> Tuple[int, int]:
    """(encoder_len, decoder_len) for enc-dec models; (0, seq) otherwise."""
    if not cfg.is_encoder_decoder:
        return 0, seq_len
    enc = int(seq_len * cfg.encoder_seq_frac)
    if cfg.max_encoder_len:
        enc = min(enc, cfg.max_encoder_len)
    return enc, seq_len - enc
