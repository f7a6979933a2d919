"""Prefill and decode steps (PyTorch port of the serving half of
``repro.launch.steps``). One card, so no shardings: each ``build_*``
function returns a plain callable."""

from __future__ import annotations

from repro_torch.launch import inputs as inputs_mod
from repro_torch.models import model as model_mod
from repro_torch.models.config import ModelConfig, ShapeConfig


def decoder_slots(cfg: ModelConfig, seq_len: int) -> int:
    """Slots of a global block's cache for sequences of ``seq_len`` tokens:
    ``cache_len`` of the decoder's share (:func:`~repro_torch.launch.inputs.
    split_seq`; an encoder-decoder model gives the encoder its part)."""
    return model_mod.cache_len(inputs_mod.split_seq(cfg, seq_len)[1])


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig):
    """``prefill_step(params, batch) -> (logits, cache)`` with a cache of
    :func:`decoder_slots` slots."""
    max_len = decoder_slots(cfg, shape.seq_len)

    def prefill_step(params, batch):
        return model_mod.prefill_fn(cfg, params, batch, max_len=max_len)

    return prefill_step


def build_decode_step(cfg: ModelConfig):
    """``decode_step(params, token, pos, cache) -> (logits, cache)``."""

    def decode_step(params, token, pos, cache):
        return model_mod.decode_fn(cfg, params, token, pos, cache)

    return decode_step
