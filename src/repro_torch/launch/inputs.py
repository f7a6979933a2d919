"""Sharding-rule selection and abstract input specs for every step kind
(PyTorch port of ``repro.launch.inputs``).

:func:`make_rules` picks a cell's rules over a mesh layout; the
``*_input_specs`` functions return each input of a step as a
:class:`~repro_torch.models.param.Sharded`: an empty ``meta`` tensor of the
reference's shape and dtype and its spec over the layout (no allocation).
The dry run (``launch.dryrun``) counts each device's bytes from them and
traces the step on the meta tensors. Serving reads :func:`split_seq`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import model as model_mod
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.param import (
    Rules,
    fsdp_rules,
    pspec,
    resolve_spec,
    serve_rules,
    sharded,
    train_rules,
    tree_map_specs,
)


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def make_rules(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Rules:
    multi = "pod" in mesh.axis_names
    if shape.kind == "train":
        rules = dict(fsdp_rules(multi) if cfg.train_strategy == "fsdp"
                     else train_rules(multi))
    else:
        rules = dict(serve_rules(multi, cfg.decode_seq_shard and shape.is_decode))
    # batch divisibility: progressively shrink the batch axes until they divide
    batch_axes = rules.get("batch")
    if batch_axes is not None:
        axes = (batch_axes,) if isinstance(batch_axes, str) else tuple(batch_axes)
        while axes and shape.global_batch % _axes_size(mesh, axes) != 0:
            axes = axes[1:]
        rules["batch"] = axes if axes else None
    # decode: experts resident over (data x model) with token routing — the
    # only layout where 400B-1T MoE weights fit a serving pod (see moe.py)
    if shape.is_decode and cfg.moe_num_experts:
        rules["moe_mode"] = "token"
        rules["expert_slot"] = ("data", "model")
        rules["expert_embed"] = None
    # tiny batches free the data axis: use it for KV sequence sharding too
    if shape.is_decode and cfg.decode_seq_shard and rules["batch"] is None:
        rules["kv_seq"] = ("data", "model") if "pod" not in mesh.axis_names else (
            "pod", "data", "model")
    return rules


def batch_shards(mesh, rules: Rules) -> int:
    """Devices a global batch is split over: the size of the rules' batch
    axes."""
    return _axes_size(mesh, rules.get("batch"))


def split_seq(cfg: ModelConfig, seq_len: int) -> Tuple[int, int]:
    """(encoder_len, decoder_len) for enc-dec models; (0, seq) otherwise."""
    if not cfg.is_encoder_decoder:
        return 0, seq_len
    enc = int(seq_len * cfg.encoder_seq_frac)
    if cfg.max_encoder_len:
        enc = min(enc, cfg.max_encoder_len)
    return enc, seq_len - enc


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: Rules) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    bspec = rules.get("batch")
    enc_S, dec_S = split_seq(cfg, S)
    bf16, i32 = torch.bfloat16, torch.int32
    out: Dict[str, Any] = {}
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = sharded((B, enc_S, cfg.d_model), bf16, mesh, pspec(bspec, None, None))
        out["tokens"] = sharded((B, dec_S), i32, mesh, pspec(bspec, None))
    elif cfg.frontend == "vision_stub":
        n_img = cfg.num_image_embeds
        out["image_embeds"] = sharded((B, n_img, cfg.d_model), bf16, mesh,
                                      pspec(bspec, None, None))
        out["tokens"] = sharded((B, S - n_img), i32, mesh, pspec(bspec, None))
    else:
        out["tokens"] = sharded((B, S), i32, mesh, pspec(bspec, None))
    if cfg.is_encoder_only:
        out["targets"] = sharded(out["tokens"].shape, i32, mesh, pspec(bspec, None))
    return out


def prefill_input_specs(cfg, shape, mesh, rules) -> Dict[str, Any]:
    return train_input_specs(cfg, shape, mesh, rules)


def cache_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: Rules):
    """The decode cache (``model.cache_specs``) at the shape's batch and
    decoder length, each leaf laid out by :func:`resolve_spec`."""
    enc_S, dec_S = split_seq(cfg, shape.seq_len)
    return tree_map_specs(
        lambda s: sharded(s.shape, s.dtype, mesh, resolve_spec(s.shape, s.logical, rules, mesh)),
        model_mod.cache_specs(cfg, shape.global_batch, dec_S, enc_S))


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: Rules) -> Dict[str, Any]:
    B = shape.global_batch
    bspec = rules.get("batch")
    return {
        "token": sharded((B, 1), torch.int32, mesh, pspec(bspec, None)),
        "pos": sharded((), torch.int32, mesh, pspec()),
        "cache": cache_input_specs(cfg, shape, mesh, rules),
    }


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: Rules) -> Dict[str, Any]:
    if shape.kind == "train":
        return train_input_specs(cfg, shape, mesh, rules)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape, mesh, rules)
    return decode_input_specs(cfg, shape, mesh, rules)
