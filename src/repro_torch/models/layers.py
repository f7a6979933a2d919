"""Shared neural-net building blocks (PyTorch port of ``repro.models.layers``).

Pure functions over parameter dicts. The rounding points are the JAX
package's: ``rmsnorm`` works in float32 and casts back, ``rope`` computes its
angles in float32 and rotates in ``x.dtype``, and each weight is cast to the
activation dtype where it is used.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamSpec
from repro_torch.parallel import collectives as coll


def rmsnorm_spec(dim: int, logical=("act_embed",)) -> ParamSpec:
    return ParamSpec((dim,), logical, init="ones")


def rmsnorm(x, w, eps: float, group: Optional[coll.Group] = None):
    """RMS norm over the last dim. With ``group`` that dim is split over
    the group's ranks (``x`` and ``w`` the rank's block): the mean square
    is the all-reduced sum of squares over the whole dim."""
    dtype = x.dtype
    x = x.float()
    if group is None:
        var = torch.mean(x * x, dim=-1, keepdim=True)
    else:
        var = coll.all_reduce(torch.sum(x * x, dim=-1, keepdim=True), group) / (
            x.shape[-1] * group.size)
    x = x * torch.rsqrt(var + eps)
    return (x * w.float()).to(dtype)


def rope(x, positions, theta: float):
    """Apply RoPE. x: [..., S, H, D]; positions: [..., S] (broadcastable).

    Angles in float32 (position * freq needs the range), rotation in
    ``x.dtype``."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions.float()[..., None] * freqs  # [..., S, half]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)  # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1)


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    D = cfg.d_model
    F_ = d_ff or cfg.d_ff
    wd = cfg.weight_dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((D, F_), ("embed", "mlp"), dtype=wd),
            "w_up": ParamSpec((D, F_), ("embed", "mlp"), dtype=wd),
            "w_down": ParamSpec((F_, D), ("mlp", "embed"), dtype=wd),
        }
    return {
        "w_up": ParamSpec((D, F_), ("embed", "mlp"), dtype=wd),
        "w_down": ParamSpec((F_, D), ("mlp", "embed"), dtype=wd),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp(cfg: ModelConfig, p: dict, x):
    dt = cfg.activation_dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        act = F.silu if cfg.mlp_type == "swiglu" else _gelu
        h = act(g) * u
    else:
        h = _gelu(x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x
