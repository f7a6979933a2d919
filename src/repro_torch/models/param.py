"""Abstract parameter specs and their initialisation (PyTorch port of
``repro.models.param``).

A parameter is described by its shape, logical axis names and init rule, so
that the model's parameter tree can be listed without allocating; the
serving engine materialises it with :func:`init_params`. The port runs on
one card, so the JAX package's sharding rules, ``resolve_spec`` and meshes
have no counterpart here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]  # one logical axis name (or None) per dim
    init: str = "normal"  # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 1.0  # stddev multiplier for normal init
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn, tree):
    """Apply ``fn`` to every :class:`ParamSpec` of a nested dict."""
    if is_spec(tree):
        return fn(tree)
    return {k: tree_map_specs(fn, v) for k, v in tree.items()}


def init_param(spec: ParamSpec, generator: torch.Generator) -> torch.Tensor:
    """One parameter on ``generator``'s device: zeros, ones, the Mamba2
    inits of ``A_log`` (``ssm_a``: log of U(1, 16)) and of the dt bias
    (``ssm_dt``: softplus^-1 of U(1e-3, 1e-1)), or a normal truncated at two
    standard deviations with fan-in scaling (stddev ``scale / sqrt(fan_in)``,
    fan-in the second-to-last dim), drawn in float32 and cast to the spec's
    dtype."""
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init in ("ssm_a", "ssm_dt"):
        lo, hi = (1.0, 16.0) if spec.init == "ssm_a" else (1e-3, 1e-1)
        u = torch.empty(spec.shape, dtype=torch.float32, device=dev)
        u.uniform_(lo, hi, generator=generator)
        return (torch.log(u) if spec.init == "ssm_a"
                else torch.log(torch.expm1(u))).to(spec.dtype)
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / math.sqrt(max(1, fan_in))
    x = torch.empty(spec.shape, dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return x.mul_(std).to(spec.dtype)  # in place: one float32 copy of the leaf


def init_params(tree, generator: torch.Generator) -> Any:
    """Materialise a ParamSpec tree, leaf after leaf in sorted key order
    from one generator (deterministic for a given seed and device)."""
    if is_spec(tree):
        return init_param(tree, generator)
    return {k: init_params(tree[k], generator) for k in sorted(tree)}
