"""Gradient compression for the data-parallel reduction: int8 with error
feedback (PyTorch port of ``repro.optim.compression``).

Quantizing to int8 with one scale a tensor cuts the bytes of a gradient
reduction 4x against float32; error feedback (Karimireddy et al.) carries
each step's quantization residual into the next step, so the scheme stays
convergent. Wrap the gradients between the backward pass and the optimizer
update. The port runs on one card, where no reduction crosses a link: the
pair is the reference's arithmetic, for runs that want its numbers. Off by
default.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.optimizers import tree_leaves, tree_unflatten


def init_error_feedback(params) -> Any:
    """Zero float32 residuals of the tree's layout."""
    return tree_unflatten(params, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                               for p in tree_leaves(params)])


def compress_decompress(g, ef):
    """int8 quantize -> dequantize with error feedback. Returns (g_hat, ef')."""
    g = g.float() + ef
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    g_hat = q.float() * scale
    return g_hat, g - g_hat


def compress_grads(grads, ef_state) -> Tuple[Any, Any]:
    out = [compress_decompress(g, e)
           for g, e in zip(tree_leaves(grads), tree_leaves(ef_state), strict=True)]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))
