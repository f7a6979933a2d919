"""Weights of a mixture-of-experts decoder configuration (Mixtral's block),
made on the device from the seed in one call a leaf, in the dtype they are
stored in.

The tree is the layout both the program and the reference read: the dense
tree of ``bench/weights.py`` with each layer's ``mlp`` replaced by ``moe``:
``router`` [L, D, E] in float32 (as the program keeps it), and the
experts' SwiGLU matrices ``wg`` and ``wu`` [L, E, D, F] and ``wd_`` [L, E,
F, D]. Each matrix is N(0, 1 / fan_in) over the dims its product
contracts, the router too, so that its logits are of unit scale.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from bench import weights
from bench.weights import DTYPES


def layout(cfg: dict) -> Dict[str, Tuple[tuple, str, float]]:
    """{path: (shape, kind, std)} of every leaf; kind "norm", "router" or
    "matrix"."""
    L, D, E, F = (cfg["num_hidden_layers"], cfg["hidden_size"], cfg["num_local_experts"],
                  cfg["intermediate_size"])
    b = "decoder/b0/"
    out = {p: v for p, v in weights.layout(cfg).items() if not p.startswith(b + "mlp/")}
    out.update({
        b + "moe/router": ((L, D, E), "router", 1 / math.sqrt(D)),
        b + "moe/wg": ((L, E, D, F), "matrix", 1 / math.sqrt(D)),
        b + "moe/wu": ((L, E, D, F), "matrix", 1 / math.sqrt(D)),
        b + "moe/wd_": ((L, E, F, D), "matrix", 1 / math.sqrt(F)),
    })
    return out


def make_weights(cfg: dict, seed: int, device, matrix_dtype: str) -> dict:
    """The weight tree of ``cfg`` drawn from ``seed`` on ``device``:
    matrices in ``matrix_dtype``, norm scales and the router in float32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tree: dict = {}
    for path, (shape, kind, std) in sorted(layout(cfg).items()):
        dtype = DTYPES[matrix_dtype] if kind == "matrix" else torch.float32
        x = torch.empty(shape, dtype=dtype, device=device)
        x.normal_(1.0 if kind == "norm" else 0.0, std, generator=gen)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = x
    return tree
