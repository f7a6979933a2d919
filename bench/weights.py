"""Weights of a dense transformer configuration, made on the device from
the seed in one call a leaf, in the dtype they are stored in.

The tree is the layout both the program and the reference read: stacked
over the layers, ``decoder.b0`` holding each layer's ``ln_attn``, ``attn``
(``wq`` [L, D, H, hd], ``wk``/``wv`` [L, D, KV, hd], ``wo`` [L, H, hd, D]),
``ln_mlp`` and ``mlp`` (``w_up`` [L, D, F], ``w_down`` [L, F, D]); then
``embed`` [V, D], ``final_norm`` [D] and the head [D, V] (``unembed`` of a
causal decoder, ``mlm_head`` of an encoder).

Each matrix is N(0, 1 / fan_in) over the dims its product contracts, so
every product keeps its input's scale and a full-width random model stays
well conditioned in bf16; embeddings are N(0, 1) and norm scales
1 + 0.1 N(0, 1), so that a scale left out shows.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def head_key(cfg: dict) -> str:
    return "unembed" if cfg["causal"] else "mlm_head"


def layout(cfg: dict) -> Dict[str, Tuple[tuple, str, float]]:
    """{path: (shape, kind, std)} of every leaf; kind "norm" or "matrix"."""
    L, D, H, KV, hd, F, V = (cfg["num_hidden_layers"], cfg["hidden_size"],
                             cfg["num_attention_heads"], cfg["num_key_value_heads"],
                             cfg["head_dim"], cfg["intermediate_size"], cfg["vocab_size"])
    b = "decoder/b0/"
    return {
        "embed": ((V, D), "matrix", 1.0),
        "final_norm": ((D,), "norm", 0.1),
        head_key(cfg): ((D, V), "matrix", 1 / math.sqrt(D)),
        b + "ln_attn": ((L, D), "norm", 0.1),
        b + "attn/wq": ((L, D, H, hd), "matrix", 1 / math.sqrt(D)),
        b + "attn/wk": ((L, D, KV, hd), "matrix", 1 / math.sqrt(D)),
        b + "attn/wv": ((L, D, KV, hd), "matrix", 1 / math.sqrt(D)),
        b + "attn/wo": ((L, H, hd, D), "matrix", 1 / math.sqrt(H * hd)),
        b + "ln_mlp": ((L, D), "norm", 0.1),
        b + "mlp/w_up": ((L, D, F), "matrix", 1 / math.sqrt(D)),
        b + "mlp/w_down": ((L, F, D), "matrix", 1 / math.sqrt(F)),
    }


def make_weights(cfg: dict, seed: int, device, matrix_dtype: str) -> dict:
    """The weight tree of ``cfg`` drawn from ``seed`` on ``device``:
    matrices in ``matrix_dtype``, norm scales in float32 (as the program
    keeps them)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tree: dict = {}
    for path, (shape, kind, std) in sorted(layout(cfg).items()):
        if kind == "norm":
            x = torch.empty(shape, dtype=torch.float32, device=device)
            x.normal_(1.0, std, generator=gen)
        else:
            x = torch.empty(shape, dtype=DTYPES[matrix_dtype], device=device)
            x.normal_(0.0, std, generator=gen)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = x
    return tree


def leaves(tree, prefix: str = ""):
    """(path, tensor) of every leaf, in sorted path order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree
