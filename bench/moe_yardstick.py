"""The benchmark's arithmetic of a mixture-of-experts decoder configuration
(Mixtral's block), reckoned from shapes and the rows each expert computed:
a forward's model operations, and the work of one call of the expert FFN.
Nothing here imports the program.

Counts are of the work the model needs: a token's ``num_experts_per_tok``
routed experts and not the others, the router, the attention's two
products over the attended (causal) pairs, and the head over the
positions asked for. An expert FFN call reads each expert's three weight
matrices (of the experts with rows) and its rows once, and writes its
output once: the bound a grouped GEMM over the experts is held to.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from bench.yardstick import attended_pairs


def moe_matmul_params(cfg: dict) -> Tuple[float, float, float, float]:
    """(weights of one layer's attention products, of its router, of one
    expert, of the head): q, k, v and o; [d, experts]; the SwiGLU's three
    matrices; [d, vocab]."""
    D, H, KV, hd, F = (cfg["hidden_size"], cfg["num_attention_heads"],
                       cfg["num_key_value_heads"], cfg["head_dim"], cfg["intermediate_size"])
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    return (float(attn), float(D * cfg["num_local_experts"]), float(3 * D * F),
            float(D * cfg["vocab_size"]))


def forward_flops(cfg: dict, seq: int, batch: int = 1, head_positions: int = 0) -> float:
    """Model operations of one forward over ``batch`` sequences of ``seq``
    tokens: two per weight and token of the attention products, the router
    and the token's routed experts, the attention's two products over the
    causal pairs, and the head over ``head_positions`` positions a
    sequence."""
    attn, router, expert, head = moe_matmul_params(cfg)
    L, k = cfg["num_hidden_layers"], cfg["num_experts_per_tok"]
    D_att = cfg["num_attention_heads"] * cfg["head_dim"]
    pairs = attended_pairs(seq, seq, True)
    per_token = 2.0 * (attn + router + k * expert)
    per_seq = L * (per_token * seq + 2 * 2.0 * D_att * pairs) + 2.0 * head * head_positions
    return batch * per_seq


def expert_work(rows: Sequence[int], d_model: int, d_ff: int,
                itemsize: int) -> Tuple[float, float]:
    """(flops, bytes) of one expert FFN call that computed ``rows[e]`` rows
    of expert e: three products of each row with its expert's [d, f]
    matrices; the matrices of every expert with rows, the rows in and the
    outputs out, each once."""
    n = sum(rows)
    used = sum(1 for r in rows if r)
    flops = 2.0 * 3 * d_model * d_ff * n
    nbytes = itemsize * (3.0 * d_model * d_ff * used + 2.0 * d_model * n)
    return flops, nbytes
