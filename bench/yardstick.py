"""The benchmark's own arithmetic: the H100's peaks, the operations and bytes
of a kernel call and of a model's step, reckoned from shapes, and the
statistics the metrics take. Nothing here imports the program: a later
change to the program cannot move the yardstick.

Counts are of the work the algorithm needs, not of what a kernel spends:
an attention forward counts its two products over the attended pairs, a
backward the minimum of five, every input read once and every output
written once.
"""

from __future__ import annotations

import statistics
from typing import Iterable, Sequence, Tuple

# NVIDIA's data sheet, H100 SXM, dense: bf16 tensor-core peak and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take: operations at the bf16 peak
    or bytes at the HBM rate, whichever is longer."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def attended_pairs(Sq: int, Skv: int, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs that attend: all of them, or under a causal mask
    those with key position <= query position (query i at q_offset + i)."""
    if not causal:
        return Sq * Skv
    total = 0
    # rows whose causal limit is inside [0, Skv): i + q_offset + 1 keys
    first_full = max(0, min(Sq, Skv - q_offset))
    n = first_full
    total += n * (q_offset + 1) + n * (n - 1) // 2
    total += (Sq - first_full) * Skv
    return total


def attention_fwd_work(q_shape: Sequence[int], kv_shape: Sequence[int], causal: bool,
                       itemsize: int, q_offset: int = 0, lse: bool = False) -> Tuple[float, float]:
    """(flops, bytes) of one attention forward: q [B, Sq, H, hd], k and v
    [B, Skv, KV, hd]; two products (scores and probabilities times values)
    over the attended pairs; q, k, v read and o written once, and with
    ``lse`` the float32 row statistics [B, H, Sq] written too."""
    B, Sq, H, hd = q_shape
    Skv, KV = kv_shape[1], kv_shape[2]
    flops = 2 * 2.0 * B * H * hd * attended_pairs(Sq, Skv, causal, q_offset)
    nbytes = itemsize * (2.0 * B * Sq * H * hd + 2.0 * B * Skv * KV * hd)
    if lse:
        nbytes += 4.0 * B * H * Sq
    return flops, nbytes


def attention_bwd_work(q_shape: Sequence[int], kv_shape: Sequence[int], causal: bool,
                       itemsize: int, q_offset: int = 0) -> Tuple[float, float]:
    """(flops, bytes) of one attention backward: five products over the
    attended pairs (scores again, dO V^T, dV = P^T dO, dQ = dS K,
    dK = dS^T Q); do, q, k, v, o and the float32 lse read once, dq, dk, dv
    written once."""
    B, Sq, H, hd = q_shape
    Skv, KV = kv_shape[1], kv_shape[2]
    flops = 5 * 2.0 * B * H * hd * attended_pairs(Sq, Skv, causal, q_offset)
    q_like = B * Sq * H * hd  # do, q, o, dq
    kv_like = B * Skv * KV * hd  # k, v, dk, dv
    nbytes = itemsize * (4.0 * q_like + 4.0 * kv_like) + 4.0 * B * H * Sq
    return flops, nbytes


def dense_matmul_params(cfg: dict) -> Tuple[float, float]:
    """(weights of one layer's products, weights of the head) of a dense
    transformer configuration file: q, k, v, o and the two-matrix GELU
    MLP a layer; the head is [d, vocab]."""
    D, H, KV, hd, F = (cfg["hidden_size"], cfg["num_attention_heads"],
                       cfg["num_key_value_heads"], cfg["head_dim"], cfg["intermediate_size"])
    layer = D * H * hd + 2 * D * KV * hd + H * hd * D + 2 * D * F
    return float(layer), float(D * cfg["vocab_size"])


def forward_flops(cfg: dict, seq: int, batch: int = 1, head_positions: int = 0) -> float:
    """Model operations of one forward over ``batch`` sequences of ``seq``
    tokens: two per weight and token in each layer's products, the
    attention's two products over the attended pairs (causal or not, as
    the configuration says), and the head over ``head_positions``
    positions a sequence (a prefill's last one; every one in training)."""
    layer, head = dense_matmul_params(cfg)
    L = cfg["num_hidden_layers"]
    D_att = cfg["num_attention_heads"] * cfg["head_dim"]
    pairs = attended_pairs(seq, seq, cfg["causal"])
    per_seq = L * (2.0 * layer * seq + 2 * 2.0 * D_att * pairs) + 2.0 * head * head_positions
    return batch * per_seq


def train_step_flops(cfg: dict, seq: int, batch: int) -> float:
    """Model operations of a train step: three times the forward with its
    head over every position (the backward's two products for each of the
    forward's one); the recompute is not counted."""
    return 3.0 * forward_flops(cfg, seq, batch, head_positions=seq)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between the
    order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Iterable[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    xs = list(values)
    q1, med, q3 = statistics.quantiles(xs, n=4)
    return (q3 - q1) / abs(med)
