"""Mixture-of-Experts on one card (PyTorch port of ``repro.models.moe``).

The JAX package shards the experts over the ``model`` mesh axis inside a
``shard_map`` and runs each shard's rows through ``lax.ragged_dot``. The
port runs on one card, so its expert-parallel domain is one device:
``moe_layout(cfg, 1)`` gives ``e_shards = f_shards = 1`` and ``slots = E``,
every routed row is local, and ``shard_map``, ``psum`` and the ZeRO gather
of the expert weights have no counterpart.

:func:`moe_apply` keeps the reference's semantics step by step, and is
split into its four steps so that they can be timed apart:

1. :func:`route`: float32 router logits, softmax, ``top_k`` on the
   probabilities, renormalised;
2. :func:`dispatch`: a stable sort of the ``T * k`` (token, choice) rows by
   expert id and the capacity cut ``order[:C]``, ``C = _capacity(T * k, 1,
   cf)``; rows past the cut are dropped, as the reference drops them;
3. :func:`expert_ffn`: the grouped SwiGLU FFN (``lax.ragged_dot`` in the
   reference, an XLA op and not a Pallas kernel) as one ``torch.matmul``
   per expert and weight on that expert's run of sorted rows;
4. :func:`combine`: each row weighted by its renormalised probability and
   summed into its token.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ParamSpec


def moe_layout(cfg: ModelConfig, n_shards: int) -> Tuple[int, int, int, int]:
    """(e_shards, f_shards, n_local_experts, slots) for an EP domain of
    ``n_shards`` devices. Works for any (E, n): e_shards = gcd(E, n) expert
    groups of n_local_e experts; each group's FFN dim is split into f_shards
    chunks. Device i owns (group i // f_shards, chunk i % f_shards) — i.e.
    slot s maps to expert ((s // n_local_e) // f_shards) * n_local_e
    + (s % n_local_e), chunk (s // n_local_e) % f_shards. All slots on one
    device are DISTINCT experts (same chunk), so ragged_dot groups never
    overlap."""
    E = cfg.moe_num_experts
    e_shards = math.gcd(E, n_shards)
    f_shards = n_shards // e_shards
    n_local_e = E // e_shards
    slots = n_shards * n_local_e
    return e_shards, f_shards, n_local_e, slots


def moe_specs(cfg: ModelConfig, n_model: int = 1) -> dict:
    D, E, F_ = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    _, f_shards, _, slots = moe_layout(cfg, n_model)
    Fc = F_ // f_shards
    wd = cfg.weight_dtype
    assert F_ % f_shards == 0
    logical = ("expert_slot", "expert_embed", "expert_mlp")
    return {
        "router": ParamSpec((D, E), (None, None), dtype=torch.float32),
        "wg": ParamSpec((slots, D, Fc), logical, dtype=wd),
        "wu": ParamSpec((slots, D, Fc), logical, dtype=wd),
        "wd_": ParamSpec((slots, Fc, D), ("expert_slot", "expert_mlp", "expert_embed"),
                         dtype=wd),
    }


def _capacity(n_rows_local: int, e_shards: int, cf: float) -> int:
    c = int(math.ceil(n_rows_local * cf / e_shards))
    return max(8, min(n_rows_local, (c + 7) // 8 * 8))


def route(cfg: ModelConfig, router, x_flat) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_flat [T, D] -> (topw [T, k] float32, renormalised; topi [T, k]
    expert ids, most probable first). ``torch.topk`` does not promise
    ``lax.top_k``'s order among equal probabilities (lowest index first);
    float32 probabilities of real activations are not tied."""
    logits = x_flat.float() @ router.float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, cfg.moe_top_k, dim=-1)
    return topw / topw.sum(dim=-1, keepdim=True), topi


def dispatch(cfg: ModelConfig, topi) -> Tuple[torch.Tensor, List[int]]:
    """(sel, group sizes): ``sel`` [n <= C] the flat (token * k + choice)
    rows kept, sorted by expert id (stable, so by token within an expert);
    the group sizes, one a expert, are read to the host: the one
    device-to-host read of an MoE block, which sizes the per-expert
    products. A ``meta`` tensor (the dry run's data-less trace) has no
    sizes to read: there the kept rows are spread evenly over the experts,
    the static split of the reference's capacity-sized buffers."""
    T, k = topi.shape
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sel = order[:_capacity(T * k, 1, cfg.moe_capacity_factor)]
    if topi.device.type == "meta":
        n, E = sel.shape[0], cfg.moe_num_experts
        return sel, [n // E + (e < n % E) for e in range(E)]
    sizes = torch.bincount(flat_e[sel], minlength=cfg.moe_num_experts)
    return sel, sizes.tolist()


def expert_ffn(cfg: ModelConfig, p: dict, xs, group_sizes: List[int]):
    """The grouped SwiGLU FFN: rows ``xs`` [n, D], sorted by expert, in runs
    of ``group_sizes``; each expert with rows multiplies its run by its
    weights (cast to the activation dtype, as the reference casts them)."""
    act = cfg.activation_dtype
    out = xs.new_empty((xs.shape[0], cfg.d_model))
    start = 0
    for e, n in enumerate(group_sizes):
        if not n:
            continue
        rows = xs[start:start + n]
        h = F.silu(rows @ p["wg"][e].to(act)) * (rows @ p["wu"][e].to(act))
        out[start:start + n] = h @ p["wd_"][e].to(act)
        start += n
    return out


def combine(out_rows, sel, topw, topi):
    """[T, D]: each kept row times its token's renormalised probability (in
    the rows' dtype, as the reference rounds it), summed into its token.
    The reference scatter-adds the sorted rows into zeros, so a token's
    rows are added in ascending expert id. Here each row goes to slot
    ``token * k + rank`` (its expert's rank among the token's k experts) of
    a zeroed [T, k, D] buffer, by distinct indices, and the k slots are
    added in that order: the same rounding, and the same bits on every run,
    where an ``index_add_`` on the card adds by atomics in no fixed order.
    A dropped row's slot stays zero."""
    T, k = topi.shape
    rows = out_rows * topw.reshape(-1)[sel].to(out_rows.dtype)[:, None]
    rank = torch.argsort(torch.argsort(topi, dim=-1), dim=-1).reshape(-1)
    buf = out_rows.new_zeros((T * k, out_rows.shape[1]))
    buf[(sel // k) * k + rank[sel]] = rows
    buf = buf.view(T, k, -1)
    out = buf[:, 0]
    for j in range(1, k):
        out = out + buf[:, j]
    return out


def moe_apply(cfg: ModelConfig, p: dict, x):
    """x: [B, S, D] -> [B, S, D] on one device (``slots = E``)."""
    B, S, D = x.shape
    if p["wg"].shape[0] != cfg.moe_num_experts:
        raise ValueError(f"{cfg.name}: expert weights of {p['wg'].shape[0]} slots; "
                         f"one device holds moe_layout(cfg, 1)'s "
                         f"{cfg.moe_num_experts}")
    x_flat = x.reshape(B * S, D)
    topw, topi = route(cfg, p["router"], x_flat)
    sel, group_sizes = dispatch(cfg, topi)
    out_rows = expert_ffn(cfg, p, x_flat[sel // cfg.moe_top_k], group_sizes)
    return combine(out_rows, sel, topw, topi).reshape(B, S, D)


def moe_apply_token_routed(cfg: ModelConfig, p: dict, x):
    """The reference's serve-time path with the experts resident over the
    whole mesh. Its EP domain here is the one device, where it gathers no
    tokens, computes every routed row and sums nothing across devices:
    :func:`moe_apply`."""
    return moe_apply(cfg, p, x)


def moe_aux_loss(cfg: ModelConfig, p: dict, x) -> torch.Tensor:
    """Switch-style load-balance loss over the global batch (fp32)."""
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    x_flat = x.reshape(-1, x.shape[-1]).float()
    probs = torch.softmax(x_flat @ p["router"].float(), dim=-1)
    _, topi = torch.topk(probs, k, dim=-1)
    onehot = F.one_hot(topi, E).float().sum(dim=1)  # [T, E]
    frac_routed = onehot.mean(dim=0) / k
    mean_prob = probs.mean(dim=0)
    return E * torch.sum(frac_routed * mean_prob)
