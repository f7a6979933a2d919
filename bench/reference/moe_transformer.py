"""Plain reference of a mixture-of-experts decoder configuration
(``bench/configs``; Mixtral's block, arXiv:2401.04088): pre-norm blocks of
RMSNorm, grouped-query self attention with rotary positions over the
whole head, full causal (no sliding window), then a mixture of SwiGLU
experts; residual adds; then a final RMSNorm and the untied head. A
prefill gives the last position's logits and every layer's K and V.

The expert layer: float32 router logits, a softmax over the experts, the
``num_experts_per_tok`` most probable kept and their probabilities
renormalised; each expert computes ``w2(silu(w1 x) * w3 x)`` (``wd_``,
``wg``, ``wu``) on the tokens routed to it, and each token sums its
experts' outputs weighted by those probabilities. Nothing is dropped.
Where the program picked other experts than the reference would (a bf16
rounding near a tie), ``route_as`` makes the reference follow the
program's choices, weighted by its own probabilities of them, and reports
each choice that differs from its own with the probability margin it
crossed, so that one flip near a tie does not part the two computations
downstream while a wrong rule still shows.

Everything is computed in float32 with TF32 off, every product through
``mm`` (the dense reference's, :data:`~bench.reference.dense_transformer.
MATMULS`: float32, or fp8 e4m3 for the control). The attention is computed
in blocks of :data:`Q_BLOCK` queries, each against the keys up to its end,
and the weights are widened to float32 a layer at a time and the experts
one at a time, so that the reference fits beside the program's bf16
weights at 8192 tokens. Departures from the published model: none but
those the configuration file lists (the layers cut).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from bench.reference.dense_transformer import MATMULS, rmsnorm, rope, strict_float32

Q_BLOCK = 512  # queries a block of the attention: 32 heads x 512 x 8192 float32 scores, 0.5 GiB


def attend(q, k, v, mm, block: int = Q_BLOCK):
    """Causal softmax attention in blocks of ``block`` queries: q [S, H, hd],
    k, v [S, KV, hd]; query head h reads KV head h // (H / KV)."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    kh = k.repeat_interleave(G, dim=1).permute(1, 2, 0)  # [H, hd, S]
    vh = v.repeat_interleave(G, dim=1).permute(1, 0, 2)  # [H, S, hd]
    pos = torch.arange(S, device=q.device)
    out = []
    for a in range(0, S, block):
        b = min(S, a + block)
        s = mm(q[a:b].permute(1, 0, 2), kh[:, :, :b]) * hd ** -0.5  # [H, b - a, b]
        s = s.masked_fill(pos[None, :b] > pos[a:b, None], -torch.inf)
        out.append(mm(torch.softmax(s, dim=-1), vh[:, :b]).permute(1, 0, 2))
    return torch.cat(out)


def crossings(probs, own, used):
    """The probability margin each choice of ``used`` that is not among
    ``own`` crossed: the largest probability among ``own``'s choices that
    ``used`` left out, less the choice's own. probs [T, E]; own, used
    [T, k] expert ids. 1-D, one entry a differing choice."""
    mine = torch.zeros_like(probs, dtype=torch.bool).scatter_(-1, own, True)
    given = torch.zeros_like(probs, dtype=torch.bool).scatter_(-1, used, True)
    left = torch.where(mine & ~given, probs, -torch.inf).amax(dim=-1, keepdim=True)
    return (left - probs)[given & ~mine]


def moe(cfg: dict, lp: dict, x, mm, route=None):
    """The expert layer over x [T, D] (float32): (out [T, D], the choices
    taken [T, k], the margins of those that differ from the reference's
    own). ``route`` [T, k]: the choices to take instead of its own."""
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(mm(x, lp["router"]), dim=-1)
    _, own = torch.topk(probs, k, dim=-1)
    topi = own if route is None else route.to(own.device, torch.long)
    w = probs.gather(-1, topi)
    w = w / w.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(E):
        tok, slot = torch.nonzero(topi == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(mm(xe, lp["wg"][e].float())) * mm(xe, lp["wu"][e].float())
        out.index_add_(0, tok, mm(h, lp["wd_"][e].float()) * w[tok, slot, None])
    return out, topi, crossings(probs, own, topi)


def layer_weights(tree: dict, l: int) -> dict:
    """Layer ``l``'s weights of the stacked tree: attention, norms and
    router widened to float32, the experts as stored (widened one at a
    time by :func:`moe`)."""
    b = tree["decoder"]["b0"]
    m = b["moe"]
    return {"ln_attn": b["ln_attn"][l].float(), "ln_mlp": b["ln_mlp"][l].float(),
            **{k: w[l].float() for k, w in b["attn"].items()},
            "router": m["router"][l].float(), "wg": m["wg"][l], "wu": m["wu"][l],
            "wd_": m["wd_"][l]}


def block(cfg: dict, lp: dict, h, positions, mm, route=None):
    """One layer over h [S, D]: returns (h, (k, v), (choices, margins)), k
    after its rotation, as a cache keeps it."""
    S, D = h.shape
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    x = rmsnorm(h, lp["ln_attn"], eps)
    q = mm(x, lp["wq"].reshape(D, H * hd)).reshape(S, H, hd)
    k = mm(x, lp["wk"].reshape(D, KV * hd)).reshape(S, KV, hd)
    v = mm(x, lp["wv"].reshape(D, KV * hd)).reshape(S, KV, hd)
    q, k = rope(q, positions, theta), rope(k, positions, theta)
    o = attend(q, k, v, mm).reshape(S, H * hd)
    h = h + mm(o, lp["wo"].reshape(H * hd, D))
    y, topi, margins = moe(cfg, lp, rmsnorm(h, lp["ln_mlp"], eps), mm, route)
    return h + y, (k, v), (topi, margins)


def prefill(cfg: dict, tree: dict, prompts: Sequence[torch.Tensor], precision: str = "float32",
            on_layer: Optional[Callable] = None, route_as: Optional[Sequence] = None,
            on_route: Optional[Callable] = None) -> List[torch.Tensor]:
    """The last position's float32 logits [V] of each prompt (1-D token
    ids), layer by layer over all prompts; ``on_layer(l, i, k, v)`` sees
    prompt i's K and V [S, KV, hd] of layer l as they are made. With
    ``route_as`` (prompt i's layer l choices ``route_as[i][l]``, [S, k])
    each expert layer takes the given choices; ``on_route(l, i, choices,
    margins)`` sees the choices taken and the margins crossed by those
    that differ from the reference's own (:func:`crossings`)."""
    strict_float32()
    mm = MATMULS[precision]
    emb = tree["embed"]
    hs = [emb[p.long()].float() for p in prompts]
    for l in range(cfg["num_hidden_layers"]):
        lp = layer_weights(tree, l)
        for i, h in enumerate(hs):
            pos = torch.arange(h.shape[0], device=h.device)
            route = None if route_as is None else route_as[i][l]
            hs[i], (k, v), (topi, margins) = block(cfg, lp, h, pos, mm, route)
            if on_layer is not None:
                on_layer(l, i, k, v)
            if on_route is not None:
                on_route(l, i, topi, margins)
        del lp
    w = tree["unembed"].float()
    fn = tree["final_norm"].float()
    return [mm(rmsnorm(h[-1:], fn, cfg["rms_norm_eps"]), w)[0] for h in hs]
