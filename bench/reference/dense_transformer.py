"""Plain reference of a dense transformer configuration (``bench/configs``):
pre-norm blocks of RMSNorm, self attention with rotary positions over the
whole head, a tanh-GELU MLP, residual adds; then a final RMSNorm and the
head. A causal decoder is served by its prefill (the last position's
logits and every layer's K and V); an encoder is trained on the
cross-entropy of every position, with AdamW.

Everything is computed in float32 with TF32 off, one product at a time
through ``mm``; :func:`fp8_mm` is the same products with both operands
rounded to float8 e4m3 (a scale a tensor), the precision one step below
the configurations' bf16, which the benchmark's control computes in. The
weights are the tree of ``bench/weights.py``, read as they are stored and
widened to float32 a layer at a time, so that the reference fits beside
the program's weights.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def strict_float32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def f32_mm(a, b):
    return torch.matmul(a.float(), b.float())


def q8(x):
    """``x`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to the format's largest value, back in float32."""
    x = x.float()
    scale = FP8_MAX / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8MatMul(torch.autograd.Function):
    """A product whose operands, and in the backward the incoming gradient,
    are rounded to float8 e4m3 before float32 arithmetic."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(q8(a), q8(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = q8(g)
        return (torch.matmul(g8, q8(b).transpose(-1, -2)),
                torch.matmul(q8(a).transpose(-1, -2), g8))


def fp8_mm(a, b):
    return _Fp8MatMul.apply(a.float(), b.float())


MATMULS: Dict[str, Callable] = {"float32": f32_mm, "fp8": fp8_mm}


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, positions, theta: float):
    """Rotary embedding over the whole head: x [..., S, H, hd], the two
    halves of the head rotated by position * theta^(-i / half)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def attend(q, k, v, causal: bool, mm):
    """Softmax attention on the whole score matrix: q [B, S, H, hd], k, v
    [B, S, KV, hd]; query head h reads KV head h // (H / KV)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qh = q.permute(0, 2, 1, 3)  # [B, H, S, hd]
    kh = k.repeat_interleave(G, dim=2).permute(0, 2, 3, 1)  # [B, H, hd, S]
    vh = v.repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    s = mm(qh, kh) * hd ** -0.5
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return mm(p, vh).permute(0, 2, 1, 3)


def layer_weights(tree: dict, l: int) -> dict:
    """Layer ``l``'s weights of the stacked tree, widened to float32."""
    b = tree["decoder"]["b0"]
    return {"ln_attn": b["ln_attn"][l].float(), "ln_mlp": b["ln_mlp"][l].float(),
            **{k: w[l].float() for k, w in b["attn"].items()},
            **{k: w[l].float() for k, w in b["mlp"].items()}}


def block(cfg: dict, lp: dict, h, positions, mm):
    """One layer over h [B, S, D]: returns (h, (k, v)), k after its
    rotation, as a cache keeps it."""
    B, S, D = h.shape
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps, theta = cfg["layer_norm_eps"], cfg["rotary_emb_base"]
    x = rmsnorm(h, lp["ln_attn"], eps).reshape(B * S, D)
    q = mm(x, lp["wq"].reshape(D, H * hd)).reshape(B, S, H, hd)
    k = mm(x, lp["wk"].reshape(D, KV * hd)).reshape(B, S, KV, hd)
    v = mm(x, lp["wv"].reshape(D, KV * hd)).reshape(B, S, KV, hd)
    q, k = rope(q, positions, theta), rope(k, positions, theta)
    o = attend(q, k, v, cfg["causal"], mm).reshape(B * S, H * hd)
    h = h + mm(o, lp["wo"].reshape(H * hd, D)).reshape(B, S, D)
    x = rmsnorm(h, lp["ln_mlp"], eps).reshape(B * S, D)
    h = h + mm(gelu_tanh(mm(x, lp["w_up"])), lp["w_down"]).reshape(B, S, D)
    return h, (k, v)


def head_weight(cfg: dict, tree: dict):
    return tree["unembed" if cfg["causal"] else "mlm_head"]


def prefill(cfg: dict, tree: dict, prompts: Sequence[torch.Tensor], precision: str = "float32",
            on_layer: Optional[Callable] = None) -> List[torch.Tensor]:
    """The last position's float32 logits [V] of each prompt (1-D token
    ids), layer by layer over all prompts; ``on_layer(l, i, k, v)`` sees
    prompt i's K and V [S, KV, hd] of layer l as they are made."""
    strict_float32()
    mm = MATMULS[precision]
    emb = tree["embed"]
    hs = [emb[p.long()].float()[None] for p in prompts]
    for l in range(cfg["num_hidden_layers"]):
        lp = layer_weights(tree, l)
        for i, h in enumerate(hs):
            pos = torch.arange(h.shape[1], device=h.device)
            hs[i], (k, v) = block(cfg, lp, h, pos, mm)
            if on_layer is not None:
                on_layer(l, i, k[0], v[0])
        del lp
    eps = cfg["layer_norm_eps"]
    w = head_weight(cfg, tree).float()
    fn = tree["final_norm"].float()
    return [mm(rmsnorm(h[0, -1:], fn, eps), w)[0] for h in hs]


def loss(cfg: dict, params: dict, tokens, targets, mm):
    """Mean cross-entropy of every position: tokens, targets [B, S]."""
    B, S = tokens.shape
    D, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
    h = params["embed"][tokens.long()].float()
    pos = torch.arange(S, device=tokens.device)
    b = params["decoder"]["b0"]
    for l in range(cfg["num_hidden_layers"]):
        lp = {"ln_attn": b["ln_attn"][l], "ln_mlp": b["ln_mlp"][l],
              **{k: w[l] for k, w in b["attn"].items()},
              **{k: w[l] for k, w in b["mlp"].items()}}
        h, _ = block(cfg, lp, h, pos, mm)
    h = rmsnorm(h, params["final_norm"], eps).reshape(B * S, D)
    logits = mm(h, head_weight(cfg, params))
    gold = torch.gather(logits, 1, targets.reshape(-1, 1).long())[:, 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)


def loss_and_grads(cfg: dict, params: dict, tokens, targets, micro: int, precision: str):
    """(loss, gradients) of float32 ``params`` (a tree of leaves) on the
    batch, the gradients summed over micro-batches of ``micro`` rows, each
    weighted by its share of the batch."""
    strict_float32()
    mm = MATMULS[precision]
    flat = [p for _, p in _leaves(params)]
    leaves = [p.detach().requires_grad_() for p in flat]
    tree = _rebuild(params, iter(leaves))
    B = tokens.shape[0]
    total = 0.0
    for i in range(0, B, micro):
        part = loss(cfg, tree, tokens[i:i + micro], targets[i:i + micro], mm)
        (part * (tokens[i:i + micro].shape[0] / B)).backward()
        total += part.item() * tokens[i:i + micro].shape[0] / B
    grads = _rebuild(params, iter([p.grad for p in leaves]))
    return total, grads


def adamw(params: dict, grads: dict, state: Optional[dict], opt: dict):
    """One AdamW step of float32 trees, the configuration's settings: the
    gradients scaled by min(1, clip / (norm + 1e-9)), the moments, bias
    corrections, and the decoupled weight decay added to the step.
    Returns (params, state, the clipped gradients)."""
    lr, b1, b2, eps, wd = opt["lr"], opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    g_leaves = [g for _, g in _leaves(grads)]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in g_leaves))
    scale = torch.clamp(opt["grad_clip"] / (norm + 1e-9), max=1.0)
    g_leaves = [g * scale for g in g_leaves]
    p_leaves = [p for _, p in _leaves(params)]
    if state is None:
        state = {"t": 0, "mu": [torch.zeros_like(p) for p in p_leaves],
                 "nu": [torch.zeros_like(p) for p in p_leaves]}
    t = state["t"] + 1
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    new_p, mus, nus = [], [], []
    for p, g, mu, nu in zip(p_leaves, g_leaves, state["mu"], state["nu"]):
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        new_p.append(p - lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps) + wd * p))
        mus.append(mu)
        nus.append(nu)
    return (_rebuild(params, iter(new_p)), {"t": t, "mu": mus, "nu": nus},
            _rebuild(params, iter(g_leaves)))


def _leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _rebuild(like, it):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    return next(it)
