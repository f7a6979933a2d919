"""Attention: GQA, sliding-window prefill and ring-buffer decode, logit
softcap, qk-norm, the encoder's bidirectional self attention and the
decoder's cross-attention (PyTorch port of ``repro.models.attention``).

The JAX model attends through its XLA path (``_chunk_scores``) and leaves
the Pallas kernels to the TPU target. The port does what the JAX package
intends for its target: its attention *is* the kernel. Prefill calls
``ops.flash_attention`` and decode ``ops.decode_attention``, which launch
the hand-written CUDA kernels on the card and take their plain PyTorch
versions on the CPU. Public layouts are the JAX package's: ``wq [D,H,hd]``,
``wk/wv [D,KV,hd]``, ``wo [H,hd,D]``, caches ``[B,T,KV,hd]``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm, rope
from repro_torch.models.param import ParamSpec


def attn_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    D, KV, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    H = cfg.padded_heads  # zero-padded wo rows: exact outputs
    wd = cfg.weight_dtype
    p = {
        "wq": ParamSpec((D, H, hd), ("embed", "heads", "head_dim"), dtype=wd),
        "wk": ParamSpec((D, KV, hd), ("embed", "kv_heads", "head_dim"), dtype=wd),
        "wv": ParamSpec((D, KV, hd), ("embed", "kv_heads", "head_dim"), dtype=wd),
        "wo": ParamSpec((H, hd, D), ("heads", "head_dim", "embed"),
                        init="zeros" if H != cfg.num_heads else "normal", dtype=wd),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = ParamSpec((hd,), ("head_dim",), init="ones", dtype=wd)
        p["k_norm"] = ParamSpec((hd,), ("head_dim",), init="ones", dtype=wd)
    return p


def _project_q(cfg, p, x, positions):
    dt = cfg.activation_dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    if cfg.use_rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
    return q


def _project_kv(cfg, p, x, positions):
    dt = cfg.activation_dtype
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if "k_norm" in p:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope and positions is not None:
        k = rope(k, positions, cfg.rope_theta)
    return k, v


def _out_proj(cfg, p, out):
    """[B, S, H, hd] @ wo [H, hd, D] -> [B, S, D]."""
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cfg.activation_dtype))


def self_attention(cfg: ModelConfig, p: dict, x, *, positions, causal: bool,
                   window: int = 0, return_kv: bool = False):
    """Full-sequence self attention: the decoder's prefill (causal), the
    encoder's (``causal=False``: every position attends every other).
    x: [B, S, D]; positions: [S]."""
    q = _project_q(cfg, p, x, positions)
    k, v = _project_kv(cfg, p, x, positions)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cfg.attn_logit_softcap, q_offset=0)
    y = _out_proj(cfg, p, out)
    if return_kv:
        return y, (k, v)
    return y


def cross_attention(cfg: ModelConfig, p: dict, x, enc_kv):
    """Decoder cross-attention over the encoder's K/V (no mask, no RoPE).

    x: [B, Sq, D]; enc_kv: (k, v), each [B, enc_S, KV, hd]. Every query
    attends every encoder position: the flash kernel with ``causal=False``
    over Sq decoder positions, or for one position (a decode step) the
    decode kernel at ``valid_len = enc_S``. Returns [B, Sq, D]."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cfg.activation_dtype))
    k, v = enc_kv
    if q.shape[1] == 1:
        out = ops.decode_attention(q[:, 0], k, v, k.shape[1],
                                   softcap=cfg.attn_logit_softcap)[:, None]
    else:
        out = ops.flash_attention(q, k, v, causal=False,
                                  softcap=cfg.attn_logit_softcap)
    return _out_proj(cfg, p, out)


def project_cross_kv(cfg: ModelConfig, p: dict, enc_out):
    """The cross-attention K/V of the encoder output [B, enc_S, D]: (k, v),
    each [B, enc_S, KV, hd], without RoPE."""
    return _project_kv(cfg, p, enc_out, None)


def decode_self_attention(cfg: ModelConfig, p: dict, x, cache_k, cache_v,
                          pos: int, *, window: int = 0):
    """Single-token decode against a KV cache.

    x: [B, 1, D]; cache_k/v: [B, T, KV, hd]; ``pos`` is a host int (tokens
    0..pos-1 are valid; the new token is written at slot ``pos``). The new
    K/V are written into the cache *in place*, where the JAX function
    returns an updated copy through ``dynamic_update_slice``: the cache is
    the only copy of that state, so nothing is lost, and a full cache copy
    per layer and step is saved. A ``window`` W makes no difference here:
    the served model takes this path for a LOCAL block only when its cache
    is shorter than W (``max_len < W``), so ``pos < W`` and the JAX mask
    ``t > pos - W`` keeps every slot ``0 .. pos``. Returns (y [B,1,D],
    cache_k, cache_v).
    """
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = _project_q(cfg, p, x, positions)
    k_new, v_new = _project_kv(cfg, p, x, positions)
    cache_k[:, pos] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v_new[:, 0].to(cache_v.dtype)
    out = ops.decode_attention(q[:, 0], cache_k.to(q.dtype), cache_v.to(q.dtype),
                               pos + 1, softcap=cfg.attn_logit_softcap)
    return _out_proj(cfg, p, out[:, None]), cache_k, cache_v


def decode_ring_attention(cfg: ModelConfig, p: dict, x, cache_k, cache_v,
                          pos: int, window: int):
    """Single-token decode against a ring-buffer KV cache of ``window`` = W
    slots (a LOCAL block's), in place.

    The new token's K/V (RoPE applied at its absolute position ``pos``
    before caching, so the ring's rotation is transparent) go to slot
    ``pos mod W``. The JAX function then masks slot i by the absolute
    position it holds, ``pos - ((pos - i) mod W)``, attending it iff that is
    in ``[0, pos]``: every slot once ``pos >= W``, slots ``i <= pos`` before.
    So the valid slots are exactly ``i < valid_len = min(pos + 1, W)``, and
    since attention is a sum over keys their order does not matter: this is
    the plain decode attention over the first ``valid_len`` slots, the same
    kernel as :func:`decode_self_attention`. Returns (y [B,1,D], cache_k,
    cache_v).
    """
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = _project_q(cfg, p, x, positions)
    k_new, v_new = _project_kv(cfg, p, x, positions)
    slot = pos % window
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    out = ops.decode_attention(q[:, 0], cache_k.to(q.dtype), cache_v.to(q.dtype),
                               min(pos + 1, window), softcap=cfg.attn_logit_softcap)
    return _out_proj(cfg, p, out[:, None]), cache_k, cache_v
