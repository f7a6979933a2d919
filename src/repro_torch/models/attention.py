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

Over a mesh (a ``MeshCtx``, ``ctx``) the weights are a rank's working
blocks: its query heads, and its KV heads or, where the model axis does not
divide them, all of them (:func:`head_layout`). The kernels run on the
rank's heads, ``wo``'s split contraction is all-reduced, and decode over a
sequence-split cache (a global block's, or a LOCAL block's ring) merges
each rank's partial result by its log-sum-exp. The cross attention's K/V
are split on their KV heads as its weights are.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm, rope
from repro_torch.models.param import ParamSpec
from repro_torch.parallel import collectives as coll


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


def head_layout(cfg: ModelConfig, ctx):
    """(heads group, KV heads group, KV slice) of a rank over a mesh: the
    groups splitting the query and KV heads (None: not split), and the
    slice of the projected KV heads its query heads read. Where the model
    axis splits the query heads but not the KV heads (the GQA fallback:
    they are replicated), that is the KV heads of the rank's query heads:
    ``h // G`` for its heads h, G = H / KV."""
    if ctx is None:
        return None, None, slice(None)
    return ctx.memo_cfg("heads", cfg, lambda: _head_layout(cfg, ctx))


def _head_layout(cfg: ModelConfig, ctx):
    H, KV = cfg.padded_heads, cfg.num_kv_heads
    hg = ctx.group(ctx.axes_for(H, "heads"))
    kg = ctx.group(ctx.axes_for(KV, "kv_heads"))
    if hg is None or kg is not None:
        return hg, kg, slice(None)
    n, G = H // hg.size, H // KV
    if n % G and G % n:
        raise NotImplementedError(f"{cfg.name}: {n} query heads a rank against groups "
                                  f"of {G}")
    h0 = hg.index * n
    return hg, kg, slice(h0 // G, (h0 + n - 1) // G + 1)


def self_attention(cfg: ModelConfig, p: dict, x, *, positions, causal: bool,
                   window: int = 0, return_kv: bool = False, ctx=None):
    """Full-sequence self attention: the decoder's prefill (causal), the
    encoder's (``causal=False``: every position attends every other).
    x: [B, S, D]; positions: [S]. Over a mesh the returned K/V hold every
    KV head (gathered where the model axis splits them)."""
    q = _project_q(cfg, p, x, positions)
    k, v = _project_kv(cfg, p, x, positions)
    hg, kg, kv = head_layout(cfg, ctx)
    out = ops.flash_attention(q, k[:, :, kv], v[:, :, kv], causal=causal, window=window,
                              softcap=cfg.attn_logit_softcap, q_offset=0)
    y = _out_proj(cfg, p, out)
    if ctx is not None:
        y = coll.all_reduce(y, hg)
    if return_kv:
        if ctx is not None:
            k, v = coll.all_gather(k, kg, 2), coll.all_gather(v, kg, 2)
        return y, (k, v)
    return y


def cross_attention(cfg: ModelConfig, p: dict, x, enc_kv, ctx=None):
    """Decoder cross-attention over the encoder's K/V (no mask, no RoPE).

    x: [B, Sq, D]; enc_kv: (k, v), each [B, enc_S, KV, hd]. Every query
    attends every encoder position: the flash kernel with ``causal=False``
    over Sq decoder positions, or for one position (a decode step) the
    decode kernel at ``valid_len = enc_S``. Returns [B, Sq, D]. Over a mesh
    ``p`` and ``enc_kv`` hold the rank's heads (:func:`project_cross_kv`),
    each query head attends the KV heads it reads, and ``wo``'s split
    contraction is all-reduced."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cfg.activation_dtype))
    hg, _, kv = head_layout(cfg, ctx)
    k, v = enc_kv[0][:, :, kv], enc_kv[1][:, :, kv]
    if q.shape[1] == 1:
        out = ops.decode_attention(q[:, 0], k, v, k.shape[1],
                                   softcap=cfg.attn_logit_softcap)[:, None]
    else:
        out = ops.flash_attention(q, k, v, causal=False,
                                  softcap=cfg.attn_logit_softcap)
    return coll.all_reduce(_out_proj(cfg, p, out), hg)


def project_cross_kv(cfg: ModelConfig, p: dict, enc_out):
    """The cross-attention K/V of the encoder output [B, enc_S, D]: (k, v),
    each [B, enc_S, KV, hd], without RoPE. Over a mesh, the KV heads of the
    rank's ``wk``/``wv`` blocks: its own where the rules split them, else
    all of them (the GQA fallback), as the cross cache holds them."""
    return _project_kv(cfg, p, enc_out, None)


def decode_self_attention(cfg: ModelConfig, p: dict, x, cache_k, cache_v,
                          pos: int, *, window: int = 0, ctx=None,
                          n_slots: Optional[int] = None):
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

    Over a mesh (``ctx``) the weights and the cache are a rank's blocks
    (:func:`_decode_cached`; ``n_slots`` the cache's slots over the mesh).
    """
    return _decode_cached(cfg, p, x, cache_k, cache_v, pos, pos, pos + 1, ctx, n_slots)


def merge_partials(o, lse, group: Optional[coll.Group]):
    """The attention over the union of the group's cache slices from each
    slice's output ``o`` [B, H, hd] and log-sum-exp ``lse`` [B, H] (-inf
    for a slice with no valid slot, which adds zero weight): the outputs
    weighted by exp(lse - max lse) and normalised, in float32. Returns o's
    dtype."""
    if group is None:
        return o
    m = coll.all_reduce_max(lse, group)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)[..., None]
    acc = coll.all_reduce(torch.cat([o.float() * w, w], dim=-1), group)
    return (acc[..., :-1] / acc[..., -1:]).to(o.dtype)


def decode_ring_attention(cfg: ModelConfig, p: dict, x, cache_k, cache_v,
                          pos: int, window: int, ctx=None,
                          n_slots: Optional[int] = None):
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

    Over a mesh whose rules split the ring by sequence (``kv_seq``), rank r
    holds slots ``[r W_l, (r + 1) W_l)``; the valid slots are a prefix of
    the ring, so each slice's are a prefix of the slice, and the slices
    merge by their log-sum-exps (:func:`_decode_cached`).
    """
    return _decode_cached(cfg, p, x, cache_k, cache_v, pos, pos % window,
                          min(pos + 1, window), ctx, n_slots)


def _decode_cached(cfg: ModelConfig, p: dict, x, cache_k, cache_v, pos: int, slot: int,
                   n_valid: int, ctx, n_slots: Optional[int] = None):
    """One decode step of the token at position ``pos`` whose K/V go to
    cache slot ``slot``, attending the first ``n_valid`` slots, in place.

    Over a mesh (``ctx``) the weights and the cache are a rank's blocks.
    The new token's K/V (every KV head) go to the rank whose cache slice
    holds ``slot``. Where the rules split the cache by sequence, each rank
    attends its slice for every query head (the query gathered over the
    heads' group) at its own valid length ``clamp(n_valid - r T, 0, T)``
    (slice r of T slots) through ``ops.decode_attention_lse``, the slices
    are merged (:func:`merge_partials`) and the rank keeps its own heads;
    else its heads attend the KV heads they read in the whole cache.
    The group splitting the slots is the one the rules give ``n_slots``,
    the cache's slots over the mesh (a rank's T slots alone would not say
    whether the rules split them)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = _project_q(cfg, p, x, positions)[:, 0]
    k_new, v_new = _project_kv(cfg, p, x, positions)
    hg, kg, kv = head_layout(cfg, ctx)
    T = cache_k.shape[1]
    seq = None if ctx is None else ctx.group(ctx.axes_for(n_slots, "kv_seq"))
    t0 = (seq.index if seq else 0) * T
    k_new, v_new = coll.all_gather(k_new, kg, 2), coll.all_gather(v_new, kg, 2)
    if t0 <= slot < t0 + T:
        cache_k[:, slot - t0] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, slot - t0] = v_new[:, 0].to(cache_v.dtype)
    valid = min(max(n_valid - t0, 0), T)
    ck, cv = cache_k.to(q.dtype), cache_v.to(q.dtype)
    cap = cfg.attn_logit_softcap
    if ctx is None:
        out = ops.decode_attention(q, ck, cv, valid, softcap=cap)
    elif seq is None:
        out, _ = ops.decode_attention_lse(q, ck[:, :, kv], cv[:, :, kv], valid, softcap=cap)
    else:
        out, lse = ops.decode_attention_lse(coll.all_gather(q, hg, 1), ck, cv, valid,
                                            softcap=cap)
        out = merge_partials(out, lse, seq)
        if hg is not None:
            n = out.shape[1] // hg.size
            out = out[:, hg.index * n:(hg.index + 1) * n]
    return coll.all_reduce(_out_proj(cfg, p, out[:, None]), hg), cache_k, cache_v
