"""Mamba2 (SSD, state-space duality) blocks — chunked matmul form + decode
step (PyTorch port of ``repro.models.ssm``).

The chunked SSD forward (quadratic within a chunk, linear state passing
across chunks; arXiv:2405.21060) is the reference's einsums in the same
order, in plain PyTorch: the JAX package runs it in XLA, with no Pallas
kernel. :func:`ssd_chunked` is its core, apart from the projections and
the convolution, so that it can be held against the sequential oracle
``repro_torch.kernels.ref.ssd_reference`` and timed alone. The decode step
is that recurrence for one token.

Shapes: d_inner = expand * d_model, H = d_inner // headdim heads, G groups
sharing (B, C) projections of state size N. The state, B, C and dt are
float32.

Over a mesh (a ``MeshCtx``, ``ctx``) the weights are a rank's blocks: the
rules split ``w_z``, ``w_x``, ``conv_x``, ``gate_norm`` and ``w_out``'s
input dim on ``ssm_inner``, and ``w_dt``, ``dt_bias``, ``A_log`` and
``D_skip`` on ``ssm_heads``, both over ``model``; ``w_B``, ``w_C`` and their
convolutions are replicated. Each rank runs the SSD on its own heads (each
reading the (B, C) group of its global index, :func:`ssm_layout`), the gate
norm takes its mean square over the whole ``d_inner`` by an all-reduce of
the ranks' sums of squares, and ``w_out``'s split contraction is
all-reduced. The cache's state is split on its heads and ``conv_x`` on its
channels, as the weights are.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.models.param import ParamSpec
from repro_torch.parallel import collectives as coll


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_headdim
    return d_in, H, cfg.ssm_n_groups, cfg.ssm_d_state


def ssm_specs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    d_in, H, G, N = ssm_dims(cfg)
    W = cfg.ssm_conv_width
    wd = cfg.weight_dtype
    return {
        "w_z": ParamSpec((D, d_in), ("embed", "ssm_inner"), dtype=wd),
        "w_x": ParamSpec((D, d_in), ("embed", "ssm_inner"), dtype=wd),
        "w_B": ParamSpec((D, G * N), ("embed", None), dtype=wd),
        "w_C": ParamSpec((D, G * N), ("embed", None), dtype=wd),
        "w_dt": ParamSpec((D, H), ("embed", "ssm_heads"), dtype=wd),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), init="ssm_dt", dtype=wd),
        "A_log": ParamSpec((H,), ("ssm_heads",), init="ssm_a", dtype=wd),
        "D_skip": ParamSpec((H,), ("ssm_heads",), init="ones", dtype=wd),
        "conv_x": ParamSpec((W, d_in), ("conv", "ssm_inner"), scale=1.0, dtype=wd),
        "conv_B": ParamSpec((W, G * N), ("conv", None), dtype=wd),
        "conv_C": ParamSpec((W, G * N), ("conv", None), dtype=wd),
        "gate_norm": ParamSpec((d_in,), ("ssm_inner",), init="ones", dtype=wd),
        "w_out": ParamSpec((d_in, D), ("ssm_inner", "embed"), dtype=wd),
    }


def ssm_layout(cfg: ModelConfig, ctx):
    """(heads group, B/C group slice) of a rank over a mesh: the group
    splitting the SSM's heads and inner channels (None: not split), and the
    slice of the G (B, C) groups its heads read, head h reading group
    ``h // (H / G)`` of its global index."""
    if ctx is None:
        return None, slice(None)
    return ctx.memo_cfg("ssm", cfg, lambda: _ssm_layout(cfg, ctx))


def _ssm_layout(cfg: ModelConfig, ctx):
    d_in, H, G, _ = ssm_dims(cfg)
    hg = ctx.group(ctx.axes_for(H, "ssm_heads"))
    ig = ctx.group(ctx.axes_for(d_in, "ssm_inner"))
    if (hg and hg.axes) != (ig and ig.axes):
        raise NotImplementedError(f"{cfg.name}: SSM heads split over {hg and hg.axes}, "
                                  f"inner channels over {ig and ig.axes}")
    if hg is None:
        return None, slice(None)
    n, rep = H // hg.size, H // G
    if n % rep and rep % n:
        raise NotImplementedError(f"{cfg.name}: {n} SSM heads a rank against groups of {rep}")
    h0 = hg.index * n
    return hg, slice(h0 // rep, (h0 + n - 1) // rep + 1)


def _repeat(x, rep: int, dim: int):
    """``jnp.repeat(x, rep, axis=dim)``: each entry along ``dim`` ``rep``
    times in a row, as a broadcast view flattened; ``torch.repeat_interleave``
    may read its output size back from the card, which stalls the host."""
    dim %= x.ndim
    shape = x.shape[:dim + 1] + (rep,) + x.shape[dim + 1:]
    return x.unsqueeze(dim + 1).expand(shape).flatten(dim, dim + 1)


def _causal_conv(x, w, tail=None):
    """Depthwise causal conv along S. x: [B,S,C]; w: [W,C]; tail: [B,W-1,C]
    carried state for decode/continuation. Returns (y, new_tail). The W taps
    are added in order, each product rounded in ``x.dtype``, as the
    reference's ``sum`` adds them."""
    W, S = w.shape[0], x.shape[1]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    y = xp[:, 0:S] * w[0][None, None, :]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i][None, None, :]
    return y, xp[:, xp.shape[1] - (W - 1):]


def _project(cfg, p, x):
    dt_ = cfg.activation_dtype
    z = x @ p["w_z"].to(dt_)
    xin = x @ p["w_x"].to(dt_)
    Bm = x @ p["w_B"].to(dt_)
    Cm = x @ p["w_C"].to(dt_)
    dt_raw = (x @ p["w_dt"].to(dt_)).float() + p["dt_bias"].float()
    dt = torch.logaddexp(dt_raw, torch.zeros_like(dt_raw))  # jax.nn.softplus
    return z, xin, Bm, Cm, dt


def _conv_all(cfg, p, xin, Bm, Cm, tails):
    """The three causal convolutions and their SiLU; returns (xin, Bm, Cm,
    new tails {"x", "B", "C"})."""
    act = cfg.activation_dtype
    out, new = [], {}
    for name, a in (("x", xin), ("B", Bm), ("C", Cm)):
        y, new[name] = _causal_conv(a, p[f"conv_{name}"].to(act),
                                    None if tails is None else tails[name])
        out.append(F.silu(y))
    return (*out, new)


def _gate_out(cfg, p, y, z, group=None):
    """The gated norm and ``w_out``; with ``group`` (the heads' group) the
    norm's mean square and the product's contraction are summed over it."""
    y = rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps, group)
    return coll.all_reduce(y @ p["w_out"].to(cfg.activation_dtype), group)


def ssd_chunked(X, dt, A, Bm, Cm, D_skip, Q: int, init_state=None):
    """The chunked SSD over S = c * Q steps. X: [B,S,H,P]; dt: [B,S,H]
    float32 (post-softplus); A: [H] float32 (negative); Bm/Cm: [B,S,G,N]
    float32; D_skip: [H]. Returns (Y [B,S,H,P] float32, final state
    [B,H,N,P] float32)."""
    B_, S, H, P = X.shape
    G, N = Bm.shape[2], Bm.shape[3]
    C_ = S // Q
    X = X.reshape(B_, C_, Q, H, P)
    Bm = Bm.reshape(B_, C_, Q, G, N)
    Cm = Cm.reshape(B_, C_, Q, G, N)
    dt = dt.reshape(B_, C_, Q, H)
    dA = dt * A[None, None, None, :]  # [B,c,Q,H]
    cs = torch.cumsum(dA, dim=2)  # inclusive

    rep = H // G
    Xf = X.float()

    # --- intra-chunk (quadratic within chunk) ------------------------------
    # L[q,k] = exp(cs[q]-cs[k]) for q>=k else 0. The exponent is masked
    # before the exp (-inf: exp gives 0), where the reference masks the
    # exp's output: the same values, but above the diagonal cs[q] - cs[k]
    # is a sum of |dt A| that overflows float32's exp at full width, and
    # its gradient there, 0 * inf, would be NaN
    Lexp = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # [B,c,Q,Q,H] (q,k)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=X.device))
    L = torch.exp(torch.where(tri[None, None, :, :, None], Lexp, -torch.inf))
    CB = torch.einsum("bcqgn,bckgn->bcqkg", Cm, Bm)  # [B,c,Q,Q,G]
    CB = _repeat(CB, rep, -1)  # [B,c,Q,Q,H]
    M = CB * L * dt[:, :, None, :, :]  # weight for input k at query q
    Y = torch.einsum("bcqkh,bckhp->bcqhp", M, Xf)

    # --- chunk states -------------------------------------------------------
    decay_states = torch.exp(cs[:, :, -1:, :] - cs)  # [B,c,Q,H]
    Bh = _repeat(Bm, rep, 3)  # [B,c,Q,H,N]
    states = torch.einsum("bckhn,bckh,bckhp->bchnp", Bh, decay_states * dt, Xf)

    # --- inter-chunk recurrence ---------------------------------------------
    chunk_decay = torch.exp(cs[:, :, -1, :])  # [B,c,H]
    s = (torch.zeros((B_, H, N, P), dtype=torch.float32, device=X.device)
         if init_state is None else init_state.float())
    prev = []
    for c in range(C_):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # [B,c,H,N,P] state at chunk starts

    Ch = _repeat(Cm, rep, 3)  # [B,c,Q,H,N]
    Y = Y + torch.einsum("bcqhn,bchnp->bcqhp", Ch * torch.exp(cs)[..., None], prev_states)

    # --- skip -------------------------------------------------------------------
    Y = Y + D_skip.float()[None, None, None, :, None] * Xf
    return Y.reshape(B_, S, H, P), s


def _local_dims(cfg, p, ctx):
    """(heads group, B/C group slice, d_inner, H, G, N) of the rank's
    blocks ``p`` (the whole model's with no mesh)."""
    _, _, G, N = ssm_dims(cfg)
    hg, gs = ssm_layout(cfg, ctx)
    H = p["w_dt"].shape[-1]
    d_in = p["w_x"].shape[-1]
    if d_in != H * cfg.ssm_headdim:
        raise ValueError(f"{cfg.name}: {d_in} inner channels for {H} SSM heads")
    return hg, gs, d_in, H, G, N


def ssm_forward(cfg: ModelConfig, p: dict, x, *, init_state=None, conv_tails=None,
                return_state: bool = False, ctx=None):
    """Full-sequence SSD. x: [B,S,D]. Returns y [B,S,D] (+ (ssm_state,
    conv_tail {"x", "B", "C"})). Over a mesh ``p`` and the state are the
    rank's heads, ``x`` and ``y`` whole."""
    B_, S, D = x.shape
    hg, gs, d_in, H, G, N = _local_dims(cfg, p, ctx)
    P = cfg.ssm_headdim
    act = cfg.activation_dtype

    z, xin, Bm, Cm, dt = _project(cfg, p, x)
    xin, Bm, Cm, tails = _conv_all(cfg, p, xin, Bm, Cm, conv_tails)

    # Pad S up to a chunk multiple. Padded steps get dt=0: decay exp(0)=1 and
    # zero input contribution, so the final state is exact.
    Q = min(cfg.ssm_chunk, S)
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        xin, Bm, Cm, dt = (F.pad(a, (0, 0, 0, pad)) for a in (xin, Bm, Cm, dt))
        S = S + pad

    A = -torch.exp(p["A_log"].float())  # [H]
    Y, final_state = ssd_chunked(
        xin.reshape(B_, S, H, P), dt, A, Bm.reshape(B_, S, G, N)[:, :, gs].float(),
        Cm.reshape(B_, S, G, N)[:, :, gs].float(), p["D_skip"], Q, init_state)
    y = Y.reshape(B_, S, d_in)[:, :S_orig].to(act)
    out = _gate_out(cfg, p, y, z, hg)
    if return_state:
        return out, (final_state, tails)
    return out


def ssm_decode(cfg: ModelConfig, p: dict, x, state, conv_tails, ctx=None):
    """One-token recurrence. x: [B,1,D]; state: [B,H,N,P] fp32. Returns
    (y [B,1,D], (new state, new conv tails)). Over a mesh ``p``, the state
    and ``conv_x``'s tail are the rank's heads and channels."""
    B_, _, D = x.shape
    hg, gs, d_in, H, G, N = _local_dims(cfg, p, ctx)
    P = cfg.ssm_headdim
    act = cfg.activation_dtype

    z, xin, Bm, Cm, dt = _project(cfg, p, x)
    xin, Bm, Cm, tails = _conv_all(cfg, p, xin, Bm, Cm, conv_tails)

    X = xin.reshape(B_, H, P).float()
    Bm = Bm.reshape(B_, G, N)[:, gs].float()
    Cm = Cm.reshape(B_, G, N)[:, gs].float()
    dt = dt.reshape(B_, H)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A[None, :])  # [B,H]

    rep = H // Bm.shape[1]
    Bh = _repeat(Bm, rep, 1)  # [B,H,N]
    Ch = _repeat(Cm, rep, 1)
    state = state * dA[:, :, None, None] + torch.einsum("bhn,bh,bhp->bhnp", Bh, dt, X)
    y = torch.einsum("bhn,bhnp->bhp", Ch, state)
    y = y + p["D_skip"].float()[None, :, None] * X
    y = y.reshape(B_, 1, d_in).to(act)
    return _gate_out(cfg, p, y, z, hg), (state, tails)
