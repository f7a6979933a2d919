"""Plain-torch oracles for the port's kernels (port of ``repro.kernels.ref``).

* :func:`mha_reference` and :func:`decode_attention_reference` are the JAX
  package's deliberately naive attention oracles: full score matrices and
  an exact softmax, with the query offset implied by the shapes.
* :func:`ssd_reference` is the sequential Mamba2 (SSD) recurrence, one
  token after another in float32: the oracle for the chunked form of
  ``models.ssm``.
* The JAX tick reference is a ``lax.scan`` over the shared step function,
  kept apart from the Pallas kernel so a test isolates the kernel's
  plumbing. In the port the kernel's plain version already is that loop
  over the shared step (``tick._tick_body``), on the whole member block and
  with no plumbing of its own, so the reference is that function.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.kernels.tick import polca_tick_plain as polca_tick_reference

__all__ = ["mha_reference", "decode_attention_reference", "ssd_reference",
           "polca_tick_reference"]


def mha_reference(q, k, v, *, causal=True, window=0, softcap=0.0, valid_len=None):
    """q: [B,Sq,H,D]; k/v: [B,Skv,KV,D]; GQA by head grouping.

    ``q_offset`` is implied: query i sits at absolute position
    Skv - Sq + i (decode-style alignment) when Sq != Skv, else i.
    Returns [B,Sq,H,D] in q.dtype.
    """
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k.float()) * (D ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(Sq, device=q.device) + (Skv - Sq)
    t_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= t_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= t_pos[None, :] > q_pos[:, None] - window
    if valid_len is not None:
        mask &= (t_pos < valid_len)[None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention_reference(q, k, v, valid_len, *, softcap=0.0):
    """Single-token decode. q: [B,H,D]; k/v: [B,T,KV,D]; valid_len scalar."""
    o = mha_reference(q[:, None], k, v, causal=False, softcap=softcap,
                      valid_len=valid_len)
    return o[:, 0]


def ssd_reference(x, dt, A, B, C, D_skip, init_state=None):
    """Sequential SSD recurrence (the oracle for the chunked form).

    x: [Bt,S,H,P]; dt: [Bt,S,H] (post-softplus); A: [H] (negative);
    B/C: [Bt,S,G,N]; D_skip: [H]. Returns (y [Bt,S,H,P] in x.dtype,
    final_state [Bt,H,N,P] float32).
    """
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = torch.repeat_interleave(B.float(), rep, dim=2)  # [Bt,S,H,N]
    Ch = torch.repeat_interleave(C.float(), rep, dim=2)
    xf, dtf, A = x.float(), dt.float(), A.float()
    state = (torch.zeros((Bt, H, N, P), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A[None, :])  # [Bt,H]
        state = state * decay[:, :, None, None] + torch.einsum(
            "bhn,bh,bhp->bhnp", Bh[:, t], dtf[:, t], xf[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    y = torch.stack(ys, dim=1) + D_skip.float()[None, None, :, None] * xf
    return y.to(x.dtype), state
