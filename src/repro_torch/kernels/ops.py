"""Public wrappers for the port's kernels (port of ``repro.kernels.ops``).

Each wrapper dispatches on the device of its input: a CUDA tensor launches
the hand-written kernel (or raises), a CPU tensor takes the kernel's plain
PyTorch version. There is no fallback from one to the other. A ``meta``
tensor (the dry run's data-less trace) takes the kernel's traceable op of
:mod:`repro_torch.kernels.traced`: the kernel's outputs and flop count,
nothing launched.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import tick as _tick
from repro_torch.kernels import traced as _traced


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0):
    """Prefill attention, q: [B,Sq,H,hd]; k/v: [B,Skv,KV,hd] -> [B,Sq,H,hd]:
    ``csrc/flash_attention.cu`` on CUDA tensors, :func:`~repro_torch.kernels.
    flash_attention.flash_attention_plain` on CPU tensors. ``q_offset`` is
    the absolute position of q[:, 0]. When grad is enabled and q, k or v
    requires it (training), the call goes through :class:`~repro_torch.
    kernels.flash_attention.FlashAttention`, whose backward is
    ``csrc/flash_attention_bwd.cu`` (the plain gradient on CPU tensors)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _fa.FlashAttention.apply(q, k, v, causal, window, softcap, q_offset)
    if q.device.type == "meta":
        return _traced.flash_attention(q, k, v, bool(causal), int(window), float(softcap),
                                       int(q_offset))
    fn = _fa.flash_attention_plain if q.device.type == "cpu" else _fa.flash_attention
    return fn(q, k, v, causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)


def decode_attention(q, k, v, valid_len, *, softcap=0.0):
    """One-token decode attention, q: [B,H,hd]; k/v: [B,T,KV,hd]; cache slots
    below the host int ``valid_len`` attend: ``csrc/decode_attention.cu`` on
    CUDA tensors, :func:`~repro_torch.kernels.decode_attention.
    decode_attention_plain` on CPU tensors."""
    if q.device.type == "meta":
        return _traced.decode_attention(q, k, v, int(valid_len), float(softcap))
    fn = _dec.decode_attention_plain if q.device.type == "cpu" else _dec.decode_attention
    return fn(q, k, v, valid_len, softcap=softcap)


def decode_attention_lse(q, k, v, valid_len, *, softcap=0.0):
    """One-token decode attention and each row's float32 log-sum-exp (o
    [B,H,hd], lse [B,H]; -inf where no slot is valid): the decode kernel's
    launch that also writes the row statistics on CUDA tensors,
    :func:`~repro_torch.kernels.decode_attention.decode_attention_lse_plain`
    on CPU tensors. A cache split by sequence merges its slices' outputs by
    these (``models.attention.merge_partials``)."""
    if q.device.type == "meta":
        return _traced.decode_attention_lse(q, k, v, int(valid_len), float(softcap))
    fn = (_dec.decode_attention_lse_plain if q.device.type == "cpu"
          else _dec.decode_attention_lse)
    return fn(q, k, v, valid_len, softcap=softcap)


def polca_tick(occ, bscale, row_budget, *, consts, oob_ticks, brake_ticks,
               ring_depth, esc):
    """Non-predictive POLCA tick loop (power fold + latch/ring update):
    ``csrc/tick.cu`` on CUDA tensors, :func:`~repro_torch.kernels.tick.
    polca_tick_plain` on CPU tensors. ``consts`` is a
    :class:`~repro_torch.kernels.tick.TickConsts`."""
    fn = _tick.polca_tick_plain if occ.device.type == "cpu" else _tick.polca_tick_loop
    return fn(occ, bscale, row_budget, consts, oob_ticks=oob_ticks,
              brake_ticks=brake_ticks, ring_depth=ring_depth, esc=esc)
