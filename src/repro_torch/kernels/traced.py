"""The attention kernels as operators a data-less trace can follow.

The dry run (``launch.dryrun``) traces a step on ``meta`` tensors, which
hold no data: a kernel cannot be launched on them, and the plain versions
would make the float32 [B, H, Sq, Skv] scores, which the kernels never
write (at a 32k-token prefill, hundreds of GB). So on ``meta`` tensors
``ops.flash_attention``, ``ops.decode_attention`` and
:class:`~repro_torch.kernels.flash_attention.FlashAttention` call these
``torch.library`` custom ops instead:

* ``repro_torch::flash_attention``: the prefill kernel;
* ``repro_torch::flash_attention_lse``: the training forward (with the
  row log-sum-exp);
* ``repro_torch::flash_attention_bwd``: the gradient kernels;
* ``repro_torch::decode_attention``: the decode kernel;
* ``repro_torch::decode_attention_lse``: the decode kernel with the row
  log-sum-exp (a sequence-split cache's slices).

Each op's fake (``register_fake``) gives outputs of the kernel's shapes and
dtypes and allocates nothing else, and each has a flop formula
(``register_flop_formula``), so ``torch.utils.flop_counter.FlopCounterMode``
counts each kernel as ``chip_smoke.py``'s bounds count it: 4 B H hd flops an
attended (query, key) pair forward (two products), 10 for the backward's
five products, 4 B H hd valid_len for decode.

CUDA and CPU tensors never reach these ops: the wrappers launch the kernels
or run the plain versions, as before, and an op called on them raises.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula


def _refuse(name: str, t: torch.Tensor):
    raise ValueError(f"repro_torch::{name} stands for its kernel on meta tensors only; "
                     f"got a {t.device} tensor (call ops.{name})")


@functools.lru_cache(maxsize=256)
def attended_pairs(Sq: int, Skv: int, causal: bool, window: int, q_offset: int) -> int:
    """(query, key) pairs the flash mask admits: query i (position
    ``q_offset + i``) attends key t iff t <= its position (``causal``) and
    t > its position - ``window`` (a window > 0)."""
    if not causal and not window:
        return Sq * Skv
    total = 0
    for pos in range(q_offset, q_offset + Sq):
        hi = min(pos + 1, Skv) if causal else Skv
        lo = max(0, pos - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def _forward_flops(q_shape, k_shape, causal, window, q_offset) -> int:
    B, Sq, H, hd = q_shape
    return 4 * B * H * hd * attended_pairs(Sq, k_shape[1], bool(causal), int(window),
                                           int(q_offset))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                    window: int, softcap: float, q_offset: int) -> torch.Tensor:
    _refuse("flash_attention", q)


@flash_attention.register_fake
def _(q, k, v, causal, window, softcap, q_offset):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, window, softcap, q_offset, *args, **kwargs) -> int:
    return _forward_flops(q_shape, k_shape, causal, window, q_offset)


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=())
def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                        window: int, softcap: float,
                        q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    _refuse("flash_attention_lse", q)


@flash_attention_lse.register_fake
def _(q, k, v, causal, window, softcap, q_offset):
    B, Sq, H, _ = q.shape
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty((B, H, Sq), dtype=torch.float32, device=q.device))


@register_flop_formula(torch.ops.repro_torch.flash_attention_lse)
def _(q_shape, k_shape, v_shape, causal, window, softcap, q_offset, *args, **kwargs) -> int:
    return _forward_flops(q_shape, k_shape, causal, window, q_offset)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, causal: bool,
                        window: int, softcap: float,
                        q_offset: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _refuse("flash_attention_bwd", q)


@flash_attention_bwd.register_fake
def _(dout, q, k, v, o, lse, causal, window, softcap, q_offset):
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(do_shape, q_shape, k_shape, v_shape, o_shape, lse_shape, causal, window, softcap,
      q_offset, *args, **kwargs) -> int:
    return _forward_flops(q_shape, k_shape, causal, window, q_offset) * 10 // 4


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int,
                     softcap: float) -> torch.Tensor:
    _refuse("decode_attention", q)


@decode_attention.register_fake
def _(q, k, v, valid_len, softcap):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _(q_shape, k_shape, v_shape, valid_len, softcap, *args, **kwargs) -> int:
    B, H, hd = q_shape
    return 4 * B * H * hd * int(valid_len)


@torch.library.custom_op("repro_torch::decode_attention_lse", mutates_args=())
def decode_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int,
                         softcap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    _refuse("decode_attention_lse", q)


@decode_attention_lse.register_fake
def _(q, k, v, valid_len, softcap):
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty(q.shape[:2], dtype=torch.float32, device=q.device))


@register_flop_formula(torch.ops.repro_torch.decode_attention_lse)
def _(q_shape, k_shape, v_shape, valid_len, softcap, *args, **kwargs) -> int:
    B, H, hd = q_shape
    return 4 * B * H * hd * int(valid_len)
