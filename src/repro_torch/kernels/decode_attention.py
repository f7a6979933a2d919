"""Split-KV decode attention: the plain PyTorch version and the CUDA kernel
wrapper (port of ``repro.kernels.decode_attention``).

One query token per sequence against a KV cache ``[B, T, KV, hd]`` whose
slots ``t < valid_len`` attend, with the G = H / KV query heads of a KV head
together and an optional tanh logit softcap; the numerics are those of
:mod:`repro_torch.kernels.flash_attention`. ``valid_len`` is a host integer.

* :func:`decode_attention_plain` is the function in plain PyTorch
  (``ops.decode_attention`` takes it for CPU tensors).
* :func:`decode_attention` launches ``csrc/decode_attention.cu`` on CUDA
  tensors: a split pass over chunks of the valid slots, then a combine
  pass (one count in ``decode_attention.launches`` per call).

The JAX module's docstring mentions a ``t_offset`` ring-buffer mode that its
function does not have; neither does this port.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    DTYPES, _attend_plain, check_attention_inputs)

SPLIT_GRAIN = 64  # a split covers a multiple of the kernel's 64-slot tile


def decode_attention_plain(q, k, v, valid_len: int, *, softcap: float = 0.0):
    """The kernel's plain PyTorch version. q: [B, H, hd]; k/v: [B, T, KV, hd];
    slots t < valid_len attend. Returns [B, H, hd]."""
    mask = (torch.arange(k.shape[1], device=q.device) < valid_len)[None, :]
    return _attend_plain(q[:, None], k, v, mask, softcap)[:, 0]


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_len(batch_kv: int, valid_len: int, sm_count: int) -> int:
    """Slots per split: enough splits that the B * KV rows of blocks give
    about two blocks per SM, each split a multiple of ``SPLIT_GRAIN``."""
    grains = -(-max(valid_len, 1) // SPLIT_GRAIN)
    splits = max(1, min(grains, -(-2 * sm_count // batch_kv)))
    return -(-grains // splits) * SPLIT_GRAIN


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/decode_attention.cu)
# ---------------------------------------------------------------------------

_LIB_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6   # dtype, q, k, v, o, scratch x2
                 + [ctypes.c_longlong] * 10               # q/k/v/o strides
                 + [ctypes.c_int] * 7                     # B H KV hd valid_len split_len n_splits
                 + [ctypes.c_float] * 2                   # scale, softcap
                 + [ctypes.c_int, ctypes.c_void_p])       # device, stream


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _LIB_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def decode_attention(q, k, v, valid_len: int, *, softcap: float = 0.0):
    """Decode attention as the split and combine CUDA launches on PyTorch's
    current stream (no synchronisation). q: [B, H, hd]; k/v: [B, T, KV, hd],
    float32 or bfloat16, read through their strides; ``valid_len`` is a
    host int, clamped to [0, T]. Returns a new contiguous [B, H, hd]
    tensor."""
    check_attention_inputs("decode_attention", q, k, v, 3)
    B, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    vl = min(max(int(valid_len), 0), T)
    dev = q.device
    sl = split_len(B * KV, vl, _sm_count(dev.index))
    n_splits = max(1, -(-vl // sl))
    o = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    part_acc = torch.empty((B * KV, n_splits, G, hd), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B * KV, n_splits, G, 2), dtype=torch.float32, device=dev)
    strides = [*q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *o.stride()[:2]]
    err = _lib().decode_attention_launch(
        DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), *strides, B, H, KV, hd, vl, sl,
        n_splits, float(hd) ** -0.5, float(softcap), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"valid_len {vl}, {q.dtype})")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
