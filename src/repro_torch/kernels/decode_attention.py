"""Split-KV decode attention: the plain PyTorch version and the CUDA kernel
wrapper (port of ``repro.kernels.decode_attention``).

One query token per sequence against a KV cache ``[B, T, KV, hd]`` whose
slots ``t < valid_len`` attend, with the G = H / KV query heads of a KV head
together and an optional tanh logit softcap; the numerics are those of
:mod:`repro_torch.kernels.flash_attention`. ``valid_len`` is a host integer.

* :func:`decode_attention_plain` is the function in plain PyTorch
  (``ops.decode_attention`` takes it for CPU tensors).
* :func:`decode_attention` launches a kernel of ``csrc/decode_attention.cu``
  on CUDA tensors: one grid over chunks of the valid slots
  (:func:`split_plan`) whose last block per (batch, KV head) combines the
  chunks' partials, on the tensor cores for bf16 at hd 64 or 128 and on the
  CUDA cores otherwise (:func:`kernel_variant`). One count in
  ``decode_attention.launches`` per call, and one in
  ``decode_attention.launches_by_variant``.
* :func:`decode_attention_lse` is the same launch whose combining block
  also writes each row's float32 log-sum-exp ([B, H]; -inf where no slot
  is valid), so that the outputs over slices of a cache split by sequence
  merge into the output over the whole (``models.attention.
  merge_partials``); :func:`decode_attention_lse_plain` is its plain
  version. Its launches are counted in ``decode_attention_lse.launches``
  (and by variant), not in ``decode_attention``'s.

The JAX module's docstring mentions a ``t_offset`` ring-buffer mode that its
function does not have; neither does this port.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    DTYPES, _attend_plain, check_aligned, check_attention_inputs)

TC_HEAD_DIMS = (64, 128)  # head dims of the tensor-core decode kernel (bf16)
SPLIT_GRAIN = 64  # slots: a multiple of every tile length of the kernel (<= 64)
BLOCKS_PER_SM = 2  # chunks in flight per SM the split plan aims at
HEADS_PER_BLOCK = 8  # query heads a block takes (csrc kMaxHeads)


def decode_attention_plain(q, k, v, valid_len: int, *, softcap: float = 0.0):
    """The kernel's plain PyTorch version. q: [B, H, hd]; k/v: [B, T, KV, hd];
    slots t < valid_len attend. Returns [B, H, hd]."""
    mask = (torch.arange(k.shape[1], device=q.device) < valid_len)[None, :]
    return _attend_plain(q[:, None], k, v, mask, softcap)[:, 0]


def decode_attention_lse_plain(q, k, v, valid_len: int, *, softcap: float = 0.0):
    """:func:`decode_attention_lse`'s plain version: (o [B, H, hd], lse
    [B, H] float32), lse the log-sum-exp of each row's scaled, softcapped
    scores over the valid slots (-inf with none, where o is 0)."""
    mask = (torch.arange(k.shape[1], device=q.device) < valid_len)[None, :]
    o, lse = _attend_plain(q[:, None], k, v, mask, softcap, with_lse=True)
    return o[:, 0], lse.reshape(q.shape[:2])


def kernel_variant(dtype: torch.dtype, hd: int) -> str:
    """The decode kernel a CUDA call runs: ``"tensor_core"`` (mma.sync) for
    bf16 at hd 64 or 128, ``"cuda_core"`` (float32 fmaf) for float32 and
    for bf16 at the other head dims. A static choice between two
    hand-written kernels, not a fallback."""
    return "tensor_core" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS else "cuda_core"


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_plan(rows: int, valid_len: int, sm_count: int) -> tuple:
    """(split_len, n_splits): the valid slots [0, valid_len) cut into
    n_splits chunks of split_len slots (the last one shorter), split_len a
    multiple of :data:`SPLIT_GRAIN`, so that the ``rows`` (batch, KV head,
    head group) rows of chunks give about :data:`BLOCKS_PER_SM` blocks per
    SM. Every chunk starts below valid_len; with no valid slot there is one
    empty chunk, whose block writes the zero output."""
    grains = -(-max(valid_len, 1) // SPLIT_GRAIN)
    splits = max(1, min(grains, -(-BLOCKS_PER_SM * sm_count // rows)))
    sl = -(-grains // splits) * SPLIT_GRAIN
    return sl, max(1, -(-valid_len // sl))


_ARRIVALS = {}  # (device index, stream) -> int32 counters, zero between calls


def _arrivals(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """The kernel's per-(batch, KV head, head group) arrival counters for
    launches on ``stream`` of ``dev``: allocated zeroed on that stream once
    (again only to grow), left zeroed by every launch. Calls on one stream
    run in order, so they never share counters with a call in flight."""
    key = (dev.index, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _ARRIVALS[key] = buf
    return buf


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/decode_attention.cu)
# ---------------------------------------------------------------------------

_LIB_ARGTYPES = ([ctypes.c_int] * 2                       # dtype, tensor_core
                 + [ctypes.c_void_p] * 8                  # q, k, v, o, scratch x2, lse, arrivals
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


def _launch(name: str, q, k, v, valid_len: int, softcap: float, lse):
    """One launch of the decode kernel into a new [B, H, hd] output (and
    ``lse`` [B, H] float32 when given); returns (o, variant)."""
    check_attention_inputs(name, q, k, v, 3)
    for arg, t in (("k", k), ("v", v)):
        check_aligned(name, arg, "the kernel's TMA load", t.stride(), t.element_size(),
                      t.data_ptr())
    B, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    vl = min(max(int(valid_len), 0), T)
    dev = q.device
    variant = kernel_variant(q.dtype, hd)
    rows = B * KV * -(-G // HEADS_PER_BLOCK)
    sl, n_splits = split_plan(rows, vl, _sm_count(dev.index))
    o = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    part_acc = torch.empty((B * KV, n_splits, G, hd), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B * KV, n_splits, G, 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    arrivals = _arrivals(dev, stream, rows)
    strides = [*q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *o.stride()[:2]]
    err = _lib().decode_attention_launch(
        DTYPES[q.dtype], int(variant == "tensor_core"), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        None if lse is None else lse.data_ptr(), arrivals.data_ptr(), *strides, B, H, KV,
        hd, vl, sl, n_splits, float(hd) ** -0.5, float(softcap), dev.index, stream)
    if err != 0:
        what = (f"tensor map encoding failed: CUresult {-err}" if err < 0
                else f"CUDA error {err}")
        raise RuntimeError(f"{name} {variant} kernel launch failed: {what} (q "
                           f"{tuple(q.shape)}, k {tuple(k.shape)}, valid_len {vl}, {q.dtype})")
    return o, variant


def decode_attention(q, k, v, valid_len: int, *, softcap: float = 0.0):
    """Decode attention as one CUDA kernel launch on PyTorch's current
    stream (no synchronisation). q: [B, H, hd]; k/v: [B, T, KV, hd],
    float32 or bfloat16, read through their strides (16-byte aligned);
    ``valid_len`` is a host int, clamped to [0, T] (0: the output is 0).
    Returns a new contiguous [B, H, hd] tensor. Each stream has its own
    arrival counters, so calls on different streams may overlap."""
    o, variant = _launch("decode_attention", q, k, v, valid_len, softcap, None)
    decode_attention.launches += 1
    decode_attention.launches_by_variant[variant] += 1
    return o


decode_attention.launches = 0
decode_attention.launches_by_variant = {"tensor_core": 0, "cuda_core": 0}


def decode_attention_lse(q, k, v, valid_len: int, *, softcap: float = 0.0):
    """:func:`decode_attention`'s launch that also writes each row's float32
    log-sum-exp. Returns (o [B, H, hd], lse [B, H]); lse is -inf for a row
    with no valid slot (``valid_len`` 0), whose output is 0."""
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    o, variant = _launch("decode_attention_lse", q, k, v, valid_len, softcap, lse)
    decode_attention_lse.launches += 1
    decode_attention_lse.launches_by_variant[variant] += 1
    return o, lse


decode_attention_lse.launches = 0
decode_attention_lse.launches_by_variant = {"tensor_core": 0, "cuda_core": 0}
