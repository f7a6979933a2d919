"""Flash attention for prefill: the plain PyTorch version and the CUDA kernel
wrapper (port of ``repro.kernels.flash_attention``).

* :func:`flash_attention_plain` computes the function in straightforward
  PyTorch: the full float32 score matrix and a masked softmax.
  ``ops.flash_attention`` takes it for CPU tensors and ``chip_smoke.py``
  holds the kernel against it.
* :func:`flash_attention` launches the hand-written kernel
  (``csrc/flash_attention.cu``) on CUDA tensors and counts its launches in
  ``flash_attention.launches``.

The function is the Pallas kernel's: grouped-query heads (query head h reads
KV head h // G), scale hd^-1/2, optional tanh logit softcap, causal masking
with query i at absolute position ``q_offset + i``, an optional sliding
window (key t attends iff t > q_pos - window), float32 softmax statistics,
probabilities rounded to v's type before the PV product, and the finite
sentinel ``NEG_INF``. A query with no key left to attend gives 0 (the
``l == 0`` guard), as the Pallas kernel gives when it skips every block of
that query, never NaN. Unlike the Pallas wrapper, any Sq and Skv work: the
kernel masks its ragged last tiles.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
MAX_GROUP = 32  # query heads per KV head the kernels take


def _attend_plain(q, k, v, mask, softcap: float):
    """Masked grouped-query attention on full float32 scores.

    q: [B, Sq, H, hd]; k/v: [B, Skv, KV, hd]; mask: [Sq, Skv] bool (True
    attends). Returns [B, Sq, H, hd] in q's dtype."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k.float()) * (hd ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    pv = p.to(v.dtype).float()
    o = torch.einsum("bkgqt,btkd->bqkgd", pv, v.float()) / l.permute(0, 3, 1, 2, 4)
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def attention_mask(Sq: int, Skv: int, *, causal: bool, window: int,
                   q_offset: int, device) -> torch.Tensor:
    """[Sq, Skv] bool: query i (absolute position ``q_offset + i``) attends
    key t."""
    q_pos = torch.arange(Sq, device=device)[:, None] + q_offset
    t_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= t_pos <= q_pos
    if window:
        mask &= t_pos > q_pos - window
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, q_offset: int = 0):
    """The kernel's plain PyTorch version. q: [B, Sq, H, hd]; k/v:
    [B, Skv, KV, hd] -> [B, Sq, H, hd]."""
    mask = attention_mask(q.shape[1], k.shape[1], causal=causal,
                          window=window, q_offset=q_offset, device=q.device)
    return _attend_plain(q, k, v, mask, softcap)


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

_LIB_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4   # dtype, q, k, v, o
                 + [ctypes.c_longlong] * 12               # q/k/v/o strides
                 + [ctypes.c_int] * 9                     # B Sq Skv H KV hd causal window q_offset
                 + [ctypes.c_float] * 2                   # scale, softcap
                 + [ctypes.c_int, ctypes.c_void_p])       # device, stream


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _LIB_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def check_attention_inputs(fn: str, q, k, v, q_dims: int):
    """Validate what the attention kernels take: CUDA tensors on one device,
    one dtype of :data:`DTYPES`, GQA head counts, a supported head dim and a
    contiguous head dim (other strides are free)."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn} launches a CUDA kernel; q is on {q.device} "
                         f"(ops.{fn} takes the plain version for CPU tensors)")
    if q.dim() != q_dims or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{fn}: bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{fn}: {name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"{fn}: dtype {q.dtype} is not one of {list(DTYPES)}")
    H, hd = q.shape[-2], q.shape[-1]
    KV = k.shape[2]
    if k.shape[0] != q.shape[0] or k.shape[3] != hd:
        raise ValueError(f"{fn}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch or head dim")
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"{fn}: {H} query heads on {KV} KV heads (need a "
                         f"multiple, at most {MAX_GROUP} per KV head)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {hd} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{fn}: the head dim must be contiguous")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0):
    """Flash attention as one CUDA kernel launch on PyTorch's current stream
    (no synchronisation). q: [B, Sq, H, hd]; k/v: [B, Skv, KV, hd], float32
    or bfloat16, read through their strides. Returns a new contiguous
    [B, Sq, H, hd] tensor."""
    check_attention_inputs("flash_attention", q, k, v, 4)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    err = _lib().flash_attention_launch(
        DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        *strides, B, Sq, Skv, H, KV, hd, int(bool(causal)), int(window),
        int(q_offset), float(hd) ** -0.5, float(softcap), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
