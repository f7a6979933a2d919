"""Flash attention for prefill: the plain PyTorch version and the CUDA kernel
wrapper (port of ``repro.kernels.flash_attention``).

* :func:`flash_attention_plain` computes the function in straightforward
  PyTorch: the full float32 score matrix and a masked softmax.
  ``ops.flash_attention`` takes it for CPU tensors and ``chip_smoke.py``
  holds the kernel against it.
* :func:`flash_attention` launches a hand-written kernel of
  ``csrc/flash_attention.cu`` on CUDA tensors: the tensor-core kernel
  (wgmma, TMA) for bf16 at hd 64, 96, 128 and 256, the CUDA-core kernel
  otherwise (:func:`kernel_variant`). It counts launches in
  ``flash_attention.launches`` and, by variant, in
  ``flash_attention.launches_by_variant``.

Training adds the gradient. :class:`FlashAttention` is a
``torch.autograd.Function`` whose forward is :func:`flash_attention_lse`,
the same kernel launched so that it also writes each row's float32
log-sum-exp [B, H, Sq], and whose backward is :func:`flash_attention_bwd`,
the hand-written kernel of ``csrc/flash_attention_bwd.cu`` (wgmma fed by TMA
for bf16 at hd 64, CUDA cores otherwise: :func:`bwd_variant`); each counts its
launches the same way. On CPU tensors the Function runs the plain versions,
:func:`flash_attention_lse_plain` and :func:`flash_attention_bwd_plain` (the
gradient from its explicit formulas), and counts nothing. On ``meta``
tensors (the dry run's trace) it calls the kernels' traceable ops
(:mod:`repro_torch.kernels.traced`).

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
from repro_torch.kernels import traced as _traced

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64, 96, 128, 256)  # 96: gpt-neox-20b; 256: gemma2-9b
MAX_GROUP = 32  # query heads per KV head the kernels take
TC_HEAD_DIMS = (64, 96, 128, 256)  # head dims of the tensor-core flash kernel (bf16)
COPY_ALIGN = 16  # bytes: TMA's alignment of base addresses and strides


def _scores_plain(q, k, softcap: float):
    """float32 scores [B, KV, G, Sq, Skv] of grouped-query heads (query head
    h = kvh * G + g reads KV head kvh), scaled by hd^-1/2 and softcapped."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k.float()) * (hd ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    return s


def _attend_plain(q, k, v, mask, softcap: float, with_lse: bool = False):
    """Masked grouped-query attention on full float32 scores.

    q: [B, Sq, H, hd]; k/v: [B, Skv, KV, hd]; mask: [Sq, Skv] bool (True
    attends). Returns [B, Sq, H, hd] in q's dtype; ``with_lse``: and each
    row's float32 log-sum-exp [B, KV, G, Sq] (-inf for a row with no key)."""
    B, Sq, H, hd = q.shape
    s = torch.where(mask, _scores_plain(q, k, softcap), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0] if with_lse else None
    l = torch.where(l == 0.0, 1.0, l)
    pv = p.to(v.dtype).float()
    o = torch.einsum("bkgqt,btkd->bqkgd", pv, v.float()) / l.permute(0, 3, 1, 2, 4)
    o = o.reshape(B, Sq, H, hd).to(q.dtype)
    return (o, lse) if with_lse else o


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

_STRIDED_ARGS = ([ctypes.c_void_p] * 5                   # q, k, v, o, lse
                 + [ctypes.c_longlong] * 12               # q/k/v/o strides
                 + [ctypes.c_int] * 9                     # B Sq Skv H KV hd causal window q_offset
                 + [ctypes.c_float] * 2                   # scale, softcap
                 + [ctypes.c_int, ctypes.c_void_p])       # device, stream
_ENTRY_POINTS = {"cuda_core": ("flash_attention_launch", [ctypes.c_int] + _STRIDED_ARGS),
                 "tensor_core": ("flash_attention_tc_launch", _STRIDED_ARGS)}


def _entry(variant: str):
    """The C entry point of ``variant`` in the built library."""
    name, argtypes = _ENTRY_POINTS[variant]
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def kernel_variant(dtype: torch.dtype, hd: int) -> str:
    """The flash kernel a CUDA call runs: ``"tensor_core"`` (wgmma) for
    bf16 at hd 64, 96, 128 and 256 (hd 96 in a 128-column tile whose last
    32 columns TMA zero-fills), ``"cuda_core"`` (float32 fmaf) for float32,
    whose 2e-5 contract TF32 would break, and for bf16 at hd 8, 16 and 32.
    A static choice between two hand-written kernels, not a fallback."""
    return "tensor_core" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS else "cuda_core"


def check_aligned(fn: str, name: str, why: str, strides, itemsize: int,
                  data_ptr: int) -> None:
    """A kernel that loads a [B, S, heads, hd] tensor by TMA (a 4-D tensor
    map) needs its base address and its batch, sequence and head strides
    (``strides[:3]``, in elements) to be multiples of 16 bytes; raise
    otherwise. ``why`` names the copy."""
    if data_ptr % COPY_ALIGN or any((s * itemsize) % COPY_ALIGN for s in strides[:3]):
        raise ValueError(f"{fn}: {why} needs {name}'s base and strides to be "
                         f"multiples of {COPY_ALIGN} bytes; {name} has base "
                         f"{data_ptr:#x} and strides {tuple(strides)} of {itemsize} bytes")


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


def _launch_forward(fn: str, q, k, v, lse, causal, window, softcap, q_offset):
    """One launch of the flash kernel on PyTorch's current stream; with
    ``lse`` (float32 [B, H, Sq]) the kernel also writes the rows'
    log-sum-exp. Returns (o, variant)."""
    check_attention_inputs(fn, q, k, v, 4)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    variant = kernel_variant(q.dtype, hd)
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if variant == "tensor_core":
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_aligned(fn, name, "the tensor-core kernel's TMA load",
                          t.stride(), t.element_size(), t.data_ptr())
    dtype_arg = [] if variant == "tensor_core" else [DTYPES[q.dtype]]
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    err = _entry(variant)(
        *dtype_arg, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *strides, B, Sq, Skv, H, KV, hd, int(bool(causal)), int(window),
        int(q_offset), float(hd) ** -0.5, float(softcap), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        what = (f"tensor map encoding failed: CUresult {-err}" if err < 0
                else f"CUDA error {err}")
        raise RuntimeError(f"{fn} {variant} kernel launch failed: {what} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})")
    return o, variant


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0):
    """Flash attention as one CUDA kernel launch on PyTorch's current stream
    (no synchronisation). q: [B, Sq, H, hd]; k/v: [B, Skv, KV, hd], float32
    or bfloat16, read through their strides. Returns a new contiguous
    [B, Sq, H, hd] tensor."""
    o, variant = _launch_forward("flash_attention", q, k, v, None, causal, window,
                                 softcap, q_offset)
    flash_attention.launches += 1
    flash_attention.launches_by_variant[variant] += 1
    return o


flash_attention.launches = 0
flash_attention.launches_by_variant = {"tensor_core": 0, "cuda_core": 0}


# ---------------------------------------------------------------------------
# training: the forward with the row log-sum-exp, and its gradient
# ---------------------------------------------------------------------------

def flash_attention_lse_plain(q, k, v, *, causal: bool = True, window: int = 0,
                              softcap: float = 0.0, q_offset: int = 0):
    """The training forward's plain version: (o [B, Sq, H, hd], lse [B, H,
    Sq] float32), lse the log-sum-exp of each row's scaled, softcapped,
    masked scores, +inf for a row with no key (whose output is 0)."""
    B, Sq, H, _ = q.shape
    mask = attention_mask(Sq, k.shape[1], causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask, _scores_plain(q, k, softcap), -torch.inf)
    lse = torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    lse = torch.where(torch.isneginf(lse), torch.inf, lse)
    return _attend_plain(q, k, v, mask, softcap), lse


def flash_attention_lse(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0):
    """The training forward: one launch of the flash kernel
    (:func:`flash_attention`'s, same variant choice) that also writes the
    rows' float32 log-sum-exp. Returns (o, lse [B, H, Sq]); counts its
    launches in ``flash_attention_lse.launches`` (and by variant), not in
    :func:`flash_attention`'s counts."""
    B, Sq, H, _ = q.shape
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    o, variant = _launch_forward("flash_attention_lse", q, k, v, lse, causal, window,
                                 softcap, q_offset)
    flash_attention_lse.launches += 1
    flash_attention_lse.launches_by_variant[variant] += 1
    return o, lse


flash_attention_lse.launches = 0
flash_attention_lse.launches_by_variant = {"tensor_core": 0, "cuda_core": 0}


def flash_attention_bwd_plain(do, q, k, v, o, lse, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0,
                              q_offset: int = 0):
    """The gradient of the flash function from its explicit formulas, in
    float32: P = exp(c - lse) on attended pairs (c the softcapped score),
    D = rowsum(dO * O), dS = P (dO V^T - D) c' (c' = 1 - (c / softcap)^2,
    the softcap's derivative), dV = P^T dO, dQ = dS K hd^-1/2, dK = dS^T Q
    hd^-1/2; dK and dV summed over the G query heads of each KV head. A row
    with no key (lse = +inf) gets zero gradients. Returns (dq, dk, dv) in
    the dtypes of q, k, v."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    c = _scores_plain(q, k, softcap)
    lse_ = lse.reshape(B, KV, G, Sq, 1)
    p = torch.where(mask & torch.isfinite(lse_), torch.exp(c - lse_), 0.0)
    qf = q.float().reshape(B, Sq, KV, G, hd)
    dof = do.float().reshape(B, Sq, KV, G, hd)
    d = (dof * o.float().reshape(B, Sq, KV, G, hd)).sum(-1)  # [B, Sq, KV, G]
    dp = torch.einsum("bqkgd,btkd->bkgqt", dof, v.float())
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    if softcap:
        ds = ds * (1.0 - (c / softcap) ** 2)
    scale = hd ** -0.5
    dv = torch.einsum("bkgqt,bqkgd->btkd", p, dof)
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds, qf) * scale
    return dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_BWD_ARGS = ([ctypes.c_int] * 2                      # variant, dtype
             + [ctypes.c_void_p] * 10                # do q k v o lse delta dq dk dv
             + [ctypes.c_longlong] * 15              # do/q/k/v/o strides
             + [ctypes.c_int] * 9                    # B Sq Skv H KV hd causal window q_offset
             + [ctypes.c_float] * 2                  # scale, softcap
             + [ctypes.c_int, ctypes.c_void_p])      # device, stream
BWD_VARIANTS = {"cuda_core": 0, "tensor_core": 1}
BWD_BLOCK_ROWS = 128  # rows (keys, or queries) a block of the tensor-core backward owns


def bwd_variant(dtype: torch.dtype, hd: int) -> str:
    """The backward kernel a CUDA call runs: ``"tensor_core"`` (wgmma fed
    by TMA) for bf16 at hd 64, the head dim of the trained models; ``"cuda_core"``
    (float32 fmaf) for float32, whose 2e-5 contract TF32 would break, and
    for bf16 at every other head dim. A static choice between two
    hand-written kernels, not a fallback."""
    return "tensor_core" if dtype == torch.bfloat16 and hd == 64 else "cuda_core"


def flash_attention_bwd(do, q, k, v, o, lse, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0):
    """The gradient of flash attention on the card: the kernels of
    ``csrc/flash_attention_bwd.cu`` (D = rowsum(dO * O), then a dK/dV pass
    and a dQ pass; no atomics, so the same inputs give the same bits) on
    PyTorch's current stream. do, o: [B, Sq, H, hd] and q, k, v as the
    forward took them; lse: the forward's float32 [B, H, Sq]. Returns new
    contiguous (dq, dk, dv) in q's dtype; one call counts one launch in
    ``flash_attention_bwd.launches`` (and by variant). Raises on a shape,
    type or layout the kernels do not take."""
    fn = "flash_attention_bwd"
    check_attention_inputs(fn, q, k, v, 4)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    for name, t in (("do", do), ("o", o)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{fn}: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; q is {q.dtype} {tuple(q.shape)} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{fn}: {name}'s head dim must be contiguous")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"{fn}: lse must be contiguous float32 [B, H, Sq] = "
                         f"{(B, H, Sq)} on {q.device}; got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    variant = bwd_variant(q.dtype, hd)
    if variant == "tensor_core":
        for name, t in (("do", do), ("q", q), ("k", k), ("v", v)):
            check_aligned(fn, name, "the tensor-core kernel's TMA load",
                          t.stride(), t.element_size(), t.data_ptr())
        check_aligned(fn, "o", "the tensor-core kernel's 16-byte loads", o.stride(),
                      o.element_size(), o.data_ptr())
    # the kernels write every entry of each gradient, but launch nothing
    # when Sq or Skv is 0: zeros then
    new = torch.empty if Sq and Skv else torch.zeros
    dq = new((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    dk = new((B, Skv, KV, hd), dtype=k.dtype, device=k.device)
    dv = new((B, Skv, KV, hd), dtype=v.dtype, device=v.device)
    # scratch: D = rowsum(dO * O) [B, H, Sq]; the tensor-core kernel's
    # (lse log2(e), D) pairs [B, H, Sq rounded up to a block, 2] instead
    rows = -(-Sq // BWD_BLOCK_ROWS) * BWD_BLOCK_ROWS
    delta = torch.empty((B, H, rows, 2) if variant == "tensor_core" else (B, H, Sq),
                        dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention_bwd")
    entry = lib.flash_attention_bwd_launch
    if entry.argtypes is None:
        entry.argtypes = _BWD_ARGS
        entry.restype = ctypes.c_int
    strides = [s for t in (do, q, k, v, o) for s in t.stride()[:3]]
    err = entry(BWD_VARIANTS[variant], DTYPES[q.dtype], do.data_ptr(), q.data_ptr(),
                k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *strides, B, Sq, Skv, H, KV,
                hd, int(bool(causal)), int(window), int(q_offset), float(hd) ** -0.5,
                float(softcap), q.device.index,
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        what = (f"tensor map encoding failed: CUresult {-err}" if err < 0
                else f"CUDA error {err}")
        raise RuntimeError(f"{fn} {variant} kernel launch failed: {what} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_variant[variant] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_variant = {"tensor_core": 0, "cuda_core": 0}


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient. Forward: :func:`flash_attention_lse`
    on CUDA tensors, :func:`flash_attention_lse_plain` on CPU tensors; it
    keeps q, k, v, o and lse. Backward: :func:`flash_attention_bwd` on
    CUDA tensors, :func:`flash_attention_bwd_plain` on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        opts = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
        if q.device.type == "meta":
            o, lse = _traced.flash_attention_lse(q, k, v, *_op_args(opts))
        else:
            cpu = q.device.type == "cpu"
            o, lse = (flash_attention_lse_plain if cpu else flash_attention_lse)(q, k, v,
                                                                                 **opts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = opts
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "meta":
            dq, dk, dv = _traced.flash_attention_bwd(do.contiguous(), q, k, v, o, lse,
                                                     *_op_args(ctx.opts))
        else:
            bwd = flash_attention_bwd_plain if q.device.type == "cpu" else flash_attention_bwd
            dq, dk, dv = bwd(do.contiguous(), q, k, v, o, lse, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def _op_args(opts: dict) -> tuple:
    return (bool(opts["causal"]), int(opts["window"]), float(opts["softcap"]),
            int(opts["q_offset"]))
