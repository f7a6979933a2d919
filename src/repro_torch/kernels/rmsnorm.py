"""RMSNorm over the last dim, forward and backward: the plain PyTorch
version and the CUDA kernels' wrappers (no counterpart in the JAX package,
where XLA fuses the norm's float32 chain).

The norm works in float32 and rounds once, to ``x``'s dtype::

    r = rsqrt(mean(x**2) + eps)              (float32, a row)
    y = x.dtype((x * r) * w)
    dx = x.dtype(g * r - x * (sum(g * x) * r**3 / D)),  g = dy * w
    dw = w.dtype(sum over rows of dy * (x * r))

* :func:`rmsnorm_plain` is the function as PyTorch's ops compose it, with
  autograd's gradient: ``models.layers.rmsnorm`` takes it wherever the
  kernels do not take the input (CPU and ``meta`` tensors, a ``group``,
  other widths), and the card's checks hold the kernels to it.
* :func:`rmsnorm_fwd` launches ``csrc/rmsnorm.cu``'s forward: one pass that
  reads ``x`` once and writes ``y`` (and ``r``, where a gradient is to
  come); :func:`rmsnorm_bwd` its backward: one pass that reads ``x``, ``dy``
  and ``r`` and writes ``dx`` and a float32 partial ``dw`` a block, then a
  launch that adds the partial rows in a fixed order (no atomics: a
  gradient repeats bit for bit). Each counts its calls in ``.launches``.
* :class:`RMSNorm` joins them for autograd, saving ``x`` itself and ``r``.

The kernels take ``x`` and ``w`` of float32 or bf16 whose last dim is a
multiple of :data:`COLS_MULTIPLE` (16-byte rows) up to :data:`MAX_COLS`
(:func:`kernel_takes`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

COLS_MULTIPLE = 8  # the kernels read and write 8 elements of a row at once
MAX_COLS = 16384  # a row in one block's registers: 512 threads x 4 vectors of 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/rmsnorm.cu's dtype codes


def _refusal(x, w):
    """Why the kernels do not take ``x`` and ``w`` (None where they do),
    device aside."""
    D = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        return f"x and w of float32 or bf16, got {x.dtype} and {w.dtype}"
    if x.dim() < 1 or tuple(w.shape) != (D,):
        return f"w [D] for x [..., D], got {tuple(w.shape)} for {tuple(x.shape)}"
    if D < COLS_MULTIPLE or D % COLS_MULTIPLE or D > MAX_COLS:
        return (f"a last dim that is a multiple of {COLS_MULTIPLE} up to {MAX_COLS}, "
                f"got {D}")
    return None


def kernel_takes(x, w) -> bool:
    """Whether the kernels take ``x`` and ``w``: CUDA tensors on one device
    of float32 or bf16, ``w`` [D] for ``x`` [..., D], D a multiple of
    :data:`COLS_MULTIPLE` up to :data:`MAX_COLS`."""
    return x.is_cuda and w.device == x.device and _refusal(x, w) is None


def _check(x, w) -> None:
    why = _refusal(x, w)
    if why is not None:
        raise ValueError(f"rmsnorm's kernels take {why}")
    if not x.is_cuda or w.device != x.device:
        raise ValueError(f"rmsnorm's kernels take CUDA tensors on one device, got "
                         f"{x.device} and {w.device}")


def rmsnorm_plain(x, w, eps: float):
    """RMS norm over the last dim as PyTorch's ops compose it: float32
    through, one rounding to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    if lib.rmsnorm_fwd_launch.argtypes is None:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.rmsnorm_fwd_launch.argtypes = [i, i, vp, vp, vp, vp, ll, i, ctypes.c_float, i, vp]
        lib.rmsnorm_fwd_launch.restype = i
        lib.rmsnorm_bwd_parts.argtypes = [i, i, ll, i, i]
        lib.rmsnorm_bwd_parts.restype = ll
        lib.rmsnorm_bwd_launch.argtypes = [i, i, vp, vp, vp, vp, vp, vp, vp, ll, ll, i, i, vp]
        lib.rmsnorm_bwd_launch.restype = i
    return lib


@functools.lru_cache(maxsize=256)
def _parts(x_code: int, w_code: int, rows: int, cols: int, device: int) -> int:
    """The backward's blocks (one wave of resident blocks, fewer for fewer
    rows), each writing one float32 partial row of ``dw``: asked of the
    kernel once a shape, so that a CUDA graph's capture asks nothing."""
    parts = _lib().rmsnorm_bwd_parts(x_code, w_code, rows, cols, device)
    if parts < 1:
        raise RuntimeError(f"rmsnorm backward: no launch plan for {rows} rows of {cols}")
    return parts


def _rows(t):
    """``t`` as the kernels read it: contiguous, its start on 16 bytes."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def rmsnorm_fwd(x, w, eps: float, *, save: bool = False):
    """The forward as one kernel launch on PyTorch's current stream:
    (``y``, ``r``), ``r`` the float32 1 / rms a row where ``save``, else
    None (nothing written but ``y``)."""
    _check(x, w)
    x, w = _rows(x), _rows(w)
    D, dev = x.shape[-1], x.device
    rows = x.numel() // D
    y = torch.empty_like(x)
    r = torch.empty(x.shape[:-1], dtype=torch.float32, device=dev) if save else None
    err = _lib().rmsnorm_fwd_launch(_DTYPES[x.dtype], _DTYPES[w.dtype], x.data_ptr(),
                                    w.data_ptr(), y.data_ptr(),
                                    None if r is None else r.data_ptr(), rows, D, float(eps),
                                    dev.index, _stream(dev))
    if err != 0:
        raise RuntimeError(f"rmsnorm forward kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)} {x.dtype}, w {w.dtype})")
    rmsnorm_fwd.launches += 1
    return y, r


def rmsnorm_bwd(x, dy, r, w):
    """The backward as two kernel launches on PyTorch's current stream:
    (``dx``, ``dw``) in the dtypes of ``x`` and ``w``."""
    if (dy.shape != x.shape or dy.dtype != x.dtype or r.shape != x.shape[:-1]
            or r.dtype != torch.float32 or dy.device != x.device or r.device != x.device):
        raise ValueError(f"rmsnorm backward: dy {tuple(dy.shape)} {dy.dtype} on {dy.device} "
                         f"and float32 r {tuple(r.shape)} {r.dtype} on {r.device} for x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    _check(x, w)
    x, dy, r, w = _rows(x), _rows(dy), _rows(r), _rows(w)
    D, dev = x.shape[-1], x.device
    rows = x.numel() // D
    codes = (_DTYPES[x.dtype], _DTYPES[w.dtype])
    parts = _parts(*codes, rows, D, dev.index)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    partial = torch.empty((parts, D), dtype=torch.float32, device=dev)
    err = _lib().rmsnorm_bwd_launch(*codes, x.data_ptr(), dy.data_ptr(), r.data_ptr(),
                                    w.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                                    partial.data_ptr(), parts, rows, D, dev.index, _stream(dev))
    if err != 0:
        raise RuntimeError(f"rmsnorm backward kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)} {x.dtype}, w {w.dtype})")
    rmsnorm_bwd.launches += 1
    return dx, dw


rmsnorm_fwd.launches = 0
rmsnorm_bwd.launches = 0


class RMSNorm(torch.autograd.Function):
    """``y`` of the norm with its gradient: :func:`rmsnorm_fwd` and
    :func:`rmsnorm_bwd` (CUDA tensors only: anything else raises
    ``ValueError``). Saves ``x`` itself and the float32 ``r``."""

    @staticmethod
    def forward(ctx, x, w, eps):
        y, r = rmsnorm_fwd(x, w, eps, save=True)
        ctx.save_for_backward(x, r, w)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, r, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, dy.to(x.dtype), r, w)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None)
