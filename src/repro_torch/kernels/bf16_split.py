"""The exact three-way bf16 split of a float32 matrix: the plain PyTorch
version and the CUDA kernel wrapper (no counterpart in the JAX package).

``x`` [rows, cols] float32 becomes ``[3, rows, out_cols]`` bf16, the planes
``hi = bf16(x)``, ``lo = bf16(x - hi)`` and ``lo2 = bf16(x - hi - lo)``
(round to nearest even; both differences are exact in float32), the
columns from ``cols`` on zero. bf16 has float32's exponent range, so three
8-bit significands cover float32's 24 and ``hi + lo + lo2 == x`` for every
``2**-110 <= |x|`` up to bf16's largest finite value (about 3.39e38); below
``2**-110`` ``lo2`` falls among bf16's subnormals and the three miss ``x``
by at most ``2**-134``. A product of the three planes against bf16 operands,
accumulated in float32, is then the product of ``x`` itself
(:class:`repro_torch.models.model.TensorCoreLogits`'s backward).

* :func:`split3_plain` is the function in plain PyTorch
  (``ops.bf16_split3`` takes it for CPU tensors).
* :func:`split3` launches ``csrc/bf16_split.cu`` on CUDA tensors: one pass,
  each element read once and each piece written once. It counts launches
  in ``split3.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

COLS_MULTIPLE = 4  # out_cols: the kernel writes four columns of a plane at once


def _check(x, out_cols: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"bf16_split3 takes a 2-D float32 matrix, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if out_cols < x.shape[1] or out_cols % COLS_MULTIPLE:
        raise ValueError(f"bf16_split3: out_cols {out_cols} must be at least the matrix's "
                         f"{x.shape[1]} columns and a multiple of {COLS_MULTIPLE}")


def split3_plain(x: torch.Tensor, out_cols: int) -> torch.Tensor:
    """The kernel's plain PyTorch version: [3, rows, out_cols] bf16."""
    _check(x, out_cols)
    rows, cols = x.shape
    out = torch.zeros((3, rows, out_cols), dtype=torch.bfloat16, device=x.device)
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    lo = rest.to(torch.bfloat16)
    out[0, :, :cols] = hi
    out[1, :, :cols] = lo
    out[2, :, :cols] = (rest - lo.float()).to(torch.bfloat16)
    return out


_LIB_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p,           # x, out
                 ctypes.c_longlong, ctypes.c_int,             # rows, cols
                 ctypes.c_longlong, ctypes.c_int,             # x's row stride, out_cols
                 ctypes.c_int, ctypes.c_void_p]               # device, stream


def _lib() -> ctypes.CDLL:
    lib = _build.load("bf16_split")
    fn = lib.bf16_split3_launch
    if fn.argtypes is None:
        fn.argtypes = _LIB_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def dense_rows(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``x`` [rows, cols] as the kernel reads it, and its row stride: rows
    of contiguous columns that do not overlap. A matrix whose columns are
    strided (a transpose, a column step) or whose rows are closer than
    ``cols`` apart (a row broadcast: stride 0) is copied to a contiguous
    one first; any other (a slice of wider rows) is read in place."""
    rows, cols = x.shape
    if (cols > 1 and x.stride(1) != 1) or (rows > 1 and x.stride(0) < cols):
        x = x.contiguous()
    return x, (x.stride(0) if rows > 1 else cols)


def split3(x: torch.Tensor, out_cols: int) -> torch.Tensor:
    """The split as one CUDA kernel launch on PyTorch's current stream (no
    synchronisation). ``x``: [rows, cols] float32 in any layout
    (:func:`dense_rows`). Returns a new contiguous [3, rows, out_cols]
    bf16 tensor."""
    _check(x, out_cols)
    if not x.is_cuda:
        raise ValueError(f"bf16_split3's kernel takes a CUDA tensor, got {x.device}")
    x, stride = dense_rows(x)
    rows, cols = x.shape
    dev = x.device
    out = torch.empty((3, rows, out_cols), dtype=torch.bfloat16, device=dev)
    err = _lib().bf16_split3_launch(x.data_ptr(), out.data_ptr(), rows, cols, stride, out_cols,
                                    dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bf16_split3 kernel launch failed: CUDA error {err} "
                           f"(x {tuple(x.shape)}, out_cols {out_cols})")
    split3.launches += 1
    return out


split3.launches = 0
