// The exact three-way bf16 split of a float32 matrix (kernels/bf16_split.py).
//
// x [rows, cols] float32, rows `x_stride` elements apart, becomes three bf16
// planes of [rows, out_cols] (out_cols >= cols, a multiple of 4; the columns
// from cols on are zero):
//
//   hi = bf16(x), lo = bf16(x - hi), lo2 = bf16((x - hi) - lo)
//
// each rounded to nearest even. Both differences are exact in float32, and
// hi + lo + lo2 == x for every 2^-110 <= |x| <= bf16's largest finite value.
// One pass: each element read once, each piece written once. A thread takes
// four columns of a row (an 8-byte store a plane); blockIdx.y walks the rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;  // columns a thread

__device__ __forceinline__ void split1(float v, __nv_bfloat16& hi, __nv_bfloat16& lo,
                                       __nv_bfloat16& lo2) {
  hi = __float2bfloat16_rn(v);
  const float rest = v - __bfloat162float(hi);
  lo = __float2bfloat16_rn(rest);
  lo2 = __float2bfloat16_rn(rest - __bfloat162float(lo));
}

__global__ void __launch_bounds__(kThreads) split3_kernel(const float* __restrict__ x,
                                                          __nv_bfloat16* __restrict__ out,
                                                          long long rows, int cols,
                                                          long long x_stride, int out_cols) {
  const long long plane = rows * out_cols;
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (c0 >= out_cols) return;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* xr = x + r * x_stride;
    union {
      __nv_bfloat16 h[kCols];
      uint2 u;
    } p[3];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = c0 + j;
      split1(c < cols ? xr[c] : 0.0f, p[0].h[j], p[1].h[j], p[2].h[j]);
    }
    const long long at = r * out_cols + c0;
#pragma unroll
    for (int i = 0; i < 3; ++i) *reinterpret_cast<uint2*>(out + i * plane + at) = p[i].u;
  }
}

}  // namespace

// 0, or the CUDA error of the launch (cudaErrorInvalidValue for arguments
// the kernel does not take).
extern "C" int bf16_split3_launch(const void* x, void* out, long long rows, int cols,
                                  long long x_stride, int out_cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || cols < 0 || out_cols < cols || out_cols % kCols != 0 || x_stride < cols)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || out_cols == 0) return (int)cudaSuccess;
  const int col_blocks = (out_cols / kCols + kThreads - 1) / kThreads;
  const dim3 grid(col_blocks, (unsigned)(rows < 65535 ? rows : 65535));
  split3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(out), rows, cols, x_stride,
      out_cols);
  return (int)cudaGetLastError();
}
