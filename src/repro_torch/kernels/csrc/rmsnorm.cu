// RMSNorm over the last dim, forward and backward (kernels/rmsnorm.py).
//
// No Pallas kernel in the JAX package: XLA fuses the norm's float32 chain
// there. Unfused, PyTorch runs it as 8 elementwise and reduction launches
// forward and 16 backward, each reading or writing a float32 copy of the
// activations. Both directions are bound by device memory, so each is one
// pass: the forward reads x once and writes y once (and a float32 1/rms a
// row), the backward reads x and dy once and writes dx once.
//
// Forward, rows of x [rows, cols] (cols a multiple of 8, at most 16384):
//
//   r = rsqrt(sum(x^2) / cols + eps)    (float32; saved where rstd != null)
//   y = T((x * r) * w)                  (float32, rounded once to x's dtype)
//
// the op order and rounding point of the plain chain. Backward, with
// g = dy * w:
//
//   dx = T(g * r - x * (sum(g * x) * r^3 / cols))
//   dw = W(sum over rows of dy * (x * r))
//
// dw is summed in float32 without atomics: each block adds its rows' terms
// in a fixed order into a partial row, and a second launch adds the partial
// rows in order, so a gradient repeats bit for bit.
//
// A row belongs to a group of `group` threads (a power of two, the
// block's x), each holding up to kVecs vectors of 8 elements in registers
// (16-byte loads of bf16, two of float32): one thread for rows of 8 to 32
// elements, a warp for 1024, 256 threads for 6144 and 8192. Narrower groups
// stack rows along the block's y to 256 threads. The row's sum is a
// butterfly of shuffles inside a warp, then the warps' sums through shared
// memory in warp order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kVec = 8;         // elements a vector
constexpr int kVecs = 4;        // vectors a thread holds
constexpr int kRowsBlock = 256; // threads a block where a row takes fewer
constexpr int kMaxGroup = 512;  // threads a row at most: rows of 16384 elements
constexpr int kSlices = 8;      // partial rows a reducing thread adds, then in order

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  struct Raw {
    float4 a, b;
  };
  static __device__ __forceinline__ Raw load(const float* p) {
    return Raw{reinterpret_cast<const float4*>(p)[0], reinterpret_cast<const float4*>(p)[1]};
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[kVec]) {
    f[0] = r.a.x, f[1] = r.a.y, f[2] = r.a.z, f[3] = r.a.w;
    f[4] = r.b.x, f[5] = r.b.y, f[6] = r.b.z, f[7] = r.b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[kVec]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  static __device__ __forceinline__ float from(float v) { return v; }
};

template <>
struct Pack<__nv_bfloat16> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[kVec]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x, f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[kVec]) {
    union {
      uint4 u;
      __nv_bfloat162 h[kVec / 2];
    } o;
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) o.h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = o.u;
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) { return __float2bfloat16_rn(v); }
};

template <typename T>
__device__ __forceinline__ void load_floats(const T* p, float (&f)[kVec]) {
  Pack<T>::unpack(Pack<T>::load(p), f);
}

// The sum of v over the threads of this thread's row (threadIdx.x 0 ..
// blockDim.x - 1 of row threadIdx.y), the same value in each of them.
// Every thread of the block calls it (a block barrier where a row spans
// warps).
__device__ __forceinline__ float row_sum(float v, float* red) {
  const int group = blockDim.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < group) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (group <= 32) return v;
  const int warps = group / 32;
  const int warp = (threadIdx.y * group + threadIdx.x) / 32;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const float* mine = red + threadIdx.y * warps;
  float s = 0.0f;
  for (int i = 0; i < warps; ++i) s += mine[i];
  __syncthreads();  // red is written again by the next call
  return s;
}

template <typename T, typename W, int kThreads>
__global__ void __launch_bounds__(kThreads) rmsnorm_fwd_kernel(const T* __restrict__ x,
                                                               const W* __restrict__ w,
                                                               T* __restrict__ y,
                                                               float* __restrict__ rstd,
                                                               long long rows, int cols,
                                                               float eps) {
  __shared__ float red[kMaxGroup / 32];
  const int group = blockDim.x, nvec = cols / kVec;
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool valid = row < rows;
  const T* xr = x + row * cols;
  typename Pack<T>::Raw raw[kVecs];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = threadIdx.x + k * group;
    if (valid && v < nvec) {
      raw[k] = Pack<T>::load(xr + v * kVec);
      float f[kVec];
      Pack<T>::unpack(raw[k], f);
#pragma unroll
      for (int j = 0; j < kVec; ++j) ss += f[j] * f[j];
    }
  }
  ss = row_sum(ss, red);
  if (!valid) return;
  const float r = rsqrtf(ss / cols + eps);
  if (rstd != nullptr && threadIdx.x == 0) rstd[row] = r;
  T* yr = y + row * cols;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = threadIdx.x + k * group;
    if (v < nvec) {
      float f[kVec], wf[kVec];
      Pack<T>::unpack(raw[k], f);
      load_floats(w + v * kVec, wf);
#pragma unroll
      for (int j = 0; j < kVec; ++j) f[j] = (f[j] * r) * wf[j];
      Pack<T>::store(yr + v * kVec, f);
    }
  }
}

// A block takes blockDim.y rows at a time, the grid's rows apart. Each
// thread adds its columns' dw terms in row order; the block's rows (y = 0,
// 1, ..) are then added in order into partial[blockIdx.x].
template <typename T, typename W, int kThreads>
__global__ void __launch_bounds__(kThreads) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ rstd,
    const W* __restrict__ w, T* __restrict__ dx, float* __restrict__ partial, long long rows,
    int cols) {
  extern __shared__ __align__(16) float rows_dw[];  // [blockDim.y][cols] if blockDim.y > 1
  __shared__ float red[kMaxGroup / 32];
  const int group = blockDim.x, nvec = cols / kVec;
  float acc[kVecs][kVec];
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[k][j] = 0.0f;

  const long long step = (long long)gridDim.x * blockDim.y;
  for (long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       row - threadIdx.y < rows; row += step) {  // the same trip count in every thread
    const bool valid = row < rows;
    typename Pack<T>::Raw xraw[kVecs], graw[kVecs];
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int v = threadIdx.x + k * group;
      if (valid && v < nvec) {
        xraw[k] = Pack<T>::load(x + row * cols + v * kVec);
        graw[k] = Pack<T>::load(dy + row * cols + v * kVec);
        float xf[kVec], df[kVec], wf[kVec];
        Pack<T>::unpack(xraw[k], xf);
        Pack<T>::unpack(graw[k], df);
        load_floats(w + v * kVec, wf);
#pragma unroll
        for (int j = 0; j < kVec; ++j) dot += (df[j] * wf[j]) * xf[j];
      }
    }
    dot = row_sum(dot, red);
    if (!valid) continue;
    const float r = rstd[row];
    const float c = dot * (r * r * r) / cols;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int v = threadIdx.x + k * group;
      if (v < nvec) {
        float xf[kVec], df[kVec], wf[kVec], out[kVec];
        Pack<T>::unpack(xraw[k], xf);
        Pack<T>::unpack(graw[k], df);
        load_floats(w + v * kVec, wf);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          out[j] = (df[j] * wf[j]) * r - xf[j] * c;
          acc[k][j] += df[j] * (xf[j] * r);
        }
        Pack<T>::store(dx + row * cols + v * kVec, out);
      }
    }
  }

  float* mine = blockDim.y == 1 ? partial + (long long)blockIdx.x * cols
                                : rows_dw + threadIdx.y * cols;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = threadIdx.x + k * group;
    if (v < nvec) Pack<float>::store(mine + v * kVec, acc[k]);
  }
  if (blockDim.y == 1) return;
  __syncthreads();
  const int threads = blockDim.x * blockDim.y;
  for (int col = threadIdx.y * group + threadIdx.x; col < cols; col += threads) {
    float s = 0.0f;
    for (int i = 0; i < (int)blockDim.y; ++i) s += rows_dw[i * cols + col];
    partial[(long long)blockIdx.x * cols + col] = s;
  }
}

// dw[col] = W(sum of partial[p][col] over p = 0 .. parts - 1): slice s adds
// the parts s, s + kSlices, .., then the slices add in order.
template <typename W>
__global__ void __launch_bounds__(32 * kSlices) rmsnorm_dw_kernel(const float* __restrict__ partial,
                                                                 W* __restrict__ dw, int parts,
                                                                 int cols) {
  __shared__ float slices[kSlices][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (col < cols)
    for (int p = threadIdx.y; p < parts; p += kSlices) s += partial[(long long)p * cols + col];
  slices[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || col >= cols) return;
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < kSlices; ++i) t += slices[i][threadIdx.x];
  dw[col] = Pack<W>::from(t);
}

struct Shape {
  dim3 block;
  size_t bwd_smem;
  bool wide() const { return block.x * block.y > kRowsBlock; }
};

// false for cols the kernels do not take
bool plan(int cols, Shape& s) {
  if (cols < kVec || cols % kVec != 0 || cols > kVec * kVecs * kMaxGroup) return false;
  const int need = (cols / kVec + kVecs - 1) / kVecs;
  int group = 1;
  while (group < need) group *= 2;
  const int per_block = group < kRowsBlock ? kRowsBlock / group : 1;
  s.block = dim3(group, per_block);
  s.bwd_smem = per_block > 1 ? (size_t)per_block * cols * sizeof(float) : 0;
  return true;
}

template <typename T, typename W>
int launch_fwd(const void* x, const void* w, void* y, float* rstd, long long rows, int cols,
               float eps, cudaStream_t stream) {
  Shape s;
  if (!plan(cols, s)) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + s.block.y - 1) / s.block.y;
  auto kernel = s.wide() ? rmsnorm_fwd_kernel<T, W, kMaxGroup>
                         : rmsnorm_fwd_kernel<T, W, kRowsBlock>;
  kernel<<<(unsigned)blocks, s.block, 0, stream>>>(static_cast<const T*>(x),
                                                   static_cast<const W*>(w), static_cast<T*>(y),
                                                   rstd, rows, cols, eps);
  return (int)cudaGetLastError();
}

// blocks of the backward: one wave of resident blocks, or fewer where
// there are fewer row blocks; 0 where the arguments are not taken
template <typename T, typename W>
long long bwd_blocks(long long rows, int cols, int device) {
  Shape s;
  if (!plan(cols, s)) return 0;
  int sms = 0, per_sm = 0;
  auto kernel = s.wide() ? rmsnorm_bwd_kernel<T, W, kMaxGroup>
                         : rmsnorm_bwd_kernel<T, W, kRowsBlock>;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, s.block.x * s.block.y,
                                                    s.bwd_smem) != cudaSuccess)
    return 0;
  const long long row_blocks = (rows + s.block.y - 1) / s.block.y;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return row_blocks < wave ? (row_blocks > 0 ? row_blocks : 1) : wave;
}

template <typename T, typename W>
int launch_bwd(const void* x, const void* dy, const float* rstd, const void* w, void* dx,
               void* dw, float* partial, long long parts, long long rows, int cols,
               cudaStream_t stream) {
  Shape s;
  if (!plan(cols, s)) return (int)cudaErrorInvalidValue;
  auto kernel = s.wide() ? rmsnorm_bwd_kernel<T, W, kMaxGroup>
                         : rmsnorm_bwd_kernel<T, W, kRowsBlock>;
  kernel<<<(unsigned)parts, s.block, s.bwd_smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), rstd, static_cast<const W*>(w),
      static_cast<T*>(dx), partial, rows, cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rmsnorm_dw_kernel<W><<<(cols + 31) / 32, dim3(32, kSlices), 0, stream>>>(
      partial, static_cast<W*>(dw), (int)parts, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16
#define RMSNORM_DISPATCH(FN, ...)                                                 \
  if (x_dtype == 0 && w_dtype == 0) return FN<float, float>(__VA_ARGS__);             \
  if (x_dtype == 0 && w_dtype == 1) return FN<float, __nv_bfloat16>(__VA_ARGS__);     \
  if (x_dtype == 1 && w_dtype == 0) return FN<__nv_bfloat16, float>(__VA_ARGS__);     \
  if (x_dtype == 1 && w_dtype == 1) return FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__);

// 0, or the CUDA error of the launch (cudaErrorInvalidValue for arguments
// the kernel does not take). rstd may be null (no gradient to come).
extern "C" int rmsnorm_fwd_launch(int x_dtype, int w_dtype, const void* x, const void* w,
                                  void* y, void* rstd, long long rows, int cols, float eps,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  RMSNORM_DISPATCH(launch_fwd, x, w, y, r, rows, cols, eps, s)
  return (int)cudaErrorInvalidValue;
}

// The backward's blocks, each writing one float32 partial row of dw: the
// rows of the buffer rmsnorm_bwd_launch takes. 0 for arguments the kernel
// does not take.
extern "C" long long rmsnorm_bwd_parts(int x_dtype, int w_dtype, long long rows, int cols,
                                       int device) {
  if (cudaSetDevice(device) != cudaSuccess || rows < 0) return 0;
  RMSNORM_DISPATCH(bwd_blocks, rows, cols, device)
  return 0;
}

// dx and dw from x, dy, the forward's rstd and w; partial is [parts, cols]
// float32 scratch, parts from rmsnorm_bwd_parts.
extern "C" int rmsnorm_bwd_launch(int x_dtype, int w_dtype, const void* x, const void* dy,
                                  const void* rstd, const void* w, void* dx, void* dw,
                                  void* partial, long long parts, long long rows, int cols,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || parts < 1 || parts > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(partial);
  RMSNORM_DISPATCH(launch_bwd, x, dy, r, w, dx, dw, p, parts, rows, cols, s)
  return (int)cudaErrorInvalidValue;
}
