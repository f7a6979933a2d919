// Flash attention for prefill: a hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel, the Pallas
// kernel behind repro.kernels.flash_attention.flash_attention and
// repro.kernels.ops.flash_attention.
//
// Computes o = softmax(mask(softcap(q k^T * hd^-1/2))) v with grouped-query
// heads (G = H / KV query heads share one KV head), causal masking at
// q_offset (query i sits at absolute position q_offset + i), an optional
// sliding window (key t attends iff t > q_pos - window) and the key bound
// t < Skv. Scores, the running max m, the denominator l and the accumulator
// are float32; probabilities are rounded to v's type before the PV product,
// as the Pallas kernel rounds them. Masked scores are the finite sentinel
// NEG_INF = -0.7 * FLT_MAX and add exactly zero; a row with no key left
// (l == 0) gives 0, as the Pallas kernel gives when it skips every block of
// such a row, never NaN.
//
// Bound: operations. At the serving shapes (S = 1024, hd = 64) a block reads
// each KV tile once for all G * BQ query rows of its tile, and the causal
// product is 4 * B * H * hd * S(S+1)/2 flops against ~2 * B * S * (H + KV) * hd
// bytes: hundreds of flops per byte, far above the card's ridge point.
//
// Design: the TPU kernel carried m/l/acc in VMEM scratch across a sequential
// KV grid axis. Hopper's blocks run in no order, so one block owns one
// (batch, KV head, query tile) with all G query heads of that KV head folded
// into its rows (the Pallas kernel's GQA fold: a KV tile is loaded once per G
// query heads) and loops over the KV tiles itself, skipping tiles wholly in
// the future (causal) or wholly before the window. Q, K and V tiles are read
// through the strides of the native [B, S, heads, hd] layouts (no transposed
// copy in device memory) and staged in shared memory as float32; the last
// query tile and the last KV tile are masked, so any Sq and Skv work. Each
// warp owns RPW rows: a lane computes the scores of two keys of a 64-key
// tile, the row max and sum are warp shuffles, and a lane accumulates hd/32
// output columns. The products run on the CUDA cores in float32 (fmaf);
// tensor cores (wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -0.7f * 3.402823466e+38f;  // -0.7 * FLT_MAX
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 64;  // keys per KV tile: two per lane
constexpr int kMaxGroup = 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// round a float32 to T and back (the cast of p to v's type)
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;  // strides in elements; head_dim is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int Sq, Skv, KV, G, BQ;
  int causal, window, q_offset;
  float scale, softcap;
};

template <int HD>
struct Tile {
  static constexpr int RPW = HD <= 128 ? 16 : 8;  // rows per warp
  static constexpr int RB = kWarps * RPW;         // rows per block
  static constexpr int DP = HD + 4;  // padded row: float4 reads hit distinct banks
  static constexpr int NC = (HD + 31) / 32;  // output columns per lane
  static constexpr size_t kSharedFloats =
      (size_t)RB * DP + (size_t)kBlockK * DP + (size_t)kBlockK * HD + (size_t)RB * kBlockK;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(FlashArgs a) {
  using Tl = Tile<HD>;
  constexpr int RPW = Tl::RPW, RB = Tl::RB, DP = Tl::DP, NC = Tl::NC;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [RB][DP]
  float* Ks = Qs + RB * DP;                      // [kBlockK][DP]
  float* Vs = Ks + kBlockK * DP;                 // [kBlockK][HD]
  float* Ps = Vs + kBlockK * HD;                 // [RB][kBlockK]

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;
  const int q0 = blockIdx.x * a.BQ;  // first query index of this tile
  const int rows = a.G * a.BQ;       // rows in use: row r is head g = r / BQ,
                                     // query q0 + r % BQ
  const int q_end = min(q0 + a.BQ, a.Sq);

  for (int idx = tid; idx < RB * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int qi = q0 + r % a.BQ;
    float x = 0.f;
    if (r < rows && qi < a.Sq)
      x = to_float(q[b * a.q_sb + qi * a.q_ss + (long long)(kvh * a.G + r / a.BQ) * a.q_sh + d]);
    Qs[r * DP + d] = x;
  }

  // KV tiles that can hold an attended key for some row of this tile
  const int first_q = a.q_offset + q0, last_q = a.q_offset + q_end - 1;
  int kt_end = (a.Skv + kBlockK - 1) / kBlockK;
  if (a.causal) kt_end = last_q < 0 ? 0 : min(kt_end, last_q / kBlockK + 1);
  int kt_begin = 0;
  if (a.window > 0) kt_begin = max(0, first_q - a.window + 1) / kBlockK;

  float m[RPW], l[RPW], acc[RPW][NC];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[rr][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int t0 = kt * kBlockK;
    __syncthreads();  // the previous tile's reads (and the Q stores) are done
    for (int idx = tid; idx < kBlockK * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD, t = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < a.Skv) {
        kx = to_float(k[b * a.k_sb + t * a.k_ss + kvh * a.k_sh + d]);
        vx = to_float(v[b * a.v_sb + t * a.v_ss + kvh * a.v_sh + d]);
      }
      Ks[j * DP + d] = kx;
      Vs[j * HD + d] = vx;
    }
    __syncthreads();

    // scores of this warp's rows against keys t0 + lane and t0 + lane + 32
    float s[RPW][2];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) s[rr][0] = s[rr][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 k0 = *reinterpret_cast<const float4*>(&Ks[lane * DP + d]);
      const float4 k1 = *reinterpret_cast<const float4*>(&Ks[(lane + 32) * DP + d]);
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float4 qv = *reinterpret_cast<const float4*>(&Qs[(warp * RPW + rr) * DP + d]);
        s[rr][0] = fmaf(qv.x, k0.x, s[rr][0]);
        s[rr][0] = fmaf(qv.y, k0.y, s[rr][0]);
        s[rr][0] = fmaf(qv.z, k0.z, s[rr][0]);
        s[rr][0] = fmaf(qv.w, k0.w, s[rr][0]);
        s[rr][1] = fmaf(qv.x, k1.x, s[rr][1]);
        s[rr][1] = fmaf(qv.y, k1.y, s[rr][1]);
        s[rr][1] = fmaf(qv.z, k1.z, s[rr][1]);
        s[rr][1] = fmaf(qv.w, k1.w, s[rr][1]);
      }
    }

    // online softmax, one row at a time; every lane holds the row's m and l
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const int qi = q0 + r % a.BQ;
      const bool active = r < rows && qi < a.Sq;
      const int q_pos = a.q_offset + qi;
      float sv[2];
      bool ok[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int t = t0 + lane + 32 * c;
        ok[c] = active && t < a.Skv && (!a.causal || t <= q_pos) &&
                (a.window <= 0 || t > q_pos - a.window);
        float x = s[rr][c] * a.scale;
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        sv[c] = ok[c] ? x : kNegInf;
      }
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(sv[0], sv[1])));
      const float p0 = ok[0] ? expf(sv[0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(sv[1] - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = alpha * l[rr] + warp_sum(p0 + p1);
      m[rr] = m_new;
      Ps[r * kBlockK + lane] = round_to(p0, T());
      Ps[r * kBlockK + lane + 32] = round_to(p1, T());
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[rr][c] *= alpha;
    }
    __syncwarp();

    // acc += p v for this warp's rows
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          vv[jj][c] = d < HD ? Vs[(j + jj) * HD + d] : 0.f;
        }
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float4 p = *reinterpret_cast<const float4*>(&Ps[(warp * RPW + rr) * kBlockK + j]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[rr][c] = fmaf(p.x, vv[0][c], acc[rr][c]);
          acc[rr][c] = fmaf(p.y, vv[1][c], acc[rr][c]);
          acc[rr][c] = fmaf(p.z, vv[2][c], acc[rr][c]);
          acc[rr][c] = fmaf(p.w, vv[3][c], acc[rr][c]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const int qi = q0 + r % a.BQ;
    if (r >= rows || qi >= a.Sq) continue;
    const float denom = l[rr] == 0.f ? 1.f : l[rr];
    T* orow = o + b * a.o_sb + qi * a.o_ss + (long long)(kvh * a.G + r / a.BQ) * a.o_sh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) store(orow + d, acc[rr][c] / denom);
    }
  }
}

template <typename T, int HD>
int launch(FlashArgs a, int B, cudaStream_t stream) {
  using Tl = Tile<HD>;
  if (a.G < 1 || a.G > kMaxGroup || a.G > Tl::RB) return (int)cudaErrorInvalidValue;
  a.BQ = Tl::RB / a.G;
  const size_t shared = Tl::kSharedFloats * sizeof(float);
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((unsigned)((a.Sq + a.BQ - 1) / a.BQ), (unsigned)(B * a.KV));
  flash_kernel<T, HD><<<grid, kThreads, shared, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(FlashArgs a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<T, 8>(a, B, stream);
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream) of CUDA device `device`.
// dtype 0 is float32, 1 is bfloat16 (q, k, v and o share it). Strides are
// in elements and the head dimension is contiguous. Returns
// cudaGetLastError() after the launch (0 on success); the kernel runs
// asynchronously and a fault during the run shows at the next
// synchronization.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int B, int Sq, int Skv, int H, int KV, int hd,
    int causal, int window, int q_offset, float scale, float softcap, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (KV < 1 || H % KV != 0 || B * KV > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  FlashArgs a{q,    k,    v,    o,    q_sb, q_ss,   q_sh,     k_sb,   k_ss,   k_sh,
              v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,   Sq,       Skv,    KV,     H / KV,
              0,    causal, window, q_offset, scale, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, hd, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, hd, s);
  return (int)cudaErrorInvalidValue;
}
