// Split-KV decode attention: a hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::_decode_kernel, the Pallas
// kernel behind repro.kernels.decode_attention.decode_attention and
// repro.kernels.ops.decode_attention.
//
// Computes, for one query token per sequence, o = softmax(mask(softcap(q k^T
// * hd^-1/2))) v against a KV cache, where cache slot t attends iff
// t < valid_len, with the G = H / KV query heads of a KV head together.
// Scores, m, l and the accumulators are float32; probabilities are rounded
// to v's type before the PV product, as the Pallas kernel rounds them.
// Masked slots add exactly zero; with no slot valid the output is 0.
//
// Bound: bytes. Every valid cache slot is read once (K and V, 2 * KV * hd
// elements a sequence) for G multiply-adds per element: a few flops per byte,
// far below the card's ridge point, so the kernel has to stream the valid
// part of the cache at the memory's rate and read nothing else.
//
// Design: the TPU kernel walked the cache as a sequential grid axis with m/l/
// acc in VMEM scratch, one (batch, KV head) per grid row. On the card that is
// B * KV blocks (64 at the serving shape) for 132 SMs, so the valid range
// [0, valid_len) is split into chunks of split_len slots and each block owns
// one (chunk, batch, KV head): it stages 64-slot tiles of K and V in shared
// memory as float32, runs the online softmax over the chunk, and writes its
// partial (m, l, acc) in float32 to a scratch tensor the wrapper allocates.
// Only chunks that start below valid_len are launched, so the padded cache
// past valid_len is never read. A second launch combines the partials of each
// (batch, KV head): M = max m, L = sum l e^(m-M), o = sum acc e^(m-M) / L.
// The cache is read through the strides of its native [B, T, KV, hd] layout
// (no transposed copy); valid_len is a host integer, so a decode step needs
// no device-to-host synchronisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -0.7f * 3.402823466e+38f;  // -0.7 * FLT_MAX
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;  // cache slots staged per tile
constexpr int kMaxGroup = 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part_acc;  // [B * KV, n_splits, G, hd]
  float* part_ml;   // [B * KV, n_splits, G, 2]
  long long q_sb, q_sh;  // strides in elements; head_dim is contiguous
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_sh;
  int KV, G, valid_len, split_len, n_splits;
  float scale, softcap;
};

template <int HD>
struct Layout {
  static constexpr int DP = HD + 4;  // padded K row: float4 reads hit distinct banks
  static constexpr int NO = (kMaxGroup * HD + kThreads - 1) / kThreads;  // outputs a thread
  static size_t shared_floats(int G) {
    return (size_t)G * HD + (size_t)kTile * DP + (size_t)kTile * HD + (size_t)G * kTile +
           3 * (size_t)G;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(DecodeArgs a) {
  using L = Layout<HD>;
  constexpr int DP = L::DP, NO = L::NO;
  const int G = a.G;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [kTile][DP]
  float* Vs = Ks + kTile * DP;                   // [kTile][HD]
  float* Qs = Vs + kTile * HD;                   // [G][HD]
  float* Ss = Qs + G * HD;                       // [G][kTile]
  float* m_s = Ss + G * kTile;                   // [G]
  float* l_s = m_s + G;                          // [G]
  float* alpha_s = l_s + G;                      // [G]

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.KV, kvh = bh % a.KV;
  const int t_begin = split * a.split_len;
  const int t_end = min(t_begin + a.split_len, a.valid_len);

  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    Qs[idx] = to_float(q[b * a.q_sb + (long long)(kvh * G + g) * a.q_sh + d]);
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    __syncthreads();  // the previous tile's reads (and the Q stores) are done
    for (int idx = tid; idx < kTile * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD, t = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < t_end) {
        kx = to_float(k[b * a.k_sb + t * a.k_st + kvh * a.k_sh + d]);
        vx = to_float(v[b * a.v_sb + t * a.v_st + kvh * a.v_sh + d]);
      }
      Ks[j * DP + d] = kx;
      Vs[j * HD + d] = vx;
    }
    __syncthreads();

    // scores: thread -> (head g, slot j), consecutive threads on consecutive slots
    for (int idx = tid; idx < G * kTile; idx += kThreads) {
      const int g = idx / kTile, j = idx % kTile;
      float s = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(&Ks[j * DP + d]);
        const float4 qv = *reinterpret_cast<const float4*>(&Qs[g * HD + d]);
        s = fmaf(qv.x, kv.x, s);
        s = fmaf(qv.y, kv.y, s);
        s = fmaf(qv.z, kv.z, s);
        s = fmaf(qv.w, kv.w, s);
      }
      s *= a.scale;
      if (a.softcap > 0.f) s = tanhf(s / a.softcap) * a.softcap;
      Ss[idx] = t0 + j < t_end ? s : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int g = warp; g < G; g += kWarps) {
      const bool ok0 = t0 + lane < t_end, ok1 = t0 + lane + 32 < t_end;
      const float s0 = Ss[g * kTile + lane], s1 = Ss[g * kTile + lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      const float alpha = expf(m_old - m_new);
      const float psum = warp_sum(p0 + p1);
      Ss[g * kTile + lane] = round_to(p0, T());
      Ss[g * kTile + lane + 32] = round_to(p1, T());
      if (lane == 0) {
        l_s[g] = alpha * l_s[g] + psum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v: thread -> (head, column) pairs tid + kThreads * i
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int idx = tid + kThreads * i;
      if (idx < G * HD) {
        const int g = idx / HD, d = idx % HD;
        const float* p = Ss + g * kTile;
        float x = acc[i] * alpha_s[g];
#pragma unroll 8
        for (int j = 0; j < kTile; ++j) x = fmaf(p[j], Vs[j * HD + d], x);
        acc[i] = x;
      }
    }
  }
  __syncthreads();

  const long long part = (long long)bh * a.n_splits + split;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int idx = tid + kThreads * i;
    if (idx < G * HD) a.part_acc[part * G * HD + idx] = acc[i];
  }
  for (int g = tid; g < G; g += kThreads) {
    a.part_ml[(part * G + g) * 2] = m_s[g];
    a.part_ml[(part * G + g) * 2 + 1] = l_s[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(DecodeArgs a, int HD) {
  const int G = a.G, bh = blockIdx.x;
  const int b = bh / a.KV, kvh = bh % a.KV;
  T* o = static_cast<T*>(a.o);
  const float* ml = a.part_ml + (long long)bh * a.n_splits * G * 2;
  const float* pacc = a.part_acc + (long long)bh * a.n_splits * G * HD;
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float M = kNegInf;
    for (int s = 0; s < a.n_splits; ++s) M = fmaxf(M, ml[(s * G + g) * 2]);
    float Lsum = 0.f, A = 0.f;
    for (int s = 0; s < a.n_splits; ++s) {
      const float w = expf(ml[(s * G + g) * 2] - M);
      Lsum += ml[(s * G + g) * 2 + 1] * w;
      A += pacc[(long long)s * G * HD + idx] * w;
    }
    const float denom = Lsum == 0.f ? 1.f : Lsum;
    store(o + b * a.o_sb + (long long)(kvh * G + g) * a.o_sh + d, A / denom);
  }
}

template <typename T, int HD>
int launch(DecodeArgs a, int B, cudaStream_t stream) {
  using L = Layout<HD>;
  const size_t shared = L::shared_floats(a.G) * sizeof(float);
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(L::shared_floats(kMaxGroup) * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((unsigned)a.n_splits, (unsigned)(B * a.KV));
  decode_split_kernel<T, HD><<<grid, kThreads, shared, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<B * a.KV, kThreads, 0, stream>>>(a, HD);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(DecodeArgs a, int B, int hd, cudaStream_t stream) {
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

// Launch on `stream` (PyTorch's current stream) of CUDA device `device`: the
// split pass over n_splits chunks of split_len slots, then the combine pass.
// dtype 0 is float32, 1 is bfloat16 (q, the cache and o share it). Strides
// are in elements and the head dimension is contiguous. part_acc and part_ml
// are float32 scratch of B * KV * n_splits * G * hd and * 2 elements.
// valid_len must be at most the cache length and n_splits * split_len must
// cover it. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int decode_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* o, void* part_acc,
    void* part_ml, long long q_sb, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_sh, int B, int H, int KV, int hd, int valid_len, int split_len,
    int n_splits, float scale, float softcap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (KV < 1 || H % KV != 0 || H / KV > kMaxGroup || B * KV > 65535 || n_splits < 1 ||
      split_len < 1 || (long long)n_splits * split_len < valid_len)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  DecodeArgs a{q,    k,    v,    o,    static_cast<float*>(part_acc),
               static_cast<float*>(part_ml), q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
               v_sh, o_sb, o_sh, KV, H / KV, valid_len, split_len, n_splits, scale, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, hd, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, hd, s);
  return (int)cudaErrorInvalidValue;
}
