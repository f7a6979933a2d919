// The gradient of flash attention: hand-written CUDA kernels for Hopper
// (sm_90a).
//
// Replaces: no Pallas kernel. The JAX model takes the gradient of its XLA
// attention (src/repro/models/attention.py::_chunk_scores) by autodiff; the
// port's attention is the flash kernel (flash_attention.cu), so its gradient
// is a kernel too. This is the backward of that kernel's exact function:
// scale hd^-1/2, the tanh logit softcap, causal masking with query i at
// absolute position q_offset + i, the sliding window (key t attends iff
// t > q_pos - window), the key bound t < Skv, grouped-query heads (query head
// h reads KV head h / G) and cross attention (Sq != Skv).
//
// Method (the flash-attention-2 backward). The forward's train launch writes
// the float32 row log-sum-exp lse = m + log(l) of the scaled, softcapped,
// masked scores, +inf for a row with no key. Here:
//   1. D = rowsum(dO * O) of every row (delta_kernel, float32 [B, H, Sq];
//      the tensor-core kernel's stats_kernel keeps lse log2(e) beside it);
//   2. a dK/dV pass: a block owns one KV tile of one KV head and loops over
//      the G query heads of that KV head and over every query tile that can
//      attend the tile, recomputing P = exp(c - lse) from Q and K (c the
//      softcapped score), dP = dO V^T and dS = P (dP - D) c', and summing
//      dV += P^T dO and dK += dS^T Q in registers; then writes dK, dV once;
//   3. a dQ pass: a block owns one query tile of one query head and loops
//      over the KV tiles its rows attend, recomputing P and dS the same way
//      and summing dQ += dS K in registers; then writes dQ once.
// Every sum has a fixed order and every output element one writer: no
// atomics, so two launches on the same inputs give the same bits. A row
// with no key has lse = +inf, so P = 0 and its dQ, and its share of dK and
// dV, are exactly 0, never NaN. c' = 1 - (c / softcap)^2 is the softcap's
// derivative (1 without a softcap).
//
// Bound: operations. The minimum is five products a attended (query, key)
// pair (S = Q K^T, dP = dO V^T, dV, dK, dQ): 10 B H hd flops a pair (about
// half the pairs when causal) against reading Q, K, V, O, dO and lse and
// writing dQ, dK, dV once. At roberta-large's training shape (B 32, S 2048,
// H 16, hd 64) that is 1.374 TFLOP against 1.08 GB: 1.39 ms at the bf16
// peak, far past the ridge point (the bound chip_smoke.py::time_backward
// prints). The two passes make seven products: each computes S and dP, so
// that every output has one writer and no float atomic is needed; 14 flops
// a pair, 1.95 ms at roberta's shape. A one-pass kernel (dQ summed from the
// dK/dV blocks) would need dQ accumulated across blocks in a fixed order
// without atomics and a schedule of those blocks that cannot deadlock; it is
// not attempted.
//
// Two kernel families, chosen by (dtype, hd) in the Python wrapper:
//
// * tensor core (bf16, hd 64): wgmma fed by TMA, warp-specialised. A block
//   of either pass is a producer warpgroup, one thread of which issues every
//   load (the warpgroup keeps 24 registers: setmaxnreg), and two consumer
//   warpgroups of 64 rows that take 240. stats_kernel first writes each
//   row's (lse log2(e), D) pair into a [B, H, Sq rounded up to 128] scratch
//   (+inf and 0 past Sq, so that P = 0 there), from 16-byte loads.
//   - dK/dV pass: a block owns 128 keys of one KV head. K and V come in once
//     by TMA (128-byte swizzle); then the (query head, 64-query tile) pairs
//     of its group stream through a 4-stage ring of mbarrier-guarded stages,
//     each Q and dO by TMA (rows past Sq zero-filled) and the pair's
//     statistics by a bulk copy. Per pair a consumer warpgroup runs S^T = K
//     Q^T and dP^T = V dO^T as wgmma m64n64k16 chains (SS, both K-major),
//     then P^T = exp2(S^T scale log2(e) - lse log2(e)) (one FFMA and one
//     ex2) and dS^T = P^T (dP^T - D) on the accumulator registers, rounds
//     both to bf16 in registers, and runs dV += P^T dO and dK += dS^T Q as RS
//     wgmma, dO and Q read MN-major from the same stage through the
//     descriptor's transpose.
//   - dQ pass: a block owns 128 queries of one query head. Q and dO come in
//     once, 64-key K and V tiles stream through the ring; S = Q K^T and dP =
//     dO V^T (SS), dS, then dQ += dS K (RS, K read MN-major). The two
//     warpgroups take turns issuing their products (named barriers), S and
//     dP of tile i with dQ of tile i - 1, as the forward does.
//   P and dS never leave registers. Only tiles that cross the causal
//   diagonal, a window edge or the ragged end of Sq or Skv apply the mask: a
//   branch uniform over a warpgroup around the elementwise step, so that no
//   wgmma sits on a divergent path (ptxas would serialize them all, C7512);
//   the softcap is a template instance. Measured and rejected on the card
//   (PERF.md, PR 24): turns, or the dQ pass's deferred products, in the
//   dK/dV pass (its S^T, dP^T, dK and dV accumulators already take 128
//   registers a thread of the 168 ptxas allots; 36 bytes spill as it is),
//   and the fixed operands (K, Q) as register fragments.
// * CUDA core (float32, and bf16 at the other head dims): the same two
//   passes with 32-row tiles staged in shared memory as float32 and every
//   product as fmaf, for float32's 2e-5 contract (TF32 would break it) and
//   the small head dims of the smoke configs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, H, Sq], the forward's
  float* delta;      // [B, H, Sq], written by delta_kernel (the CUDA-core passes)
  void* dq;          // [B, Sq, H, hd], contiguous
  void* dk;          // [B, Skv, KV, hd], contiguous
  void* dv;
  long long q_sb, q_ss, q_sh;  // strides in elements; head_dim is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long d_sb, d_ss, d_sh;  // dO
  int B, Sq, Skv, H, KV, G, hd;
  int causal, window, q_offset;
  float scale, softcap;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// query i (absolute position q_offset + i) attends key t
__device__ __forceinline__ bool attends(const BwdArgs& a, int qi, int t) {
  const int qp = a.q_offset + qi;
  return qi < a.Sq && t < a.Skv && (!a.causal || t <= qp) &&
         (a.window <= 0 || t > qp - a.window);
}

// The first and one past the last query index that can attend a key of
// [t0, t0 + n) (clipped to [0, Sq)), the first rounded down to `tile`.
__device__ __forceinline__ void query_range(const BwdArgs& a, int t0, int n, int tile,
                                            int& qb, int& qe) {
  const int t_last = min(t0 + n, a.Skv) - 1;
  qb = a.causal ? max(0, t0 - a.q_offset) : 0;
  qe = a.Sq;
  if (a.window > 0) qe = min(qe, max(0, t_last + a.window - a.q_offset));
  qb = qb / tile * tile;
}

// The KV tiles of `tile` keys that hold a key some query of [q0, q0 + n)
// attends: [kb, ke).
__device__ __forceinline__ void key_range(const BwdArgs& a, int q0, int n, int tile, int& kb,
                                          int& ke) {
  const int q_last = a.q_offset + min(q0 + n, a.Sq) - 1;
  ke = (a.Skv + tile - 1) / tile;
  if (a.causal) ke = q_last < 0 ? 0 : min(ke, q_last / tile + 1);
  kb = a.window > 0 ? max(0, a.q_offset + q0 - a.window + 1) / tile : 0;
}

// P and dS of one (query, key) pair from its raw score s = q.k and
// dp = dO.v: P = exp(c - lse), dS = P (dp - D) c'.
__device__ __forceinline__ void grad_entry(const BwdArgs& a, bool ok, float s, float dp,
                                           float lse, float d, float& p, float& ds) {
  float x = s * a.scale, dt = 1.f;
  if (a.softcap > 0.f) {
    const float th = tanhf(x / a.softcap);
    x = th * a.softcap;
    dt = 1.f - th * th;
  }
  p = ok ? exp2f((x - lse) * kLog2e) : 0.f;
  ds = p * (dp - d) * dt;
}

// ---------------------------------------------------------------------------
// D = rowsum(dO * O): one warp a (b, i, h) row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(BwdArgs a) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(a.B) * a.Sq * a.H) return;
  const int h = static_cast<int>(row % a.H);
  const long long bi = row / a.H;
  const int i = static_cast<int>(bi % a.Sq), b = static_cast<int>(bi / a.Sq);
  const T* o = static_cast<const T*>(a.o) + b * a.o_sb + i * a.o_ss + h * a.o_sh;
  const T* d = static_cast<const T*>(a.dout) + b * a.d_sb + i * a.d_ss + h * a.d_sh;
  float s = 0.f;
  for (int c = lane; c < a.hd; c += 32) s = fmaf(to_float(o[c]), to_float(d[c]), s);
  s = warp_sum(s);
  if (lane == 0) a.delta[(static_cast<long long>(b) * a.H + h) * a.Sq + i] = s;
}

// ---------------------------------------------------------------------------
// CUDA-core passes (float32; bf16 at hd 8, 16, 32, 96, 128, 256)
// ---------------------------------------------------------------------------

namespace cc {

constexpr int kThreads = 128;
constexpr int kTile = 32;         // query rows and keys a tile
constexpr int kPL = kTile + 1;    // padded row of the P and dS tiles

template <int HD>
struct Smem {
  static constexpr int LD = HD + 1;  // padded row: lane-strided reads hit distinct banks
  static constexpr size_t kFloats = 4 * (size_t)kTile * LD + 2 * (size_t)kTile * kPL + 2 * kTile;
};

// rows [r0, r0 + 32) of head `head` of a [B, S, heads, hd] tensor into
// dst[32][LD] as float32, zero past S
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long sb, long long ss,
                                          long long sh, int b, int head, int r0, int S) {
  constexpr int LD = Smem<HD>::LD;
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    float x = 0.f;
    if (r0 + r < S) x = to_float(src[b * sb + (r0 + r) * ss + head * sh + d]);
    dst[r * LD + d] = x;
  }
}

// lse and D of rows [q0, q0 + 32) of head h (lse +inf past Sq: P = 0 there)
__device__ __forceinline__ void load_stats(float* lse_s, float* dl_s, const BwdArgs& a, int b,
                                           int h, int q0) {
  if (threadIdx.x < kTile) {
    const int qi = q0 + threadIdx.x;
    const long long at = (static_cast<long long>(b) * a.H + h) * a.Sq + qi;
    lse_s[threadIdx.x] = qi < a.Sq ? a.lse[at] : __int_as_float(0x7f800000);
    dl_s[threadIdx.x] = qi < a.Sq ? a.delta[at] : 0.f;
  }
}

// P and dS of the 32 x 32 (query, key) tile into Ps, dSs [32][kPL]: thread
// t computes key t % 32 for queries t / 32 + 4 r, r = 0 .. 7
template <int HD>
__device__ __forceinline__ void grad_tile(const BwdArgs& a, const float* Qs, const float* dOs,
                                          const float* Ks, const float* Vs, const float* lse_s,
                                          const float* dl_s, float* Ps, float* dSs, int q0,
                                          int t0) {
  constexpr int LD = Smem<HD>::LD;
  const int j = threadIdx.x % 32, i0 = threadIdx.x / 32;
  float s[8], dp[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) s[r] = dp[r] = 0.f;
  for (int d = 0; d < HD; ++d) {
    const float kd = Ks[j * LD + d], vd = Vs[j * LD + d];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + 4 * r;
      s[r] = fmaf(Qs[i * LD + d], kd, s[r]);
      dp[r] = fmaf(dOs[i * LD + d], vd, dp[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + 4 * r;
    float p, ds;
    grad_entry(a, attends(a, q0 + i, t0 + j), s[r], dp[r], lse_s[i], dl_s[i], p, ds);
    Ps[i * kPL + j] = p;
    dSs[i * kPL + j] = ds;
  }
}

// dK, dV of keys [t0, t0 + 32) of KV head kvh; block (key tile, b * KV + kvh)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(BwdArgs a) {
  constexpr int LD = Smem<HD>::LD, NC = HD / 4;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;
  float* dSs = Ps + kTile * kPL;
  float* lse_s = dSs + kTile * kPL;
  float* dl_s = lse_s + kTile;

  const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV, t0 = blockIdx.x * kTile;
  load_rows<T, HD>(Ks, static_cast<const T*>(a.k), a.k_sb, a.k_ss, a.k_sh, b, kvh, t0, a.Skv);
  load_rows<T, HD>(Vs, static_cast<const T*>(a.v), a.v_sb, a.v_ss, a.v_sh, b, kvh, t0, a.Skv);
  int qb, qe;
  query_range(a, t0, kTile, kTile, qb, qe);

  const int jk = threadIdx.x / 4, sub = threadIdx.x % 4;  // this thread's key, column set
  float dk[NC], dv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dk[c] = dv[c] = 0.f;
  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    for (int q0 = qb; q0 < qe; q0 += kTile) {
      __syncthreads();  // the previous tile's reads are done
      load_rows<T, HD>(Qs, static_cast<const T*>(a.q), a.q_sb, a.q_ss, a.q_sh, b, h, q0, a.Sq);
      load_rows<T, HD>(dOs, static_cast<const T*>(a.dout), a.d_sb, a.d_ss, a.d_sh, b, h, q0,
                       a.Sq);
      load_stats(lse_s, dl_s, a, b, h, q0);
      __syncthreads();
      grad_tile<HD>(a, Qs, dOs, Ks, Vs, lse_s, dl_s, Ps, dSs, q0, t0);
      __syncthreads();
      for (int i = 0; i < kTile; ++i) {
        const float p = Ps[i * kPL + jk], ds = dSs[i * kPL + jk];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv[c] = fmaf(p, dOs[i * LD + sub + 4 * c], dv[c]);
          dk[c] = fmaf(ds, Qs[i * LD + sub + 4 * c], dk[c]);
        }
      }
    }
  }
  const int t = t0 + jk;
  if (t < a.Skv) {
    const long long row = ((static_cast<long long>(b) * a.Skv + t) * a.KV + kvh) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(static_cast<T*>(a.dk) + row + sub + 4 * c, dk[c] * a.scale);
      store(static_cast<T*>(a.dv) + row + sub + 4 * c, dv[c]);
    }
  }
}

// dQ of queries [q0, q0 + 32) of query head h; block (query tile, b * H + h)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdArgs a) {
  constexpr int LD = Smem<HD>::LD, NC = HD / 4;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;
  float* dSs = Ps + kTile * kPL;
  float* lse_s = dSs + kTile * kPL;
  float* dl_s = lse_s + kTile;

  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H, kvh = h / a.G;
  const int q0 = blockIdx.x * kTile;
  load_rows<T, HD>(Qs, static_cast<const T*>(a.q), a.q_sb, a.q_ss, a.q_sh, b, h, q0, a.Sq);
  load_rows<T, HD>(dOs, static_cast<const T*>(a.dout), a.d_sb, a.d_ss, a.d_sh, b, h, q0, a.Sq);
  load_stats(lse_s, dl_s, a, b, h, q0);
  int kb, ke;
  key_range(a, q0, kTile, kTile, kb, ke);

  const int iq = threadIdx.x / 4, sub = threadIdx.x % 4;  // this thread's query, column set
  float dq[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dq[c] = 0.f;
  for (int kt = kb; kt < ke; ++kt) {
    const int t0 = kt * kTile;
    __syncthreads();  // the previous tile's reads (and the first loads) are done
    load_rows<T, HD>(Ks, static_cast<const T*>(a.k), a.k_sb, a.k_ss, a.k_sh, b, kvh, t0, a.Skv);
    load_rows<T, HD>(Vs, static_cast<const T*>(a.v), a.v_sb, a.v_ss, a.v_sh, b, kvh, t0, a.Skv);
    __syncthreads();
    grad_tile<HD>(a, Qs, dOs, Ks, Vs, lse_s, dl_s, Ps, dSs, q0, t0);
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      const float ds = dSs[iq * kPL + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) dq[c] = fmaf(ds, Ks[j * LD + sub + 4 * c], dq[c]);
    }
  }
  const int qi = q0 + iq;
  if (qi < a.Sq) {
    T* row = static_cast<T*>(a.dq) + ((static_cast<long long>(b) * a.Sq + qi) * a.H + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(row + sub + 4 * c, dq[c] * a.scale);
  }
}

template <typename T, int HD>
int launch(const BwdArgs& a, cudaStream_t stream) {
  const size_t shared = Smem<HD>::kFloats * sizeof(float);
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)shared);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 g1((unsigned)((a.Skv + kTile - 1) / kTile), (unsigned)(a.B * a.KV));
  dkdv_kernel<T, HD><<<g1, kThreads, shared, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((unsigned)((a.Sq + kTile - 1) / kTile), (unsigned)(a.B * a.H));
  dq_kernel<T, HD><<<g2, kThreads, shared, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const BwdArgs& a, cudaStream_t stream) {
  switch (a.hd) {
    case 8: return launch<T, 8>(a, stream);
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 96: return launch<T, 96>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace cc

// ---------------------------------------------------------------------------
// Tensor-core passes (bf16, hd 64): wgmma fed by TMA, warp-specialised
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kRow = 128;          // bytes of a swizzled tile row: 64 bf16
constexpr int kBlockRows = 128;    // rows a block owns: two consumer warpgroups of 64
constexpr int kLoopRows = 64;      // rows of a loop tile (queries, or keys in the dQ pass)
constexpr int kStages = 4;
constexpr int kConsumers = 256;    // the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;
// the producer warpgroup keeps 24 registers and leaves 240 to each consumer
// thread: 128 x 24 + 256 x 240 <= 65536
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kBlockTile = kBlockRows * kRow;  // a [128][64] bf16 tile, 16 KB
constexpr int kLoopTile = kLoopRows * kRow;    // a [64][64] bf16 tile, 8 KB
constexpr int kStageBytes = 2 * kLoopTile;     // Q and dO, or K and V
constexpr int kStatBytes = kLoopRows * 8;      // a stage's (lse log2(e), D) pairs (dK/dV pass)
// Shared memory: the block's two tiles, the ring's stages, the stages'
// statistics, then the mbarriers; 1024 bytes of slack align the tiles to the
// swizzle's 1024-byte period.
constexpr int kDataBytes = 2 * kBlockTile + kStages * kStageBytes;
constexpr int kSmem = 1024 + kDataBytes + kStages * kStatBytes + 8 * (1 + 2 * kStages);

// The rows of the statistics [B, H, stat_rows(Sq)] of (lse log2(e), D)
// pairs: Sq rounded up to a block, rows past Sq (+inf, 0), so that a P
// made from them is 0 and every stage's 512 bytes can be copied whole.
inline int stat_rows(int Sq) { return (Sq + kBlockRows - 1) / kBlockRows * kBlockRows; }

// The statistics of every row: D = rowsum(dO * O) from 16-byte loads, eight
// threads a (b, i, h) row summing in a fixed order, and lse log2(e) beside it
__global__ void __launch_bounds__(256) stats_kernel(BwdArgs a, float2* stats, int rows) {
  const long long row = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / 8;
  const int part = threadIdx.x % 8;
  const bool live = row < static_cast<long long>(a.B) * a.H * rows;  // whole warps shuffle
  const int i = static_cast<int>(row % rows);
  const long long bh = row / rows;
  const int h = static_cast<int>(bh % a.H), b = static_cast<int>(bh / a.H);
  float s = 0.f;
  if (live && i < a.Sq) {
    const uint4 o = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.o) +
                                                    b * a.o_sb + i * a.o_ss + h * a.o_sh + 8 * part);
    const uint4 d = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.dout) +
                                                    b * a.d_sb + i * a.d_ss + h * a.d_sh + 8 * part);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 of = __bfloat1622float2(o2[j]), df = __bfloat1622float2(d2[j]);
      s = fmaf(of.x, df.x, s);
      s = fmaf(of.y, df.y, s);
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  if (live && part == 0)
    stats[row] = i < a.Sq ? make_float2(a.lse[bh * a.Sq + i] * kLog2e, s)
                          : make_float2(__int_as_float(0x7f800000), 0.f);
}

// 2^x in one MUFU instruction (results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// P = exp(c - lse) and dS = P (dP - D) c' of one (query, key) pair, in place
// on the wgmma accumulators: s the raw score q.k, dp = dO.v, l2 = lse
// log2(e) of the query's row, d its D; `ok` false for a masked pair (P = 0).
// Without a softcap one FFMA and one exp2 make P. With one, tanh(x / cap) =
// 1 - 2 / (e^(2x / cap) + 1) needs no branch (tanhf branches on |x|).
template <bool kCap>
__device__ __forceinline__ void grad_pair(float& s, float& dp, float l2, float d,
                                          const BwdArgs& a, bool ok) {
  float p, dt = 1.f;
  if constexpr (kCap) {
    const float th =
        1.f - __fdividef(2.f, exp2_ftz(s * (2.f * kLog2e * a.scale / a.softcap)) + 1.f);
    p = exp2_ftz(fmaf(th, a.softcap * kLog2e, -l2));
    dt = 1.f - th * th;
  } else {
    p = exp2_ftz(fmaf(s, a.scale * kLog2e, -l2));
  }
  p = ok ? p : 0.f;
  s = p;
  dp = kCap ? p * (dp - d) * dt : p * (dp - d);
}

// Whether every query of [q_first, q_last] attends every key of [t_first,
// t_last] (queries past Sq have lse = +inf, so P = 0 there without a mask)
__device__ __forceinline__ bool interior(const BwdArgs& a, int q_first, int q_last, int t_first,
                                         int t_last) {
  q_last = min(q_last, a.Sq - 1);
  return t_last < a.Skv && (!a.causal || t_last <= a.q_offset + q_first) &&
         (a.window <= 0 || t_first > a.q_offset + q_last - a.window);
}

// P^T and dS^T of a dK/dV tile: st = S^T and dp = dP^T of the warpgroup's
// keys x the tile's 64 queries; entry 4j + 2hr + c is key `key0 + 8 hr`,
// query q0 + 8j + 2 (lane % 4) + c, whose (lse log2(e), D) pair the stage
// holds at stats[2 (8j + 2 (lane % 4) + c)].
template <bool kCap, bool kMask>
__device__ __forceinline__ void grad_tile_t(float (&st)[32], float (&dp)[32], const float* stats,
                                            const BwdArgs& a, int key0, int q0, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    const float4 ld = *reinterpret_cast<const float4*>(stats + 2 * col);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * hr + c;
        const bool ok = !kMask || attends(a, q0 + col + c, key0 + 8 * hr);
        grad_pair<kCap>(st[e], dp[e], c ? ld.z : ld.x, c ? ld.w : ld.y, a, ok);
      }
  }
}

// P and dS of a dQ tile: s = S and dp = dP of the thread's rows qi[hr]
// (statistics st[hr]) x the tile's keys t0 + 8j + 2 (lane % 4) + c
template <bool kCap, bool kMask>
__device__ __forceinline__ void grad_tile(float (&s)[32], float (&dp)[32], const float2 (&st)[2],
                                          const BwdArgs& a, const int (&qi)[2], int t0, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * hr + c;
        const bool ok = !kMask || attends(a, qi[hr], t0 + 8 * j + 2 * (lane % 4) + c);
        grad_pair<kCap>(s[e], dp[e], st[hr].x, st[hr].y, a, ok);
      }
}

// An m64n64 accumulator as the bf16 A fragments of the four k16 steps of a
// product whose depth is its 64 columns
__device__ __forceinline__ void pack_a(uint32_t (&f)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) f[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// acc[32] += A B over 64 of depth: A from the fragments f, B the MN-major
// [64 depth rows][64 columns] tile at `tile` (read transposed by the
// descriptor, a k16 step 16 rows = 2048 bytes on)
__device__ __forceinline__ void product_rs(float (&acc)[32], const uint32_t (&f)[4][4],
                                           uint32_t tile) {
  const uint64_t db = smem_desc(tile, kLoopTile, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n64(acc, f[kk], db + ((kk * 16 * kRow) >> 4));
}

// acc[32] = A B^T over the 64 head-dim columns: A the 64 rows at `a_rows`, B
// the 64 rows at `b_rows`, both K-major (a k16 step 32 bytes on)
__device__ __forceinline__ void product_ss(float (&acc)[32], uint32_t a_rows, uint32_t b_rows) {
  const uint64_t da = smem_desc(a_rows, 16, 1024), db = smem_desc(b_rows, 16, 1024);
  clobber_regs(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64(acc, da + ((kk * 32) >> 4), db + ((kk * 32) >> 4), kk > 0);
}

// write a warpgroup's [64][64] accumulator times `mul` as bf16: the thread's
// rows row0 and row0 + 8 (those below n_rows) of a contiguous [.., heads,
// 64] output at head `head`
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[32], float mul,
                                           long long b_rows, int row0, int n_rows, int heads,
                                           int head, int lane) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + 8 * hr;
    if (r >= n_rows) continue;
    __nv_bfloat16* p = out + ((b_rows + r) * heads + head) * 64 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack_bf16(acc[4 * j + 2 * hr] * mul, acc[4 * j + 2 * hr + 1] * mul);
  }
}

// dK, dV of keys [t0, t0 + 128) of KV head kvh; block (b * KV + kvh, key
// block). Consumer warpgroup wg owns keys t0 + 64 wg ..: S^T = K Q^T, dP^T =
// V dO^T (SS), then P^T and dS^T on the accumulators, then dV += P^T dO and
// dK += dS^T Q (RS). The loop runs over the (query head of the group,
// 64-query tile) pairs; one producer thread brings K and V in once and each
// pair's Q, dO and statistics into the ring.
template <bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                BwdArgs a, const float2* stat_g, int rows) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t k_s = (base + 1023) & ~1023u, v_s = k_s + kBlockTile;
  const uint32_t ring = v_s + kBlockTile;  // stage s: Q at ring + s kStageBytes, dO after it
  const uint32_t stat_s = ring + kStages * kStageBytes;  // stage s: kStatBytes at + s kStatBytes
  const float* stats = reinterpret_cast<const float*>(smem_raw + (stat_s - base));
  const uint32_t kv_bar = stat_s + kStages * kStatBytes;
  const uint32_t full_bar = kv_bar + 8, empty_bar = full_bar + 8 * kStages;

  const int b = blockIdx.x / a.KV, kvh = blockIdx.x % a.KV, t0 = blockIdx.y * kBlockRows;
  int qb, qe;
  query_range(a, t0, kBlockRows, kLoopRows, qb, qe);
  const int nq = qe > qb ? (qe - qb + kLoopRows - 1) / kLoopRows : 0, n_iter = a.G * nq;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers / 32);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer: one thread issues every load
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(kv_bar, 2 * kBlockTile);
      tma_load_4d(k_s, &tm_k, kv_bar, 0, kvh, t0, b);
      tma_load_4d(v_s, &tm_v, kv_bar, 0, kvh, t0, b);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        mbar_wait(empty_bar + 8 * s, ((it / kStages) & 1) ^ 1);  // the stage is free
        mbar_expect_tx(full_bar + 8 * s, kStageBytes + kStatBytes);
        const int h = kvh * a.G + it / nq, q0 = qb + (it % nq) * kLoopRows;
        const uint32_t q_t = ring + s * kStageBytes;
        tma_load_4d(q_t, &tm_q, full_bar + 8 * s, 0, h, q0, b);
        tma_load_4d(q_t + kLoopTile, &tm_do, full_bar + 8 * s, 0, h, q0, b);
        bulk_load(stat_s + s * kStatBytes, stat_g + (static_cast<long long>(b) * a.H + h) * rows + q0,
                  kStatBytes, full_bar + 8 * s);
      }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int kw = t0 + wg * 64;                 // the warpgroup's first key
  const int key0 = kw + warp * 16 + lane / 4;  // the thread's keys key0, key0 + 8
  const uint32_t k_wg = k_s + wg * 64 * kRow, v_wg = v_s + wg * 64 * kRow;
  float dk[32], dv[32], st[32], dp[32];
  uint32_t pf[4][4], sf[4][4];  // P^T and dS^T as A fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  auto issue_sdp = [&](int s) {
    product_ss(st, k_wg, ring + s * kStageBytes);              // S^T
    product_ss(dp, v_wg, ring + s * kStageBytes + kLoopTile);  // dP^T
    wgmma_commit();
  };
  auto issue_dkdv = [&](int s) {
    product_rs(dv, pf, ring + s * kStageBytes + kLoopTile);  // dV += P^T dO
    product_rs(dk, sf, ring + s * kStageBytes);              // dK += dS^T Q
    wgmma_commit();
  };
  auto grad = [&](int it) {
    const int s = it % kStages, q0 = qb + (it % nq) * kLoopRows;
    const float* sts = stats + s * (kStatBytes / 4);
    if (interior(a, q0, q0 + kLoopRows - 1, kw, kw + 63))
      grad_tile_t<kCap, false>(st, dp, sts, a, key0, q0, lane);
    else
      grad_tile_t<kCap, true>(st, dp, sts, a, key0, q0, lane);
  };

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    mbar_wait(full_bar + 8 * s, (it / kStages) & 1);
    wgmma_fence();
    issue_sdp(s);
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dp);
    grad(it);
    pack_a(pf, st);
    pack_a(sf, dp);
    wgmma_fence();
    issue_dkdv(s);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pf);
    fence_regs(sf);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);  // done with the stage
  }

  const long long b_rows = static_cast<long long>(b) * a.Skv;
  store_rows(static_cast<__nv_bfloat16*>(a.dk), dk, a.scale, b_rows, key0, a.Skv, a.KV, kvh, lane);
  store_rows(static_cast<__nv_bfloat16*>(a.dv), dv, 1.f, b_rows, key0, a.Skv, a.KV, kvh, lane);
}

// dQ of queries [q0, q0 + 128) of query head h; block (b * H + h, query
// block, the last first: causal rows there attend the most keys). Consumer
// warpgroup wg owns queries q0 + 64 wg ..: S = Q K^T and dP = dO V^T (SS),
// then dS on the accumulators, then dQ += dS K (RS). The producer brings Q
// and dO in once and the 64-key K and V tiles into the ring. The two
// warpgroups take turns issuing their products (named barriers 1 and 2): S
// and dP of tile i together with dQ += dS K of tile i - 1, so that one
// warpgroup's elementwise step runs under the other's products and under
// its own dQ product; the first and last turns are peeled, so that no wgmma
// sits under a branch inside the loop.
template <bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
              const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              BwdArgs a, const float2* stat_g, int rows) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u, do_s = q_s + kBlockTile;
  const uint32_t ring = do_s + kBlockTile;  // stage s: K at ring + s kStageBytes, V after it
  const uint32_t q_bar = ring + kStages * kStageBytes;
  const uint32_t full_bar = q_bar + 8, empty_bar = full_bar + 8 * kStages;

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, kvh = h / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;
  int kb, ke;
  key_range(a, q0, kBlockRows, kLoopRows, kb, ke);
  const int n_tiles = max(0, ke - kb);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_bar, 2 * kBlockTile);
      tma_load_4d(q_s, &tm_q, q_bar, 0, h, q0, b);
      tma_load_4d(do_s, &tm_do, q_bar, 0, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(empty_bar + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * s, kStageBytes);
        const uint32_t k_t = ring + s * kStageBytes;
        tma_load_4d(k_t, &tm_k, full_bar + 8 * s, 0, kvh, (kb + i) * kLoopRows, b);
        tma_load_4d(k_t + kLoopTile, &tm_v, full_bar + 8 * s, 0, kvh, (kb + i) * kLoopRows, b);
      }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int qw = q0 + wg * 64;  // the warpgroup's first query
  const int qi[2] = {qw + warp * 16 + lane / 4, qw + warp * 16 + lane / 4 + 8};
  // the rows' (lse log2(e), D); qi < stat_rows(Sq): the block lies inside
  const float2 stat[2] = {stat_g[(static_cast<long long>(b) * a.H + h) * rows + qi[0]],
                          stat_g[(static_cast<long long>(b) * a.H + h) * rows + qi[1]]};
  const uint32_t q_wg = q_s + wg * 64 * kRow, do_wg = do_s + wg * 64 * kRow;
  float dq[32], sc[32], dp[32];
  uint32_t sf[4][4];  // dS of the tile before, as A fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  auto issue_sdp = [&](int st) {
    product_ss(sc, q_wg, ring + st * kStageBytes);               // S
    product_ss(dp, do_wg, ring + st * kStageBytes + kLoopTile);  // dP
    wgmma_commit();
  };
  auto issue_dq = [&](int st) {
    product_rs(dq, sf, ring + st * kStageBytes);  // dQ += dS K
    wgmma_commit();
  };
  auto grad = [&](int i) {
    const int t0 = (kb + i) * kLoopRows;
    if (interior(a, qw, qw + 63, t0, t0 + kLoopRows - 1))
      grad_tile<kCap, false>(sc, dp, stat, a, qi, t0, lane);
    else
      grad_tile<kCap, true>(sc, dp, stat, a, qi, t0, lane);
  };

  const int my_turn = 1 + wg, their_turn = 2 - wg;
  mbar_wait(q_bar, 0);
  if (n_tiles > 0) {
    if (wg == 1) named_arrive(1);  // warpgroup 0 goes first
    mbar_wait(full_bar, 0);
    named_sync(my_turn);
    wgmma_fence();
    issue_sdp(0);
    named_arrive(their_turn);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    grad(0);
    pack_a(sf, dp);
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % kStages, prev = (i - 1) % kStages;
      mbar_wait(full_bar + 8 * st, (i / kStages) & 1);
      named_sync(my_turn);
      wgmma_fence();
      issue_sdp(st);
      issue_dq(prev);
      named_arrive(their_turn);
      wgmma_wait<1>();  // S and dP are done; the dQ product may still run
      fence_regs(sc);
      fence_regs(dp);
      grad(i);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(sf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * prev);  // done with tile i - 1's stage
      pack_a(sf, dp);
    }
    named_sync(my_turn);
    wgmma_fence();
    issue_dq((n_tiles - 1) % kStages);
    if (wg == 0) named_arrive(their_turn);  // warpgroup 1's last turn: none follows
    wgmma_wait<0>();
    fence_regs(dq);
  }
  store_rows(static_cast<__nv_bfloat16*>(a.dq), dq, a.scale, static_cast<long long>(b) * a.Sq,
             qi[0], a.Sq, a.H, h, lane);
}

template <bool kCap>
int launch_passes(const CUtensorMap (&m)[8], const BwdArgs& a, float2* stats,
                  cudaStream_t stream) {
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<kCap>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dq_kernel<kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int rows = stat_rows(a.Sq);
  const long long n = static_cast<long long>(a.B) * a.H * rows;
  stats_kernel<<<static_cast<unsigned>((n * 8 + 255) / 256), 256, 0, stream>>>(a, stats, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g1(static_cast<unsigned>(a.B * a.KV),
                static_cast<unsigned>((a.Skv + kBlockRows - 1) / kBlockRows));
  dkdv_kernel<kCap><<<g1, kThreads, kSmem, stream>>>(m[0], m[1], m[2], m[3], a, stats,
                                                            rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 g2(static_cast<unsigned>(a.B * a.H), static_cast<unsigned>(rows / kBlockRows));
  dq_kernel<kCap><<<g2, kThreads, kSmem, stream>>>(m[4], m[5], m[6], m[7], a, stats, rows);
  return static_cast<int>(cudaGetLastError());
}

// The statistics, then both passes: the eight tensor maps (128-byte
// swizzled 64-column boxes; the block's tiles 128 rows, the ring's 64), the
// dK/dV pass and the dQ pass. `stats` is the caller's float32 scratch of
// [B, H, stat_rows(Sq), 2]. Returns 0, a CUDA error, or minus the driver's
// CUresult when a map cannot be encoded.
int launch(const BwdArgs& a, float2* stats, cudaStream_t stream) {
  constexpr CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  struct Src {
    const void* p;
    int S, heads;
    long long sb, ss, sh;
  };
  const Src k{a.k, a.Skv, a.KV, a.k_sb, a.k_ss, a.k_sh}, v{a.v, a.Skv, a.KV, a.v_sb, a.v_ss, a.v_sh};
  const Src q{a.q, a.Sq, a.H, a.q_sb, a.q_ss, a.q_sh}, d{a.dout, a.Sq, a.H, a.d_sb, a.d_ss, a.d_sh};
  // dK/dV pass: K, V (the block's), Q, dO (the ring's); dQ pass: Q, dO, K, V
  const Src order[8] = {k, v, q, d, q, d, k, v};
  CUtensorMap m[8];
  for (int i = 0; i < 8; ++i) {
    const Src& t = order[i];
    const int rows = i % 4 < 2 ? kBlockRows : kLoopRows;
    const int r = encode_map(&m[i], bf16, 2, t.p, a.B, t.S, t.heads, 64, t.sb, t.ss, t.sh, 64,
                             rows, sw);
    if (r != 0) return -r;
  }
  return a.softcap > 0.f ? launch_passes<true>(m, a, stats, stream)
                         : launch_passes<false>(m, a, stats, stream);
}

}  // namespace tc

}  // namespace

// The gradient of flash attention on `stream` (PyTorch's current stream) of
// CUDA device `device`: dq [B, Sq, H, hd], dk and dv [B, Skv, KV, hd]
// (contiguous, allocated by the caller) from dout, q, k, v, o (strided, the
// head dim contiguous), the forward's lse [B, H, Sq] and a float32 scratch
// delta. variant 1 is the tensor-core kernel (bf16, hd 64; the base
// addresses and strides of dout, q, k, v and o must be multiples of 16
// bytes; delta holds [B, H, Sq rounded up to 128, 2]), 0 the CUDA-core
// kernel (dtype 0 float32, 1 bfloat16; delta holds [B, H, Sq]). Returns 0,
// cudaGetLastError() after a refused launch, or minus the driver's CUresult
// when a tensor map cannot be encoded; the kernels run asynchronously and a
// fault shows at the next synchronization.
extern "C" int flash_attention_bwd_launch(
    int variant, int dtype, const void* dout, const void* q, const void* k, const void* v,
    const void* o, const float* lse, float* delta, void* dq, void* dk, void* dv, long long d_sb,
    long long d_ss, long long d_sh, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, int B, int Sq, int Skv,
    int H, int KV, int hd, int causal, int window, int q_offset, float scale, float softcap,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (KV < 1 || H % KV != 0 || B * H > 65535 || (variant == 1 && (dtype != 1 || hd != 64)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Skv == 0) return (int)cudaSuccess;  // the caller's zeros stand
  BwdArgs a{q,    k,    v,    o,    dout, lse,  delta, dq,   dk,   dv,   q_sb,  q_ss,
            q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,  o_sb, o_ss, o_sh, d_sb,  d_ss,
            d_sh, B,    Sq,   Skv,  H,    KV,   H / KV, hd,  causal, window, q_offset,
            scale, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) return tc::launch(a, reinterpret_cast<float2*>(delta), s);
  const long long rows = static_cast<long long>(B) * Sq * H;
  const unsigned blocks = static_cast<unsigned>((rows + 7) / 8);
  if (dtype == 0)
    delta_kernel<float><<<blocks, 256, 0, s>>>(a);
  else if (dtype == 1)
    delta_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0) return cc::dispatch<float>(a, s);
  return cc::dispatch<__nv_bfloat16>(a, s);
}
