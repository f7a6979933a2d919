// Flash attention for prefill: hand-written CUDA kernels for Hopper (sm_90a).
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
// such a row, never NaN. The training launch also writes each row's float32
// log-sum-exp m + log(l) of its scaled, softcapped, masked scores (+inf for
// a row with no key), which the backward (flash_attention_bwd.cu) reads.
//
// Bound: operations for grouped-query heads. At the serving shapes (S =
// 1024, hd = 64, G = 4) a block reads each KV tile once for all its query
// rows, and the causal product is 4 * B * H * hd * S(S+1)/2 flops against
// ~2 * B * S * (H + KV) * hd bytes: hundreds of flops per byte, far above
// the card's ridge point. With one query head a KV head (gpt-neox-20b,
// opt-30b) at S = 1024 the byte count bounds it.
//
// The TPU kernel carried m/l/acc in VMEM scratch across a sequential KV grid
// axis. Hopper's blocks run in no order, so a block owns a tile of query
// rows and loops over the KV tiles itself, skipping tiles wholly in the
// future (causal) or wholly before the window. Q, K and V are read through
// the strides of the native [B, S, heads, hd] layouts (no transposed copy).
// Two kernels, chosen by (dtype, hd) in the Python wrapper:
//
// * flash_tc_kernel (bf16, hd 64, 96, 128 or 256): the tensor-core kernel. A
//   block owns (batch, query head, 128-query tile): two consumer warpgroups
//   of 64 rows and a producer warpgroup, 384 threads. The producer gives up
//   its registers (setmaxnreg.dec to 24) so that the consumers can take 240
//   (setmaxnreg.inc), and one of its threads issues TMA loads through 4-D
//   tensor maps over the native layouts: Q once, then K and V tiles (128
//   keys at hd 64, 64 at hd 96 and 128, 32 at hd 256) into a 4-stage ring
//   of mbarrier-guarded buffers, 128-byte swizzled, rows past Skv
//   zero-filled. Each consumer warpgroup runs S = Q K^T as a chain of
//   wgmma (Q and K K-major in shared memory), the online softmax on the
//   float32 accumulator registers (row max and sum over the four lanes that
//   share a row), rounds P to bf16 in registers and runs O += P V as wgmma
//   with P as the register A operand and V read MN-major from the same
//   swizzled tile through the descriptor's transpose. The two warpgroups take turns issuing their
//   products (named barriers), S of tile i together with PV of tile i - 1,
//   so that one warpgroup's softmax runs under the other's products and
//   under its own PV product. The first and last turns are peeled off the
//   loop, so that no wgmma sits under a branch (ptxas serializes every
//   wgmma of a kernel with one on a divergent path). The K/V re-reads of
//   the G heads of one KV head hit L2.
//   hd 96 runs the hd-128 tile: its tensor maps have an inner dimension of
//   96 and two 64-column boxes, TMA zero-fills columns 96-127 of the second
//   (they lie past the dimension), the zero columns add exactly 0 to Q K^T
//   and the epilogue writes the first 96 of PV's 128 columns. Device memory
//   traffic stays at 96 columns; the tensor cores do a third more work.
//   hd 256 needs O's 64 x 256 float32 accumulator (128 registers a
//   thread) beside S and P: 32-key tiles keep S and P at 16 and 8
//   registers, and shared memory (Q 64 KB, a stage 32 KB) holds 4 stages.
//   ptxas still allocates the consumers fewer registers than this code
//   takes unbounded, so it spills a little and runs the wgmma chains one
//   product at a time at hd 256 (the ptxas lines chip_smoke.py prints).
// * flash_kernel (float32, where TF32 would break the 2e-5 contract, and
//   bf16 at hd 8, 16 and 32): the CUDA-core kernel. One block owns a
//   (batch, KV head, query tile) with the G query heads of that KV head
//   folded into its rows; tiles are staged in shared memory as float32 and
//   both products run as fmaf, a lane computing two keys of a 64-key tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "wgmma.cuh"

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
  float* lse;  // [B, H, Sq] row log-sum-exp (the train launch), or null
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
    const int h = kvh * a.G + r / a.BQ;
    if (a.lse != nullptr && lane == 0)
      a.lse[((long long)b * a.KV * a.G + h) * a.Sq + qi] =
          l[rr] == 0.f ? __int_as_float(0x7f800000) : m[rr] + logf(l[rr]);
    T* orow = o + b * a.o_sb + qi * a.o_ss + (long long)h * a.o_sh;
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

// bf16 at hd 64, 96, 128 and 256 runs the tensor-core kernel, never this one
template <typename T>
int dispatch(FlashArgs a, int B, int hd, cudaStream_t stream) {
  constexpr bool f32 = sizeof(T) == 4;
  switch (hd) {
    case 8: return launch<T, 8>(a, B, stream);
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
  }
  if constexpr (f32) {
    switch (hd) {
      case 64: return launch<T, 64>(a, B, stream);
      case 96: return launch<T, 96>(a, B, stream);  // NC = 3 columns a lane
      case 128: return launch<T, 128>(a, B, stream);
      case 256: return launch<T, 256>(a, B, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16, hd 64, 96, 128 or 256)
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kBM = 128;         // query rows a block: two warpgroups of 64
constexpr int kConsumers = 256;  // the two consumer warpgroups
constexpr int kRow = 128;        // bytes of a swizzled panel row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

// Per head dim. Shared memory: a [rows][kTD] bf16 tile is kTD / 64 panels
// of [rows][64], each row 128 bytes with the 128-byte swizzle TMA writes and
// wgmma reads. Q's tile, then per stage a K tile and a V tile, then the
// mbarriers.
//
// kTD: the tile's head-dim columns; hd 96 runs in a 128-column tile whose
// last 32 columns TMA zero-fills. block_n: keys a KV tile, 128 at hd 64; 64
// at hd 96 and 128, so that a consumer thread's S tile, the P of the tile
// before it and its O accumulator (64 + 32 + 64 registers at 128 keys) stay
// within the 168 registers ptxas allots a thread of a 384-thread block
// (setmaxnreg does not raise what ptxas allots); 32 at hd 256, where O
// alone is 128 registers and Q's 64 KB tile leaves 4 stages of 32 KB in
// the 227 KB a block may have (64-key tiles fit only 2 stages, and spilled
// more: slower).
constexpr int block_n(int hd) { return hd == 64 ? 128 : hd == 256 ? 32 : 64; }

template <int HD>
struct Cfg {
  static constexpr int kTD = HD == 96 ? 128 : HD;
  static constexpr int kBN = block_n(HD);
  static constexpr int kPanels = kTD / 64;
  static constexpr int kStages = 4;
  // the producer is a warpgroup (setmaxnreg acts on whole warpgroups) that
  // keeps 24 registers and leaves 240 to each consumer thread:
  // 128 x 24 + 256 x 240 <= 65536
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr int kQBytes = kBM * kTD * 2;
  static constexpr int kTileBytes = kBN * kTD * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kDataBytes = kQBytes + kStages * kStageBytes;
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte period
  static constexpr int kSmem = 1024 + kDataBytes + 8 * (1 + 2 * kStages);
};

struct TcArgs {
  void* o;
  float* lse;  // [B, H, Sq] row log-sum-exp (the train launch), or null
  long long o_sb, o_ss, o_sh;  // strides in elements; head_dim is contiguous
  int Sq, Skv, G, n_qtiles;
  int causal, window, q_offset;
  float scale, softcap;
};

// The absolute positions of a consumer thread's two rows, and the first and
// last of its warpgroup's rows below Sq.
struct Rows {
  int pos0, pos1, wg_first, wg_last;
};

// cap * tanh(x / cap) as cap - 2 cap / (e^(2x / cap) + 1), k2 = 2 log2(e) /
// cap: no branch (tanhf branches on |x|, a divergent branch per score), and
// within a few float ulps of cap, the scores' own absolute rounding
__device__ __forceinline__ float softcap_tanh(float x, float cap, float k2) {
  return cap - __fdividef(2.f * cap, exp2f(x * k2) + 1.f);
}

// Scale, softcap and mask the scores of one KV tile (keys t0 ..), then the
// online softmax of the thread's two rows: their new max in m, alpha the
// factor for the accumulator, this lane's share of the row sum in l, and
// exp(s - m) in sc. The four lanes lane / 4 share a row.
template <int kBN>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const TcArgs& a,
                                             const Rows& rows, int t0, int lane) {
  // masking only on tiles that cross an edge for some row of the warpgroup
  const bool edge = t0 + kBN > a.Skv || (a.causal && t0 + kBN - 1 > rows.wg_first) ||
                    (a.window > 0 && t0 <= rows.wg_last - a.window);
  const float k2 = 2.f * kLog2e / a.softcap;
#pragma unroll
  for (int e = 0; e < kBN / 2; ++e) {
    const float x = sc[e] * a.scale;
    sc[e] = a.softcap > 0.f ? softcap_tanh(x, a.softcap, k2) : x;
  }
  if (edge) {  // one branch a tile; the mask as selects, not a branch a score
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) {
      const int t = t0 + 8 * (e / 4) + 2 * (lane % 4) + (e & 1);
      const int qp = (e / 2) & 1 ? rows.pos1 : rows.pos0;
      const bool ok =
          (t < a.Skv) & (!a.causal | (t <= qp)) & ((a.window <= 0) | (t > qp - a.window));
      sc[e] = ok ? sc[e] : kNegInf;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = m[hr];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row with every key masked so far keeps m = NEG_INF; subtracting 0
    // then gives exp(NEG_INF) = 0 for its masked scores, not exp(0)
    const float m_sub = (mx == kNegInf ? 0.f : mx) * kLog2e;
    alpha[hr] = exp2f(fmaf(m[hr], kLog2e, -m_sub));
    m[hr] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = exp2f(fmaf(sc[4 * j + 2 * hr + c], kLog2e, -m_sub));
        sc[4 * j + 2 * hr + c] = p;
        sum += p;
      }
    l[hr] = alpha[hr] * l[hr] + sum;
  }
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, TcArgs a) {
  using C = Cfg<HD>;
  constexpr int kBN = C::kBN, kTD = C::kTD;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + C::kQBytes;      // stage s: K at + s * kStageBytes, V after it
  const uint32_t q_bar = q_s + C::kDataBytes;  // then full[kStages], empty[kStages]
  const uint32_t full_bar = q_bar + 8, empty_bar = q_bar + 8 * (1 + C::kStages);

  const int qt = a.n_qtiles - 1 - static_cast<int>(blockIdx.x);  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int q0 = qt * kBM;
  const int q_last = a.q_offset + min(q0 + kBM, a.Sq) - 1;  // absolute positions
  int kt_end = (a.Skv + kBN - 1) / kBN;
  if (a.causal) kt_end = q_last < 0 ? 0 : min(kt_end, q_last / kBN + 1);
  int kt_begin = 0;
  if (a.window > 0) kt_begin = max(0, a.q_offset + q0 - a.window + 1) / kBN;
  const int n_tiles = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers / 32);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer: one thread issues every load
    reg_dealloc<C::kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_bar, C::kQBytes);
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p)
        tma_load_4d(q_s + p * kBM * kRow, &tm_q, q_bar, 64 * p, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::kStages;
        mbar_wait(empty_bar + 8 * s, ((i / C::kStages) & 1) ^ 1);  // the stage is free
        mbar_expect_tx(full_bar + 8 * s, C::kStageBytes);
        const int t0 = (kt_begin + i) * kBN;
        const uint32_t k_s = kv_s + s * C::kStageBytes, v_s = k_s + C::kTileBytes;
#pragma unroll
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load_4d(k_s + p * kBN * kRow, &tm_k, full_bar + 8 * s, 64 * p, kvh, t0, b);
          tma_load_4d(v_s + p * kBN * kRow, &tm_v, full_bar + 8 * s, 64 * p, kvh, t0, b);
        }
      }
    }
    return;
  }

  // a consumer thread: warpgroup wg owns block rows wg*64 .. wg*64+63; this
  // thread holds rows r and r + 8 of them (the wgmma accumulator layout)
  reg_alloc<C::kConsumerRegs>();
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r = wg * 64 + warp * 16 + lane / 4;
  const Rows rows{a.q_offset + q0 + r, a.q_offset + q0 + r + 8, a.q_offset + q0 + wg * 64,
                  a.q_offset + min(q0 + wg * 64 + 64, a.Sq) - 1};
  const uint32_t q_wg = q_s + wg * 64 * kRow;

  float o[kTD / 2];
#pragma unroll
  for (int i = 0; i < kTD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[kBN / 2];  // S of the newest tile: sc[4j + 2h + c] is row r + 8h,
                      // key t0 + 8j + 2 (lane % 4) + c
  uint32_t pa[kBN / 16][4];  // P of the tile before it, the A fragments of its k16 steps

  // The products of a turn, each chain committed as one group. S = Q K^T
  // of the tile in stage `st`; O += P V of the tile in stage `st`, V's
  // [keys][hd] tile the MN-major B operand (a k16 step is 16 key rows, 2048
  // bytes; the hd panels kBN * 128 bytes apart).
  // Each descriptor is the tile's base descriptor plus a constant offset
  // (in the 16-byte units of its low address field). At hd 256 the empty
  // asm hides the base's origin, so that the compiler cannot hoist the 16
  // loop-invariant Q descriptors (32 registers) out of the loop and spill
  // them (without it: 244 bytes spilled, 14% slower); at hd 64 hoisting
  // them is 1-2% faster.
  auto issue_s = [&](int st) {
    uint64_t dq = smem_desc(q_wg, 16, 1024), dk = smem_desc(kv_s + st * C::kStageBytes, 16, 1024);
    if constexpr (kTD > 128) asm volatile("" : "+l"(dq), "+l"(dk));
    clobber_regs(sc);
#pragma unroll
    for (int kk = 0; kk < kTD / 16; ++kk) {
      const uint32_t k_off = (kk % 4) * 32;  // 16 columns = 32 bytes
      wgmma_ss<kBN>(sc, dq + (((kk / 4) * kBM * kRow + k_off) >> 4),
                    dk + (((kk / 4) * kBN * kRow + k_off) >> 4), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int st) {
    uint64_t dv = smem_desc(kv_s + st * C::kStageBytes + C::kTileBytes, kBN * kRow, 1024);
    if constexpr (kTD > 128) asm volatile("" : "+l"(dv));
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) wgmma_rs<kTD>(o, pa[kk], dv + ((kk * 16 * kRow) >> 4));
    wgmma_commit();
  };
  // P in bf16 as the A fragments of the k16 steps over the tile's keys
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  // Issue order: the two consumer warpgroups take turns (named barriers 1
  // and 2), each issuing its products for a tile together: S of tile i and
  // O += P V of tile i - 1. While one warpgroup's products run, the other
  // runs its softmax, and within a warpgroup the softmax of tile i runs
  // under the PV product of tile i - 1. n_tiles + 1 turns: S of tile 0; S
  // of tile i with PV of tile i - 1; PV of the last tile. The first and
  // last turns are peeled, so that no wgmma sits under a branch inside the
  // loop: ptxas serializes every wgmma of a kernel whose wgmma it finds on
  // a divergent path (C7520).
  const int my_turn = 1 + wg, their_turn = 2 - wg;
  mbar_wait(q_bar, 0);
  if (n_tiles > 0) {
    if (wg == 1) named_arrive(1);  // warpgroup 0 goes first
    mbar_wait(full_bar, 0);
    named_sync(my_turn);
    wgmma_fence();
    issue_s(0);
    named_arrive(their_turn);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile<kBN>(sc, m, l, alpha, a, rows, kt_begin * kBN, lane);
    pack_p();  // O is still 0: nothing to rescale
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % C::kStages, prev = (i - 1) % C::kStages;
      mbar_wait(full_bar + 8 * st, (i / C::kStages) & 1);
      named_sync(my_turn);
      wgmma_fence();
      issue_s(st);
      issue_pv(prev);
      named_arrive(their_turn);
      wgmma_wait<1>();  // S is done; the PV product may still run
      fence_regs(sc);
      softmax_tile<kBN>(sc, m, l, alpha, a, rows, (kt_begin + i) * kBN, lane);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * prev);  // done with tile i - 1's stage
#pragma unroll
      for (int j = 0; j < kTD / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      pack_p();
    }
    named_sync(my_turn);
    wgmma_fence();
    issue_pv((n_tiles - 1) % C::kStages);
    if (wg == 0) named_arrive(their_turn);  // warpgroup 1's last turn: none follows
    wgmma_wait<0>();
    fence_regs(o);
  }

  // epilogue: o / l (0 for a row with no key), bf16 pairs into [B, S, H, hd]
  // (the first hd of the tile's kTD columns)
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lr = l[hr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / (lr == 0.f ? 1.f : lr);
    const int qi = q0 + r + 8 * hr;
    if (qi >= a.Sq) continue;
    if (a.lse != nullptr && lane % 4 == 0)
      a.lse[(static_cast<long long>(b) * gridDim.y + h) * a.Sq + qi] =
          lr == 0.f ? __int_as_float(0x7f800000) : m[hr] + logf(lr);
    __nv_bfloat16* orow = out + b * a.o_sb + qi * a.o_ss + h * a.o_sh + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
  }
}

template <int HD>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, TcArgs a,
           int B, int H, cudaStream_t stream) {
  using C = Cfg<HD>;
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>(a.n_qtiles), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_tc_kernel<HD><<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// Launch the CUDA-core kernel on `stream` (PyTorch's current stream) of CUDA
// device `device`. dtype 0 is float32, 1 is bfloat16 (q, k, v and o share
// it; bf16 at hd 64, 96, 128 and 256 is the tensor-core kernel's, and
// refused here). A non-null `lse` [B, H, Sq] float32 also receives each
// row's log-sum-exp m + log(l) (+inf for a row with no key): the training
// forward, whose backward is flash_attention_bwd.cu; serving passes null.
// Strides are in elements and the head dimension is contiguous. Returns
// cudaGetLastError() after the launch (0 on success); the kernel runs
// asynchronously and a fault during the run shows at the next
// synchronization.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int B, int Sq, int Skv, int H, int KV, int hd,
    int causal, int window, int q_offset, float scale, float softcap, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (KV < 1 || H % KV != 0 || B * KV > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  FlashArgs a{q,    k,    v,    o,    lse,  q_sb, q_ss,   q_sh,     k_sb,   k_ss,   k_sh,
              v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,   Sq,       Skv,    KV,     H / KV,
              0,    causal, window, q_offset, scale, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, hd, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, hd, s);
  return (int)cudaErrorInvalidValue;
}

// Launch the tensor-core kernel (bf16, hd 64, 96, 128 or 256) on `stream` of
// CUDA device `device`. Strides are in elements, the head dimension is
// contiguous; the base addresses and every other stride must be multiples of
// 16 bytes (TMA). A non-null `lse` receives the rows' log-sum-exp, as above.
// Returns 0 on success, cudaGetLastError() after a refused
// launch, or minus the driver's CUresult when a tensor map cannot be encoded.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, float* lse, long long q_sb,
    long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh, int B,
    int Sq, int Skv, int H, int KV, int hd, int causal, int window, int q_offset, float scale,
    float softcap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (KV < 1 || H % KV != 0 || H > 65535 || B > 65535 ||
      (hd != 64 && hd != 96 && hd != 128 && hd != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaSuccess);
  CUtensorMap tq, tk, tv;
  // 64-column boxes of 128-byte rows, swizzled as wgmma reads them; at hd 96
  // the second box of a row reaches past the inner dimension, and TMA fills
  // its last 32 columns with zeros
  constexpr CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const int bn = tc::block_n(hd);
  int r = hopper::encode_map(&tq, bf16, 2, q, B, Sq, H, hd, q_sb, q_ss, q_sh, 64, tc::kBM, sw);
  if (r == 0)
    r = hopper::encode_map(&tk, bf16, 2, k, B, Skv, KV, hd, k_sb, k_ss, k_sh, 64, bn, sw);
  if (r == 0)
    r = hopper::encode_map(&tv, bf16, 2, v, B, Skv, KV, hd, v_sb, v_ss, v_sh, 64, bn, sw);
  if (r != 0) return -r;
  const tc::TcArgs a{o,      lse,    o_sb,   o_ss,   o_sh,     Sq,    Skv,    H / KV,
                     (Sq + tc::kBM - 1) / tc::kBM, causal, window, q_offset, scale, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return tc::launch<64>(tq, tk, tv, a, B, H, s);
    case 96: return tc::launch<96>(tq, tk, tv, a, B, H, s);
    case 128: return tc::launch<128>(tq, tk, tv, a, B, H, s);
  }
  return tc::launch<256>(tq, tk, tv, a, B, H, s);
}
