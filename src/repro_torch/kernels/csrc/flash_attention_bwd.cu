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
//   1. delta_kernel: D = rowsum(dO * O), float32 [B, H, Sq];
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
// Bound: operations. The backward recomputes S and does four more products
// (dP, dV, dK, dQ): 10 B H Sq Skv hd flops over the attended pairs (about
// half of them when causal) against reading Q, K, V, O, dO and lse and
// writing dQ, dK, dV once: at roberta-large's training shape (B 32, S 2048,
// H 16, hd 64) ~1.4 TFLOP against ~1.1 GB, far past the ridge point.
//
// Two kernel families, chosen by (dtype, hd) in the Python wrapper:
//
// * tensor core (bf16, hd 64): mma.sync m16n8k16 with float32 accumulators.
//   128 threads; each of the four warps owns 16 rows of the block's 64 (keys
//   in the dK/dV pass, queries in the dQ pass). The block's fixed operands
//   (K and V, or Q and dO) stay in shared memory; the loop's tiles (Q and
//   dO, or K and V) are copied by cp.async into two shared-memory buffers,
//   the next tile's copy running under this tile's products; every operand
//   reaches the tensor cores by ldmatrix (rows padded to 72 bf16 so that it
//   hits distinct banks), the second products' B operands (dO and Q for dV
//   and dK, K for dQ) transposed by ldmatrix.trans from the same tiles. A
//   loop tile is taken in two halves of 32 rows, so that S and dP take 32
//   registers, not 64: three blocks a SM. P and dS go from the product's
//   accumulator registers straight into the next product's A fragments,
//   rounded to bf16. Not yet fast: 64-row tiles, mma.sync rather than wgmma,
//   and the dK/dV pass recomputes S = Q K^T that the dQ pass computes again.
// * CUDA core (float32, and bf16 at the other head dims): the same two
//   passes with 32-row tiles staged in shared memory as float32 and every
//   product as fmaf, for float32's 2e-5 contract (TF32 would break it) and
//   the small head dims of the smoke configs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, H, Sq], the forward's
  float* delta;      // [B, H, Sq], written by delta_kernel
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
// Tensor-core passes (bf16, hd 64): mma.sync m16n8k16, float32 accumulators
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 128;  // four warps of 16 rows each
constexpr int kTile = 64;      // rows a block, and rows of a loop tile
constexpr int kHD = 64;
constexpr int kLD = kHD + 8;   // padded smem row (bf16): fragment loads hit distinct banks
constexpr int kTileElems = kTile * kLD;
constexpr int kTileBytes = kTileElems * 2;
// six tiles (the block's two, the loop's two, double-buffered) and the
// loop's lse and D, double-buffered
constexpr int kSmem = 6 * kTileBytes + 4 * kTile * 4;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b: m16n8k16, A row-major [16][16] and B "col" ([n][k] rows) bf16
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 b16 matrices from shared memory, one row address a lane
// (lanes 8i .. 8i + 7 give matrix i's rows); .trans hands each thread the
// transposed pair (rows 2 (t % 4) and + 1 of column t / 4)
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes global -> shared without registers; zeros when !valid (no read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + 64) of head `head` of a [B, S, heads, 64] bf16 tensor into
// dst[64][kLD] by cp.async (zeros past S); the caller commits and waits.
// 16-byte copies: the wrapper checks that the base and strides are
// multiples of 16 bytes.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long sb, long long ss, long long sh, int b,
                                          int head, int r0, int S) {
  const uint32_t d0 = smem_u32(dst);
  for (int idx = threadIdx.x; idx < kTile * (kHD / 8); idx += kThreads) {
    const int r = idx / (kHD / 8), c = idx % (kHD / 8);
    const bool valid = r0 + r < S;
    const __nv_bfloat16* g = valid ? src + b * sb + (r0 + r) * ss + head * sh + 8 * c : src;
    cp_async16(d0 + (r * kLD + 8 * c) * 2, g, valid);
  }
}

// acc[4][4] = A times B^T, A the warp's 16 rows of a [64][kLD] tile
// (rows 16 w ..), B rows [n0, n0 + 32) of another: acc[nt] is columns
// 8 nt .. 8 nt + 7 of the [16][32] result. Both operands come from shared
// memory by ldmatrix, k (the 64 columns) outer: four independent
// accumulators a step.
__device__ __forceinline__ void product_nt(float (&acc)[4][4], const __nv_bfloat16* a_tile,
                                           const __nv_bfloat16* b_tile, int n0, int w,
                                           int lane) {
  const uint32_t a_base = smem_u32(a_tile) +
                          ((16 * w + lane % 8 + 8 * ((lane / 8) % 2)) * kLD + 8 * (lane / 16)) * 2;
  const uint32_t b_base = smem_u32(b_tile) +
                          ((n0 + 8 * (lane / 16) + lane % 8) * kLD + 8 * ((lane / 8) % 2)) * 2;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t f[4];
    ldsm_x4(a_base + 16 * kk * 2, f);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b_base + (16 * np * kLD + 16 * kk) * 2, b);
      mma(acc[2 * np], f, b[0], b[1]);
      mma(acc[2 * np + 1], f, b[2], b[3]);
    }
  }
}

// acc[8][4] += X times src rows [k0, k0 + 32): X the warp's [16][32]
// operand in accumulator layout x (rounded to bf16), src [k rows][64 (n)
// columns] row-major, read transposed by ldmatrix
__device__ __forceinline__ void product_acc(float (&acc)[8][4], const float (&x)[4][4],
                                            const __nv_bfloat16* src, int k0, int lane) {
  const uint32_t base = smem_u32(src) +
                        ((k0 + lane % 8 + 8 * ((lane / 8) % 2)) * kLD + 8 * (lane / 16)) * 2;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4_t(base + (16 * kk * kLD + 16 * np) * 2, b);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// write the warp's [16][64] accumulator times `mul` as bf16 into rows
// row0 + .. of a contiguous [.., heads, 64] output at head `head`
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[8][4],
                                           float mul, long long b_rows, int row0, int n_rows,
                                           int heads, int head, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + g + 8 * hr;
    if (r >= n_rows) continue;
    __nv_bfloat16* p = out + ((b_rows + r) * heads + head) * kHD + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(p + 8 * nt) =
          pack_bf16(acc[nt][2 * hr] * mul, acc[nt][2 * hr + 1] * mul);
  }
}

// dK, dV of keys [t0, t0 + 64) of KV head kvh; block (key tile, b * KV + kvh).
// Warp w owns keys t0 + 16 w ..; the products run transposed: S^T = K Q^T,
// dP^T = V dO^T, dV += P^T dO, dK += dS^T Q, a query tile in two halves of
// 32 so that S^T and dP^T take 32 registers, not 64 (three blocks a SM).
// The loop runs over (query head of the group, query tile) pairs; the next
// pair's Q and dO tiles are copied by cp.async into the other buffer while
// this pair computes.
__global__ void __launch_bounds__(kThreads, 3) dkdv_kernel(BwdArgs a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kTileElems;
  __nv_bfloat16* Qs = Vs + kTileElems;       // [2] tiles
  __nv_bfloat16* dOs = Qs + 2 * kTileElems;  // [2] tiles
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kTileElems);  // [2][64]
  float* dl_s = lse_s + 2 * kTile;                                 // [2][64]

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV, t0 = blockIdx.x * kTile;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout);
  load_tile(Ks, static_cast<const __nv_bfloat16*>(a.k), a.k_sb, a.k_ss, a.k_sh, b, kvh, t0,
            a.Skv);
  load_tile(Vs, static_cast<const __nv_bfloat16*>(a.v), a.v_sb, a.v_ss, a.v_sh, b, kvh, t0,
            a.Skv);
  cp_async_commit();
  int qb, qe;
  query_range(a, t0, kTile, kTile, qb, qe);
  const int nq = qe > qb ? (qe - qb + kTile - 1) / kTile : 0, n_iter = a.G * nq;

  // the Q, dO, lse and D of pair `it` into buffer `buf`
  auto prefetch = [&](int it, int buf) {
    const int h = kvh * a.G + it / nq, q0 = qb + (it % nq) * kTile;
    load_tile(Qs + buf * kTileElems, q, a.q_sb, a.q_ss, a.q_sh, b, h, q0, a.Sq);
    load_tile(dOs + buf * kTileElems, dout, a.d_sb, a.d_ss, a.d_sh, b, h, q0, a.Sq);
    cp_async_commit();
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      const long long at = (static_cast<long long>(b) * a.H + h) * a.Sq + qi;
      lse_s[buf * kTile + threadIdx.x] = qi < a.Sq ? a.lse[at] : __int_as_float(0x7f800000);
      dl_s[buf * kTile + threadIdx.x] = qi < a.Sq ? a.delta[at] : 0.f;
    }
  };
  if (n_iter > 0) prefetch(0, 0);
  cp_async_wait<1>();  // K and V are in (the first pair may still be in flight)
  if (n_iter == 0) cp_async_wait<0>();
  __syncthreads();

  float dk[8][4], dv[8][4], sp[4][4], dp[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1, q0 = qb + (it % nq) * kTile;
    if (it + 1 < n_iter) {
      prefetch(it + 1, buf ^ 1);
      cp_async_wait<1>();  // pair it's copies are done, it + 1's may run on
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // pair it's tiles and statistics are visible to all
    const __nv_bfloat16* Qb = Qs + buf * kTileElems;
    const __nv_bfloat16* dOb = dOs + buf * kTileElems;
    const float* lse_b = lse_s + buf * kTile;
    const float* dl_b = dl_s + buf * kTile;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int n0 = 32 * half;
      product_nt(sp, Ks, Qb, n0, w, lane);   // S^T: keys x 32 queries
      product_nt(dp, Vs, dOb, n0, w, lane);  // dP^T
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + 16 * w + g + 8 * (e / 2), col = n0 + 8 * nt + 2 * t + (e & 1);
          float p, ds;
          grad_entry(a, attends(a, q0 + col, key), sp[nt][e], dp[nt][e], lse_b[col],
                     dl_b[col], p, ds);
          sp[nt][e] = p;
          dp[nt][e] = ds;
        }
      product_acc(dv, sp, dOb, n0, lane);  // dV += P^T dO
      product_acc(dk, dp, Qb, n0, lane);   // dK += dS^T Q
    }
    __syncthreads();  // every warp is done with buffer buf before it is refilled
  }
  const long long b_rows = static_cast<long long>(b) * a.Skv;
  store_rows(static_cast<__nv_bfloat16*>(a.dk), dk, a.scale, b_rows, t0 + 16 * w, a.Skv, a.KV,
             kvh, lane);
  store_rows(static_cast<__nv_bfloat16*>(a.dv), dv, 1.f, b_rows, t0 + 16 * w, a.Skv, a.KV, kvh,
             lane);
}

// dQ of queries [q0, q0 + 64) of query head h; block (query tile, b * H + h).
// Warp w owns queries q0 + 16 w ..: S = Q K^T, dP = dO V^T, dQ += dS K, a
// KV tile in two halves of 32 keys. The next KV tile is copied by cp.async
// into the other buffer while this one computes.
__global__ void __launch_bounds__(kThreads, 3) dq_kernel(BwdArgs a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + kTileElems;
  __nv_bfloat16* Ks = dOs + kTileElems;     // [2] tiles
  __nv_bfloat16* Vs = Ks + 2 * kTileElems;  // [2] tiles

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H, kvh = h / a.G;
  const int q0 = blockIdx.x * kTile;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  load_tile(Qs, static_cast<const __nv_bfloat16*>(a.q), a.q_sb, a.q_ss, a.q_sh, b, h, q0, a.Sq);
  load_tile(dOs, static_cast<const __nv_bfloat16*>(a.dout), a.d_sb, a.d_ss, a.d_sh, b, h, q0,
            a.Sq);
  cp_async_commit();
  int kb, ke;
  key_range(a, q0, kTile, kTile, kb, ke);
  auto prefetch = [&](int kt, int buf) {
    load_tile(Ks + buf * kTileElems, k, a.k_sb, a.k_ss, a.k_sh, b, kvh, kt * kTile, a.Skv);
    load_tile(Vs + buf * kTileElems, v, a.v_sb, a.v_ss, a.v_sh, b, kvh, kt * kTile, a.Skv);
    cp_async_commit();
  };
  if (kb < ke) prefetch(kb, 0);
  float lse[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + 16 * w + g + 8 * hr;
    const long long at = (static_cast<long long>(b) * a.H + h) * a.Sq + qi;
    lse[hr] = qi < a.Sq ? a.lse[at] : __int_as_float(0x7f800000);
    dl[hr] = qi < a.Sq ? a.delta[at] : 0.f;
  }
  cp_async_wait<1>();  // Q and dO are in
  if (kb >= ke) cp_async_wait<0>();
  __syncthreads();

  float dq[8][4], sp[4][4], dp[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;
  for (int kt = kb; kt < ke; ++kt) {
    const int buf = (kt - kb) & 1, t0 = kt * kTile;
    if (kt + 1 < ke) {
      prefetch(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kb = Ks + buf * kTileElems;
    const __nv_bfloat16* Vb = Vs + buf * kTileElems;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int n0 = 32 * half;
      product_nt(sp, Qs, Kb, n0, w, lane);   // S: queries x 32 keys
      product_nt(dp, dOs, Vb, n0, w, lane);  // dP
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e / 2, key = t0 + n0 + 8 * nt + 2 * t + (e & 1);
          float p, ds;
          grad_entry(a, attends(a, q0 + 16 * w + g + 8 * hr, key), sp[nt][e], dp[nt][e],
                     lse[hr], dl[hr], p, ds);
          dp[nt][e] = ds;
        }
      product_acc(dq, dp, Kb, n0, lane);  // dQ += dS K
    }
    __syncthreads();
  }
  store_rows(static_cast<__nv_bfloat16*>(a.dq), dq, a.scale, static_cast<long long>(b) * a.Sq,
             q0 + 16 * w, a.Sq, a.H, h, lane);
}

int launch(const BwdArgs& a, cudaStream_t stream) {
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 g1((unsigned)((a.Skv + kTile - 1) / kTile), (unsigned)(a.B * a.KV));
  dkdv_kernel<<<g1, kThreads, kSmem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((unsigned)((a.Sq + kTile - 1) / kTile), (unsigned)(a.B * a.H));
  dq_kernel<<<g2, kThreads, kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The gradient of flash attention on `stream` (PyTorch's current stream) of
// CUDA device `device`: dq [B, Sq, H, hd], dk and dv [B, Skv, KV, hd]
// (contiguous, allocated by the caller) from dout, q, k, v, o (strided, the
// head dim contiguous), the forward's lse [B, H, Sq] and a float32 scratch
// delta [B, H, Sq]. variant 1 is the tensor-core kernel (bf16, hd 64; the
// base addresses and strides must be multiples of 16 bytes), 0 the
// CUDA-core kernel (dtype 0 float32, 1 bfloat16). Returns
// cudaGetLastError() after the launches (0 on success); the kernels run
// asynchronously and a fault shows at the next synchronization.
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
  if (variant == 1) return tc::launch(a, s);
  if (dtype == 0) return cc::dispatch<float>(a, s);
  return cc::dispatch<__nv_bfloat16>(a, s);
}
