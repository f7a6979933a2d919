// Split-KV decode attention in one launch: hand-written CUDA kernels for
// Hopper (sm_90a).
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
// one (chunk, batch, KV head, group of at most 8 query heads). Only chunks
// that start below valid_len are launched, so the padded cache past valid_len
// is never read. A block streams its chunk in tiles of K and V (kept in
// their own type) by TMA through a ring of up to four mbarrier-guarded
// shared-memory stages (a chunk's first three tiles are requested at once); the
// tensor maps end at valid_len, so TMA reads no slot past it. Each warp keeps
// its own online softmax over its slots of every tile:
//
// * decode_mma_kernel (bf16, hd 64 or 128): the products on the tensor cores
//   (mma.sync m16n8k16, float32 accumulators), so that instruction issue
//   keeps up with the stream. A warp takes 16 slots of a 64-slot tile:
//   S = Q K^T with the block's query heads as the A rows (at most 8 of 16
//   used) and K from the 128-byte-swizzled tile by ldmatrix, the softmax on
//   the accumulator registers, P rounded to bf16 in registers as the A
//   operand of O += P V, V by ldmatrix.trans.
// * decode_kernel (float32, whose 2e-5 contract TF32 would break, and bf16
//   at the other head dims): the products on the CUDA cores. A group of
//   lanes owns one slot (hd / 8 lanes for bf16, one 16-byte piece each); its
//   dot products with the query heads, held in registers, are reduced by
//   shuffles inside the group. A group is a power of two lanes: at hd 96
//   (12 pieces in bf16, 24 in float32) it is 16 or 32 lanes of which the
//   last 4 or 8 idle, so that the shuffle reductions stay butterflies and
//   a lane keeps one piece (its registers as at the other head dims).
//
// The block merges its warps' (m, l, acc), writes its float32 partial to
// scratch the wrapper allocates, and bumps a per-(batch, KV head, head
// group) arrival counter; the last block to arrive combines the partials
// (M = max m, L = sum l e^(m-M), o = sum acc e^(m-M) / L) in one pass,
// writes o and resets the counter to 0 for the next call. One launch a call.
// The cache is read through the strides of its native [B, T, KV, hd] layout
// (no transposed copy); valid_len is a host integer, so a decode step needs
// no device-to-host synchronisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -0.7f * 3.402823466e+38f;  // -0.7 * FLT_MAX
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxStages = 4;
constexpr int kMaxHeads = 8;        // query heads a block: larger groups take more blocks
constexpr int kRingBytes = 73728;  // stages a block may hold: three blocks fit an SM

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the E values of one 16-byte piece as float32
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4], float) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8], __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8x8 bf16 matrices from shared memory, lane L giving row L % 8 of
// matrix L / 8 (the mma operand layout; .trans transposes each matrix)
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += A B, m16n8k16, bf16 in, float32 accumulators; A's rows 8-15 are zero
// (a block has at most 8 query heads), so a0/a2 are rows 0-7's k halves
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

struct DecodeArgs {
  const void* q;
  void* o;
  float* part_acc;     // [B * KV, n_splits, G, hd]
  float* part_ml;      // [B * KV, n_splits, G, 2]
  unsigned* arrivals;  // [B * KV * n_groups], 0 between calls
  long long q_sb, q_sh;  // strides in elements; head_dim is contiguous
  long long o_sb, o_sh;
  int KV, G, group, n_groups;  // `group` query heads a block (the last block fewer)
  int valid_len, split_len, n_splits, stages;
  float scale, softcap;
};

// What one block owns: chunk `split` of the valid slots of (batch b, KV head
// kvh), query heads g0 .. g0 + gn - 1 of that KV head, in n_tiles tiles of TS.
struct Chunk {
  int split, bkv, hg, b, kvh, g0, gn, t_begin, t_end, n_tiles;
};
__device__ __forceinline__ Chunk chunk_of(const DecodeArgs& a, int ts) {
  Chunk c;
  c.split = blockIdx.x;
  c.bkv = blockIdx.y;
  c.hg = blockIdx.z;
  c.b = c.bkv / a.KV;
  c.kvh = c.bkv % a.KV;
  c.g0 = c.hg * a.group;
  c.gn = min(a.group, a.G - c.g0);
  c.t_begin = c.split * a.split_len;
  c.t_end = min(c.t_begin + a.split_len, a.valid_len);
  c.n_tiles = c.t_end > c.t_begin ? (c.t_end - c.t_begin + ts - 1) / ts : 0;
  return c;
}

// Thread 0: tile i's K and V (PANELS boxes of COLS columns each, a box
// BOX_BYTES apart) into its stage of the ring, completing on full[stage].
// The maps end at valid_len: rows at or past it are zero-filled, never read.
template <int TS, int PANELS, int COLS, int BOX_BYTES>
__device__ __forceinline__ void load_tile(const CUtensorMap* tk, const CUtensorMap* tv,
                                          uint32_t ring, uint64_t* full, const DecodeArgs& a,
                                          const Chunk& c, int i) {
  constexpr int kTile = PANELS * BOX_BYTES;
  const int s = i % a.stages;
  const uint32_t ks = ring + s * 2 * kTile, bar = smem_addr(&full[s]);
  mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
  for (int p = 0; p < PANELS; ++p) {
    tma_load_4d(ks + p * BOX_BYTES, tk, bar, p * COLS, c.kvh, c.t_begin + i * TS, c.b);
    tma_load_4d(ks + kTile + p * BOX_BYTES, tv, bar, p * COLS, c.kvh, c.t_begin + i * TS, c.b);
  }
}

// The block's end, once every warp has left its (m, l, acc) per query head
// in mrg ([kWarps][group][HD + 2]: acc, m, l): merge the warps, write the
// block's partial to scratch, and let the last block of the (batch, KV head,
// head group) to arrive combine every chunk's partial into o.
template <typename T, int HD>
__device__ void finish(const DecodeArgs& a, const Chunk& c, const float* mrg) {
  const int tid = threadIdx.x, row = HD + 2;
  const long long part = (long long)c.bkv * a.n_splits + c.split;  // [B * KV, n_splits]
  for (int idx = tid; idx < c.gn * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mrg[(w * a.group + g) * row + HD]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* ws = mrg + (w * a.group + g) * row;
      const float f = expf(ws[HD] - M);
      L += ws[HD + 1] * f;
      A += ws[d] * f;
    }
    const long long gi = part * a.G + c.g0 + g;
    a.part_acc[gi * HD + d] = A;
    if (d == 0) {
      a.part_ml[gi * 2] = M;
      a.part_ml[gi * 2 + 1] = L;
    }
  }

  __shared__ bool last;
  __syncthreads();
  unsigned* arrivals = a.arrivals + (long long)c.bkv * a.n_groups + c.hg;
  if (tid == 0) {
    __threadfence();  // the block's partial is visible before its arrival counts
    last = atomicAdd(arrivals, 1u) == (unsigned)(a.n_splits - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // one pass over the chunks, rescaling the running sums as the max grows
  T* o = static_cast<T*>(a.o);
  for (int idx = tid; idx < c.gn * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    const long long gi0 = (long long)c.bkv * a.n_splits * a.G + c.g0 + g;  // chunk 0
    float M = kNegInf, L = 0.f, A = 0.f;
    for (int sp = 0; sp < a.n_splits; ++sp) {
      const long long gi = gi0 + (long long)sp * a.G;
      const float m = __ldcg(a.part_ml + gi * 2), l = __ldcg(a.part_ml + gi * 2 + 1);
      const float acc = __ldcg(a.part_acc + gi * HD + d);
      const float M_new = fmaxf(M, m);
      const float f_old = expf(M - M_new), f = expf(m - M_new);
      L = L * f_old + l * f;
      A = A * f_old + acc * f;
      M = M_new;
    }
    store(o + c.b * a.o_sb + (long long)(c.kvh * a.G + c.g0 + g) * a.o_sh + d,
          A / (L == 0.f ? 1.f : L));
  }
  if (tid == 0) *arrivals = 0u;  // ready for the next call
}

// ---------------------------------------------------------------------------
// CUDA-core kernel (float32; bf16 at hd 8, 16, 32, 96, 256)
// ---------------------------------------------------------------------------

constexpr int pow2_ceil(int x) { return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2); }
constexpr int pow2_floor(int x) { return x < 2 ? 1 : 2 * pow2_floor(x / 2); }

// Work split of a head dim HD in type T: E values per 16-byte piece, LS lanes
// per slot (a power of two) with PL pieces each, of which the first kActive
// lanes hold pieces (all LS but at hd 96), SPW slots per warp step, TS slots
// per tile: a power of two, so that it divides the 64-slot split grain, with
// a tile of K at most 8 KB (32 slots at hd 96 in bf16, 16 in float32).
template <typename T, int HD>
struct Plan {
  static constexpr int E = 16 / sizeof(T);
  static constexpr int kPieces = HD / E;
  static_assert(HD % E == 0 && (kPieces <= 32 || kPieces % 32 == 0), "head dim");
  static constexpr int LS = kPieces < 32 ? pow2_ceil(kPieces) : 32;
  static constexpr int PL = (kPieces + LS - 1) / LS;
  static constexpr int kActive = kPieces / PL;
  static constexpr int SPW = 32 / LS;
  static constexpr int TS = pow2_floor(8192 / (HD * (int)sizeof(T)) < 64
                                           ? 8192 / (HD * (int)sizeof(T)) : 64);
  static constexpr int kTileBytes = TS * HD * sizeof(T);  // one K or V tile
  static constexpr int kAlign = 128;                      // TMA destinations
};

template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, DecodeArgs a) {
  using P = Plan<T, HD>;
  constexpr int E = P::E, LS = P::LS, PL = P::PL, SPW = P::SPW, TS = P::TS;
  constexpr int STEPS = TS > kWarps * SPW ? TS / (kWarps * SPW) : 1;  // warp steps a tile
  extern __shared__ uint4 smem_raw[];
  __shared__ uint64_t full[kMaxStages];  // stage s holds its tile
  const uint32_t ring = (smem_addr(smem_raw) + P::kAlign - 1) & ~(P::kAlign - 1u);
  char* const ring_p = reinterpret_cast<char*>(smem_raw) + (ring - smem_addr(smem_raw));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Chunk c = chunk_of(a, TS);

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(smem_addr(&full[s]), 1);
    mbar_fence_init();
    for (int i = 0; i < a.stages - 1 && i < c.n_tiles; ++i)
      load_tile<TS, 1, HD, P::kTileBytes>(&tm_k, &tm_v, ring, full, a, c, i);
  }
  __syncthreads();

  // this lane's pieces of the query heads, in float32; an idle lane (pos >=
  // kActive, only at hd 96) holds zeros and reads no piece of the cache
  const int slot = lane / LS, pos = lane % LS;  // slot of the warp step, piece index
  const bool active = P::kActive == LS || pos < P::kActive;
  float qr[GC][PL * E];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const T* qh = static_cast<const T*>(a.q) + c.b * a.q_sb +
                  (long long)(c.kvh * a.G + c.g0 + min(g, c.gn - 1)) * a.q_sh +
                  (active ? pos : 0) * PL * E;
#pragma unroll
    for (int e = 0; e < PL * E; ++e) qr[g][e] = g < c.gn && active ? to_float(qh[e]) : 0.f;
  }

  // this warp's online softmax over the slots it reads; l and acc hold this
  // lane group's share and are summed over the warp's slot groups at the end
  float m[GC], l[GC], acc[GC][PL * E];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < PL * E; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < c.n_tiles; ++i) {
    mbar_wait(smem_addr(&full[i % a.stages]), (i / a.stages) & 1);  // tile i has landed
    __syncthreads();  // and every warp is done with tile i - 1: refill its stage
    if (tid == 0 && i + a.stages - 1 < c.n_tiles)
      load_tile<TS, 1, HD, P::kTileBytes>(&tm_k, &tm_v, ring, full, a, c, i + a.stages - 1);

    const int rows = min(TS, c.t_end - (c.t_begin + i * TS));
    const char* ks = ring_p + (i % a.stages) * 2 * P::kTileBytes;
    const char* vs = ks + P::kTileBytes;
    // this warp's slots of the tile: step st reads rows (st * kWarps + warp) *
    // SPW + slot, SPW neighbouring rows a step; a row past `rows` is masked
    // (row 0, always staged, is read in its place)
    int jr[STEPS];
    bool valid[STEPS];
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const int j = (st * kWarps + warp) * SPW + slot;
      valid[st] = j < rows;
      jr[st] = valid[st] ? j : 0;
    }

    // scores of every step first (independent chains), then one online
    // softmax update per head for the whole tile
    float sc[STEPS][GC];
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
#pragma unroll
      for (int g = 0; g < GC; ++g) sc[st][g] = 0.f;
#pragma unroll
      for (int p = 0; p < PL; ++p) {
        if (!active) break;
        float x[E];
        unpack(*reinterpret_cast<const uint4*>(ks + (jr[st] * P::kPieces + pos * PL + p) * 16),
               x, T());
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e) sc[st][g] = fmaf(qr[g][p * E + e], x[e], sc[st][g]);
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
#pragma unroll
        for (int off = LS / 2; off > 0; off >>= 1)
          sc[st][g] += __shfl_xor_sync(0xffffffffu, sc[st][g], off);
        float x = sc[st][g] * a.scale;
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        sc[st][g] = valid[st] ? x : kNegInf;
      }
    }
    float alpha[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int st = 1; st < STEPS; ++st) mx = fmaxf(mx, sc[st][g]);
#pragma unroll
      for (int off = LS; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      // every slot masked so far: m stays NEG_INF and subtracting 0 gives
      // exp(NEG_INF) = 0 for the masked scores, not exp(0)
      const float m_sub = (m_new == kNegInf ? 0.f : m_new) * kLog2e;
      alpha[g] = exp2f(fmaf(m[g], kLog2e, -m_sub));
      m[g] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        const float pr = exp2f(fmaf(sc[st][g], kLog2e, -m_sub));
        sum += pr;
        sc[st][g] = round_to(pr, T());  // P in v's type for the product
      }
      l[g] = alpha[g] * l[g] + sum;
#pragma unroll
      for (int e = 0; e < PL * E; ++e) acc[g][e] *= alpha[g];
    }

    // acc += P V over the same slots
#pragma unroll
    for (int st = 0; st < STEPS; ++st)
#pragma unroll
      for (int p = 0; p < PL; ++p) {
        if (!active) break;
        float x[E];
        unpack(*reinterpret_cast<const uint4*>(vs + (jr[st] * P::kPieces + pos * PL + p) * 16),
               x, T());
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[g][p * E + e] = fmaf(sc[st][g], x[e], acc[g][p * E + e]);
      }
  }
  __syncthreads();  // the ring is free (every loaded tile was consumed): it
                    // becomes the warps' merge area

  // sum l and acc over the warp's slot groups; lanes of slot group 0 write
  // the warp's (m, l, acc) of each head
  float* mrg = reinterpret_cast<float*>(ring_p);  // [kWarps][group][HD + 2]
#pragma unroll
  for (int g = 0; g < GC; ++g) {
#pragma unroll
    for (int off = LS; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < PL * E; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    }
    if (slot == 0 && g < c.gn && active) {
      float* w = mrg + (warp * a.group + g) * (HD + 2);
#pragma unroll
      for (int e = 0; e < PL * E; ++e) w[pos * PL * E + e] = acc[g][e];
      if (pos == 0) {
        w[HD] = m[g];
        w[HD + 1] = l[g];
      }
    }
  }
  __syncthreads();
  finish<T, HD>(a, c, mrg);
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16, hd 64 or 128)
// ---------------------------------------------------------------------------

// A 64-slot tile of K (or V) is hd / 64 panels of [64 slots][64 columns], a
// row 128 bytes with TMA's 128-byte swizzle: 16-byte piece c of slot j sits
// at piece c ^ (j % 8) of its row, so the eight rows an ldmatrix reads hit
// distinct banks.
template <int HD>
struct MmaPlan {
  static constexpr int TS = 64;  // 16 slots a warp
  static constexpr int kPanels = HD / 64;
  static constexpr int kPanelBytes = TS * 128;
  static constexpr int kTileBytes = kPanels * kPanelBytes;
  static constexpr int kAlign = 1024;  // the swizzle's period
  __device__ static uint32_t piece(uint32_t tile, int j, int c) {
    return tile + (c >> 3) * kPanelBytes + j * 128 + (((c & 7) ^ (j & 7)) << 4);
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
    decode_mma_kernel(const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, DecodeArgs a) {
  using P = MmaPlan<HD>;
  constexpr int TS = P::TS;
  extern __shared__ uint4 smem_raw[];
  __shared__ uint64_t full[kMaxStages];  // stage s holds its tile
  const uint32_t ring = (smem_addr(smem_raw) + P::kAlign - 1) & ~(P::kAlign - 1u);
  char* const ring_p = reinterpret_cast<char*>(smem_raw) + (ring - smem_addr(smem_raw));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Chunk c = chunk_of(a, TS);

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(smem_addr(&full[s]), 1);
    mbar_fence_init();
    for (int i = 0; i < a.stages - 1 && i < c.n_tiles; ++i)
      load_tile<TS, P::kPanels, 64, P::kPanelBytes>(&tm_k, &tm_v, ring, full, a, c, i);
  }
  __syncthreads();

  // Q as the A operand: row h = lane / 4 is query head g0 + h (zero past gn),
  // k-step kk's columns 16 kk + 2 (lane % 4) + {0, 1} and + 8
  const int h = lane >> 2, q4 = lane & 3;
  uint32_t qa[HD / 16][2];
  {
    const unsigned short* qh =
        static_cast<const unsigned short*>(a.q) + c.b * a.q_sb +
        (long long)(c.kvh * a.G + c.g0 + min(h, c.gn - 1)) * a.q_sh + 2 * q4;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 2; ++x)
        qa[kk][x] = h < c.gn ? qh[16 * kk + 8 * x] | (uint32_t)qh[16 * kk + 8 * x + 1] << 16 : 0u;
  }

  // this warp's online softmax for head h over its 16 slots of each tile; l
  // is this lane's share (its slots), summed over the row's four lanes at the end
  float m = kNegInf, l = 0.f;
  float acc[HD / 8][4];  // O: n-tile nt holds columns 8 nt + 2 (lane % 4) + {0, 1}
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int i = 0; i < c.n_tiles; ++i) {
    mbar_wait(smem_addr(&full[i % a.stages]), (i / a.stages) & 1);  // tile i has landed
    __syncthreads();  // and every warp is done with tile i - 1: refill its stage
    if (tid == 0 && i + a.stages - 1 < c.n_tiles)
      load_tile<TS, P::kPanels, 64, P::kPanelBytes>(&tm_k, &tm_v, ring, full, a, c,
                                                     i + a.stages - 1);
    const int rows = min(TS, c.t_end - (c.t_begin + i * TS));
    const uint32_t ks = ring + (i % a.stages) * 2 * P::kTileBytes, vs = ks + P::kTileBytes;
    const int j0 = warp * 16;  // this warp's slots

    // S = Q K^T over slots j0 .. j0 + 15: sc[nt][x] is slot j0 + 8 nt + 2 (lane % 4) + x
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t bk[4];  // slots j0 +0..7 / +8..15, pieces 2 kk and 2 kk + 1
      ldsm_x4(P::piece(ks, j0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)), bk);
      mma_16816(sc[0], qa[kk][0], qa[kk][1], bk[0], bk[1]);
      mma_16816(sc[1], qa[kk][0], qa[kk][1], bk[2], bk[3]);
    }

    // scale, softcap, mask slots past the chunk; online softmax of row h
    float mx = m;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float v = sc[nt][x] * a.scale;
        if (a.softcap > 0.f) v = tanhf(v / a.softcap) * a.softcap;
        sc[nt][x] = j0 + 8 * nt + 2 * q4 + x < rows ? v : kNegInf;
        mx = fmaxf(mx, sc[nt][x]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // every slot masked so far: m stays NEG_INF and subtracting 0 gives
    // exp(NEG_INF) = 0 for the masked scores, not exp(0)
    const float m_sub = (mx == kNegInf ? 0.f : mx) * kLog2e;
    const float alpha = exp2f(fmaf(m, kLog2e, -m_sub));
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        sc[nt][x] = exp2f(fmaf(sc[nt][x], kLog2e, -m_sub));
        sum += sc[nt][x];
      }
    l = alpha * l + sum;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      acc[nt][0] *= alpha;
      acc[nt][1] *= alpha;  // rows 8-15 (acc[nt][2..3]) stay 0: their A rows are 0
    }

    // O += P V: P rounded to bf16 as the A operand (slots as k), V's slots
    // j0 .. j0 + 15 by ldmatrix.trans, two 8-column n-tiles a load
    const uint32_t pa0 = pack_bf16(sc[0][0], sc[0][1]), pa1 = pack_bf16(sc[1][0], sc[1][1]);
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t bv[4];  // slots +0..7 / +8..15 of pieces 2 np, then 2 np + 1
      ldsm_x4_trans(P::piece(vs, j0 + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * np + (lane >> 4)),
                    bv);
      mma_16816(acc[2 * np], pa0, pa1, bv[0], bv[1]);
      mma_16816(acc[2 * np + 1], pa0, pa1, bv[2], bv[3]);
    }
  }
  __syncthreads();  // the ring is free (every loaded tile was consumed): it
                    // becomes the warps' merge area

  float* mrg = reinterpret_cast<float*>(ring_p);  // [kWarps][group][HD + 2]
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (h < c.gn) {
    float* w = mrg + (warp * a.group + h) * (HD + 2);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      w[8 * nt + 2 * q4] = acc[nt][0];
      w[8 * nt + 2 * q4 + 1] = acc[nt][1];
    }
    if (q4 == 0) {
      w[HD] = m;
      w[HD + 1] = l;
    }
  }
  __syncthreads();
  finish<__nv_bfloat16, HD>(a, c, mrg);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Dynamic shared memory of a block: the ring of `stages` K/V tile pairs, or
// the warps' merge area after it, and slack to align the ring.
int smem_bytes(int align, int tile_bytes, int stages, int hd) {
  const int ring = stages * 2 * tile_bytes;
  const int merge = kWarps * kMaxHeads * (hd + 2) * (int)sizeof(float);
  return align + (ring > merge ? ring : merge);
}

// Stages enough that a chunk of up to kMaxStages - 1 tiles is in flight at
// once, within kRingBytes, at least two.
int stages_for(int split_len, int ts, int tile_bytes) {
  int stages = (split_len + ts - 1) / ts + 1;
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages * 2 * tile_bytes > kRingBytes) stages = kRingBytes / (2 * tile_bytes);
  return stages < 2 ? 2 : stages;
}

template <typename K>
int launch_kernel(K kernel, int align, int tile_bytes, int ts, int hd, const CUtensorMap& tk,
                  const CUtensorMap& tv, DecodeArgs a, int B, bool& configured,
                  cudaStream_t stream) {
  if (!configured) {  // the attribute is per kernel, set once
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(align, tile_bytes, kMaxStages, hd));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  a.stages = stages_for(a.split_len, ts, tile_bytes);
  const dim3 grid((unsigned)a.n_splits, (unsigned)(B * a.KV), (unsigned)a.n_groups);
  kernel<<<grid, kThreads, smem_bytes(align, tile_bytes, a.stages, hd), stream>>>(tk, tv, a);
  return (int)cudaGetLastError();
}

struct Cache {  // the K and V cache pointers and strides (elements)
  const void* k;
  const void* v;
  long long k_sb, k_st, k_sh, v_sb, v_st, v_sh;
};

// the tensor maps of K and V, [cols, ts] boxes, up to valid_len
int encode_cache(CUtensorMap* tk, CUtensorMap* tv, const Cache& kv, const DecodeArgs& a, int B,
                 int hd, bool f32, int cols, int ts, CUtensorMapSwizzle swizzle) {
  const CUtensorMapDataType dt =
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int eb = f32 ? 4 : 2;
  int r = encode_map(tk, dt, eb, kv.k, B, a.valid_len, a.KV, hd, kv.k_sb, kv.k_st, kv.k_sh,
                     cols, ts, swizzle);
  if (r == 0)
    r = encode_map(tv, dt, eb, kv.v, B, a.valid_len, a.KV, hd, kv.v_sb, kv.v_st, kv.v_sh, cols,
                   ts, swizzle);
  return r;
}

template <typename T, int HD>
int launch_cuda_core(const Cache& kv, DecodeArgs a, int B, cudaStream_t stream) {
  using P = Plan<T, HD>;
  CUtensorMap tk, tv;
  const int r = encode_cache(&tk, &tv, kv, a, B, HD, sizeof(T) == 4, HD, P::TS,
                             CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r != 0) return -r;
  static bool configured[4] = {false, false, false, false};
  if (a.group <= 1)
    return launch_kernel(decode_kernel<T, HD, 1>, P::kAlign, P::kTileBytes, P::TS, HD, tk, tv,
                         a, B, configured[0], stream);
  if (a.group <= 2)
    return launch_kernel(decode_kernel<T, HD, 2>, P::kAlign, P::kTileBytes, P::TS, HD, tk, tv,
                         a, B, configured[1], stream);
  if (a.group <= 4)
    return launch_kernel(decode_kernel<T, HD, 4>, P::kAlign, P::kTileBytes, P::TS, HD, tk, tv,
                         a, B, configured[2], stream);
  return launch_kernel(decode_kernel<T, HD, 8>, P::kAlign, P::kTileBytes, P::TS, HD, tk, tv, a,
                       B, configured[3], stream);
}

template <int HD>
int launch_tensor_core(const Cache& kv, DecodeArgs a, int B, cudaStream_t stream) {
  using P = MmaPlan<HD>;
  CUtensorMap tk, tv;
  const int r = encode_cache(&tk, &tv, kv, a, B, HD, false, 64, P::TS,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  if (r != 0) return -r;
  static bool configured = false;
  return launch_kernel(decode_mma_kernel<HD>, P::kAlign, P::kTileBytes, P::TS, HD, tk, tv, a, B,
                       configured, stream);
}

// bf16 at hd 64 and 128 runs the tensor-core kernel, never this one
template <typename T>
int dispatch(const Cache& kv, DecodeArgs a, int B, int hd, cudaStream_t stream) {
  constexpr bool f32 = sizeof(T) == 4;
  switch (hd) {
    case 8: return launch_cuda_core<T, 8>(kv, a, B, stream);
    case 16: return launch_cuda_core<T, 16>(kv, a, B, stream);
    case 32: return launch_cuda_core<T, 32>(kv, a, B, stream);
    case 64:
      if constexpr (f32) return launch_cuda_core<T, 64>(kv, a, B, stream);
      break;
    case 96: return launch_cuda_core<T, 96>(kv, a, B, stream);
    case 128:
      if constexpr (f32) return launch_cuda_core<T, 128>(kv, a, B, stream);
      break;
    case 256: return launch_cuda_core<T, 256>(kv, a, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream) of CUDA device `device`: one
// grid of n_splits chunks of split_len slots, per (batch, KV head, group of
// at most 8 query heads). dtype 0 is float32, 1 is bfloat16 (q, the cache
// and o share it). tensor_core is 1 for the mma kernel, which bf16 at hd 64
// or 128 takes, and 0 for the CUDA-core kernel, which every other case
// takes. Strides are in elements and the head dimension is contiguous; the
// cache's base addresses and strides are multiples of 16 bytes (TMA).
// part_acc and part_ml are float32 scratch of B * KV * n_splits * G * hd and
// * 2 elements; `arrivals` holds B * KV * ceil(G / 8) zeros and is left
// zeroed. valid_len must be at most the cache length and n_splits *
// split_len must cover it. Calls that share `arrivals` must run one at a
// time (one stream). Returns cudaGetLastError() after the launch (0 on
// success), or minus the driver's CUresult when a tensor map cannot be
// encoded.
extern "C" int decode_attention_launch(
    int dtype, int tensor_core, const void* q, const void* k, const void* v, void* o,
    void* part_acc, void* part_ml, void* arrivals, long long q_sb, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long o_sb, long long o_sh, int B, int H, int KV, int hd, int valid_len,
    int split_len, int n_splits, float scale, float softcap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (KV < 1 || H % KV != 0 || B * KV > 65535 || n_splits < 1 || split_len < 1 ||
      split_len % 64 != 0 || (long long)n_splits * split_len < valid_len ||
      tensor_core != (dtype == 1 && (hd == 64 || hd == 128)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int G = H / KV;
  const int n_groups = (G + kMaxHeads - 1) / kMaxHeads;
  const int group = (G + n_groups - 1) / n_groups;
  const DecodeArgs a{q,     o,     static_cast<float*>(part_acc),
                     static_cast<float*>(part_ml), static_cast<unsigned*>(arrivals),
                     q_sb,  q_sh,  o_sb, o_sh, KV, G, group, n_groups, valid_len, split_len,
                     n_splits, 0, scale, softcap};
  const Cache kv{k, v, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core) return hd == 64 ? launch_tensor_core<64>(kv, a, B, s)
                                   : launch_tensor_core<128>(kv, a, B, s);
  if (dtype == 0) return dispatch<float>(kv, a, B, hd, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(kv, a, B, hd, s);
  return (int)cudaErrorInvalidValue;
}
