// POLCA tick loop: a hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/tick.py::_tick_kernel, the Pallas kernel behind
// repro.kernels.tick.polca_tick_loop and repro.kernels.ops.polca_tick.
//
// Computes, for every (member, row) lane, T ticks of the non-predictive POLCA
// state machine: pop the actuation ring and apply any due frequency command;
// row watts power_scale * n_servers * (p0 + occ * (k_lp * f_lp^gamma + k_hp *
// f_hp^gamma)); p = watts / (row_budget * bscale_k); the T1/T2/HP/brake latch
// and escalation step of PolcaPolicy; push OOB commands oob_ticks ahead and
// brake commands brake_ticks ahead (the brake push comes last and overwrites,
// the event-driven simulator's same-due-time rule). It writes the per-tick
// row watts, brake firings and frequencies and the brake count.
//
// Bound: bytes. Each lane-tick reads 8 B (occupancy) and writes 25 B (row_w,
// f_lp, f_hp as float64, fire as one byte) against five float64 operations.
//
// Design. The ticks are a sequential recurrence and the lanes independent, so
// a thread carries whole lanes through the T-tick loop, with frequencies,
// latches and counters in registers:
// - Layout: time-major. occ is read through its strides (any layout works)
//   and the four output planes are [T, N * R] storage, lane l = n * R + r, so
//   a warp moves 256 contiguous bytes per float64 plane and 32 per fire plane
//   each tick. The engine builds occ time-major (batched.effective_occupancy)
//   and the wrapper returns [N, T, R]-shaped views, the Pallas kernel's shapes.
// - A coded ring. f_lp and f_hp only ever hold one of the five values of the
//   per-launch table freq[] (1.0 and the four command values), so a ring slot
//   is a 4-bit code per field (0 = no command) and a lane's slot one byte.
//   Ring[D][threads] of 16-bit words in dynamic shared memory (lane j of a
//   thread in byte j): 2 * D bytes a thread, where NaN-sentinel doubles took
//   16 * D, so registers, not shared memory, set residency.
// - Powers once per value. pow(freq[i], gamma) is taken once per block into
//   shared memory; busy = k_lp * f_lp^gamma + k_hp * f_hp^gamma stays in a
//   register and is recomputed only when a popped command changes a field.
// - Two lanes a thread (l and l + 128 in a block of 256 lanes): two
//   independent recurrences interleave, and 2 * 10^5 lanes fit the card's
//   132 SMs at 6 blocks of 128 threads each (__launch_bounds__ caps a thread
//   at 80 registers): one wave. Tick k + 1's occupancy is loaded before tick
//   k's arithmetic; bscale[k, r], shared by all lanes of a tick, comes
//   through the read-only path.
//
// Numerics: float64 throughout, as the bit-identical brake-set contract
// requires. The build uses -fmad=false and no --use_fast_math, so the power
// expression rounds like the plain PyTorch version's separate multiplies and
// adds, pow is the same device function the plain version calls, and
// p = watts / budget stays a true division. f_lp and f_hp are written as
// freq[code], the same doubles the plain version's ring carries.
//
// Layouts: occ [N, T, R] by strides (elements); bscale [T, R] and row_budget
// [R] contiguous; row_w, f_lp, f_hp, fire [T, N * R]; n_brakes [N * R].

#include <cuda_runtime.h>

namespace {

// Frequency codes: an index into freq[] (kernels/tick.py::freq_table builds
// the table in this order). Code 0 in a ring field means no command.
constexpr int kOne = 1, kLpT1 = 2, kLpT2 = 3, kHpT2 = 4, kBrake = 5;
constexpr int kCodes = 6;

constexpr int kThreads = 128;     // threads a block
constexpr int kLanes = 2;         // lanes a thread
constexpr int kMinBlocks = 6;     // blocks an SM must hold: <= 80 registers
constexpr int kMaxRingDepth = 896;  // D * kThreads * 2 bytes within 227 KB
constexpr size_t kDefaultSharedBytes = 48 * 1024;

struct TickConsts {
  double t1, t2, t1_release, t2_release;
  double psn, p0_srv_w, k_lp_w, k_hp_w, gamma;
  double freq[kCodes];  // freq[code]; freq[0] unused
};

__global__ void __launch_bounds__(kThreads, kMinBlocks) polca_tick_kernel(
    const double* __restrict__ occ, long long s_n, long long s_t,
    long long s_r, const double* __restrict__ bscale,
    const double* __restrict__ row_budget, double* __restrict__ row_w,
    unsigned char* __restrict__ fire_out, double* __restrict__ f_lp_out,
    double* __restrict__ f_hp_out, int* __restrict__ n_brakes, long long L,
    int T, int R, int oob_ticks, int brake_ticks, int D, int esc,
    TickConsts c) {
  extern __shared__ unsigned short ring[];  // [D][kThreads]
  __shared__ double freq[kCodes], power[kCodes];
  const int tid = threadIdx.x;
  if (tid < kCodes) {
    double v = c.freq[0];
#pragma unroll
    for (int i = 1; i < kCodes; ++i)
      if (tid == i) v = c.freq[i];
    freq[tid] = v;
    power[tid] = pow(v, c.gamma);
  }
  __syncthreads();
  const long long lane0 = (long long)blockIdx.x * (kThreads * kLanes) + tid;
  if (lane0 >= L) return;
  for (int s = 0; s < D; ++s) ring[s * kThreads + tid] = 0;

  const double* occ_p[kLanes];
  int r[kLanes], code[kLanes], t2s[kLanes], nbr[kLanes];
  double budget[kLanes], o[kLanes], f_lp[kLanes], f_hp[kLanes], busy[kLanes];
  bool valid[kLanes], t1c[kLanes], t2c[kLanes], hpc[kLanes], brk[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const long long lane = lane0 + j * kThreads;
    valid[j] = lane < L;
    const long long l = valid[j] ? lane : lane0;  // an idle lane rereads lane0
    const long long n = l / R;
    r[j] = (int)(l - n * R);
    occ_p[j] = occ + n * s_n + r[j] * s_r;
    o[j] = *occ_p[j];
    budget[j] = row_budget[r[j]];
    code[j] = kOne | kOne << 4;
    f_lp[j] = f_hp[j] = freq[kOne];
    busy[j] = c.k_lp_w * power[kOne] + c.k_hp_w * power[kOne];
    t2s[j] = nbr[j] = 0;
    t1c[j] = t2c[j] = hpc[j] = brk[j] = false;
  }

  // (k + shift) % D, stepped without a division
  int s_pop = 0, s_oob = oob_ticks, s_brk = brake_ticks;
  long long at = lane0;  // element (k, lane0) of the [T, L] planes
  for (int k = 0; k < T; ++k, at += L) {
    // next tick's occupancy first: it does not depend on the recurrence
    const long long step = k + 1 < T ? s_t : 0;
    double nxt[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      occ_p[j] += step;
      nxt[j] = *occ_p[j];
    }

    // pop the ring: apply due commands, clear the slot
    unsigned short* pend = ring + s_pop * kThreads + tid;
    const unsigned due = *pend;
    if (due) {
      *pend = 0;
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const int b = (due >> (8 * j)) & 0xFF;
        if (b) {
          const int lp = (b & 0xF) ? (b & 0xF) : (code[j] & 0xF);
          const int hp = (b >> 4) ? (b >> 4) : (code[j] >> 4);
          code[j] = lp | hp << 4;
          f_lp[j] = freq[lp];
          f_hp[j] = freq[hp];
          busy[j] = c.k_lp_w * power[lp] + c.k_hp_w * power[hp];
        }
      }
    }

    unsigned oob_set = 0, oob_keep = 0xFFFF, brake_set = 0;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      // row watts and the budget fraction
      const double rw = c.psn * (c.p0_srv_w + o[j] * busy[j]);
      const double tick_budget = budget[j] * __ldg(bscale + k * R + r[j]);
      const double p = rw / tick_budget;

      // PolcaPolicy.observe, as in kernels/tick.py::polca_latch_step
      const bool over = p > 1.0;
      const bool fire = over && !brk[j];
      const bool rel_brake = !over && brk[j];
      const bool hi2 = p > c.t2;
      const bool cap_t2 = !over && hi2 && !t2c[j];
      const bool esc_tick = !over && hi2 && t2c[j] && !hpc[j];
      t2s[j] = cap_t2 ? 0 : (esc_tick ? t2s[j] + 1 : t2s[j]);
      const bool cap_hp = esc_tick && t2s[j] >= esc;
      const bool cap_t1 = !over && !hi2 && p > c.t1 && !t1c[j];
      const bool t2c_mid = t2c[j] || over || cap_t2;
      const bool t1c_mid = t1c[j] || over || cap_t2 || cap_t1;
      const bool hpc_mid = hpc[j] || over || cap_hp;
      const bool rel_t2 = !over && t2c_mid && p < c.t2_release;
      t2c[j] = t2c_mid && !rel_t2;
      hpc[j] = hpc_mid && !rel_t2;
      const bool rel_t1 = !over && t1c_mid && !t2c[j] && p < c.t1_release;
      t1c[j] = t1c_mid && !rel_t1;
      brk[j] = over;

      // commands in the policy's order: later ones overwrite earlier ones
      int lp = 0, hp = 0;
      if (rel_brake) { lp = kLpT2; hp = kHpT2; }
      if (cap_t2) lp = kLpT2;
      if (cap_hp) hp = kHpT2;
      if (cap_t1) lp = kLpT1;
      if (rel_t2) { lp = kLpT1; hp = kOne; }
      if (rel_t1) lp = kOne;
      const int shift = 8 * j;
      oob_set |= (unsigned)(lp | hp << 4) << shift;
      if (lp) oob_keep &= ~(0x0Fu << shift);
      if (hp) oob_keep &= ~(0xF0u << shift);
      if (fire) {
        brake_set |= 0xFFu << shift;
        ++nbr[j];
      }

      if (valid[j]) {
        const long long e = at + j * kThreads;
        row_w[e] = rw;
        fire_out[e] = fire ? 1 : 0;
        f_lp_out[e] = f_lp[j];
        f_hp_out[e] = f_hp[j];
      }
      o[j] = nxt[j];
    }

    // push: OOB commands first (only the fields they set), then the brake,
    // which overwrites both fields
    if (oob_keep != 0xFFFF) {
      unsigned short* q = ring + s_oob * kThreads + tid;
      *q = (unsigned short)((*q & oob_keep) | oob_set);
    }
    if (brake_set) {
      unsigned short* q = ring + s_brk * kThreads + tid;
      *q = (unsigned short)((*q & ~brake_set) |
                            (brake_set & (kBrake * 0x1111u)));
    }
    if (++s_pop == D) s_pop = 0;
    if (++s_oob == D) s_oob = 0;
    if (++s_brk == D) s_brk = 0;
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j)
    if (valid[j]) n_brakes[lane0 + j * kThreads] = nbr[j];
}

size_t ring_bytes(int ring_depth) {
  return (size_t)ring_depth * kThreads * sizeof(unsigned short);
}

// Select the device and allow the ring's dynamic shared memory.
cudaError_t prepare(int device, int ring_depth) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (ring_depth < 1 || ring_depth > kMaxRingDepth) return cudaErrorInvalidValue;
  const size_t shared = ring_bytes(ring_depth);
  if (shared > kDefaultSharedBytes)
    return cudaFuncSetAttribute(polca_tick_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)shared);
  return cudaSuccess;
}

}  // namespace

// The launch shape for `lanes` lanes and a ring of `ring_depth` slots on
// CUDA device `device`: out = {threads a block, lanes a thread, blocks,
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// SMs, dynamic shared bytes a block, the largest ring depth}. Returns a CUDA
// error code (0 on success).
extern "C" int polca_tick_plan(long long lanes, int ring_depth, int device,
                               long long* out) {
  cudaError_t err = prepare(device, ring_depth);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, polca_tick_kernel, kThreads, ring_bytes(ring_depth));
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long per_block = kThreads * kLanes;
  out[0] = kThreads;
  out[1] = kLanes;
  out[2] = (lanes + per_block - 1) / per_block;
  out[3] = per_sm;
  out[4] = sms;
  out[5] = (long long)ring_bytes(ring_depth);
  out[6] = kMaxRingDepth;
  return (int)cudaSuccess;
}

// Launch on `stream` (PyTorch's current stream) of CUDA device `device`.
// occ is read at occ[n * s_n + k * s_t + r * s_r]; `freq` (host memory)
// holds the values of codes 1..5 (kernels/tick.py::freq_table). Returns
// cudaGetLastError() after the launch (0 on success); the kernel runs
// asynchronously and a fault during the run shows at the next
// synchronization.
extern "C" int polca_tick_launch(
    const void* occ, long long s_n, long long s_t, long long s_r,
    const void* bscale, const void* row_budget, void* row_w, void* fire,
    void* f_lp, void* f_hp, void* n_brakes, int N, int T, int R,
    int oob_ticks, int brake_ticks, int ring_depth, int esc, double t1,
    double t2, double t1_buf, double t2_buf, double p0_srv_w, double k_lp_w,
    double k_hp_w, double gamma, double n_servers, double power_scale,
    const double* freq, int device, void* stream) {
  cudaError_t err = prepare(device, ring_depth);
  if (err != cudaSuccess) return (int)err;
  const long long lanes = (long long)N * R;
  if (lanes <= 0 || T <= 0) return (int)cudaSuccess;
  const long long per_block = kThreads * kLanes;
  const long long blocks = (lanes + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  TickConsts c{t1, t2, t1 - t1_buf, t2 - t2_buf, power_scale * n_servers,
               p0_srv_w, k_lp_w, k_hp_w, gamma, {0.0}};
  for (int i = 1; i < kCodes; ++i) c.freq[i] = freq[i - 1];
  polca_tick_kernel<<<(unsigned)blocks, kThreads, ring_bytes(ring_depth),
                      (cudaStream_t)stream>>>(
      (const double*)occ, s_n, s_t, s_r, (const double*)bscale,
      (const double*)row_budget, (double*)row_w, (unsigned char*)fire,
      (double*)f_lp, (double*)f_hp, (int*)n_brakes, lanes, T, R, oob_ticks,
      brake_ticks, ring_depth, esc, c);
  return (int)cudaGetLastError();
}
