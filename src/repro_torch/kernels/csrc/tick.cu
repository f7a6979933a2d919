// POLCA tick loop: a hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/tick.py::_tick_kernel, the Pallas kernel behind
// repro.kernels.tick.polca_tick_loop and repro.kernels.ops.polca_tick.
//
// Computes, for every (member, row) lane, T ticks of the non-predictive POLCA
// state machine: pop the [D, 2] actuation ring and apply any due frequency
// command; row watts power_scale * n_servers * (p0 + occ * (k_lp * f_lp^gamma
// + k_hp * f_hp^gamma)); p = watts / (row_budget * bscale_k); the T1/T2/HP/
// brake latch and escalation step of PolcaPolicy; push OOB commands oob_ticks
// ahead and brake commands brake_ticks ahead (the brake push comes last and
// overwrites, the event-driven simulator's same-due-time rule). It writes the
// per-tick row watts, brake firings and frequencies and the brake count.
//
// Bound: bytes. Each lane-tick reads 8 B (occupancy) and writes 25 B (row_w,
// f_lp, f_hp as float64, fire as one byte): 33 B against about twenty float64
// operations and two pow() calls, far under the card's FP64 rate.
//
// Design: one thread per lane, with the whole T-tick loop inside the thread:
// the ticks are a sequential recurrence and the lanes are independent.
// Frequencies, latches and counters live in registers. The ring is indexed by
// k % D at run time, so it lives in dynamic shared memory, D * 2 doubles per
// thread laid out [slot][field][thread] so that a warp touches consecutive
// words (a dynamically indexed register array would spill to local memory
// anyway). The lane index comes from blockIdx/threadIdx and the ragged last
// block is masked, so members are not padded. Threads never share ring words,
// so the kernel needs no __syncthreads().
//
// Numerics: float64 throughout, as the bit-identical brake-set contract
// requires. NaN marks an empty ring slot, so the build must not use
// --use_fast_math (isnan() has to be real); it uses -fmad=false so the power
// expression rounds like the plain PyTorch version's separate multiplies and
// adds.
//
// Layouts are the Pallas kernel's: occ, row_w, f_lp, f_hp, fire [N, T, R];
// bscale [T, R]; row_budget [R]; n_brakes [N, R]. Each lane walks a strided
// column of occ and of the outputs; staging through a coalesced [T, N * R]
// layout is left for later work.

#include <cuda_runtime.h>

namespace {

struct TickConsts {
  double t1, t2, t1_buf, t2_buf, lp_t1, lp_t2, hp_t2, brake_freq;
  double p0_srv_w, k_lp_w, k_hp_w, lp_share, gamma, n_servers, power_scale;
};

constexpr int kMaxThreads = 128;
constexpr size_t kDefaultSharedBytes = 48 * 1024;
constexpr size_t kMaxSharedBytes = 227 * 1024;

__global__ void polca_tick_kernel(
    const double* __restrict__ occ, const double* __restrict__ bscale,
    const double* __restrict__ row_budget, double* __restrict__ row_w,
    unsigned char* __restrict__ fire_out, double* __restrict__ f_lp_out,
    double* __restrict__ f_hp_out, int* __restrict__ n_brakes, int N, int T,
    int R, int oob_ticks, int brake_ticks, int D, int esc, TickConsts c) {
  extern __shared__ double ring[];  // [D][2][blockDim.x]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long lane = (long long)blockIdx.x * nt + tid;
  if (lane >= (long long)N * R) return;
  const int r = (int)(lane % R);
  const long long n = lane / R;

  const double nan_v = __longlong_as_double(0x7ff8000000000000LL);
  for (int s = 0; s < 2 * D; ++s) ring[s * nt + tid] = nan_v;

  const double psn = c.power_scale * c.n_servers;
  const double t2_release = c.t2 - c.t2_buf;
  const double t1_release = c.t1 - c.t1_buf;
  const double budget = row_budget[r];

  double f_lp = 1.0, f_hp = 1.0;
  bool t1c = false, t2c = false, hpc = false, brk = false;
  int t2s = 0, nbr = 0;

  long long idx = n * T * R + r;  // element (n, k, r) of the [N, T, R] planes
  for (int k = 0; k < T; ++k, idx += R) {
    // pop the ring: apply due commands, clear the slot
    double* pend = ring + (2 * (k % D)) * nt + tid;
    const double pend_lp = pend[0], pend_hp = pend[nt];
    if (!isnan(pend_lp)) f_lp = pend_lp;
    if (!isnan(pend_hp)) f_hp = pend_hp;
    pend[0] = nan_v;
    pend[nt] = nan_v;

    // row watts and the budget fraction
    const double busy = c.k_lp_w * pow(f_lp, c.gamma)
                        + c.k_hp_w * pow(f_hp, c.gamma);
    const double rw = psn * (c.p0_srv_w + occ[idx] * busy);
    const double tick_budget = budget * bscale[(long long)k * R + r];
    const double p = rw / tick_budget;

    // PolcaPolicy.observe, as in kernels/tick.py::polca_latch_step
    const bool over = p > 1.0;
    const bool fire = over && !brk;
    const bool rel_brake = !over && brk;
    const bool hi2 = p > c.t2;
    const bool cap_t2 = !over && hi2 && !t2c;
    const bool esc_tick = !over && hi2 && t2c && !hpc;
    t2s = cap_t2 ? 0 : (esc_tick ? t2s + 1 : t2s);
    const bool cap_hp = esc_tick && t2s >= esc;
    const bool cap_t1 = !over && !hi2 && p > c.t1 && !t1c;
    const bool t2c_mid = t2c || over || cap_t2;
    const bool t1c_mid = t1c || over || cap_t2 || cap_t1;
    const bool hpc_mid = hpc || over || cap_hp;
    const bool rel_t2 = !over && t2c_mid && p < t2_release;
    t2c = t2c_mid && !rel_t2;
    hpc = hpc_mid && !rel_t2;
    const bool rel_t1 = !over && t1c_mid && !t2c && p < t1_release;
    t1c = t1c_mid && !rel_t1;
    brk = over;

    // commands in the policy's order: later ones overwrite earlier ones
    double lp_cmd = nan_v, hp_cmd = nan_v;
    if (rel_brake) { lp_cmd = c.lp_t2; hp_cmd = c.hp_t2; }
    if (cap_t2) lp_cmd = c.lp_t2;
    if (cap_hp) hp_cmd = c.hp_t2;
    if (cap_t1) lp_cmd = c.lp_t1;
    if (rel_t2) { lp_cmd = c.lp_t1; hp_cmd = 1.0; }
    if (rel_t1) lp_cmd = 1.0;

    // push: OOB commands first, then the brake, which overwrites
    double* oob = ring + (2 * ((k + oob_ticks) % D)) * nt + tid;
    if (!isnan(lp_cmd)) oob[0] = lp_cmd;
    if (!isnan(hp_cmd)) oob[nt] = hp_cmd;
    if (fire) {
      double* brake = ring + (2 * ((k + brake_ticks) % D)) * nt + tid;
      brake[0] = c.brake_freq;
      brake[nt] = c.brake_freq;
      ++nbr;
    }

    row_w[idx] = rw;
    fire_out[idx] = fire ? 1 : 0;
    f_lp_out[idx] = f_lp;
    f_hp_out[idx] = f_hp;
  }
  n_brakes[lane] = nbr;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream) of CUDA device `device`.
// Returns cudaGetLastError() after the launch (0 on success); the kernel
// runs asynchronously and a fault during the run shows at the next
// synchronization.
extern "C" int polca_tick_launch(
    const void* occ, const void* bscale, const void* row_budget, void* row_w,
    void* fire, void* f_lp, void* f_hp, void* n_brakes, int N, int T, int R,
    int oob_ticks, int brake_ticks, int ring_depth, int esc, double t1,
    double t2, double t1_buf, double t2_buf, double lp_t1, double lp_t2,
    double hp_t2, double brake_freq, double p0_srv_w, double k_lp_w,
    double k_hp_w, double lp_share, double gamma, double n_servers,
    double power_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long lanes = (long long)N * R;
  if (lanes <= 0) return (int)cudaSuccess;

  // as many threads per block as fit the default 48 KB of shared memory,
  // down to one warp; deeper rings opt in to more shared memory
  const size_t per_thread = (size_t)ring_depth * 2 * sizeof(double);
  int threads = kMaxThreads;
  while (threads > 32 && per_thread * threads > kDefaultSharedBytes) threads /= 2;
  const size_t shared = per_thread * threads;
  if (shared > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (shared > kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(polca_tick_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  const TickConsts c{t1, t2, t1_buf, t2_buf, lp_t1, lp_t2, hp_t2, brake_freq,
                     p0_srv_w, k_lp_w, k_hp_w, lp_share, gamma, n_servers,
                     power_scale};
  polca_tick_kernel<<<blocks, threads, shared, (cudaStream_t)stream>>>(
      (const double*)occ, (const double*)bscale, (const double*)row_budget,
      (double*)row_w, (unsigned char*)fire, (double*)f_lp, (double*)f_hp,
      (int*)n_brakes, N, T, R, oob_ticks, brake_ticks, ring_depth, esc, c);
  return (int)cudaGetLastError();
}
