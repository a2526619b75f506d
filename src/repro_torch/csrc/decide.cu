// Fused Algorithm-1 decide (K4) for Hopper (sm_90a), in float64.
//
// Replaces the TPU kernel in src/repro/core/policy_kernels.py:
//   _score_pallas -> _pallas_fn -> pl.pallas_call, body _dest_kernel
//   -> repro_decide_dest_f64
//
// For each (cell, job) row of a padded batch it picks the migration
// destination: the site that passes the time, energy and class-C gates,
// is not the source, and has the greatest benefit above
// max(T_cost, min_benefit); ties go to the least transfer time, then to
// the lowest site id; -1 when no site qualifies.
//
// Bit-identity with the float64 numpy pass (_score_numpy), which
// produces every gated digit of the simulator: the TPU kernel ran in
// float32 because the TPU has no float64; this one runs in float64 and
// issues every floating-point operation through the round-to-nearest
// intrinsics (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn) in numpy's
// order, so no multiply and add can ever be contracted into an FMA
// whatever the build flags.  Division is IEEE: x / 0 gives inf, which the
// gates reject (a padded site or a dead link has bw 0).  Never build this
// file with --use_fast_math.  np.minimum / np.maximum propagate NaN, and
// so do np_min / np_max below.
//
// What bounds it on the card: bytes, by the count of the spec sheet.  Each
// (cell, job, site) element reads one float64 of bandwidth (8 bytes) and
// does ~20 float64 operations, so at the fleet's shapes the (B, K, S)
// bandwidth tensor is ~95% of the traffic: 34.7 us at 131,072 x 104.  In
// practice the float64 pipe is as close a limit: an IEEE division (a
// reciprocal and its Newton steps) and ~30 float64 adds, products and
// comparisons per element run at 64 lanes a clock per SM, ~31 us at that
// shape before any integer work.  So the design spends no instruction it
// can avoid and keeps many loads in flight:
//   * kGroup = 8 threads per (cell, job) row, 16 rows per block; thread
//     `sub` of a row takes sites sub, sub + 8, ... (104 sites = 13 each,
//     every lane busy), so a warp's load covers 4 rows x 64 contiguous
//     bytes.  A batch of fewer rows than 16 per SM of the card (the fleet
//     tick: 512) takes kGroup = 32, 4 rows per block, so that it too
//     spreads over the card: 7.1 us against 8.7 us with kGroup = 8 on an
//     H100 (chip_smoke.py);
//   * loads first: a thread issues all of its row's bw loads for a chunk of
//     kChunk = 128 sites into registers before the first division; larger
//     S loops over chunks;
//   * a block's rows belong to one cell: the cell's sites (window, queue
//     load, and the two job-independent terms, the time gate's limit and
//     the full-site penalty) are staged once per block and chunk in shared
//     memory; the grid has one block per kThreads / kGroup rows, up to
//     kBlocksPerSM = 16 blocks per SM of the card (the 512-row fleet tick:
//     128 blocks; 131,072 rows on an H100's 132 SMs: 2,112 blocks, 4 rows
//     per thread group);
//   * each thread reads its row's 6 job values itself (the row's 8 lanes
//     share the L1 line); the source-site test is an integer compare;
//   * zero divisors (dead links, padded sites) and zero dividends (padded
//     rows) are answered exactly beside the division (div_rn), which then
//     never takes its slow path on this data;
//   * each thread keeps its running best in increasing site id (a strict
//     test keeps the lower sid on ties); log2(kGroup) shuffle steps across
//     the row's lanes then pick the lexicographic best (greatest benefit,
//     least tt, least sid).  The TPU's sequential site-tile grid axis and its
//     VMEM scratch become that loop inside the thread group: nothing
//     carries between blocks.
// ptxas -v (sm_90a, CUDA 12.8; chip_smoke.py prints them on every build):
// decide_dest_kernel<8> 80 registers, 20 B spilled; <32> 80 registers, no
// spills.  chip_smoke.py on an H100 (700 W), event-timed: 0.079 ms at
// 131,072 x 104 (the first design: 0.193 ms), 7.1 us at the 512-row fleet
// tick (the first design: 8.6 us), mostly launch latency.
//
// Layouts (all float64, contiguous):
//   jobs  (B, K, 6): size bytes, t_load s, remaining s, source renewable
//                    window s, source load, source site id
//   sites (B, S, 3): window s, bq load, free slots
//   bw    (B, K, S): bits/s
//   dest  (B, K)   : int64 destination site, -1 = stay
//
// The entry returns cudaGetLastError() after its launch; the Python
// wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 128;                      // sites staged at a time
constexpr int kBlocksPerSM = 16;                 // blocks the grid aims at per SM
constexpr int kJobCols = 6;
constexpr int kSiteCols = 3;

struct Scalars {
  double alpha, gamma, betaqp, queue_penalty_s, min_benefit_s, ppf_sigma;
  double energy_ratio, t_downtime_s, class_c_s;
  int use_stoch;
};

// numpy's minimum / maximum: NaN in either argument gives NaN.
__device__ __forceinline__ double np_min(double a, double b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ double np_max(double a, double b) {
  return (a != a || a > b) ? a : b;
}

// IEEE x / y rounded to nearest, as __ddiv_rn.  __ddiv_rn sends a zero
// operand down its slow path, and one lane there holds its whole warp:
// zero divisors (dead links, padded sites) and zero dividends (padded job
// rows) are common here, so they are answered exactly beside it.
__device__ __forceinline__ double div_rn(double x, double y) {
  const bool special = x == 0.0 || y == 0.0;
  const double q = __ddiv_rn(special ? 1.0 : x, special ? 1.0 : y);
  if (!special) return q;
  if (x != x || y != y || (x == 0.0 && y == 0.0)) return __longlong_as_double(0x7ff8000000000000LL);
  const bool neg = (__double_as_longlong(x) < 0) != (__double_as_longlong(y) < 0);
  if (y == 0.0) return neg ? -INFINITY : INFINITY;
  return neg ? -0.0 : 0.0;
}

// Does candidate (b2, t2, s2) beat (b1, t1, s1)?  s < 0 means none.
__device__ __forceinline__ bool beats(double b1, double t1, int s1,
                                      double b2, double t2, int s2) {
  if (s2 < 0) return false;
  if (s1 < 0) return true;
  if (b2 != b1) return b2 > b1;
  if (t2 != t1) return t2 < t1;
  return s2 < s1;
}

// kGroup threads per (cell, job) row.  At least 6 blocks an SM: registers
// are capped at 80 (a few bytes spill), so more rows' loads are in flight.
template <int kGroup>
__global__ void __launch_bounds__(kThreads, 6)
decide_dest_kernel(const double* __restrict__ jobs, const double* __restrict__ sites,
                   const double* __restrict__ bw, long long* __restrict__ dest,
                   long long K, int S, long long blocks_per_cell, Scalars p) {
  // The chunk's sites: window, queue load, and the two per-site terms that
  // do not depend on the job (the time gate's limit, the full-site penalty).
  __shared__ double s_w[kChunk], s_bq[kChunk], s_limit[kChunk], s_pen[kChunk];
  constexpr int kRowsPerBlock = kThreads / kGroup;
  constexpr int kPerThread = kChunk / kGroup;  // bw loads in flight per thread

  const long long cell = blockIdx.x / blocks_per_cell;
  const long long stride = blocks_per_cell * kRowsPerBlock;
  const long long first = (blockIdx.x % blocks_per_cell) * kRowsPerBlock + threadIdx.x / kGroup;
  const long long n_rows = (K + stride - 1) / stride;  // the same for every thread of the block
  const int sub = threadIdx.x % kGroup;
  const double* site = sites + cell * S * kSiteCols;
  const double pen = -p.queue_penalty_s;

  for (long long r = 0; r < n_rows; ++r) {
    const long long kr = first + r * stride;
    const bool active = kr < K;  // idle threads still stage sites and shuffle
    const long long row = cell * K + (active ? kr : 0);
    const double* job = jobs + row * kJobCols;
    const double size = job[0], t_load = job[1], rem = job[2];
    const double cur_green = job[3], load_src = job[4], s_src = job[5];
    // (double)s != s_src for every site id s, as an integer test: src is
    // s_src where that is a site id, else -1, which no site id equals.
    const int src = s_src >= 0.0 && s_src < (double)S && s_src == floor(s_src) ? (int)s_src : -1;
    const double* bw_row = bw + row * S;
    const double size8 = __dmul_rn(8.0, size);
    const double green_used = np_min(cur_green, rem);

    double best_b = -INFINITY, best_t = 0.0;
    int best_s = -1;
    for (int c0 = 0; c0 < S; c0 += kChunk) {
      const int n = min(kChunk, S - c0);
      double bwv[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int sl = sub + kGroup * i;
        bwv[i] = active && sl < n ? bw_row[c0 + sl] : 0.0;
      }
      if (r == 0 || S > kChunk) {  // block-uniform: one chunk is staged once
        __syncthreads();           // the previous chunk's sites are consumed
        for (int i = threadIdx.x; i < n; i += kThreads) {
          const double W = site[(c0 + i) * kSiteCols + 0];
          const double free_slots = site[(c0 + i) * kSiteCols + 2];
          s_w[i] = W;
          s_bq[i] = site[(c0 + i) * kSiteCols + 1];
          s_limit[i] = p.use_stoch ? __dmul_rn(p.alpha, np_max(__dadd_rn(W, p.ppf_sigma), 0.0))
                                   : __dmul_rn(p.alpha, W);
          s_pen[i] = free_slots <= 0.0 ? pen : 0.0;
        }
        __syncthreads();
      }
      if (!active) continue;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int sl = sub + kGroup * i;
        if (sl >= n) break;
        const int s = c0 + sl;
        const double W = s_w[sl];
        const double tt = div_rn(size8, bwv[i]);
        const double t_cost = __dadd_rn(__dadd_rn(tt, t_load), p.t_downtime_s);
        const bool energy_ok = __dmul_rn(p.energy_ratio, tt) < W;
        const bool not_c = tt < p.class_c_s;
        const bool time_ok = t_cost < s_limit[sl];
        const double avoided = np_max(0.0, __dsub_rn(np_min(W, rem), green_used));
        double benefit = __dsub_rn(__dmul_rn(p.gamma, avoided),
                                   __dmul_rn(p.betaqp, __dsub_rn(s_bq[sl], load_src)));
        benefit = __dadd_rn(benefit, s_pen[sl]);
        // benefit > np_max(t_cost, min_benefit), NaN t_cost failing both
        const bool valid = time_ok && energy_ok && not_c && s != src &&
                           benefit > t_cost && benefit > p.min_benefit_s;
        // Sites rise within a thread, so a strict test keeps the lower sid
        // on ties; best_b starts at -inf, below any valid benefit (which
        // exceeds t_cost), so no test for "none yet" is needed.
        if (valid && (benefit > best_b || (benefit == best_b && tt < best_t))) {
          best_b = benefit;
          best_t = tt;
          best_s = s;
        }
      }
    }
    // The row's kGroup threads are kGroup neighbouring lanes of one warp.
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      const double ob = __shfl_xor_sync(0xffffffffu, best_b, off);
      const double ot = __shfl_xor_sync(0xffffffffu, best_t, off);
      const int os = __shfl_xor_sync(0xffffffffu, best_s, off);
      if (beats(best_b, best_t, best_s, ob, ot, os)) {
        best_b = ob;
        best_t = ot;
        best_s = os;
      }
    }
    // numpy: np.where(np.isfinite(max benefit), argmax, -1)
    if (active && sub == 0) dest[row] = (best_s >= 0 && isfinite(best_b)) ? best_s : -1;
  }
}

// One block per kRowsPerBlock rows of a cell, up to ``target`` blocks in
// all (more rows per thread group when K is large).
template <int kGroup>
int launch(const void* jobs, const void* sites, const void* bw, void* dest, long long B,
           long long K, long long S, long long target, const Scalars& p, cudaStream_t stream) {
  constexpr long long kRowsPerBlock = kThreads / kGroup;
  const long long blocks_per_cell = std::min((K + kRowsPerBlock - 1) / kRowsPerBlock,
                                             std::max(1LL, (target + B - 1) / B));
  if (B * blocks_per_cell > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  decide_dest_kernel<kGroup><<<(unsigned)(B * blocks_per_cell), kThreads, 0, stream>>>(
      static_cast<const double*>(jobs), static_cast<const double*>(sites),
      static_cast<const double*>(bw), static_cast<long long*>(dest), K, static_cast<int>(S),
      blocks_per_cell, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_decide_dest_f64(
    const void* jobs, const void* sites, const void* bw, void* dest,
    long long B, long long K, long long S,
    double alpha, double gamma, double betaqp, double queue_penalty_s,
    double min_benefit_s, double ppf_sigma, int use_stoch,
    double energy_ratio, double t_downtime_s, double class_c_s,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || K <= 0) return 0;
  if (S <= 0 || S > INT_MAX / kSiteCols) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Scalars p{alpha, gamma, betaqp, queue_penalty_s, min_benefit_s, ppf_sigma,
                  energy_ratio, t_downtime_s, class_c_s, use_stoch};
  const long long target = static_cast<long long>(sms) * kBlocksPerSM;
  const auto st = static_cast<cudaStream_t>(stream);
  // Fewer rows than one 8-thread-per-row block per SM: 32 threads per row,
  // so that the batch still spreads over the card.
  return B * K <= static_cast<long long>(sms) * (kThreads / 8)
             ? launch<32>(jobs, sites, bw, dest, B, K, S, target, p, st)
             : launch<8>(jobs, sites, bw, dest, B, K, S, target, p, st);
}
