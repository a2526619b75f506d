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
// What bounds it on the card: bytes.  Each (cell, job, site) element
// reads one float64 of bandwidth (8 bytes) and does ~20 float64
// operations, so at the fleet's shapes the (B, K, S) bandwidth tensor is
// ~95% of the traffic.  The design: one warp per (cell, job) row; the
// lanes stride over the sites (s = lane, lane + 32, ...), so each warp
// reads its row of bw coalesced, and each lane keeps its running best in
// increasing site id.  A shuffle reduction then picks the lexicographic
// best (greatest benefit, least tt, least sid) across lanes.  The TPU's
// sequential site-tile grid axis and its VMEM scratch become that loop
// inside the warp: nothing carries between blocks.
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

namespace {

constexpr int kWarpsPerCta = 8;
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

// Does candidate (b2, t2, s2) beat (b1, t1, s1)?  s < 0 means none.
__device__ __forceinline__ bool beats(double b1, double t1, int s1,
                                      double b2, double t2, int s2) {
  if (s2 < 0) return false;
  if (s1 < 0) return true;
  if (b2 != b1) return b2 > b1;
  if (t2 != t1) return t2 < t1;
  return s2 < s1;
}

__global__ void __launch_bounds__(32 * kWarpsPerCta)
decide_dest_kernel(const double* __restrict__ jobs, const double* __restrict__ sites,
                   const double* __restrict__ bw, long long* __restrict__ dest,
                   long long rows, long long K, int S, Scalars p) {
  const long long row = (long long)blockIdx.x * kWarpsPerCta + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps exit together: row is warp-uniform

  const double* job = jobs + row * kJobCols;
  const double size = job[0], t_load = job[1], rem = job[2];
  const double cur_green = job[3], load_src = job[4], s_src = job[5];
  const double* site = sites + (row / K) * S * kSiteCols;
  const double* bw_row = bw + row * S;

  const double size8 = __dmul_rn(8.0, size);
  const double green_used = np_min(cur_green, rem);
  const double pen = -p.queue_penalty_s;

  double best_b = 0.0, best_t = 0.0;
  int best_s = -1;
  for (int s = lane; s < S; s += 32) {
    const double W = site[s * kSiteCols + 0];
    const double bq_load = site[s * kSiteCols + 1];
    const double free_slots = site[s * kSiteCols + 2];
    const double tt = __ddiv_rn(size8, bw_row[s]);
    const double t_cost = __dadd_rn(__dadd_rn(tt, t_load), p.t_downtime_s);
    const bool energy_ok = __dmul_rn(p.energy_ratio, tt) < W;
    const bool not_c = tt < p.class_c_s;
    const double limit = p.use_stoch
        ? __dmul_rn(p.alpha, np_max(__dadd_rn(W, p.ppf_sigma), 0.0))
        : __dmul_rn(p.alpha, W);
    const bool time_ok = t_cost < limit;
    const double avoided = np_max(0.0, __dsub_rn(np_min(W, rem), green_used));
    double benefit = __dsub_rn(__dmul_rn(p.gamma, avoided),
                               __dmul_rn(p.betaqp, __dsub_rn(bq_load, load_src)));
    benefit = __dadd_rn(benefit, free_slots <= 0.0 ? pen : 0.0);
    const bool valid = time_ok && energy_ok && not_c && (double)s != s_src &&
                       benefit > np_max(t_cost, p.min_benefit_s);
    // sites rise within a lane, so a strict test keeps the lower sid on ties
    if (valid && beats(best_b, best_t, best_s, benefit, tt, s)) {
      best_b = benefit;
      best_t = tt;
      best_s = s;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
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
  if (lane == 0) {
    dest[row] = (best_s >= 0 && isfinite(best_b)) ? best_s : -1;
  }
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
  const long long rows = B * K;
  if (rows <= 0) return 0;
  const long long blocks = (rows + kWarpsPerCta - 1) / kWarpsPerCta;
  if (blocks > INT_MAX || S <= 0 || S > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scalars p{alpha, gamma, betaqp, queue_penalty_s, min_benefit_s, ppf_sigma,
                  energy_ratio, t_downtime_s, class_c_s, use_stoch};
  decide_dest_kernel<<<(unsigned)blocks, 32 * kWarpsPerCta, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(jobs), static_cast<const double*>(sites),
      static_cast<const double*>(bw), static_cast<long long*>(dest),
      rows, K, static_cast<int>(S), p);
  return static_cast<int>(cudaGetLastError());
}
