// Flash attention backward on Hopper's tensor cores (sm_90a), float32 and
// bfloat16.
//
// The TPU package has no attention backward kernel: it trains by XLA's
// autodiff of flash_attention_ref (src/repro/kernels/ref.py), since
// jax.grad through flash_attention_pallas fails.  This file computes the
// same gradients for K1's forward (flash_attention.cu): dQ, dK and dV of
// GQA attention over q, do (b, s, nh, hd) and k, v (b, t, nkv, hd), with
// scores scaled by hd^-0.5, optional tanh softcap (the chain rule through
// cap * tanh(x / cap) multiplies dS by 1 - tanh^2), causal / sliding-window /
// full masks on dense left-aligned positions, and ragged s and t.  The kv
// head of query head h is h / (nh / nkv), so dK and dV of a kv head sum over
// its nh / nkv query heads.
//
// What bounds it on the card: operations in float32, bytes in bfloat16.
// At the training slice's shape (8, 512, 6, 64), causal, the five products
// (S recomputed, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K) need
// 4.03 GFLOP: float32 does each as three TF32 products (3 x 4.03 GFLOP at
// 495 TFLOP/s, 0.0245 ms, against 50 MB of q, k, v, o, dO, dQ, dK, dV in
// 0.015 ms); bf16 needs 0.0041 ms at 989 TFLOP/s and 25.3 MB in 0.0076 ms.
// Every product runs on the tensor cores with mma.sync, on the machinery of
// K1's forward (flash_common.cuh):
//   * float32: m16n8k8 TF32 with a 3xTF32 split, every operand hi/lo and
//     each product lo*hi + hi*lo + hi*hi (float32-class accuracy;
//     tests/test_torch_tf32_split.py emulates the whole backward against
//     the plain version); never torch's allow_tf32 switches.  The tensor
//     cores truncate as they accumulate, so each register pass's share of
//     dQ, dK and dV goes into a fresh accumulator, kOutGroup output n-tiles
//     at a time, and is added to the float32 running sum;
//   * bfloat16: m16n8k16 with float32 accumulation; P and dS are rounded
//     to bf16 before they multiply dO, Q and K, and dQ, dK, dV are written
//     in bf16, as the plain version rounds them.
// The design, FlashAttention-2's without atomics, so the result is
// deterministic (a fixed summation order; S and dP are recomputed in both
// roles):
//   * the forward writes each row's log-sum-exp in base 2 (lse), so P is
//     recomputed as 2^(x - lse) with x exactly K1's scores times log2 e
//     (softcap included); no row max or sum is recomputed;
//   * a preprocess computes D = rowsum(dO * O) in float32 (16-byte vector
//     loads), so dS = P (dP - D), times 1 - tanh^2 and the scale;
//   * one kernel, two roles, in one launch.  A block of 4 warps keeps two
//     fixed tiles of 64 rows (each warp owns 16 of them) and streams tiles
//     of kBn rows of the other side:
//       dK/dV, per (k tile, kv head, batch): fixed K, V; streamed Q, dO (and
//         their rows' lse and D) over the group's query heads and the q tiles
//         that see the k tile.  The products are the transposed ones,
//         S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out as
//         accumulators with a k row per lane row, and dV += P^T dO, dK +=
//         dS^T Q take them as A fragments straight from registers;
//       dQ, per (q tile, head, batch): fixed Q, dO (each lane's two rows'
//         lse and D in registers); streamed K, V over the k tiles the rows
//         see; S = Q K^T, dP = dO V^T, dQ += dS K.
//     The grid interleaves the two roles heaviest first, so each fills the
//     other's tail (launched apart, each left SMs idle at its end);
//   * S-type products (A: the fixed tile, via ldmatrix; B: the streamed
//     tile's rows, via ldmatrix, as K in the forward's Q.K^T);
//     output products (A: P or dS from the accumulators; B: the streamed
//     tile's rows as the k index, as V in the forward's P.V).  float32:
//     the S accumulator holds columns 2t, 2t+1 while an m16n8k8 A fragment
//     wants t, t+4, so the mma's k index is relabelled (A column t is row
//     2t, t + 4 is 2t + 1) and B loads rows 2t, 2t + 1 with scalar loads;
//     bf16: two n-tiles of the accumulator are the m16n8k16 A fragment and
//     B comes from ldmatrix.trans;
//   * streamed tiles are copied global -> shared with cp.async (16 B per
//     thread; lse and D 4 B), double-buffered: tile j + 1 loads while tile j
//     computes.  Rows are padded by 16 B (conflict-free ldmatrix and scalar
//     loads); rows past s or t are zero-filled and masked;
//   * a warp computes S, dP and its outputs kNC streamed rows at a time in
//     registers; masks apply per element only where a pass straddles an
//     edge, and a warp skips a pass whose every element is masked (it would
//     add only zeros);
//   * a head dim above 64 is split into groups of kDo = 64 output columns,
//     one block each (S and dP are recomputed per group), so the output
//     accumulators stay at 16 x 64 per warp.
//
// Tiles, shared memory and registers per instantiation (ptxas -v, sm_90a,
// CUDA 12.8; chip_smoke.py prints them on every build), no spills:
//   type  hd   kBn  kNC  kDo x groups  smem      registers
//   f32   16   64   32   16 x 1         31.0 KB  134
//   f32   32   64   32   32 x 1         55.0 KB  161
//   f32   64   64   32   64 x 1        103.0 KB  234   2 blocks an SM
//   f32   128  32   32   64 x 2        132.5 KB  232
//   f32   256  16   16   64 x 4        195.2 KB  168
//   bf16  16   64   16   16 x 1         19.0 KB   96
//   bf16  32   64   16   32 x 1         31.0 KB  124
//   bf16  64   64   16   64 x 1         55.0 KB  162   3 blocks an SM (32-row
//                                                      passes: ptxas holds 168
//                                                      and spills 4 B)
//   bf16  128  32   16   64 x 2         68.5 KB  158
//   bf16  256  32   16   64 x 4        132.5 KB  162
// Shared memory exceeds the 48 KB default for most, so each launch opts in
// with cudaFuncSetAttribute.  All pointers must be 16-byte aligned (the
// wrapper checks).
//
// What still holds it (PERF.md): float32 splits every operand in registers,
// each streamed element once per warp that reads it (pre-split hi / lo
// tiles in shared memory, or wgmma, are the next step); at hd 64 two (f32)
// or three (bf16) blocks an SM hide the mma.sync latency.
//
// The entry returns cudaGetLastError() after its launches; the Python
// wrapper raises if it is not 0.

#include <math.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBm = 16 * kWarps;  // rows of a block's fixed tiles

template <typename T, int HD>
struct Bwd {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // rows of a streamed tile
  static constexpr int kBn = HD <= 64 ? 64 : (kF32 && HD == 256 ? 16 : 32);
  // streamed rows a warp holds in registers at a time (columns of S, dP):
  // bf16 16, one m16n8k16 k step, so hd 64 fits 3 blocks an SM
  static constexpr int kNC = kF32 ? (kBn > 32 ? 32 : kBn) : 16;
  // output head-dim columns per block
  static constexpr int kDo = HD < 64 ? HD : 64;
  static constexpr int kGroups = HD / kDo;
  // float32 output n-tiles per fresh accumulator
  static constexpr int kOutGroup = kDo / 8 < 4 ? kDo / 8 : 4;
  static constexpr int kStride = HD + 16 / sizeof(T);  // shared row, padded by 16 B
  static constexpr size_t kBytes =
      sizeof(T) * kStride * (2 * kBm + 4 * kBn) + sizeof(float) * 4 * kBn;
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int b, s, t, nh, nkv, mask, window;
  float softcap, scale;
};

// dot product of two 16-byte vectors of T, in float32.
template <typename T>
__device__ __forceinline__ float dot16(const uint4& x, const uint4& y, float acc) {
  const unsigned xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      acc = fmaf(__uint_as_float(xs[i]), __uint_as_float(ys[i]), acc);
    } else {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
      acc = fmaf(a.y, b.y, fmaf(a.x, b.x, acc));
    }
  }
  return acc;
}

// D = rowsum(dO * O) in float32, written as (b, nh, s): kL lanes per (b, i,
// h) row, each reading 16-byte vectors of O and dO.
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int s, int nh) {
  constexpr int kVec = 16 / sizeof(T), kVecs = HD / kVec;
  constexpr int kL = kVecs < 32 ? kVecs : 32;  // lanes per row, a power of 2
  const long long row = (long long)blockIdx.x * (256 / kL) + threadIdx.x / kL;
  const int lane = threadIdx.x % kL;
  float acc = 0.0f;
  if (row < rows) {
    const uint4* orow = reinterpret_cast<const uint4*>(o + row * HD);
    const uint4* drow = reinterpret_cast<const uint4*>(dout + row * HD);
    for (int c = lane; c < kVecs; c += kL) acc = dot16<T>(orow[c], drow[c], acc);
  }
#pragma unroll
  for (int off = kL / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0 && row < rows) {
    const int h = static_cast<int>(row % nh);
    const long long bi = row / nh;  // b * s + i
    const long long b = bi / s;
    const int i = static_cast<int>(bi % s);
    delta[(b * nh + h) * s + i] = acc;
  }
}

// x1 = F1 N1^T and x2 = F2 N2^T for this warp's 16 fixed rows (f1w, f2w)
// and kNC streamed rows (n1, n2): S and dP, or their transposes.
template <typename T, int HD>
__device__ __forceinline__ void scores_dp(const T* f1w, const T* f2w, const T* n1, const T* n2,
                                          int lane, float (&x1)[Bwd<T, HD>::kNC / 8][4],
                                          float (&x2)[Bwd<T, HD>::kNC / 8][4]) {
  using C = Bwd<T, HD>;
  constexpr int kS = C::kStride, kNT = C::kNC / 8;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x1[j][e] = x2[j][e] = 0.0f;
  // A: rows lane % 16, column half lane / 16; B: two n-tiles per ldmatrix.
  const int a_off = (lane % 16) * kS + (lane / 16) * (C::kF32 ? 4 : 8);
  const int b_off = ((lane % 8) + 8 * (lane / 16)) * kS + ((lane / 8) % 2) * (C::kF32 ? 4 : 8);
  if constexpr (C::kF32) {
#pragma unroll 2
    for (int kk = 0; kk < HD / 8; ++kk) {
      unsigned raw[4], a1h[4], a1l[4], a2h[4], a2l[4];
      ldsm_x4(raw, f1w + a_off + kk * 8);
      split_bits(raw, a1h, a1l);
      ldsm_x4(raw, f2w + a_off + kk * 8);
      split_bits(raw, a2h, a2l);
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {
        unsigned b1h[4], b1l[4], b2h[4], b2l[4];  // [n-tile 2p b0, b1, n-tile 2p+1 b0, b1]
        ldsm_x4(raw, n1 + 16 * p * kS + b_off + kk * 8);
        split_bits(raw, b1h, b1l);
        ldsm_x4(raw, n2 + 16 * p * kS + b_off + kk * 8);
        split_bits(raw, b2h, b2l);
        // term by term (lo.hi, hi.lo, hi.hi), so consecutive mmas feed
        // different accumulators
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_tf32(x1[2 * p + i], a1l, b1h[2 * i], b1h[2 * i + 1]);
          mma_tf32(x2[2 * p + i], a2l, b2h[2 * i], b2h[2 * i + 1]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_tf32(x1[2 * p + i], a1h, b1l[2 * i], b1l[2 * i + 1]);
          mma_tf32(x2[2 * p + i], a2h, b2l[2 * i], b2l[2 * i + 1]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_tf32(x1[2 * p + i], a1h, b1h[2 * i], b1h[2 * i + 1]);
          mma_tf32(x2[2 * p + i], a2h, b2h[2 * i], b2h[2 * i + 1]);
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned a1[4], a2[4];
      ldsm_x4(a1, f1w + a_off + kk * 16);
      ldsm_x4(a2, f2w + a_off + kk * 16);
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {
        unsigned b1[4], b2[4];
        ldsm_x4(b1, n1 + 16 * p * kS + b_off + kk * 16);
        ldsm_x4(b2, n2 + 16 * p * kS + b_off + kk * 16);
        mma_bf16(x1[2 * p], a1, b1[0], b1[1]);
        mma_bf16(x1[2 * p + 1], a1, b1[2], b1[3]);
        mma_bf16(x2[2 * p], a2, b2[0], b2[1]);
        mma_bf16(x2[2 * p + 1], a2, b2[2], b2[3]);
      }
    }
  }
}

// acc (16 fixed rows x kDo columns) += x (16 x kNC, from the accumulators)
// times the kNC streamed rows at nb (nb points at the first of them, at the
// block's first output column).
template <typename T, int HD>
__device__ __forceinline__ void out_product(float (&acc)[Bwd<T, HD>::kDo / 8][4],
                                            const float (&x)[Bwd<T, HD>::kNC / 8][4],
                                            const T* nb, int lane) {
  using C = Bwd<T, HD>;
  constexpr int kS = C::kStride, kNT = C::kNC / 8, kDT = C::kDo / 8;
  const int g = lane / 4, tig = lane % 4;
  if constexpr (C::kF32) {
    constexpr int kG = C::kOutGroup;
#pragma unroll
    for (int n0 = 0; n0 < kDT; n0 += kG) {
      float fr[kG][4];
#pragma unroll
      for (int i = 0; i < kG; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) fr[i][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        // A column tig is streamed row 2 tig, column tig + 4 is row 2 tig + 1.
        const unsigned pa[4] = {__float_as_uint(x[j][0]), __float_as_uint(x[j][2]),
                                __float_as_uint(x[j][1]), __float_as_uint(x[j][3])};
        unsigned ah[4], al[4];
        split_bits(pa, ah, al);
        const float* b0 = nb + (8 * j + 2 * tig) * kS + 8 * n0 + g;
        unsigned bh[kG][2], bl[kG][2];
#pragma unroll
        for (int i = 0; i < kG; ++i) {
          split(b0[8 * i], bh[i][0], bl[i][0]);
          split(b0[kS + 8 * i], bh[i][1], bl[i][1]);
        }
#pragma unroll
        for (int i = 0; i < kG; ++i) mma_tf32(fr[i], al, bh[i][0], bh[i][1]);
#pragma unroll
        for (int i = 0; i < kG; ++i) mma_tf32(fr[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
        for (int i = 0; i < kG; ++i) mma_tf32(fr[i], ah, bh[i][0], bh[i][1]);
      }
#pragma unroll
      for (int i = 0; i < kG; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + i][e] += fr[i][e];
    }
  } else {
    const int v_row = (lane % 8) + 8 * ((lane / 8) % 2);
    const int v_col = 8 * (lane / 16);
#pragma unroll
    for (int c = 0; c < kNT / 2; ++c) {
      const unsigned a[4] = {pack_bf16(x[2 * c][0], x[2 * c][1]),
                             pack_bf16(x[2 * c][2], x[2 * c][3]),
                             pack_bf16(x[2 * c + 1][0], x[2 * c + 1][1]),
                             pack_bf16(x[2 * c + 1][2], x[2 * c + 1][3])};
#pragma unroll
      for (int p = 0; p < kDT / 2; ++p) {
        unsigned bb[4];
        ldsm_x4_trans(bb, nb + (16 * c + v_row) * kS + 16 * p + v_col);
        mma_bf16(acc[2 * p], a, bb[0], bb[1]);
        mma_bf16(acc[2 * p + 1], a, bb[2], bb[3]);
      }
    }
  }
}

// One block's work.  kKV: the dK/dV role (fixed K, V; streamed Q, dO) for
// k tile ``tile`` of kv head ``head``; otherwise the dQ role (fixed Q, dO;
// streamed K, V) for q tile ``tile`` of query head ``head``; output column
// group ``grp``.
template <typename T, int HD, bool kKV>
__device__ __forceinline__ void bwd_block(const BwdArgs& a, int head, int b, int tile, int grp,
                                          unsigned char* smem_raw) {
  using C = Bwd<T, HD>;
  constexpr int kBn = C::kBn, kS = C::kStride, kNC = C::kNC, kDo = C::kDo;
  constexpr int kNT = kNC / 8, kDT = kDo / 8;
  T* f1 = reinterpret_cast<T*>(smem_raw);  // [kBm][kS]  K or Q
  T* f2 = f1 + kBm * kS;                   // [kBm][kS]  V or dO
  T* n1 = f2 + kBm * kS;                   // [2][kBn][kS]  Q or K
  T* n2 = n1 + 2 * kBn * kS;               // [2][kBn][kS]  dO or V
  float* n_lse = reinterpret_cast<float*>(n2 + 2 * kBn * kS);  // [2][kBn] (dK/dV)
  float* n_d = n_lse + 2 * kBn;                                // [2][kBn] (dK/dV)

  const int s = a.s, t = a.t, nh = a.nh, nkv = a.nkv, mask = a.mask;
  const int window = mask == kWindow ? a.window : 0;
  const int group = nh / nkv;
  const int m0 = tile * kBm, col0 = grp * kDo;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wr = m0 + 16 * warp;  // this warp's first fixed row
  const float scale_l2 = a.scale * kLog2e, softcap_l2 = a.softcap * kLog2e;
  const float softcap = a.softcap, scale = a.scale;

  const long long q_rs = (long long)nh * HD, kv_rs = (long long)nkv * HD;
  const int m_limit = kKV ? t : s, n_limit = kKV ? s : t;
  const long long m_rs = kKV ? kv_rs : q_rs;
  const T* qp = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const T* dp = static_cast<const T*>(a.dout);
  const int kvh = kKV ? head : head / group;
  const long long kv_off = ((long long)b * t * nkv + kvh) * HD;
  // dQ: the head's rows; dK/dV: the group's first query head (hh adds to it)
  const long long q_off0 = ((long long)b * s * nh + (kKV ? kvh * group : head)) * HD;
  const long long row_off0 = (long long)b * nh * s + (long long)(kKV ? kvh * group : head) * s;

  // Streamed rows this fixed tile sees.  Query row qi sees key kj when
  // kj <= qi (causal) and qi - kj < window (window).
  int n_lo = 0, n_hi = n_limit;
  if (kKV) {
    if (mask != kFull) n_lo = m0;
    if (window > 0) n_hi = min(s, m0 + kBm - 1 + window);
  } else {
    if (mask != kFull) n_hi = min(t, m0 + kBm);
    if (window > 0) n_lo = max(0, m0 - window + 1);
  }
  const int first = n_lo / kBn;
  const int n_tiles = n_hi > first * kBn ? (n_hi - first * kBn + kBn - 1) / kBn : 0;
  const int n_iter = (kKV ? group : 1) * n_tiles;

  auto load_streamed = [&](int it, int buf) {
    const int hh = kKV ? it / n_tiles : 0;
    const int r0 = (first + (kKV ? it % n_tiles : it)) * kBn;
    T* d1 = n1 + buf * kBn * kS;
    T* d2 = n2 + buf * kBn * kS;
    if (kKV) {
      const long long off = q_off0 + (long long)hh * HD;
      load_rows<T, HD, kThreads>(d1, qp + off, r0, kBn, s, q_rs, tid);
      load_rows<T, HD, kThreads>(d2, dp + off, r0, kBn, s, q_rs, tid);
      const long long roff = row_off0 + (long long)hh * s;
      for (int i = tid; i < kBn; i += kThreads) {
        const bool ok = r0 + i < s;
        cp_async4(n_lse + buf * kBn + i, ok ? a.lse + roff + r0 + i : a.lse, ok);
        cp_async4(n_d + buf * kBn + i, ok ? a.delta + roff + r0 + i : a.delta, ok);
      }
    } else {
      load_rows<T, HD, kThreads>(d1, kp + kv_off, r0, kBn, t, kv_rs, tid);
      load_rows<T, HD, kThreads>(d2, vp + kv_off, r0, kBn, t, kv_rs, tid);
    }
  };

  load_rows<T, HD, kThreads>(f1, (kKV ? kp + kv_off : qp + q_off0), m0, kBm, m_limit, m_rs, tid);
  load_rows<T, HD, kThreads>(f2, (kKV ? vp + kv_off : dp + q_off0), m0, kBm, m_limit, m_rs, tid);
  if (n_iter > 0) load_streamed(0, 0);
  cp_async_commit();

  // dQ: lse and D of this lane's two rows.
  float row_lse[2] = {0.0f, 0.0f}, row_d[2] = {0.0f, 0.0f};
  if (!kKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = wr + g + 8 * r;
      if (qi < s) {
        row_lse[r] = a.lse[row_off0 + qi];
        row_d[r] = a.delta[row_off0 + qi];
      }
    }
  }

  float o1[kDT][4];               // dK or dQ
  float o2[kKV ? kDT : 1][4];     // dV
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o1[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < (kKV ? kDT : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o2[n][e] = 0.0f;

  const T* f1w = f1 + 16 * warp * kS;
  const T* f2w = f2 + 16 * warp * kS;

  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_iter) load_streamed(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile it (and the fixed tiles) have landed
    __syncthreads();
    const int r0 = (first + (kKV ? it % n_tiles : it)) * kBn;
    const T* t1 = n1 + buf * kBn * kS;
    const T* t2 = n2 + buf * kBn * kS;
    const float* sl = n_lse + buf * kBn;
    const float* sd = n_d + buf * kBn;

#pragma unroll 1
    for (int c = 0; c < kBn / kNC; ++c) {
      // This pass's index ranges: fixed rows wr .. wr + 15, streamed rows
      // c0 .. c0 + kNC - 1.
      const int c0 = r0 + c * kNC;
      const int q_min = kKV ? c0 : wr, q_max = kKV ? c0 + kNC - 1 : wr + 15;
      const int k_min = kKV ? wr : c0, k_max = kKV ? wr + 15 : c0 + kNC - 1;
      const bool dead = q_min >= s || k_min >= t || (mask != kFull && k_min > q_max) ||
                        (window > 0 && q_min - k_max >= window);
      if (dead) continue;  // every element masked: P = dS = 0
      const bool edge = q_max >= s || k_max >= t || (mask != kFull && k_max > q_min) ||
                        (window > 0 && q_max - k_min >= window);

      float x1[kNT][4], x2[kNT][4];
      scores_dp<T, HD>(f1w, f2w, t1 + c * kNC * kS, t2 + c * kNC * kS, lane, x1, x2);

      // x1 becomes P = 2^(x - lse), x2 dS = P (dP - D) dcap scale, with x
      // computed as the forward computes it.  Masked cells and cells past
      // s or t are exactly 0.
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        float2 nl = make_float2(0.0f, 0.0f), nd = make_float2(0.0f, 0.0f);
        if (kKV) {
          nl = *reinterpret_cast<const float2*>(sl + c * kNC + 8 * j + 2 * tig);
          nd = *reinterpret_cast<const float2*>(sd + c * kNC + 8 * j + 2 * tig);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse = kKV ? ((e & 1) ? nl.y : nl.x) : row_lse[e >> 1];
          const float dd = kKV ? ((e & 1) ? nd.y : nd.x) : row_d[e >> 1];
          float x, dcap = scale;
          if (softcap > 0.0f) {
            const float th = tanhf(x1[j][e] * scale / softcap);
            x = softcap_l2 * th;
            dcap = (1.0f - th * th) * scale;
          } else {
            x = x1[j][e] * scale_l2;
          }
          bool ok = true;
          if (edge) {
            const int fr = wr + g + 8 * (e >> 1);
            const int sr = c0 + 8 * j + 2 * tig + (e & 1);
            const int qi = kKV ? sr : fr, kj = kKV ? fr : sr;
            ok = qi < s && kj < t;
            if (mask != kFull) ok = ok && kj <= qi;
            if (window > 0) ok = ok && qi - kj < window;
          }
          const float p = ok ? exp2_approx(x - lse) : 0.0f;
          x1[j][e] = p;
          x2[j][e] = p * (x2[j][e] - dd) * dcap;
        }
      }

      // dK += dS^T Q and dV += P^T dO, or dQ += dS K.
      out_product<T, HD>(o1, x2, t1 + c * kNC * kS + col0, lane);
      if constexpr (kKV) out_product<T, HD>(o2, x1, t2 + c * kNC * kS + col0, lane);
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  // Write this warp's rows (dK and dV: k rows below t; dQ: q rows below s).
  T* out1 = static_cast<T*>(kKV ? a.dk : a.dq);
  T* out2 = static_cast<T*>(a.dv);
  const long long out_off = kKV ? kv_off : q_off0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g + 8 * r;
    if (row >= m_limit) continue;
    const long long base = out_off + (long long)row * m_rs + col0 + 2 * tig;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      if constexpr (C::kF32) {
        *reinterpret_cast<float2*>(out1 + base + 8 * n) = make_float2(o1[n][2 * r], o1[n][2 * r + 1]);
        if constexpr (kKV)
          *reinterpret_cast<float2*>(out2 + base + 8 * n) = make_float2(o2[n][2 * r], o2[n][2 * r + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out1 + base + 8 * n) =
            __floats2bfloat162_rn(o1[n][2 * r], o1[n][2 * r + 1]);
        if constexpr (kKV)
          *reinterpret_cast<__nv_bfloat162*>(out2 + base + 8 * n) =
              __floats2bfloat162_rn(o2[n][2 * r], o2[n][2 * r + 1]);
      }
    }
  }
}

// Both roles in one grid, so each fills the other's tail.  Blocks go in
// pairs of slabs, heaviest first under a causal mask: the dK/dV blocks of k
// tile i (all kv heads, batches and column groups), then the dQ blocks of
// the i-th q tile from the end; past the shorter side, the rest of the
// longer.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int G = Bwd<T, HD>::kGroups;
  const int tk = (a.t + kBm - 1) / kBm, tq = (a.s + kBm - 1) / kBm;
  const long long kv_slab = (long long)a.nkv * a.b * G, q_slab = (long long)a.nh * a.b * G;
  const long long pairs = min(tk, tq);
  long long r = blockIdx.x;
  bool kv;
  int ti;
  if (r < pairs * (kv_slab + q_slab)) {
    ti = static_cast<int>(r / (kv_slab + q_slab));
    r %= kv_slab + q_slab;
    kv = r < kv_slab;
    if (!kv) r -= kv_slab;
  } else {
    r -= pairs * (kv_slab + q_slab);
    kv = tk > tq;
    const long long slab = kv ? kv_slab : q_slab;
    ti = static_cast<int>(pairs + r / slab);
    r %= slab;
  }
  const int heads = kv ? a.nkv : a.nh;
  const int grp = static_cast<int>(r % G);
  r /= G;
  const int head = static_cast<int>(r % heads), b = static_cast<int>(r / heads);
  if (kv) {
    bwd_block<T, HD, true>(a, head, b, ti, grp, smem_raw);
  } else {
    bwd_block<T, HD, false>(a, head, b, tq - 1 - ti, grp, smem_raw);
  }
}

template <typename T, int HD>
int launch_hd(const BwdArgs& args, const void* o, float* delta, cudaStream_t st) {
  using C = Bwd<T, HD>;
  const long long rows = (long long)args.b * args.s * args.nh;
  if (rows > 0) {
    constexpr int kRows = 256 / (HD / (16 / sizeof(T)) < 32 ? HD / (16 / sizeof(T)) : 32);
    flash_bwd_delta_kernel<T, HD><<<(unsigned)((rows + kRows - 1) / kRows), 256, 0, st>>>(
        static_cast<const T*>(o), static_cast<const T*>(args.dout), delta, rows, args.s,
        args.nh);
  }
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = ((long long)(args.t + kBm - 1) / kBm * args.nkv +
                            (long long)(args.s + kBm - 1) / kBm * args.nh) * args.b * C::kGroups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0)
    flash_bwd_kernel<T, HD><<<(unsigned)blocks, kThreads, C::kBytes, st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const BwdArgs& args, const void* o, float* delta, int hd, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(args, o, delta, st);
    case 32: return launch_hd<T, 32>(args, o, delta, st);
    case 64: return launch_hd<T, 64>(args, o, delta, st);
    case 128: return launch_hd<T, 128>(args, o, delta, st);
    case 256: return launch_hd<T, 256>(args, o, delta, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, do, dq: (b, s, nh, hd); k, v, dk, dv: (b, t, nkv, hd), all of one
// type (dtype 0 = float32, 1 = bfloat16); lse: the forward's (b, nh, s)
// base-2 log-sum-exp, float32; delta: (b, nh, s) float32 scratch for D.
// All contiguous and 16-byte aligned.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* delta, int b, int s, int t, int nh,
    int nkv, int hd, int mask, int window, float softcap, float scale, int dtype, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  if (nkv == 0 || nh % nkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  const BwdArgs args{q, k, v, dout, static_cast<const float*>(lse), dl, dq, dk, dv,
                     b, s, t, nh, nkv, mask, window, softcap, scale};
  if (dtype == 0) return launch_bwd<float>(args, o, dl, hd, st);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(args, o, dl, hd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
