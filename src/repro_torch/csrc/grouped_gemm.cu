// Grouped GEMM of the routed MoE experts on Hopper (sm_90a), bfloat16 and
// float32: K5.
//
// Replaces no TPU kernel.  The JAX package computes its MoE with XLA's
// einsums over a dense (E, b, s, d) dispatch (src/repro/models/moe.py,
// apply_moe): every token row goes through every expert, and the rows of
// the experts a token is not routed to are zero.  The port sorts the b s k
// routed (token, expert) rows by expert instead (models/moe.py, _dispatch)
// and this kernel runs each expert's MLP on its own contiguous range of
// the sorted rows only: the same products, less the multiplications by
// zero rows (granite's top-8 of 32 experts: a quarter of the dense work).
//
// One kernel, five operand layouts, a GEMM over groups of rows whose
// bounds (offsets, int64, groups + 1, on the device) are read by the
// kernel itself, never by the host:
//   kind        A (m, k)              B (k, n) of group e            C and epilogue
//   fwd_glu     x rows (ragged M)     [wg_e | wi_e], K-major rows    h = act(x wg) * (x wi), and
//                                                                    optionally [g | u] for the backward
//   fwd         h rows (ragged M)     wo_e                           out rows
//   dgrad_glu   dout rows (ragged M)  wo_e^T (K contiguous)          [dg | du] from dh and [g | u]
//   dgrad       [dg | du] (ragged M)  [wg_e | wi_e]^T, K split at f  dx rows
//   wgrad       X^T: the ragged rows  dY rows                        dW_e = X_e^T dY_e, the
//               are the reduction                                    ragged dimension the sum
// Each output element is summed by one thread in a fixed order: no split K,
// no atomics, so every call is bit-reproducible (the remat rerun routes as
// the forward did only if the forward repeats itself exactly).  A group
// with no rows gives dW_e = 0.
//
// What bounds it on the card: operations.  At granite's widths (d 1,024,
// f 512) a layer's forward is 0.82 TFLOP over 262,144 routed rows against
// ~2 GB of rows and weights moved; at 989 TFLOP/s and 3.35 TB/s the
// products take ~0.8 ms, the bytes ~0.6 ms.
//
// The design (bfloat16): mma.sync m16n8k16 with float32 accumulators,
// fed by ldmatrix from a 3-stage cp.async ring of 128 x 64 (A) and 64 x
// 128 (B) tiles in shared memory; 8 warps of 64 x 32 outputs a block, two
// blocks an SM (128 registers a thread).  Each thread's chunks of a tile
// lie in one column and step down its rows by one stride, so the copies'
// addresses cost an add each.  mma.sync rather than wgmma: the five
// layouts need the transposed and untransposed fragments of both
// operands, which ldmatrix and ldmatrix.trans give from padded rows (16 B
// of padding a row: the 8 rows an ldmatrix reads fall on distinct banks)
// with no descriptors.  Tried on the H100 at granite's and phi3.5-moe's
// layers, all bit-identical: 4 warps of 64 x 64 were 2-5% slower at
// granite's, 128 x 256 tiles (one block an SM) 5-8%, 32-deep k tiles up
// to 9%; wgmma is the step beyond (PERF.md).
// The tiles are walked persistently: a grid of as many blocks as fit on
// the card walks tile indices t = blockIdx.x, + gridDim.x, ...  For ragged
// M the tile space is the static bound (ceil(rows / 128) + groups) x
// column tiles; each block derives every group's first row tile from the
// offsets into shared memory, finds a tile's group by binary search, and
// stops at the first index past the last group's last tile.  Column tiles
// run fastest, so the blocks in flight share their A rows and the
// expert's weights in L2.  fwd_glu's B tile holds 64 columns of wg and
// the same 64 of wi side by side, and each warp's fragments 0-1 (gate)
// and 2-3 (up) cover the same columns, so the SwiGLU product is formed in
// registers: g and u are rounded to the type first, as the plain version
// rounds its two products.
// float32 (reduced models, held to the CPU at 1e-4 and better): the same
// tile walk and epilogues over a plain 64 x 64 x 16 CUDA-core tile, IEEE
// fmaf, no tensor cores.
//
// Shapes: the widths (d, f) must be multiples of 8 (16-byte rows), groups
// at most kMaxGroups; the wrapper (kernels/grouped_gemm.py) checks them.
// The entry returns cudaGetLastError() after its launch; the Python
// wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using flash::cp_async16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::ldsm_x4;
using flash::ldsm_x4_trans;
using flash::mma_bf16;
using bf16 = __nv_bfloat16;

enum Kind { kFwdGlu = 0, kFwd = 1, kDgradGlu = 2, kDgrad = 3, kWgrad = 4 };
constexpr int kMaxGroups = 256, kMaxDevices = 64;

struct Args {
  const void* a;
  long long lda;
  const void* b0;
  const void* b1;  // fwd_glu: wi beside wg; dgrad: the K rows past b_ksplit
  long long ldb, b_stride;  // b_stride: elements from one group's B to the next
  long long b_ksplit;
  void* c;
  long long ldc, c_stride;  // c_stride: wgrad's elements from one dW_e to the next
  void* aux;  // fwd_glu: [g | u] out (or null); dgrad_glu: [g | u] in
  long long ld_aux;
  const long long* offsets;
  int groups;
  int M, N, K;  // ragged M: M the rows of the buffer (the tile bound); wgrad: M, N of each dW_e
};

template <int KIND>
struct Traits {
  static constexpr bool kACol = KIND == kWgrad;                       // A stored k-major (X^T)
  static constexpr bool kBCol = KIND == kDgradGlu || KIND == kDgrad;  // B stored n-major (W^T)
  static constexpr bool kRaggedK = KIND == kWgrad;
  static constexpr bool kGlu = KIND == kFwdGlu;
};

// Logical output columns a tile covers: fwd_glu's tile holds the gate's and
// the up projection's halves of its columns.
template <int KIND, int TBN>
constexpr int col_span() {
  return Traits<KIND>::kGlu ? TBN / 2 : TBN;
}

template <int KIND, int TBM, int TBN>
long long tile_bound(const Args& p, int n_tiles) {
  const long long m_tiles = (p.M + TBM - 1) / TBM;
  if (Traits<KIND>::kRaggedK) return (long long)p.groups * m_tiles * n_tiles;
  return (m_tiles + p.groups) * n_tiles;
}

struct Tile {
  int e, nt;
  long long m0, m_hi, k_lo, k_hi;
};

// s_start[e]: group e's first row tile; s_start[groups]: the row tiles in all.
template <int TBM>
__device__ void row_tile_starts(const Args& p, int* s_start) {
  for (int e = threadIdx.x; e < p.groups; e += blockDim.x) {
    const long long rows = p.offsets[e + 1] - p.offsets[e];
    s_start[e + 1] = (int)((rows + TBM - 1) / TBM);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s_start[0] = 0;
    for (int e = 0; e < p.groups; ++e) s_start[e + 1] += s_start[e];
  }
  __syncthreads();
}

// Tile index t's group, rows, column tile and K range; false past the last tile.
template <int KIND, int TBM>
__device__ __forceinline__ bool find_tile(const Args& p, const int* s_start, long long t,
                                          int n_tiles, Tile& tl) {
  if constexpr (Traits<KIND>::kRaggedK) {
    const long long m_tiles = (p.M + TBM - 1) / TBM, per = m_tiles * n_tiles;
    tl.e = (int)(t / per);
    if (tl.e >= p.groups) return false;
    const long long r = t - tl.e * per;
    tl.m0 = (r / n_tiles) * TBM;
    tl.nt = (int)(r % n_tiles);
    tl.m_hi = p.M;
    tl.k_lo = p.offsets[tl.e];
    tl.k_hi = p.offsets[tl.e + 1];
  } else {
    const int mt = (int)(t / n_tiles);
    if (mt >= s_start[p.groups]) return false;
    tl.nt = (int)(t % n_tiles);
    // the last group whose first row tile is at or before mt: a group with
    // no rows shares its start with the next, so the search never stops on one
    int lo = 0, hi = p.groups - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (s_start[mid] <= mt) lo = mid; else hi = mid - 1;
    }
    tl.e = lo;
    tl.m0 = p.offsets[lo] + (long long)(mt - s_start[lo]) * TBM;
    tl.m_hi = p.offsets[lo + 1];
    tl.k_lo = 0;
    tl.k_hi = p.K;
  }
  return true;
}

template <typename T>
__device__ __forceinline__ const T* a_addr(const Args& p, bool a_col, long long m, long long k) {
  const T* a = static_cast<const T*>(p.a);
  return a_col ? a + k * p.lda + m : a + m * p.lda + k;
}

// B(k, physical column pc of tile nt) of group e; ok: inside B.  A chunk of
// 8 columns or 8 k never straddles fwd_glu's halves (64 wide) or dgrad's
// K split (a multiple of 8).
template <int KIND, int TBN, typename T>
__device__ __forceinline__ const T* b_addr(const Args& p, const Tile& tl, long long k, int pc,
                                           bool& ok) {
  const T* b0 = static_cast<const T*>(p.b0) + tl.e * p.b_stride;
  const T* b1 = static_cast<const T*>(p.b1) + tl.e * p.b_stride;
  ok = k < tl.k_hi;
  if constexpr (Traits<KIND>::kBCol) {
    const long long n = (long long)tl.nt * TBN + pc;
    ok = ok && n < p.N;
    return k < p.b_ksplit ? b0 + n * p.ldb + k : b1 + n * p.ldb + (k - p.b_ksplit);
  } else if constexpr (Traits<KIND>::kGlu) {
    const int up = pc >= TBN / 2;
    const long long n = (long long)tl.nt * (TBN / 2) + pc - up * (TBN / 2);
    ok = ok && n < p.N;
    return (up ? b1 : b0) + k * p.ldb + n;
  } else {
    const long long n = (long long)tl.nt * TBN + pc;
    ok = ok && n < p.N;
    return b0 + k * p.ldb + n;
  }
}

// ---------------------------------------------------------------------------
// Epilogues, on a pair of adjacent columns (n, n + 1)
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void put2(T* dst, float x0, float x1) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
  }
}

template <typename T>
__device__ __forceinline__ float2 get2(const T* src) {
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float2*>(src);
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, float>::value) return x;
  else return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float logistic(float x) { return 1.0f / (1.0f + expf(-x)); }

// v: the accumulators at (row, n), (row, n + 1); u: fwd_glu's up projection there.
template <int KIND, typename T>
__device__ __forceinline__ void epilogue(const Args& p, int e, long long row, long long n,
                                         float v0, float v1, float u0, float u1) {
  T* c = static_cast<T*>(p.c);
  if constexpr (KIND == kFwdGlu) {
    const float g0 = round_to<T>(v0), g1 = round_to<T>(v1);
    const float x0 = round_to<T>(u0), x1 = round_to<T>(u1);
    put2<T>(c + row * p.ldc + n, g0 * logistic(g0) * x0, g1 * logistic(g1) * x1);
    if (p.aux != nullptr) {
      T* gu = static_cast<T*>(p.aux) + row * p.ld_aux;
      put2<T>(gu + n, g0, g1);
      put2<T>(gu + p.N + n, x0, x1);
    }
  } else if constexpr (KIND == kDgradGlu) {
    const T* gu = static_cast<const T*>(p.aux) + row * p.ld_aux;
    const float2 g = get2<T>(gu + n), u = get2<T>(gu + p.N + n);
    const float s0 = logistic(g.x), s1 = logistic(g.y);
    // h = g s(g) u: dh/dg = u s (1 + g (1 - s)), dh/du = g s
    put2<T>(c + row * p.ldc + n, v0 * u.x * s0 * (1.0f + g.x * (1.0f - s0)),
            v1 * u.y * s1 * (1.0f + g.y * (1.0f - s1)));
    put2<T>(c + row * p.ldc + p.N + n, v0 * g.x * s0, v1 * g.y * s1);
  } else if constexpr (KIND == kWgrad) {
    put2<T>(c + e * p.c_stride + row * p.ldc + n, v0, v1);
  } else {
    put2<T>(c + row * p.ldc + n, v0, v1);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3, kPad = 8;
constexpr int kWarpsM = 2, kWarpsN = 4, kMinBlocks = 2;  // warps a block, blocks an SM
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWM = kBM / kWarpsM, kWN = kBN / kWarpsN;  // a warp's tile
constexpr int kMF = kWM / 16, kNF = kWN / 8;  // its m16 and n8 fragments
constexpr int kHalf = kNF / 2;  // fwd_glu: a warp's fragments of the gate (then of the up)
static_assert(kHalf % 2 == 0, "B fragments load in pairs within a half");

// Fragment j's first physical column in the tile: the gate's half, then
// the up projection's, each a warp's kWN / 2 columns (fwd_glu pairs j with
// j + kHalf; every other kind only permutes its columns).
__device__ __forceinline__ int frag_col(int wn, int j) {
  return (j / kHalf) * (kBN / 2) + wn * (kWN / 2) + (j % kHalf) * 8;
}

template <int KIND>
struct Smem {
  using Tr = Traits<KIND>;
  static constexpr int kAStride = Tr::kACol ? kBM + kPad : kBK + kPad;  // elements a row
  static constexpr int kARows = Tr::kACol ? kBK : kBM;
  static constexpr int kBStride = Tr::kBCol ? kBK + kPad : kBN + kPad;
  static constexpr int kBRows = Tr::kBCol ? kBN : kBK;
  static constexpr int kAElems = kARows * kAStride, kBElems = kBRows * kBStride;
  static constexpr int kStageElems = kAElems + kBElems;
  static constexpr size_t kBytes =
      sizeof(bf16) * kStageElems * kStages + sizeof(int) * (kMaxGroups + 1);
};

// One stage's A and B tiles, 16-byte chunks, global -> shared.  Thread tid
// copies chunk column tid % kC of rows tid / kC + q * (kThreads / kC): its
// column (and so fwd_glu's half, dgrad's side of the K split and the
// column bound) is fixed for the stage, and its rows step by one stride.
template <int KIND>
__device__ __forceinline__ void load_stage(const Args& p, const Tile& tl, long long k0, bf16* sa,
                                           bf16* sb, int tid) {
  using Tr = Traits<KIND>;
  using S = Smem<KIND>;
  const bf16* a = static_cast<const bf16*>(p.a);
  if constexpr (Tr::kACol) {  // rows k, chunks along m
    constexpr int kC = kBM / 8, kStep = kThreads / kC;
    static_assert(kThreads % kC == 0 && kBK % kStep == 0, "A tile");
    const int r0 = tid / kC, c = (tid % kC) * 8;
    const bool col_ok = tl.m0 + c < tl.m_hi;
    const bf16* src = a + (k0 + r0) * p.lda + tl.m0 + c;
#pragma unroll
    for (int q = 0; q < kBK / kStep; ++q) {
      const bool ok = col_ok && k0 + r0 + q * kStep < tl.k_hi;
      cp_async16(sa + (r0 + q * kStep) * S::kAStride + c, ok ? src + q * kStep * p.lda : a, ok);
    }
  } else {  // rows m, chunks along k
    constexpr int kC = kBK / 8, kStep = kThreads / kC;
    static_assert(kThreads % kC == 0 && kBM % kStep == 0, "A tile");
    const int r0 = tid / kC, c = (tid % kC) * 8;
    const bool col_ok = k0 + c < tl.k_hi;
    const bf16* src = a + (tl.m0 + r0) * p.lda + k0 + c;
#pragma unroll
    for (int q = 0; q < kBM / kStep; ++q) {
      const bool ok = col_ok && tl.m0 + r0 + q * kStep < tl.m_hi;
      cp_async16(sa + (r0 + q * kStep) * S::kAStride + c, ok ? src + q * kStep * p.lda : a, ok);
    }
  }
  const bf16* b0 = static_cast<const bf16*>(p.b0) + tl.e * p.b_stride;
  const bf16* b1 = static_cast<const bf16*>(p.b1) + tl.e * p.b_stride;
  if constexpr (Tr::kBCol) {  // rows n, chunks along k; k past b_ksplit from b1
    constexpr int kC = kBK / 8, kStep = kThreads / kC;
    static_assert(kThreads % kC == 0 && kBN % kStep == 0, "B tile");
    const int r0 = tid / kC, c = (tid % kC) * 8;
    const long long k = k0 + c, n0 = (long long)tl.nt * kBN + r0;
    const bool col_ok = k < tl.k_hi;
    const bf16* src = (k < p.b_ksplit ? b0 + k : b1 + (k - p.b_ksplit)) + n0 * p.ldb;
#pragma unroll
    for (int q = 0; q < kBN / kStep; ++q) {
      const bool ok = col_ok && n0 + q * kStep < p.N;
      cp_async16(sb + (r0 + q * kStep) * S::kBStride + c, ok ? src + q * kStep * p.ldb : b0, ok);
    }
  } else {  // rows k, chunks along n; fwd_glu's second half from b1
    constexpr int kC = kBN / 8, kStep = kThreads / kC;
    static_assert(kThreads % kC == 0 && kBK % kStep == 0, "B tile");
    const int r0 = tid / kC, c = (tid % kC) * 8;
    long long n = (long long)tl.nt * kBN + c;
    const bf16* base = b0;
    if constexpr (Tr::kGlu) {
      const int up = c >= kBN / 2;
      n = (long long)tl.nt * (kBN / 2) + c - up * (kBN / 2);
      base = up ? b1 : b0;
    }
    const bool col_ok = n < p.N;
    const bf16* src = base + (k0 + r0) * p.ldb + n;
#pragma unroll
    for (int q = 0; q < kBK / kStep; ++q) {
      const bool ok = col_ok && k0 + r0 + q * kStep < tl.k_hi;
      cp_async16(sb + (r0 + q * kStep) * S::kBStride + c, ok ? src + q * kStep * p.ldb : b0, ok);
    }
  }
}

// Warp (wm, wn) computes rows wm * kWM + [0, kWM) of the tile and, as
// fragment j (8 columns), physical columns frag_col(wn, j) + [0, 8).
template <int KIND>
__device__ __forceinline__ void compute_stage(const bf16* sa, const bf16* sb,
                                              float (&acc)[kMF][kNF][4], int wm, int wn,
                                              int lane) {
  using Tr = Traits<KIND>;
  using S = Smem<KIND>;
  const int mat = lane / 8, r8 = lane % 8;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 16) {
    unsigned af[kMF][4], bfr[kNF][2];
#pragma unroll
    for (int mi = 0; mi < kMF; ++mi) {
      const int m = wm * kWM + mi * 16;
      if constexpr (Tr::kACol) {
        ldsm_x4_trans(af[mi], sa + (ks + r8 + (mat / 2) * 8) * S::kAStride + m + (mat % 2) * 8);
      } else {
        ldsm_x4(af[mi], sa + (m + lane % 16) * S::kAStride + ks + (lane / 16) * 8);
      }
    }
#pragma unroll
    for (int jp = 0; jp < kNF / 2; ++jp) {
      const int n = frag_col(wn, 2 * jp);
      unsigned r4[4];
      if constexpr (Tr::kBCol) {
        ldsm_x4(r4, sb + (n + r8 + (mat / 2) * 8) * S::kBStride + ks + (mat % 2) * 8);
      } else {
        ldsm_x4_trans(r4, sb + (ks + r8 + (mat % 2) * 8) * S::kBStride + n + (mat / 2) * 8);
      }
      bfr[2 * jp][0] = r4[0];
      bfr[2 * jp][1] = r4[1];
      bfr[2 * jp + 1][0] = r4[2];
      bfr[2 * jp + 1][1] = r4[3];
    }
#pragma unroll
    for (int mi = 0; mi < kMF; ++mi)
#pragma unroll
      for (int j = 0; j < kNF; ++j) mma_bf16(acc[mi][j], af[mi], bfr[j][0], bfr[j][1]);
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    grouped_gemm_tc(const Args p, long long bound, int n_tiles) {
  using S = Smem<KIND>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  int* s_start = reinterpret_cast<int*>(smem + sizeof(bf16) * S::kStageElems * kStages);
  if constexpr (!Traits<KIND>::kRaggedK) row_tile_starts<kBM>(p, s_start);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN, g = lane / 4, t4 = lane % 4;
  for (long long t = blockIdx.x; t < bound; t += gridDim.x) {
    Tile tl;
    if (!find_tile<KIND, kBM>(p, s_start, t, n_tiles, tl)) break;
    float acc[kMF][kNF][4];
#pragma unroll
    for (int mi = 0; mi < kMF; ++mi)
#pragma unroll
      for (int j = 0; j < kNF; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.0f;
    const int nk = (int)((tl.k_hi - tl.k_lo + kBK - 1) / kBK);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) {
        bf16* st = stages + s * S::kStageElems;
        load_stage<KIND>(p, tl, tl.k_lo + (long long)s * kBK, st, st + S::kAElems, tid);
      }
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
      const int nxt = kt + kStages - 1;
      if (nxt < nk) {
        bf16* st = stages + (nxt % kStages) * S::kStageElems;
        load_stage<KIND>(p, tl, tl.k_lo + (long long)nxt * kBK, st, st + S::kAElems, tid);
      }
      cp_async_commit();
      const bf16* st = stages + (kt % kStages) * S::kStageElems;
      compute_stage<KIND>(st, st + S::kAElems, acc, wm, wn, lane);
    }
    cp_async_wait<0>();
    __syncthreads();  // the next tile's loads may overwrite every stage
#pragma unroll
    for (int mi = 0; mi < kMF; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = tl.m0 + wm * kWM + mi * 16 + g + h * 8;
        if (row >= tl.m_hi) continue;
        if constexpr (Traits<KIND>::kGlu) {
#pragma unroll
          for (int j = 0; j < kHalf; ++j) {
            const long long n = (long long)tl.nt * (kBN / 2) + frag_col(wn, j) + 2 * t4;
            if (n < p.N)
              epilogue<KIND, bf16>(p, tl.e, row, n, acc[mi][j][2 * h], acc[mi][j][2 * h + 1],
                                   acc[mi][j + kHalf][2 * h], acc[mi][j + kHalf][2 * h + 1]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < kNF; ++j) {
            const long long n = (long long)tl.nt * kBN + frag_col(wn, j) + 2 * t4;
            if (n < p.N)
              epilogue<KIND, bf16>(p, tl.e, row, n, acc[mi][j][2 * h], acc[mi][j][2 * h + 1],
                                   0.0f, 0.0f);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSBM = 64, kSBN = 64, kSBK = 16, kSThreads = 256;

// Thread (ty, tx) computes rows ty * 4 + [0, 4) and physical columns
// (j / 2) * 32 + tx * 2 + j % 2, j < 4: fwd_glu's gate and up halves pair up.
template <int KIND>
__global__ void __launch_bounds__(kSThreads)
    grouped_gemm_f32(const Args p, long long bound, int n_tiles) {
  using Tr = Traits<KIND>;
  __shared__ float sa[kSBK][kSBM];
  __shared__ float sb[kSBK][kSBN];
  __shared__ int s_start[kMaxGroups + 1];
  if constexpr (!Tr::kRaggedK) row_tile_starts<kSBM>(p, s_start);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (long long t = blockIdx.x; t < bound; t += gridDim.x) {
    Tile tl;
    if (!find_tile<KIND, kSBM>(p, s_start, t, n_tiles, tl)) break;
    float acc[4][4] = {};
    for (long long k0 = tl.k_lo; k0 < tl.k_hi; k0 += kSBK) {
      for (int i = tid; i < kSBK * kSBM; i += kSThreads) {
        // neighbouring threads on the stored contiguous dim
        const int kk = Tr::kACol ? i / kSBM : i % kSBK, mm = Tr::kACol ? i % kSBM : i / kSBK;
        const long long m = tl.m0 + mm, k = k0 + kk;
        sa[kk][mm] = m < tl.m_hi && k < tl.k_hi ? *a_addr<float>(p, Tr::kACol, m, k) : 0.0f;
      }
      for (int i = tid; i < kSBK * kSBN; i += kSThreads) {
        const int kk = Tr::kBCol ? i % kSBK : i / kSBN, nn = Tr::kBCol ? i / kSBK : i % kSBN;
        bool ok;
        const float* src = b_addr<KIND, kSBN, float>(p, tl, k0 + kk, nn, ok);
        sb[kk][nn] = ok ? *src : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSBK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sa[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sb[kk][(j / 2) * (kSBN / 2) + tx * 2 + j % 2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = tl.m0 + ty * 4 + i;
      if (row >= tl.m_hi) continue;
      if constexpr (Tr::kGlu) {
        const long long n = (long long)tl.nt * (kSBN / 2) + tx * 2;
        if (n < p.N)
          epilogue<KIND, float>(p, tl.e, row, n, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const long long n = (long long)tl.nt * kSBN + jp * (kSBN / 2) + tx * 2;
          if (n < p.N)
            epilogue<KIND, float>(p, tl.e, row, n, acc[i][2 * jp], acc[i][2 * jp + 1], 0.0f,
                                  0.0f);
        }
      }
    }
  }
}

template <int KIND, bool kF32>
int launch(const Args& p, int device, cudaStream_t stream) {
  constexpr int TBM = kF32 ? kSBM : kBM, TBN = kF32 ? kSBN : kBN;
  constexpr int span = col_span<KIND, TBN>();
  const int n_tiles = (p.N + span - 1) / span;
  const long long bound = tile_bound<KIND, TBM, TBN>(p, n_tiles);
  if (bound == 0) return 0;
  auto kernel = kF32 ? grouped_gemm_f32<KIND> : grouped_gemm_tc<KIND>;
  const size_t bytes = kF32 ? 0 : Smem<KIND>::kBytes;
  const int threads = kF32 ? kSThreads : kThreads;
  // blocks the card holds at once, found on this device's first launch
  static int resident[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[device] == 0) {
    cudaError_t err;
    if (!kF32) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = (int)(bound < resident[device] ? bound : resident[device]);
  kernel<<<grid, threads, bytes, stream>>>(p, bound, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <bool kF32>
int launch_kind(int kind, const Args& p, int device, cudaStream_t st) {
  switch (kind) {
    case kFwdGlu: return launch<kFwdGlu, kF32>(p, device, st);
    case kFwd: return launch<kFwd, kF32>(p, device, st);
    case kDgradGlu: return launch<kDgradGlu, kF32>(p, device, st);
    case kDgrad: return launch<kDgrad, kF32>(p, device, st);
    case kWgrad: return launch<kWgrad, kF32>(p, device, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kind: 0 fwd_glu, 1 fwd, 2 dgrad_glu, 3 dgrad, 4 wgrad (the table above);
// dtype: 0 float32, 1 bfloat16, for every operand.  offsets: int64,
// groups + 1 absolute row positions (ragged M: of A's and C's rows; wgrad:
// of A's and B's K rows).
extern "C" int repro_grouped_gemm(int kind, int dtype, const void* a, long long lda,
                                  const void* b0, const void* b1, long long ldb,
                                  long long b_stride, long long b_ksplit, void* c, long long ldc,
                                  long long c_stride, void* aux, long long ld_aux,
                                  const void* offsets, int groups, int M, int N, int K,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (groups < 1 || groups > kMaxGroups || N % 8 || (kind != kWgrad && K % 8) ||
      (kind == kWgrad && M % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{a, lda, b0, b1, ldb, b_stride, b_ksplit, c, ldc, c_stride, aux, ld_aux,
               static_cast<const long long*>(offsets), groups, M, N, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_kind<true>(kind, p, device, st);
  if (dtype == 1) return launch_kind<false>(kind, p, device, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
