// Grouped (ragged) expert matmuls for the dropless dispatch mode, forward
// and backward:
//   forward  y[seg_e]    = lhs[seg_e] @ rhs[e]       (transpose_rhs=False)
//   dlhs     dlhs[seg_e] = g[seg_e] @ rhs[e]^T       (transpose_rhs=True)
//   drhs     drhs[e]     = lhs[seg_e]^T @ g[seg_e]   (f32, (E, K, N))
// lhs (M, K), rhs (E, K, N), offsets (E+1,) int32 with seg_e =
// [offsets[e], offsets[e+1]); f32 accumulation, the forward and dlhs cast
// to lhs's dtype; rows at or past offsets[E] belong to no expert: they come
// out zero and add nothing to drhs.
//
// Replaces the TPU kernels repro/kernels/grouped_ffn.py:
// _grouped_matmul_kernel (pallas_call in _grouped_matmul_impl) in both its
// forms, and _grouped_drhs_kernel (pallas_call in _grouped_drhs_impl).
//
// Bounds on the H100 at the training/prefill shapes (M=4096, K=N=2048,
// E=16, bf16): the forward and dlhs move 160 MiB — the 128 MiB of expert
// weights dominate — against 34.4 GFLOP, so they are memory-bound near
// 50 us; at decode (M=8) the forward reads at most 8 experts' weights.
// drhs reads 32 MiB and writes the 256 MiB f32 gradient: 90 us.
//
// Forward and dlhs (redesigned for Hopper): a tile schedule over
// (segment, row tile, column tile).  The rows fall into segments, clamping
// c_x = offsets[x] into [0, M): a zero head [0, c_0), expert e's rows
// [c_e, c_{e+1}), and a zero tail [c_E, M) (offsets are non-decreasing, as
// the dispatch plan's cumulative counts are).  Each segment is cut into
// BM-row tiles from its first row, so at most ceil(M/BM) + E + 1 row tiles
// exist whatever the offsets; the grid is (column tiles, that many row
// tiles), fixed by M, N and E alone, so a launch reads nothing of the data
// on the host and replays in a CUDA graph.  Each block finds its own tile
// from offsets (find_tile: a block-wide prefix sum over the segments' tile
// counts), exits when its slot is past the last tile, writes zeros for a
// head or tail tile, and otherwise multiplies one expert's rows by that
// expert's weights: no expert is walked in turn and no row of another
// expert is loaded.  Mirrored by kernels/grouped_ffn.py:tile_schedule.
//
// The main loop: mma.sync m16n8k16 (bf16 in, f32 accumulators, rounded to
// bf16 once), fed by ldmatrix from a ring of STAGES shared-memory stages
// that cp.async fills 16 bytes a copy, STAGES - 1 k steps ahead; rows are
// padded by 16 bytes so ldmatrix hits no bank twice.  The tile follows M:
// 128x128x64 with 8 warps (64x32 each) and 3 stages for prefill and
// training; for M <= SMALL_M (decode) 16x64x64 with 4 warps (16x16 each)
// and 4 stages, so that a few rows still spread over N/64 column tiles of
// every active expert and the card
// streams the weights with hundreds of blocks.  dlhs reads B as rows of
// w[e] (contiguous along the contraction) and feeds ldmatrix without the
// transpose; the forward reads B rows along N through ldmatrix.trans.  No
// (E, N, K) copy is made.  Shapes whose rows are not whole 16-byte pieces
// (K or N not a multiple of 8, or unaligned bases) load element by element
// through the same stages.  The f32 variant keeps f32 FMAs (never TF32) on
// 64x64 tiles under the same schedule.
//
// drhs: the TPU kernel runs a sequential (E, M/block_m) grid with the
// expert's (K, N) gradient resident and accumulated across row blocks.
// CUDA blocks run in no order, so here a (N/64, K/64, E) grid gives each
// block one 64x64 tile of drhs[e], and the walk over the expert's rows
// becomes a loop inside the block: 32-row chunks of lhs (read transposed
// through a col_major matrix_a fragment) and g, rows past the segment's
// end loaded as 0, f32 accumulators; an empty segment writes zeros.  Every
// block reads its expert's rows of lhs and g once per tile, so lhs and g
// are read N/64 resp. K/64 times (from L2); the 256 MiB f32 store is the
// bound.  The reference's grouped_block_m is a TPU tiling knob; these
// kernels pick their own tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "sm90_mma.cuh"

using namespace nvcuda;

#define GMM_MAX_E 1024

namespace {

constexpr int SMALL_M = 256;   // M at or below which the decode tile is used

// segment s's rows [lo, hi): s = 0 the zero head, 1..E expert s - 1, E + 1
// the zero tail
__device__ __forceinline__ void seg_rows(const int* __restrict__ offsets,
                                         int E, int M, int s, int& lo,
                                         int& hi) {
  const auto c = [&](int x) { return min(max(offsets[x], 0), M); };
  lo = s == 0 ? 0 : c(s - 1);
  hi = max(lo, s <= E ? c(s) : M);
}

// This block's tile: row tile `slot` of the schedule.  Returns false when
// the slot is past the last tile; else e (-1 for a zero tile) and rows
// [row0, row1).  Every thread of the block calls it (it holds barriers);
// NT is blockDim.x.
template <int NT>
__device__ bool find_tile(const int* __restrict__ offsets, int E, int M,
                          int bm, int slot, int& e, int& row0, int& row1) {
  __shared__ int warp_sum[NT / 32];
  __shared__ int found[3];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nseg = E + 2, chunk = (nseg + NT - 1) / NT;
  const int s0 = min(nseg, tid * chunk), s1 = min(nseg, s0 + chunk);
  int mine = 0;
  for (int s = s0; s < s1; ++s) {
    int lo, hi;
    seg_rows(offsets, E, M, s, lo, hi);
    mine += (hi - lo + bm - 1) / bm;
  }
  int incl = mine;                               // inclusive scan in the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  if (tid == 0) found[0] = -2;
  __syncthreads();
  int start = incl - mine;
  for (int w = 0; w < warp; ++w) start += warp_sum[w];
  for (int s = s0; s < s1; ++s) {
    int lo, hi;
    seg_rows(offsets, E, M, s, lo, hi);
    const int n = (hi - lo + bm - 1) / bm;
    if (slot >= start && slot < start + n) {
      found[0] = s >= 1 && s <= E ? s - 1 : -1;
      found[1] = lo + (slot - start) * bm;
      found[2] = min(hi, found[1] + bm);
    }
    start += n;
  }
  __syncthreads();
  e = found[0];
  row0 = found[1];
  row1 = found[2];
  return e != -2;
}

// out rows [row0, row1) x columns [col0, col0 + bn) set to zero
template <typename T>
__device__ void zero_tile(T* __restrict__ out, T zero, int row0, int row1,
                          int col0, int bn, int Nout) {
  const int cols = min(bn, Nout - col0);
  for (int i = threadIdx.x; i < (row1 - row0) * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    out[(size_t)(row0 + r) * Nout + col0 + c] = zero;
  }
}

// out (M, Nout) = lhs (M, Kc) @ B_e on expert e's rows, where B_e is rhs[e]
// (Kc, Nout) row-major, or with TRANS rhs[e] (Nout, Kc) read transposed.
// BM x BN x BK tiles, WM x WN warps, STAGES cp.async stages.
template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool TRANS>
struct Gemm {
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int MT = BM / WM / 16;        // 16-row A fragments
  static constexpr int NT = BN / WN / 8;         // 8-column C fragments
  static constexpr int A_LD = BK + 8;
  static constexpr int B_LD = TRANS ? BK + 8 : BN + 8;
  static constexpr int A_ELEMS = BM * A_LD;
  static constexpr int B_ELEMS = TRANS ? BN * B_LD : BK * B_LD;
  static constexpr size_t SMEM =
      (size_t)STAGES * (A_ELEMS + B_ELEMS) * sizeof(__nv_bfloat16);
  static_assert(NT % 2 == 0, "B fragments are loaded two at a time");
};

// one 8-element piece of a tile: 16 bytes by cp.async when vec, else
// element by element (0 outside the rows or columns in range)
__device__ __forceinline__ void load_piece(__nv_bfloat16* dst,
                                           const __nv_bfloat16* __restrict__ src,
                                           bool row_in, int col, int ncols,
                                           bool vec) {
  if (vec) {
    const bool in = row_in && col < ncols;       // ncols % 8 == 0
    sm90::cp_async16(dst, in ? src + col : src, in);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[i] = row_in && col + i < ncols ? src[col + i]
                                         : __float2bfloat16(0.f);
  }
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool TRANS>
__global__ void __launch_bounds__(WM * WN * 32)
grouped_mm_bf16_kernel(const __nv_bfloat16* __restrict__ lhs,
                       const __nv_bfloat16* __restrict__ rhs,
                       const int* __restrict__ offsets,
                       __nv_bfloat16* __restrict__ out, int M, int Kc,
                       int Nout, int E, bool vec) {
  using G = Gemm<BM, BN, BK, WM, WN, STAGES, TRANS>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + STAGES * G::A_ELEMS;

  int e, row0, row1;
  if (!find_tile<G::THREADS>(offsets, E, M, BM, blockIdx.y, e, row0, row1))
    return;
  const int col0 = blockIdx.x * BN;
  if (e < 0) {
    zero_tile(out, __float2bfloat16(0.f), row0, row1, col0, BN, Nout);
    return;
  }
  const __nv_bfloat16* w = rhs + (size_t)e * Kc * Nout;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm0 = (warp / WN) * (BM / WM), wn0 = (warp % WN) * (BN / WN);
  const int nk = (Kc + BK - 1) / BK;

  // k step kt into stage st
  const auto load = [&](int kt, int st) {
    const int k0 = kt * BK;
    __nv_bfloat16* a = As + st * G::A_ELEMS;
    for (int c = tid; c < BM * BK / 8; c += G::THREADS) {
      const int r = c / (BK / 8), kk = (c % (BK / 8)) * 8;
      const bool in = row0 + r < row1;
      load_piece(a + r * G::A_LD + kk,
                 lhs + (size_t)(in ? row0 + r : 0) * Kc, in, k0 + kk, Kc,
                 vec);
    }
    __nv_bfloat16* b = Bs + st * G::B_ELEMS;
    if constexpr (TRANS) {       // BN rows of w[e] (Nout, Kc), BK columns
      for (int c = tid; c < BN * BK / 8; c += G::THREADS) {
        const int n = c / (BK / 8), kk = (c % (BK / 8)) * 8;
        const bool in = col0 + n < Nout;
        load_piece(b + n * G::B_LD + kk,
                   w + (size_t)(in ? col0 + n : 0) * Kc, in, k0 + kk, Kc,
                   vec);
      }
    } else {                     // BK rows of w[e] (Kc, Nout), BN columns
      for (int c = tid; c < BK * BN / 8; c += G::THREADS) {
        const int r = c / (BN / 8), nn = (c % (BN / 8)) * 8;
        const bool in = k0 + r < Kc;
        load_piece(b + r * G::B_LD + nn,
                   w + (size_t)(in ? k0 + r : 0) * Nout, in, col0 + nn, Nout,
                   vec);
      }
    }
  };

  float acc[G::MT][G::NT][4];
#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[i][j][x] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st);
    sm90::cp_async_commit();
  }
  // ldmatrix lane offsets: A-style (and trans B) and B-style tiles
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);
  for (int kt = 0; kt < nk; ++kt) {
    sm90::cp_async_wait<STAGES - 2>();           // k step kt has landed
    __syncthreads();                             // and stage kt-1 is free
    if (kt + STAGES - 1 < nk)
      load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    sm90::cp_async_commit();
    const __nv_bfloat16* a = As + (kt % STAGES) * G::A_ELEMS;
    const __nv_bfloat16* b = Bs + (kt % STAGES) * G::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[G::MT][4];
#pragma unroll
      for (int i = 0; i < G::MT; ++i)
        sm90::ldmatrix_x4(af[i],
                          a + (wm0 + 16 * i + a_row) * G::A_LD + kk + a_col);
#pragma unroll
      for (int j = 0; j < G::NT; j += 2) {
        uint32_t bf[4];
        if constexpr (TRANS)
          sm90::ldmatrix_x4(bf,
                            b + (wn0 + 8 * j + b_row) * G::B_LD + kk + b_col);
        else
          sm90::ldmatrix_x4_trans(
              bf, b + (kk + a_row) * G::B_LD + wn0 + 8 * j + a_col);
#pragma unroll
        for (int i = 0; i < G::MT; ++i) {
          sm90::mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
          sm90::mma_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  sm90::cp_async_wait<0>();

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < G::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm0 + 16 * i + g + 8 * h;
      if (r >= row1) continue;
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int c = col0 + wn0 + 8 * j + 2 * t;
        __nv_bfloat16* o = out + (size_t)r * Nout + c;
        const float x = acc[i][j][2 * h], y = acc[i][j][2 * h + 1];
        if (vec && c < Nout) {                   // Nout % 8 == 0: c + 1 too
          *reinterpret_cast<uint32_t*>(o) = sm90::pack_bf16(x, y);
        } else {
          if (c < Nout) o[0] = __float2bfloat16(x);
          if (c + 1 < Nout) o[1] = __float2bfloat16(y);
        }
      }
    }
  }
}

constexpr int FBM = 64, FBN = 64, FBK = 16;

template <bool TRANS>
__global__ void __launch_bounds__(256)
grouped_mm_f32_kernel(const float* __restrict__ lhs,
                      const float* __restrict__ rhs,
                      const int* __restrict__ offsets,
                      float* __restrict__ out, int M, int Kc, int Nout,
                      int E) {
  __shared__ float As[FBK][FBM + 4];  // transposed: As[k][row]
  __shared__ float Bs[FBK][FBN + 4];

  int e, row0, row1;
  if (!find_tile<256>(offsets, E, M, FBM, blockIdx.y, e, row0, row1)) return;
  const int col0 = blockIdx.x * FBN;
  if (e < 0) {
    zero_tile(out, 0.f, row0, row1, col0, FBN, Nout);
    return;
  }
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // each thread owns a 4x4 patch
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const float* w = rhs + (size_t)e * Kc * Nout;
  for (int k0 = 0; k0 < Kc; k0 += FBK) {
    for (int c = tid; c < FBM * FBK; c += blockDim.x) {
      const int r = c / FBK, kk = c % FBK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < row1 && gk < Kc) ? lhs[(size_t)gr * Kc + gk] : 0.f;
    }
    for (int c = tid; c < FBK * FBN; c += blockDim.x) {
      if constexpr (TRANS) {  // along rows of w[e] (Nout, Kc)
        const int n = c / FBK, kk = c % FBK;
        const int gk = k0 + kk, gn = col0 + n;
        Bs[kk][n] = (gk < Kc && gn < Nout) ? w[(size_t)gn * Kc + gk] : 0.f;
      } else {
        const int r = c / FBN, n = c % FBN;
        const int gk = k0 + r, gn = col0 + n;
        Bs[r][n] = (gk < Kc && gn < Nout) ? w[(size_t)gk * Nout + gn] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = row0 + ty * 4 + i, gn = col0 + tx * 4 + j;
      if (gr < row1 && gn < Nout) out[(size_t)gr * Nout + gn] = acc[i][j];
    }
}

// drhs[e] (K, N) f32 = lhs[seg_e]^T @ g[seg_e]; block (x: N tile, y: K
// tile, z: expert) walks its expert's rows in DM-row chunks.
constexpr int BM = 64, BN = 64;
constexpr int C_LD = BN + 4;   // floats
constexpr int DM = 32;
constexpr int DA_LD = BM + 8;  // As[m][k]: lhs rows, read as col_major A
constexpr int DB_LD = BN + 8;  // Bs[m][n]: g rows, row_major B

__global__ void __launch_bounds__(128)
grouped_drhs_bf16_kernel(const __nv_bfloat16* __restrict__ lhs,
                         const __nv_bfloat16* __restrict__ g,
                         const int* __restrict__ offsets,
                         float* __restrict__ out, int M, int K, int N,
                         bool vec) {
  __shared__ __align__(32) __nv_bfloat16 As[DM * DA_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[DM * DB_LD];
  __shared__ __align__(32) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int e = blockIdx.z;
  const int k0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lo = max(offsets[e], 0), hi = min(offsets[e + 1], M);

  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int m0 = lo; m0 < hi; m0 += DM) {
    // lhs chunk (DM x BM) and g chunk (DM x BN), rows at or past hi as 0
    for (int c = tid; c < DM * BM / 8; c += blockDim.x) {
      const int r = c / (BM / 8), kk = (c % (BM / 8)) * 8;
      const int gr = m0 + r, gk = k0 + kk;
      __nv_bfloat16* dst = As + r * DA_LD + kk;
      const bool rv = gr < hi;
      if (rv && vec && gk + 8 <= K) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(lhs + (size_t)gr * K + gk);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t)
          dst[t] = (rv && gk + t < K) ? lhs[(size_t)gr * K + gk + t] : zero;
      }
    }
    for (int c = tid; c < DM * BN / 8; c += blockDim.x) {
      const int r = c / (BN / 8), nn = (c % (BN / 8)) * 8;
      const int gr = m0 + r, gn = n0 + nn;
      __nv_bfloat16* dst = Bs + r * DB_LD + nn;
      const bool rv = gr < hi;
      if (rv && vec && gn + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(g + (size_t)gr * N + gn);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t)
          dst[t] = (rv && gn + t < N) ? g[(size_t)gr * N + gn + t] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < DM; mm += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + mm * DA_LD + wr + 16 * i, DA_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + mm * DB_LD + wc + 16 * j, DB_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr + 16 * i) * C_LD + wc + 16 * j,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  float* o = out + (size_t)e * K * N;
  for (int c = tid; c < BM * BN; c += blockDim.x) {
    const int r = c / BN, n = c % BN;
    const int gk = k0 + r, gn = n0 + n;
    if (gk < K && gn < N) o[(size_t)gk * N + gn] = Cs[r * C_LD + n];
  }
}

constexpr int FDM = 16;

__global__ void __launch_bounds__(256)
grouped_drhs_f32_kernel(const float* __restrict__ lhs,
                        const float* __restrict__ g,
                        const int* __restrict__ offsets,
                        float* __restrict__ out, int M, int K, int N) {
  __shared__ float As[FDM][FBM + 4];  // As[m][k]
  __shared__ float Bs[FDM][FBN + 4];  // Bs[m][n]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // each thread owns a 4x4 patch
  const int e = blockIdx.z;
  const int k0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  const int lo = max(offsets[e], 0), hi = min(offsets[e + 1], M);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int m0 = lo; m0 < hi; m0 += FDM) {
    for (int c = tid; c < FDM * FBM; c += blockDim.x) {
      const int r = c / FBM, kk = c % FBM;
      const int gr = m0 + r, gk = k0 + kk;
      As[r][kk] = (gr < hi && gk < K) ? lhs[(size_t)gr * K + gk] : 0.f;
    }
    for (int c = tid; c < FDM * FBN; c += blockDim.x) {
      const int r = c / FBN, n = c % FBN;
      const int gr = m0 + r, gn = n0 + n;
      Bs[r][n] = (gr < hi && gn < N) ? g[(size_t)gr * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < FDM; ++mm) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[mm][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[mm][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* o = out + (size_t)e * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + ty * 4 + i, gn = n0 + tx * 4 + j;
      if (gk < K && gn < N) o[(size_t)gk * N + gn] = acc[i][j];
    }
}

// rhs (E, K, N) in every entry point; the forward's lhs/out are (M, K) /
// (M, N), the transposed form's (M, N) / (M, K).  The grid: column tiles
// by the most row tiles any offsets can give (see the header).
template <int BM_, int BN_, int BK_, int WM, int WN, int STAGES, bool TRANS>
int launch_gemm(const void* lhs, const void* rhs, const void* offsets,
                void* out, int M, int Kc, int Nout, int E, bool vec,
                cudaStream_t stream) {
  using G = Gemm<BM_, BN_, BK_, WM, WN, STAGES, TRANS>;
  const auto kernel = grouped_mm_bf16_kernel<BM_, BN_, BK_, WM, WN, STAGES,
                                             TRANS>;
  static bool raised = false;  // no attribute call under graph capture
  if (!raised) {
    if (const int rc = (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)G::SMEM))
      return rc;
    raised = true;
  }
  const dim3 grid((Nout + BN_ - 1) / BN_, (M + BM_ - 1) / BM_ + E + 1);
  kernel<<<grid, G::THREADS, G::SMEM, stream>>>(
      (const __nv_bfloat16*)lhs, (const __nv_bfloat16*)rhs,
      (const int*)offsets, (__nv_bfloat16*)out, M, Kc, Nout, E, vec);
  return (int)cudaGetLastError();
}

template <bool TRANS>
int launch_mm_bf16(const void* lhs, const void* rhs, const void* offsets,
                   void* out, int M, int K, int N, int E, void* stream) {
  if (E < 1 || E > GMM_MAX_E) return (int)cudaErrorInvalidValue;
  const int Kc = TRANS ? N : K, Nout = TRANS ? K : N;
  if (M == 0 || Nout == 0) return 0;
  const bool vec = Kc % 8 == 0 && Nout % 8 == 0 &&
                   ((uintptr_t)lhs | (uintptr_t)rhs | (uintptr_t)out) % 16 ==
                       0;
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= SMALL_M)
    return launch_gemm<16, 64, 64, 1, 4, 4, TRANS>(lhs, rhs, offsets, out, M,
                                                   Kc, Nout, E, vec, s);
  return launch_gemm<128, 128, 64, 2, 4, 3, TRANS>(lhs, rhs, offsets, out, M,
                                                   Kc, Nout, E, vec, s);
}

template <bool TRANS>
int launch_mm_f32(const void* lhs, const void* rhs, const void* offsets,
                  void* out, int M, int K, int N, int E, void* stream) {
  if (E < 1 || E > GMM_MAX_E) return (int)cudaErrorInvalidValue;
  const int Kc = TRANS ? N : K, Nout = TRANS ? K : N;
  if (M == 0 || Nout == 0) return 0;
  const dim3 grid((Nout + FBN - 1) / FBN, (M + FBM - 1) / FBM + E + 1);
  grouped_mm_f32_kernel<TRANS><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)lhs, (const float*)rhs, (const int*)offsets, (float*)out,
      M, Kc, Nout, E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int grouped_matmul_bf16(const void* lhs, const void* rhs,
                                   const void* offsets, void* out, int M,
                                   int K, int N, int E, void* stream) {
  return launch_mm_bf16<false>(lhs, rhs, offsets, out, M, K, N, E, stream);
}

extern "C" int grouped_matmul_f32(const void* lhs, const void* rhs,
                                  const void* offsets, void* out, int M,
                                  int K, int N, int E, void* stream) {
  return launch_mm_f32<false>(lhs, rhs, offsets, out, M, K, N, E, stream);
}

// dlhs: g (M, N) @ rhs[e]^T → out (M, K)
extern "C" int grouped_matmul_t_bf16(const void* g, const void* rhs,
                                     const void* offsets, void* out, int M,
                                     int K, int N, int E, void* stream) {
  return launch_mm_bf16<true>(g, rhs, offsets, out, M, K, N, E, stream);
}

extern "C" int grouped_matmul_t_f32(const void* g, const void* rhs,
                                    const void* offsets, void* out, int M,
                                    int K, int N, int E, void* stream) {
  return launch_mm_f32<true>(g, rhs, offsets, out, M, K, N, E, stream);
}

// drhs: lhs (M, K), g (M, N) → out (E, K, N) f32, every element written
extern "C" int grouped_drhs_bf16(const void* lhs, const void* g,
                                 const void* offsets, void* out, int M,
                                 int K, int N, int E, void* stream) {
  if (E < 1 || E > 65535) return (int)cudaErrorInvalidValue;
  if (K == 0 || N == 0) return 0;
  const bool vec = K % 8 == 0 && N % 8 == 0 &&
                   ((uintptr_t)lhs | (uintptr_t)g) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, E);
  grouped_drhs_bf16_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)lhs, (const __nv_bfloat16*)g,
      (const int*)offsets, (float*)out, M, K, N, vec);
  return (int)cudaGetLastError();
}

extern "C" int grouped_drhs_f32(const void* lhs, const void* g,
                                const void* offsets, void* out, int M, int K,
                                int N, int E, void* stream) {
  if (E < 1 || E > 65535) return (int)cudaErrorInvalidValue;
  if (K == 0 || N == 0) return 0;
  const dim3 grid((N + FBN - 1) / FBN, (K + FBM - 1) / FBM, E);
  grouped_drhs_f32_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)lhs, (const float*)g, (const int*)offsets, (float*)out,
      M, K, N);
  return (int)cudaGetLastError();
}
