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
// Design (simple and correct first; TMA + wgmma come later): each block
// owns a 64x64 output tile.  Forward and dlhs keep the offsets in shared
// memory; for every expert whose segment overlaps the block's rows they
// walk the contraction in 32-deep shared-memory tiles, with rows outside
// that segment loaded as 0, and accumulate in f32 — bf16 on the tensor
// cores through WMMA (mma.sync), f32 with FMAs.  A row belongs to exactly
// one expert, so the other experts add exact zeros and the masked sums are
// exact.  dlhs is the same kernel with B read transposed: each B tile is
// loaded from rows of w[e] (contiguous along the contraction) into a
// column-major shared tile and fed to a col_major matrix_b fragment, so no
// (E, N, K) copy of the weights is ever made in device memory.  The kernel
// re-reads an expert's weights once per 64-row tile (from L2 when they
// fit); that, not the bound, sets its time.
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

#include <type_traits>

using namespace nvcuda;

#define GMM_MAX_E 1024

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int A_LD = BK + 8;   // bf16 elements; rows stay 16-byte aligned
constexpr int B_LD = BN + 8;   // B tile row-major: Bs[k][n]
constexpr int BT_LD = BK + 8;  // B tile column-major: Bs[n][k] (transposed)
constexpr int B_SMEM = (BK * B_LD > BN * BT_LD) ? BK * B_LD : BN * BT_LD;
constexpr int C_LD = BN + 4;   // floats

// out (M, Nout) = per-segment lhs (M, Kc) @ B_e, where B_e is rhs[e]
// (Kc, Nout) row-major, or with TRANS rhs[e] (Nout, Kc) read transposed.
template <bool TRANS>
__global__ void __launch_bounds__(128)
grouped_mm_bf16_kernel(const __nv_bfloat16* __restrict__ lhs,
                       const __nv_bfloat16* __restrict__ rhs,
                       const int* __restrict__ offsets,
                       __nv_bfloat16* __restrict__ out, int M, int Kc,
                       int Nout, int E, bool vec) {
  using BLayout =
      std::conditional_t<TRANS, wmma::col_major, wmma::row_major>;
  __shared__ int offs[GMM_MAX_E + 1];
  __shared__ __align__(32) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[B_SMEM];
  __shared__ __align__(32) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  for (int i = tid; i <= E; i += blockDim.x) offs[i] = offsets[i];
  __syncthreads();

  // 4 warps, each a 32x32 quarter of the tile as 2x2 16x16 fragments
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int end = min(offs[E], M);
  for (int e = 0; e < E && row0 < end; ++e) {
    const int lo = max(offs[e], 0), hi = min(offs[e + 1], M);
    if (lo >= hi || hi <= row0 || lo >= row0 + BM) continue;
    const __nv_bfloat16* w = rhs + (size_t)e * Kc * Nout;
    for (int k0 = 0; k0 < Kc; k0 += BK) {
      // A tile (BM x BK) in 8-element chunks, rows outside [lo, hi) as 0
      for (int c = tid; c < BM * BK / 8; c += blockDim.x) {
        const int r = c / (BK / 8), kk = (c % (BK / 8)) * 8;
        const int gr = row0 + r, gk = k0 + kk;
        __nv_bfloat16* dst = As + r * A_LD + kk;
        const bool rv = gr >= lo && gr < hi;
        if (rv && vec && gk + 8 <= Kc) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(lhs + (size_t)gr * Kc + gk);
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t)
            dst[t] = (rv && gk + t < Kc) ? lhs[(size_t)gr * Kc + gk + t]
                                         : zero;
        }
      }
      if constexpr (TRANS) {
        // B tile from BN rows of w[e] (Nout, Kc), BK contiguous elements
        // each, stored column-major: Bs[n * BT_LD + k]
        for (int c = tid; c < BN * BK / 8; c += blockDim.x) {
          const int n = c / (BK / 8), kk = (c % (BK / 8)) * 8;
          const int gn = col0 + n, gk = k0 + kk;
          __nv_bfloat16* dst = Bs + n * BT_LD + kk;
          if (gn < Nout && vec && gk + 8 <= Kc) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(w + (size_t)gn * Kc + gk);
          } else {
#pragma unroll
            for (int t = 0; t < 8; ++t)
              dst[t] = (gn < Nout && gk + t < Kc)
                           ? w[(size_t)gn * Kc + gk + t] : zero;
          }
        }
      } else {
        // B tile (BK x BN) of w[e] (Kc, Nout), row-major: Bs[k * B_LD + n]
        for (int c = tid; c < BK * BN / 8; c += blockDim.x) {
          const int r = c / (BN / 8), nn = (c % (BN / 8)) * 8;
          const int gk = k0 + r, gn = col0 + nn;
          __nv_bfloat16* dst = Bs + r * B_LD + nn;
          if (gk < Kc && vec && gn + 8 <= Nout) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(w + (size_t)gk * Nout + gn);
          } else {
#pragma unroll
            for (int t = 0; t < 8; ++t)
              dst[t] = (gk < Kc && gn + t < Nout)
                           ? w[(size_t)gk * Nout + gn + t] : zero;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout>
            b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wr + 16 * i) * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if constexpr (TRANS)
            wmma::load_matrix_sync(b[j], Bs + (wc + 16 * j) * BT_LD + kk,
                                   BT_LD);
          else
            wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wc + 16 * j, B_LD);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr + 16 * i) * C_LD + wc + 16 * j,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  // rows no expert covered (at or past offsets[E]) kept their zero sums
  for (int c = tid; c < BM * BN; c += blockDim.x) {
    const int r = c / BN, n = c % BN;
    const int gr = row0 + r, gn = col0 + n;
    if (gr < M && gn < Nout)
      out[(size_t)gr * Nout + gn] = __float2bfloat16(Cs[r * C_LD + n]);
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
  __shared__ int offs[GMM_MAX_E + 1];
  __shared__ float As[FBK][FBM + 4];  // transposed: As[k][row]
  __shared__ float Bs[FBK][FBN + 4];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // each thread owns a 4x4 patch
  const int row0 = blockIdx.y * FBM, col0 = blockIdx.x * FBN;
  for (int i = tid; i <= E; i += blockDim.x) offs[i] = offsets[i];
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int end = min(offs[E], M);
  for (int e = 0; e < E && row0 < end; ++e) {
    const int lo = max(offs[e], 0), hi = min(offs[e + 1], M);
    if (lo >= hi || hi <= row0 || lo >= row0 + FBM) continue;
    const float* w = rhs + (size_t)e * Kc * Nout;
    for (int k0 = 0; k0 < Kc; k0 += FBK) {
      for (int c = tid; c < FBM * FBK; c += blockDim.x) {
        const int r = c / FBK, kk = c % FBK;
        const int gr = row0 + r, gk = k0 + kk;
        As[kk][r] = (gr >= lo && gr < hi && gk < Kc)
                        ? lhs[(size_t)gr * Kc + gk] : 0.f;
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
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = row0 + ty * 4 + i, gn = col0 + tx * 4 + j;
      if (gr < M && gn < Nout) out[(size_t)gr * Nout + gn] = acc[i][j];
    }
}

// drhs[e] (K, N) f32 = lhs[seg_e]^T @ g[seg_e]; block (x: N tile, y: K
// tile, z: expert) walks its expert's rows in DM-row chunks.
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
// (M, N), the transposed form's (M, N) / (M, K).
template <bool TRANS>
int launch_mm_bf16(const void* lhs, const void* rhs, const void* offsets,
                   void* out, int M, int K, int N, int E, void* stream) {
  if (E < 1 || E > GMM_MAX_E) return (int)cudaErrorInvalidValue;
  const int Kc = TRANS ? N : K, Nout = TRANS ? K : N;
  if (M == 0 || Nout == 0) return 0;
  const bool vec = Kc % 8 == 0 && Nout % 8 == 0 &&
                   ((uintptr_t)lhs | (uintptr_t)rhs) % 16 == 0;
  const dim3 grid((Nout + BN - 1) / BN, (M + BM - 1) / BM);
  grouped_mm_bf16_kernel<TRANS><<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)lhs, (const __nv_bfloat16*)rhs,
      (const int*)offsets, (__nv_bfloat16*)out, M, Kc, Nout, E, vec);
  return (int)cudaGetLastError();
}

template <bool TRANS>
int launch_mm_f32(const void* lhs, const void* rhs, const void* offsets,
                  void* out, int M, int K, int N, int E, void* stream) {
  if (E < 1 || E > GMM_MAX_E) return (int)cudaErrorInvalidValue;
  const int Kc = TRANS ? N : K, Nout = TRANS ? K : N;
  if (M == 0 || Nout == 0) return 0;
  const dim3 grid((Nout + FBN - 1) / FBN, (M + FBM - 1) / FBM);
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
