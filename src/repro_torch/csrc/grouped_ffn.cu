// Grouped (ragged) expert matmul for the dropless dispatch mode:
//   y[offs[e]:offs[e+1]] = lhs[offs[e]:offs[e+1]] @ rhs[e]
// lhs (M, K), rhs (E, K, N), offsets (E+1,) int32; f32 accumulation, the
// result cast to lhs's dtype; rows at or past offsets[E] belong to no
// expert and come out zero.
//
// Replaces the TPU kernel repro/kernels/grouped_ffn.py:
// _grouped_matmul_kernel with transpose_rhs=False (pallas_call in
// _grouped_matmul_impl).  The transpose_rhs=True (dlhs) form and the drhs
// kernel come with the training slice.
//
// Bound on the H100: at prefill (M=4096, K=N=2048, E=16) 34.4 GFLOP
// against 160 MiB — the 128 MiB of expert weights dominate — so it is
// memory-bound near 50 us; at decode (M=8) it reads at most 8 experts'
// weights.  Design (simple and correct first; TMA + wgmma come later):
// each block owns a 64x64 output tile and keeps the offsets in shared
// memory.  For every expert whose segment overlaps its rows it walks K in
// 32-deep shared-memory tiles, with rows outside that segment loaded as 0,
// and accumulates in f32 — bf16 on the tensor cores through WMMA
// (mma.sync), f32 with FMAs.  A row belongs to exactly one expert, so the
// other experts add exact zeros and the masked sums are exact.  The kernel
// re-reads an expert's weights once per 64-row tile (from L2 when they
// fit); that, not the bound, sets its time.  The reference's
// grouped_block_m is a TPU tiling knob; this kernel picks its own tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

#define GMM_MAX_E 1024

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int A_LD = BK + 8;  // bf16 elements; rows stay 16-byte aligned
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;  // floats

__global__ void __launch_bounds__(128)
grouped_mm_bf16_kernel(const __nv_bfloat16* __restrict__ lhs,
                       const __nv_bfloat16* __restrict__ rhs,
                       const int* __restrict__ offsets,
                       __nv_bfloat16* __restrict__ out, int M, int K, int N,
                       int E, bool vec) {
  __shared__ int offs[GMM_MAX_E + 1];
  __shared__ __align__(32) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * B_LD];
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
    const __nv_bfloat16* w = rhs + (size_t)e * K * N;
    for (int k0 = 0; k0 < K; k0 += BK) {
      // A tile (BM x BK) in 8-element chunks, rows outside [lo, hi) as 0
      for (int c = tid; c < BM * BK / 8; c += blockDim.x) {
        const int r = c / (BK / 8), kk = (c % (BK / 8)) * 8;
        const int gr = row0 + r, gk = k0 + kk;
        __nv_bfloat16* dst = As + r * A_LD + kk;
        const bool rv = gr >= lo && gr < hi;
        if (rv && vec && gk + 8 <= K) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(lhs + (size_t)gr * K + gk);
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t)
            dst[t] = (rv && gk + t < K) ? lhs[(size_t)gr * K + gk + t] : zero;
        }
      }
      // B tile (BK x BN) of expert e's weights
      for (int c = tid; c < BK * BN / 8; c += blockDim.x) {
        const int r = c / (BN / 8), nn = (c % (BN / 8)) * 8;
        const int gk = k0 + r, gn = col0 + nn;
        __nv_bfloat16* dst = Bs + r * B_LD + nn;
        if (gk < K && vec && gn + 8 <= N) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn);
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t)
            dst[t] = (gk < K && gn + t < N) ? w[(size_t)gk * N + gn + t] : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wr + 16 * i) * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wc + 16 * j, B_LD);
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
    if (gr < M && gn < N)
      out[(size_t)gr * N + gn] = __float2bfloat16(Cs[r * C_LD + n]);
  }
}

constexpr int FBM = 64, FBN = 64, FBK = 16;

__global__ void __launch_bounds__(256)
grouped_mm_f32_kernel(const float* __restrict__ lhs,
                      const float* __restrict__ rhs,
                      const int* __restrict__ offsets,
                      float* __restrict__ out, int M, int K, int N, int E) {
  __shared__ int offs[GMM_MAX_E + 1];
  __shared__ float As[FBK][FBM + 4];  // transposed: As[k][row]
  __shared__ float Bs[FBK][FBN];

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
    const float* w = rhs + (size_t)e * K * N;
    for (int k0 = 0; k0 < K; k0 += FBK) {
      for (int c = tid; c < FBM * FBK; c += blockDim.x) {
        const int r = c / FBK, kk = c % FBK;
        const int gr = row0 + r, gk = k0 + kk;
        As[kk][r] = (gr >= lo && gr < hi && gk < K)
                        ? lhs[(size_t)gr * K + gk] : 0.f;
      }
      for (int c = tid; c < FBK * FBN; c += blockDim.x) {
        const int r = c / FBN, n = c % FBN;
        const int gk = k0 + r, gn = col0 + n;
        Bs[r][n] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.f;
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
      if (gr < M && gn < N) out[(size_t)gr * N + gn] = acc[i][j];
    }
}

}  // namespace

extern "C" int grouped_matmul_bf16(const void* lhs, const void* rhs,
                                   const void* offsets, void* out, int M,
                                   int K, int N, int E, void* stream) {
  if (E < 1 || E > GMM_MAX_E) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const bool vec = K % 8 == 0 && N % 8 == 0 &&
                   ((uintptr_t)lhs | (uintptr_t)rhs) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  grouped_mm_bf16_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)lhs, (const __nv_bfloat16*)rhs,
      (const int*)offsets, (__nv_bfloat16*)out, M, K, N, E, vec);
  return (int)cudaGetLastError();
}

extern "C" int grouped_matmul_f32(const void* lhs, const void* rhs,
                                  const void* offsets, void* out, int M,
                                  int K, int N, int E, void* stream) {
  if (E < 1 || E > GMM_MAX_E) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
  grouped_mm_f32_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)lhs, (const float*)rhs, (const int*)offsets, (float*)out,
      M, K, N, E);
  return (int)cudaGetLastError();
}
