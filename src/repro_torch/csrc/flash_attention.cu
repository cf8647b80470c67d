// Flash attention, forward and backward, for q (B, H, Sq, d) and k, v
// (B, KV, Sk, d) in bf16 or f32 (head-major; head h reads kv head
// h / (H / KV)), positions qpos (Sq,) and kpos (Sk,) int32:
//   forward  o = softmax(mask(cap(q k^T * scale))) v, in q's dtype, and
//            lse = m + log(l) per row in f32
//   dq       dq = (dS k) * scale
//   dk/dv    dk = sum_g (dS^T q) * scale, dv = sum_g P^T dO
// with p = exp(s - lse), dS = p (dO v^T - delta) (1 - t^2) masked to 0,
// t = tanh(s_raw / cap), delta = rowsum(dO o) (computed by the caller).
// The mask is the reference's _mask: kpos >= 0, kpos <= qpos when causal,
// kpos > qpos - window with a window; a masked score is NEG = -1e30.
//
// Replaces the TPU kernels repro/kernels/flash_attention.py: _fwd_kernel,
// _bwd_dq_kernel and _bwd_dkv_kernel.
//
// Bounds on the H100 at the training shapes (B=8, H=KV=16, S=1024, d=128,
// bf16; q, k, v, o and dO are 33.5 MB each): the forward moves 134 MB
// (40 us at 3.35 TB/s) and does 68.7 GFLOP over all tiles (69 us at the
// bf16 tensor-core rate; the causal half 35 us), dq 168 MB and 103 GFLOP,
// dk/dv 201 MB and 137 GFLOP: all bound by operations on the tensor cores.
// Every kernel keeps the reference's arithmetic: p and dS are f32, as the
// TPU kernels keep them.
//
// The forward skips the k tiles in which no row of a group of its q rows
// may see any key.  That is exact while every row of the group has an
// allowed key: a masked key adds p = exp(NEG - m), which is 0 once the row
// has met an allowed key and is wiped by alpha = exp(NEG - m) = 0 when it
// meets one later.  So a block first scans qpos and kpos (plan_k_tiles):
// if a row of a group has no allowed key at all, the group visits every
// tile, as the reference does (p = 1 for every key: o = mean of v, lse =
// NEG + log Sk); else it visits the tiles that hold a valid key between
// its rows' lowest and highest allowed positions.  The rule reads the
// positions only, so invalid slots (kpos < 0) and q offset against k are
// handled.  At the causal training shape a group visits the k tiles up to
// its diagonal: in 64x64 units, 136 of 256 (q tile, k tile) pairs per
// (b, h), against 256 before.
//
// bf16 forward (redesigned for Hopper; flash_fwd_bf16_kernel): a 64-row q
// tile per block and 4 warps, each owning 16 query rows and skipping on
// its own the k tiles its rows may not see, FlashAttention-2 style on
// mma.sync m16n8k16.  q stays in registers as A fragments; q k^T
// accumulates in f32 registers; the scores, the row max and the row sum
// stay in registers (max and sum reduced over the quad of lanes that share
// a row with shuffles), and the accumulator fragments of the scores become
// the A operands of P V without a trip through shared memory.  P V keeps p
// in f32 through a split p = hi + lo into two bf16 values (hi = bf16(p),
// lo = bf16(p - hi)): two bf16 products with exact f32 partial products
// and f32 sums, leaving |p - hi - lo| <= 2^-16 |p|, 256 times below the
// bf16 output's unit roundoff (2^-8).  The scores are kept in base 2 (s
// log2 e), so each p is one exp2; a tile in which every (row, key) pair of
// a warp is allowed skips the mask.  The head dim and the softcap are
// template arguments, so the loops are straight-line code.  K and V tiles
// (and their positions) arrive by cp.async into a double buffer: the copy
// of the next visited tile runs under the products of this one.  Rows are
// padded by 16 bytes in shared memory, so ldmatrix reads hit no bank
// twice.  Blocks take their q tiles last-first, so the longest causal rows
// start first.
//
// f32 forward, dq and dk/dv (simple and right first): a 64-row tile of
// queries or keys per block, 256 threads.  The TPU grid's sequential axes
// become loops inside the block: the forward and dq walk the k tiles of one
// (b, h, q tile); dk/dv walks the G query heads of one kv head and all
// their q tiles, with f32 accumulators and no atomics, so its result does
// not depend on run order.  Tiles of q, k, v and dO sit in dynamic shared
// memory (up to 164 KB), with the 64x64 f32 score tile.  q k^T and dO v^T
// run on the tensor cores (WMMA) when the inputs are bf16 (the products of
// bf16 values are exact in f32; only the order of the sums changes) and
// with f32 FMAs otherwise (never TF32); the products of p and dS are f32
// FMAs.  The f32 forward skips tiles by the rule above; dq and dk/dv visit
// every tile.  Keys past Sk (the ragged edge) count as nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "sm90_mma.cuh"

using namespace nvcuda;

namespace {

constexpr int FA_TILE = 64;         // rows of a q tile and of a k tile
constexpr int FA_THREADS = 256;     // 8 warps
constexpr int S_LD = FA_TILE + 4;   // row stride of the f32 score tiles
constexpr int MAX_NJ = 8;           // d / 16 at the largest head dim, 128
constexpr float NEG = -1e30f;

struct Mask {
  float scale;
  int causal, window, use_window;
  float cap;
  int use_cap;
};

// row padding of a tile in shared memory: bf16 rows stay 16-byte aligned
// for WMMA; f32 rows get an odd stride, so a column walk hits no bank twice
template <typename T> struct Pad;
template <> struct Pad<__nv_bfloat16> { static constexpr int value = 8; };
template <> struct Pad<float> { static constexpr int value = 1; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool allowed(int qp, int kp, const Mask& mk) {
  bool ok = kp >= 0;
  if (mk.causal) ok = ok && kp <= qp;
  if (mk.use_window) ok = ok && kp > qp - mk.window;
  return ok;
}

// The k tiles (of FA_TILE keys) each group of `group` q rows of a block
// (rows [q0, q0 + qn), at most PLAN_GROUPS groups) visits, as a 2-bit code
// per group in flags[j] (bits 2i, 2i + 1 for group i; j < ceil(Sk /
// FA_TILE)): 0 skip, 1 visit, 2 visit and no mask needed.  A group visits
// every tile if one of its rows has no allowed key (the reference then
// gives that row p = 1 for every key); else each tile holding a valid key
// kp with kp <= max qpos (causal) and kp > min qpos - window (window) of
// its rows, a superset of the tiles with an allowed (row, key) pair.  Code
// 2 marks a tile in which every (row, key) pair is allowed (all FA_TILE
// keys valid, kp <= min qpos, kp > max qpos - window).  red is
// 3 * PLAN_GROUPS ints of shared scratch.  Ends with a barrier.  Mirrored
// by kernels/flash_attention.py:visited_k_tiles.
constexpr int PLAN_GROUPS = 4;

__device__ void plan_k_tiles(const int* __restrict__ qpos,
                             const int* __restrict__ kpos, int q0, int qn,
                             int group, int Sk, const Mask& mk, int* flags,
                             int* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32, nkt = (Sk + FA_TILE - 1) / FA_TILE;
  const int ngroups = (qn + group - 1) / group;
  if (threadIdx.x < PLAN_GROUPS) {
    red[3 * threadIdx.x] = 0x7fffffff;             // lowest q position
    red[3 * threadIdx.x + 1] = -0x7fffffff - 1;    // highest
    red[3 * threadIdx.x + 2] = 0;                  // a row with no key
  }
  __syncthreads();
  for (int r = warp; r < qn; r += nw) {      // a warp per row, 32 keys a step
    const int qp = qpos[q0 + r];
    bool found = false;
    for (int c0 = 0; c0 < Sk && !found; c0 += 32) {
      const int c = c0 + lane;
      found = __any_sync(0xffffffffu, c < Sk && allowed(qp, kpos[c], mk));
    }
    if (lane == 0) {
      int* rg = red + 3 * (r / group);
      atomicMin(rg, qp);
      atomicMax(rg + 1, qp);
      if (!found) rg[2] = 1;
    }
  }
  __syncthreads();
  for (int j = warp; j < nkt; j += nw) {
    int code = 0;
    for (int i = 0; i < ngroups; ++i) {
      const long long qmin = red[3 * i], qmax = red[3 * i + 1];
      bool any = false, every = true;
      for (int c = j * FA_TILE + lane; c < (j + 1) * FA_TILE; c += 32) {
        const int kp = c < Sk ? kpos[c] : -1;
        any |= kp >= 0 && (!mk.causal || kp <= qmax) &&
               (!mk.use_window || kp > qmin - mk.window);
        every &= kp >= 0 && (!mk.causal || kp <= qmin) &&
                 (!mk.use_window || kp > qmax - mk.window);
      }
      any = __any_sync(0xffffffffu, any) || red[3 * i + 2];
      every = __all_sync(0xffffffffu, every);
      code |= (every ? 2 : any ? 1 : 0) << (2 * i);
    }
    if (lane == 0) flags[j] = code;
  }
  __syncthreads();
}

// the first visited tile at or after j (nkt when none is left)
__device__ __forceinline__ int next_tile(const int* flags, int j, int nkt) {
  while (j < nkt && !flags[j]) ++j;
  return j;
}

// rows [row0, row0 + FA_TILE) of a (nrows, d) matrix into dst (stride ld);
// rows past nrows as 0
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* __restrict__ src, int row0,
                          int nrows, int d) {
  const T zero = from_f<T>(0.f);
  for (int i = threadIdx.x; i < FA_TILE * d; i += FA_THREADS) {
    const int r = i / d, c = i - r * d;
    dst[r * ld + c] =
        row0 + r < nrows ? src[(size_t)(row0 + r) * d + c] : zero;
  }
}

// S[r][c] = sum_k A[r][k] * B[c][k] over a 64x64 tile, f32 FMAs
__device__ void tile_dot(const float* A, const float* B, int ld, float* S,
                         int d) {
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < d; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(rg + 16 * i) * ld + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(cg + 16 * j) * ld + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      S[(rg + 16 * i) * S_LD + cg + 16 * j] = acc[i][j];
}

// the same with bf16 inputs on the tensor cores (f32 accumulation): each
// warp a 16x32 piece, B read as a col_major fragment (B^T without a copy)
__device__ void tile_dot(const __nv_bfloat16* A, const __nv_bfloat16* B,
                         int ld, float* S, int d) {
  const int warp = threadIdx.x / 32;
  const int r0 = (warp >> 1) * 16, c0 = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int k = 0; k < d; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> a;
    wmma::load_matrix_sync(a, A + r0 * ld + k, ld);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b;
      wmma::load_matrix_sync(b, B + (c0 + 16 * j) * ld + k, ld);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(S + r0 * S_LD + c0 + 16 * j, acc[j], S_LD,
                            wmma::mem_row_major);
}

// acc[i][j] += sum_{t < n} P[r_i * prs + t * pts] * X[t][c_j] in f32, for
// the thread's rows r_i = rg + 16 i and columns c_j = cg + 16 j (j < nj)
template <typename T>
__device__ __forceinline__ void acc_product(float (&acc)[4][MAX_NJ],
                                            const float* P, int prs, int pts,
                                            const T* X, int ld, int n,
                                            int nj) {
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  for (int t = 0; t < n; ++t) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(rg + 16 * i) * prs + t * pts];
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) {
      if (j < nj) {
        const float x = to_f(X[t * ld + cg + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][MAX_NJ]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) acc[i][j] = 0.f;
}

// acc rows (row0 + r_i < nrows) into out (nrows, d) rows, divided by div[r]
// when div is given
template <typename T>
__device__ __forceinline__ void store_acc(const float (&acc)[4][MAX_NJ],
                                          T* out, int row0, int nrows, int d,
                                          const float* div) {
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16, nj = d / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    if (row0 + r >= nrows) continue;
    const float l = div ? div[r] : 1.f;
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j)
      if (j < nj)
        out[(size_t)(row0 + r) * d + cg + 16 * j] =
            from_f<T>(div ? acc[i][j] / l : acc[i][j]);
  }
}

// one block per (q tile, h, b); the visited k tiles in a loop (the TPU's
// nk axis); the f32 forward
template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, T* __restrict__ o,
                 float* __restrict__ lse, int H, int KV, int Sq, int Sk,
                 int d, Mask mk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + Pad<T>::value;
  float* Ss = reinterpret_cast<float*>(smem);        // scores, then p
  float* m_s = Ss + FA_TILE * S_LD;                  // running max
  float* l_s = m_s + FA_TILE;                        // running sum
  float* a_s = l_s + FA_TILE;                        // this tile's alpha
  int* qp_s = reinterpret_cast<int*>(a_s + FA_TILE);
  int* kp_s = qp_s + FA_TILE;
  T* Qs = reinterpret_cast<T*>(kp_s + FA_TILE);
  T* Ks = Qs + FA_TILE * ld;
  T* Vs = Ks + FA_TILE * ld;
  int* flags = reinterpret_cast<int*>(Vs + FA_TILE * ld);
  const int nkt = (Sk + FA_TILE - 1) / FA_TILE;

  const int q0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = tid / 16, nj = d / 16;
  const T* qb = q + ((size_t)b * H + h) * Sq * d;
  const T* kb = k + ((size_t)b * KV + kvh) * Sk * d;
  const T* vb = v + ((size_t)b * KV + kvh) * Sk * d;

  load_tile(Qs, ld, qb, q0, Sq, d);
  for (int i = tid; i < FA_TILE; i += FA_THREADS) {
    qp_s[i] = q0 + i < Sq ? qpos[q0 + i] : 0;
    m_s[i] = NEG;
    l_s[i] = 0.f;
  }
  float acc[4][MAX_NJ];
  zero_acc(acc);
  plan_k_tiles(qpos, kpos, q0, min(FA_TILE, Sq - q0), FA_TILE, Sk, mk,
               flags, flags + nkt);

  for (int j = next_tile(flags, 0, nkt); j < nkt;
       j = next_tile(flags, j + 1, nkt)) {
    const int k0 = j * FA_TILE, kn = min(FA_TILE, Sk - k0);
    load_tile(Ks, ld, kb, k0, Sk, d);
    load_tile(Vs, ld, vb, k0, Sk, d);
    for (int i = tid; i < FA_TILE; i += FA_THREADS)
      kp_s[i] = i < kn ? kpos[k0 + i] : 0;
    __syncthreads();
    tile_dot(Qs, Ks, ld, Ss, d);
    __syncthreads();
    // online softmax: warp w owns rows 8w..8w+7, a lane columns lane and
    // lane + 32; keys past Sk are -inf (p = 0), masked keys NEG
    for (int rr = 0; rr < FA_TILE / 8; ++rr) {
      const int r = warp * (FA_TILE / 8) + rr;
      const int qp = qp_s[r];
      float s[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = lane + 32 * hh;
        if (c < kn) {
          float x = Ss[r * S_LD + c] * mk.scale;
          if (mk.use_cap) x = mk.cap * tanhf(x / mk.cap);
          s[hh] = allowed(qp, kp_s[c], mk) ? x : NEG;
        } else {
          s[hh] = neg_inf();
        }
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s[0], s[1])));
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      Ss[r * S_LD + lane] = p0;
      Ss[r * S_LD + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // o_acc = o_acc * alpha + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[rg + 16 * i];
#pragma unroll
      for (int j = 0; j < MAX_NJ; ++j) acc[i][j] *= alpha;
    }
    acc_product(acc, Ss, S_LD, 1, Vs, ld, kn, nj);
    __syncthreads();
  }

  store_acc(acc, o + ((size_t)b * H + h) * Sq * d, q0, Sq, d, l_s);
  for (int i = tid; i < FA_TILE; i += FA_THREADS)
    if (q0 + i < Sq)
      lse[((size_t)b * H + h) * Sq + q0 + i] = m_s[i] + logf(l_s[i]);
}

// p and dS of one (q tile, k tile) pair from the score tile Ss and the
// dO v^T tile Ps: Ss <- p (0 past the edge), Ps <- dS * scale (0 where
// masked or past the edge)
__device__ __forceinline__ void probs_and_ds(float* Ss, float* Ps,
                                             const float* lse_s,
                                             const float* dl_s,
                                             const int* qp_s,
                                             const int* kp_s, int qn, int kn,
                                             const Mask& mk) {
  for (int e = threadIdx.x; e < FA_TILE * FA_TILE; e += FA_THREADS) {
    const int r = e / FA_TILE, c = e % FA_TILE;
    float p = 0.f, ds = 0.f;
    if (r < qn && c < kn) {
      const float sr = Ss[r * S_LD + c] * mk.scale;
      float s = sr, t = 0.f;
      if (mk.use_cap) {
        t = tanhf(sr / mk.cap);
        s = mk.cap * t;
      }
      const bool ok = allowed(qp_s[r], kp_s[c], mk);
      p = expf((ok ? s : NEG) - lse_s[r]);
      if (ok) {
        ds = p * (Ps[r * S_LD + c] - dl_s[r]);
        if (mk.use_cap) ds *= 1.f - t * t;
      }
    }
    Ss[r * S_LD + c] = p;
    Ps[r * S_LD + c] = ds * mk.scale;
  }
}

// loads lse, delta and q positions of rows [q0, q0 + FA_TILE) (0 past Sq)
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s,
                                          int* qp_s, const float* lse,
                                          const float* delta,
                                          const int* qpos, int q0, int Sq) {
  for (int i = threadIdx.x; i < FA_TILE; i += FA_THREADS) {
    const bool in = q0 + i < Sq;
    lse_s[i] = in ? lse[q0 + i] : 0.f;
    dl_s[i] = in ? delta[q0 + i] : 0.f;
    qp_s[i] = in ? qpos[q0 + i] : 0;
  }
}

// one block per (q tile, h, b); the k tiles in a loop
template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int* __restrict__ qpos, const int* __restrict__ kpos,
                T* __restrict__ dq, int H, int KV, int Sq, int Sk, int d,
                Mask mk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + Pad<T>::value;
  float* Ss = reinterpret_cast<float*>(smem);        // scores, then p
  float* Ps = Ss + FA_TILE * S_LD;                   // dO v^T, then dS
  float* lse_s = Ps + FA_TILE * S_LD;
  float* dl_s = lse_s + FA_TILE;
  int* qp_s = reinterpret_cast<int*>(dl_s + FA_TILE);
  int* kp_s = qp_s + FA_TILE;
  T* Qs = reinterpret_cast<T*>(kp_s + FA_TILE);
  T* Os = Qs + FA_TILE * ld;
  T* Ks = Os + FA_TILE * ld;
  T* Vs = Ks + FA_TILE * ld;

  const int q0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int qn = min(FA_TILE, Sq - q0), nj = d / 16;
  const size_t qoff = ((size_t)b * H + h) * Sq;
  const T* kb = k + ((size_t)b * KV + kvh) * Sk * d;
  const T* vb = v + ((size_t)b * KV + kvh) * Sk * d;

  load_tile(Qs, ld, q + qoff * d, q0, Sq, d);
  load_tile(Os, ld, dout + qoff * d, q0, Sq, d);
  load_rows(lse_s, dl_s, qp_s, lse + qoff, delta + qoff, qpos, q0, Sq);
  float acc[4][MAX_NJ];
  zero_acc(acc);

  for (int k0 = 0; k0 < Sk; k0 += FA_TILE) {
    const int kn = min(FA_TILE, Sk - k0);
    load_tile(Ks, ld, kb, k0, Sk, d);
    load_tile(Vs, ld, vb, k0, Sk, d);
    for (int i = threadIdx.x; i < FA_TILE; i += FA_THREADS)
      kp_s[i] = i < kn ? kpos[k0 + i] : 0;
    __syncthreads();
    tile_dot(Qs, Ks, ld, Ss, d);
    tile_dot(Os, Vs, ld, Ps, d);
    __syncthreads();
    probs_and_ds(Ss, Ps, lse_s, dl_s, qp_s, kp_s, qn, kn, mk);
    __syncthreads();
    acc_product(acc, Ps, S_LD, 1, Ks, ld, kn, nj);    // dq += dS k
    __syncthreads();
  }
  store_acc(acc, dq + qoff * d, q0, Sq, d, nullptr);
}

// one block per (k tile, kv head, b); the G query heads of that kv head and
// all their q tiles in a loop (the TPU's sequential (G, nq) axes)
template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int* __restrict__ qpos, const int* __restrict__ kpos,
                 T* __restrict__ dk, T* __restrict__ dv, int H, int KV,
                 int Sq, int Sk, int d, Mask mk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + Pad<T>::value;
  float* Ss = reinterpret_cast<float*>(smem);        // scores, then p
  float* Ps = Ss + FA_TILE * S_LD;                   // dO v^T, then dS
  float* lse_s = Ps + FA_TILE * S_LD;
  float* dl_s = lse_s + FA_TILE;
  int* qp_s = reinterpret_cast<int*>(dl_s + FA_TILE);
  int* kp_s = qp_s + FA_TILE;
  T* Qs = reinterpret_cast<T*>(kp_s + FA_TILE);
  T* Os = Qs + FA_TILE * ld;
  T* Ks = Os + FA_TILE * ld;
  T* Vs = Ks + FA_TILE * ld;

  const int k0 = blockIdx.x * FA_TILE, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int kn = min(FA_TILE, Sk - k0), nj = d / 16;
  const size_t koff = ((size_t)b * KV + kvh) * Sk * d;

  load_tile(Ks, ld, k + koff, k0, Sk, d);
  load_tile(Vs, ld, v + koff, k0, Sk, d);
  for (int i = threadIdx.x; i < FA_TILE; i += FA_THREADS)
    kp_s[i] = i < kn ? kpos[k0 + i] : 0;
  float acc_k[4][MAX_NJ], acc_v[4][MAX_NJ];
  zero_acc(acc_k);
  zero_acc(acc_v);

  for (int g = 0; g < G; ++g) {
    const size_t qoff = ((size_t)b * H + kvh * G + g) * Sq;
    for (int q0 = 0; q0 < Sq; q0 += FA_TILE) {
      const int qn = min(FA_TILE, Sq - q0);
      load_tile(Qs, ld, q + qoff * d, q0, Sq, d);
      load_tile(Os, ld, dout + qoff * d, q0, Sq, d);
      load_rows(lse_s, dl_s, qp_s, lse + qoff, delta + qoff, qpos, q0, Sq);
      __syncthreads();
      tile_dot(Qs, Ks, ld, Ss, d);
      tile_dot(Os, Vs, ld, Ps, d);
      __syncthreads();
      probs_and_ds(Ss, Ps, lse_s, dl_s, qp_s, kp_s, qn, kn, mk);
      __syncthreads();
      acc_product(acc_v, Ss, 1, S_LD, Os, ld, qn, nj);   // dv += p^T dO
      acc_product(acc_k, Ps, 1, S_LD, Qs, ld, qn, nj);   // dk += dS^T q
      __syncthreads();
    }
  }
  store_acc(acc_k, dk + koff, k0, Sk, d, nullptr);
  store_acc(acc_v, dv + koff, k0, Sk, d, nullptr);
}

// ---------------------------------------------------------------------------
// the bf16 forward on mma.sync (see the header): block (q tile, h, b), 4
// warps of 16 rows, the visited k tiles double-buffered through cp.async
// ---------------------------------------------------------------------------

constexpr int FB_THREADS = 128;     // 4 warps
constexpr int FB_GROUP = 16;        // query rows per warp (one m16 tile)
constexpr int FB_PAD = 8;           // bf16 elements of row padding (16 bytes)

// rows [row0, row0 + FA_TILE) of a (nrows, d) bf16 matrix into dst (stride
// ld) by cp.async, 16 bytes a copy; rows past nrows as 0
__device__ __forceinline__ void cp_tile(__nv_bfloat16* dst, int ld,
                                        const __nv_bfloat16* __restrict__ src,
                                        int row0, int nrows, int d) {
  const int chunks = d / 8;
  for (int c = threadIdx.x; c < FA_TILE * chunks; c += FB_THREADS) {
    const int r = c / chunks, col = (c - r * chunks) * 8;
    const bool in = row0 + r < nrows;
    sm90::cp_async16(dst + r * ld + col,
                     in ? src + (size_t)(row0 + r) * d + col : src, in);
  }
}

// k tile j's keys, values and key positions into stage st
__device__ __forceinline__ void cp_kv(__nv_bfloat16* Ks, __nv_bfloat16* Vs,
                                      int* kps, int ld, int st,
                                      const __nv_bfloat16* __restrict__ kb,
                                      const __nv_bfloat16* __restrict__ vb,
                                      const int* __restrict__ kpos, int j,
                                      int Sk, int d) {
  const int k0 = j * FA_TILE;
  cp_tile(Ks + st * FA_TILE * ld, ld, kb, k0, Sk, d);
  cp_tile(Vs + st * FA_TILE * ld, ld, vb, k0, Sk, d);
  if (threadIdx.x < FA_TILE) {
    const bool in = k0 + (int)threadIdx.x < Sk;
    sm90::cp_async4(kps + st * FA_TILE + threadIdx.x,
                    in ? kpos + k0 + threadIdx.x : kpos, in);
  }
}

// NJ = d / 16 and CAP (a softcap) are template arguments, so that every
// loop over the head dim and the softmax are straight-line code
template <int NJ, bool CAP>
__global__ void __launch_bounds__(FB_THREADS, 2)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kpos,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int H, int KV, int Sq, int Sk, Mask mk) {
  constexpr int d = 16 * NJ, ld = d + FB_PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nkt = (Sk + FA_TILE - 1) / FA_TILE;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + FA_TILE * ld;              // 2 stages
  __nv_bfloat16* Vs = Ks + 2 * FA_TILE * ld;          // 2 stages
  int* kps = reinterpret_cast<int*>(Vs + 2 * FA_TILE * ld);  // 2 stages
  int* flags = kps + 2 * FA_TILE;                     // nkt, then scratch

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_TILE;  // longest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t qoff = ((size_t)b * H + h) * Sq;
  const __nv_bfloat16* kb = k + ((size_t)b * KV + kvh) * Sk * d;
  const __nv_bfloat16* vb = v + ((size_t)b * KV + kvh) * Sk * d;

  cp_tile(Qs, ld, q + qoff * d, q0, Sq, d);    // in flight during the plan
  plan_k_tiles(qpos, kpos, q0, min(FA_TILE, Sq - q0), FB_GROUP, Sk, mk,
               flags, flags + nkt);
  int j = next_tile(flags, 0, nkt);
  if (j < nkt) cp_kv(Ks, Vs, kps, ld, 0, kb, vb, kpos, j, Sk, d);
  sm90::cp_async_commit();

  // scores are kept in base 2: s log2(e), so that p = exp2(s2 - m2); a
  // masked score stays NEG, and a row max of NEG (no allowed key) gives
  // lse = NEG + log(l) as in the reference
  constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;
  const float scale2 = CAP ? mk.scale : mk.scale * LOG2E;
  const float cap2 = mk.cap * LOG2E;
  // this thread's rows of the C fragments: ra = g, rb = g + 8 of its warp's
  const int ra = q0 + FB_GROUP * warp + g, rb = ra + 8;
  const int qpa = ra < Sq ? qpos[ra] : 0, qpb = rb < Sq ? qpos[rb] : 0;
  float ma = NEG, mb = NEG, la = 0.f, lb = 0.f;  // la, lb: this lane's part
  float oacc[2 * NJ][4];
#pragma unroll
  for (int n = 0; n < 2 * NJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  uint32_t qf[NJ][4];
  // ldmatrix lane offsets: A (and V^T) tiles, and K tiles (B fragments)
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);

  for (int st = 0, first = 1; j < nkt; st ^= 1, first = 0) {
    const int jn = next_tile(flags, j + 1, nkt);
    if (jn < nkt) cp_kv(Ks, Vs, kps, ld, st ^ 1, kb, vb, kpos, jn, Sk, d);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();                    // tile j (and q) landed
    __syncthreads();
    if (first) {
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk)
        sm90::ldmatrix_x4(qf[kk], Qs + (FB_GROUP * warp + a_row) * ld +
                                      16 * kk + a_col);
    }
    const int code = (flags[j] >> (2 * warp)) & 3;   // this warp's rows
    if (code) {
      const __nv_bfloat16* Kt = Ks + st * FA_TILE * ld;
      const __nv_bfloat16* Vt = Vs + st * FA_TILE * ld;

      // s = q k^T: 16 rows x 64 keys per warp, 8 fragments of 8 keys
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];
          sm90::ldmatrix_x4(bf, Kt + (16 * np + b_row) * ld + 16 * kk + b_col);
          sm90::mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
          sm90::mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
        }
      }

      // scale, cap, then in base 2 (x log2 e); the mask (NEG, as in the
      // reference) and the ragged edge (-inf) unless the warp's rows see
      // every key of the tile
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale2;
          if (CAP) x = cap2 * tanhf(x / mk.cap);
          s[n][e] = x;
        }
      if (code == 1) {
        const int* kp = kps + st * FA_TILE;
        const int kn = min(FA_TILE, Sk - j * FA_TILE);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * n + 2 * t + (e & 1);
            s[n][e] = c < kn ? (allowed(e < 2 ? qpa : qpb, kp[c], mk)
                                    ? s[n][e] : NEG)
                             : neg_inf();
          }
      }

      // online softmax with exp2
      float xa = ma, xb = mb;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        xa = fmaxf(xa, fmaxf(s[n][0], s[n][1]));
        xb = fmaxf(xb, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, off));
        xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, off));
      }
      const float alpha_a = exp2f(ma - xa), alpha_b = exp2f(mb - xb);
      ma = xa;
      mb = xb;
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[n][0] = exp2f(s[n][0] - ma);
        s[n][1] = exp2f(s[n][1] - ma);
        s[n][2] = exp2f(s[n][2] - mb);
        s[n][3] = exp2f(s[n][3] - mb);
        sa += s[n][0] + s[n][1];
        sb += s[n][2] + s[n][3];
      }
      la = la * alpha_a + sa;
      lb = lb * alpha_b + sb;
#pragma unroll
      for (int n = 0; n < 2 * NJ; ++n) {
        oacc[n][0] *= alpha_a;
        oacc[n][1] *= alpha_a;
        oacc[n][2] *= alpha_b;
        oacc[n][3] *= alpha_b;
      }

      // o += p v with p = hi + lo, each a bf16 A fragment made from the
      // score fragments of 16 keys; every V fragment feeds 2 products
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ph[4], pl[4];
        sm90::split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        sm90::split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        sm90::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        sm90::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < NJ; ++np) {
          uint32_t bf[4];
          sm90::ldmatrix_x4_trans(
              bf, Vt + (16 * kk + a_row) * ld + 16 * np + a_col);
          sm90::mma_bf16(oacc[2 * np], pl, bf[0], bf[1]);
          sm90::mma_bf16(oacc[2 * np + 1], pl, bf[2], bf[3]);
          sm90::mma_bf16(oacc[2 * np], ph, bf[0], bf[1]);
          sm90::mma_bf16(oacc[2 * np + 1], ph, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();                 // stage st is refilled next iteration
    j = jn;
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, off);
    lb += __shfl_xor_sync(0xffffffffu, lb, off);
  }
  __nv_bfloat16* ob = o + qoff * d;
#pragma unroll
  for (int n = 0; n < 2 * NJ; ++n) {
    const int c = 8 * n + 2 * t;
    if (ra < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)ra * d + c) =
          sm90::pack_bf16(oacc[n][0] / la, oacc[n][1] / la);
    if (rb < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)rb * d + c) =
          sm90::pack_bf16(oacc[n][2] / lb, oacc[n][3] / lb);
  }
  if (t == 0) {
    if (ra < Sq) lse[qoff + ra] = (ma == NEG ? NEG : ma * LN2) + logf(la);
    if (rb < Sq) lse[qoff + rb] = (mb == NEG ? NEG : mb * LN2) + logf(lb);
  }
}

int check_shape(int B, int H, int KV, int Sq, int Sk, int d) {
  if (B < 0 || Sq < 0 || Sk < 1 || KV < 1 || H < KV || H % KV ||
      d < 16 || d > 16 * MAX_NJ || d % 16)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// a kernel's dynamic shared memory: score_tiles f32 score tiles, then
// row_arrays 64-entry f32 or int arrays, then in_tiles input tiles (each
// part a multiple of 32 bytes, so the WMMA operands stay aligned)
template <typename T>
size_t smem_bytes(int d, int score_tiles, int row_arrays, int in_tiles) {
  return (size_t)score_tiles * FA_TILE * S_LD * sizeof(float) +
         (size_t)row_arrays * FA_TILE * sizeof(float) +
         (size_t)in_tiles * FA_TILE * (d + Pad<T>::value) * sizeof(T);
}

// raise a kernel's dynamic shared memory limit to bytes the first time it
// needs it (granted is the caller's static), so that a launch under
// CUDA-graph capture makes no attribute call
template <typename K>
int set_smem(K kernel, size_t bytes, size_t& granted) {
  if (bytes <= granted) return 0;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == 0) granted = bytes;
  return rc;
}

// the forward's tile flags and plan scratch after its other shared memory
size_t plan_bytes(int Sk) {
  return (size_t)((Sk + FA_TILE - 1) / FA_TILE + 3 * PLAN_GROUPS) *
         sizeof(int);
}

int launch_fwd_f32(const void* q, const void* k, const void* v,
                   const void* qpos, const void* kpos, void* o, void* lse,
                   int B, int H, int KV, int Sq, int Sk, int d, Mask mk,
                   void* stream) {
  if (int rc = check_shape(B, H, KV, Sq, Sk, d)) return rc;
  if (B == 0 || Sq == 0) return 0;
  const size_t bytes = smem_bytes<float>(d, 1, 5, 3) + plan_bytes(Sk);
  static size_t granted = 0;
  if (int rc = set_smem(flash_fwd_kernel<float>, bytes, granted)) return rc;
  const dim3 grid((Sq + FA_TILE - 1) / FA_TILE, H, B);
  flash_fwd_kernel<float><<<grid, FA_THREADS, bytes,
                            (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)qpos,
      (const int*)kpos, (float*)o, (float*)lse, H, KV, Sq, Sk, d, mk);
  return (int)cudaGetLastError();
}

template <int NJ, bool CAP>
int launch_fwd_bf16_t(const void* q, const void* k, const void* v,
                      const void* qpos, const void* kpos, void* o, void* lse,
                      int B, int H, int KV, int Sq, int Sk, Mask mk,
                      cudaStream_t stream) {
  const size_t bytes = (size_t)5 * FA_TILE * (16 * NJ + FB_PAD) *
                           sizeof(__nv_bfloat16) +
                       2 * FA_TILE * sizeof(int) + plan_bytes(Sk);
  static size_t granted = 0;
  const auto kernel = flash_fwd_bf16_kernel<NJ, CAP>;
  if (int rc = set_smem(kernel, bytes, granted)) return rc;
  const dim3 grid((Sq + FA_TILE - 1) / FA_TILE, H, B);
  kernel<<<grid, FB_THREADS, bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)qpos, (const int*)kpos,
      (__nv_bfloat16*)o, (float*)lse, H, KV, Sq, Sk, mk);
  return (int)cudaGetLastError();
}

template <int NJ>
int launch_fwd_bf16_d(const void* q, const void* k, const void* v,
                      const void* qpos, const void* kpos, void* o, void* lse,
                      int B, int H, int KV, int Sq, int Sk, Mask mk,
                      cudaStream_t stream) {
  return mk.use_cap ? launch_fwd_bf16_t<NJ, true>(q, k, v, qpos, kpos, o,
                                                  lse, B, H, KV, Sq, Sk, mk,
                                                  stream)
                    : launch_fwd_bf16_t<NJ, false>(q, k, v, qpos, kpos, o,
                                                   lse, B, H, KV, Sq, Sk, mk,
                                                   stream);
}

int launch_fwd_bf16(const void* q, const void* k, const void* v,
                    const void* qpos, const void* kpos, void* o, void* lse,
                    int B, int H, int KV, int Sq, int Sk, int d, Mask mk,
                    void* stream) {
  if (int rc = check_shape(B, H, KV, Sq, Sk, d)) return rc;
  if (B == 0 || Sq == 0) return 0;
  // cp.async moves 16-byte pieces: rows of d bf16 (d % 16 == 0) stay
  // aligned if the bases are; positions move 4 bytes at a time
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 ||
      ((uintptr_t)qpos | (uintptr_t)kpos) % 4)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d / 16) {
#define FA_HEAD_DIM(nj)                                                   \
  case nj:                                                                \
    return launch_fwd_bf16_d<nj>(q, k, v, qpos, kpos, o, lse, B, H, KV, Sq, \
                                 Sk, mk, s);
    FA_HEAD_DIM(1) FA_HEAD_DIM(2) FA_HEAD_DIM(3) FA_HEAD_DIM(4)
    FA_HEAD_DIM(5) FA_HEAD_DIM(6) FA_HEAD_DIM(7) FA_HEAD_DIM(8)
#undef FA_HEAD_DIM
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* qpos,
              const void* kpos, void* dq, int B, int H, int KV, int Sq,
              int Sk, int d, Mask mk, void* stream) {
  if (int rc = check_shape(B, H, KV, Sq, Sk, d)) return rc;
  if (B == 0 || Sq == 0) return 0;
  const size_t bytes = smem_bytes<T>(d, 2, 4, 4);
  static size_t granted = 0;
  if (int rc = set_smem(flash_dq_kernel<T>, bytes, granted)) return rc;
  const dim3 grid((Sq + FA_TILE - 1) / FA_TILE, H, B);
  flash_dq_kernel<T><<<grid, FA_THREADS, bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (const int*)qpos,
      (const int*)kpos, (T*)dq, H, KV, Sq, Sk, d, mk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* qpos,
               const void* kpos, void* dk, void* dv, int B, int H, int KV,
               int Sq, int Sk, int d, Mask mk, void* stream) {
  if (int rc = check_shape(B, H, KV, Sq, Sk, d)) return rc;
  if (B == 0) return 0;
  const size_t bytes = smem_bytes<T>(d, 2, 4, 4);
  static size_t granted = 0;
  if (int rc = set_smem(flash_dkv_kernel<T>, bytes, granted)) return rc;
  const dim3 grid((Sk + FA_TILE - 1) / FA_TILE, KV, B);
  flash_dkv_kernel<T><<<grid, FA_THREADS, bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (const int*)qpos,
      (const int*)kpos, (T*)dk, (T*)dv, H, KV, Sq, Sk, d, mk);
  return (int)cudaGetLastError();
}

}  // namespace

#define FA_MASK_ARGS                                                    \
  float scale, int causal, int window, int use_window, float cap,      \
      int use_cap, void* stream
#define FA_MASK Mask{scale, causal, window, use_window, cap, use_cap}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* qpos, const void* kpos, void* o,
                              void* lse, int B, int H, int KV, int Sq,
                              int Sk, int d, FA_MASK_ARGS) {
  return launch_fwd_bf16(q, k, v, qpos, kpos, o, lse, B, H, KV, Sq, Sk, d,
                         FA_MASK, stream);
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             const void* qpos, const void* kpos, void* o,
                             void* lse, int B, int H, int KV, int Sq, int Sk,
                             int d, FA_MASK_ARGS) {
  return launch_fwd_f32(q, k, v, qpos, kpos, o, lse, B, H, KV, Sq, Sk, d,
                        FA_MASK, stream);
}

extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* qpos,
                             const void* kpos, void* dq, int B, int H, int KV,
                             int Sq, int Sk, int d, FA_MASK_ARGS) {
  return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, qpos, kpos, dq,
                                  B, H, KV, Sq, Sk, d, FA_MASK, stream);
}

extern "C" int flash_dq_f32(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* qpos,
                            const void* kpos, void* dq, int B, int H, int KV,
                            int Sq, int Sk, int d, FA_MASK_ARGS) {
  return launch_dq<float>(q, k, v, dout, lse, delta, qpos, kpos, dq, B, H,
                          KV, Sq, Sk, d, FA_MASK, stream);
}

extern "C" int flash_dkv_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* qpos,
                              const void* kpos, void* dk, void* dv, int B,
                              int H, int KV, int Sq, int Sk, int d,
                              FA_MASK_ARGS) {
  return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, qpos, kpos, dk,
                                   dv, B, H, KV, Sq, Sk, d, FA_MASK, stream);
}

extern "C" int flash_dkv_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* qpos,
                             const void* kpos, void* dk, void* dv, int B,
                             int H, int KV, int Sq, int Sk, int d,
                             FA_MASK_ARGS) {
  return launch_dkv<float>(q, k, v, dout, lse, delta, qpos, kpos, dk, dv, B,
                           H, KV, Sq, Sk, d, FA_MASK, stream);
}
