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
// Tile skip.  A masked key gives p = exp(NEG - m): 0 once its row has met
// an allowed key, wiped by alpha = exp(NEG - m) = 0 when it meets one
// later, but 1 for a row with no allowed key at all (lse = NEG + log Sk =
// NEG in f32, so p = exp(NEG - NEG) = 1 for every key slot, as the
// reference gives it).  So each block first reads the positions.  The
// forward and dq (plan_k_tiles): a group of q rows with a row that has no
// allowed key visits every k tile; else the tiles that hold a valid key
// between its rows' lowest and highest allowed positions.  dk/dv
// (plan_q_tiles): a k tile visits the q tiles by the same rule seen from
// the keys, and also, for dv only, a q tile holding a row with no allowed
// key (its dO lands in dv of every key; its dS is 0).  The rules read the
// positions only, so invalid slots (kpos < 0), q offset against k,
// windows and shuffled positions are exact.  At the causal training shape
// each kernel visits 136 of the 256 (q tile, k tile) pairs of 64x64 per
// (b, h).
//
// bf16 kernels (redesigned for Hopper): 64 rows (queries, or keys for
// dk/dv) per block and 4 warps of 16, FlashAttention-2 style on mma.sync
// m16n8k16.  Products accumulate in f32 registers, and the accumulator
// fragments of the scores become the A operands of the next product
// without a trip through shared memory.  The products of p and dS keep
// them in f32 through a split x = hi + lo into two bf16 values (hi =
// bf16(x), lo = bf16(x - hi)): two bf16 products with exact f32 partial
// products and f32 sums, leaving |x - hi - lo| <= 2^-16 |x|, 256 times
// below a bf16 output's unit roundoff (2^-8).  Scores are kept in base 2
// (s log2 e), so each p is one exp2; a tile in which every (row, key) pair
// of a warp is allowed skips the mask.  The head dim and the softcap are
// template arguments, so the loops are straight-line code.  The tiles a
// block walks (K and V for the forward and dq; q, dO, lse, delta and q
// positions for dk/dv) arrive by cp.async into a double buffer: the copy
// of the next visited tile runs under the products of this one.  Rows are
// padded by 16 bytes in shared memory, so ldmatrix reads hit no bank
// twice.
// Head dims: multiples of 16 up to 128, 120 (h2o-danube3: padded to 128
// zeroed columns in shared memory, the last 8-column fragment of o, dq, dk
// and dv neither computed nor stored) and 256 (gemma2: two warps per 16
// rows, each keeping the outputs of its half of the head dim), in every
// kernel.
//   forward (flash_fwd_bf16_kernel): q stays in registers up to d = 128;
//     the online softmax in registers; P V as (hi + lo) V.  At d = 256
//     each warp of a pair sums q k^T over its half of the head dim and
//     the pair adds the partial scores through shared memory.
// The backward sums each 32 rows of its p and dS products in a fresh
// fragment and adds that to its f32 accumulators: an mma that adds into a
// large accumulator truncates at its last bits, so a long sum held there
// drifts (by a bf16 ulp of dv where every key carries many fully masked
// rows' dO).
//   dq (flash_dq_bf16_kernel): S = q k^T and dP = dO v^T per visited k
//     tile, q and dO read as A fragments from shared memory; dS in
//     registers; dq += (hi + lo) k with k read through ldmatrix.trans.
//   dk/dv (flash_dkv_bf16_kernel): keys are the M dimension.  Per visited
//     q tile, in two halves of 32 queries, S^T = K Q^T and dP^T = V dO^T;
//     p^T and dS^T per column (lse, delta and the q position come with the
//     q tile); dv += (hi + lo) dO and dk += (hi + lo) q, dO and q read
//     through ldmatrix.trans.  Each warp keeps dk and dv of its 16 keys in
//     f32 registers over the G query heads of its kv head and their q
//     tiles: no atomics, and the result does not depend on run order.
//   At d = 256 (BwdShape) the two warps of a pair compute the same scores
//     over the whole head dim and each keeps dq, or dk and dv, for its
//     128 columns: d = 128's registers; the six tiles take 203 KB.
//
// f32 forward, dq and dk/dv (simple and right first): a 64-row tile of
// queries or keys per block, 256 threads.  The TPU grid's sequential axes
// become loops inside the block over the tiles the rules above visit.
// Tiles of q, k, v and dO sit in dynamic shared memory with the 64x64
// f32 score tiles: the forward's three resident (212 KB at d = 256), dq's
// and dk/dv's four streamed through two (167 KB at d = 256), the
// gradients' columns split in chunks of 128 over blocks.  Every product
// is f32 FMAs (never TF32).
// Keys past Sk (the ragged edge) count as nothing.
//
// Built whole (FA_PART unset: flash_ab.py builds a version so) or in
// parts, one nvcc each, all at once (kernels/build.py's FLASH_PARTS = 5:
// the 60 bf16 instances take most of the library's build): part 0 holds
// the entry points, the f32 kernels and the bf16 instances of head dims
// 16 and 32; parts 1-4 those of 48..80, of 96 and 112, of 120 and 128,
// and of 256, each behind its extern "C" fa_bf16_part<p>, which part 0
// calls.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

#ifndef FA_PART
#define FA_PART -1
#endif

extern "C" int fa_bf16_part1(int kind, const void* args);
extern "C" int fa_bf16_part2(int kind, const void* args);
extern "C" int fa_bf16_part3(int kind, const void* args);
extern "C" int fa_bf16_part4(int kind, const void* args);

namespace {

// the part that builds the bf16 instances of head dim d, and whether this
// translation unit builds them
constexpr int fa_part_of(int d) {
  return d <= 32 ? 0 : d <= 80 ? 1 : d <= 112 ? 2 : d == 256 ? 4 : 3;
}
constexpr bool fa_local(int d) { return FA_PART < 0 || fa_part_of(d) == FA_PART; }

constexpr int FA_TILE = 64;         // rows of a q tile and of a k tile
constexpr int FA_THREADS = 256;     // 8 warps (f32 kernels)
constexpr int S_LD = FA_TILE + 4;   // row stride of the f32 score tiles
constexpr int F_LD_PAD = 1;         // f32 rows: an odd stride, no bank twice
constexpr int MAX_NJ = 8;           // 16-column groups a warp (bf16) or an
                                    // f32 backward block accumulates
constexpr int FWD_NJ = 16;          // the f32 forward's: column groups at
                                    // d = 256
constexpr float NEG = -1e30f;
constexpr int INT_HI = 0x7fffffff, INT_LO = -0x7fffffff - 1;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

struct Mask {
  float scale;
  int causal, window, use_window;
  float cap;
  int use_cap;
};

// blocks per row tile of an f32 backward at head dim d: one for each 16
// MAX_NJ columns of the gradients
__host__ __device__ constexpr int f32_chunks(int d) {
  return (d + 16 * MAX_NJ - 1) / (16 * MAX_NJ);
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

// whether a query at position qp has an allowed key among kpos[0, Sk): the
// warp scans 32 keys a step and stops at the first step that finds one
__device__ bool row_has_key(int qp, const int* __restrict__ kpos, int Sk,
                            const Mask& mk) {
  const int lane = threadIdx.x % 32;
  for (int c0 = 0; c0 < Sk; c0 += 32) {
    const int c = c0 + lane;
    if (__any_sync(0xffffffffu, c < Sk && allowed(qp, kpos[c], mk)))
      return true;
  }
  return false;
}

// whether some key position kp of the k tile [k0, k0 + FA_TILE) may be
// seen by a row of q positions [qmin, qmax] (any) and whether every one is
// seen by every row (every; all FA_TILE keys valid, kp <= qmin, kp > qmax -
// window): the superset rule of both plans; warp-collective.  plan_k_tiles
// spells this rule and row_has_key out inline: through these helpers the
// bf16 forward and dq ran 5% and 8% slower on an H100 (flash_ab.py at the
// causal training shape)
__device__ __forceinline__ void tile_pairs(const int* __restrict__ kpos,
                                           int k0, int Sk, long long qmin,
                                           long long qmax, const Mask& mk,
                                           bool& any, bool& every) {
  const int lane = threadIdx.x % 32;
  any = false;
  every = true;
  for (int c = k0 + lane; c < k0 + FA_TILE; c += 32) {
    const int kp = c < Sk ? kpos[c] : -1;
    any |= kp >= 0 && (!mk.causal || kp <= qmax) &&
           (!mk.use_window || kp > qmin - mk.window);
    every &= kp >= 0 && (!mk.causal || kp <= qmin) &&
             (!mk.use_window || kp > qmax - mk.window);
  }
  any = __any_sync(0xffffffffu, any);
  every = __all_sync(0xffffffffu, every);
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

// Whether each q tile (of FA_TILE rows) holds a row with no allowed key
// among kpos[0, Sk), in nokey[i]: one block per q tile, a warp per row.
// Run once before dk/dv, whose every block needs the answer for every q
// tile: a row's scan reads keys up to its first allowed one, so all rows
// take up to Sq Sk / 32 warp steps, which a scan in each dk/dv block
// repeated over the grid (under h2o-danube3's window of 4096 at S = 8192,
// several times dk/dv's own work)
__global__ void __launch_bounds__(FA_THREADS)
plan_nokey_kernel(const int* __restrict__ qpos,
                  const int* __restrict__ kpos, int Sq, int Sk, Mask mk,
                  int* __restrict__ nokey) {
  __shared__ int found;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * FA_TILE, r1 = min(Sq, q0 + FA_TILE);
  if (threadIdx.x == 0) found = 0;
  __syncthreads();
  for (int r = q0 + warp; r < r1; r += FA_THREADS / 32)
    if (!row_has_key(qpos[r], kpos, Sk, mk) && lane == 0) found = 1;
  __syncthreads();
  if (threadIdx.x == 0) nokey[blockIdx.x] = found;
}

// The q tiles (of FA_TILE rows) the dk/dv block of k tile [k0, k0 +
// FA_TILE) visits, as a code per q tile in flags[i] (i < ceil(Sq /
// FA_TILE)): 0 skip, 1 visit, 2 visit and no mask needed (the codes of
// plan_k_tiles, by the same rule with the q tile's lowest and highest
// positions), 3 visit for dv only: a q tile that would be skipped but
// holds a row with no allowed key at all (nokey, from plan_nokey_kernel).
// The reference's dk/dv uses p unmasked, and such a row's lse is NEG, so
// its p is 1 for every key slot and its dO lands in dv of every key; its
// dS is 0.  Ends with a barrier.  Mirrored by
// kernels/flash_attention.py:visited_q_tiles.
__device__ void plan_q_tiles(const int* __restrict__ qpos,
                             const int* __restrict__ kpos,
                             const int* __restrict__ nokey, int k0, int Sq,
                             int Sk, const Mask& mk, int* flags) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32, nqt = (Sq + FA_TILE - 1) / FA_TILE;
  for (int i = warp; i < nqt; i += nw) {
    const int r1 = min(Sq, (i + 1) * FA_TILE);
    int qmin = INT_HI, qmax = INT_LO;
    for (int r = i * FA_TILE + lane; r < r1; r += 32) {
      const int qp = qpos[r];
      qmin = min(qmin, qp);
      qmax = max(qmax, qp);
    }
    qmin = __reduce_min_sync(0xffffffffu, qmin);
    qmax = __reduce_max_sync(0xffffffffu, qmax);
    bool any, every;
    tile_pairs(kpos, k0, Sk, qmin, qmax, mk, any, every);
    if (lane == 0) flags[i] = every ? 2 : any ? 1 : nokey[i] ? 3 : 0;
  }
  __syncthreads();
}

// the first visited tile at or after j (n when none is left)
__device__ __forceinline__ int next_tile(const int* flags, int j, int n) {
  while (j < n && !flags[j]) ++j;
  return j;
}

#if FA_PART <= 0
// ---------------------------------------------------------------------------
// the f32 kernels: 256 threads, f32 FMAs, tiles through shared memory
// ---------------------------------------------------------------------------

// rows [row0, row0 + FA_TILE) of a (nrows, d) matrix into dst (stride ld);
// rows past nrows as 0
__device__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                          int row0, int nrows, int d) {
  for (int i = threadIdx.x; i < FA_TILE * d; i += FA_THREADS) {
    const int r = i / d, c = i - r * d;
    dst[r * ld + c] = row0 + r < nrows ? src[(size_t)(row0 + r) * d + c] : 0.f;
  }
}

// S[r][c] = sum_k A[r][k] * B[c][k] over a 64x64 tile
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

// acc[i][j] += sum_{t < n} P[r_i * prs + t * pts] * X[t][c_j], for the
// thread's rows r_i = rg + 16 i and columns c_j = cg + 16 j (j < nj)
template <int N>
__device__ __forceinline__ void acc_product(float (&acc)[4][N],
                                            const float* P, int prs, int pts,
                                            const float* X, int ld, int n,
                                            int nj) {
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  for (int t = 0; t < n; ++t) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(rg + 16 * i) * prs + t * pts];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < nj) {
        const float x = X[t * ld + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[4][N]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
}

// acc rows (row0 + r_i < nrows) into columns c0 + ... (< d) of out (nrows,
// d) rows, divided by div[r] when div is given
template <int N>
__device__ __forceinline__ void store_acc(const float (&acc)[4][N],
                                          float* out, int row0, int nrows,
                                          int d, const float* div,
                                          int c0 = 0) {
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    if (row0 + r >= nrows) continue;
    const float l = div ? div[r] : 1.f;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (c0 + cg + 16 * j < d)
        out[(size_t)(row0 + r) * d + c0 + cg + 16 * j] =
            div ? acc[i][j] / l : acc[i][j];
  }
}

// one block per (q tile, h, b); the visited k tiles in a loop (the TPU's
// nk axis).  Head dims up to 16 FWD_NJ = 256
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, float* __restrict__ o,
                 float* __restrict__ lse, int H, int KV, int Sq, int Sk,
                 int d, Mask mk) {
  extern __shared__ __align__(128) unsigned char smem[];
  // rows of 16 ceil(d / 16) columns (+ the pad): p v reads whole 16-column
  // groups of V, and the columns past d (zeroed below) add nothing
  const int ld = 16 * ((d + 15) / 16) + F_LD_PAD;
  float* Ss = reinterpret_cast<float*>(smem);        // scores, then p
  float* m_s = Ss + FA_TILE * S_LD;                  // running max
  float* l_s = m_s + FA_TILE;                        // running sum
  float* a_s = l_s + FA_TILE;                        // this tile's alpha
  int* qp_s = reinterpret_cast<int*>(a_s + FA_TILE);
  int* kp_s = qp_s + FA_TILE;
  float* Qs = reinterpret_cast<float*>(kp_s + FA_TILE);
  float* Ks = Qs + FA_TILE * ld;
  float* Vs = Ks + FA_TILE * ld;
  int* flags = reinterpret_cast<int*>(Vs + FA_TILE * ld);
  const int nkt = (Sk + FA_TILE - 1) / FA_TILE;

  const int q0 = blockIdx.x * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = tid / 16, nj = (d + 15) / 16;
  const float* qb = q + ((size_t)b * H + h) * Sq * d;
  const float* kb = k + ((size_t)b * KV + kvh) * Sk * d;
  const float* vb = v + ((size_t)b * KV + kvh) * Sk * d;

  load_tile(Qs, ld, qb, q0, Sq, d);
  for (int i = tid; i < FA_TILE * (ld - d); i += FA_THREADS)
    Vs[(i / (ld - d)) * ld + d + i % (ld - d)] = 0.f;
  for (int i = tid; i < FA_TILE; i += FA_THREADS) {
    qp_s[i] = q0 + i < Sq ? qpos[q0 + i] : 0;
    m_s[i] = NEG;
    l_s[i] = 0.f;
  }
  float acc[4][FWD_NJ];
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
      for (int j = 0; j < FWD_NJ; ++j) acc[i][j] *= alpha;
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

// one block per (q tile, column chunk, h, b) (the chunk the fastest of the
// x index); the k tiles plan_k_tiles visits in a loop.  q, dO, k and v
// stream through two tiles, q then dO in one, k then v then k again in the
// other, reloaded per k tile (four resident tiles of 64 x 257 f32 would be
// 263 KB at d = 256, past the 227 KB a block may have), and dq is split in
// chunks of 16 MAX_NJ columns, a block each, so that the accumulator stays
// 4 MAX_NJ registers
__global__ void __launch_bounds__(FA_THREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int* __restrict__ qpos, const int* __restrict__ kpos,
                float* __restrict__ dq, int H, int KV, int Sq, int Sk, int d,
                Mask mk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = 16 * ((d + 15) / 16) + F_LD_PAD;
  float* Ss = reinterpret_cast<float*>(smem);        // scores, then p
  float* Ps = Ss + FA_TILE * S_LD;                   // dO v^T, then dS
  float* lse_s = Ps + FA_TILE * S_LD;
  float* dl_s = lse_s + FA_TILE;
  int* qp_s = reinterpret_cast<int*>(dl_s + FA_TILE);
  int* kp_s = qp_s + FA_TILE;
  float* Xs = reinterpret_cast<float*>(kp_s + FA_TILE);  // q, then dO
  float* Ys = Xs + FA_TILE * ld;                     // k, then v, then k
  int* flags = reinterpret_cast<int*>(Ys + FA_TILE * ld);
  const int nkt = (Sk + FA_TILE - 1) / FA_TILE;

  const int nch = f32_chunks(d);
  const int c0 = 16 * MAX_NJ * (blockIdx.x % nch);  // the block's columns
  const int q0 = blockIdx.x / nch * FA_TILE, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int qn = min(FA_TILE, Sq - q0);
  const int nj = min(MAX_NJ, (d - c0 + 15) / 16);
  const size_t qoff = ((size_t)b * H + h) * Sq;
  const float* kb = k + ((size_t)b * KV + kvh) * Sk * d;
  const float* vb = v + ((size_t)b * KV + kvh) * Sk * d;

  // the pad columns the products read (d = 120): 0 throughout
  for (int i = threadIdx.x; i < 2 * FA_TILE * (ld - d); i += FA_THREADS)
    Xs[(i / (ld - d)) * ld + d + i % (ld - d)] = 0.f;
  load_rows(lse_s, dl_s, qp_s, lse + qoff, delta + qoff, qpos, q0, Sq);
  float acc[4][MAX_NJ];
  zero_acc(acc);
  plan_k_tiles(qpos, kpos, q0, qn, FA_TILE, Sk, mk, flags, flags + nkt);

  for (int j = next_tile(flags, 0, nkt); j < nkt;
       j = next_tile(flags, j + 1, nkt)) {
    const int k0 = j * FA_TILE, kn = min(FA_TILE, Sk - k0);
    for (int i = threadIdx.x; i < FA_TILE; i += FA_THREADS)
      kp_s[i] = i < kn ? kpos[k0 + i] : 0;
    load_tile(Xs, ld, q + qoff * d, q0, Sq, d);
    load_tile(Ys, ld, kb, k0, Sk, d);
    __syncthreads();
    tile_dot(Xs, Ys, ld, Ss, d);                       // s = q k^T
    __syncthreads();
    load_tile(Xs, ld, dout + qoff * d, q0, Sq, d);
    load_tile(Ys, ld, vb, k0, Sk, d);
    __syncthreads();
    tile_dot(Xs, Ys, ld, Ps, d);                       // dO v^T
    __syncthreads();
    probs_and_ds(Ss, Ps, lse_s, dl_s, qp_s, kp_s, qn, kn, mk);
    load_tile(Ys, ld, kb, k0, Sk, d);
    __syncthreads();
    acc_product(acc, Ps, S_LD, 1, Ys + c0, ld, kn, nj);    // dq += dS k
    __syncthreads();
  }
  store_acc(acc, dq + qoff * d, q0, Sq, d, nullptr, c0);
}

// one block per (k tile, column chunk, kv head, b); the G query heads of
// that kv head and the q tiles plan_q_tiles visits in a loop (the TPU's
// sequential (G, nq) axes).  The operands stream through two tiles as in
// dq: q then dO then q again in one, k then v in the other, per q tile;
// dk and dv in chunks of 16 MAX_NJ columns, a block each
__global__ void __launch_bounds__(FA_THREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int* __restrict__ qpos, const int* __restrict__ kpos,
                 const int* __restrict__ nokey, float* __restrict__ dk,
                 float* __restrict__ dv, int H, int KV, int Sq, int Sk,
                 int d, Mask mk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = 16 * ((d + 15) / 16) + F_LD_PAD;
  float* Ss = reinterpret_cast<float*>(smem);        // scores, then p
  float* Ps = Ss + FA_TILE * S_LD;                   // dO v^T, then dS
  float* lse_s = Ps + FA_TILE * S_LD;
  float* dl_s = lse_s + FA_TILE;
  int* qp_s = reinterpret_cast<int*>(dl_s + FA_TILE);
  int* kp_s = qp_s + FA_TILE;
  float* Xs = reinterpret_cast<float*>(kp_s + FA_TILE);  // q, dO, q
  float* Ys = Xs + FA_TILE * ld;                     // k, then v
  int* flags = reinterpret_cast<int*>(Ys + FA_TILE * ld);
  const int nqt = (Sq + FA_TILE - 1) / FA_TILE;

  const int nch = f32_chunks(d);
  const int c0 = 16 * MAX_NJ * (blockIdx.x % nch);  // the block's columns
  const int k0 = blockIdx.x / nch * FA_TILE, kvh = blockIdx.y;
  const int b = blockIdx.z, G = H / KV;
  const int kn = min(FA_TILE, Sk - k0);
  const int nj = min(MAX_NJ, (d - c0 + 15) / 16);
  const size_t koff = ((size_t)b * KV + kvh) * Sk * d;

  // the pad columns the products read (d = 120): 0 throughout
  for (int i = threadIdx.x; i < 2 * FA_TILE * (ld - d); i += FA_THREADS)
    Xs[(i / (ld - d)) * ld + d + i % (ld - d)] = 0.f;
  for (int i = threadIdx.x; i < FA_TILE; i += FA_THREADS)
    kp_s[i] = i < kn ? kpos[k0 + i] : 0;
  float acc_k[4][MAX_NJ], acc_v[4][MAX_NJ];
  zero_acc(acc_k);
  zero_acc(acc_v);
  plan_q_tiles(qpos, kpos, nokey, k0, Sq, Sk, mk, flags);

  for (int g = 0; g < G; ++g) {
    const size_t qoff = ((size_t)b * H + kvh * G + g) * Sq;
    for (int i = next_tile(flags, 0, nqt); i < nqt;
         i = next_tile(flags, i + 1, nqt)) {
      const int q0 = i * FA_TILE, qn = min(FA_TILE, Sq - q0);
      load_tile(Xs, ld, q + qoff * d, q0, Sq, d);
      load_tile(Ys, ld, k + koff, k0, Sk, d);
      load_rows(lse_s, dl_s, qp_s, lse + qoff, delta + qoff, qpos, q0, Sq);
      __syncthreads();
      tile_dot(Xs, Ys, ld, Ss, d);                     // s = q k^T
      __syncthreads();
      load_tile(Xs, ld, dout + qoff * d, q0, Sq, d);
      load_tile(Ys, ld, v + koff, k0, Sk, d);
      __syncthreads();
      tile_dot(Xs, Ys, ld, Ps, d);                     // dO v^T
      __syncthreads();
      probs_and_ds(Ss, Ps, lse_s, dl_s, qp_s, kp_s, qn, kn, mk);
      __syncthreads();
      acc_product(acc_v, Ss, 1, S_LD, Xs + c0, ld, qn, nj);  // dv += p^T dO
      __syncthreads();
      load_tile(Xs, ld, q + qoff * d, q0, Sq, d);
      __syncthreads();
      acc_product(acc_k, Ps, 1, S_LD, Xs + c0, ld, qn, nj);  // dk += dS^T q
      __syncthreads();
    }
  }
  store_acc(acc_k, dk + koff, k0, Sk, d, nullptr, c0);
  store_acc(acc_v, dv + koff, k0, Sk, d, nullptr, c0);
}
#endif  // FA_PART <= 0

// ---------------------------------------------------------------------------
// the bf16 kernels on mma.sync (see the header): 64 rows per block, 4
// warps of 16, the walked tiles double-buffered through cp.async
// ---------------------------------------------------------------------------

constexpr int FB_THREADS = 128;     // 4 warps
constexpr int FB_GROUP = 16;        // rows per warp (one m16 tile)
constexpr int FB_PAD = 8;           // bf16 elements of row padding (16 bytes)
constexpr int DKV_HALF = 32;        // queries per half of a dk/dv q tile
constexpr int SPLIT_KS = 2;         // 16-row steps per fresh fragment sum
                                    // (1: dk/dv spills, 12% slower on an
                                    // H100, flash_ab.py)
using bf16 = __nv_bfloat16;

// rows [row0, row0 + FA_TILE) of a (nrows, d) bf16 matrix into dst (stride
// ld) by cp.async, 16 bytes a copy, by a block of THREADS threads (a
// constant stride: with blockDim.x the forward and dq ran 4% and 2% slower,
// flash_ab.py on an H100); rows past nrows as 0.  DP > 0: DP columns, those
// past d written as 0 (a head dim of 16 n + 8 padded to the mma's k step
// with the same copy count for every tile row: with the d / 8 copies of
// d = 120, ptxas spilled 16 bytes in dq, flash_ab.py)
template <int THREADS = FB_THREADS, int DP = 0>
__device__ __forceinline__ void cp_tile(bf16* dst, int ld,
                                        const bf16* __restrict__ src,
                                        int row0, int nrows, int d) {
  const int chunks = (DP ? DP : d) / 8;
  for (int c = threadIdx.x; c < FA_TILE * chunks; c += THREADS) {
    const int r = c / chunks, col = (c - r * chunks) * 8;
    const bool in = row0 + r < nrows && (!DP || col < d);
    sm90::cp_async16(dst + r * ld + col,
                     in ? src + (size_t)(row0 + r) * d + col : src, in);
  }
}

// k tile j's keys, values and key positions into stage st
template <int THREADS = FB_THREADS, int DP = 0>
__device__ __forceinline__ void cp_kv(bf16* Ks, bf16* Vs, int* kps, int ld,
                                      int st, const bf16* __restrict__ kb,
                                      const bf16* __restrict__ vb,
                                      const int* __restrict__ kpos, int j,
                                      int Sk, int d) {
  const int k0 = j * FA_TILE;
  cp_tile<THREADS, DP>(Ks + st * FA_TILE * ld, ld, kb, k0, Sk, d);
  cp_tile<THREADS, DP>(Vs + st * FA_TILE * ld, ld, vb, k0, Sk, d);
  if (threadIdx.x < FA_TILE) {
    const bool in = k0 + (int)threadIdx.x < Sk;
    sm90::cp_async4(kps + st * FA_TILE + threadIdx.x,
                    in ? kpos + k0 + threadIdx.x : kpos, in);
  }
}

// ldmatrix lane offsets: rows and columns of an A tile (and of a B tile
// read transposed), and of a B tile stored as its n rows
struct Lanes {
  int a_row, a_col, b_row, b_col;
  __device__ Lanes() {
    const int lane = threadIdx.x % 32;
    a_row = (lane & 7) + 8 * ((lane >> 3) & 1);
    a_col = 8 * (lane >> 4);
    b_row = (lane & 7) + 8 * (lane >> 4);
    b_col = 8 * ((lane >> 3) & 1);
  }
};

// acc[n] += (hi + lo) X over 16 KS rows of X, X rows [x0, x0 + 16 KS) of
// a (., 16 NJ) bf16 tile with stride ld read through ldmatrix.trans; the
// warp's A tile of each 16 rows kk is held as C fragments c[2 kk] (columns
// 0..7) and c[2 kk + 1] (8..15) of 16 rows.  The KS steps of each pair of
// n tiles sum in a fresh fragment, lo first, which is then added to acc in
// f32: the tensor cores' f32 accumulation truncates, so a long sum held in
// their accumulator drifts by its own magnitude's last bits at every step.
// Only the first NT of the 2 NJ 8-column fragments are computed (a head
// dim of 16 n + 8 leaves the last one out)
template <int NJ, int KS, int NT = 2 * NJ>
__device__ __forceinline__ void acc_split_product(float (&acc)[2 * NJ][4],
                                                  const float (*c)[4],
                                                  const bf16* X, int ld,
                                                  int x0, const Lanes& ln) {
  uint32_t hi[KS][4], lo[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    sm90::split_bf16(c[2 * kk][0], c[2 * kk][1], hi[kk][0], lo[kk][0]);
    sm90::split_bf16(c[2 * kk][2], c[2 * kk][3], hi[kk][1], lo[kk][1]);
    sm90::split_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[kk][2],
                     lo[kk][2]);
    sm90::split_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[kk][3],
                     lo[kk][3]);
  }
#pragma unroll
  for (int np = 0; np < NJ; ++np) {
    const bool second = 2 * np + 1 < NT;       // unrolled: a constant
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t bf[4];
      sm90::ldmatrix_x4_trans(
          bf, X + (x0 + 16 * kk + ln.a_row) * ld + 16 * np + ln.a_col);
      sm90::mma_bf16(t0, lo[kk], bf[0], bf[1]);
      if (second) sm90::mma_bf16(t1, lo[kk], bf[2], bf[3]);
      sm90::mma_bf16(t0, hi[kk], bf[0], bf[1]);
      if (second) sm90::mma_bf16(t1, hi[kk], bf[2], bf[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * np][e] += t0[e];
      if (second) acc[2 * np + 1][e] += t1[e];
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_frags(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// rows ra and ra + 8 of the first NF 8-column fragments of a C-fragment
// accumulator, times mul, into out (nrows rows of stride D) bf16
template <int D, int NF, int N>
__device__ __forceinline__ void store_frags(const float (&acc)[N][4],
                                            bf16* out, int ra, int nrows,
                                            float mul) {
  static_assert(NF <= N, "fragments");
  const int t = threadIdx.x % 4, rb = ra + 8;
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    const int c = 8 * n + 2 * t;
    if (ra < nrows)
      *reinterpret_cast<uint32_t*>(out + (size_t)ra * D + c) =
          sm90::pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    if (rb < nrows)
      *reinterpret_cast<uint32_t*>(out + (size_t)rb * D + c) =
          sm90::pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// s += q k^T over head-dim columns [16 kk, 16 kk + 16): the warp's q A
// fragment qa against the 64 keys of K tile Kt
__device__ __forceinline__ void qk_step(float (&s)[8][4],
                                        const uint32_t (&qa)[4],
                                        const bf16* Kt, int ld, int kk,
                                        const Lanes& ln) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t bf[4];
    sm90::ldmatrix_x4(bf, Kt + (16 * np + ln.b_row) * ld + 16 * kk +
                              ln.b_col);
    sm90::mma_bf16(s[2 * np], qa, bf[0], bf[1]);
    sm90::mma_bf16(s[2 * np + 1], qa, bf[2], bf[3]);
  }
}

// The forward's shape at head dim D: NJ 16-column groups (DP = 16 NJ, D
// padded to the mma's k step), NT 8-column fragments of o, and NH warps
// sharing each 16-row group, each owning NJW of the NJ column groups
template <int D>
struct FwdShape {
  static constexpr int NJ = (D + 15) / 16, DP = 16 * NJ, NT = D / 8;
  static constexpr int NH = NJ > MAX_NJ ? 2 : 1;
  static constexpr int NJW = NJ / NH, THREADS = FB_THREADS * NH;
  static constexpr int XS_WORDS = NH > 1 ? THREADS * 32 : 0;  // exchange
};

// bar.sync on barrier id (1..15; 0 is __syncthreads) among n threads
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// D (the head dim) and CAP (a softcap) are template arguments, so that
// every loop over the head dim and the softmax are straight-line code.  D
// is a multiple of 16 up to 128, or 120 (h2o-danube3: 3840 / 32) or 256
// (gemma2), as in dq and dk/dv.
//   - A head dim off the mma's k step of 16 (120) is padded in shared
//     memory to DP = 16 ceil(D / 16) columns.  Columns D..DP-1 of every
//     tile are zeroed once (cp.async writes columns < D only), so q k^T
//     gets nothing from them; o's 8-column fragments past D are neither
//     computed nor stored.  Global rows stay D wide (240 bytes, 15 pieces
//     of 16 bytes), so the wrapper copies nothing.
//   - Past d = 128 one warp's O accumulator would be 2 DP = 128 f32
//     registers a thread at d = 256, and ptxas spilled (72-116 bytes at
//     255 registers, whole or half k tiles, q held or re-read; flash_ab.py
//     on an H100).  So two warps share each 16-row group (8 warps, 256
//     threads): each sums q k^T over its half of the head dim, q read
//     from shared memory, the pair adds the two partial score tiles
//     through shared memory (a + b = b + a: both hold the same scores and
//     run the same online softmax), and each accumulates the P V columns
//     of its half, 64 registers.  Q and two stages of K and V take 5 * 64
//     * 264 * 2 = 169 KB and the exchange 32 KB: one block of 8 warps per
//     SM.
template <int D, bool CAP>
__global__ void __launch_bounds__(FwdShape<D>::THREADS,
                                  FwdShape<D>::NH > 1 ? 1 : 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kpos, bf16* __restrict__ o,
                      float* __restrict__ lse, int H, int KV, int Sq, int Sk,
                      Mask mk) {
  using Sh = FwdShape<D>;
  constexpr int NJ = Sh::NJ, DP = Sh::DP, ld = DP + FB_PAD, NT = Sh::NT;
  constexpr int NH = Sh::NH, NJW = Sh::NJW;
  constexpr bool QREG = NH == 1;            // q held in registers
  static_assert(D % 8 == 0 && DP - D <= 8 && NJW <= MAX_NJ &&
                (NH == 1 || NT == 2 * NJ), "head dim");
  extern __shared__ __align__(128) unsigned char smem[];
  const int nkt = (Sk + FA_TILE - 1) / FA_TILE;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + FA_TILE * ld;                       // 2 stages
  bf16* Vs = Ks + 2 * FA_TILE * ld;                   // 2 stages
  int* kps = reinterpret_cast<int*>(Vs + 2 * FA_TILE * ld);  // 2 stages
  int* flags = kps + 2 * FA_TILE;                     // nkt, then scratch
  float* xs = reinterpret_cast<float*>(flags + nkt + 3 * PLAN_GROUPS);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_TILE;  // longest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warp's 16-row group and head-dim half (0 with one warp a group)
  const int rw = NH > 1 ? warp % 4 : warp, half = NH > 1 ? warp / 4 : 0;
  const int g = lane / 4, t = lane % 4;
  const size_t qoff = ((size_t)b * H + h) * Sq;
  const bf16* kb = k + ((size_t)b * KV + kvh) * Sk * D;
  const bf16* vb = v + ((size_t)b * KV + kvh) * Sk * D;

  if constexpr (DP != D) {     // the pad columns of Q and both K, V stages
    for (int r = threadIdx.x; r < 5 * FA_TILE; r += Sh::THREADS)
      *reinterpret_cast<uint4*>(Qs + r * ld + D) = make_uint4(0, 0, 0, 0);
  }
  cp_tile<Sh::THREADS>(Qs, ld, q + qoff * D, q0, Sq, D);  // in flight during
                                                          // the plan
  plan_k_tiles(qpos, kpos, q0, min(FA_TILE, Sq - q0), FB_GROUP, Sk, mk,
               flags, flags + nkt);
  int j = next_tile(flags, 0, nkt);
  if (j < nkt)
    cp_kv<Sh::THREADS>(Ks, Vs, kps, ld, 0, kb, vb, kpos, j, Sk, D);
  sm90::cp_async_commit();

  // scores are kept in base 2: s log2(e), so that p = exp2(s2 - m2); a
  // masked score stays NEG, and a row max of NEG (no allowed key) gives
  // lse = NEG + log(l) as in the reference
  const float scale2 = CAP ? mk.scale : mk.scale * LOG2E;
  const float cap2 = mk.cap * LOG2E;
  // this thread's rows of the C fragments: ra = g, rb = g + 8 of its warp's
  const int ra = q0 + FB_GROUP * rw + g, rb = ra + 8;
  const int qpa = ra < Sq ? qpos[ra] : 0, qpb = rb < Sq ? qpos[rb] : 0;
  float ma = NEG, mb = NEG, la = 0.f, lb = 0.f;  // la, lb: this lane's part
  float oacc[2 * NJW][4];       // the warp's columns; fragments < NT in use
  zero_frags(oacc);
  uint32_t qf[QREG ? NJ : 1][4];
  const Lanes ln;
  const int kk0 = NJW * half;                   // the warp's first group
  const bf16* Qw = Qs + (FB_GROUP * rw + ln.a_row) * ld + ln.a_col;

  for (int st = 0, first = 1; j < nkt; st ^= 1, first = 0) {
    const int jn = next_tile(flags, j + 1, nkt);
    if (jn < nkt)
      cp_kv<Sh::THREADS>(Ks, Vs, kps, ld, st ^ 1, kb, vb, kpos, jn, Sk, D);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();                    // tile j (and q) landed
    __syncthreads();
    if constexpr (QREG) {
      if (first) {
#pragma unroll
        for (int kk = 0; kk < NJ; ++kk) sm90::ldmatrix_x4(qf[kk], Qw + 16 * kk);
      }
    }
    const int code = (flags[j] >> (2 * rw)) & 3;     // this warp's rows
    if (code) {
      const bf16* Kt = Ks + st * FA_TILE * ld;
      const bf16* Vt = Vs + st * FA_TILE * ld;

      // s = q k^T: 16 rows x 64 keys per warp, 8 fragments of 8 keys (the
      // warp's half of the head dim, then the pair's two halves added)
      float s[8][4];
      zero_frags(s);
#pragma unroll
      for (int kk = 0; kk < NJW; ++kk) {
        uint32_t qa[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        } else {
          sm90::ldmatrix_x4(qa, Qw + 16 * (kk0 + kk));
        }
        qk_step(s, qa, Kt, ld, kk0 + kk, ln);
      }
      if constexpr (NH > 1) {
        float* mine = xs + warp * 32 * 32 + lane;
#pragma unroll
        for (int i = 0; i < 32; ++i) mine[32 * i] = s[i / 4][i % 4];
        named_barrier(1 + rw, 64);                   // the pair's two warps
        const float* theirs = xs + (warp ^ 4) * 32 * 32 + lane;
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i / 4][i % 4] += theirs[32 * i];
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
      for (int n = 0; n < 2 * NJW; ++n) {
        oacc[n][0] *= alpha_a;
        oacc[n][1] *= alpha_a;
        oacc[n][2] *= alpha_b;
        oacc[n][3] *= alpha_b;
      }

      // o += p v over the warp's columns, p = hi + lo, each a bf16 A
      // fragment made from the score fragments of 16 keys; every V
      // fragment feeds 2 products (1 for the last 8 columns of a head dim
      // of 16 n + 8)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ph[4], pl[4];
        sm90::split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        sm90::split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        sm90::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        sm90::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < NJW; ++np) {
          uint32_t bf[4];
          sm90::ldmatrix_x4_trans(
              bf, Vt + (16 * kk + ln.a_row) * ld + 16 * (kk0 + np) +
                      ln.a_col);
          const bool second = 2 * np + 1 < NT;     // unrolled: a constant
          sm90::mma_bf16(oacc[2 * np], pl, bf[0], bf[1]);
          if (second) sm90::mma_bf16(oacc[2 * np + 1], pl, bf[2], bf[3]);
          sm90::mma_bf16(oacc[2 * np], ph, bf[0], bf[1]);
          if (second) sm90::mma_bf16(oacc[2 * np + 1], ph, bf[2], bf[3]);
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
  __nv_bfloat16* ob = o + qoff * D + 16 * kk0;
#pragma unroll
  for (int n = 0; n < 2 * NJW; ++n) {
    if (n >= NT) continue;           // past D (NH = 1); unrolled: constant
    const int c = 8 * n + 2 * t;
    if (ra < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)ra * D + c) =
          sm90::pack_bf16(oacc[n][0] / la, oacc[n][1] / la);
    if (rb < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)rb * D + c) =
          sm90::pack_bf16(oacc[n][2] / lb, oacc[n][3] / lb);
  }
  if (t == 0 && half == 0) {
    if (ra < Sq) lse[qoff + ra] = (ma == NEG ? NEG : ma * LN2) + logf(la);
    if (rb < Sq) lse[qoff + rb] = (mb == NEG ? NEG : mb * LN2) + logf(lb);
  }
}

// p in base 2 from a raw score x (s q.k, scaled by scale2 = scale log2 e,
// or by scale and then capped) and lse2 = lse log2 e: lse2 and the masked
// score NEG log2 e are products rounded on their own (__fmul_rn is never
// contracted into an FMA), so that a row with no allowed key, whose lse is
// NEG, gets p = exp2(0) = 1 exactly and a masked key of any other row 0
__device__ __forceinline__ float lse_base2(float lse) {
  return __fmul_rn(lse, LOG2E);
}

// The backward's shape at head dim D: NJ 16-column groups (DP = 16 NJ, D
// padded to the mma's k step), NT 8-column fragments of dq, dk and dv, and
// NH warps sharing each 16 rows (queries for dq, keys for dk/dv), each
// keeping the NJW groups (NTW fragments) of its own columns.  Up to d =
// 128 one warp keeps all of them (NH = 1): dq is 2 DP f32 registers a
// thread, dk and dv 4 DP, 128 at d = 128.  At d = 256 that would be 256,
// past the 255 a thread may have, so two warps share the rows (8 warps,
// 256 threads), each computing the same scores over the whole head dim
// and keeping the gradients of its 128 columns: the register set of d =
// 128, the score products done twice (the price of no exchange: the six
// 64 x 264 bf16 tiles take 203 KB of the 227 KB a block may have, which
// leaves no room for the forward's 32 KB partial-score exchange)
template <int D>
struct BwdShape {
  static constexpr int NJ = (D + 15) / 16, DP = 16 * NJ, NT = D / 8;
  static constexpr int NH = NJ > MAX_NJ ? 2 : 1;
  static constexpr int NJW = NJ / NH, NTW = NT / NH;
  static constexpr int THREADS = FB_THREADS * NH;
  // dq's passes over a k tile, each of 64 / KP keys: 2 past d = 128 and at
  // d = 120, where with the whole tile's scores (s and dp, 64 registers)
  // ptxas spilled 8-20 bytes (flash_ab.py), 1 elsewhere
  static constexpr int KP = NH > 1 || DP != D ? 2 : 1;
  static_assert(D % 8 == 0 && DP - D <= 8 && NJW <= MAX_NJ &&
                (NH == 1 || NT == 2 * NJ), "head dim");
};

// dq: block (q tile, h, b), q tiles last-first (the longest causal rows
// start first); each warp walks the k tiles its 16 rows visit
template <int D, bool CAP>
__global__ void __launch_bounds__(BwdShape<D>::THREADS,
                                  BwdShape<D>::NH > 1 ? 1 : 2)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ qpos,
                     const int* __restrict__ kpos, bf16* __restrict__ dq,
                     int H, int KV, int Sq, int Sk, Mask mk) {
  using Sh = BwdShape<D>;
  constexpr int NJ = Sh::NJ, DP = Sh::DP, ld = DP + FB_PAD, NJW = Sh::NJW;
  constexpr int THREADS = Sh::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nkt = (Sk + FA_TILE - 1) / FA_TILE;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + FA_TILE * ld;                       // dO
  bf16* Ks = Os + FA_TILE * ld;                       // 2 stages
  bf16* Vs = Ks + 2 * FA_TILE * ld;                   // 2 stages
  int* kps = reinterpret_cast<int*>(Vs + 2 * FA_TILE * ld);  // 2 stages
  int* flags = kps + 2 * FA_TILE;                     // nkt, then scratch

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_TILE;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warp's 16 rows and its columns of dq (0 with one warp a group)
  const int rw = Sh::NH > 1 ? warp % 4 : warp;
  const int col0 = Sh::NH > 1 ? 16 * NJW * (warp / 4) : 0;
  const int g = lane / 4, t = lane % 4;
  const size_t qoff = ((size_t)b * H + h) * Sq;
  const bf16* kb = k + ((size_t)b * KV + kvh) * Sk * D;
  const bf16* vb = v + ((size_t)b * KV + kvh) * Sk * D;

  // every copy writes DP columns, zeros past D
  cp_tile<THREADS, DP>(Qs, ld, q + qoff * D, q0, Sq, D);  // in flight
  cp_tile<THREADS, DP>(Os, ld, dout + qoff * D, q0, Sq, D);  // during
  plan_k_tiles(qpos, kpos, q0, min(FA_TILE, Sq - q0), FB_GROUP, Sk, mk,
               flags, flags + nkt);                            // the plan
  int j = next_tile(flags, 0, nkt);
  if (j < nkt)
    cp_kv<THREADS, DP>(Ks, Vs, kps, ld, 0, kb, vb, kpos, j, Sk, D);
  sm90::cp_async_commit();

  const float scale2 = CAP ? mk.scale : mk.scale * LOG2E;
  const float cap2 = mk.cap * LOG2E;
  // this thread's rows: ra = g, rb = g + 8 of its warp's 16 (0 past Sq)
  const int ra = q0 + FB_GROUP * rw + g, rb = ra + 8;
  const int qpa = ra < Sq ? qpos[ra] : 0, qpb = rb < Sq ? qpos[rb] : 0;
  const float l2a = ra < Sq ? lse_base2(lse[qoff + ra]) : 0.f;
  const float l2b = rb < Sq ? lse_base2(lse[qoff + rb]) : 0.f;
  const float dla = ra < Sq ? delta[qoff + ra] : 0.f;
  const float dlb = rb < Sq ? delta[qoff + rb] : 0.f;
  float acc[2 * NJW][4];
  zero_frags(acc);
  const Lanes ln;
  const bf16* Qw = Qs + (FB_GROUP * rw + ln.a_row) * ld + ln.a_col;
  const bf16* Ow = Os + (FB_GROUP * rw + ln.a_row) * ld + ln.a_col;

  for (int st = 0; j < nkt; st ^= 1) {
    const int jn = next_tile(flags, j + 1, nkt);
    if (jn < nkt)
      cp_kv<THREADS, DP>(Ks, Vs, kps, ld, st ^ 1, kb, vb, kpos, jn, Sk, D);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();                    // tile j (and q, dO) landed
    __syncthreads();
    const int code = (flags[j] >> (2 * rw)) & 3;     // this warp's rows
    if (code) {
      const bf16* Kt = Ks + st * FA_TILE * ld;
      const bf16* Vt = Vs + st * FA_TILE * ld;

      const int* kp = kps + st * FA_TILE;
      const int kn = min(FA_TILE, Sk - j * FA_TILE);
      constexpr int KW = FA_TILE / Sh::KP;           // keys a pass
#pragma unroll 1
      for (int c0 = 0; c0 < FA_TILE; c0 += KW) {
        // s = q k^T and dp = dO v^T: 16 rows x KW keys per warp, over the
        // whole head dim
        float s[KW / 8][4], dp[KW / 8][4];
        zero_frags(s);
        zero_frags(dp);
#pragma unroll
        for (int kk = 0; kk < NJ; ++kk) {
          uint32_t qa[4], oa[4];
          sm90::ldmatrix_x4(qa, Qw + 16 * kk);
          sm90::ldmatrix_x4(oa, Ow + 16 * kk);
#pragma unroll
          for (int np = 0; np < KW / 16; ++np) {
            const int off =
                (c0 + 16 * np + ln.b_row) * ld + 16 * kk + ln.b_col;
            uint32_t bk[4], bv[4];
            sm90::ldmatrix_x4(bk, Kt + off);
            sm90::ldmatrix_x4(bv, Vt + off);
            sm90::mma_bf16(s[2 * np], qa, bk[0], bk[1]);
            sm90::mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
            sm90::mma_bf16(dp[2 * np], oa, bv[0], bv[1]);
            sm90::mma_bf16(dp[2 * np + 1], oa, bv[2], bv[3]);
          }
        }

        // dS = p (dp - delta) (1 - t^2), 0 where masked or past Sk; the
        // mask unless the warp's rows see every key of the tile
#pragma unroll
        for (int n = 0; n < KW / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + 8 * n + 2 * t + (e & 1);
            float x = s[n][e] * scale2, tt = 0.f;
            if (CAP) {
              tt = tanhf(x / mk.cap);
              x = cap2 * tt;
            }
            const bool ok =
                code == 2 ||
                (c < kn && allowed(e < 2 ? qpa : qpb, kp[c], mk));
            float ds = 0.f;
            if (ok) {
              const float p = exp2f(x - (e < 2 ? l2a : l2b));
              ds = p * (dp[n][e] - (e < 2 ? dla : dlb));
              if (CAP) ds *= 1.f - tt * tt;
            }
            s[n][e] = ds;
          }

        // dq += dS k over the warp's columns with dS = hi + lo, 16
        // SPLIT_KS keys at a time
#pragma unroll
        for (int hh = 0; hh < KW / (16 * SPLIT_KS); ++hh)
          acc_split_product<NJW, SPLIT_KS, Sh::NTW>(
              acc, s + 2 * SPLIT_KS * hh, Kt + col0, ld,
              c0 + 16 * SPLIT_KS * hh, ln);
      }
    }
    __syncthreads();                 // stage st is refilled next iteration
    j = jn;
  }
  sm90::cp_async_wait<0>();
  store_frags<D, Sh::NTW>(acc, dq + qoff * D + col0, ra, Sq, mk.scale);
}

// q tile i of query head (b, hq)'s q, dO, lse, delta and q positions into
// stage st (rows past Sq as 0); rows holds 3 FA_TILE words a stage
template <int THREADS, int DP>
__device__ __forceinline__ void cp_qtile(
    bf16* Qs, bf16* Os, uint32_t* rows, int ld, int st,
    const bf16* __restrict__ q, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qpos, size_t qoff, int i, int Sq, int d) {
  const int q0 = i * FA_TILE;
  cp_tile<THREADS, DP>(Qs + st * FA_TILE * ld, ld, q + qoff * d, q0, Sq, d);
  cp_tile<THREADS, DP>(Os + st * FA_TILE * ld, ld, dout + qoff * d, q0, Sq,
                       d);
  for (int e = threadIdx.x; e < 3 * FA_TILE; e += THREADS) {
    const int which = e / FA_TILE, r = e - which * FA_TILE;
    const bool in = q0 + r < Sq;
    const int at = in ? q0 + r : 0;
    const void* src = which == 0 ? (const void*)(lse + qoff + at)
                      : which == 1 ? (const void*)(delta + qoff + at)
                                   : (const void*)(qpos + at);
    sm90::cp_async4(rows + st * 3 * FA_TILE + e, src, in);
  }
}

// dk/dv: block (k tile, kv head, b), k tiles first-first (under a causal
// mask the first keys are seen by the most queries); the G query heads of
// the kv head and the q tiles plan_q_tiles visits, in one sequence n =
// g nqt + i, the next visited q tile's copy in flight under this one's
// products
template <int D, bool CAP>
__global__ void __launch_bounds__(BwdShape<D>::THREADS,
                                  BwdShape<D>::NH > 1 ? 1 : 2)
flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kpos,
                      const int* __restrict__ nokey, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int KV, int Sq, int Sk,
                      Mask mk) {
  using Sh = BwdShape<D>;
  constexpr int NJ = Sh::NJ, DP = Sh::DP, ld = DP + FB_PAD, NJW = Sh::NJW;
  constexpr int THREADS = Sh::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nqt = (Sq + FA_TILE - 1) / FA_TILE;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + FA_TILE * ld;
  bf16* Qs = Vs + FA_TILE * ld;                       // 2 stages
  bf16* Os = Qs + 2 * FA_TILE * ld;                   // dO, 2 stages
  // lse, delta, q positions: 3 FA_TILE words a stage, 2 stages
  uint32_t* rows = reinterpret_cast<uint32_t*>(Os + 2 * FA_TILE * ld);
  int* flags = reinterpret_cast<int*>(rows + 6 * FA_TILE);  // nqt

  const int k0 = blockIdx.x * FA_TILE, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, total = G * nqt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warp's 16 keys and its columns of dk and dv (0 with one warp)
  const int rw = Sh::NH > 1 ? warp % 4 : warp;
  const int col0 = Sh::NH > 1 ? 16 * NJW * (warp / 4) : 0;
  const int g = lane / 4, t = lane % 4;
  const size_t koff = ((size_t)b * KV + kvh) * Sk * D;
  const size_t qoff0 = ((size_t)b * H + (size_t)kvh * G) * Sq;

  // every copy writes DP columns, zeros past D
  cp_tile<THREADS, DP>(Ks, ld, k + koff, k0, Sk, D);  // in flight during
  cp_tile<THREADS, DP>(Vs, ld, v + koff, k0, Sk, D);  // the plan
  plan_q_tiles(qpos, kpos, nokey, k0, Sq, Sk, mk, flags);
  int n = 0;
  while (n < total && !flags[n % nqt]) ++n;
  if (n < total)
    cp_qtile<THREADS, DP>(Qs, Os, rows, ld, 0, q, dout, lse, delta, qpos,
                          qoff0 + (size_t)(n / nqt) * Sq, n % nqt, Sq, D);
  sm90::cp_async_commit();

  const float scale2 = CAP ? mk.scale : mk.scale * LOG2E;
  const float cap2 = mk.cap * LOG2E;
  const float neg2 = lse_base2(NEG);
  // this thread's keys: ka = g, kb = g + 8 of its warp's 16 (-1 past Sk)
  const int ka = k0 + FB_GROUP * rw + g, kb = ka + 8;
  const int kpa = ka < Sk ? kpos[ka] : -1, kpb = kb < Sk ? kpos[kb] : -1;
  float dka[2 * NJW][4], dva[2 * NJW][4];
  zero_frags(dka);
  zero_frags(dva);
  const Lanes ln;
  const bf16* Kw = Ks + (FB_GROUP * rw + ln.a_row) * ld + ln.a_col;
  const bf16* Vw = Vs + (FB_GROUP * rw + ln.a_row) * ld + ln.a_col;

  for (int st = 0; n < total; st ^= 1) {
    int nn = n + 1;
    while (nn < total && !flags[nn % nqt]) ++nn;
    if (nn < total)
      cp_qtile<THREADS, DP>(Qs, Os, rows, ld, st ^ 1, q, dout, lse, delta,
                            qpos, qoff0 + (size_t)(nn / nqt) * Sq, nn % nqt,
                            Sq, D);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();             // q tile n (and k, v) landed
    __syncthreads();
    const int code = flags[n % nqt];
    const bf16* Qt = Qs + st * FA_TILE * ld;
    const bf16* Ot = Os + st * FA_TILE * ld;
    const float* ls = reinterpret_cast<const float*>(rows + st * 3 * FA_TILE);
    const float* dl = ls + FA_TILE;
    const int* qp = reinterpret_cast<const int*>(dl + FA_TILE);

    // the halves one after the other (unrolled, ptxas interleaves them,
    // runs out of registers and spills: 6% slower on an H100, flash_ab.py)
#pragma unroll 1
    for (int c0 = 0; c0 < FA_TILE; c0 += DKV_HALF) {
      // s^T = K Q^T and dp^T = V dO^T: 16 keys x 32 queries per warp, over
      // the whole head dim
      float s[4][4], dp[4][4];
      zero_frags(s);
      zero_frags(dp);
      if (code != 3) {
#pragma unroll
        for (int kk = 0; kk < NJ; ++kk) {
          uint32_t kf[4], vf[4];
          sm90::ldmatrix_x4(kf, Kw + 16 * kk);
          sm90::ldmatrix_x4(vf, Vw + 16 * kk);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const int off =
                (c0 + 16 * np + ln.b_row) * ld + 16 * kk + ln.b_col;
            uint32_t bq[4], bo[4];
            sm90::ldmatrix_x4(bq, Qt + off);
            sm90::ldmatrix_x4(bo, Ot + off);
            sm90::mma_bf16(s[2 * np], kf, bq[0], bq[1]);
            sm90::mma_bf16(s[2 * np + 1], kf, bq[2], bq[3]);
            sm90::mma_bf16(dp[2 * np], vf, bo[0], bo[1]);
            sm90::mma_bf16(dp[2 * np + 1], vf, bo[2], bo[3]);
          }
        }
      }

      // p^T (unmasked, as the reference's dk/dv uses it) and dS^T, per
      // column: lse, delta and the q position of query c.  Code 3: no
      // allowed pair, p = exp2(NEG log2 e - lse2) needs no score
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 8 * n8 + 2 * t + (e & 1);
          const float l2 = lse_base2(ls[c]);
          float p, ds = 0.f;
          if (code == 3) {
            p = exp2f(neg2 - l2);
          } else {
            float x = s[n8][e] * scale2, tt = 0.f;
            if (CAP) {
              tt = tanhf(x / mk.cap);
              x = cap2 * tt;
            }
            const bool ok =
                code == 2 || allowed(qp[c], e < 2 ? kpa : kpb, mk);
            p = exp2f((ok ? x : neg2) - l2);
            if (ok) {
              ds = p * (dp[n8][e] - dl[c]);
              if (CAP) ds *= 1.f - tt * tt;
            }
          }
          s[n8][e] = p;
          dp[n8][e] = ds;
        }

      // dv += p^T dO and dk += dS^T q over the 32 queries and the warp's
      // columns, each as hi + lo
#pragma unroll
      for (int hh = 0; hh < 2 / SPLIT_KS; ++hh) {
        const int x0 = c0 + 16 * SPLIT_KS * hh;
        acc_split_product<NJW, SPLIT_KS, Sh::NTW>(
            dva, s + 2 * SPLIT_KS * hh, Ot + col0, ld, x0, ln);
        if (code != 3)
          acc_split_product<NJW, SPLIT_KS, Sh::NTW>(
              dka, dp + 2 * SPLIT_KS * hh, Qt + col0, ld, x0, ln);
      }
    }
    __syncthreads();                 // stage st is refilled next iteration
    n = nn;
  }
  sm90::cp_async_wait<0>();
  store_frags<D, Sh::NTW>(dka, dk + koff + col0, ka, Sk, mk.scale);
  store_frags<D, Sh::NTW>(dva, dv + koff + col0, ka, Sk, 1.f);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// the head dims every kernel takes: multiples of 16 up to 128, 120 and
// 256 (kernels/flash_attention.py mirrors the set)
bool head_dim(int d) {
  return (d >= 16 && d <= 16 * MAX_NJ && d % 16 == 0) || d == 120 ||
         d == 256;
}

int check_shape(int B, int H, int KV, int Sq, int Sk, int d) {
  if (B < 0 || Sq < 0 || Sk < 1 || KV < 1 || H < KV || H % KV ||
      !head_dim(d))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// an f32 kernel's dynamic shared memory: score_tiles f32 score tiles, then
// row_arrays 64-entry f32 or int arrays, then in_tiles input tiles, then
// flag_ints ints of the plan
size_t smem_bytes(int d, int score_tiles, int row_arrays, int in_tiles,
                  int flag_ints) {
  return (size_t)score_tiles * FA_TILE * S_LD * sizeof(float) +
         (size_t)row_arrays * FA_TILE * sizeof(float) +
         (size_t)in_tiles * FA_TILE * (d + F_LD_PAD) * sizeof(float) +
         (size_t)flag_ints * sizeof(int);
}

// a bf16 kernel's: tiles padded bf16 tiles of head dim d, then words
// 4-byte words (row arrays, positions and plan flags)
size_t bf16_smem_bytes(int d, int tiles, int words) {
  return (size_t)tiles * FA_TILE * (d + FB_PAD) * sizeof(bf16) +
         (size_t)words * 4;
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

// ints of plan_k_tiles' flags and scratch, and of plan_q_tiles' flags
int k_plan_ints(int Sk) {
  return (Sk + FA_TILE - 1) / FA_TILE + 3 * PLAN_GROUPS;
}
int q_plan_ints(int Sq) { return (Sq + FA_TILE - 1) / FA_TILE; }

// the operands of every entry point: the backward's (out0 dq or dk, out1
// dv, dk/dv's scratch: ceil(Sq / FA_TILE) ints for plan_nokey_kernel); the
// forward has no dout, lse or delta and writes o to out0, lse to out1
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *qpos, *kpos;
  void *out0, *out1, *scratch;
  int B, H, KV, Sq, Sk, d;
  Mask mk;
  cudaStream_t stream;
};

#if FA_PART <= 0
int launch_fwd_f32(const Args& a) {
  const size_t bytes =
      smem_bytes(16 * ((a.d + 15) / 16), 1, 5, 3, k_plan_ints(a.Sk));
  static size_t granted = 0;
  if (int rc = set_smem(flash_fwd_kernel, bytes, granted)) return rc;
  const dim3 grid((a.Sq + FA_TILE - 1) / FA_TILE, a.H, a.B);
  flash_fwd_kernel<<<grid, FA_THREADS, bytes, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const int*)a.qpos, (const int*)a.kpos, (float*)a.out0,
      (float*)a.out1, a.H, a.KV, a.Sq, a.Sk, a.d, a.mk);
  return (int)cudaGetLastError();
}
#endif  // FA_PART <= 0

// plan_nokey_kernel into a.scratch, before either dk/dv kernel
int launch_nokey(const Args& a) {
  const int nqt = (a.Sq + FA_TILE - 1) / FA_TILE;
  if (nqt == 0) return 0;
  plan_nokey_kernel<<<nqt, FA_THREADS, 0, a.stream>>>(
      (const int*)a.qpos, (const int*)a.kpos, a.Sq, a.Sk, a.mk,
      (int*)a.scratch);
  return (int)cudaGetLastError();
}

#if FA_PART <= 0
// the f32 backward's shared memory (two input tiles), blocks (one for
// each chunk of 16 MAX_NJ columns of the gradients) and launch
int launch_dq_f32(const Args& a) {
  const int dp = 16 * ((a.d + 15) / 16);
  const size_t bytes = smem_bytes(dp, 2, 4, 2, k_plan_ints(a.Sk));
  static size_t granted = 0;
  if (int rc = set_smem(flash_dq_kernel, bytes, granted)) return rc;
  const dim3 grid((a.Sq + FA_TILE - 1) / FA_TILE * f32_chunks(a.d), a.H,
                  a.B);
  flash_dq_kernel<<<grid, FA_THREADS, bytes, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (const int*)a.qpos, (const int*)a.kpos, (float*)a.out0, a.H, a.KV,
      a.Sq, a.Sk, a.d, a.mk);
  return (int)cudaGetLastError();
}

int launch_dkv_f32(const Args& a) {
  if (int rc = launch_nokey(a)) return rc;
  const int dp = 16 * ((a.d + 15) / 16);
  const size_t bytes = smem_bytes(dp, 2, 4, 2, q_plan_ints(a.Sq));
  static size_t granted = 0;
  if (int rc = set_smem(flash_dkv_kernel, bytes, granted)) return rc;
  const dim3 grid((a.Sk + FA_TILE - 1) / FA_TILE * f32_chunks(a.d), a.KV,
                  a.B);
  flash_dkv_kernel<<<grid, FA_THREADS, bytes, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (const int*)a.qpos, (const int*)a.kpos, (const int*)a.scratch,
      (float*)a.out0, (float*)a.out1, a.H, a.KV, a.Sq, a.Sk, a.d, a.mk);
  return (int)cudaGetLastError();
}
#endif  // FA_PART <= 0

// the bf16 kernels, one struct per kernel (kind: its number across the
// parts) with run<D, CAP> (D the head dim)
struct FwdBf16 {
  static constexpr int kind = 0;
  template <int D, bool CAP>
  static int run(const Args& a) {
    using Sh = FwdShape<D>;
    const size_t bytes = bf16_smem_bytes(
        Sh::DP, 5, 2 * FA_TILE + k_plan_ints(a.Sk) + Sh::XS_WORDS);
    static size_t granted = 0;
    const auto kernel = flash_fwd_bf16_kernel<D, CAP>;
    if (int rc = set_smem(kernel, bytes, granted)) return rc;
    const dim3 grid((a.Sq + FA_TILE - 1) / FA_TILE, a.H, a.B);
    kernel<<<grid, Sh::THREADS, bytes, a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const int*)a.qpos, (const int*)a.kpos, (bf16*)a.out0,
        (float*)a.out1, a.H, a.KV, a.Sq, a.Sk, a.mk);
    return (int)cudaGetLastError();
  }
};

struct DqBf16 {
  static constexpr int kind = 1;
  template <int D, bool CAP>
  static int run(const Args& a) {
    using Sh = BwdShape<D>;
    const size_t bytes =
        bf16_smem_bytes(Sh::DP, 6, 2 * FA_TILE + k_plan_ints(a.Sk));
    static size_t granted = 0;
    const auto kernel = flash_dq_bf16_kernel<D, CAP>;
    if (int rc = set_smem(kernel, bytes, granted)) return rc;
    const dim3 grid((a.Sq + FA_TILE - 1) / FA_TILE, a.H, a.B);
    kernel<<<grid, Sh::THREADS, bytes, a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const bf16*)a.dout, (const float*)a.lse, (const float*)a.delta,
        (const int*)a.qpos, (const int*)a.kpos, (bf16*)a.out0, a.H, a.KV,
        a.Sq, a.Sk, a.mk);
    return (int)cudaGetLastError();
  }
};

struct DkvBf16 {
  static constexpr int kind = 2;
  template <int D, bool CAP>
  static int run(const Args& a) {
    if (int rc = launch_nokey(a)) return rc;
    using Sh = BwdShape<D>;
    const size_t bytes =
        bf16_smem_bytes(Sh::DP, 6, 6 * FA_TILE + q_plan_ints(a.Sq));
    static size_t granted = 0;
    const auto kernel = flash_dkv_bf16_kernel<D, CAP>;
    if (int rc = set_smem(kernel, bytes, granted)) return rc;
    const dim3 grid((a.Sk + FA_TILE - 1) / FA_TILE, a.KV, a.B);
    kernel<<<grid, Sh::THREADS, bytes, a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const bf16*)a.dout, (const float*)a.lse, (const float*)a.delta,
        (const int*)a.qpos, (const int*)a.kpos, (const int*)a.scratch,
        (bf16*)a.out0, (bf16*)a.out1, a.H, a.KV, a.Sq, a.Sk, a.mk);
    return (int)cudaGetLastError();
  }
};

// the bf16 kernel of kind at a head dim that another part builds (only
// declared when built whole: nothing calls it then)
int remote_bf16(int part, int kind, const Args& a);
#if FA_PART >= 0
int remote_bf16(int part, int kind, const Args& a) {
  switch (part) {
    case 1: return fa_bf16_part1(kind, &a);
    case 2: return fa_bf16_part2(kind, &a);
    case 3: return fa_bf16_part3(kind, &a);
    case 4: return fa_bf16_part4(kind, &a);
  }
  return (int)cudaErrorInvalidValue;
}
#endif

// K::run<d, softcap?>, one instance per head dim (60 bf16 instances in
// all), here or in the part that builds it; cp.async moves 16-byte
// pieces: rows of d bf16 (d % 8 == 0) stay aligned if the bases are;
// 4-byte words 4 bytes
template <typename K>
int launch_bf16(const Args& a) {
  if ((uintptr_t)a.q % 16 || (uintptr_t)a.k % 16 || (uintptr_t)a.v % 16 ||
      (uintptr_t)a.dout % 16 || (uintptr_t)a.qpos % 4 ||
      (uintptr_t)a.kpos % 4 || (uintptr_t)a.lse % 4 ||
      (uintptr_t)a.delta % 4)
    return (int)cudaErrorMisalignedAddress;
  const bool cap = a.mk.use_cap;
#define FA_HEAD_DIM(dd)                                              \
  case dd:                                                           \
    if constexpr (fa_local(dd))                                      \
      return cap ? K::template run<dd, true>(a)                      \
                 : K::template run<dd, false>(a);                    \
    else                                                             \
      return remote_bf16(fa_part_of(dd), K::kind, a);
  switch (a.d) {
    FA_HEAD_DIM(16) FA_HEAD_DIM(32) FA_HEAD_DIM(48) FA_HEAD_DIM(64)
    FA_HEAD_DIM(80) FA_HEAD_DIM(96) FA_HEAD_DIM(112) FA_HEAD_DIM(128)
    FA_HEAD_DIM(120) FA_HEAD_DIM(256)
  }
#undef FA_HEAD_DIM
  return (int)cudaErrorInvalidValue;
}

// shape checks, then the launch unless there is nothing to compute (the
// forward and dq with no query; dk/dv with no query still write zeros)
int launch(int (*fn)(const Args&), const Args& a, bool need_rows) {
  if (int rc = check_shape(a.B, a.H, a.KV, a.Sq, a.Sk, a.d)) return rc;
  if (a.B == 0 || (need_rows && a.Sq == 0)) return 0;
  return fn(a);
}

}  // namespace

#if FA_PART > 0
// this part's bf16 instances, for part 0's entry points (args: its Args)
#define FA_PART_FN_(p) fa_bf16_part##p
#define FA_PART_FN(p) FA_PART_FN_(p)
extern "C" int FA_PART_FN(FA_PART)(int kind, const void* args) {
  const Args& a = *static_cast<const Args*>(args);
  return kind == 0   ? launch_bf16<FwdBf16>(a)
         : kind == 1 ? launch_bf16<DqBf16>(a)
                     : launch_bf16<DkvBf16>(a);
}
#else

#define FA_MASK_ARGS                                                    \
  float scale, int causal, int window, int use_window, float cap,      \
      int use_cap, void* stream
#define FA_ARGS(dout, lse, delta, out0, out1, scratch)                     \
  Args{q, k, v, dout, lse, delta, qpos, kpos, out0, out1, scratch, B, H,   \
       KV, Sq, Sk, d, Mask{scale, causal, window, use_window, cap, use_cap}, \
       (cudaStream_t)stream}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* qpos, const void* kpos, void* o,
                              void* lse, int B, int H, int KV, int Sq,
                              int Sk, int d, FA_MASK_ARGS) {
  return launch(launch_bf16<FwdBf16>,
                FA_ARGS(nullptr, nullptr, nullptr, o, lse, nullptr), true);
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             const void* qpos, const void* kpos, void* o,
                             void* lse, int B, int H, int KV, int Sq, int Sk,
                             int d, FA_MASK_ARGS) {
  return launch(launch_fwd_f32, FA_ARGS(nullptr, nullptr, nullptr, o, lse, nullptr),
                true);
}

extern "C" int flash_dq_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* qpos,
                             const void* kpos, void* dq, int B, int H, int KV,
                             int Sq, int Sk, int d, FA_MASK_ARGS) {
  return launch(launch_bf16<DqBf16>,
                FA_ARGS(dout, lse, delta, dq, nullptr, nullptr), true);
}

extern "C" int flash_dq_f32(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* qpos,
                            const void* kpos, void* dq, int B, int H, int KV,
                            int Sq, int Sk, int d, FA_MASK_ARGS) {
  return launch(launch_dq_f32, FA_ARGS(dout, lse, delta, dq, nullptr, nullptr),
                true);
}

extern "C" int flash_dkv_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* qpos,
                              const void* kpos, void* dk, void* dv,
                              void* nokey, int B, int H, int KV, int Sq,
                              int Sk, int d,
                              FA_MASK_ARGS) {
  return launch(launch_bf16<DkvBf16>, FA_ARGS(dout, lse, delta, dk, dv, nokey),
                false);
}

extern "C" int flash_dkv_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* qpos,
                             const void* kpos, void* dk, void* dv,
                             void* nokey, int B, int H, int KV, int Sq,
                             int Sk, int d,
                             FA_MASK_ARGS) {
  return launch(launch_dkv_f32, FA_ARGS(dout, lse, delta, dk, dv, nokey),
                false);
}
#endif  // FA_PART > 0
