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
// bf16 tensor-core rate), dq 168 MB and 103 GFLOP, dk/dv 201 MB and 137
// GFLOP: all bound by operations on the tensor cores.  These kernels keep
// the reference's arithmetic: every product of p or dS (P v, dS k, P^T dO,
// dS^T q) is in f32, as the TPU kernels compute them, so half or more of
// the work runs at the f32 FMA rate (67 TFLOP/s), and the kernels are
// milliseconds, not microseconds.
//
// Design (simple and right first): a 64-row tile of queries or keys per
// block, 256 threads.  The TPU grid's sequential axes become loops inside
// the block: the forward and dq walk the k tiles of one (b, h, q tile);
// dk/dv walks the G query heads of one kv head and all their q tiles, with
// f32 accumulators and no atomics, so its result does not depend on run
// order.  Tiles of q, k, v and dO sit in dynamic shared memory (up to
// 164 KB), with the 64x64 f32 score tile.  q k^T and dO v^T run on the
// tensor cores (WMMA) when the inputs are bf16 (the products of bf16
// values are exact in f32; only the order of the sums changes) and with
// f32 FMAs otherwise (never TF32); the products of p and dS are f32 FMAs.
// No tile is skipped: a row whose keys are all masked gets p = 1 for every
// key, as in the reference (o = mean of v, lse = NEG + log Sk), and keys
// past Sk (the ragged edge) count as nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

// one block per (q tile, h, b); the k tiles in a loop (the TPU's nk axis)
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

  for (int k0 = 0; k0 < Sk; k0 += FA_TILE) {
    const int kn = min(FA_TILE, Sk - k0);
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

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* qpos,
               const void* kpos, void* o, void* lse, int B, int H, int KV,
               int Sq, int Sk, int d, Mask mk, void* stream) {
  if (int rc = check_shape(B, H, KV, Sq, Sk, d)) return rc;
  if (B == 0 || Sq == 0) return 0;
  const size_t bytes = smem_bytes<T>(d, 1, 5, 3);
  static size_t granted = 0;
  if (int rc = set_smem(flash_fwd_kernel<T>, bytes, granted)) return rc;
  const dim3 grid((Sq + FA_TILE - 1) / FA_TILE, H, B);
  flash_fwd_kernel<T><<<grid, FA_THREADS, bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)qpos,
      (const int*)kpos, (T*)o, (float*)lse, H, KV, Sq, Sk, d, mk);
  return (int)cudaGetLastError();
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
  return launch_fwd<__nv_bfloat16>(q, k, v, qpos, kpos, o, lse, B, H, KV, Sq,
                                   Sk, d, FA_MASK, stream);
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             const void* qpos, const void* kpos, void* o,
                             void* lse, int B, int H, int KV, int Sq, int Sk,
                             int d, FA_MASK_ARGS) {
  return launch_fwd<float>(q, k, v, qpos, kpos, o, lse, B, H, KV, Sq, Sk, d,
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
