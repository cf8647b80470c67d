// Row gather of the layout transform (paper §3.2 "Layout Transform
// Optimization", Fig. 4): out[i] = src[idx[i]], a zero row where idx[i] < 0,
// and its VJP, the row scatter-add out[idx[i]] += g[i].
//
// gather_rows replaces the TPU kernel repro/kernels/layout_transform.py:
// _gather_rows_kernel (pallas_call in _gather_rows_impl).  One kernel serves
// the grouped dispatch (token map), the sort dispatch (inverse row map) and
// the sort combine (slot map).
//
// Bound on the H100: bytes — each source row read once and each output row
// written once (M=4096 rows of 4 KiB bf16 move 32 MiB, about 10 us at
// 3.35 TB/s).  Design: it copies bytes, so one kernel serves every dtype;
// a warp moves a row in steps of 8 independent 16-byte loads a lane (4 KiB
// a warp in flight), then their stores, neighbouring lanes on neighbouring
// addresses (4-byte words, else bytes, where the width or the pointers are
// off 16).  An index at or past N also writes a zero row, so the kernel
// never reads out of bounds.  It has two forms:
// - the gather, a warp per output row i reading src[idx[i]] — the combine
//   and the scatter-add's backward, which read each source row at most
//   once;
// - the fan-out, for the dispatches, where the caller also passes dest
//   (N, K), the inverse of idx: a warp per source row reads it once and
//   writes it to its K rows, and further warps write the zero rows.  At
//   dbrx's top-4 dispatch (32,768 rows of 12 KiB from 8192) the gather
//   read each source row 4 times, in expert-sorted order, far apart: the
//   100 MB source is twice the L2, so the re-reads went back to device
//   memory (0.269 ms on an H100 80GB HBM3 at 700 W, against 0.150 of
//   bound).  Each row read once brings
//   the traffic to the bound's 503 MB.  A TMA form (cp.async.bulk into a
//   ring of shared-memory stages, one issuing thread per block) was no
//   faster at 12 KiB rows and slower at 4 KiB (gate_gather_ab.py).
//
// scatter_add_rows replaces the TPU kernel repro/kernels/layout_transform.py:
// _scatter_add_kernel (pallas_call in scatter_add_rows), the gather's VJP:
// out (n, d) with out[idx[i]] += g[i], idx[i] < 0 (or >= n) skipped and
// duplicate indices accumulated.
//
// Bound on the H100: bytes — g is read once and out written once (at the
// training shapes (4096, 2048) bf16 each way, 32 MiB: 10.0 us at an H100
// SXM's 3.35 TB/s, its 700 W limit); the plan's index bytes are ~0.1% of
// that.  Design: a deterministic gather-form reduction in two launches.
// scatter_plan_kernel, one block, inverts idx into compressed rows:
// starts (n+1,) and slots, where slots[starts[r] .. starts[r+1]) are the
// input rows i with idx[i] == r — counts by integer atomics (order-free),
// an exclusive block scan, then placement by atomics on a cursor per row
// (counts and cursors in shared memory when n fits, else in the global
// scratch the wrapper passes).  scatter_sum_kernel then gives one warp to
// each (output row, column chunk): it visits its row's input rows in
// ascending i (each step the least slot above the last, by a warp min, so
// the atomics' placement order does not matter), adds them in f32 with
// plain adds (__fadd_rn: nothing contracted), rounds once to g's dtype and
// writes the row — zeros for a row with no addend.  16-byte vectors where
// the width and the pointers allow, else one element a lane.  The TPU
// kernel keeps the (n, d) accumulator resident across a sequential grid;
// here there is no (n, d) scratch, no memset and no rounding pass, and the
// result is the same on every run for any number of addends per row:
// bitwise the plain twin (kernels/layout_transform.py:scatter_add_rows_plain,
// which adds in the same order).  The reference adds in g's dtype, so with
// 3 or more addends in bf16 it rounds after each add where this rounds once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Both forms of the gather on one kernel: a warp per unit row, copying it
// in steps of U vectors of T a lane (with T = uint4, 4 KiB a warp in
// flight per step: U independent 16-byte loads a lane, then their stores),
// neighbouring lanes on neighbouring addresses.
//  FAN = false, the gather form: warp i loads output row i from
//    src[idx[i]], or writes zeros when idx[i] < 0 or >= N.
//  FAN = true, the fan-out form: warp t < N loads source row t once and
//    stores each step to out[dest[t, k]] for every k with 0 <= dest[t, k]
//    < M; a row with no destination is not read.  Warps N.. each scan 32
//    rows of idx and write zeros to the rows with idx < 0 or >= N (the sort
//    dispatch's empty capacity slots).  dest must be the inverse of idx:
//    every i with 0 <= idx[i] < N is some dest[idx[i], k].
template <typename T, bool FAN, int U>
__global__ void __launch_bounds__(256)
gather_rows_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                   const int* __restrict__ dest, T* __restrict__ out,
                   long long N, long long M, int K, long long units) {
  const long long w =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const T zero{};
  if (FAN && w >= N) {
    const long long i0 = (w - N) * 32, i = i0 + lane;
    bool empty = false;
    if (i < M) {
      const int r = idx[i];
      empty = r < 0 || r >= N;
    }
    for (unsigned mask = __ballot_sync(0xffffffffu, empty); mask;
         mask &= mask - 1) {
      T* o = out + (i0 + __ffs(mask) - 1) * units;
      for (long long c = lane; c < units; c += 32) o[c] = zero;
    }
    return;
  }
  if (!FAN && w >= M) return;
  long long r = FAN ? w : idx[w];
  if (FAN) {
    bool any = false;
    for (int k = 0; k < K; ++k) {
      const int d = dest[w * K + k];
      any |= d >= 0 && d < M;
    }
    if (!any) return;
  } else if (r < 0 || r >= N) {
    T* o = out + w * units;
    for (long long c = lane; c < units; c += 32) o[c] = zero;
    return;
  }
  const T* s = src + r * units;
  for (long long c0 = lane; c0 < units; c0 += 32 * U) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + 32 * u < units) v[u] = s[c0 + 32 * u];
    for (int k = 0; k < (FAN ? K : 1); ++k) {
      const long long d = FAN ? dest[w * K + k] : w;
      if (d < 0 || d >= M) continue;
      T* o = out + d * units;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (c0 + 32 * u < units) o[c0 + 32 * u] = v[u];
    }
  }
}

template <typename T, bool FAN>
static void launch_gather(const void* src, const void* idx, const void* dest,
                          void* out, long long N, long long M, int K,
                          long long row_bytes, cudaStream_t stream) {
  const long long warps = FAN ? N + (M + 31) / 32 : M;
  const unsigned int blocks = (unsigned int)((warps + 7) / 8);
  gather_rows_kernel<T, FAN, 8><<<blocks, 256, 0, stream>>>(
      (const T*)src, (const int*)idx, (const int*)dest, (T*)out, N, M, K,
      row_bytes / (long long)sizeof(T));
}

// 16-byte vectors when the row width and the pointers allow, else 4-byte
// words, else bytes
template <bool FAN>
static int gather_any(const void* src, const void* idx, const void* dest,
                      void* out, long long N, long long M, int K,
                      long long row_bytes, cudaStream_t s) {
  const uintptr_t a = (uintptr_t)src | (uintptr_t)out;
  if (row_bytes % 16 == 0 && a % 16 == 0)
    launch_gather<uint4, FAN>(src, idx, dest, out, N, M, K, row_bytes, s);
  else if (row_bytes % 4 == 0 && a % 4 == 0)
    launch_gather<unsigned int, FAN>(src, idx, dest, out, N, M, K,
                                     row_bytes, s);
  else
    launch_gather<unsigned char, FAN>(src, idx, dest, out, N, M, K,
                                      row_bytes, s);
  return (int)cudaGetLastError();
}

extern "C" int gather_rows(const void* src, const void* idx, void* out,
                           long long N, long long M, long long row_bytes,
                           void* stream) {
  if (M == 0 || row_bytes == 0) return 0;
  return gather_any<false>(src, idx, nullptr, out, N, M, 1, row_bytes,
                           (cudaStream_t)stream);
}

// The fan-out form: dest (N, K) int32, the output rows of each source row
// (-1 for none), the inverse of idx (M,).  Same result as gather_rows.
extern "C" int gather_rows_fanout(const void* src, const void* idx,
                                  const void* dest, void* out, long long N,
                                  long long M, int K, long long row_bytes,
                                  void* stream) {
  if (M == 0 || row_bytes == 0) return 0;
  if (K < 1) return (int)cudaErrorInvalidValue;
  return gather_any<true>(src, idx, dest, out, N, M, K, row_bytes,
                          (cudaStream_t)stream);
}

constexpr int PLAN_THREADS = 1024;
constexpr long long PLAN_SMEM_ROWS = 12000;   // n + 1 counts, under 48 KiB

// Inclusive sum of v over the block (PLAN_THREADS threads); total as well.
__device__ long long block_scan(long long v, long long& total) {
  __shared__ long long warp_sum[PLAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  long long before = 0;
  total = 0;
  for (int w = 0; w < PLAN_THREADS / 32; ++w) {
    if (w < warp) before += warp_sum[w];
    total += warp_sum[w];
  }
  __syncthreads();
  return v + before;
}

// starts (n+1,): exclusive scan of the rows' addend counts; slots (M,): the
// valid i grouped by idx[i] (within a row in no fixed order).  cursor: n
// ints of global scratch, used when the counts do not fit shared memory.
__global__ void __launch_bounds__(PLAN_THREADS)
scatter_plan_kernel(const int* __restrict__ idx, int* __restrict__ starts,
                    int* __restrict__ cursor, int* __restrict__ slots,
                    long long n, long long M) {
  extern __shared__ int cnt_smem[];
  int* cnt = n + 1 <= PLAN_SMEM_ROWS ? cnt_smem : cursor;
  const int tid = threadIdx.x;
  for (long long r = tid; r < n; r += PLAN_THREADS) cnt[r] = 0;
  __syncthreads();
  for (long long i = tid; i < M; i += PLAN_THREADS) {
    const int r = idx[i];
    if (r >= 0 && r < n) atomicAdd(cnt + r, 1);
  }
  __syncthreads();
  // each thread scans a contiguous chunk of the rows
  const long long chunk = (n + PLAN_THREADS - 1) / PLAN_THREADS;
  const long long r0 = min(n, tid * chunk), r1 = min(n, r0 + chunk);
  long long mine = 0;
  for (long long r = r0; r < r1; ++r) mine += cnt[r];
  long long total;
  long long at = block_scan(mine, total) - mine;
  for (long long r = r0; r < r1; ++r) {
    const int c = cnt[r];
    starts[r] = (int)at;
    cnt[r] = (int)at;                  // now the row's placement cursor
    at += c;
  }
  if (tid == 0) starts[n] = (int)total;
  __syncthreads();
  for (long long i = tid; i < M; i += PLAN_THREADS) {
    const int r = idx[i];
    if (r >= 0 && r < n) slots[atomicAdd(cnt + r, 1)] = (int)i;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float from_f32(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float v, __nv_bfloat16) {
  return __float2bfloat16(v);
}

// One warp per (output row, chunk of 32 V columns): out[r] = the f32 sum of
// g[i] over the row's slots in ascending i, rounded once to T.  V elements
// a lane: a 16-byte vector (vec) or one element.
template <typename T, int V>
__global__ void __launch_bounds__(256)
scatter_sum_kernel(const T* __restrict__ g, const int* __restrict__ starts,
                   const int* __restrict__ slots, T* __restrict__ out,
                   long long n, long long d) {
  const long long w =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long chunks = (d + 32 * V - 1) / (32 * V);
  if (w >= n * chunks) return;
  const long long r = w / chunks;
  const long long c0 = (w - r * chunks) * 32 * V + (long long)lane * V;
  const int s0 = starts[r], c = starts[r + 1] - s0;
  const int* list = slots + s0;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  int prev = -1;
  for (int step = 0; step < c; ++step) {
    int next = 0x7fffffff;                       // the least slot above prev
    for (int j = lane; j < c; j += 32) {
      const int x = list[j];
      if (x > prev && x < next) next = x;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      next = min(next, __shfl_xor_sync(0xffffffffu, next, off));
    prev = next;
    const T* src = g + (long long)next * d + c0;
    if constexpr (V > 1) {
      if (c0 < d) {
        alignas(16) T x[V];
        *reinterpret_cast<uint4*>(x) = *reinterpret_cast<const uint4*>(src);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], to_f32(x[v]));
      }
    } else if (c0 < d) {
      acc[0] = __fadd_rn(acc[0], to_f32(src[0]));
    }
  }
  if (c0 >= d) return;
  T* dst = out + r * d + c0;
  if constexpr (V > 1) {
    alignas(16) T x[V];
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = from_f32(acc[v], T{});
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(x);
  } else {
    dst[0] = from_f32(acc[0], T{});
  }
}

template <typename T, int V>
static void launch_sum(const void* g, const int* starts, const int* slots,
                       void* out, long long n, long long d, cudaStream_t s) {
  const long long warps = n * ((d + 32 * V - 1) / (32 * V));
  const unsigned int blocks = (unsigned int)((warps + 7) / 8);
  scatter_sum_kernel<T, V><<<blocks, 256, 0, s>>>(
      (const T*)g, starts, slots, (T*)out, n, d);
}

// g (M, d) bf16 (is_bf16=1) or f32 (0) → out (n, d) of g's dtype.  Scratch
// from the caller: starts (n+1,), cursor (n,) and slots (M,) int32.
extern "C" int scatter_add_rows(const void* g, const void* idx, void* starts,
                                void* cursor, void* slots, void* out,
                                long long n, long long M, long long d,
                                int is_bf16, void* stream) {
  if (n == 0 || d == 0) return 0;
  if (n >= 2147483647LL || M >= 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = n + 1 <= PLAN_SMEM_ROWS ? (size_t)(n + 1) * 4 : 0;
  scatter_plan_kernel<<<1, PLAN_THREADS, smem, s>>>(
      (const int*)idx, (int*)starts, (int*)cursor, (int*)slots, n, M);
  const int* st = (const int*)starts;
  const int* sl = (const int*)slots;
  const size_t elem = is_bf16 ? 2 : 4;
  const bool vec = (d * elem) % 16 == 0 &&
                   ((uintptr_t)g | (uintptr_t)out) % 16 == 0;
  if (is_bf16) {
    if (vec)
      launch_sum<__nv_bfloat16, 8>(g, st, sl, out, n, d, s);
    else
      launch_sum<__nv_bfloat16, 1>(g, st, sl, out, n, d, s);
  } else {
    if (vec)
      launch_sum<float, 4>(g, st, sl, out, n, d, s);
    else
      launch_sum<float, 1>(g, st, sl, out, n, d, s);
  }
  return (int)cudaGetLastError();
}

// gather_rows_rowstep replaces the TPU kernel repro/kernels/
// layout_transform.py: _gather_row_kernel (pallas_call in
// gather_rows_rowstep), the seed's tiling kept as the benchmark baseline of
// the blocked gather (bench_layout's speedup_vs_rowstep): out[i] =
// src[idx[i]], a zero row where idx[i] < 0 (or >= N, so that nothing is
// read out of bounds).
//
// Bound on the H100: bytes, as the gather's (32 MiB at M=4096 rows of 4 KiB
// bf16: 10.0 us).  Design: the seed's tiling is what this kernel exists to
// measure, so it keeps it: one block per output row (grid (M,)), whose
// threads copy that one row, 16-byte vectors where the row width and the
// pointers allow, else one element per load.  It shares no code with
// gather_rows_kernel, so that its time is its own.
template <typename U>
__global__ void gather_rowstep_kernel(const U* __restrict__ src,
                                      const int* __restrict__ idx,
                                      U* __restrict__ out, long long N,
                                      long long units) {
  const long long row = blockIdx.x;
  const int r = idx[row];
  U* o = out + row * units;
  if (r < 0 || r >= N) {
    const U zero{};
    for (long long c = threadIdx.x; c < units; c += blockDim.x) o[c] = zero;
    return;
  }
  const U* s = src + (long long)r * units;
  for (long long c = threadIdx.x; c < units; c += blockDim.x) o[c] = s[c];
}

template <typename U>
static void launch_rowstep(const void* src, const void* idx, void* out,
                           long long N, long long M, long long row_bytes,
                           cudaStream_t stream) {
  const long long units = row_bytes / (long long)sizeof(U);
  const int threads = units >= 256 ? 256 : (int)((units + 31) / 32 * 32);
  gather_rowstep_kernel<U><<<(unsigned int)M, threads, 0, stream>>>(
      (const U*)src, (const int*)idx, (U*)out, N, units);
}

// src (N, d) and out (M, d) of elements of elem_bytes (2: bf16, 4: f32)
extern "C" int gather_rows_rowstep(const void* src, const void* idx,
                                   void* out, long long N, long long M,
                                   long long d, int elem_bytes,
                                   void* stream) {
  if (M == 0 || d == 0) return 0;
  if (M > 2147483647LL || (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const long long row_bytes = d * elem_bytes;
  const uintptr_t a = (uintptr_t)src | (uintptr_t)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && a % 16 == 0)
    launch_rowstep<uint4>(src, idx, out, N, M, row_bytes, s);
  else if (elem_bytes == 4)
    launch_rowstep<unsigned int>(src, idx, out, N, M, row_bytes, s);
  else
    launch_rowstep<unsigned short>(src, idx, out, N, M, row_bytes, s);
  return (int)cudaGetLastError();
}

// Message for a code returned by any entry point of this library.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
