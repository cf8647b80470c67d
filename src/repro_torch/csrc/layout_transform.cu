// Row gather of the layout transform (paper §3.2 "Layout Transform
// Optimization", Fig. 4): out[i] = src[idx[i]], a zero row where idx[i] < 0,
// and its VJP, the row scatter-add out[idx[i]] += g[i].
//
// gather_rows replaces the TPU kernel repro/kernels/layout_transform.py:
// _gather_rows_kernel (pallas_call in _gather_rows_impl).  One kernel serves
// the grouped dispatch (token map), the sort dispatch (inverse row map) and
// the sort combine (slot map).
//
// Bound on the H100: bytes — each output row is read once and written once
// (M=4096 rows of 4 KiB bf16 move 32 MiB, about 10 us at 3.35 TB/s).
// Design: the paper's warp-per-row gather.  It copies bytes, so one kernel
// serves every dtype; lanes move 16-byte vectors when the row width and the
// pointers allow it (neighbouring lanes on neighbouring addresses), else
// 4-byte words, else single bytes.  Unlike the TPU version nothing has to
// stay resident: each warp reads its source row straight from device
// memory.  An index at or past N also writes a zero row, so the kernel
// never reads out of bounds.
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

template <typename U>
__global__ void gather_rows_kernel(const U* __restrict__ src,
                                   const int* __restrict__ idx,
                                   U* __restrict__ out, long long N,
                                   long long M, long long units) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int r = idx[row];
  U* o = out + row * units;
  if (r < 0 || r >= N) {
    const U zero{};
    for (long long c = lane; c < units; c += 32) o[c] = zero;
    return;
  }
  const U* s = src + (long long)r * units;
  for (long long c = lane; c < units; c += 32) o[c] = s[c];
}

template <typename U>
static void launch(const void* src, const void* idx, void* out, long long N,
                   long long M, long long row_bytes, cudaStream_t stream) {
  const int threads = 256;
  const long long rows_per_block = threads / 32;
  const unsigned int blocks =
      (unsigned int)((M + rows_per_block - 1) / rows_per_block);
  gather_rows_kernel<U><<<blocks, threads, 0, stream>>>(
      (const U*)src, (const int*)idx, (U*)out, N, M,
      row_bytes / (long long)sizeof(U));
}

extern "C" int gather_rows(const void* src, const void* idx, void* out,
                           long long N, long long M, long long row_bytes,
                           void* stream) {
  if (M == 0 || row_bytes == 0) return 0;
  const uintptr_t a = (uintptr_t)src | (uintptr_t)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && a % 16 == 0)
    launch<uint4>(src, idx, out, N, M, row_bytes, s);
  else if (row_bytes % 4 == 0 && a % 4 == 0)
    launch<unsigned int>(src, idx, out, N, M, row_bytes, s);
  else
    launch<unsigned char>(src, idx, out, N, M, row_bytes, s);
  return (int)cudaGetLastError();
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
