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
// training shapes (4096, 2048) bf16 each way, 32 MiB: 10.0 us).  Design:
// one warp per input row, f32 atomicAdd into a zeroed f32 scratch (the
// wrapper's torch.zeros), then a second pass rounds it once to g's dtype
// (for f32 g the scratch is the output and the second pass is skipped).
// The TPU kernel keeps the whole (n, d) accumulator resident in VMEM across
// a sequential grid; CUDA blocks run in no order, so the sum across blocks
// goes through atomics instead.  With at most two addends per output row
// (every MoE path at top_k <= 2) the f32 sum 0 + a + b is the same in any
// order and is rounded once, so the result equals the reference bitwise;
// with more addends the atomics add in a run-dependent order (f32 rounding
// differences, then one bf16 rounding).  A sorted segmented reduction
// would be deterministic but needs a sort of idx per call; the MoE paths
// never have more than top_k addends per row, so atomics are kept.
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void scatter_add_rows_kernel(const T* __restrict__ g,
                                        const int* __restrict__ idx,
                                        float* __restrict__ acc, long long n,
                                        long long M, long long d) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int r = idx[row];
  if (r < 0 || r >= n) return;
  const T* s = g + row * d;
  float* o = acc + (long long)r * d;
  for (long long c = lane; c < d; c += 32) atomicAdd(o + c, to_f32(s[c]));
}

__global__ void round_to_bf16_kernel(const float* __restrict__ acc,
                                     __nv_bfloat16* __restrict__ out,
                                     long long count) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16(acc[i]);
}

// g (M, d) bf16 (is_bf16=1) or f32 (0); acc (n, d) f32 zeros; out (n, d)
// bf16 for bf16 g, unused (acc is the result) for f32 g.
extern "C" int scatter_add_rows(const void* g, const void* idx, void* acc,
                                void* out, long long n, long long M,
                                long long d, int is_bf16, void* stream) {
  if (M == 0 || d == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const unsigned int blocks =
      (unsigned int)((M + threads / 32 - 1) / (threads / 32));
  if (is_bf16) {
    scatter_add_rows_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)g, (const int*)idx, (float*)acc, n, M, d);
    const long long count = n * d;
    const long long want = (count + threads - 1) / threads;
    const unsigned int rblocks = (unsigned int)(want < 65535 * 8 ? want
                                                                 : 65535 * 8);
    round_to_bf16_kernel<<<rblocks, threads, 0, s>>>(
        (const float*)acc, (__nv_bfloat16*)out, count);
  } else {
    scatter_add_rows_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)g, (const int*)idx, (float*)acc, n, M, d);
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
