// Row gather of the layout transform (paper §3.2 "Layout Transform
// Optimization", Fig. 4): out[i] = src[idx[i]], a zero row where idx[i] < 0.
//
// Replaces the TPU kernel repro/kernels/layout_transform.py:
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

// Message for a code returned by any entry point of this library.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
