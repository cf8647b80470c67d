// Fused softmax statistics + top-k gate (paper §3.2 "Gate Optimization").
//
// Replaces the TPU kernel repro/kernels/topk_gate.py:_topk_gate_kernel
// (pallas_call in fused_topk_gate).  For each row of logits (S, E) f32:
//   rowmax = max_e x,  sumexp = Σ_e exp(x - rowmax),
//   k rounds of argmax with lowest-index ties, each winner masked to -inf.
//
// Bound on the H100: bytes, and tiny ones — at S=4096, E=16 the logits are
// 256 KiB, so the launch itself is most of the cost.  Design: one warp per
// row, lanes stride over E, warp-shuffle reductions for the max, Σexp and
// each (value, index) argmax.  The logits are read once from device memory
// (the k rounds re-read them from L1).  Rows are bounded by S, so no -inf
// padding is needed (the Pallas version pads to its block).
#include <cuda_runtime.h>
#include <math.h>

#define TOPK_MAX_K 8

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void topk_gate_kernel(const float* __restrict__ logits,
                                 float* __restrict__ vals,
                                 int* __restrict__ idx,
                                 float* __restrict__ rowmax,
                                 float* __restrict__ sumexp,
                                 int S, int E, int k) {
  // blockDim.x is a multiple of 32, so a warp's lanes share one row and
  // leave together
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= S) return;
  const float* x = logits + row * E;

  float m = -INFINITY;
  for (int c = lane; c < E; c += 32) m = fmaxf(m, x[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  float s = 0.f;
  for (int c = lane; c < E; c += 32) s += expf(x[c] - m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);

  // k rounds of iterative max.  A chosen index reads as -inf afterwards,
  // exactly as the reference's `cur = where(iota == am, -inf, cur)`; the
  // sentinel index E loses every tie, like its `min(where(cur == m, iota, E))`.
  int chosen[TOPK_MAX_K];
  for (int j = 0; j < k; ++j) {
    float v = -INFINITY;
    int i = E;
    for (int c = lane; c < E; c += 32) {
      bool taken = false;
      for (int t = 0; t < j; ++t) taken |= (chosen[t] == c);
      const float val = taken ? -INFINITY : x[c];
      if (val > v || (val == v && c < i)) {
        v = val;
        i = c;
      }
    }
    warp_argmax(v, i);
    chosen[j] = i;
    if (lane == 0) {
      vals[row * k + j] = v;
      idx[row * k + j] = i;
    }
  }
  if (lane == 0) {
    rowmax[row] = m;
    sumexp[row] = s;
  }
}

extern "C" int topk_gate_f32(const void* logits, void* vals, void* idx,
                             void* rowmax, void* sumexp, int S, int E, int k,
                             void* stream) {
  if (k < 1 || k > TOPK_MAX_K || k > E) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const int threads = 256;
  const int rows_per_block = threads / 32;
  const int blocks = (S + rows_per_block - 1) / rows_per_block;
  topk_gate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)logits, (float*)vals, (int*)idx, (float*)rowmax,
      (float*)sumexp, S, E, k);
  return (int)cudaGetLastError();
}

// The launch floor: a kernel that does nothing.  chip_smoke.py times it by
// graph replay beside the gate, whose own work (0.1 us of bytes at S=4096)
// lies far below one launch.
__global__ void empty_kernel() {}

extern "C" int launch_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
