// Fused softmax statistics + top-k gate (paper §3.2 "Gate Optimization").
//
// Replaces the TPU kernel repro/kernels/topk_gate.py:_topk_gate_kernel
// (pallas_call in fused_topk_gate).  For each row of logits (S, E) f32:
//   rowmax = max_e x,  sumexp = Σ_e exp(x - rowmax),
//   k rounds of argmax with lowest-index ties, each winner masked to -inf.
//
// Bound on the H100: the launch.  The bytes are tiny (at S=8192, E=128 the
// logits are 4 MiB, 1.3 us at 3.35 TB/s; at E=16 0.25 us), so the kernel's
// time is one launch plus the longest chain of dependent steps of one
// thread: its load, then the reductions.
//
// Design: a row is held in registers, loaded once, as 16-byte vectors with
// neighbouring lanes on neighbouring addresses.  A row gets L lanes, each
// holding W*NV values (W=4: NV float4 loads; W=1: the scalar path for E not
// a multiple of 4): at E=16 a row is 4 lanes of one float4 and a warp holds
// 8 rows; at E=128 a row is 16 lanes of two (2 rows a warp: 0.0035 ms on
// an H100 80GB HBM3 at 700 W, where 32 lanes of one took 0.0038 and 8 of
// four 0.0036; gate_gather_ab.py).  Every reduction is a butterfly of
// log2(L) shuffles inside the row's lanes (2 steps at E=16, 4 at E=128).
// Round 0's argmax is also the row max, so sumexp follows it with one more
// butterfly.  A winner is masked in the registers of the lane that holds
// it (each lane compares its own compile-time columns with the winning
// index), so nothing lives in local memory.  k, L, NV and W are template
// parameters: the loops unroll and the host picks the instance.  A masked
// column stays a candidate at -inf, so when the rest of a row is -inf a
// round picks the lowest such column, chosen or not, as the reference's
// `min(where(cur == m, iota, E))` does; the padding past E reads -inf at
// an index >= E, so it never beats a column of the row.  Rows are bounded
// by S, so no -inf rows are padded on (the Pallas version pads to its
// block).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TOPK_MAX_K 8
#define TOPK_MAX_E 512
#define TOPK_THREADS 256

// (v, i) beats (w, j): a larger value, or an equal one at a lower index
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

template <int L>
__device__ __forceinline__ void row_argmax(float& v, int& i) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <int L>
__device__ __forceinline__ float row_sum(float s) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// L lanes per row; each lane loads NV times W consecutive values, its
// value e = j*W + t sitting at column (j*L + sub)*W + t.
template <int K, int L, int NV, int W>
__global__ void __launch_bounds__(TOPK_THREADS)
topk_gate_kernel(const float* __restrict__ logits, float* __restrict__ vals,
                 int* __restrict__ idx, float* __restrict__ rowmax,
                 float* __restrict__ sumexp, int S, int E) {
  constexpr int V = NV * W;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / L;
  const int sub = (int)(t % L);
  // a row past S still takes part in its warp's shuffles; it writes nothing
  const bool live = row < S;
  const float* x = logits + (live ? row : 0) * (long long)E;

  float v[V];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c0 = (j * L + sub) * W;
    if constexpr (W == 4) {
      float4 q = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (live && c0 < E) q = *reinterpret_cast<const float4*>(x + c0);
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    } else {
      v[j] = (live && c0 < E) ? x[c0] : -INFINITY;
    }
  }
  auto col = [&](int e) { return ((e / W) * L + sub) * W + e % W; };

  float out_v[K];
  int out_i[K];
  float m = 0.f, s = 0.f;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    // this lane's best, then the row's; columns rise with e, so a strict >
    // keeps the lowest of equal values
    float bv = v[0];
    int bi = col(0);
#pragma unroll
    for (int e = 1; e < V; ++e)
      if (v[e] > bv) {
        bv = v[e];
        bi = col(e);
      }
    row_argmax<L>(bv, bi);
    out_v[r] = bv;
    out_i[r] = bi;
    if (r == 0) {
      m = bv;
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (col(e) < E) s += expf(v[e] - m);
      s = row_sum<L>(s);
    }
    if (r + 1 < K) {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (col(e) == bi) v[e] = -INFINITY;
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < K; ++r)
    if (sub == r % L) {
      vals[row * K + r] = out_v[r];
      idx[row * K + r] = out_i[r];
    }
  if (sub == 0) {
    rowmax[row] = m;
    sumexp[row] = s;
  }
}

template <int K, int L, int NV, int W>
static void launch(const float* logits, float* vals, int* idx, float* rowmax,
                   float* sumexp, int S, int E, cudaStream_t stream) {
  const long long threads = (long long)S * L;
  const unsigned int blocks =
      (unsigned int)((threads + TOPK_THREADS - 1) / TOPK_THREADS);
  topk_gate_kernel<K, L, NV, W><<<blocks, TOPK_THREADS, 0, stream>>>(
      logits, vals, idx, rowmax, sumexp, S, E);
}

// The instance for E: 16-byte loads where E is a multiple of 4 and the
// logits 16-byte aligned (a row on E/4 lanes rounded up to a power of two
// up to E=64, then 16 or 32 lanes of NV float4), else one float per load
// over the whole warp.  At most 16 values a lane: ptxas spilled an
// instance of 32 (k=2, E up to 1024), so E stops at TOPK_MAX_E = 512.
template <int K>
static void launch_k(const float* x, float* vals, int* idx, float* rowmax,
                     float* sumexp, int S, int E, cudaStream_t s) {
#define TOPK_GO(L, NV, W)                                            \
  do {                                                               \
    launch<K, L, NV, W>(x, vals, idx, rowmax, sumexp, S, E, s);      \
    return;                                                          \
  } while (0)
  if (E % 4 == 0 && (uintptr_t)x % 16 == 0) {
    if (E <= 4) TOPK_GO(1, 1, 4);
    if (E <= 8) TOPK_GO(2, 1, 4);
    if (E <= 16) TOPK_GO(4, 1, 4);
    if (E <= 32) TOPK_GO(8, 1, 4);
    if (E <= 64) TOPK_GO(16, 1, 4);
    if (E <= 128) TOPK_GO(16, 2, 4);
    if (E <= 256) TOPK_GO(32, 2, 4);
    TOPK_GO(32, 4, 4);
  }
  if (E <= 32) TOPK_GO(32, 1, 1);
  if (E <= 64) TOPK_GO(32, 2, 1);
  if (E <= 128) TOPK_GO(32, 4, 1);
  if (E <= 256) TOPK_GO(32, 8, 1);
  TOPK_GO(32, 16, 1);
#undef TOPK_GO
}

extern "C" int topk_gate_f32(const void* logits, void* vals, void* idx,
                             void* rowmax, void* sumexp, int S, int E, int k,
                             void* stream) {
  if (k < 1 || k > TOPK_MAX_K || k > E || E > TOPK_MAX_E)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const float* x = (const float*)logits;
  float* v = (float*)vals;
  int* i = (int*)idx;
  float* m = (float*)rowmax;
  float* se = (float*)sumexp;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: launch_k<1>(x, v, i, m, se, S, E, s); break;
    case 2: launch_k<2>(x, v, i, m, se, S, E, s); break;
    case 3: launch_k<3>(x, v, i, m, se, S, E, s); break;
    case 4: launch_k<4>(x, v, i, m, se, S, E, s); break;
    case 5: launch_k<5>(x, v, i, m, se, S, E, s); break;
    case 6: launch_k<6>(x, v, i, m, se, S, E, s); break;
    case 7: launch_k<7>(x, v, i, m, se, S, E, s); break;
    default: launch_k<8>(x, v, i, m, se, S, E, s); break;
  }
  return (int)cudaGetLastError();
}

// The launch floor: a kernel that does nothing.  chip_smoke.py times it by
// graph replay beside the gate, whose own bytes lie below one launch.
__global__ void empty_kernel() {}

extern "C" int launch_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
