// Fused ADMM z-update: Algorithm 1 lines 13-15 in one sweep.
//
// Replaces the TPU kernel repro/kernels/soft_threshold.py:_kernel (entry
// point soft_threshold_pallas):
//   z_new = S(omega; thr)          soft threshold, the prox of l1
//   ssq   = ||z_new - z_old||^2    dual-residual term
//   nnz   = #{z_new != 0}          sparsity telemetry
// omega and z_old are (D,) float32, thr a float32 scalar.
//
// Bound on an H100: 12 D bytes (two reads and one write) at 3.35 TB/s,
// about 36 ns at the paper's D = 10 000, where the launch itself, a few
// microseconds, is the real floor; at D = 10^6 the bytes matter.
//
// Design: ``blocks`` blocks (the wrapper's ``plan``: one per 4 * 256
// elements, at most one per SM) stride over D in float4 chunks, each
// thread keeping its partial sums in registers.  A block reduces its
// partials by a fixed shuffle tree and writes them to scratch; the last
// block to arrive (an integer counter, which it resets to 0 so a replayed
// CUDA graph finds it zeroed) sums the block partials in the same fixed
// tree and writes ssq and nnz.  ssq is a fixed-order sum of the float32
// squares, accumulated in float64 and rounded once (a float32 accumulator
// strays 4e-5 relative at 2e8 elements, where a thread sums 6 000
// squares), nnz an exact integer count; there is no second launch and no
// float atomic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float shrink(float o, float thr) {
  const float mag = fabsf(o);
  return mag > thr ? (1.f - thr / (mag > 0.f ? mag : 1.f)) * o : 0.f;
}

__device__ __forceinline__ void step(float o, float zo, float thr, float* zn,
                                     double* s, int* n) {
  *zn = shrink(o, thr);
  const float diff = *zn - zo;
  *s += (double)(diff * diff);
  *n += (*zn != 0.f);
}

// the block's sums of s and n in a fixed tree; valid in thread 0
__device__ __forceinline__ void block_sum(double* s, int* n) {
  __shared__ double sh_s[kWarps];
  __shared__ int sh_n[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    *s += __shfl_xor_sync(0xffffffffu, *s, o);
    *n += __shfl_xor_sync(0xffffffffu, *n, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh_s[warp] = *s;
    sh_n[warp] = *n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    *s = 0.0;
    *n = 0;
    for (int w = 0; w < kWarps; ++w) {
      *s += sh_s[w];
      *n += sh_n[w];
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
soft_threshold_blocks(const float* __restrict__ omega,
                      const float* __restrict__ z_old, float thr,
                      float* __restrict__ z, float* __restrict__ ssq,
                      long long* __restrict__ nnz,
                      double* __restrict__ part_ssq,
                      int* __restrict__ part_nnz, int* __restrict__ arrivals,
                      int D) {
  __shared__ int is_last;
  double s = 0.0;
  int n = 0;
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  if (kVec) {
    const int D4 = D >> 2;
    const float4* o4 = reinterpret_cast<const float4*>(omega);
    const float4* zo4 = reinterpret_cast<const float4*>(z_old);
    float4* z4 = reinterpret_cast<float4*>(z);
    for (int i = first; i < D4; i += stride) {
      const float4 o = __ldg(o4 + i), zo = __ldg(zo4 + i);
      float4 zn;
      step(o.x, zo.x, thr, &zn.x, &s, &n);
      step(o.y, zo.y, thr, &zn.y, &s, &n);
      step(o.z, zo.z, thr, &zn.z, &s, &n);
      step(o.w, zo.w, thr, &zn.w, &s, &n);
      z4[i] = zn;
    }
    const int i = 4 * D4 + first;           // the last D % 4 elements
    if (i < D) step(__ldg(omega + i), __ldg(z_old + i), thr, z + i, &s, &n);
  } else {
    for (int i = first; i < D; i += stride)
      step(__ldg(omega + i), __ldg(z_old + i), thr, z + i, &s, &n);
  }
  block_sum(&s, &n);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) {
      ssq[0] = (float)s;
      nnz[0] = n;
    }
    return;
  }
  if (threadIdx.x == 0) {
    part_ssq[blockIdx.x] = s;
    part_nnz[blockIdx.x] = n;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(arrivals, 1);
    is_last = prev == (int)gridDim.x - 1;
    if (is_last) *arrivals = 0;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  s = 0.0;
  n = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    s += __ldcg(part_ssq + b);
    n += __ldcg(part_nnz + b);
  }
  block_sum(&s, &n);
  if (threadIdx.x == 0) {
    ssq[0] = (float)s;
    nnz[0] = n;
  }
}

__global__ void empty_kernel() {}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// All pointers are device pointers; part_ssq and part_nnz hold ``blocks``
// entries, arrivals one int that is zero.  Returns cudaGetLastError().
extern "C" int soft_threshold_f32(const float* omega, const float* z_old,
                                  float thr, float* z, float* ssq,
                                  long long* nnz, double* part_ssq,
                                  int* part_nnz, int* arrivals, int D,
                                  int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (aligned16(omega) && aligned16(z_old) && aligned16(z))
    soft_threshold_blocks<true><<<blocks, kThreads, 0, st>>>(
        omega, z_old, thr, z, ssq, nnz, part_ssq, part_nnz, arrivals, D);
  else
    soft_threshold_blocks<false><<<blocks, kThreads, 0, st>>>(
        omega, z_old, thr, z, ssq, nnz, part_ssq, part_nnz, arrivals, D);
  return (int)cudaGetLastError();
}

// An empty kernel: its time in a CUDA graph is the launch floor any
// kernel of this size pays.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
