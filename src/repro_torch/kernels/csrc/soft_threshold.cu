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
// about 36 ns at the paper's D = 10 000, so the launch itself, a few
// microseconds, is the real floor.  The design spends nothing on it: one
// block of 1024 threads walks D with a stride, keeps its partial sums in
// registers, and reduces them through shared memory in a fixed tree.  ssq
// is therefore a fixed-order sum, nnz an exact integer count, and there is
// no second launch and no atomic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
soft_threshold_kernel(const float* __restrict__ omega,
                      const float* __restrict__ z_old, float thr,
                      float* __restrict__ z, float* __restrict__ ssq,
                      long long* __restrict__ nnz, int D) {
  __shared__ float sh_s[kThreads];
  __shared__ int sh_n[kThreads];
  float s = 0.f;
  int n = 0;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float o = omega[i];
    const float mag = fabsf(o);
    const float zn = mag > thr ? (1.f - thr / (mag > 0.f ? mag : 1.f)) * o : 0.f;
    z[i] = zn;
    const float diff = zn - z_old[i];
    s += diff * diff;
    n += (zn != 0.f);
  }
  sh_s[threadIdx.x] = s;
  sh_n[threadIdx.x] = n;
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) {
      sh_s[threadIdx.x] += sh_s[threadIdx.x + o];
      sh_n[threadIdx.x] += sh_n[threadIdx.x + o];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    ssq[0] = sh_s[0];
    nnz[0] = sh_n[0];
  }
}

}  // namespace

// All pointers are device pointers.  Returns cudaGetLastError().
extern "C" int soft_threshold_f32(const float* omega, const float* z_old,
                                  float thr, float* z, float* ssq,
                                  long long* nnz, int D, void* stream) {
  soft_threshold_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      omega, z_old, thr, z, ssq, nnz, D);
  return (int)cudaGetLastError();
}
