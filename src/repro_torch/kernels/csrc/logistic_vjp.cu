// Fused margin-loss value and gradient over W lanes of dense row shards.
//
// Replaces the TPU kernel repro/kernels/logistic_vjp.py:_margin_kernel
// (entry points logistic_vjp_pallas and svm_vjp_pallas): for every lane w
//   ax_n    = <a_n, x_w>
//   loss_w  = sum_n mask_n * l(b_n ax_n)        (logistic or smoothed hinge)
//   c_n     = mask_n * dl/dax_n
//   grad_w  = A_w^T c
// A is (W, N, D) float32, row-major and contiguous; b and mask are (W, N),
// x is (W, D).  Rows and columns need no padding: every kernel masks the
// ragged row and column edges itself, so nothing is copied per call.
//
// Bound on an H100: memory.  The work is 4 W N D flop against 4 W N D bytes
// of A (one flop per byte), far below the card's ~20 flop per byte balance
// point in float32, so the least time is one read of A at 3.35 TB/s.
//
// Design.  The TPU kernel keeps a 256-row tile of A (about 10 MB) in VMEM
// and carries loss and grad across an in-order row grid.  A Hopper block
// has at most 227 KB of shared memory (about five 10 000-feature rows) and
// blocks run in no order, so this first version reads A twice instead:
//   1. margin_rows: one warp per row computes ax with 16-byte loads and a
//      fixed shuffle tree, then the row's masked loss value and c_n;
//   2. margin_grad_partial: each block owns 1024 columns of one lane and a
//      contiguous range of rows, and accumulates c_n * a_n in registers;
//   3. margin_grad_finish: sums the row-range partials in a fixed order;
//   4. margin_loss_sum: one block per lane reduces the row values in a
//      fixed order.
// No float atomics anywhere, so a run is bitwise reproducible.  Reading A
// twice makes the kernel's floor two reads of A, twice the bound above;
// fusing the two passes is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 4 * kWarps;       // margin pass
constexpr int kColsPerBlock = 4 * kThreads;     // grad pass: a float4 each
constexpr int kLogistic = 0;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void row_loss(int loss, float gamma, float b,
                                         float ax, float* val, float* dldax) {
  if (loss == kLogistic) {
    const float neg_m = -b * ax;
    *val = fmaxf(neg_m, 0.f) + log1pf(expf(-fabsf(neg_m)));  // logaddexp(0, .)
    *dldax = -b * (1.f / (1.f + expf(-neg_m)));               // -b sigmoid(.)
  } else {
    const float m = b * ax;
    float v, d;
    if (m >= 1.f) {
      v = 0.f;
      d = 0.f;
    } else if (m <= 1.f - gamma) {
      v = 1.f - m - 0.5f * gamma;
      d = -1.f;
    } else {
      const float r = 1.f - m;
      v = r * r / (2.f * gamma);
      d = -r / gamma;
    }
    *val = v;
    *dldax = d * b;
  }
}

__global__ void __launch_bounds__(kThreads)
margin_rows(const float* __restrict__ A, const float* __restrict__ b,
            const float* __restrict__ mask, const float* __restrict__ x,
            float* __restrict__ coef, float* __restrict__ val,
            int N, int D, int loss, float gamma, int vec4) {
  const int w = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* xw = x + (size_t)w * D;
  const int row_end = min(N, (int)(blockIdx.x + 1) * kRowsPerBlock);
  for (int r = blockIdx.x * kRowsPerBlock + warp; r < row_end; r += kWarps) {
    const size_t i = (size_t)w * N + r;
    const float* a = A + i * D;
    float acc = 0.f;
    if (vec4) {
      const float4* a4 = reinterpret_cast<const float4*>(a);
      const float4* x4 = reinterpret_cast<const float4*>(xw);
      const int D4 = D >> 2;
      int j = lane;
      for (; j + 96 < D4; j += 128) {
        const float4 a0 = __ldg(a4 + j), a1 = __ldg(a4 + j + 32);
        const float4 a2 = __ldg(a4 + j + 64), a3 = __ldg(a4 + j + 96);
        acc += dot4(a0, __ldg(x4 + j));
        acc += dot4(a1, __ldg(x4 + j + 32));
        acc += dot4(a2, __ldg(x4 + j + 64));
        acc += dot4(a3, __ldg(x4 + j + 96));
      }
      for (; j < D4; j += 32) acc += dot4(__ldg(a4 + j), __ldg(x4 + j));
    } else {
      for (int j = lane; j < D; j += 32) acc += __ldg(a + j) * __ldg(xw + j);
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      float v, g;
      row_loss(loss, gamma, b[i], acc, &v, &g);
      const float m = mask[i];
      val[i] = m * v;
      coef[i] = m * g;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
margin_grad_partial(const float* __restrict__ A, const float* __restrict__ coef,
                    float* __restrict__ out, int W, int N, int D,
                    int rows_per_split, int vec4) {
  const int w = blockIdx.y;
  const int s = blockIdx.z;
  const int col = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (col >= D) return;
  const int r0 = s * rows_per_split;
  const int r1 = min(N, r0 + rows_per_split);
  const float* cw = coef + (size_t)w * N;
  const float* Aw = A + (size_t)w * N * D + col;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec4) {
    int r = r0;
    for (; r + 3 < r1; r += 4) {
      const float4 a0 = __ldg(reinterpret_cast<const float4*>(Aw + (size_t)r * D));
      const float4 a1 = __ldg(reinterpret_cast<const float4*>(Aw + (size_t)(r + 1) * D));
      const float4 a2 = __ldg(reinterpret_cast<const float4*>(Aw + (size_t)(r + 2) * D));
      const float4 a3 = __ldg(reinterpret_cast<const float4*>(Aw + (size_t)(r + 3) * D));
      const float c0 = __ldg(cw + r), c1 = __ldg(cw + r + 1);
      const float c2 = __ldg(cw + r + 2), c3 = __ldg(cw + r + 3);
      acc.x += c0 * a0.x; acc.y += c0 * a0.y; acc.z += c0 * a0.z; acc.w += c0 * a0.w;
      acc.x += c1 * a1.x; acc.y += c1 * a1.y; acc.z += c1 * a1.z; acc.w += c1 * a1.w;
      acc.x += c2 * a2.x; acc.y += c2 * a2.y; acc.z += c2 * a2.z; acc.w += c2 * a2.w;
      acc.x += c3 * a3.x; acc.y += c3 * a3.y; acc.z += c3 * a3.z; acc.w += c3 * a3.w;
    }
    for (; r < r1; ++r) {
      const float4 a0 = __ldg(reinterpret_cast<const float4*>(Aw + (size_t)r * D));
      const float c0 = __ldg(cw + r);
      acc.x += c0 * a0.x; acc.y += c0 * a0.y; acc.z += c0 * a0.z; acc.w += c0 * a0.w;
    }
    *reinterpret_cast<float4*>(out + ((size_t)s * W + w) * D + col) = acc;
  } else {
    const int nc = min(4, D - col);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = r0; r < r1; ++r) {
      const float c = __ldg(cw + r);
      const float* a = Aw + (size_t)r * D;
      for (int q = 0; q < nc; ++q) part[q] += c * __ldg(a + q);
    }
    float* o = out + ((size_t)s * W + w) * D + col;
    for (int q = 0; q < nc; ++q) o[q] = part[q];
  }
}

__global__ void __launch_bounds__(kThreads)
margin_grad_finish(const float* __restrict__ partial, float* __restrict__ grad,
                   int W, int D, int splits) {
  const int w = blockIdx.y;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= D) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[((size_t)k * W + w) * D + col];
  grad[(size_t)w * D + col] = s;
}

__global__ void __launch_bounds__(kThreads)
margin_loss_sum(const float* __restrict__ val, float* __restrict__ loss, int N) {
  __shared__ float sh[kThreads];
  const float* v = val + (size_t)blockIdx.x * N;
  float s = 0.f;
  for (int r = threadIdx.x; r < N; r += kThreads) s += v[r];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) sh[threadIdx.x] += sh[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) loss[blockIdx.x] = sh[0];
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// All pointers are device pointers; coef and val hold W*N floats and
// partial splits*W*D floats of scratch (unused when splits == 1).
// Returns cudaGetLastError() after the launches.
extern "C" int margin_vjp_f32(const float* A, const float* b, const float* mask,
                              const float* x, float* loss, float* grad,
                              float* coef, float* val, float* partial,
                              int W, int N, int D, int splits, int loss_kind,
                              float gamma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0) {
    cudaMemsetAsync(loss, 0, sizeof(float) * (size_t)W, st);
    cudaMemsetAsync(grad, 0, sizeof(float) * (size_t)W * D, st);
    return (int)cudaGetLastError();
  }
  const int vec4 = (D % 4 == 0) && aligned16(A) && aligned16(x);
  const dim3 g_rows((N + kRowsPerBlock - 1) / kRowsPerBlock, W);
  margin_rows<<<g_rows, kThreads, 0, st>>>(A, b, mask, x, coef, val, N, D,
                                           loss_kind, gamma, vec4);
  const int rows_per_split = (N + splits - 1) / splits;
  const dim3 g_part((D + kColsPerBlock - 1) / kColsPerBlock, W, splits);
  margin_grad_partial<<<g_part, kThreads, 0, st>>>(
      A, coef, splits == 1 ? grad : partial, W, N, D, rows_per_split, vec4);
  if (splits > 1) {
    const dim3 g_fin((D + kThreads - 1) / kThreads, W);
    margin_grad_finish<<<g_fin, kThreads, 0, st>>>(partial, grad, W, D, splits);
  }
  margin_loss_sum<<<W, kThreads, 0, st>>>(val, loss, N);
  return (int)cudaGetLastError();
}
