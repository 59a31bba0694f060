// Fused margin-loss value and gradient over W lanes of dense row shards.
//
// Replaces the TPU kernel repro/kernels/logistic_vjp.py:_margin_kernel
// (entry points logistic_vjp_pallas and svm_vjp_pallas): for every lane w
//   ax_n    = <a_n, x_w>
//   loss_w  = sum_n mask_n * l(b_n ax_n)        (logistic or smoothed hinge)
//   c_n     = mask_n * dl/dax_n
//   grad_w  = A_w^T c
// A is (W, N, D) float32, row-major and contiguous; b and mask are (W, N),
// x is (W, D).  Rows and columns need no padding: nothing is copied per
// call.
//
// Bound on an H100: memory.  The work is 4 W N D flop against 4 W N D bytes
// of A (one flop per byte), far below the card's ~20 flop per byte balance
// point in float32, so the least time is one read of A at 3.35 TB/s.
//
// Design: one launch that reads each row of A from device memory once.
// The TPU kernel keeps a 256-row tile (about 10 MB) in VMEM and carries
// loss and grad across an in-order row grid; a Hopper block has 227 KB and
// blocks run in no order, so:
//   * The W N rows, flattened, are split into G contiguous ranges that
//     differ by at most one row, one per block (one per cluster of C blocks
//     when a row is too wide for one block): a single wave, no tail.  A
//     range may cross lane boundaries.
//   * Rows stream through a ring of shared-memory stages: one thread issues
//     a bulk copy (1-d TMA) per stage, completing on the stage's mbarrier;
//     rows that are not 16-byte aligned go by 4-byte cp.async instead (the
//     kBulk template argument), into the same ring.
//   * Thread t owns the float4 column chunks t + k T (k < K): x_w and the
//     gradient partial live in registers.  Per row each thread reads its
//     chunks from the ring once, forms its partial dot, reduces it by a
//     fixed shuffle tree, and one barrier later every thread sums the warp
//     values in the same order, so all hold the same ax and c; then each
//     reads its chunks from the ring a second time and adds c a (holding
//     the row in registers as well would spill at K = 5, the paper
//     shape's); thread 0 adds the row's loss to a compensated sum.  The
//     second read comes after the row's barrier, so a stage is free only
//     after the next row's barrier: the loader refills the stage of block
//     b - 1 just after the first row barrier of block b.
//   * A row wider than one block's registers hold (4 T K floats, 10 240
//     with bulk copies and 8 192 with cp.async at T = 512) is split
//     over a cluster of C blocks by columns: each block posts its partial
//     dot to shared memory and, after a cluster barrier, reads all C from
//     distributed shared memory in rank order.
//   * When a block leaves lane w (or its range ends) it writes its gradient
//     and loss partials to scratch slot g + w (unique: along the row order
//     g + w only grows) and counts itself in lane w's integer arrival
//     counter; the last block to arrive sums the lane's slots in block
//     order, writes grad[w] and loss[w] and resets the counter to 0 (so a
//     replayed CUDA graph finds it zeroed).  A lane that one block covers
//     alone is written directly.
// No float atomics anywhere, so a run is bitwise reproducible.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kLogistic = 0;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxChunks = 5;         // K: float4 chunks per thread
constexpr int kMaxStages = 8;

struct Params {
  const float* A;
  const float* b;
  const float* mask;
  const float* x;
  float* loss;
  float* grad;
  float* part_grad;        // (G + W - 1, D) gradient partials
  float* part_loss;        // (G + W - 1,) loss partials
  int* arrivals;           // (W, C) arrival counters, zero between calls
  long long N;
  int W, D;
  int groups;              // G: row ranges
  int cluster;             // C: blocks per row range, split by columns
  int cols;                // columns per block (the last may hold fewer)
  int pitch;               // floats per row slot in the ring
  int rows_per_stage;
  int stages;
  int loss_kind;
  float gamma;
};

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

// hopper::mbar_wait that traps instead of spinning for ever (after 2^26
// polls, seconds, where a stage lands in microseconds): a fault in the
// ring's phases ends the launch with an error rather than hanging the card
__device__ __forceinline__ void wait_or_trap(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// the range index that holds flattened row r: ranges of q + 1 rows come
// first (rem of them), then ranges of q rows
__device__ __forceinline__ int range_of(long long r, long long q,
                                        long long rem) {
  const long long cut = rem * (q + 1);
  return (int)(r < cut ? r / (q + 1) : rem + (r - cut) / q);
}

// kBulk: rows by bulk copy (D % 4 == 0 and 16-byte aligned A and x), else
// by 4-byte cp.async with the row slots' pad columns held at zero
template <int K, bool kBulk>
__global__ void __launch_bounds__(kMaxThreads, 1)
margin_one_pass(const Params p) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ float warp_sum[2][kMaxWarps];
  __shared__ float block_sum[2];
  __shared__ int is_last;

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_warps = T >> 5;
  const int C = p.cluster;
  const int rank = blockIdx.x % C;
  const int g = blockIdx.x / C;
  const long long R = (long long)p.W * p.N;
  const long long q = R / p.groups, rem = R % p.groups;
  const long long r0 = g * q + min((long long)g, rem);
  const long long r1 = r0 + q + (g < rem ? 1 : 0);
  const int col0 = rank * p.cols;
  const int width = min(p.cols, p.D - col0);
  const int RS = p.rows_per_stage, S = p.stages;
  const int stage_floats = RS * p.pitch;
  const long long n_blk = (r1 - r0 + RS - 1) / RS;

  if (tid == 0) {
    for (int s = 0; s < S; ++s)
      hopper::mbar_init(hopper::smem_u32(&full[s]), kBulk ? 1 : T);
    hopper::fence_mbar_init();
  }
  if (!kBulk && width < p.pitch) {
    const int pad = p.pitch - width;
    for (int e = tid; e < S * RS * pad; e += T)
      ring[(e / pad) * p.pitch + width + e % pad] = 0.f;
  }
  __syncthreads();

  // block ``blk`` of RS rows into stage blk % S: the whole stage in one
  // bulk copy when a block owns whole rows, else one per row slice
  auto issue = [&](long long blk) {
    const long long rb = r0 + blk * RS;
    const int nb = (int)min((long long)RS, r1 - rb);
    float* dst = ring + (int)(blk % S) * stage_floats;
    const uint32_t bar = hopper::smem_u32(&full[blk % S]);
    const float* src = p.A + rb * p.D + col0;
    if (kBulk) {
      const uint32_t row_bytes = 4u * width;
      hopper::mbar_expect_tx(bar, nb * row_bytes);
      if (width == p.D) {
        hopper::bulk_load(hopper::smem_u32(dst), src, nb * row_bytes, bar);
      } else {
        for (int i = 0; i < nb; ++i)
          hopper::bulk_load(hopper::smem_u32(dst + i * p.pitch),
                            src + (long long)i * p.D, row_bytes, bar);
      }
    } else {
      for (int e = tid; e < nb * width; e += T) {
        const int i = e / width, c = e - i * width;
        hopper::cp_async4(hopper::smem_u32(dst + i * p.pitch + c),
                          src + (long long)i * p.D + c);
      }
      hopper::cp_async_mbar_arrive(bar);
    }
  };
  const long long first = min((long long)S, n_blk);
  if (!kBulk || tid == 0)
    for (long long blk = 0; blk < first; ++blk) issue(blk);
  // block ``blk`` into the stage that block blk - S held, once every
  // thread's last read of that stage is done
  auto refill = [&](long long blk) {
    if (!kBulk) {
      issue(blk);
    } else if (tid == 0) {
      hopper::fence_proxy_async();
      issue(blk);
    }
  };

  bool valid[K];
#pragma unroll
  for (int k = 0; k < K; ++k) valid[k] = 4 * (tid + k * T) < width;

  float4 xr[K], gr[K];
  // thread 0's loss in row order, with Neumaier's compensation: a plain
  // running sum over thousands of rows drifts by ~1e-5 relative, enough to
  // move FISTA's float32 sufficient-decrease and monotone tests
  float loss_acc = 0.f, loss_comp = 0.f;
  int cur = -1;                   // the lane being accumulated

  // leaves lane w: its partials to scratch (or to the output when this
  // range holds the whole lane); the lane's last block combines
  auto flush = [&](int w) {
    const int gf = range_of((long long)w * p.N, q, rem);
    const int gl = range_of((long long)(w + 1) * p.N - 1, q, rem);
    float* dst = gf == gl ? p.grad + (long long)w * p.D
                          : p.part_grad + (long long)(g + w) * p.D;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = 4 * (tid + k * T);
      if (!valid[k]) continue;
      if (kBulk) {
        *reinterpret_cast<float4*>(dst + col0 + c) = gr[k];
      } else {
        dst[col0 + c] = gr[k].x;
        if (c + 1 < width) dst[col0 + c + 1] = gr[k].y;
        if (c + 2 < width) dst[col0 + c + 2] = gr[k].z;
        if (c + 3 < width) dst[col0 + c + 3] = gr[k].w;
      }
    }
    if (tid == 0 && rank == 0) {
      if (gf == gl) p.loss[w] = loss_acc + loss_comp;
      else p.part_loss[g + w] = loss_acc + loss_comp;
    }
    if (gf == gl) return;
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* ctr = p.arrivals + (long long)w * C + rank;
      const int prev = atomicAdd(ctr, 1);
      is_last = prev == gl - gf;
      if (is_last) *ctr = 0;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    for (int c = tid; c < width; c += T) {
      float s = 0.f;
      for (int j = gf; j <= gl; ++j)
        s += __ldcg(p.part_grad + (long long)(j + w) * p.D + col0 + c);
      p.grad[(long long)w * p.D + col0 + c] = s;
    }
    if (tid == 0 && rank == 0) {
      float s = 0.f;
      for (int j = gf; j <= gl; ++j) s += __ldcg(p.part_loss + j + w);
      p.loss[w] = s;
    }
  };

  int par = 0;
  float b_next = __ldg(p.b + r0), m_next = __ldg(p.mask + r0);
  for (long long blk = 0; blk < n_blk; ++blk) {
    const int s = (int)(blk % S);
    wait_or_trap(hopper::smem_u32(&full[s]), (uint32_t)((blk / S) & 1));
    const long long rb = r0 + blk * RS;
    const int nb = (int)min((long long)RS, r1 - rb);
    const float* stage = ring + s * stage_floats;
    for (int i = 0; i < nb; ++i) {
      const long long r = rb + i;
      const int w = (int)(r / p.N);
      if (w != cur) {
        if (cur >= 0) flush(cur);
        const float* xw = p.x + (long long)w * p.D + col0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int c = 4 * (tid + k * T);
          gr[k] = make_float4(0.f, 0.f, 0.f, 0.f);
          xr[k] = gr[k];
          if (!valid[k]) continue;
          if (kBulk) {
            xr[k] = __ldg(reinterpret_cast<const float4*>(xw + c));
          } else {
            xr[k].x = __ldg(xw + c);
            if (c + 1 < width) xr[k].y = __ldg(xw + c + 1);
            if (c + 2 < width) xr[k].z = __ldg(xw + c + 2);
            if (c + 3 < width) xr[k].w = __ldg(xw + c + 3);
          }
        }
        loss_acc = loss_comp = 0.f;
        cur = w;
      }
      // b and mask one row ahead, off the row's dependency chain
      const float bi = b_next, mi = m_next;
      if (r + 1 < r1) {
        b_next = __ldg(p.b + r + 1);
        m_next = __ldg(p.mask + r + 1);
      }
      const float4* row = reinterpret_cast<const float4*>(stage + i * p.pitch);
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 v = valid[k] ? row[tid + k * T]
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        dot += dot4(v, xr[k]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) warp_sum[par][warp] = dot;
      __syncthreads();
      // every thread has read the previous row a second time, before this
      // barrier: the stage of block blk - 1 is free
      if (i == 0 && blk > 0 && blk - 1 + S < n_blk) refill(blk - 1 + S);
      float ax = 0.f;
      for (int v = 0; v < n_warps; ++v) ax += warp_sum[par][v];
      if (C > 1) {
        if (tid == 0) block_sum[par] = ax;
        hopper::cluster_sync();
        ax = 0.f;
        const uint32_t addr = hopper::smem_u32(&block_sum[par]);
        for (int v = 0; v < C; ++v) ax += hopper::ld_cluster_f32(addr, v);
      }
      float val, dl;
      row_loss(p.loss_kind, p.gamma, bi, ax, &val, &dl);
      const float c = mi * dl;
      if (tid == 0) {
        const float v = mi * val, t = loss_acc + v;
        loss_comp += fabsf(loss_acc) >= fabsf(v) ? (loss_acc - t) + v
                                                 : (v - t) + loss_acc;
        loss_acc = t;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float4 v = valid[k] ? row[tid + k * T]
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        gr[k].x += c * v.x;
        gr[k].y += c * v.y;
        gr[k].z += c * v.z;
        gr[k].w += c * v.w;
      }
      par ^= 1;
    }
  }
  flush(cur);
  // no block of a cluster leaves while another may still read its
  // block_sum
  if (C > 1) hopper::cluster_sync();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int K, bool kBulk>
cudaError_t launch(const Params& p, int threads, cudaStream_t st) {
  auto kern = margin_one_pass<K, kBulk>;
  const size_t smem = sizeof(float) * (size_t)p.stages * p.rows_per_stage * p.pitch;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.groups * p.cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, p);
}

// K up to 5 with the bulk loader and up to 4 with the cp.async one, whose
// loader and masked loads take more registers: at 512 threads ptxas has
// 128 registers, and phase 1 of chip_smoke.py fails on a spill
template <bool kBulk>
cudaError_t dispatch(const Params& p, int threads, int chunks, cudaStream_t st) {
  switch (chunks) {
    case 1: return launch<1, kBulk>(p, threads, st);
    case 2: return launch<2, kBulk>(p, threads, st);
    case 3: return launch<3, kBulk>(p, threads, st);
    case 4: return launch<4, kBulk>(p, threads, st);
    case 5: return kBulk ? launch<5, true>(p, threads, st)
                         : cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// All pointers are device pointers.  The plan (groups, cluster, cols,
// threads, chunks, rows_per_stage, stages) and the loader (bulk) come from
// the wrapper's ``plan``; part_grad holds (groups + W - 1) * D floats,
// part_loss groups + W - 1, arrivals W * cluster ints that are zero.
// Returns the launch's CUDA error code (0 on success).
extern "C" int margin_vjp_f32(const float* A, const float* b, const float* mask,
                              const float* x, float* loss, float* grad,
                              float* part_grad, float* part_loss, int* arrivals,
                              int W, int N, int D, int groups, int cluster,
                              int cols, int threads, int chunks,
                              int rows_per_stage, int stages, int bulk,
                              int loss_kind, float gamma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0) {
    cudaMemsetAsync(loss, 0, sizeof(float) * (size_t)W, st);
    cudaMemsetAsync(grad, 0, sizeof(float) * (size_t)W * D, st);
    return (int)cudaGetLastError();
  }
  if (threads % 32 || threads < 32 || threads > kMaxThreads ||
      chunks < 1 || chunks > kMaxChunks || stages < 2 ||
      stages > kMaxStages || cluster < 1 || cluster > 8 ||
      (long long)threads * chunks * 4 < cols || groups < 1 ||
      (long long)groups > (long long)W * N ||
      (bulk && !(D % 4 == 0 && cols % 4 == 0 && aligned16(A) &&
                 aligned16(x) && aligned16(grad) && aligned16(part_grad))))
    return (int)cudaErrorInvalidValue;
  Params p{A, b, mask, x, loss, grad, part_grad, part_loss, arrivals,
           (long long)N, W, D, groups, cluster, cols,
           (cols + 3) / 4 * 4, rows_per_stage, stages, loss_kind, gamma};
  const cudaError_t e = bulk ? dispatch<true>(p, threads, chunks, st)
                             : dispatch<false>(p, threads, chunks, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
