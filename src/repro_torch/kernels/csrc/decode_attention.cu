// Single-token GQA decode attention against a linear or ring KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:_kernel (entry
// point decode_attention_pallas).  For every sequence b and query head
// h = kv * G + g, with p = positions[b]:
//   slot c is live iff c <= p, or every slot is once p >= Smax (a ring
//   cache that has wrapped; softmax does not care about slot order)
//   o[b, 0, h] = sum_live softmax(<q[b, 0, h], k[b, c, kv]> hd^-1/2) v[b, c, kv]
// q and o are (B, 1, H, hd), the caches (B, Smax, KV, hd), positions (B,)
// int32: the model's layouts and strides, so no cache is transposed or
// copied per call.  Types are float32 or bfloat16, float32 accumulation.
//
// Bound on an H100: memory.  Each live K and V slot is read once and used
// for G query heads (about G flop per byte), so the least time is the live
// slots' bytes at 3.35 TB/s.
//
// Design.  The TPU grid is (B, KV, slot blocks), the slot axis in order.
// One block per (b, kv) would leave half of the 132 SMs idle at B*KV = 64,
// so the slots are cut into 256-slot chunks, one block per (chunk, b, kv):
//   1. decode_split: only chunks below the live length run.  Each warp
//      takes every 8th slot, reads a K row with one 8- or 16-byte load per
//      lane (head dims 4*lane..4*lane+3) and reduces the G dot products over
//      the warp; the chunk's max m, P = exp(s - max(m, -1e30)) and l = sum P
//      follow, P is rounded to V's type as the TPU kernel does before P.V,
//      and each warp accumulates P.V over its slots in registers; the eight
//      warps' sums add in a fixed order into (m, l, acc) for the chunk;
//   2. decode_combine: per (b, kv), the live chunks' partials merge in
//      chunk order with weights exp(m_j - max(M, -1e30)), and l == 0 -> 1.
// No atomics: a run is bitwise reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;    // cache slots per block
constexpr int kMaxHd = 128;    // 4 head dims per lane
constexpr int kUnroll = 4;     // slots in flight per warp
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  *reinterpret_cast<uint32_t*>(&a) = u.x;
  *reinterpret_cast<uint32_t*>(&b) = u.y;
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  out[0] = fa.x; out[1] = fa.y; out[2] = fb.x; out[3] = fb.y;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ int live_slots(int p, int Smax) {
  return p >= Smax ? Smax : (p < 0 ? 0 : p + 1);
}

template <typename T, int GM>
__global__ void __launch_bounds__(kThreads)
decode_split(const T* __restrict__ q, const T* __restrict__ kc,
             const T* __restrict__ vc, const int* __restrict__ positions,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc, int Smax, int KV, int G, int hd,
             int n_split, long long q_sb, long long q_sh, long long k_sb,
             long long k_ss, long long k_sh, long long v_sb, long long v_ss,
             long long v_sh, float scale) {
  __shared__ float q_s[GM][kMaxHd];
  __shared__ float s_s[GM][kChunk];
  __shared__ float red[kWarps][GM][kMaxHd];

  const int split = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / KV, kv = bkv % KV;
  const int lo = split * kChunk;
  const int hi = min(lo + kChunk, live_slots(positions[b], Smax));
  if (lo >= hi) return;            // decode_combine reads live chunks only
  const int n = hi - lo;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const T* qb = q + b * q_sb + (long long)(kv * G) * q_sh;
  for (int idx = threadIdx.x; idx < G * hd; idx += kThreads)
    q_s[idx / hd][idx % hd] = to_float(qb[(long long)(idx / hd) * q_sh
                                          + idx % hd]);
  __syncthreads();

  const int d0 = lane * 4;
  const bool dl = d0 < hd;
  float qr[GM][4];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      qr[g][e] = (g < G && dl) ? q_s[g][d0 + e] : 0.f;

  const T* kb = kc + b * k_sb + (long long)kv * k_sh + d0;
  const T* vb = vc + b * v_sb + (long long)kv * v_sh + d0;

  // scores: warp w takes slots lo + w, lo + w + 8, ...
  for (int c = lo + warp; c < hi; c += kWarps * kUnroll) {
    float kf[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int cu = c + u * kWarps;
      if (cu < hi && dl) {
        load4(kb + (long long)cu * k_ss, kf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) kf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int cu = c + u * kWarps;
      float part[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float a = qr[g][0] * kf[u][0];
        a = fmaf(qr[g][1], kf[u][1], a);
        a = fmaf(qr[g][2], kf[u][2], a);
        a = fmaf(qr[g][3], kf[u][3], a);
        part[g] = a;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < GM; ++g)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (lane == 0 && cu < hi) {
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G) s_s[g][cu - lo] = part[g] * scale;
      }
    }
  }
  __syncthreads();

  // the chunk's softmax numerators: one warp per query head
  const long long pidx = (long long)bkv * n_split + split;
  for (int g = warp; g < G; g += kWarps) {
    float mx = neg_inf();
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, s_s[g][t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_safe = fmaxf(mx, kNegInf);
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(s_s[g][t] - m_safe);
      sum += p;
      s_s[g][t] = to_float(from_float<T>(p));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      part_m[pidx * G + g] = mx;
      part_l[pidx * G + g] = sum;
    }
  }
  __syncthreads();

  float acc[GM][4];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  for (int c = lo + warp; c < hi; c += kWarps * kUnroll) {
    float vf[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int cu = c + u * kWarps;
      if (cu < hi && dl) {
        load4(vb + (long long)cu * v_ss, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int cu = c + u * kWarps;
      if (cu < hi) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float p = s_s[g][cu - lo];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
          }
        }
      }
    }
  }
  if (dl) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[warp][g][d0 + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * hd; idx += kThreads) {
    const int g = idx / hd, d = idx % hd;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][g][d];
    part_acc[(pidx * G + g) * hd + d] = t;
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
decode_combine(const int* __restrict__ positions,
               const float* __restrict__ part_m,
               const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ o,
               int Smax, int KV, int G, int hd, int n_split, long long o_sb,
               long long o_sh) {
  const int bkv = blockIdx.x;
  const int b = bkv / KV, kv = bkv % KV;
  const int n_live = (live_slots(positions[b], Smax) + kChunk - 1) / kChunk;
  const long long base = (long long)bkv * n_split;
  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x) {
    const int g = idx / hd, d = idx % hd;
    float M = neg_inf();
    for (int j = 0; j < n_live; ++j) M = fmaxf(M, part_m[(base + j) * G + g]);
    const float M_safe = fmaxf(M, kNegInf);
    float L = 0.f, A = 0.f;
    for (int j = 0; j < n_live; ++j) {
      const long long pj = (base + j) * G + g;
      const float w = expf(fmaxf(part_m[pj], kNegInf) - M_safe);
      L = fmaf(w, part_l[pj], L);
      A = fmaf(w, part_acc[pj * hd + d], A);
    }
    if (L == 0.f) L = 1.f;
    o[b * o_sb + (long long)(kv * G + g) * o_sh + d] = from_float<T>(A / L);
  }
}

template <typename T, int GM>
int launch(const void* q, const void* k, const void* v, const int* positions,
           void* o, float* scratch, int B, int Smax, int KV, int G, int hd,
           const long long* st, float scale, cudaStream_t stream) {
  const int n_split = (Smax + kChunk - 1) / kChunk;
  const long long n_part = (long long)B * KV * n_split * G;
  float* part_m = scratch;
  float* part_l = scratch + n_part;
  float* part_acc = scratch + 2 * n_part;
  decode_split<T, GM><<<dim3(n_split, B * KV), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), positions, part_m, part_l, part_acc, Smax, KV,
      G, hd, n_split, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<T><<<B * KV, 128, 0, stream>>>(
      positions, part_m, part_l, part_acc, static_cast<T*>(o), Smax, KV, G,
      hd, n_split, st[8], st[9]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* pos,
             void* o, float* scratch, int B, int Smax, int KV, int G, int hd,
             const long long* st, float scale, cudaStream_t stream) {
  if (G <= 1) return launch<T, 1>(q, k, v, pos, o, scratch, B, Smax, KV, G, hd, st, scale, stream);
  if (G <= 2) return launch<T, 2>(q, k, v, pos, o, scratch, B, Smax, KV, G, hd, st, scale, stream);
  if (G <= 4) return launch<T, 4>(q, k, v, pos, o, scratch, B, Smax, KV, G, hd, st, scale, stream);
  return launch<T, 8>(q, k, v, pos, o, scratch, B, Smax, KV, G, hd, st, scale, stream);
}

}  // namespace

// Scratch floats the caller allocates: B*KV*ceil(Smax/256)*G*(hd + 2).
extern "C" long long decode_attention_scratch(int B, int Smax, int KV, int G,
                                              int hd) {
  return (long long)B * KV * ((Smax + kChunk - 1) / kChunk) * G * (hd + 2);
}

// strides: 10 element strides: q (batch, head), k (batch, slot, head),
// v (batch, slot, head), o (batch, head); the head-dim stride is 1.
// G <= 8 and hd <= 128.  Returns the CUDA error code.
extern "C" int decode_attention_fwd(int is_bf16, const void* q, const void* k,
                                    const void* v, const int* positions,
                                    void* o, float* scratch, int B, int Smax,
                                    int KV, int G, int hd,
                                    const long long* strides, float scale,
                                    void* stream) {
  if (B * KV == 0 || Smax == 0) return 0;
  if (G > 8 || hd > kMaxHd) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, positions, o, scratch, B,
                                           Smax, KV, G, hd, strides, scale, st)
                 : dispatch<float>(q, k, v, positions, o, scratch, B, Smax,
                                   KV, G, hd, strides, scale, st);
}
