// Causal (optionally sliding-window) GQA attention forward, online softmax.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_kernel (entry
// point flash_attention_pallas).  For every sequence b, query head
// h = kv * G + g and position i:
//   s_c   = <q[b, i, h], k[b, c, kv]> * hd^-1/2   over the visible keys c
//           (c <= i; and c > i - window when a window is given)
//   o     = sum_c softmax(s)_c v[b, c, kv]
// q and o are (B, S, H, hd), k and v (B, Skv, KV, hd), in the model's own
// layout and strides: nothing is transposed or copied per call.  Types are
// float32 or bfloat16 with float32 accumulation.
//
// Numerics are the TPU kernel's: m_safe = max(m_new, -1e30), the alpha
// rescale of the running sums, l == 0 -> 1, and P rounded to V's type
// before P.V (l sums the unrounded P).
//
// Bound on an H100: operations.  The work is 4 B H hd flop per visible
// (query, key) pair against (q + k + v + o) bytes read or written once; at
// prefill lengths that is hundreds of flop per byte, above the balance
// point, so the least time is the valid pairs' flop at the bf16 tensor-core
// rate.  Two bodies share the design below: bf16 with hd 64 or 128 (the
// serving path) runs its products on the tensor cores with mma.sync
// m16n8k16 (flash_fwd_mma); float32 and other head dims run scalar float32
// FMAs (flash_fwd), whose peak is 67 TFLOP/s.  wgmma, TMA and a pipelined
// K/V ring are later work.
//
// Design.  The TPU grid is (B*KV, q blocks, kv blocks) with the kv axis
// innermost and in order, carrying (acc, m, l) in VMEM scratch.  Here one
// block owns 64 query rows of one (b, kv) and loops over 64-key tiles:
//   * rows are position-major (row = i * G + g), so the G query heads of
//     one KV head share every K/V tile the block streams through shared
//     memory (K/V read once per KV head, as on the TPU) and any G works;
//   * the loop's bounds cover only tiles that hold a visible key for some
//     row (below the causal diagonal, inside the window), so fully masked
//     tiles cost nothing, as the TPU's pl.when skip;
//   * ragged edges (G*S rows, Skv keys, not multiples of 64) are masked in
//     the kernel rather than by shrinking the tile;
//   * flash_fwd: 256 threads as 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3, keys
//     tx + 16j of the score tile and head dims 4tx + 64j of the output, so
//     a row's max and sum reduce over the 16 lanes of one half warp and the
//     rescale by alpha stays in registers;
//   * K rows are padded in shared memory (stride = hd rounded up to 32,
//     plus 4 floats) so the 16 float4 reads of a half warp hit distinct
//     banks;
//   * blocks are issued longest tile first, to shorten the causal tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kMaxHd = 128;
constexpr int kLdP = kKeys + 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;  // elements per 16-byte load
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static float round(float x) { return x; }
  __device__ static void store4(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      *reinterpret_cast<uint32_t*>(&h) = w[i];
      const float2 f = __bfloat1622float2(h);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static void store4(__nv_bfloat16* p, const float* x) {
    __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&a);
    u.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

__host__ __device__ inline int ld_qk(int hd) { return (hd + 31) / 32 * 32 + 4; }

__host__ inline size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)(kRows + kKeys) * ld_qk(hd) +
                          (size_t)kKeys * kMaxHd + (size_t)kRows * kLdP);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int Skv, int KV,
          int G, int hd, long long q_sb, long long q_ss, long long q_sh,
          long long k_sb, long long k_ss, long long k_sh, long long v_sb,
          long long v_ss, long long v_sh, long long o_sb, long long o_ss,
          long long o_sh, float scale, int causal, int window) {
  extern __shared__ float4 smem4[];
  const int ld = ld_qk(hd);
  float* q_s = reinterpret_cast<float*>(smem4);   // [kRows][ld]
  float* k_s = q_s + kRows * ld;                  // [kKeys][ld]
  float* v_s = k_s + kKeys * ld;                  // [kKeys][kMaxHd]
  float* p_s = v_s + kKeys * kMaxHd;              // [kRows][kLdP]

  constexpr int V = Vec<T>::kN;
  const int nch = hd / V;
  const int tile = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int b = blockIdx.y / KV;
  const int kv = blockIdx.y % KV;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int n_rows = G * S;
  const int r0 = tile * kRows;

  const T* qb = q + b * q_sb + (long long)(kv * G) * q_sh;
  const T* kb = k + b * k_sb + (long long)kv * k_sh;
  const T* vb = v + b * v_sb + (long long)kv * v_sh;

  for (int idx = threadIdx.x; idx < kRows * nch; idx += kThreads) {
    const int rr = idx / nch, ch = idx % nch;
    const int R = r0 + rr;
    float t[V];
    if (R < n_rows) {
      Vec<T>::load(qb + (long long)(R / G) * q_ss + (long long)(R % G) * q_sh
                       + ch * V, t);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) q_s[rr * ld + ch * V + e] = t[e];
  }

  int qpos[4];
  bool rvalid[4];
  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int R = r0 + ty * 4 + j;
    rvalid[j] = R < n_rows;
    qpos[j] = R / G;
    m[j] = neg_inf();
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
  }

  const int p_first = r0 / G;
  const int p_last = min(S - 1, (r0 + kRows - 1) / G);
  const int kv_end = causal ? min(Skv, p_last + 1) : Skv;
  const int kv_begin = (causal && window > 0) ? max(0, p_first - window + 1)
                                              : 0;

  for (int c0 = kv_begin / kKeys * kKeys; c0 < kv_end; c0 += kKeys) {
    __syncthreads();   // the previous tile's P.V is done with k_s/v_s/p_s
    for (int idx = threadIdx.x; idx < kKeys * nch; idx += kThreads) {
      const int cc = idx / nch, ch = idx % nch;
      const int c = c0 + cc;
      float tk[V], tv[V];
      if (c < Skv) {
        Vec<T>::load(kb + (long long)c * k_ss + ch * V, tk);
        Vec<T>::load(vb + (long long)c * v_ss + ch * V, tv);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) tk[e] = tv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        k_s[cc * ld + ch * V + e] = tk[e];
        v_s[cc * kMaxHd + ch * V + e] = tv[e];
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[j][jj] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qv[4], kv4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        qv[j] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + j) * ld + d);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        kv4[jj] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * jj) * ld
                                                   + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float a = s[j][jj];
          a = fmaf(qv[j].x, kv4[jj].x, a);
          a = fmaf(qv[j].y, kv4[jj].y, a);
          a = fmaf(qv[j].z, kv4[jj].z, a);
          a = fmaf(qv[j].w, kv4[jj].w, a);
          s[j][jj] = a;
        }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float mx = neg_inf();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = c0 + tx + 16 * jj;
        bool ok = rvalid[j] && c < Skv;
        if (causal) {
          ok = ok && c <= qpos[j];
          if (window > 0) ok = ok && c > qpos[j] - window;
        }
        s[j][jj] = ok ? s[j][jj] * scale : neg_inf();
        mx = fmaxf(mx, s[j][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[j], mx);
      const float m_safe = fmaxf(m_new, kNegInf);
      const float alpha = expf(fmaxf(m[j], kNegInf) - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[j][jj] - m_safe);
        sum += p;
        p_s[(ty * 4 + j) * kLdP + tx + 16 * jj] = Vec<T>::round(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[j] = l[j] * alpha + sum;
      m[j] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][e] *= alpha;
    }
    __syncthreads();

    const int nk = min(kKeys, Skv - c0);   // keys past Skv have p = v = 0
    for (int c = 0; c < nk; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pv[j] = *reinterpret_cast<const float4*>(p_s + (ty * 4 + j) * kLdP
                                                 + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 va = *reinterpret_cast<const float4*>(
            v_s + (c + cc) * kMaxHd + tx * 4);
        const float4 vb4 = *reinterpret_cast<const float4*>(
            v_s + (c + cc) * kMaxHd + 64 + tx * 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = cc == 0 ? pv[j].x : cc == 1 ? pv[j].y
                        : cc == 2 ? pv[j].z : pv[j].w;
          acc[j][0] = fmaf(p, va.x, acc[j][0]);
          acc[j][1] = fmaf(p, va.y, acc[j][1]);
          acc[j][2] = fmaf(p, va.z, acc[j][2]);
          acc[j][3] = fmaf(p, va.w, acc[j][3]);
          acc[j][4] = fmaf(p, vb4.x, acc[j][4]);
          acc[j][5] = fmaf(p, vb4.y, acc[j][5]);
          acc[j][6] = fmaf(p, vb4.z, acc[j][6]);
          acc[j][7] = fmaf(p, vb4.w, acc[j][7]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!rvalid[j]) continue;
    const int R = r0 + ty * 4 + j;
    const float lj = l[j] == 0.f ? 1.f : l[j];
    T* dst = o + b * o_sb + (long long)(R / G) * o_ss
             + (long long)(kv * G + R % G) * o_sh;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = h * 64 + tx * 4;
      if (d < hd) {
        float out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) out[e] = acc[j][h * 4 + e] / lj;
        Vec<T>::store4(dst + d, out);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Skv, int KV, int G, int hd, const long long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxHd));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((G * S + kRows - 1) / kRows, B * KV);
  flash_fwd<T><<<grid, kThreads, smem_bytes(hd), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Skv, KV, G, hd, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 with hd 64 or 128: the products on the tensor cores (mma.sync
// m16n8k16, bf16 in, float32 accumulate).  128 threads, one warp per 16 of
// the block's 64 query rows.  The warp's Q fragments stay in registers for
// the whole key loop; S = Q K^T for 16 rows x 64 keys is 8 n-tiles of
// float32 accumulators, the online softmax runs on them in place (a row's
// values live in the 4 lanes of a quad), and P, rounded to bf16, is re-used
// straight from those registers as the A operand of P.V, as in
// FlashAttention-2.  K is kept [key][d] and V transposed [d][key] in shared
// memory, rows padded by 8 so every fragment load is conflict-free.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int HD>
__host__ __device__ constexpr int mma_ld() { return HD + 8; }   // halves
constexpr int kLdVt = kKeys + 8;

template <int HD>
__host__ constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         ((size_t)2 * kRows * mma_ld<HD>() + (size_t)HD * kLdVt);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int S, int Skv, int KV, int G,
              long long q_sb, long long q_ss, long long q_sh, long long k_sb,
              long long k_ss, long long k_sh, long long v_sb, long long v_ss,
              long long v_sh, long long o_sb, long long o_ss, long long o_sh,
              float scale, int causal, int window) {
  constexpr int NK = HD / 16;         // k-steps of Q K^T
  constexpr int ND = HD / 8;          // n-tiles of the output
  constexpr int NC = HD / 8;          // 16-byte chunks per row
  constexpr int LD = mma_ld<HD>();
  extern __shared__ float4 smem4[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem4);  // [64][LD]
  __nv_bfloat16* k_s = q_s + kRows * LD;                         // [64][LD]
  __nv_bfloat16* vt_s = k_s + kKeys * LD;                        // [HD][kLdVt]

  const int tile = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int b = blockIdx.y / KV;
  const int kv = blockIdx.y % KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int n_rows = G * S;
  const int r0 = tile * kRows;

  const __nv_bfloat16* qb = q + b * q_sb + (long long)(kv * G) * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + (long long)kv * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + (long long)kv * v_sh;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int idx = threadIdx.x; idx < kRows * NC; idx += kMmaThreads) {
    const int rr = idx / NC, ch = idx % NC;
    const int R = r0 + rr;
    *reinterpret_cast<uint4*>(q_s + rr * LD + ch * 8) =
        R < n_rows ? *reinterpret_cast<const uint4*>(
                         qb + (long long)(R / G) * q_ss
                         + (long long)(R % G) * q_sh + ch * 8)
                   : zero;
  }
  __syncthreads();

  // rows warp*16 + gid (h = 0) and + 8 (h = 1)
  uint32_t qf[NK][4];
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    const __nv_bfloat16* lo = q_s + (warp * 16 + gid) * LD + ks * 16 + tq * 2;
    const __nv_bfloat16* hi = lo + 8 * LD;
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(lo);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(hi);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(lo + 8);
    qf[ks][3] = *reinterpret_cast<const uint32_t*>(hi + 8);
  }
  int qpos[2];
  bool rvalid[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = r0 + warp * 16 + gid + 8 * h;
    rvalid[h] = R < n_rows;
    qpos[h] = R / G;
    m[h] = neg_inf();
    l[h] = 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int nt = 0; nt < ND; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int p_first = r0 / G;
  const int p_last = min(S - 1, (r0 + kRows - 1) / G);
  const int kv_end = causal ? min(Skv, p_last + 1) : Skv;
  const int kv_begin = (causal && window > 0) ? max(0, p_first - window + 1)
                                              : 0;

  for (int c0 = kv_begin / kKeys * kKeys; c0 < kv_end; c0 += kKeys) {
    __syncthreads();   // the previous tile's P.V is done with k_s/vt_s
    for (int idx = threadIdx.x; idx < kKeys * NC; idx += kMmaThreads) {
      // K: consecutive threads along a row; V: along keys, so the
      // transposed 2-byte stores of a warp land in consecutive words
      const int kc = idx / NC, kch = idx % NC;
      *reinterpret_cast<uint4*>(k_s + kc * LD + kch * 8) =
          c0 + kc < Skv ? *reinterpret_cast<const uint4*>(
                              kb + (long long)(c0 + kc) * k_ss + kch * 8)
                        : zero;
      const int vc = idx % kKeys, vch = idx / kKeys;
      uint4 raw = c0 + vc < Skv ? *reinterpret_cast<const uint4*>(
                                      vb + (long long)(c0 + vc) * v_ss
                                      + vch * 8)
                                : zero;
      const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_s[(vch * 8 + e) * kLdVt + vc] = e8[e];
    }
    __syncthreads();

    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kp = k_s + (nt * 8 + gid) * LD + ks * 16 + tq * 2;
        mma_bf16(sc[nt], qf[ks], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = neg_inf();
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + nt * 8 + tq * 2 + e;
          bool ok = rvalid[h] && c < Skv;
          if (causal) {
            ok = ok && c <= qpos[h];
            if (window > 0) ok = ok && c > qpos[h] - window;
          }
          float& x = sc[nt][2 * h + e];
          x = ok ? x * scale : neg_inf();
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float m_safe = fmaxf(m_new, kNegInf);
      const float alpha = expf(fmaxf(m[h], kNegInf) - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[nt][2 * h + e];
          x = expf(x - m_safe);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = l[h] * alpha + sum;
      m[h] = m_new;
#pragma unroll
      for (int nt = 0; nt < ND; ++nt) {
        acc[nt][2 * h] *= alpha;
        acc[nt][2 * h + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < ND; ++nt) {
        const __nv_bfloat16* vp = vt_s + (nt * 8 + gid) * kLdVt + kk * 16
                                  + tq * 2;
        mma_bf16(acc[nt], pa, *reinterpret_cast<const uint32_t*>(vp),
                 *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rvalid[h]) continue;
    const int R = r0 + warp * 16 + gid + 8 * h;
    const float lh = l[h] == 0.f ? 1.f : l[h];
    __nv_bfloat16* dst = o + b * o_sb + (long long)(R / G) * o_ss
                         + (long long)(kv * G + R % G) * o_sh + tq * 2;
#pragma unroll
    for (int nt = 0; nt < ND; ++nt)
      *reinterpret_cast<uint32_t*>(dst + nt * 8) =
          pack_bf16(acc[nt][2 * h] / lh, acc[nt][2 * h + 1] / lh);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int Skv, int KV, int G, const long long* st,
               float scale, int causal, int window, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)mma_smem_bytes<HD>());
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((G * S + kRows - 1) / kRows, B * KV);
  flash_fwd_mma<HD><<<grid, kMmaThreads, mma_smem_bytes<HD>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      Skv, KV, G, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, sequence, head) for q, k, v, o in
// that order; the head-dim stride is 1.  Returns the CUDA error code.
extern "C" int flash_attention_fwd(int is_bf16, const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int Skv, int KV, int G, int hd,
                                   const long long* strides, float scale,
                                   int causal, int window, void* stream) {
  if (B * KV == 0 || G * S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && hd == 128)
    return launch_mma<128>(q, k, v, o, B, S, Skv, KV, G, strides, scale,
                           causal, window, st);
  if (is_bf16 && hd == 64)
    return launch_mma<64>(q, k, v, o, B, S, Skv, KV, G, strides, scale,
                          causal, window, st);
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, B, S, Skv, KV, G, hd,
                                         strides, scale, causal, window, st)
                 : launch<float>(q, k, v, o, B, S, Skv, KV, G, hd, strides,
                                 scale, causal, window, st);
}
