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
// rate.  Two bodies: bf16 with hd 64 or 128 (the serving path) runs
// flash_fwd_wgmma, warp-specialised with a TMA-fed K/V ring and wgmma
// (described at its definition); float32 and other head dims run scalar
// float32 FMAs (flash_fwd, described below), whose peak is 67 TFLOP/s.
//
// Design of flash_fwd.  The TPU grid is (B*KV, q blocks, kv blocks) with
// the kv axis innermost and in order, carrying (acc, m, l) in VMEM scratch.
// Here one block owns 64 query rows of one (b, kv) and loops over 64-key
// tiles (flash_fwd_wgmma keeps the first three points, at 128 rows x 128
// keys):
//   * rows are position-major (row = i * G + g), so the G query heads of
//     one KV head share every K/V tile the block streams through shared
//     memory (K/V read once per KV head, as on the TPU) and any G works;
//   * the loop's bounds cover only tiles that hold a visible key for some
//     row (below the causal diagonal, inside the window), so fully masked
//     tiles cost nothing, as the TPU's pl.when skip;
//   * ragged edges (G*S rows, Skv keys, not multiples of 64) are masked in
//     the kernel rather than by shrinking the tile;
//   * 256 threads as 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3, keys
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

#include "hopper.cuh"

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

// t[0] = op over t[0 .. N), pairwise (a tree of depth log2 N), N a power
// of two; every index a constant, so t stays in registers
template <int N, typename Op>
__device__ __forceinline__ void fold(float* t, Op op) {
  if constexpr (N > 1) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) t[j] = op(t[j], t[j + N / 2]);
    fold<N / 2>(t, op);
  }
}

// 2^x in one MUFU instruction (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// bf16 with hd 64 or 128: flash_fwd_wgmma, warp-specialised for Hopper.
//
// A block owns 128 position-major query rows of one (b, kv) and runs three
// warpgroups:
//   * warpgroup 2 is the producer: it gives up registers (setmaxnreg) and
//     one thread issues TMA copies of 128-key K and V tiles into a ring of
//     3 (hd 128) or 4 (hd 64) stages.  Each stage has a full barrier for K,
//     one for V (so Q.K^T starts before V lands) and an empty barrier that
//     the 8 consumer warps arrive on once their P.V has read the stage.
//     The tensor maps are 4-d over (hd, KV, Skv, B) with the tensors' real
//     strides, so K and V are read in place; a box is 64 head dims (128
//     bytes, the swizzle span) x 128 keys, two boxes per tile at hd 128,
//     written with the 128-byte swizzle that wgmma reads; keys past Skv
//     arrive as zeros and are masked.
//   * warpgroups 0 and 1 are consumers, 64 rows each.  Q is loaded once
//     by 16-byte cp.async copies, all in flight together, into the same
//     swizzled layout (rows i * G + g do not form a rectangular TMA box
//     when G is 5 or 7).  S = Q K^T is
//     wgmma m64n128k16 with both operands in shared memory (K-major); the
//     online softmax runs on the accumulator registers, laid out as the
//     mma.sync m16n8 fragments (a row's values in the 4 lanes of a quad);
//     P, rounded to bf16, is the register A operand of P.V, which is wgmma
//     m64n64k16 per 64-column half of V with V read in its natural
//     [key][d] layout through the descriptor's MN-major (transposed) mode.
//   * a consumer issues tile i's Q.K^T together with tile i-1's P.V and
//     runs tile i's softmax while that P.V is on the tensor cores; the two
//     consumers take turns to issue (two named barriers), so one's softmax
//     overlaps the other's products.  The softmax folds the scale into one
//     FFMA per score, takes 2^x with ex2.approx, and reduces max and sum as
//     trees: on the serving shape it, and not the products, set the time.
//   * only diagonal, window-edge and ragged tiles are masked; blocks run
//     longest first (a persistent block per SM walking a static schedule
//     measured slower on the serving shape).
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;              // rows per consumer warpgroup
constexpr int kWgBlockRows = 2 * kWgRows;
constexpr int kWgKeys = 128;             // keys per K/V tile
constexpr int kWgThreads = 384;          // two consumer warpgroups, producer
constexpr int kQHalf = kWgRows * 128;    // one 64-column half of Q (bytes)
constexpr int kKvHalf = kWgKeys * 128;   // one 64-column half of a K/V tile

template <int HD>
struct WgLayout {
  static constexpr int kHalves = HD / 64;
  static constexpr int kStages = HD == 128 ? 3 : 4;
  static constexpr int kTile = kHalves * kKvHalf;   // one K (or V) tile
  static constexpr int kK = 2 * kHalves * kQHalf;   // Q of both warpgroups first
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  // + 1024: the dynamic shared memory base is aligned up to the swizzle atom
  static constexpr int kBytes = kBars + 3 * kStages * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tmap_k,
                const __grid_constant__ CUtensorMap tmap_v,
                const __nv_bfloat16* __restrict__ q,
                __nv_bfloat16* __restrict__ o, int S, int Skv, int KV, int G,
                long long q_sb, long long q_ss, long long q_sh,
                long long o_sb, long long o_ss, long long o_sh,
                float scale_log2, int causal, int window) {
  using L = WgLayout<HD>;
  using namespace hopper;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  const uint32_t k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t bars = base + L::kBars;   // full K, full V, empty per stage
  const auto full_k = [&](int st) { return bars + 8 * st; };
  const auto full_v = [&](int st) { return bars + 8 * (L::kStages + st); };
  const auto empty = [&](int st) { return bars + 8 * (2 * L::kStages + st); };

  const int tile = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int b = blockIdx.y / KV;
  const int kv = blockIdx.y % KV;
  const int n_rows = G * S;
  const int r0 = tile * kWgBlockRows;
  const int p_first = r0 / G;
  const int p_last = min(S - 1, (r0 + kWgBlockRows - 1) / G);
  const int kv_end = causal ? min(Skv, p_last + 1) : Skv;
  const int kv_begin = (causal && window > 0) ? max(0, p_first - window + 1)
                                              : 0;
  const int t_first = kv_begin / kWgKeys;
  const int n_tiles = max(0, (kv_end + kWgKeys - 1) / kWgKeys - t_first);

  if (threadIdx.x == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), 8);   // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----------------------------------------------------------
    setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * 128) {
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % L::kStages;
        const uint32_t ph = (i / L::kStages) & 1;
        const int c0 = (t_first + i) * kWgKeys;
        mbar_wait(empty(st), ph ^ 1);   // a fresh barrier passes parity 1
        mbar_expect_tx(full_k(st), L::kTile);
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h)
          tma_load_4d(k_s + st * L::kTile + h * kKvHalf, &tmap_k, full_k(st),
                      h * 64, kv, c0, b);
        mbar_expect_tx(full_v(st), L::kTile);
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h)
          tma_load_4d(v_s + st * L::kTile + h * kKvHalf, &tmap_v, full_v(st),
                      h * 64, kv, c0, b);
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------------
    setmaxnreg_inc<232>();
    const int t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31;
    const int gid = lane >> 2, tq = lane & 3;
    const int rw = r0 + wg * kWgRows;          // this warpgroup's first row
    const int q_off = wg * L::kHalves * kQHalf;
    const uint32_t q_s = base + q_off;

    // Q rows rw .. rw + 63, 128-byte swizzled: 16-byte chunk c of row r at
    // chunk c ^ (r % 8); all of a thread's copies in flight at once, rows
    // past the end zero-filled
    constexpr int NC = HD / 8;
    const __nv_bfloat16* qb = q + b * q_sb + (long long)(kv * G) * q_sh;
    for (int idx = t; idx < kWgRows * NC; idx += 128) {
      const int rr = idx / NC, ch = idx % NC;
      const int R = rw + rr;
      const bool ok = R < n_rows;
      cp_async16(sbase + q_off + (ch >> 3) * kQHalf + rr * 128
                     + (((ch & 7) ^ (rr & 7)) << 4),
                 ok ? qb + (long long)(R / G) * q_ss
                          + (long long)(R % G) * q_sh + ch * 8
                    : qb,
                 ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);

    // rows rw + warp*16 + gid (h = 0) and + 8 (h = 1)
    int qpos[2];
    bool rvalid[2];
    float m[2], l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int R = rw + warp * 16 + gid + 8 * h;
      rvalid[h] = R < n_rows;
      qpos[h] = R / G;
      m[h] = neg_inf();
      l[h] = 0.f;
    }
    const int pw_first = rw / G;
    const int pw_last = min(S - 1, (rw + kWgRows - 1) / G);
    const bool rows_full = rw + kWgRows <= n_rows;

    // accumulators in the m64nN layout: element 4 j + e is row gid + 8 (e/2)
    // of the warp's 16, column 8 j + 2 tq + e % 2
    float oacc[HD / 2];
    float sacc[kWgKeys / 2];
    uint32_t pa[kWgKeys / 16][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kWgKeys / 2; ++i) sacc[i] = 0.f;

    // S = Q K^T of tile i, 64 x 128, both operands K-major; a k-step of 16
    // is 32 bytes further along a swizzled 128-byte row.  Not waited for.
    const auto issue_qk = [&](int i) {
      const int st = i % L::kStages;
      mbar_wait(full_k(st), (i / L::kStages) & 1);
      fence_regs<kWgKeys / 2>(sacc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const uint64_t da = sw128_desc(q_s + (ks >> 2) * kQHalf + (ks & 3) * 32,
                                       0, 1024);
        const uint64_t db = sw128_desc(
            k_s + st * L::kTile + (ks >> 2) * kKvHalf + (ks & 3) * 32, 0,
            1024);
        wgmma_ss<kWgKeys>(sacc, da, db, ks);
      }
      wgmma_commit();
    };
    // O += P V for tile i: V [key][d] is MN-major for B; per 64-column
    // half one swizzle atom wide, 8-key groups 1024 bytes apart.  Not
    // waited for.
    const auto issue_pv = [&](int i) {
      const int st = i % L::kStages;
      mbar_wait(full_v(st), (i / L::kStages) & 1);
      fence_regs<HD / 2>(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgKeys / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < L::kHalves; ++hh)
          wgmma_rs<64>(oacc + 32 * hh, pa[kk],
                       sw128_desc(v_s + st * L::kTile + hh * kKvHalf
                                  + kk * 16 * 128, 1024, 1024));
      wgmma_commit();
    };
    const auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(i % L::kStages));
    };
    // the online softmax of tile i on S; m in log2 units (scores times
    // hd^-1/2 log2 e).  Leaves P in sacc and the rescale of the running
    // output in alpha.  Max and sum fold pairwise (short dependency chains)
    const auto softmax = [&](int i, float* alpha) {
      const int c0 = (t_first + i) * kWgKeys;
      const bool need_mask =
          !rows_full || c0 + kWgKeys > Skv ||
          (causal && (c0 + kWgKeys - 1 > pw_first ||
                      (window > 0 && c0 <= pw_last - window)));
      if (need_mask) {
#pragma unroll
        for (int nt = 0; nt < kWgKeys / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int c = c0 + nt * 8 + tq * 2 + (e & 1);
            bool ok = rvalid[h] && c < Skv;
            if (causal) {
              ok = ok && c <= qpos[h];
              if (window > 0) ok = ok && c > qpos[h] - window;
            }
            if (!ok) sacc[4 * nt + e] = neg_inf();
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float t[kWgKeys / 8];
#pragma unroll
        for (int nt = 0; nt < kWgKeys / 8; ++nt)
          t[nt] = fmaxf(sacc[4 * nt + 2 * h], sacc[4 * nt + 2 * h + 1]);
        fold<kWgKeys / 8>(t, [](float a, float b) { return fmaxf(a, b); });
        float mx = t[0];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx * scale_log2);
        const float m_safe = fmaxf(m_new, kNegInf);
        alpha[h] = ex2(fmaxf(m[h], kNegInf) - m_safe);
#pragma unroll
        for (int nt = 0; nt < kWgKeys / 8; ++nt) {
          float& x0 = sacc[4 * nt + 2 * h];
          float& x1 = sacc[4 * nt + 2 * h + 1];
          x0 = ex2(fmaf(x0, scale_log2, -m_safe));
          x1 = ex2(fmaf(x1, scale_log2, -m_safe));
          t[nt] = x0 + x1;
        }
        fold<kWgKeys / 8>(t, [](float a, float b) { return a + b; });
        float sum = t[0];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[h] = l[h] * alpha[h] + sum;
        m[h] = m_new;
      }
    };
    const auto rescale_and_pack = [&](const float* alpha) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          oacc[4 * j + 2 * h] *= alpha[h];
          oacc[4 * j + 2 * h + 1] *= alpha[h];
        }
      // P (bf16) as the A fragments of 16-key steps
#pragma unroll
      for (int kk = 0; kk < kWgKeys / 16; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
    };

    // Tile i's Q.K^T is issued with tile i-1's P.V, and its softmax runs
    // while that P.V is on the tensor cores.  The two warpgroups take
    // turns to issue (named barriers 3 and 4, warpgroup 0 first), so one's
    // softmax overlaps the other's products.
    if (n_tiles > 0) {
      float alpha[2];
      issue_qk(0);
      wgmma_wait<0>();
      fence_regs<kWgKeys / 2>(sacc);
      softmax(0, alpha);
      rescale_and_pack(alpha);
      if (wg == 1) named_bar_arrive(3, 256);
      for (int i = 1; i < n_tiles; ++i) {
        named_bar_sync(3 + wg, 256);
        issue_qk(i);
        issue_pv(i - 1);
        named_bar_arrive(4 - wg, 256);
        wgmma_wait<1>();            // Q.K^T of tile i is done
        fence_regs<kWgKeys / 2>(sacc);
        softmax(i, alpha);
        wgmma_wait<0>();            // P.V of tile i - 1 is done
        fence_regs<HD / 2>(oacc);
        release(i - 1);
        rescale_and_pack(alpha);
      }
      if (wg == 0) named_bar_sync(3, 256);   // warpgroup 1's last turn
      issue_pv(n_tiles - 1);
      wgmma_wait<0>();
      fence_regs<HD / 2>(oacc);
      release(n_tiles - 1);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!rvalid[h]) continue;
      const int R = rw + warp * 16 + gid + 8 * h;
      const float lh = l[h] == 0.f ? 1.f : l[h];
      __nv_bfloat16* dst = o + b * o_sb + (long long)(R / G) * o_ss
                           + (long long)(kv * G + R % G) * o_sh + tq * 2;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8) =
            pack_bf16(oacc[4 * j + 2 * h] / lh, oacc[4 * j + 2 * h + 1] / lh);
    }
  }
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime so the
// library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// error codes past the CUDA runtime's: 10000 + the driver's CUresult
constexpr int kEncodeError = 10000;

// K or V (B, Skv, KV, hd) bf16 with element strides (batch, seq, head) as a
// 4-d tensor map over (hd, KV, Skv, B); boxes of 64 x 1 x 128 x 1
int kv_tensor_map(CUtensorMap* map, const void* ptr, int B, int Skv, int KV,
                  int hd, long long sb, long long ss, long long sh) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)KV,
                              (cuuint64_t)max(Skv, 1), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, kWgKeys, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int Skv, int KV, int G, const long long* st,
                 float scale, int causal, int window, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WgLayout<HD>::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap tk, tv;
  int rc = kv_tensor_map(&tk, k, B, Skv, KV, HD, st[3], st[4], st[5]);
  if (rc) return rc;
  rc = kv_tensor_map(&tv, v, B, Skv, KV, HD, st[6], st[7], st[8]);
  if (rc) return rc;
  const dim3 grid((G * S + kWgBlockRows - 1) / kWgBlockRows, B * KV);
  flash_fwd_wgmma<HD><<<grid, kWgThreads, WgLayout<HD>::kBytes, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), S, Skv, KV, G, st[0], st[1], st[2],
      st[9], st[10], st[11], scale * 1.4426950408889634f, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, sequence, head) for q, k, v, o in
// that order; the head-dim stride is 1.  Returns the CUDA error code, or
// 10000 + the driver's error when a tensor map cannot be encoded (the wgmma
// body's k and v need 16-byte aligned bases and strides).
extern "C" int flash_attention_fwd(int is_bf16, const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int Skv, int KV, int G, int hd,
                                   const long long* strides, float scale,
                                   int causal, int window, void* stream) {
  if (B * KV == 0 || G * S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && hd == 128)
    return launch_wgmma<128>(q, k, v, o, B, S, Skv, KV, G, strides, scale,
                             causal, window, st);
  if (is_bf16 && hd == 64)
    return launch_wgmma<64>(q, k, v, o, B, S, Skv, KV, G, strides, scale,
                            causal, window, st);
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, B, S, Skv, KV, G, hd,
                                         strides, scale, causal, window, st)
                 : launch<float>(q, k, v, o, B, S, Skv, KV, G, hd, strides,
                                 scale, causal, window, st);
}
