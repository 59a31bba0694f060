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
// Design: one launch, split-KV, one pass over K and V together.
//   * A block takes one (b, kv, split).  The caller sizes the splits
//     (kernels/decode_attention.py: split_plan) so that B * KV * splits
//     blocks fill the SMs in one wave at the occupancy this kernel reaches
//     (decode_attention_blocks_per_sm), with equal slot counts per split.
//     Positions live on the device, so a split past the live length exits
//     at once; split 0 always runs, so a sequence with no live slot still
//     writes its (zero) output.
//   * Each warp streams its own tiles (tile j of the split goes to warp
//     j % warps) through its own ring of shared-memory stages, filled by
//     16-byte cp.async (zero-filled past the live slots): no block-wide
//     barrier inside the loop.  A tile holds U = 32 / GM slots, so its
//     U x GM scores are 32 values: each lane computes the partial dot
//     products of its 4 head dims for all 32, and one reduce-scatter over
//     the warp (31 shuffles) leaves lane u * GM + g with the score of slot
//     u for head g.  The online softmax follows per head (max and sum over
//     the lanes of that head): m_safe = max(m, -1e30), alpha rescales the
//     running sums, and P is rounded to the cache's type before P.V, as the
//     TPU kernel does (l sums the unrounded P).  P and alpha go through a
//     few words of shared memory to every lane, which accumulates P.V for
//     its 4 head dims and all G heads in registers.
//   * The warps' (m, l, acc) merge in warp order inside the block, and the
//     block writes its split's partial.  The combine runs in the same
//     launch: an integer arrival counter per (b, kv) picks the last block
//     of the live splits, which merges the partials in split order with
//     weights exp(m_j - max(M, -1e30)), l == 0 -> 1, writes o and resets
//     the counter to 0, so a CUDA graph replay finds it zeroed.  No float
//     atomics: a run is bitwise reproducible.
//
// Partial mode (decode_attention_partial_fwd): the caches hold one shard
// of a cache's slots, [slot_offset, slot_offset + Smax) of s_total (the
// slot axis split over ranks).  Liveness keeps the global rule: the
// shard's live slots are clamp(live_slots(p, s_total) - slot_offset, 0,
// Smax).  The same launch, splits and combine run over those slots, and the
// combining block writes the shard's softmax state in float32 instead of
// o: o normalised by its own l, m (natural-log units, floored at -1e30)
// and l, per (b, h).  A shard with no live slot writes o = 0, m = -1e30,
// l = 0 (split 0 still runs), so a combine across shards stays finite.
// The whole-cache path is the PARTIAL = false instantiation, unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxHd = 128;    // 4 head dims per lane
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

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

// GM heads (a power of two >= G) per tile of U slots; the ring's depth and
// the block's warps: 12-32 slots in flight per warp, and in bf16 at hd 128
// four blocks of 48 KB on an SM (GM = 4)
template <int GM>
struct Shape {
  static constexpr int kU = 32 / GM;
  static constexpr int kStages = GM <= 2 ? 2 : (GM == 4 ? 3 : 4);
  static constexpr int kWarps = GM == 1 ? 2 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kScratch = 32 + 8;   // floats per warp: P, alpha
};

template <typename T, int GM>
__host__ __device__ inline int smem_bytes(int hd) {
  using Sh = Shape<GM>;
  return Sh::kWarps * (Sh::kStages * Sh::kU * 2 * hd * (int)sizeof(T)
                       + Sh::kScratch * 4);
}

// one level of the warp's reduce-scatter of 32 values: a lane keeps the
// half of its N values picked by lane bit N / 2 and adds its partner's copy
// of that half (after the five levels lane L holds the sum of value L)
template <int N>
__device__ __forceinline__ void scatter_level(float (&val)[32], int lane) {
  const bool up = lane & (N / 2);
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float send = up ? val[j] : val[j + N / 2];
    const float keep = up ? val[j + N / 2] : val[j];
    val[j] = keep + __shfl_xor_sync(kFull, send, N / 2);
  }
}

// PARTIAL: o is float32 and m_out, l_out (B, H) receive the shard's
// softmax state (see the header); otherwise o is T and both are unused
template <typename T, int GM, bool PARTIAL>
__global__ void __launch_bounds__(Shape<GM>::kThreads)
decode_split_kv(const T* __restrict__ q, const T* __restrict__ kc,
                const T* __restrict__ vc, const int* __restrict__ positions,
                void* __restrict__ o, float* __restrict__ m_out,
                float* __restrict__ l_out, float* __restrict__ part,
                int* __restrict__ arrivals, int Smax, int KV, int G, int hd,
                int n_split, int split_len, int slot_offset, int s_total,
                long long q_sb, long long q_sh,
                long long k_sb, long long k_ss, long long k_sh,
                long long v_sb, long long v_ss, long long v_sh,
                long long o_sb, long long o_sh, float scale_log2) {
  using Sh = Shape<GM>;
  constexpr int U = Sh::kU, NS = Sh::kStages, W = Sh::kWarps;
  constexpr int E = 16 / sizeof(T);   // elements per 16-byte copy
  extern __shared__ float4 smem4[];
  __shared__ int is_last;

  const int split = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / KV, kv = bkv % KV;
  const int live =
      PARTIAL ? min(max(live_slots(positions[b], s_total) - slot_offset, 0),
                    Smax)
              : live_slots(positions[b], Smax);
  const int lo = split * split_len;
  const int hi = min(min(lo + split_len, Smax), live);
  if (split > 0 && lo >= hi) return;   // not counted by the combine
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const int ring_elems = NS * U * 2 * hd;   // per warp
  T* ring = reinterpret_cast<T*>(smem4) + warp * ring_elems;
  float* scr = reinterpret_cast<float*>(reinterpret_cast<T*>(smem4)
                                        + W * ring_elems)
               + warp * Sh::kScratch;

  const int d0 = lane * 4;
  const bool dl = d0 < hd;
  float qr[GM][4];
  const T* qb = q + b * q_sb + (long long)(kv * G) * q_sh;
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      qr[g][e] = (g < G && dl) ? to_float(qb[(long long)g * q_sh + d0 + e])
                               : 0.f;

  const T* kb = kc + b * k_sb + (long long)kv * k_sh;
  const T* vb = vc + b * v_sb + (long long)kv * v_sh;
  const int n_tiles = (hi - lo + U - 1) / U;
  const int mine = n_tiles > warp ? (n_tiles - 1 - warp) / W + 1 : 0;
  const int chunks = hd / E;   // 16-byte chunks per row

  // tile j of the split (slots lo + j U ..) into stage st of this warp's
  // ring: U K rows, then U V rows; lane copies chunk idx % chunks of row
  // idx / chunks for idx = lane, lane + 32, ...
  const bool even = 32 % chunks == 0;    // then the chunk stays the lane's
  const int ch0 = lane % chunks, u0 = lane / chunks, u_step = 32 / chunks;
  const auto issue = [&](int j, int st) {
    T* dk = ring + st * U * 2 * hd;
    T* dv = dk + U * hd;
    const int c_base = lo + j * U;
    for (int idx = lane, u = u0, ch = ch0; idx < U * chunks;
         idx += 32, u += u_step) {
      if (!even) u = idx / chunks, ch = idx % chunks;
      const int c = c_base + u;
      const bool ok = c < hi;
      const long long cs = ok ? c : lo;
      hopper::cp_async16(dk + u * hd + ch * E, kb + cs * k_ss + ch * E,
                         ok ? 16 : 0);
      hopper::cp_async16(dv + u * hd + ch * E, vb + cs * v_ss + ch * E,
                         ok ? 16 : 0);
    }
  };

  // lane u * GM + g ends up with the score of slot u, head g
  const int my_u = lane / GM, my_g = lane % GM;
  float m = neg_inf(), l = 0.f;   // head my_g's, the same in all its lanes
  float acc[GM][4];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < mine) issue(warp + W * s, s);
    hopper::cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    const int ahead = i + NS - 1;
    if (ahead < mine) issue(warp + W * ahead, ahead % NS);
    hopper::cp_async_commit();
    hopper::cp_async_wait<NS - 1>();   // tile i has landed (this lane's part)
    __syncwarp();                      // ... and every lane's

    const T* sk = ring + (i % NS) * U * 2 * hd;
    const T* sv = sk + U * hd;
    const int c_base = lo + (warp + W * i) * U;

    float val[32];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[4] = {0.f, 0.f, 0.f, 0.f};
      if (dl) load4(sk + u * hd + d0, kf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float a = qr[g][0] * kf[0];
        a = fmaf(qr[g][1], kf[1], a);
        a = fmaf(qr[g][2], kf[2], a);
        a = fmaf(qr[g][3], kf[3], a);
        val[u * GM + g] = a;
      }
    }
    scatter_level<32>(val, lane);
    scatter_level<16>(val, lane);
    scatter_level<8>(val, lane);
    scatter_level<4>(val, lane);
    scatter_level<2>(val, lane);
    // scores and m in log2 units: exp2(s log2 e - m) = exp(s - m / log2 e)
    const bool ok = c_base + my_u < hi && my_g < G;
    const float s = ok ? val[0] * scale_log2 : neg_inf();

    float mx = s;
#pragma unroll
    for (int off = GM; off < 32; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    const float m_new = fmaxf(m, mx);
    const float m_safe = fmaxf(m_new, kNegInf);
    const float alpha = exp2f(fmaxf(m, kNegInf) - m_safe);
    const float p = exp2f(s - m_safe);
    float sum = p;
#pragma unroll
    for (int off = GM; off < 32; off <<= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    l = l * alpha + sum;
    m = m_new;
    scr[lane] = to_float(from_float<T>(p));
    if (lane < GM) scr[32 + lane] = alpha;
    __syncwarp();

#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float a = scr[32 + g];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= a;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[4] = {0.f, 0.f, 0.f, 0.f};
      if (dl) load4(sv + u * hd + d0, vf);
      float pu[GM];
      if (GM % 4 == 0) {
#pragma unroll
        for (int g = 0; g < GM; g += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(scr + u * GM + g);
          pu[g] = p4.x; pu[(g + 1) % GM] = p4.y;
          pu[(g + 2) % GM] = p4.z; pu[(g + 3) % GM] = p4.w;
        }
      } else {
#pragma unroll
        for (int g = 0; g < GM; ++g) pu[g] = scr[u * GM + g];
      }
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(pu[g], vf[e], acc[g][e]);
    }
    __syncwarp();   // the stage and scr are free for the next tile
  }
  hopper::cp_async_wait<0>();

  // the warps' states, in this warp's own ring: acc[GM][hd], m[GM], l[GM]
  __syncwarp();
  float* wst = reinterpret_cast<float*>(ring);
  if (lane < GM) {
    wst[GM * hd + lane] = m;          // lane g < GM holds u = 0, head g
    wst[GM * hd + GM + lane] = l;
  }
  if (dl) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) wst[g * hd + d0 + e] = acc[g][e];
  }
  __syncthreads();

  // the block's partial for this split, warps merged in order
  const long long n_part = (long long)gridDim.y * n_split * G;
  float* part_acc = part;   // first: 16-byte aligned rows of hd floats
  float* part_m = part + n_part * hd;
  float* part_l = part_m + n_part;
  const long long pidx = ((long long)bkv * n_split + split) * G;
  const float* wbase = reinterpret_cast<const float*>(smem4);
  const int wstride = ring_elems * (int)sizeof(T) / 4;   // floats per ring
  const int hd4 = hd / 4;
  for (int idx = threadIdx.x; idx < G * hd4; idx += Sh::kThreads) {
    const int g = idx / hd4, d = (idx % hd4) * 4;
    float M = neg_inf();
#pragma unroll
    for (int w = 0; w < W; ++w) M = fmaxf(M, wbase[w * wstride + GM * hd + g]);
    const float M_safe = fmaxf(M, kNegInf);
    float Lw = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float* ws = wbase + w * wstride;
      const float wt = exp2f(fmaxf(ws[GM * hd + g], kNegInf) - M_safe);
      const float4 a = *reinterpret_cast<const float4*>(ws + g * hd + d);
      Lw = fmaf(wt, ws[GM * hd + GM + g], Lw);
      A.x = fmaf(wt, a.x, A.x);
      A.y = fmaf(wt, a.y, A.y);
      A.z = fmaf(wt, a.z, A.z);
      A.w = fmaf(wt, a.w, A.w);
    }
    *reinterpret_cast<float4*>(part_acc + (pidx + g) * hd + d) = A;
    if (d == 0) {
      part_m[pidx + g] = M;
      part_l[pidx + g] = Lw;
    }
  }

  // the last live split of this (b, kv) to arrive combines
  __threadfence();
  __syncthreads();
  const int n_live = live == 0 ? 1 : (live + split_len - 1) / split_len;
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(arrivals + bkv, 1);
    is_last = prev == n_live - 1;
    if (is_last) arrivals[bkv] = 0;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // one thread per (head, 4 head dims): every split's loads are
  // independent of each other, so they go out together
  const long long first = (long long)bkv * n_split * G;
  for (int idx = threadIdx.x; idx < G * hd4; idx += Sh::kThreads) {
    const int g = idx / hd4, d = (idx % hd4) * 4;
    float M = neg_inf();
#pragma unroll 8
    for (int j = 0; j < n_live; ++j)
      M = fmaxf(M, __ldcg(part_m + first + (long long)j * G + g));
    const float M_safe = fmaxf(M, kNegInf);
    float Lw = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int j = 0; j < n_live; ++j) {
      const long long pj = first + (long long)j * G + g;
      const float wt = exp2f(fmaxf(__ldcg(part_m + pj), kNegInf) - M_safe);
      const float4 a = __ldcg(reinterpret_cast<const float4*>(part_acc
                                                              + pj * hd + d));
      Lw = fmaf(wt, __ldcg(part_l + pj), Lw);
      A.x = fmaf(wt, a.x, A.x);
      A.y = fmaf(wt, a.y, A.y);
      A.z = fmaf(wt, a.z, A.z);
      A.w = fmaf(wt, a.w, A.w);
    }
    if (PARTIAL) {
      const float den = Lw == 0.f ? 1.f : Lw;
      float* dst = static_cast<float*>(o) + b * o_sb
                   + (long long)(kv * G + g) * o_sh + d;
      *reinterpret_cast<float4*>(dst) = make_float4(A.x / den, A.y / den,
                                                    A.z / den, A.w / den);
      if (d == 0) {
        const long long row = (long long)b * KV * G + kv * G + g;
        m_out[row] = fmaxf(M * kLn2, kNegInf);
        l_out[row] = Lw;
      }
      continue;
    }
    if (Lw == 0.f) Lw = 1.f;
    T* dst = static_cast<T*>(o) + b * o_sb + (long long)(kv * G + g) * o_sh
             + d;
    dst[0] = from_float<T>(A.x / Lw);
    dst[1] = from_float<T>(A.y / Lw);
    dst[2] = from_float<T>(A.z / Lw);
    dst[3] = from_float<T>(A.w / Lw);
  }
}

template <typename T, int GM, bool PARTIAL>
int configure() {
  static bool done = false;
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kv<T, GM, PARTIAL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<T, GM>(kMaxHd));
    if (err != cudaSuccess) return (int)err;
    done = true;
  }
  return 0;
}

// one call's operands; m, l, slot_offset and s_total are read in partial
// mode only
struct Args {
  const void *q, *k, *v;
  const int* positions;
  void* o;
  float *m, *l, *part;
  int* arrivals;
  int B, Smax, KV, G, hd, n_split, split_len, slot_offset, s_total;
  const long long* st;
  float scale;
  cudaStream_t stream;
};

template <typename T, int GM, bool PARTIAL>
int launch(const Args& a) {
  const int rc = configure<T, GM, PARTIAL>();
  if (rc) return rc;
  const long long* st = a.st;
  decode_split_kv<T, GM, PARTIAL><<<dim3(a.n_split, a.B * a.KV),
                                    Shape<GM>::kThreads,
                                    smem_bytes<T, GM>(a.hd), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.positions, a.o, a.m, a.l, a.part,
      a.arrivals, a.Smax, a.KV, a.G, a.hd, a.n_split, a.split_len,
      a.slot_offset, a.s_total, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], a.scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <typename T, int GM>
int occupancy(int hd) {
  const int rc = configure<T, GM, false>();
  if (rc) return -rc;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_split_kv<T, GM, false>, Shape<GM>::kThreads,
      smem_bytes<T, GM>(hd));
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T>
int blocks_per_sm(int G, int hd) {
  if (G <= 1) return occupancy<T, 1>(hd);
  if (G <= 2) return occupancy<T, 2>(hd);
  if (G <= 4) return occupancy<T, 4>(hd);
  return occupancy<T, 8>(hd);
}

template <typename T, bool PARTIAL>
int dispatch(const Args& a) {
  if (a.G <= 1) return launch<T, 1, PARTIAL>(a);
  if (a.G <= 2) return launch<T, 2, PARTIAL>(a);
  if (a.G <= 4) return launch<T, 4, PARTIAL>(a);
  return launch<T, 8, PARTIAL>(a);
}

template <bool PARTIAL>
int run(int is_bf16, const Args& a) {
  if (a.B * a.KV == 0 || a.Smax == 0) return 0;
  if (a.G < 1 || a.G > 8 || a.hd > kMaxHd || a.n_split < 1 ||
      (long long)a.n_split * a.split_len < a.Smax)
    return (int)cudaErrorInvalidValue;
  return is_bf16 ? dispatch<__nv_bfloat16, PARTIAL>(a)
                 : dispatch<float, PARTIAL>(a);
}

}  // namespace

// Blocks of the kernel one SM holds at (type, G, hd); negative: minus the
// CUDA error.  The caller sizes the splits from it.
extern "C" int decode_attention_blocks_per_sm(int is_bf16, int G, int hd) {
  if (G < 1 || G > 8 || hd < 1 || hd > kMaxHd) return -(int)cudaErrorInvalidValue;
  return is_bf16 ? blocks_per_sm<__nv_bfloat16>(G, hd)
                 : blocks_per_sm<float>(G, hd);
}

// part: B*KV*n_split*G*(hd + 2) floats of scratch, 16-byte aligned (the
// partial outputs, then their m, then their l); arrivals: B*KV int32,
// zero before the first call, left zero by every call.  Splits are
// [j * split_len, min((j + 1) * split_len, Smax)), j < n_split.
// strides: 10 element strides: q (batch, head), k (batch, slot, head),
// v (batch, slot, head), o (batch, head); the head-dim stride is 1, the
// others and the bases 16-byte aligned.  G <= 8 and hd <= 128, hd * the
// element size a multiple of 16.  Returns the CUDA error code.
extern "C" int decode_attention_fwd(int is_bf16, const void* q, const void* k,
                                    const void* v, const int* positions,
                                    void* o, float* part, int* arrivals,
                                    int B, int Smax, int KV, int G, int hd,
                                    int n_split, int split_len,
                                    const long long* strides, float scale,
                                    void* stream) {
  const Args a{q, k, v, positions, o, nullptr, nullptr, part, arrivals,
               B, Smax, KV, G, hd, n_split, split_len, 0, Smax, strides,
               scale, static_cast<cudaStream_t>(stream)};
  return run<false>(is_bf16, a);
}

// The partial mode: the caches hold slots [slot_offset, slot_offset + Smax)
// of an s_total-slot cache; o is float32 (B, 1, H, hd) at the o strides
// given (in floats, 16-byte aligned), m and l float32 (B, H) contiguous.
// Otherwise as decode_attention_fwd.
extern "C" int decode_attention_partial_fwd(
    int is_bf16, const void* q, const void* k, const void* v,
    const int* positions, float* o, float* m, float* l, float* part,
    int* arrivals, int B, int Smax, int KV, int G, int hd, int n_split,
    int split_len, int slot_offset, int s_total, const long long* strides,
    float scale, void* stream) {
  if (slot_offset < 0 || (long long)slot_offset + Smax > s_total)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, positions, o, m, l, part, arrivals, B, Smax, KV, G,
               hd, n_split, split_len, slot_offset, s_total, strides, scale,
               static_cast<cudaStream_t>(stream)};
  return run<true>(is_bf16, a);
}
