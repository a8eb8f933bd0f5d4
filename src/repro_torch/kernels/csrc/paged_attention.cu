// Paged decode attention over a block-table KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paged_attention_pallas of
// src/repro/kernels/paged_attention.py.  Computes, for every lane b and
// KV head kv, the single decode query of each of its G grouped heads
// against the lane's rows [0, pos[b]] (optionally only the last `window`
// of them), read through the lane's block table:
//   q      (B, KV, G, d)             float32 or bfloat16
//   pools  (n_blocks, bs, KV, d)     float32 or bfloat16 (K and V alike)
//   table  (B, nb_lane) int32        pool block of each lane-logical block
//   pos    (B,) int32                last written row; < 0: inactive lane
//   out    (B, KV, G, d)             q's dtype
// with the Pallas kernel's arithmetic: K is cast to q's dtype before the
// f32-accumulated q.k, which is then scaled by sm_scale; the softmax is an
// online one in f32; p is cast to V's dtype before the f32-accumulated p.V;
// out = acc / max(l, 1e-30).  A lane with pos < 0 reads nothing and writes
// exact zeros.
//
// What bounds it on an H100: one decode query per head reads each live K
// and V row once and does 4 d flops per row and head on it, so it is bound
// by device-memory bytes: live rows x KV x d x 2 (K and V) x the element
// size, plus q and the output.  At the serving slice's shapes (8 lanes,
// 8 KV heads, d = 64, bf16, a few hundred live rows per lane) that is a
// few MB per layer and step, about 1 us at 3.35 TB/s, so a launch of this
// size is bound in practice by its latency and by the grid: one block per
// (lane, KV head) gives 64 blocks on 132 SMs.
//
// What the design does about that:
//   * each lane walks only its live logical blocks [lo, hi] (hi = pos / bs,
//     lo from the window), and inside a block only its live rows, so the
//     bytes read scale with live tokens, not with the table's capacity.
//     Table entries past hi (stale ids of an earlier tenant, or the zeros
//     of a fresh table) are never loaded, nor are rows past pos;
//   * one block of 128 threads per (lane, KV head) serves all G query
//     heads of the group, so each K/V row is read from device memory once
//     per group; rows come in 16-byte loads, 32 rows per pass, into shared
//     memory (K rounded to q's dtype, both as f32), one warp runs the
//     online softmax of one head with one lane per row, and every thread
//     keeps G * d / 128 output accumulators in registers;
//   * the walk over blocks is a loop inside the block, in place of the
//     TPU's sequential grid axis: no split over blocks and no atomics, so
//     the sum order is fixed and a run repeats bit for bit.
// Splitting a lane's walk over several blocks (flash-decoding) to fill
// the card, and cp.async / TMA double-buffering, are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;     // pool rows staged per pass: one per lane of a warp
constexpr int kMaxAcc = 32;   // accumulators per thread, so G * d <= 4096
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and widened back: the casts of K to q's dtype and of p to V's
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Python's a // b for b > 0 (C's / truncates toward zero)
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                       const TKV* __restrict__ v_pool, const int* __restrict__ table,
                       const int* __restrict__ pos, TQ* __restrict__ out, int KV, int G, int d,
                       int bs, int nb_lane, int window, float sm_scale) {
  extern __shared__ float smem[];
  const int kv = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ks = d + 1;                 // padded K row: the score loop reads rows apart
  float* sK = smem;                     // [kTile][d + 1]  K rounded to q's dtype
  float* sV = sK + kTile * ks;          // [kTile][d]
  float* sQ = sV + kTile * d;           // [G][d]
  float* sP = sQ + G * d;               // [G][kTile]      scores, then p rounded to V's dtype
  float* sM = sP + G * kTile;           // [G] running max
  float* sL = sM + G;                   // [G] running denominator
  float* sA = sL + G;                   // [G] this pass's rescale of the accumulator

  const int GD = G * d;
  const size_t qoff = ((size_t)b * KV + kv) * GD;
  const int p_b = pos[b];

  float acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = 0.f;

  if (p_b >= 0) {  // uniform over the block: an inactive lane skips the walk
    for (int e = tid; e < GD; e += kThreads) sQ[e] = to_f32(q[qoff + e]);
    for (int g = tid; g < G; g += kThreads) {
      sM[g] = kNegInf;
      sL[g] = 0.f;
    }
    const int hi = min(p_b / bs, nb_lane - 1);
    const int lo = window > 0 ? max(0, min(floor_div(p_b - window + 1, bs), nb_lane - 1)) : 0;
    const size_t row_stride = (size_t)KV * d;  // elements from one pool row to the next
    constexpr int kVec = 16 / sizeof(TKV);     // elements per 16-byte load
    const int vpr = d / kVec;                  // 16-byte loads per row
    for (int j = lo; j <= hi; ++j) {
      const size_t blk = (size_t)table[(size_t)b * nb_lane + j];
      for (int r0 = 0; r0 < bs; r0 += kTile) {
        const int t0 = j * bs + r0;  // position of the pass's first row
        const int rows = min(kTile, bs - r0);
        // live rows of the pass: positions in [pos - window + 1, pos]
        const int e = min(rows, p_b - t0 + 1);
        const int a = window > 0 ? max(0, p_b - window + 1 - t0) : 0;
        if (a >= e) continue;  // uniform over the block
        __syncthreads();       // the previous pass is done with sK, sV and sP
        const size_t base = (blk * bs + r0) * row_stride + (size_t)kv * d;
        for (int idx = tid; idx < (e - a) * vpr; idx += kThreads) {
          const int r = a + idx / vpr, c = (idx % vpr) * kVec;
          const size_t off = base + (size_t)r * row_stride + c;
          const uint4 kw = *reinterpret_cast<const uint4*>(k_pool + off);
          const uint4 vw = *reinterpret_cast<const uint4*>(v_pool + off);
          const TKV* kx = reinterpret_cast<const TKV*>(&kw);
          const TKV* vx = reinterpret_cast<const TKV*>(&vw);
#pragma unroll
          for (int t = 0; t < kVec; ++t) {
            sK[r * ks + c + t] = round_to<TQ>(to_f32(kx[t]));
            sV[r * d + c + t] = to_f32(vx[t]);
          }
        }
        __syncthreads();
        for (int idx = tid; idx < G * kTile; idx += kThreads) {
          const int g = idx / kTile, r = idx % kTile;
          float s = kNegInf;
          if (r >= a && r < e) {
            const float* qg = sQ + g * d;
            const float* kr = sK + r * ks;
            float dot = 0.f;
            for (int c = 0; c < d; ++c) dot = fmaf(qg[c], kr[c], dot);
            s = dot * sm_scale;
          }
          sP[idx] = s;
        }
        __syncthreads();
        // online softmax: one warp per query head, lane r holds row r
        for (int g = warp; g < G; g += kWarps) {
          const float s = sP[g * kTile + lane];
          float mx = s;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_prev = sM[g];
          const float m_new = fmaxf(m_prev, mx);
          const float p = expf(s - m_new);  // exactly 0 for a masked row
          float sum = p;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          sP[g * kTile + lane] = round_to<TKV>(p);
          if (lane == 0) {
            const float alpha = expf(m_prev - m_new);
            sL[g] = alpha * sL[g] + sum;
            sM[g] = m_new;
            sA[g] = alpha;
          }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kMaxAcc; ++k) {
          const int idx = tid + k * kThreads;
          if (idx < GD) {
            const int g = idx / d, c = idx % d;
            const float* pg = sP + g * kTile;
            float dot = 0.f;
            for (int r = a; r < e; ++r) dot = fmaf(pg[r], sV[r * d + c], dot);
            acc[k] = acc[k] * sA[g] + dot;
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < GD) {
      // pos < 0: acc = 0 and l = 0, so exact zeros, as in the Pallas kernel
      const float v = p_b >= 0 ? acc[k] / fmaxf(sL[idx / d], 1e-30f) : 0.f;
      out[qoff + idx] = from_f32<TQ>(v);
    }
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
           const void* pos, void* out, int B, int KV, int G, int d, int bs, int nb_lane,
           int window, float sm_scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kTile * (d + 1) + (size_t)kTile * d + (size_t)G * d +
                       (size_t)G * kTile + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(KV, B);
  paged_attention_kernel<TQ, TKV><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<TQ*>(out), KV, G, d, bs, nb_lane, window,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window.
// Requires d % 8 == 0, d <= 256, G * d <= 4096, 16-byte aligned q and
// pools, and every table entry a lane reaches (blocks lo..hi) inside the
// pool.  Returns the error of the launch (0 = none).
extern "C" int paged_attention_launch(int q_dtype, int kv_dtype, const void* q,
                                      const void* k_pool, const void* v_pool,
                                      const void* table, const void* pos, void* out, int B,
                                      int KV, int G, int d, int bs, int nb_lane, int window,
                                      float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k_pool, v_pool, table, pos, out, B, KV, G, d, bs, nb_lane,
                                window, sm_scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k_pool, v_pool, table, pos, out, B, KV, G, d, bs,
                                        nb_lane, window, sm_scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k_pool, v_pool, table, pos, out, B, KV, G, d, bs,
                                        nb_lane, window, sm_scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, table, pos, out, B, KV, G,
                                                d, bs, nb_lane, window, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
