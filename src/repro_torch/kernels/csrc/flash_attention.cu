// Causal (optionally sliding-window) flash attention forward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_pallas of
// src/repro/kernels/flash_attention.py.  Computes, for every row bh of
// q and every query position i,
//   q    (BH, S, d)          float32 or bfloat16
//   k, v (BHkv, S, d)        q's dtype; BHkv divides BH, and query row bh
//                            reads key/value row bh / (BH / BHkv) (GQA
//                            without a broadcast copy)
//   out  (BH, S, d)          q's dtype
// with the Pallas kernel's arithmetic: s = (q . k accumulated in f32) *
// sm_scale; keys j with (causal and j > i) or (window > 0 and i - j >=
// window) get s = -1e30; an online softmax in f32 (running max m,
// denominator l of the unrounded p, accumulator acc); p is cast to V's
// dtype before the f32-accumulated p . V: each tile rescales acc by
// exp(m_prev - m_new), then adds its p_j v_j in key order; out =
// acc / max(l, 1e-30) in q's dtype.  S need not be a multiple of a tile: keys past S are masked
// and queries past S are not written.
//
// What bounds it on an H100: 4 d flops per (query, live key) pair and
// head against reading q, k, v and writing out once, so at prefill
// lengths (S in the thousands, d = 64 or 256) it is bound by operations:
// for gemma3-12b's 2 x 4096-token prefill (32 rows of BH, d = 256) a
// causal layer is 275 GFLOP, 0.28 ms at the bf16 tensor-core rate.  This
// first kernel does its products in f32 FMAs out of shared memory, so
// its own ceiling is a fraction of the 67 TFLOP/s f32 rate.
//
// What the design does about that:
//   * one block of 256 threads per (row of BH, tile of 64 queries); the
//     query tile stays in shared memory while 32-key tiles of K and V
//     stream through it (16-byte loads, converted to f32 once on the way
//     in), so q, k and v are read from device memory once per tile pair
//     and the (S, S) scores never leave the SM;
//   * tiles that are wholly masked are skipped, as the Pallas @pl.when
//     skips them: keys above the query tile's last position (causal) and
//     keys below its first position's window; a windowed layer touches
//     O(S * window) tiles, not O(S^2);
//   * four threads share a query row: each holds 8 of the tile's 32
//     scores and d / 4 output columns in registers; the row max and sum
//     go through two xor shuffles, so all four hold identical m and l;
//   * every output element is summed by one thread in a fixed order, no
//     atomics and no split over blocks: a second call gives the same
//     bits;
//   * query tiles are issued last-first, so the long causal rows start
//     early and the short ones fill the tail.
// wgmma / mma.sync, TMA and double-buffered K/V tiles are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;           // queries per block: 4 threads per row
constexpr int kBlockK = 32;           // keys per tile
constexpr int kRowThreads = kThreads / kBlockQ;          // 4
constexpr int kScoresPerThread = kBlockK / kRowThreads;  // 8
constexpr int kMaxHeadDim = 256;
constexpr int kMaxAcc = kMaxHeadDim / kRowThreads;       // 64 output columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and widened back: the cast of p to V's dtype
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// rows [r0, r0 + rows) of a (S, d) matrix into dst[r][c] (row stride ld),
// as f32; rows past S are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int r0, int rows, int S, int d, int tid) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const int vpr = d / kVec;
  for (int idx = tid; idx < rows * vpr; idx += kThreads) {
    const int r = idx / vpr, c = (idx % vpr) * kVec;
    float* out = dst + r * ld + c;
    if (r0 + r < S) {
      const uint4 w = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c);
      const T* x = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int t = 0; t < kVec; ++t) out[t] = to_f32(x[t]);
    } else {
#pragma unroll
      for (int t = 0; t < kVec; ++t) out[t] = 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int group, int S,
                       int d, int causal, int window, float sm_scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;                 // padded rows: the score loop reads rows apart
  float* sQ = smem;                     // [kBlockQ][d + 1]
  float* sK = sQ + kBlockQ * ld;        // [kBlockK][d + 1]
  float* sV = sK + kBlockK * ld;        // [kBlockK][d]
  float* sP = sV + kBlockK * d;         // [kBlockQ][kBlockK + 1]  p rounded to V's dtype

  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;    // query row of the tile
  const int part = tid % kRowThreads;   // which 8 keys and d / 4 columns
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qt * kBlockQ;
  const int q_last = min(q0 + kBlockQ, S) - 1;
  const int qpos = q0 + row;
  const T* qb = q + (size_t)bh * S * d;
  const T* kb = k + (size_t)(bh / group) * S * d;
  const T* vb = v + (size_t)(bh / group) * S * d;

  load_tile(sQ, ld, qb, q0, kBlockQ, S, d, tid);

  // key tiles with at least one live (query, key) pair for the block
  const int k_end = (causal ? q_last : S - 1) / kBlockK;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBlockK : 0;
  const int ncols = d / kRowThreads;

  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int kt = k_begin; kt <= k_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile is done with sK, sV and sP (and sQ is loaded)
    load_tile(sK, ld, kb, k0, kBlockK, S, d, tid);
    load_tile(sV, d, vb, k0, kBlockK, S, d, tid);
    __syncthreads();

    // this thread's 8 scores: keys part + 4 t of the tile, summed over c in order
    float s[kScoresPerThread];
#pragma unroll
    for (int t = 0; t < kScoresPerThread; ++t) s[t] = 0.f;
    const float* qr = sQ + row * ld;
    const float* kr = sK + part * ld;
    for (int c = 0; c < d; ++c) {
      const float qc = qr[c];
#pragma unroll
      for (int t = 0; t < kScoresPerThread; ++t)
        s[t] = fmaf(qc, kr[kRowThreads * t * ld + c], s[t]);
    }
    float m_cur = kNegInf;
#pragma unroll
    for (int t = 0; t < kScoresPerThread; ++t) {
      const int kpos = k0 + part + kRowThreads * t;
      bool live = kpos < S;
      if (causal) live = live && qpos >= kpos;
      if (window > 0) live = live && qpos - kpos < window;
      s[t] = live ? s[t] * sm_scale : kNegInf;
      m_cur = fmaxf(m_cur, s[t]);
    }
    // the row's four threads are neighbouring lanes of one warp
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    const float m_new = fmaxf(m, m_cur);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kScoresPerThread; ++t) {
      const float p = expf(s[t] - m_new);
      sum += p;
      sP[row * (kBlockK + 1) + part + kRowThreads * t] = round_to<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float alpha = expf(m - m_new);
    l = alpha * l + sum;
    m = m_new;
    __syncwarp();  // sP's row is written by this warp alone
    // acc = acc * alpha, then + p_j v_j for the tile's keys in order
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) acc[i] *= alpha;
    const float* pr = sP + row * (kBlockK + 1);
    for (int j = 0; j < kBlockK; ++j) {
      const float pj = pr[j];
      const float* vr = sV + j * d + part;
#pragma unroll
      for (int i = 0; i < kMaxAcc; ++i)
        if (i < ncols) acc[i] = fmaf(pj, vr[kRowThreads * i], acc[i]);
    }
  }

  if (qpos < S) {
    T* ob = out + ((size_t)bh * S + qpos) * d;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      if (i < ncols) ob[part + kRowThreads * i] = from_f32<T>(acc[i] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int BHkv, int S,
           int d, int causal, int window, float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kBlockQ * (d + 1) + (size_t)kBlockK * (d + 1) +
                                       (size_t)kBlockK * d + (size_t)kBlockQ * (kBlockK + 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, BH);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), BH / BHkv, S, d, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  window <= 0:
// no window.  Requires d % 8 == 0, 8 <= d <= 256, BH % BHkv == 0,
// BH <= 65535, contiguous 16-byte aligned tensors.  Returns the error of
// the launch (0 = none).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      void* out, int BH, int BHkv, int S, int d, int causal,
                                      int window, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 8 != 0 || d < 8 || d > kMaxHeadDim || BHkv < 1 || BH % BHkv != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, out, BH, BHkv, S, d, causal, window, sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, BH, BHkv, S, d, causal, window, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
