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
// causal layer is 275 GFLOP, 0.28 ms at the bf16 tensor-core rate.
//
// Two kernels, chosen by dtype in flash_attention_launch:
//
// bf16, the serving path (wg_kernel): both products on the tensor cores
// with wgmma (warpgroup MMA, sm_90a), f32 accumulate.
//   * one block of two warpgroups per (row of BH, tile of 128 queries),
//     64 query rows per warpgroup: S = Q K^T by wgmma.m64n64k16 with Q
//     and K read from shared memory through matrix descriptors, O += P V
//     by wgmma.m64nDk16 with P taken from the S accumulators into
//     registers (rounded to bf16) and V read from shared memory
//     transposed; O (64 x D per warpgroup) stays in registers;
//   * tiles stay bf16 in shared memory, cut into column blocks of 64
//     elements with the 128-byte swizzle (16-byte chunk c of row r at
//     c ^ (r % 8)), the layout wgmma reads; cp.async writes it without
//     bank conflicts;
//   * K/V tiles of 64 keys in a ring of 2 stages filled by cp.async.cg
//     (16 bytes a thread, zero-filled past S and past d): tile j + 1 is
//     in flight while tile j is computed.  Shared memory: Q 64 KB, a
//     stage 64 KB at D = 256 (192 KB, one block per SM); 96 KB at D =
//     128, 48 KB at D = 64.  Registers: 255 at D = 256 (128 of them O),
//     207 at D = 128, 159 at D = 64, no spills: one block of 8 warps per
//     SM;
//   * the head dim is a template (D = 64, 128, 256; d <= D, the columns
//     past d zero-filled);
//   * the mask is applied only to the tiles that cut the causal diagonal,
//     the window's edge or S; wholly masked tiles are never visited, as
//     the Pallas @pl.when skips them (a windowed layer touches
//     O(S * window) tiles).
// f32, the parity path (simt_kernel, the first kernel, unchanged): f32 FMAs
// out of shared memory, 256 threads per 64 queries, 32-key tiles.  TF32
// tensor cores would break the f32 parity checks (1e-5 of max |plain|),
// so f32 stays off them; nothing on the serving path runs f32.
//
// Both kernels: every output element is summed in one fixed order, no
// split over keys and no atomics, so a second call gives the same bits;
// query tiles are issued last-first, so the long causal rows start early
// and the short ones fill the tail.

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
simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
        simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, BH);
  simt_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), BH / BHkv, S, d, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0
// reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two floats rounded to bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

namespace wg {

constexpr int kWarpgroups = 2;
constexpr int kThreads = kWarpgroups * 128;
constexpr int kBr = kWarpgroups * 64;  // queries per block: 64 per warpgroup
constexpr int kBc = 64;                // keys per tile
constexpr int kStages = 2;             // K/V tiles in flight: the ring of cp.async stages

// Every shared tile is a row of column blocks of 64 bf16 (128 bytes a
// row), each 128-byte swizzled: 16-byte chunk c of row r sits at chunk
// c ^ (r % 8) of its row, so wgmma reads it through a descriptor of
// 8-row, 1024-byte atoms and cp.async writes it without bank conflicts.
template <int D>
struct Layout {
  static constexpr uint32_t kQ = kBr * D * 2;   // bytes of the Q tile
  static constexpr uint32_t kKV = kBc * D * 2;  // bytes of one K or V tile
  static constexpr size_t kBytes = kQ + 2 * kStages * kKV + 1024;  // + room to align to 1024
};

// a shared-memory matrix descriptor with the 128-byte swizzle; lbo and
// sbo in bytes
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// orders the compiler's use of registers a wgmma reads or writes after
// the wait that completes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 64, f32) += A (64 x 16, bf16, K-major in shared memory) .
// B (64 x 16, bf16, K-major in shared memory), both 128-byte swizzled
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, "
      "1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16, registers) . B (16 x 64, bf16,
// N-major in shared memory, 128-byte swizzled: transposed on the way in)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, "
      "%34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16, registers) . B (16 x 128, bf16,
// N-major in shared memory, 128-byte swizzled: transposed on the way in)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, "
      "%66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 256, f32) += A (64 x 16, bf16, registers) . B (16 x 256, bf16,
// N-major in shared memory, 128-byte swizzled: transposed on the way in)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (D == 64) wgmma_rs_n64(d, a, desc_b);
  if constexpr (D == 128) wgmma_rs_n128(d, a, desc_b);
  if constexpr (D == 256) wgmma_rs_n256(d, a, desc_b);
}

// rows [r0, r0 + kRows) of a (S, d) bf16 matrix into the swizzled tile at
// shared address dst, asynchronously; rows past S and columns past d are
// zeros
template <int D, int kRows>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                          int r0, int S, int d, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert(kRows * kChunks % kThreads == 0, "a tile is whole passes of the block");
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const bool live = r0 + r < S && c * 8 < d;
    const __nv_bfloat16* g = live ? src + (size_t)(r0 + r) * d + c * 8 : src;
    const uint32_t off = (c >> 3) * (kRows * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    cp_async16(dst + off, g, live ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
wg_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int group,
          int S, int d, int causal, int window, float sm_scale) {
  using Lay = Layout<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + Lay::kQ;               // [kStages] K tiles
  const uint32_t sV = sK + kStages * Lay::kKV;    // [kStages] V tiles

  const int tid = threadIdx.x, lane = tid % 32;
  const int wgi = tid / 128, wwarp = (tid / 32) % 4;  // warpgroup, warp within it
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qt * kBr;
  const int q_last = min(q0 + kBr, S) - 1;
  const __nv_bfloat16* qb = q + (size_t)bh * S * d;
  const __nv_bfloat16* kb = k + (size_t)(bh / group) * S * d;
  const __nv_bfloat16* vb = v + (size_t)(bh / group) * S * d;

  // key tiles with at least one live (query, key) pair for the block
  const int k_end = (causal ? q_last : S - 1) / kBc;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBc : 0;
  const int n_tiles = k_end - k_begin + 1;

  load_tile<D, kBr>(sQ, qb, q0, S, d, tid);
  load_tile<D, kBc>(sK, kb, k_begin * kBc, S, d, tid);
  load_tile<D, kBc>(sV, vb, k_begin * kBc, S, d, tid);
  cp_async_commit();

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = q0 + wgi * 64 + wwarp * 16;     // this warp's first query row
  const uint32_t q_wg = sQ + wgi * 64 * 128;       // the warpgroup's rows of each column block

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = k_begin + it, st = it % kStages;
    if (it + 1 < n_tiles) {  // the next tile into the other stage, freed by the last sync
      const int nx = (it + 1) % kStages;
      load_tile<D, kBc>(sK + nx * Lay::kKV, kb, (kt + 1) * kBc, S, d, tid);
      load_tile<D, kBc>(sV + nx * Lay::kKV, vb, (kt + 1) * kBc, S, d, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // the copies are generic-proxy writes; wgmma reads through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int k0 = kt * kBc;
    const uint32_t k_base = sK + st * Lay::kKV, v_base = sV + st * Lay::kKV;

    // S = Q K^T: 16 columns of d per wgmma, within a column block by 32 bytes
    float s[kBc / 2];
#pragma unroll
    for (int i = 0; i < kBc / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // bytes into the column block
      wgmma_ss_n64(s, make_desc(q_wg + (kk / 4) * (kBr * 128) + col, 16, 1024),
                   make_desc(k_base + (kk / 4) * (kBc * 128) + col, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // every (query, key) pair of the tile live: no mask needed
    const bool full = k0 + kBc <= S && (!causal || k0 + kBc - 1 <= q0) &&
                      (window <= 0 || q0 + kBr - 1 - k0 < window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kBc / 2; ++i) {
      float x = s[i] * sm_scale;
      if (!full) {
        const int key = k0 + (i / 4) * 8 + 2 * tig + (i & 1);
        const int row = row0 + g + ((i >> 1) & 1) * 8;
        bool live = key < S;
        if (causal) live = live && row >= key;
        if (window > 0) live = live && row - key < window;
        if (!live) x = kNegInf;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kBc / 2; ++i) {
      const float p = expf(s[i] - m[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += p;
      s[i] = p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = alpha[h] * l[h] + sum[h];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    // P as the A operand, rounded to bf16: keys 16 kk .. 16 kk + 15
    uint32_t pa[kBc / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    // O += P V: V's rows are keys (K), its columns d (N, contiguous); a
    // wgmma takes 16 keys (two 8-key atoms, 1024 bytes apart), and the
    // 64-column blocks lie kBc * 128 bytes apart
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], make_desc(v_base + kk * 16 * 128, kBc * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // out = acc / max(l, 1e-30): a thread holds two neighbouring columns of
  // rows g and g + 8 in each 8-column tile
  const float den0 = fmaxf(l[0], 1e-30f), den1 = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * tig;
    if (c >= d) continue;
    if (row0 + g < S)
      *reinterpret_cast<uint32_t*>(out + ((size_t)bh * S + row0 + g) * d + c) =
          pack_bf16(o[4 * j] / den0, o[4 * j + 1] / den0);
    if (row0 + g + 8 < S)
      *reinterpret_cast<uint32_t*>(out + ((size_t)bh * S + row0 + g + 8) * d + c) =
          pack_bf16(o[4 * j + 2] / den1, o[4 * j + 3] / den1);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int BHkv, int S,
           int d, int causal, int window, float sm_scale, cudaStream_t stream) {
  const size_t smem = Layout<D>::kBytes;
  static bool smem_opted_in = false;  // above 48 KB a kernel must opt in, once
  if (smem > 48 * 1024 && !smem_opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        wg_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_opted_in = true;
  }
  const dim3 grid((S + kBr - 1) / kBr, BH);
  wg_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), BH / BHkv, S, d,
      causal, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace wg

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
  if (dtype == 0)  // the parity path: f32 FMAs
    return launch<float>(q, k, v, out, BH, BHkv, S, d, causal, window, sm_scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  // bf16 on the tensor cores, the head dim rounded up to a template's
  if (d <= 64) return wg::launch<64>(q, k, v, out, BH, BHkv, S, d, causal, window, sm_scale, s);
  if (d <= 128)
    return wg::launch<128>(q, k, v, out, BH, BHkv, S, d, causal, window, sm_scale, s);
  return wg::launch<256>(q, k, v, out, BH, BHkv, S, d, causal, window, sm_scale, s);
}

