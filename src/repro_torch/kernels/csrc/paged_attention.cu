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
// size, plus q and the output.  gemma3-12b's global layer at 8 lanes of up
// to 2,048 live rows (d = 256, bf16) reads 42 MB, 13 us at 3.35 TB/s, but
// only if the whole card streams: one block per (lane, KV head) walking
// its rows alone fills 64 of the 132 SMs and keeps a few KB in flight on
// each.  granite-3-2b's layer (d = 64, a few hundred rows per lane) is a
// few MB, and its time is the launches' latency.
//
// What the design does about that (flash-decoding):
//   * paged_attention_split: grid (KV x head chunks, B, n_split).  Split
//     s covers the lane-logical rows [s R, (s + 1) R), R = rows_per_split
//     = 128 rounded to whole table blocks; n_split and R are functions of
//     (nb_lane, bs) alone (split_plan in paged_attention.py), so the grid
//     and the scratch do not depend on pos: the decode step reads no
//     position on the host and can be captured in a CUDA graph.  gemma3's
//     table (97 blocks of 32 rows) gives 25 splits, 1,600 blocks, of which
//     the lanes of a 5,128-row step fill 336.  A split holding none of the
//     lane's live rows [lo, hi] (hi = min(pos, nb_lane bs - 1), lo from
//     the window) exits at once; the others each write a partial
//     (m, l, acc) in f32 to scratch;
//   * inside a split, 4 warps take the live rows in turn.  A warp's 32
//     lanes are cut into segments of SEG lanes (the power of two that
//     covers a row's 16-byte chunks: 32 at d = 256 bf16, 8 at d = 64), one
//     row per segment and U rows per lane in a pass: each lane loads its
//     chunk of K and of V with one 16-byte load each straight into
//     registers (no shared-memory staging, no f32 copy), and the next
//     pass's loads are issued before this pass computes (a register double
//     buffer).  The q . k of each head is a per-lane partial summed over
//     the segment by xor shuffles; each reduction runs its shuffle offsets
//     in the outer loop, so the U x G independent chains overlap their
//     latencies (a pass is latency-bound, not bandwidth-bound).  The
//     softmax state (m, l) of each head is uniform over the warp; the
//     warps' partials merge through shared memory at the end.  No kernel
//     spills;
//   * only table entries of live rows are read (entries past hi, stale
//     ids or a fresh table's zeros, never are), and no row past pos;
//   * paged_attention_merge: grid (KV, B); one warp per head finds m =
//     max m_s and l = sum exp(m_s - m) l_s over the lane's live splits
//     (a fixed xor tree), then each output sums exp(m_s - m) acc_s in
//     split order and writes acc / max(l, 1e-30) in q's dtype, or exact
//     zeros for an inactive lane.  Every sum runs in an order fixed by the
//     table's shape and pos, with no atomics: a second call gives the same
//     bits.
// One call launches both kernels; the wrapper counts it as one launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;  // query heads per block; a larger group takes several blocks
constexpr int kMergeThreads = 256;
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

// the lane's live rows [lo, hi] (lo > hi: none; pos < 0 gives none)
__device__ __forceinline__ void live_rows(int p_b, int window, int L, int& lo, int& hi) {
  lo = window > 0 ? max(0, p_b - window + 1) : 0;
  hi = min(p_b, L - 1);
}

// kG: query heads a block serves (1, 2, 4 or 8; G rounded up); kNch:
// 16-byte chunks of a row per lane (2 only for f32 rows of more than 32
// chunks, d > 128).  Scratch: part_acc (B, KV, n_split, G, d) and
// part_ml (B, KV, n_split, G, 2) f32.
template <typename TQ, typename TKV, int kG, int kNch>
__global__ void __launch_bounds__(kThreads)
paged_attention_split(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
             const TKV* __restrict__ v_pool, const int* __restrict__ table,
             const int* __restrict__ pos, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int KV, int G, int d, int bs, int nb_lane, int window,
             float sm_scale, int n_split, int rows_per_split) {
  constexpr int kVec = 16 / sizeof(TKV);  // elements per 16-byte chunk
  constexpr int kU = kG * kNch >= 8 ? 1 : 4;  // rows per lane and pass (registers)
  extern __shared__ float smem[];

  const int n_gc = (G + kG - 1) / kG;
  const int kv = blockIdx.x / n_gc, g0 = (blockIdx.x % n_gc) * kG;
  const int b = blockIdx.y, split = blockIdx.z;
  const int p_b = pos[b];
  int lo, hi;
  live_rows(p_b, window, nb_lane * bs, lo, hi);
  const int a = max(lo, split * rows_per_split);
  const int e = min(hi + 1, (split + 1) * rows_per_split);
  if (a >= e) return;  // uniform: the merge reads only splits that hold live rows

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cpr = d / kVec;  // chunks per row
  int seg = 1;               // lanes per row: a power of two, at most 32
  while (seg * kNch < cpr) seg *= 2;
  const int rpp = 32 / seg;  // rows per warp pass
  const int sg = lane / seg, t = lane % seg;

  // shared: the split's table entries, then per warp (m, l) and acc of kG heads
  const int j0 = a / bs, n_ent = (e - 1) / bs - j0 + 1;
  int* s_tab = reinterpret_cast<int*>(smem);
  float* s_ml = smem + ((n_ent + 3) & ~3);      // [kWarps][kG][2]
  float* s_acc = s_ml + kWarps * kG * 2;        // [kWarps][kG][d]
  for (int j = tid; j < n_ent; j += kThreads) s_tab[j] = table[(size_t)b * nb_lane + j0 + j];

  // q of the block's heads, in this lane's chunks, as f32
  float qr[kG][kNch][kVec];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int i = 0; i < kNch; ++i) {
      const int c = t + seg * i;
#pragma unroll
      for (int x = 0; x < kVec; ++x)
        qr[g][i][x] = (g0 + g < G && c < cpr)
                          ? to_f32(q[(((size_t)b * KV + kv) * G + g0 + g) * d + c * kVec + x])
                          : 0.f;
    }
  float acc[kG][kNch][kVec];
  float m[kG], l[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kNch; ++i)
#pragma unroll
      for (int x = 0; x < kVec; ++x) acc[g][i][x] = 0.f;
  }
  __syncthreads();  // s_tab is in

  const size_t row_stride = (size_t)KV * d;  // elements from one pool row to the next
  const int per_warp = rpp * kU;             // rows of one warp pass
  const int stride = kWarps * per_warp;      // rows of one block pass
  // this lane's chunks of K and V of the pass starting at row `base`
  // (zeros for rows past e), with 16-byte loads into registers
  auto load_pass = [&](int base, uint4(&kr)[kU][kNch], uint4(&vr)[kU][kNch], bool(&live)[kU]) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = base + u * rpp + sg;
      live[u] = r < e;
      size_t off = 0;
      if (live[u]) {
        const int j = r / bs;
        off = ((size_t)s_tab[j - j0] * bs + (r - j * bs)) * row_stride + (size_t)kv * d;
      }
#pragma unroll
      for (int i = 0; i < kNch; ++i) {
        const int c = t + seg * i;
        if (live[u] && c < cpr) {
          kr[u][i] = *reinterpret_cast<const uint4*>(k_pool + off + c * kVec);
          vr[u][i] = *reinterpret_cast<const uint4*>(v_pool + off + c * kVec);
        } else {
          kr[u][i] = make_uint4(0, 0, 0, 0);
          vr[u][i] = make_uint4(0, 0, 0, 0);
        }
      }
    }
  };
  uint4 kr[kU][kNch], vr[kU][kNch], kn[kU][kNch], vn[kU][kNch];
  bool live[kU], live_n[kU];
  int base = a + warp * per_warp;
  if (base < e) load_pass(base, kr, vr, live);
  for (; base < e; base += stride) {
    // row base is live, so every pass has one live row (warp-uniform loop);
    // the next pass's rows load while this one computes
    if (base + stride < e) load_pass(base + stride, kn, vn, live_n);
    // scores: the lane's partial q . k, summed over the row's segment
    float s[kU][kG];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int g = 0; g < kG; ++g) s[u][g] = 0.f;
#pragma unroll
      for (int i = 0; i < kNch; ++i) {
        const TKV* kx = reinterpret_cast<const TKV*>(&kr[u][i]);
#pragma unroll
        for (int x = 0; x < kVec; ++x) {
          const float kf = round_to<TQ>(to_f32(kx[x]));
#pragma unroll
          for (int g = 0; g < kG; ++g) s[u][g] = fmaf(qr[g][i][x], kf, s[u][g]);
        }
      }
    }
    // every reduction below runs its shuffle offsets in the outer loop, so
    // the kU x kG independent chains overlap their latencies
    for (int o = seg / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int g = 0; g < kG; ++g) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int g = 0; g < kG; ++g) s[u][g] = live[u] ? s[u][g] * sm_scale : kNegInf;
    // online softmax per head, (m, l) uniform over the warp
    float mx[kG], sum[kG], alpha[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      mx[g] = s[0][g];
#pragma unroll
      for (int u = 1; u < kU; ++u) mx[g] = fmaxf(mx[g], s[u][g]);
    }
    for (int o = seg; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < kG; ++g) mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float m_new = fmaxf(m[g], mx[g]);
      alpha[g] = expf(m[g] - m_new);
      m[g] = m_new;
      sum[g] = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float p = expf(s[u][g] - m_new);  // exactly 0 for a dead slot
        sum[g] += p;
        s[u][g] = round_to<TKV>(p);
      }
    }
    for (int o = seg; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < kG; ++g) sum[g] += __shfl_xor_sync(0xffffffffu, sum[g], o);
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      l[g] = alpha[g] * l[g] + sum[g];
#pragma unroll
      for (int i = 0; i < kNch; ++i)
#pragma unroll
        for (int x = 0; x < kVec; ++x) {
          float y = acc[g][i][x] * alpha[g];
#pragma unroll
          for (int u = 0; u < kU; ++u)
            y = fmaf(s[u][g], to_f32(reinterpret_cast<const TKV*>(&vr[u][i])[x]), y);
          acc[g][i][x] = y;
        }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      live[u] = live_n[u];
#pragma unroll
      for (int i = 0; i < kNch; ++i) {
        kr[u][i] = kn[u][i];
        vr[u][i] = vn[u][i];
      }
    }
  }

  // the warp's segments hold sums over their own rows: add them up
  for (int o = seg; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int i = 0; i < kNch; ++i)
#pragma unroll
        for (int x = 0; x < kVec; ++x)
          acc[g][i][x] += __shfl_xor_sync(0xffffffffu, acc[g][i][x], o);
  }
  // merge the warps (a warp with no rows has m = -1e30, l = 0, acc = 0)
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      s_ml[(warp * kG + g) * 2] = m[g];
      s_ml[(warp * kG + g) * 2 + 1] = l[g];
    }
  }
  if (sg == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int i = 0; i < kNch; ++i) {
        const int c = t + seg * i;
        if (c < cpr) {
#pragma unroll
          for (int x = 0; x < kVec; ++x) s_acc[(warp * kG + g) * d + c * kVec + x] = acc[g][i][x];
        }
      }
  }
  __syncthreads();
  const size_t part = ((size_t)b * KV + kv) * n_split + split;  // (b, kv, split)
  for (int idx = tid; idx < kG * d; idx += kThreads) {
    const int g = idx / d, c = idx % d;
    if (g0 + g >= G) continue;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, s_ml[(w * kG + g) * 2]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(s_ml[(w * kG + g) * 2] - mm);  // warp 0 has rows: mm is finite
      ll += f * s_ml[(w * kG + g) * 2 + 1];
      aa += f * s_acc[(w * kG + g) * d + c];
    }
    part_acc[(part * G + g0 + g) * d + c] = aa;
    if (c == 0) {
      part_ml[(part * G + g0 + g) * 2] = mm;
      part_ml[(part * G + g0 + g) * 2 + 1] = ll;
    }
  }
}

template <typename TQ>
__global__ void __launch_bounds__(kMergeThreads)
paged_attention_merge(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
             const int* __restrict__ pos, TQ* __restrict__ out, int KV, int G, int d, int bs,
             int nb_lane, int window, int n_split, int rows_per_split) {
  extern __shared__ float s_ml[];  // [G][2]: each head's m and l over the live splits
  const int kv = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qoff = ((size_t)b * KV + kv) * G * d;
  int lo, hi;
  live_rows(pos[b], window, nb_lane * bs, lo, hi);
  if (lo > hi) {  // pos < 0 (or no live row): exact zeros
    for (int idx = tid; idx < G * d; idx += kMergeThreads) out[qoff + idx] = from_f32<TQ>(0.f);
    return;
  }
  const int s_lo = lo / rows_per_split, n_live = hi / rows_per_split - s_lo + 1;
  const size_t first = ((size_t)b * KV + kv) * n_split + s_lo;  // (b, kv, first live split)
  // m = max_s m_s and l = sum_s exp(m_s - m) l_s, one warp per head, the
  // splits over its lanes and a fixed xor tree
  for (int g = warp; g < G; g += kMergeThreads / 32) {
    float mm = kNegInf;
    for (int s = lane; s < n_live; s += 32) mm = fmaxf(mm, part_ml[((first + s) * G + g) * 2]);
    for (int o = 16; o > 0; o >>= 1) mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, o));
    float ll = 0.f;
    for (int s = lane; s < n_live; s += 32) {
      const size_t ps = (first + s) * G + g;
      ll += expf(part_ml[ps * 2] - mm) * part_ml[ps * 2 + 1];
    }
    for (int o = 16; o > 0; o >>= 1) ll += __shfl_xor_sync(0xffffffffu, ll, o);
    if (lane == 0) {
      s_ml[g * 2] = mm;
      s_ml[g * 2 + 1] = ll;
    }
  }
  __syncthreads();
  // acc = sum_s exp(m_s - m) acc_s in split order; the loads of four
  // splits in flight at once
  for (int idx = tid; idx < G * d; idx += kMergeThreads) {
    const int g = idx / d, c = idx % d;
    const float mm = s_ml[g * 2];
    float aa = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_live; ++s) {
      const size_t ps = (first + s) * G + g;
      aa += expf(part_ml[ps * 2] - mm) * part_acc[ps * d + c];
    }
    out[qoff + idx] = from_f32<TQ>(aa / fmaxf(s_ml[g * 2 + 1], 1e-30f));
  }
}

template <typename TQ, typename TKV, int kG, int kNch>
int launch_split(const void* q, const void* k_pool, const void* v_pool, const void* table,
                 const void* pos, float* part_acc, float* part_ml, int B, int KV, int G, int d,
                 int bs, int nb_lane, int window, float sm_scale, int n_split,
                 int rows_per_split, cudaStream_t stream) {
  const int n_ent = rows_per_split / bs + 1;
  const size_t smem = sizeof(float) * ((size_t)((n_ent + 3) & ~3) + (size_t)kWarps * kG * 2 +
                                       (size_t)kWarps * kG * d);
  const dim3 grid(KV * ((G + kG - 1) / kG), B, n_split);
  paged_attention_split<TQ, TKV, kG, kNch><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(pos), part_acc, part_ml, KV, G, d, bs, nb_lane, window, sm_scale,
      n_split, rows_per_split);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int kNch>
int launch_group(const void* q, const void* k_pool, const void* v_pool, const void* table,
                 const void* pos, float* part_acc, float* part_ml, int B, int KV, int G, int d,
                 int bs, int nb_lane, int window, float sm_scale, int n_split,
                 int rows_per_split, cudaStream_t stream) {
#define REPRO_SPLIT(KG)                                                                     \
  launch_split<TQ, TKV, KG, kNch>(q, k_pool, v_pool, table, pos, part_acc, part_ml, B, KV, \
                                  G, d, bs, nb_lane, window, sm_scale, n_split,            \
                                  rows_per_split, stream)
  if (G <= 1) return REPRO_SPLIT(1);
  if (G <= 2) return REPRO_SPLIT(2);
  if (G <= 4) return REPRO_SPLIT(4);
  return REPRO_SPLIT(kMaxGroup);
#undef REPRO_SPLIT
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
           const void* pos, void* out, void* part_acc, void* part_ml, int B, int KV, int G,
           int d, int bs, int nb_lane, int window, float sm_scale, int n_split,
           int rows_per_split, cudaStream_t stream) {
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int err = 0;
  if (n_split == 0) {  // a table of no blocks: nothing to walk, the merge writes zeros
  } else if constexpr (sizeof(TKV) == 4) {
    if (d > 128)  // an f32 row of more than 32 chunks: two per lane
      err = launch_group<TQ, TKV, 2>(q, k_pool, v_pool, table, pos, pa, pm, B, KV, G, d, bs,
                                     nb_lane, window, sm_scale, n_split, rows_per_split,
                                     stream);
    else
      err = launch_group<TQ, TKV, 1>(q, k_pool, v_pool, table, pos, pa, pm, B, KV, G, d, bs,
                                     nb_lane, window, sm_scale, n_split, rows_per_split,
                                     stream);
  } else {
    err = launch_group<TQ, TKV, 1>(q, k_pool, v_pool, table, pos, pa, pm, B, KV, G, d, bs,
                                   nb_lane, window, sm_scale, n_split, rows_per_split, stream);
  }
  if (err) return err;
  paged_attention_merge<TQ><<<dim3(KV, B), kMergeThreads, sizeof(float) * 2 * G, stream>>>(
      pa, pm, static_cast<const int*>(pos), static_cast<TQ*>(out), KV, G, d, bs, nb_lane, window,
      n_split, rows_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window.
// Requires d % 8 == 0, d <= 256, G * d <= 4096, 16-byte aligned q and
// pools, every table entry a lane reaches (blocks lo..hi) inside the
// pool, rows_per_split a positive multiple of bs, n_split *
// rows_per_split >= nb_lane * bs, and f32 scratch part_acc (B, KV,
// n_split, G, d) and part_ml (B, KV, n_split, G, 2).  Returns the error of
// the launches (0 = none).
extern "C" int paged_attention_launch(int q_dtype, int kv_dtype, const void* q,
                                      const void* k_pool, const void* v_pool,
                                      const void* table, const void* pos, void* out,
                                      void* part_acc, void* part_ml, int B, int KV, int G, int d,
                                      int bs, int nb_lane, int window, float sm_scale,
                                      int n_split, int rows_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 8 != 0 || d < 8 || d > 256 || G < 1 || bs < 1 || rows_per_split < bs ||
      rows_per_split % bs != 0 || (long long)n_split * rows_per_split < (long long)nb_lane * bs)
    return (int)cudaErrorInvalidValue;
#define REPRO_PAGED(TQ, TKV)                                                                \
  launch<TQ, TKV>(q, k_pool, v_pool, table, pos, out, part_acc, part_ml, B, KV, G, d, bs, \
                  nb_lane, window, sm_scale, n_split, rows_per_split, s)
  if (q_dtype == 0 && kv_dtype == 0) return REPRO_PAGED(float, float);
  if (q_dtype == 0 && kv_dtype == 1) return REPRO_PAGED(float, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 0) return REPRO_PAGED(__nv_bfloat16, float);
  if (q_dtype == 1 && kv_dtype == 1) return REPRO_PAGED(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_PAGED
  return (int)cudaErrorInvalidValue;
}
