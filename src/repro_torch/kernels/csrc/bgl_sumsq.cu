// Grouped per-row sum of squares and its gradient, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bgl_sumsq_pallas of
// src/repro/kernels/bgl_norm.py:40.  The rows are (bit, group) pairs of a
// BSQ plane tensor viewed as (n_bits * n_groups, rest): the regulariser
// (paper Eq. 4) needs ||[Wp^(b); Wn^(b)]||_2 for every pair of every
// quantised tensor each training step, and takes sqrt, mask and reweighing
// outside.  One launch takes a whole group of such views:
//   x_i   (R_i, C_i)  float32 or bfloat16 (one dtype per group), row-major,
//                     contiguous
//   out   (sum R_i,)  float32: the rows of x_0, then those of x_1, ...;
//                     out[row0_i + r] = sum_c float(x_i[r, c])^2
// and the backward, one launch too:
//   gx_i  = x_i * (2 g[row0_i + r]), in f32 and for bf16 rounded to bf16
//           once: bitwise the plain version's x * (2 g)[:, None].
//
// What bounds both on an H100: each reads every element once (the
// backward also writes one) and does two flops on it, so device-memory
// bytes bound them: sum R_i C_i sizeof(x) over 3.35 TB/s.  A BSQ train step
// of 2-layer full-width granite-3-2b reads 16.04 GB of f32 planes in 16
// views, 4.79 ms; one of ResNet-20 reads 19.5 MB in 44 views, 5.8 us.
//
// What the two-kernel design it replaces lost: one call per view, each a
// partial kernel and a one-block-per-row finish kernel.  The ResNet step
// paid 88 launches of 8.6-14.5 us each (launch and drain, not bytes: 1.3 %
// of its bound), the LM step drained the card 16 times and ran its short
// rows at 32-55 % of their bound.  What this design does about it:
//   * the segment table (pointer, C, first block, first output row, chunks
//     per row, chunk length) travels by value in the launch's parameters
//     (__grid_constant__, read from the constant bank): no host-to-device
//     copy and no allocation that depends on the data, so the launch can be
//     captured in a graph.  kMaxSegs segments fit one launch; the wrapper
//     splits a longer table into several launches and counts each;
//   * every block sums one chunk of one row; a row is cut into chunks whose
//     length depends on that row's length alone (about 16 pieces, a power
//     of two between 32 KB and 256 KB), so a 1.7 KB ResNet row is one block,
//     a 147 KB one five blocks (the ResNet group 882 blocks, one wave), and a
//     3.64 GB embedding row 256 KB blocks, all of a group's blocks in one grid;
//   * 256 threads read 16-byte vectors, eight independent loads in flight
//     per thread (the last round predicated, so a 32 KB chunk has all of
//     its loads in flight at once), squares summed in f32 (bf16 widens
//     exactly to f32 first); a chunk whose start is not 16-byte aligned
//     takes its first and last few elements as scalars, so any C and any
//     element-aligned view works.  A variant that read through a
//     shared-memory ring of cp.async.bulk copies (4 x 16 KB, an mbarrier
//     per stage) was measured once on the card: 0.27 % faster on the LM
//     group, within 2-3 % either way on the small groups, a tie, so it was
//     dropped; the vector loads need no shared memory and no barriers;
//   * the reduction stays in the launch: a block reduces its threads in a
//     fixed tree and, for a row of one chunk, writes the row's sum; else it
//     writes its partial, fences, and counts itself on the row's counter;
//     the block that finds itself last sums the row's partials in index
//     order and resets the counter to 0 for the next launch.  No float
//     atomics: a second call gives the same bits, and a view's sums are the
//     same bits alone or in any group (its chunking is its own);
//   * the backward walks the same blocks, reads g once per block, and
//     stores 16-byte vectors where x and gx share their alignment.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;
constexpr int kMaxSegs = 96;  // 96 x 40 bytes: the table and the pointers fit 4 KB

struct Seg {
  const void* x;   // (R, C), row-major
  void* gx;        // the backward's output, shaped like x (unused forward)
  long long C;
  int block0;      // the segment's first block in the launch
  int row0;        // its first row in the flat output (and in g)
  int n_chunks;    // blocks per row
  int chunk;       // elements per block; a row's last block may take fewer
};

struct Table {
  int n;
  Seg s[kMaxSegs];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// sum of squares of the values in one 16-byte vector
template <typename T> __device__ __forceinline__ float vec_sumsq(uint4 v);

template <> __device__ __forceinline__ float vec_sumsq<float>(uint4 v) {
  const float a = __uint_as_float(v.x), b = __uint_as_float(v.y);
  const float c = __uint_as_float(v.z), d = __uint_as_float(v.w);
  return (a * a + b * b) + (c * c + d * d);
}

// a bf16 is the high half of the f32 with the same value; element 0 of
// each 32-bit word sits in its low half (little-endian)
__device__ __forceinline__ float bf16_pair_sumsq(uint32_t w) {
  const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xffff0000u);
  return lo * lo + hi * hi;
}

template <> __device__ __forceinline__ float vec_sumsq<__nv_bfloat16>(uint4 v) {
  return (bf16_pair_sumsq(v.x) + bf16_pair_sumsq(v.y)) +
         (bf16_pair_sumsq(v.z) + bf16_pair_sumsq(v.w));
}

// v * g2 for each value of one 16-byte vector, each rounded once to T
template <typename T> __device__ __forceinline__ uint4 vec_scale(uint4 v, float g2);

template <> __device__ __forceinline__ uint4 vec_scale<float>(uint4 v, float g2) {
  return make_uint4(__float_as_uint(__uint_as_float(v.x) * g2),
                    __float_as_uint(__uint_as_float(v.y) * g2),
                    __float_as_uint(__uint_as_float(v.z) * g2),
                    __float_as_uint(__uint_as_float(v.w) * g2));
}

__device__ __forceinline__ uint32_t bf16_pair_scale(uint32_t w, float g2) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(__uint_as_float(w << 16) * g2,
                                                 __uint_as_float(w & 0xffff0000u) * g2);
  return *reinterpret_cast<const uint32_t*>(&r);  // .x (low half) is element 0
}

template <> __device__ __forceinline__ uint4 vec_scale<__nv_bfloat16>(uint4 v, float g2) {
  return make_uint4(bf16_pair_scale(v.x, g2), bf16_pair_scale(v.y, g2),
                    bf16_pair_scale(v.z, g2), bf16_pair_scale(v.w, g2));
}

// the block's sum in thread 0, in a fixed order; every thread calls it
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) {
    s = lane < kWarps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  return s;
}

// the segment that holds block blk: the last one whose block0 <= blk (the
// same for every thread of the block)
__device__ __forceinline__ int find_seg(const Table& tab, int blk) {
  int lo = 0, hi = tab.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.s[mid].block0 <= blk) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// one block's share of the work: chunk c of row r of segment seg
struct Work {
  int seg, r, c, row;
  long long start, n;  // the chunk's first element in its row, its length
};

__device__ __forceinline__ Work block_work(const Table& tab) {
  Work w;
  const int blk = blockIdx.x;
  w.seg = find_seg(tab, blk);
  const Seg& sg = tab.s[w.seg];
  const int local = blk - sg.block0;
  w.r = local / sg.n_chunks;
  w.c = local - w.r * sg.n_chunks;
  w.row = sg.row0 + w.r;
  w.start = (long long)w.c * sg.chunk;
  w.n = min((long long)sg.chunk, sg.C - w.start);
  return w;
}

// elements of p before its first 16-byte boundary (p is element-aligned)
template <typename T>
__device__ __forceinline__ long long head_of(const T* p, long long n) {
  return min(n, (long long)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T)));
}

// this thread's share of sum_i p[i]^2 over n elements, in a fixed order
template <typename T>
__device__ __forceinline__ float chunk_sumsq(const T* p, long long n) {
  constexpr int V = 16 / sizeof(T);
  const long long head = head_of(p, n);
  const long long nvec = (n - head) / V;
  const long long tail = head + nvec * V;
  const uint4* pv = reinterpret_cast<const uint4*>(p + head);
  float acc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = 0.f;
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(pv + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] += vec_sumsq<T>(v[u]);
  }
  if (i < nvec) {  // the last round, fewer than kUnroll vectors for this thread
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * kThreads;
      v[u] = j < nvec ? __ldg(pv + j) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] += vec_sumsq<T>(v[u]);
  }
  // fewer than V scalars each at the head and the tail
  float e = 0.f;
  if (threadIdx.x < head) {
    const float f = to_f32(p[threadIdx.x]);
    e += f * f;
  }
  if (threadIdx.x < n - tail) {
    const float f = to_f32(p[tail + threadIdx.x]);
    e += f * f;
  }
#pragma unroll
  for (int w = kUnroll / 2; w > 0; w >>= 1)
#pragma unroll
    for (int u = 0; u < w; ++u) acc[u] += acc[u + w];
  return acc[0] + e;
}

// the block's chunk sum to the row: a row of one chunk takes it as its sum;
// else the last of the row's blocks to finish sums the row's partials
__device__ __forceinline__ void row_epilogue(float thread_sum, const Work& w, const Seg& sg,
                                             float* __restrict__ partial,
                                             unsigned int* __restrict__ counter,
                                             float* __restrict__ out) {
  const float s = block_sum(thread_sum);
  if (sg.n_chunks == 1) {
    if (threadIdx.x == 0) out[w.row] = s;
    return;
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s;
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(counter + w.row, 1u) == (unsigned int)(sg.n_chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the row's partials, in index order: thread t takes j = t, t + 256, ...
  const float* pp = partial + (blockIdx.x - w.c);
  float t = 0.f;
  for (int j = threadIdx.x; j < sg.n_chunks; j += kThreads) t += __ldcg(pp + j);
  t = block_sum(t);
  if (threadIdx.x == 0) {
    out[w.row] = t;
    counter[w.row] = 0u;  // ready for the next launch
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bgl_grouped_kernel(const __grid_constant__ Table tab, float* __restrict__ partial,
                   unsigned int* __restrict__ counter, float* __restrict__ out) {
  const Work w = block_work(tab);
  const Seg& sg = tab.s[w.seg];
  const T* p = static_cast<const T*>(sg.x) + (long long)w.r * sg.C + w.start;
  row_epilogue(chunk_sumsq<T>(p, w.n), w, sg, partial, counter, out);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bgl_grad_kernel(const __grid_constant__ Table tab, const float* __restrict__ g,
                long long g_stride) {
  constexpr int V = 16 / sizeof(T);
  const Work w = block_work(tab);
  const Seg& sg = tab.s[w.seg];
  const float g2 = 2.0f * __ldg(g + w.row * g_stride);
  const long long off = (long long)w.r * sg.C + w.start;
  const T* p = static_cast<const T*>(sg.x) + off;
  T* q = static_cast<T*>(sg.gx) + off;
  const long long n = w.n;
  if (((reinterpret_cast<uintptr_t>(p) ^ reinterpret_cast<uintptr_t>(q)) & 15) != 0) {
    for (long long i = threadIdx.x; i < n; i += kThreads) from_f32(q + i, to_f32(p[i]) * g2);
    return;
  }
  const long long head = head_of(p, n);
  const long long nvec = (n - head) / V;
  const long long tail = head + nvec * V;
  const uint4* pv = reinterpret_cast<const uint4*>(p + head);
  uint4* qv = reinterpret_cast<uint4*>(q + head);
  for (long long i = threadIdx.x; i < nvec; i += kUnroll * kThreads) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * kThreads;
      if (j < nvec) v[u] = __ldg(pv + j);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * kThreads;
      if (j < nvec) qv[j] = vec_scale<T>(v[u], g2);
    }
  }
  if (threadIdx.x < head) from_f32(q + threadIdx.x, to_f32(p[threadIdx.x]) * g2);
  if (threadIdx.x < n - tail)
    from_f32(q + tail + threadIdx.x, to_f32(p[tail + threadIdx.x]) * g2);
}

// the table from the host arrays; 0, or an error for a bad argument
int fill(Table& tab, int n, const void* const* xs, void* const* gxs, const long long* C,
         const int* block0, const int* row0, const int* n_chunks, const int* chunk) {
  if (n < 1 || n > kMaxSegs) return (int)cudaErrorInvalidValue;
  tab.n = n;
  for (int i = 0; i < n; ++i) {
    if (n_chunks[i] < 1 || chunk[i] < 1) return (int)cudaErrorInvalidValue;
    tab.s[i] = Seg{xs[i], gxs ? gxs[i] : nullptr, C[i], block0[i], row0[i], n_chunks[i],
                   chunk[i]};
  }
  return 0;
}

}  // namespace

// One launch over n <= kMaxSegs segments (a longer table is refused with
// cudaErrorInvalidValue).  dtype: 0 = float32, 1 = bfloat16.
// Segment i holds R_i rows of C_i elements at xs[i]; its blocks are
// block0[i] .. block0[i] + R_i * n_chunks[i] - 1 (block0[0] = 0, ascending,
// n_blocks in all), each summing chunk[i] elements of one row (the last of
// a row fewer); its rows land at out[row0[i] ...].  partial holds n_blocks
// floats; counter holds an unsigned int per output row, all 0, and is left
// all 0.  Returns cudaGetLastError() after the launch.
extern "C" int bgl_sumsq_grouped_launch(int dtype, int n, const void* const* xs,
                                        const long long* C, const int* block0, const int* row0,
                                        const int* n_chunks, const int* chunk, int n_blocks,
                                        void* partial, void* counter, void* out, void* stream) {
  Table tab;
  int err = fill(tab, n, xs, nullptr, C, block0, row0, n_chunks, chunk);
  if (err) return err;
  if (n_blocks < 1 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  unsigned int* cc = static_cast<unsigned int*>(counter);
  float* oo = static_cast<float*>(out);
  const dim3 grid((unsigned int)n_blocks);
  if (dtype == 0) {
    bgl_grouped_kernel<float><<<grid, kThreads, 0, s>>>(tab, pp, cc, oo);
  } else {
    bgl_grouped_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(tab, pp, cc, oo);
  }
  return (int)cudaGetLastError();
}

// The backward over the same kind of table: gxs[i] (shaped like xs[i],
// contiguous) = xs[i] * 2 g[(row0[i] + r) * g_stride] for each row r.
extern "C" int bgl_sumsq_grad_launch(int dtype, int n, const void* const* xs, void* const* gxs,
                                     const long long* C, const int* block0, const int* row0,
                                     const int* n_chunks, const int* chunk, int n_blocks,
                                     const void* g, long long g_stride, void* stream) {
  Table tab;
  int err = fill(tab, n, xs, gxs, C, block0, row0, n_chunks, chunk);
  if (err) return err;
  if (n_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gg = static_cast<const float*>(g);
  if (dtype == 0)
    bgl_grad_kernel<float><<<(unsigned int)n_blocks, kThreads, 0, s>>>(tab, gg, g_stride);
  else if (dtype == 1)
    bgl_grad_kernel<__nv_bfloat16><<<(unsigned int)n_blocks, kThreads, 0, s>>>(tab, gg,
                                                                                g_stride);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
