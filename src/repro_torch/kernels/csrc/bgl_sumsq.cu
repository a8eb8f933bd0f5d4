// Per-row sum of squares of an (R, C) matrix, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bgl_sumsq_pallas of
// src/repro/kernels/bgl_norm.py:40.  The rows are (bit, group) pairs of a
// BSQ plane tensor viewed as (n_bits * n_groups, rest): the regulariser
// (paper Eq. 4) needs ||[Wp^(b); Wn^(b)]||_2 for every pair each training
// step, and takes sqrt, mask and reweighing outside.
//   x    (R, C)  float32 or bfloat16, row-major, contiguous
//   out  (R,)    float32: out[r] = sum_c float(x[r, c])^2
//
// What bounds it on an H100: it reads every element once and does two
// flops on it, so it is bound by device-memory bytes: R * C * sizeof(x)
// over 3.35 TB/s.  A BSQ train step of 2-layer full-width granite-3-2b
// reads 16.04 GB of f32 planes in 16 calls, 4.79 ms; one (9, 101,187,584)
// embedding plane tensor is 3.64 GB, 1.09 ms.
//
// What the design does about that: the TPU kernel carries each row's sum
// along a sequential grid axis in VMEM.  Here rows are few (9 to 18) and
// long (1e6 to 1e8 elements), so one block per row would leave most of
// the 132 SMs idle.  Instead:
//   * each row is cut into chunks of 256 KB and every chunk is a block
//     (13,896 blocks for the embedding), 256 threads reading 16-byte
//     vectors, four independent loads in flight per thread, squares
//     summed in f32 (bf16 widens exactly to f32 first);
//   * a chunk whose start is not 16-byte aligned (a row length that is
//     no multiple of 4 f32 or 8 bf16 values) takes its first and last
//     few elements as scalars, so any C works;
//   * each block reduces its threads in a fixed tree (warp shuffles, then
//     one warp over the warp sums) and writes one partial to an
//     (R, n_chunks) scratch; a second kernel sums each row's partials in
//     index order in one block.  No float atomics: a second call on the
//     same input gives the same bits.
// TMA bulk loads and a single-kernel last-block reduction are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// the block's sum in thread 0, in a fixed order
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

// block b = r * n_chunks + c sums row r's elements [c * chunk, (c + 1) * chunk)
template <typename T>
__global__ void __launch_bounds__(kThreads)
bgl_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, long long C,
                   long long chunk, long long n_chunks) {
  constexpr int V = 16 / sizeof(T);
  const long long blk = blockIdx.x;
  const long long r = blk / n_chunks, c = blk % n_chunks;
  const long long start = c * chunk;
  const long long n = min(chunk, C - start);
  const T* p = x + r * C + start;
  // elements before the first 16-byte boundary (x is element-aligned)
  const long long head =
      min(n, (long long)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T)));
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
  for (; i < nvec; i += kThreads) acc[0] += vec_sumsq<T>(__ldg(pv + i));
  // fewer than V scalars each at the head and the tail
  if (threadIdx.x < head) {
    const float f = to_f32(p[threadIdx.x]);
    acc[1] += f * f;
  }
  if (threadIdx.x < n - tail) {
    const float f = to_f32(p[tail + threadIdx.x]);
    acc[2] += f * f;
  }
  const float s = block_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
  if (threadIdx.x == 0) partial[blk] = s;
}

// block r sums row r's n_chunks partials: thread t takes j = t, t + 256, ...
__global__ void __launch_bounds__(kThreads)
bgl_finish_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  long long n_chunks) {
  const float* p = partial + (long long)blockIdx.x * n_chunks;
  float s = 0.f;
  for (long long j = threadIdx.x; j < n_chunks; j += kThreads) s += p[j];
  s = block_sum(s);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  partial holds R * n_chunks floats,
// n_chunks = ceil(C / chunk); R * n_chunks and R fit a 1-D grid; R, C >= 1.
// Returns cudaGetLastError() after the two launches.
extern "C" int bgl_sumsq_launch(int dtype, const void* x, void* partial, void* out, long long R,
                                long long C, long long chunk, long long n_chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = (unsigned int)(R * n_chunks);
  float* pp = static_cast<float*>(partial);
  if (dtype == 0)
    bgl_partial_kernel<float><<<blocks, kThreads, 0, s>>>(static_cast<const float*>(x), pp, C,
                                                          chunk, n_chunks);
  else if (dtype == 1)
    bgl_partial_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), pp, C, chunk, n_chunks);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bgl_finish_kernel<<<(unsigned int)R, kThreads, 0, s>>>(pp, static_cast<float*>(out), n_chunks);
  return (int)cudaGetLastError();
}
