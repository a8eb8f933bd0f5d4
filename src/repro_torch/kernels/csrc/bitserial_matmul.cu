// Bitserial matmul over sign+magnitude bit-plane packed weights, for
// Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/bitserial_matmul.py: bitserial_matmul_pallas (the
// static kernel) and bitserial_matmul_pallas_dyn (the runtime
// active-plane kernel).  Here they are one kernel with an optional
// device-memory `active` operand (null = every plane).
//
// Computes out (M, N) = x (M, K) @ W (K, N), with W built on the fly from
//   planes (n, K8, N) uint8  bit b of |q|, 8 consecutive K rows per byte,
//                            row kb*8+i in bit i (LSB first along K)
//   sign   (K8, N) uint8     1 = negative, same packing
//   scale  (G,) float32      per-output-group scale, G divides N
// as W = (1 - 2 sign) * sum_{b >= lo} bit_b * 2^(b - lo), lo = n - a,
// a = clamp(*active, 1, n) (a = n without `active`).  Every product is
// accumulated in f32; the epilogue is acc * ((scale * 2^lo) * (1/denom)),
// denom = 2^denom_bits - 1, then a cast to x's dtype: the rounding
// sequence of the Pallas kernel's final-k step.  Dead planes add
// nothing and live planes carry exact integer weights, so active = a is
// bitwise equal to the static kernel over truncate_packed(pw, a).
//
// What bounds it on an H100: at decode (M = a few lanes) the kernel
// reads (n + 1) / 8 bytes per weight element and does 2 M flops on it,
// far below the card's ~295 flop/byte balance point, so it is bound by
// device-memory bytes: for granite-3-2b at n = 6 one decode step reads
// about 2.13 GB of packed weights, about 0.64 ms at 3.35 TB/s.  At
// prefill (M = hundreds of tokens) the same bytes feed 2 M flops each
// and the f32 FMA rate bounds it.
//
// What the design does about that:
//   * the weights never exist unpacked in device memory: each block reads
//     the packed bytes once, as 4-byte words holding 4 neighbouring
//     columns (consecutive threads on consecutive words), and unpacks the
//     4 columns at once with byte-lane masks (0x01010101);
//   * small M (<= 8, decode): a block owns 32 columns and all of K; its
//     256 threads split the K byte-rows 32 ways, keep M x 4 partial sums
//     in registers, and add the 32 partials in a fixed order in shared
//     memory.  There is no split-K across blocks and no atomics, so the
//     sum order is fixed and runs are deterministic;
//   * large M (prefill): a 64 x 64 output tile per block, K walked in
//     64-row chunks; x and the unpacked W chunk are staged in shared
//     memory and each thread computes a 4 x 4 register tile.
// The bf16 cast of each weight is exact (|w| <= 255), so the f32 FMAs
// see exactly the values the Pallas kernel feeds its f32-accumulating
// dot.  wgmma, TMA and pipelining are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr unsigned kLanes = 0x01010101u;

// Live-plane offset lo = n - clamp(active, 1, n); 0 without `active`.
__device__ __forceinline__ int first_live_plane(const int* active, int n_bits) {
  if (active == nullptr) return 0;
  int a = *active;
  a = a < 1 ? 1 : (a > n_bits ? n_bits : a);
  return n_bits - a;
}

// Byte-lane magnitudes of K row i for the 4 columns of the words p[]:
// lane c holds sum_{b >= lo} bit_b(c) << (b - lo) <= 255, so no lane
// carries into the next.
__device__ __forceinline__ unsigned lane_mags(const unsigned (&p)[8], int i, int n_bits,
                                              int lo) {
  unsigned mag4 = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if (b < n_bits && b >= lo) mag4 |= ((p[b] >> i) & kLanes) << (b - lo);
  }
  return mag4;
}

__device__ __forceinline__ float lane_weight(unsigned mag4, unsigned sg4, int c) {
  float m = (float)((mag4 >> (8 * c)) & 0xffu);
  return ((sg4 >> (8 * c)) & 1u) ? -m : m;
}

// Epilogue scale of output column col: (scale[g] * 2^lo) * (1/denom).
__device__ __forceinline__ float col_scale(const float* scale, int col, int N, int G, int lo,
                                           float inv_denom) {
  return (scale[col / (N / G)] * (float)(1u << lo)) * inv_denom;
}

// ---------------------------------------------------------------- small M
constexpr int kSmallM = 8;        // rows a small-M block serves
constexpr int kSmallCols = 32;    // columns per block (8 threads x 4)
constexpr int kSmallKG = 32;      // K groups (256 threads / 8)
constexpr int kSmallChunk = 32;   // K byte-rows of x staged per pass

template <typename T>
__global__ void __launch_bounds__(256)
bitserial_small_m(const T* __restrict__ x, const uint8_t* __restrict__ planes,
                  const uint8_t* __restrict__ sign, const float* __restrict__ scale,
                  const int* __restrict__ active, T* __restrict__ out, int M, int K, int K8,
                  int N, int n_bits, int G, float inv_denom) {
  __shared__ float xs[kSmallM][kSmallChunk * 8];
  __shared__ float red[kSmallKG][kSmallM][kSmallCols];
  const int tid = threadIdx.x;
  const int ct = tid % 8, kg = tid / 8;
  const int col0 = blockIdx.x * kSmallCols + ct * 4;
  const int lo = first_live_plane(active, n_bits);
  const size_t plane_stride = (size_t)K8 * N;

  float acc[kSmallM][4];
#pragma unroll
  for (int m = 0; m < kSmallM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int kb0 = 0; kb0 < K8; kb0 += kSmallChunk) {
    __syncthreads();
    for (int idx = tid; idx < kSmallM * kSmallChunk * 8; idx += blockDim.x) {
      int m = idx / (kSmallChunk * 8), j = idx % (kSmallChunk * 8);
      int k = kb0 * 8 + j;
      xs[m][j] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();
    const int rows = min(kSmallChunk, K8 - kb0);
    if (col0 < N) {
      for (int r = kg; r < rows; r += kSmallKG) {
        const size_t off = (size_t)(kb0 + r) * N + col0;
        unsigned p[8];
#pragma unroll
        for (int b = 0; b < 8; ++b)
          p[b] = b < n_bits ? *reinterpret_cast<const unsigned*>(planes + b * plane_stride + off)
                            : 0u;
        const unsigned s4 = *reinterpret_cast<const unsigned*>(sign + off);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const unsigned mag4 = lane_mags(p, i, n_bits, lo);
          const unsigned sg4 = (s4 >> i) & kLanes;
          float w[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) w[c] = lane_weight(mag4, sg4, c);
#pragma unroll
          for (int m = 0; m < kSmallM; ++m) {
            const float xv = xs[m][r * 8 + i];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kSmallM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[kg][m][ct * 4 + c] = acc[m][c];
  __syncthreads();
  // one output per thread; the 32 K-group partials are added in order
  const int m = tid / kSmallCols, c = tid % kSmallCols;
  const int col = blockIdx.x * kSmallCols + c;
  if (m < M && col < N) {
    float v = 0.f;
    for (int g = 0; g < kSmallKG; ++g) v += red[g][m][c];
    out[(size_t)m * N + col] = from_f32<T>(v * col_scale(scale, col, N, G, lo, inv_denom));
  }
}

// ---------------------------------------------------------------- large M
constexpr int kTileM = 64, kTileN = 64, kTileK = 64;  // kTileK / 8 byte-rows per chunk

template <typename T>
__global__ void __launch_bounds__(256)
bitserial_tiled(const T* __restrict__ x, const uint8_t* __restrict__ planes,
                const uint8_t* __restrict__ sign, const float* __restrict__ scale,
                const int* __restrict__ active, T* __restrict__ out, int M, int K, int K8, int N,
                int n_bits, int G, float inv_denom) {
  __shared__ float xs[kTileM][kTileK + 1];
  __shared__ __align__(16) float ws[kTileK][kTileN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int lo = first_live_plane(active, n_bits);
  const size_t plane_stride = (size_t)K8 * N;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kb0 = 0; kb0 < K8; kb0 += kTileK / 8) {
    __syncthreads();
    for (int idx = tid; idx < kTileM * kTileK; idx += blockDim.x) {
      int mm = idx / kTileK, kk = idx % kTileK;
      int row = m0 + mm, k = kb0 * 8 + kk;
      xs[mm][kk] = (row < M && k < K) ? to_f32(x[(size_t)row * K + k]) : 0.f;
    }
    if (tid < (kTileK / 8) * (kTileN / 4)) {
      const int r = tid / (kTileN / 4), cq = tid % (kTileN / 4);
      const int kb = kb0 + r, col = n0 + cq * 4;
      unsigned p[8], s4 = 0u;
#pragma unroll
      for (int b = 0; b < 8; ++b) p[b] = 0u;
      if (kb < K8 && col < N) {
        const size_t off = (size_t)kb * N + col;
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if (b < n_bits) p[b] = *reinterpret_cast<const unsigned*>(planes + b * plane_stride + off);
        s4 = *reinterpret_cast<const unsigned*>(sign + off);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned mag4 = lane_mags(p, i, n_bits, lo);
        const unsigned sg4 = (s4 >> i) & kLanes;
#pragma unroll
        for (int c = 0; c < 4; ++c) ws[r * 8 + i][cq * 4 + c] = lane_weight(mag4, sg4, c);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty * 4 + i][kk];
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N)
        out[(size_t)row * N + col] =
            from_f32<T>(acc[i][j] * col_scale(scale, col, N, G, lo, inv_denom));
    }
  }
}

template <typename T>
void launch(const void* x, const void* planes, const void* sign, const void* scale,
            const void* active, void* out, int M, int K, int K8, int N, int n_bits, int G,
            float inv_denom, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const uint8_t* pp = static_cast<const uint8_t*>(planes);
  const uint8_t* sp = static_cast<const uint8_t*>(sign);
  const float* sc = static_cast<const float*>(scale);
  const int* ap = static_cast<const int*>(active);
  T* op = static_cast<T*>(out);
  if (M <= kSmallM) {
    dim3 grid((N + kSmallCols - 1) / kSmallCols);
    bitserial_small_m<T><<<grid, 256, 0, stream>>>(xp, pp, sp, sc, ap, op, M, K, K8, N, n_bits,
                                                   G, inv_denom);
  } else {
    dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
    bitserial_tiled<T><<<grid, 256, 0, stream>>>(xp, pp, sp, sc, ap, op, M, K, K8, N, n_bits, G,
                                                 inv_denom);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `active` may be null (every plane).
// Requires 1 <= n_bits <= 8, N % 4 == 0, 4-byte aligned planes/sign, and
// G dividing N.  Returns cudaGetLastError() after the launch.
extern "C" int bitserial_matmul_launch(int dtype, const void* x, const void* planes,
                                       const void* sign, const void* scale, const void* active,
                                       void* out, int M, int K, int K8, int N, int n_bits,
                                       int denom_bits, int G, void* stream) {
  // 1/denom rounded once to f32, as the Pallas epilogue's constant is
  const float inv_denom = (float)(1.0 / ((double)(1ull << denom_bits) - 1.0));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, planes, sign, scale, active, out, M, K, K8, N, n_bits, G, inv_denom, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(x, planes, sign, scale, active, out, M, K, K8, N, n_bits, G,
                          inv_denom, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
