// Bitserial matmul over sign+magnitude bit-plane packed weights, for
// Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/bitserial_matmul.py: bitserial_matmul_pallas (the
// static kernel) and bitserial_matmul_pallas_dyn (the runtime
// active-plane kernel).  Here they are one entry with an optional
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
// sequence of the Pallas kernel's final-k step.  Live planes carry exact
// integer weights (|w| <= 255, exact in bf16 and f32), dead planes are
// never read, and no tile or split depends on `active`, so active = a is
// bitwise equal to the static path over truncate_packed(pw, a).
//
// What bounds it on an H100:
//   * decode (M <= 8): (n + 1) / 8 bytes of packed weight per element and
//     2 M flops on it, far below the card's ~295 flop/byte balance, so
//     device-memory bytes bound it: one granite-3-2b layer (7
//     projections, n = 6) reads 51 MB, 0.016 ms at 3.35 TB/s.  A call
//     moves 1 to 52 MB, a few microseconds, so in practice a chain of
//     latencies (launch, loads, the reduction of the K splits) and the
//     unpacking (about 10 instructions per weight with the FMAs) set its
//     time;
//   * prefill (M in the hundreds or thousands): 2 M flops per weight,
//     bound by the tensor cores' bf16 rate (989 TFLOP/s): gemma3-12b's
//     2 x 4096-token prefill runs 176 TFLOP here, 0.18 s at that rate.
//     The unpacking of each weight tile has to keep up with the products
//     of a tall M tile.
//
// What the design does about that (three kernels, picked per call):
//   * splitk_kernel, decode (M <= 8, f32 or bf16): a block of 128 threads
//     owns 128 columns (8 threads x 16 neighbouring columns: 16-byte loads
//     of every live plane and of the sign, neighbouring threads on
//     neighbouring addresses; 8 columns at M > 4, where 16 would not fit
//     255 registers; 4-byte words where N is no multiple of 16) and one
//     split of K, whose byte-rows 16 threads share, the next row's loads
//     in flight while one is summed.  The split plan (the wrapper's, a
//     function of M, K and N alone) keeps the grid within one wave of 264
//     blocks with a whole number of rows per thread.  x is
//     staged once per block (in chunks where K is long), the first loads
//     already in flight.  M is a template (1, 2, 4, 8).  The block adds
//     its threads' partials in a fixed order in shared memory and writes
//     one partial per split to a workspace; the last block of a column
//     tile to arrive (an arrival counter, reset by that block) sums the
//     splits in split order and applies the epilogue: one launch, no
//     float atomics, a second call gives the same bits.  Planes below lo
//     are never loaded.  The 8 x 8 bit matrix of each byte (planes x K
//     rows) is transposed with delta swaps, 4 columns per 32-bit word, and
//     each magnitude becomes an f32 through the 2^23 exponent trick;
//   * wgmma_kernel, prefill (M > 8, bf16 x, K % 8 == 0, N % 16 == 0,
//     16-byte aligned operands): a 256 x 128 output tile per block, warp-
//     specialised.  Two producer warpgroups bring each K step's x tile
//     (256 x 64) in by TMA, 128-byte swizzled, and unpack the step's
//     packed bytes (loaded into registers a step ahead) into an N-major
//     bf16 weight tile: bit transpose, then bf16 128 + m built byte-wise
//     with the sign as bit 7, and 128 subtracted.  Two consumer
//     warpgroups of 128 rows issue wgmma.m64n128k16 (bf16 x bf16 -> f32)
//     and nothing else.  A 4-stage ring of x and weight tiles with
//     mbarriers between them, no block-wide barrier in the loop;
//     setmaxnreg moves registers from the producers to the consumers'
//     accumulators.  Blocks walk the tiles in groups of 8 M-tiles, so a
//     wave's x rows and weight columns stay in L2;
//   * tiled_kernel (M > 8 otherwise: f32 x, the parity path, and bf16
//     shapes the wgmma tile does not take): a 64 x 64 f32 FMA tile out of
//     shared memory.  TF32 would break the f32 parity checks, so f32
//     stays off the tensor cores; nothing on the serving path runs f32.

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from the driver at run time)
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

// Epilogue scale of output column col: (scale[g] * 2^lo) * (1/denom).
__device__ __forceinline__ float col_scale(const float* scale, int col, int N, int G, int lo,
                                           float inv_denom) {
  return (scale[col / (N / G)] * (float)(1u << lo)) * inv_denom;
}

// byte permute (PTX prmt, default mode): byte j of the result is byte
// (sel >> 4j) & 7 of {b, a}, or that byte's sign replicated when bit 3 of
// the nibble is set
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// a - b on two bf16 lanes, rounded to nearest
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t bf16x2_pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- bit unpacking (integer code on 32-bit words of 4 byte lanes, one
// ---- output column per lane)

// exchange bits (a >> s) & m with bits b & m
__device__ __forceinline__ void swap_bits(uint32_t& a, uint32_t& b, int s, uint32_t m) {
  const uint32_t t = ((a >> s) ^ b) & m;
  b ^= t;
  a ^= t << s;
}

// Per byte lane, the 8 x 8 bit matrix M[b][i] = bit i of lane c of p[b]
// is transposed in place: afterwards bit b of lane c of p[i] is the old
// bit i of lane c of p[b].  With p[b] = magnitude plane b (bit i = K row
// i of the byte-row), lane c of p[i] becomes the magnitude of K row i.
__device__ __forceinline__ void transpose8(uint32_t (&p)[8]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) swap_bits(p[b], p[b + 4], 4, 0x0F0F0F0Fu);
#pragma unroll
  for (int b = 0; b < 8; b += 4) {
    swap_bits(p[b], p[b + 2], 2, 0x33333333u);
    swap_bits(p[b + 1], p[b + 3], 2, 0x33333333u);
  }
#pragma unroll
  for (int b = 0; b < 8; b += 2) swap_bits(p[b], p[b + 1], 1, 0x55555555u);
}

// Weight of lane c as an f32: lane c of r is the magnitude m (8 bits),
// bit 8c + i of s its sign.  0x4B000000 | m is the float 2^23 + m.
template <int c, int i>
__device__ __forceinline__ float weight_f32(uint32_t r, uint32_t s) {
  const float m = __uint_as_float(prmt(r, 0x4B000000u, 0x7440u | c)) - 8388608.0f;
  return __uint_as_float(__float_as_uint(m) ^ ((s << (31 - 8 * c - i)) & 0x80000000u));
}

// Four bf16 weights (lanes 0..3 of r, two per word, the lower lane in the
// low half) when at most 7 planes are live and the sign rides as bit 7 of
// each lane (m < 128): the halves (s << 15) | 0x4300 | m are +-(128 + m)
// exactly, and subtracting their +-128 leaves +-m.
__device__ __forceinline__ uint2 weights_bf16_narrow(uint32_t r) {
  const uint32_t hi = (r & 0x80808080u) | 0x43434343u;
  const uint32_t lo = r & 0x7F7F7F7Fu;
  const uint32_t w01 = prmt(lo, hi, 0x5140u), w23 = prmt(lo, hi, 0x7362u);
  return make_uint2(bf16x2_sub(w01, w01 & 0xFF00FF00u), bf16x2_sub(w23, w23 & 0xFF00FF00u));
}

// The same with 8 live planes (m up to 255): lane c of r is m, bit 8c + i
// of s its sign.
template <int i>
__device__ __forceinline__ uint2 weights_bf16_wide(uint32_t r, uint32_t s) {
  const uint32_t w01 = bf16x2_pack(weight_f32<0, i>(r, s), weight_f32<1, i>(r, s));
  const uint32_t w23 = bf16x2_pack(weight_f32<2, i>(r, s), weight_f32<3, i>(r, s));
  return make_uint2(w01, w23);
}

// ---- end of bit unpacking

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

// ---------------------------------------------------------------- decode
constexpr int kSplitThreads = 128;
constexpr int kColThreads = 8;                             // threads across a column tile
constexpr int kKThreads = kSplitThreads / kColThreads;     // threads across a split's rows
constexpr int kRedCols = kColThreads * 4;                  // columns per reduction round
constexpr int kXBytes = 24 * 1024;                         // x a block stages at a time, f32

// byte-rows of x a block stages at a time: a multiple of kKThreads, so a
// thread's rows keep their order whatever the chunking
template <int MT> constexpr int x_rows() { return kXBytes / (MT * 8 * 4); }

template <int W> struct Words;  // W 32-bit words of one plane, one byte-row
template <> struct Words<4> {
  static __device__ __forceinline__ void load(uint32_t (&w)[4], const uint8_t* p) {
    if (p == nullptr) {
      w[0] = w[1] = w[2] = w[3] = 0u;
      return;
    }
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
};
template <> struct Words<2> {
  static __device__ __forceinline__ void load(uint32_t (&w)[2], const uint8_t* p) {
    if (p == nullptr) {
      w[0] = w[1] = 0u;
      return;
    }
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  }
};
template <> struct Words<1> {
  static __device__ __forceinline__ void load(uint32_t (&w)[1], const uint8_t* p) {
    w[0] = p == nullptr ? 0u : __ldg(reinterpret_cast<const unsigned int*>(p));
  }
};

// byte-row r of every live plane (from live0 on, pstride apart) and of
// the sign at column col0; zeros where !ok
template <int W>
__device__ __forceinline__ void load_row(uint32_t (&p)[8][W], uint32_t (&sg)[W],
                                         const uint8_t* live0, const uint8_t* sign,
                                         size_t pstride, size_t off, int a, bool ok) {
#pragma unroll
  for (int b = 0; b < 8; ++b)
    Words<W>::load(p[b], ok && b < a ? live0 + b * pstride + off : nullptr);
  Words<W>::load(sg, ok ? sign + off : nullptr);
}

// One block: columns [n0, n0 + kColThreads * CV) and the byte-rows
// [s * rps, (s + 1) * rps) of split s = blockIdx.y.  Thread (tk, tc) owns
// columns n0 + tc * CV .. + CV - 1 and the byte-rows r0 + tk + j *
// kKThreads, the next one's loads in flight while one is summed.  Per
// column the K rows are summed in order within a thread, then over tk (in
// shared memory), then over the splits in split order by the last block
// of the column tile to arrive (the workspace holds the splits' partials).
template <typename T, int MT, int CV>
__global__ void __launch_bounds__(kSplitThreads, 1)
splitk_kernel(const T* __restrict__ x, const uint8_t* __restrict__ planes,
              const uint8_t* __restrict__ sign, const float* __restrict__ scale,
              const int* __restrict__ active, T* __restrict__ out, float* __restrict__ ws,
              unsigned* __restrict__ counters, int M, int K, int K8, int N, int n_bits, int G,
              float inv_denom, int rps, int xr) {
  constexpr int W = CV / 4;               // words per plane per byte-row
  constexpr int BW = kColThreads * CV;    // the block's columns
  extern __shared__ float smem[];
  float* xs = smem;                       // [MT][xr * 8]: rows of x, f32
  float* red = xs + MT * xr * 8;          // [kKThreads][MT][kRedCols]
  __shared__ unsigned is_last;

  const int tid = threadIdx.x;
  const int tc = tid % kColThreads, tk = tid / kColThreads;
  const int n0 = blockIdx.x * BW;
  const int col0 = n0 + tc * CV;
  const int n_split = gridDim.y;
  const int r0 = blockIdx.y * rps, r1 = min(r0 + rps, K8);
  const int lo = first_live_plane(active, n_bits);
  const int a = n_bits - lo;
  const size_t pstride = (size_t)K8 * N;
  const uint8_t* live0 = planes + (size_t)lo * pstride;  // the first live plane
  const bool live_cols = col0 < N;  // N % CV == 0: a thread's columns are all in or all out
  const int kw = xr * 8;

  float acc[MT][CV];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[m][c] = 0.f;

  for (int c0 = r0; c0 < r1; c0 += xr) {  // x in chunks of xr byte-rows
    const int c1 = min(c0 + xr, r1);
    uint32_t p[8][W], sg[W];
    // the first row's loads fly while x is staged
    load_row<W>(p, sg, live0, sign, pstride, (size_t)(c0 + tk) * N + col0, a,
                live_cols && c0 + tk < c1);
    if (c0 > r0) __syncthreads();  // the last chunk is done with xs
    for (int idx = tid; idx < MT * kw; idx += kSplitThreads) {
      const int m = idx / kw, j = idx % kw, k = c0 * 8 + j;
      xs[idx] = (m < M && j < (c1 - c0) * 8 && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();
    if (!live_cols) continue;
    for (int r = c0 + tk; r < c1; r += kKThreads) {
      uint32_t pn[8][W], sgn[W];
      // the next row's loads fly while this one is summed
      load_row<W>(pn, sgn, live0, sign, pstride, (size_t)(r + kKThreads) * N + col0, a,
                  r + kKThreads < c1);
      const float* xr8 = xs + (r - c0) * 8;
#pragma unroll
      for (int q = 0; q < W; ++q) {
        uint32_t t[8];
#pragma unroll
        for (int b = 0; b < 8; ++b) t[b] = p[b][q];
        transpose8(t);
        const uint32_t sq = sg[q];
#define BSM_ROW(I)                                                                  \
  {                                                                                 \
    const float w0 = weight_f32<0, I>(t[I], sq), w1 = weight_f32<1, I>(t[I], sq);   \
    const float w2 = weight_f32<2, I>(t[I], sq), w3 = weight_f32<3, I>(t[I], sq);   \
    _Pragma("unroll") for (int m = 0; m < MT; ++m) {                                \
      const float xv = xr8[m * kw + I];                                             \
      acc[m][q * 4 + 0] = fmaf(xv, w0, acc[m][q * 4 + 0]);                          \
      acc[m][q * 4 + 1] = fmaf(xv, w1, acc[m][q * 4 + 1]);                          \
      acc[m][q * 4 + 2] = fmaf(xv, w2, acc[m][q * 4 + 2]);                          \
      acc[m][q * 4 + 3] = fmaf(xv, w3, acc[m][q * 4 + 3]);                          \
    }                                                                               \
  }
        BSM_ROW(0) BSM_ROW(1) BSM_ROW(2) BSM_ROW(3)
        BSM_ROW(4) BSM_ROW(5) BSM_ROW(6) BSM_ROW(7)
#undef BSM_ROW
      }
#pragma unroll
      for (int q = 0; q < W; ++q) {
#pragma unroll
        for (int b = 0; b < 8; ++b) p[b][q] = pn[b][q];
        sg[q] = sgn[q];
      }
    }
  }

  // the kKThreads partials of each column, added in tk order, 4 columns
  // of every thread a round: the output itself with one split, else the
  // split's partial in the workspace
#pragma unroll
  for (int q4 = 0; q4 < CV / 4; ++q4) {
    __syncthreads();  // red is free
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[(tk * MT + m) * kRedCols + tc * 4 + c] = acc[m][q4 * 4 + c];
    __syncthreads();
    for (int e = tid; e < MT * kRedCols; e += kSplitThreads) {
      const int m = e / kRedCols, cc = e % kRedCols;
      const int cl = (cc / 4) * CV + q4 * 4 + cc % 4, col = n0 + cl;
      float v = 0.f;
      for (int g = 0; g < kKThreads; ++g) v += red[(g * MT + m) * kRedCols + cc];
      if (m >= M || col >= N) continue;
      if (n_split > 1)
        ws[((size_t)blockIdx.y * M + m) * N + col] = v;
      else
        out[(size_t)m * N + col] = from_f32<T>(v * col_scale(scale, col, N, G, lo, inv_denom));
    }
  }
  if (n_split == 1) return;

  // the last block of this column tile to arrive sums the splits in order
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[blockIdx.x], 1u) == (unsigned)(n_split - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int quads = min(BW, N - n0) / 4;  // N % 4 == 0
  for (int e = tid; e < M * quads; e += kSplitThreads) {
    const int m = e / quads, col = n0 + (e % quads) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int t = 0; t < n_split; ++t) {
      const float4 u =
          __ldcg(reinterpret_cast<const float4*>(ws + ((size_t)t * M + m) * N + col));
      v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
    }
    T* o = out + (size_t)m * N + col;
    o[0] = from_f32<T>(v.x * col_scale(scale, col, N, G, lo, inv_denom));
    o[1] = from_f32<T>(v.y * col_scale(scale, col + 1, N, G, lo, inv_denom));
    o[2] = from_f32<T>(v.z * col_scale(scale, col + 2, N, G, lo, inv_denom));
    o[3] = from_f32<T>(v.w * col_scale(scale, col + 3, N, G, lo, inv_denom));
  }
  if (tid == 0) counters[blockIdx.x] = 0u;  // ready for the next call
}

template <typename T, int MT, int CV>
int launch_splitk(const void* x, const void* planes, const void* sign, const void* scale,
                  const void* active, void* out, void* ws, void* counters, int M, int K, int K8,
                  int N, int n_bits, int G, float inv_denom, int n_split, int rps,
                  cudaStream_t stream) {
  const int xr = min(x_rows<MT>(), (rps + kKThreads - 1) / kKThreads * kKThreads);
  const size_t smem = sizeof(float) * ((size_t)MT * xr * 8 + (size_t)kKThreads * MT * kRedCols);
  const dim3 grid((N + kColThreads * CV - 1) / (kColThreads * CV), n_split);
  splitk_kernel<T, MT, CV><<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(planes),
      static_cast<const uint8_t*>(sign), static_cast<const float*>(scale),
      static_cast<const int*>(active), static_cast<T*>(out), static_cast<float*>(ws),
      static_cast<unsigned*>(counters), M, K, K8, N, n_bits, G, inv_denom, rps, xr);
  return (int)cudaGetLastError();
}

template <typename T, int MT>
int launch_splitk_cv(bool wide, const void* x, const void* planes, const void* sign,
                     const void* scale, const void* active, void* out, void* ws, void* counters,
                     int M, int K, int K8, int N, int n_bits, int G, float inv_denom, int n_split,
                     int rps, cudaStream_t stream) {
  // 16 columns a thread (8 at M > 4, where 16 would not fit 255 registers)
  if (wide)
    return launch_splitk<T, MT, MT >= 8 ? 8 : 16>(x, planes, sign, scale, active, out, ws,
                                                  counters, M, K, K8, N, n_bits, G, inv_denom,
                                                  n_split, rps, stream);
  return launch_splitk<T, MT, 4>(x, planes, sign, scale, active, out, ws, counters, M, K, K8, N,
                                 n_bits, G, inv_denom, n_split, rps, stream);
}

// ---------------------------------------------------------------- large M, SIMT
constexpr int kTileM = 64, kTileN = 64, kTileK = 64;  // kTileK / 8 byte-rows per chunk

template <typename T>
__global__ void __launch_bounds__(256)
tiled_kernel(const T* __restrict__ x, const uint8_t* __restrict__ planes,
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
int launch_tiled(const void* x, const void* planes, const void* sign, const void* scale,
                 const void* active, void* out, int M, int K, int K8, int N, int n_bits, int G,
                 float inv_denom, cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  tiled_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(planes),
      static_cast<const uint8_t*>(sign), static_cast<const float*>(scale),
      static_cast<const int*>(active), static_cast<T*>(out), M, K, K8, N, n_bits, G, inv_denom);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- large M, wgmma
namespace wg {

// The warp-specialised prefill tile of the note at the top.  A stage's
// "full" barrier counts the producers' arrivals and the TMA's bytes, its
// "empty" barrier the consumers' release once their products are done.
// Each consumer owns two m64n128 slabs, so one unpacked weight tile feeds
// 256 rows.  The unpacking sets the pace, so two producer warpgroups
// share it; setmaxnreg gives them 88 registers and the consumers, whose
// accumulators take 128 of theirs, 168.
constexpr int kProducers = 2, kConsumers = 2;
constexpr int kProducerThreads = kProducers * 128;
constexpr int kThreads = (kProducers + kConsumers) * 128;
constexpr int kBM = kConsumers * 128;      // output rows
constexpr int kBN = 128;                   // output columns; K steps of 64 rows (8 byte-rows)
constexpr int kStages = 4;                 // the ring of x tiles and bf16 weight tiles
constexpr int kGroupM = 8;                 // M tiles that walk the N tiles together
constexpr uint32_t kA = kBM * 128;         // x tile: kBM rows of 64 bf16, K-major
constexpr uint32_t kB = 2 * 64 * 128;      // weight tile: 2 blocks of 64 columns x 64 K rows
constexpr size_t kSmem = kStages * (kA + kB) + 2 * kStages * 8 + 1024;  // + barriers, align

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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
// at most N of this warpgroup's committed wgmma groups still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// mbarrier operations on a shared-memory address
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// an arrival that also announces `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// the box at (k, m) of the tensor map into shared memory, counted on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int k, int m,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(m), "r"(bar)
      : "memory");
}
// orders the compiler's use of the accumulators after the wait that
// completes the wgmma writing them
__device__ __forceinline__ void fence_regs(float (&r)[2][64]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[j][i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16, bf16, K-major in shared memory) . B
// (16 x 128, bf16, N-major in shared memory: transposed on the way in),
// both 128-byte swizzled
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, "
      "1, 1, 0, 1;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// One K step's packed words of a producer thread: byte-row kb of the step,
// columns 4 g .. 4 g + 3 of the tile; w[0..a-1] the live planes, w[8] the
// sign, zeros past K8 and N
struct Packed {
  uint32_t w[9];
};

__device__ __forceinline__ void load_packed(Packed& q, const uint8_t* live0, const uint8_t* sgn,
                                            size_t pstride, int N, int K8, int a, int row,
                                            bool live_col) {
  const bool ok = live_col && row < K8;
  const size_t off = (size_t)row * N;
#pragma unroll
  for (int b = 0; b < 8; ++b)
    q.w[b] = ok && b < a ? __ldg(reinterpret_cast<const unsigned int*>(live0 + b * pstride + off))
                         : 0u;
  q.w[8] = ok ? __ldg(reinterpret_cast<const unsigned int*>(sgn + off)) : 0u;
}

// The 4 columns x 8 K rows of q into the N-major bf16 weight tile at row:
// K row i at i * 128 bytes, the columns' 8 bytes in 16-byte chunk
// chunk ^ i (the 128-byte swizzle: K row 8 kb + i has i = its row % 8).
__device__ __forceinline__ void unpack_packed(const Packed& q, uint8_t* row, int chunk, int a) {
  uint32_t p[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) p[b] = q.w[b];
  const uint32_t s = q.w[8];
  if (a <= 7) {
    p[7] = s;  // the sign as bit 7 of every magnitude byte
    transpose8(p);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint2*>(row + i * 128 + ((chunk ^ i) << 4)) = weights_bf16_narrow(p[i]);
  } else {
    transpose8(p);
#define BSM_WIDE(I) \
  *reinterpret_cast<uint2*>(row + I * 128 + ((chunk ^ I) << 4)) = weights_bf16_wide<I>(p[I], s);
    BSM_WIDE(0) BSM_WIDE(1) BSM_WIDE(2) BSM_WIDE(3)
    BSM_WIDE(4) BSM_WIDE(5) BSM_WIDE(6) BSM_WIDE(7)
#undef BSM_WIDE
  }
}

__global__ void __launch_bounds__(kThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x, const uint8_t* __restrict__ planes,
             const uint8_t* __restrict__ sign, const float* __restrict__ scale,
             const int* __restrict__ active, __nv_bfloat16* __restrict__ out, int M, int K,
             int K8, int N, int n_bits, int G, float inv_denom) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sA = base;                    // [kStages] x tiles
  const uint32_t sB = sA + kStages * kA;       // [kStages] bf16 weight tiles
  const uint32_t full = sB + kStages * kB;     // [kStages] barriers: stage filled
  const uint32_t empty = full + kStages * 8;   // [kStages] barriers: stage free again
  unsigned char* gB = smem_raw + (sB - raw);   // generic pointer for the unpacking

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // groups of kGroupM M tiles walk the N tiles together
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const int group = blockIdx.x / (kGroupM * tiles_n);
  const int first_m = group * kGroupM;
  const int gm = min(tiles_m - first_m, kGroupM);
  const int in_group = blockIdx.x - group * kGroupM * tiles_n;
  const int m0 = (first_m + in_group % gm) * kBM, n0 = (in_group / gm) * kBN;
  const int lo = first_live_plane(active, n_bits);
  const int n_kt = (K8 + 7) / 8;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s * 8, kProducerThreads + 1);  // the producers and the TMA arrival
      mbar_init(empty + s * 8, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kProducerThreads) {
    // ---- producers: thread (kb, g) unpacks byte-row kb, columns 4 g .. 4 g + 3
    asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n");
    const int kb = tid / 32, g = tid % 32;
    const int a = n_bits - lo, col = n0 + g * 4;
    const size_t pstride = (size_t)K8 * N;
    const uint8_t* live0 = planes + (size_t)lo * pstride + col;  // the first live plane
    uint8_t* row = gB + (g / 16) * (64 * 128) + kb * 8 * 128 + (g % 2) * 8;
    Packed cur, nxt;
    load_packed(cur, live0, sign + col, pstride, N, K8, a, kb, col < N);
    for (int t = 0; t < n_kt; ++t) {
      const int s = t % kStages;
      if (t + 1 < n_kt)  // the next step's bytes fly while this one is unpacked
        load_packed(nxt, live0, sign + col, pstride, N, K8, a, (t + 1) * 8 + kb, col < N);
      mbar_wait(empty + s * 8, ((t / kStages) & 1) ^ 1);
      if (tid == 0) {
        mbar_arrive_tx(full + s * 8, kA);
        tma_load_2d(sA + s * kA, &tmap_x, t * 64, m0, full + s * 8);
      }
      unpack_packed(cur, row + s * kB, (g % 16) / 2, a);
      // generic-proxy writes, read by wgmma through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full + s * 8);
      cur = nxt;
    }
    return;
  }

  // ---- consumers: warpgroup c owns rows [128 c, 128 c + 128) of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 168;\n");
  const int c = warp / 4 - kProducers, wwarp = warp % 4;
  float acc[2][64];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
  for (int t = 0; t < n_kt; ++t) {
    const int s = t % kStages;
    mbar_wait(full + s * 8, (t / kStages) & 1);
    const uint32_t a_base = sA + s * kA + c * 128 * 128;
    const uint32_t b_base = sB + s * kB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 K rows each: 32 bytes along an A row, 16 B rows
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wgmma_n128(acc[j], make_desc(a_base + j * 64 * 128 + kk * 32, 16, 1024),
                   make_desc(b_base + kk * 16 * 128, 64 * 128, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // step t - 1's products are done: its stage is free
    if (t > 0 && tid % 128 == 0) mbar_arrive(empty + ((t - 1) % kStages) * 8);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // a thread holds two neighbouring columns of rows r and r + 8 in each
  // 8-column group of each of its slabs
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = m0 + c * 128 + j * 64 + wwarp * 16 + lane / 4;
#pragma unroll
    for (int q = 0; q < kBN / 8; ++q) {
      const int col = n0 + q * 8 + 2 * (lane % 4);
      if (col >= N) continue;  // N % 16 == 0: col + 1 < N too
      const float c0 = col_scale(scale, col, N, G, lo, inv_denom);
      const float c1 = col_scale(scale, col + 1, N, G, lo, inv_denom);
      if (r < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)r * N + col) =
            bf16x2_pack(acc[j][4 * q] * c0, acc[j][4 * q + 1] * c1);
      if (r + 8 < M)
        *reinterpret_cast<uint32_t*>(out + (size_t)(r + 8) * N + col) =
            bf16x2_pack(acc[j][4 * q + 2] * c0, acc[j][4 * q + 3] * c1);
    }
  }
}

// cuTensorMapEncodeTiled, from the driver at run time (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

int launch(const void* x, const void* planes, const void* sign, const void* scale,
           const void* active, void* out, int M, int K, int K8, int N, int n_bits, int G,
           float inv_denom, cudaStream_t stream) {
  static bool smem_opted_in = false;  // above 48 KB a kernel must opt in, once
  if (!smem_opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_opted_in = true;
  }
  // x (M, K) bf16 as a 2-D tensor map: boxes of 64 K x kBM rows, 128-byte
  // swizzled, zeros past M and K
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)kBM};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  wgmma_kernel<<<tiles, kThreads, kSmem, stream>>>(
      map, static_cast<const uint8_t*>(planes), static_cast<const uint8_t*>(sign),
      static_cast<const float*>(scale), static_cast<const int*>(active),
      static_cast<__nv_bfloat16*>(out), M, K, K8, N, n_bits, G, inv_denom);
  return (int)cudaGetLastError();
}

}  // namespace wg

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
int launch(const void* x, const void* planes, const void* sign, const void* scale,
           const void* active, void* out, void* ws, void* counters, int M, int K, int K8, int N,
           int n_bits, int G, float inv_denom, int n_split, int rps, cudaStream_t stream) {
  if (M <= 8) {
    // 16-byte loads where every column tile and plane starts 16-byte aligned
    const bool wide = N % 16 == 0 && aligned16(planes) && aligned16(sign);
    if (M <= 1)
      return launch_splitk_cv<T, 1>(wide, x, planes, sign, scale, active, out, ws, counters, M,
                                    K, K8, N, n_bits, G, inv_denom, n_split, rps, stream);
    if (M <= 2)
      return launch_splitk_cv<T, 2>(wide, x, planes, sign, scale, active, out, ws, counters, M,
                                    K, K8, N, n_bits, G, inv_denom, n_split, rps, stream);
    if (M <= 4)
      return launch_splitk_cv<T, 4>(wide, x, planes, sign, scale, active, out, ws, counters, M,
                                    K, K8, N, n_bits, G, inv_denom, n_split, rps, stream);
    return launch_splitk_cv<T, 8>(wide, x, planes, sign, scale, active, out, ws, counters, M,
                                  K, K8, N, n_bits, G, inv_denom, n_split, rps, stream);
  }
  return launch_tiled<T>(x, planes, sign, scale, active, out, M, K, K8, N, n_bits, G, inv_denom,
                         stream);
}

}  // namespace

// Which kernel a call of these operands takes: 0 = splitk_kernel (M <= 8),
// 1 = wgmma_kernel, 2 = tiled_kernel.
extern "C" int bitserial_matmul_path(int dtype, const void* x, const void* planes,
                                     const void* sign, int M, int K, int N) {
  if (M <= 8) return 0;
  if (dtype == 1 && K % 8 == 0 && N % 16 == 0 && aligned16(x) && aligned16(planes) &&
      aligned16(sign))
    return 1;
  return 2;
}

// dtype: 0 = float32, 1 = bfloat16.  `active` may be null (every plane).
// For M <= 8, (n_split, rows_per_split) is the wrapper's split plan, `ws`
// an f32 workspace of n_split * M * N elements (unused when n_split = 1)
// and `counters` one zeroed unsigned per column tile of 32 columns,
// reset by the kernel, never used by two calls at once.  Requires 1 <=
// n_bits <= 8, N % 4 == 0, 4-byte aligned planes/sign, and G dividing N.
// Returns the error of the launch (0 = none).
extern "C" int bitserial_matmul_launch(int dtype, const void* x, const void* planes,
                                       const void* sign, const void* scale, const void* active,
                                       void* out, void* ws, void* counters, int M, int K, int K8,
                                       int N, int n_bits, int denom_bits, int G, int n_split,
                                       int rows_per_split, void* stream) {
  // 1/denom rounded once to f32, as the Pallas epilogue's constant is
  const float inv_denom = (float)(1.0 / ((double)(1ull << denom_bits) - 1.0));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 8 && bitserial_matmul_path(dtype, x, planes, sign, M, K, N) == 1)
    return wg::launch(x, planes, sign, scale, active, out, M, K, K8, N, n_bits, G, inv_denom, s);
  if (dtype == 0)
    return launch<float>(x, planes, sign, scale, active, out, ws, counters, M, K, K8, N, n_bits,
                         G, inv_denom, n_split, rows_per_split, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, planes, sign, scale, active, out, ws, counters, M, K, K8, N,
                                 n_bits, G, inv_denom, n_split, rows_per_split, s);
  return (int)cudaErrorInvalidValue;
}
