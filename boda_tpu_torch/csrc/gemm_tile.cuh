// The FFMA block-tile GEMM core of the fused kernels (resblock.cu:
// resblock; stem.cu and the Hopper GEMM core hopper_gemm.cuh take its
// to_f32 / from_f32 conversions).
//
// tile_product: the 256 threads of a block compute a BM x BN tile of
// sum_k A[m,k] * B[n,k], each thread owning a TM x TN register micro-tile whose
// rows and columns are strided across the threads (so a warp's shared-memory
// reads are broadcasts for A and consecutive words for B). K advances in BK chunks staged
// through shared memory in f32; the products are plain FFMA in full FP32 (no
// tensor cores, hence no TF32), accumulated in registers in f32.
// The tile is 64 x 64, or 16 x 256 for products with few rows.
//
// The caller supplies two loaders, load_a(m, k, v) and load_b(n, k, v), that
// each fill v[0..3] with the operand values at (row, k .. k+3) converted to
// f32 and zero where the row or k lies outside the matrix: ragged M, N and K
// edges are masked here, so no operand is padded in device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace boda {

constexpr int kBM = 64;       // tile rows (M)
constexpr int kBN = 64;       // tile cols (N)
constexpr int kBK = 16;       // K chunk staged in shared memory
constexpr int kTM = 4;        // micro-tile rows per thread
constexpr int kTN = 4;        // micro-tile cols per thread
constexpr int kThreads = 256;
constexpr int kSmemPad = 4;   // keeps the transposed stores off one bank

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v[0..3] = p[0..3] in f32, read with one 16-byte (f32) or 8-byte (bf16) load
// where p is aligned for it, else element by element. One wide load matters
// where a kernel's shared memory leaves little L1 to catch the narrow ones.
template <typename T>
__device__ __forceinline__ void load_quad(const T* p, float v[4]) {
  if (reinterpret_cast<size_t>(p) % (4 * sizeof(T)) == 0) {
    if constexpr (sizeof(T) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
      const float2 lo = __bfloat1622float2(q[0]);
      const float2 hi = __bfloat1622float2(q[1]);
      v[0] = lo.x;
      v[1] = lo.y;
      v[2] = hi.x;
      v[3] = hi.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = to_f32(p[j]);
  }
}

// Rows of a row-major [rows, K] matrix, four consecutive k per call.
template <typename TIn>
struct RowMajorLoader {
  const TIn* __restrict__ X;
  int rows;
  int K;
  __device__ __forceinline__ void operator()(int r, int k, float v[4]) const {
    if (r < rows && k + 3 < K) {
      load_quad(X + (size_t)r * K + k, v);
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = (r < rows && k + j < K) ? to_f32(X[(size_t)r * K + k + j]) : 0.f;
  }
};

// A BM x BN tile shape of the core, with BM * BN = 64 * 64 so that each of the
// 256 threads owns a 4 x 4 micro-tile: 64 x 64 (the default) or 16 x 256 (for
// products with few rows and many columns). Thread t owns rows ty + kThrRows*i
// and columns tx + kThrCols*j, ty = t / kThrCols, tx = t % kThrCols.
template <int BM>
struct Tile {
  static constexpr int kCols = kBM * kBN / BM;
  static constexpr int kThrRows = BM / kTM;
  static constexpr int kThrCols = kThreads / kThrRows;
  // quads (4 consecutive k of one row) each thread stages per K chunk, and
  // whether the threads' last round of them runs past the tile
  static constexpr int kQuadsA = (BM * kBK / 4 + kThreads - 1) / kThreads;
  static constexpr int kQuadsB = (kCols * kBK / 4 + kThreads - 1) / kThreads;
  static constexpr bool kRaggedA = kQuadsA * kThreads != BM * kBK / 4;
  static constexpr bool kRaggedB = kQuadsB * kThreads != kCols * kBK / 4;
  static_assert(kThrRows * kTM == BM && kThrCols * kTN == kCols, "tile shape");
  // the K-chunk staging buffers of tile_product
  struct Smem {
    float As[kBK][BM + kSmemPad];
    float Bs[kBK][kCols + kSmemPad];
  };
};

// acc[i][j] = sum over k < K of A[m0 + ty + kThrRows*i, k] *
// B[n0 + tx + kThrCols*j, k] (see Tile). Every thread of the block must call
// it: it synchronises the block around each chunk.
template <int BM, typename LoadA, typename LoadB>
__device__ __forceinline__ void tile_product(const LoadA& load_a, const LoadB& load_b,
                                             int m0, int n0, int K,
                                             typename Tile<BM>::Smem& sm,
                                             float (&acc)[kTM][kTN]) {
  using T = Tile<BM>;
  const int tid = threadIdx.x;
  const int tx = tid % T::kThrCols;
  const int ty = tid / T::kThrCols;

#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // quad q stages row q / 4, k0 + (q % 4) * 4 .. + 3
    float av[T::kQuadsA][4], bv[T::kQuadsB][4];
#pragma unroll
    for (int l = 0; l < T::kQuadsA; ++l) {
      const int q = tid + l * kThreads;
      if (!T::kRaggedA || q < BM * 4) load_a(m0 + q / 4, k0 + (q % 4) * 4, av[l]);
    }
#pragma unroll
    for (int l = 0; l < T::kQuadsB; ++l) {
      const int q = tid + l * kThreads;
      if (!T::kRaggedB || q < T::kCols * 4) load_b(n0 + q / 4, k0 + (q % 4) * 4, bv[l]);
    }
    __syncthreads();  // the previous chunk's reads are done
#pragma unroll
    for (int l = 0; l < T::kQuadsA; ++l) {
      const int q = tid + l * kThreads;
      if (!T::kRaggedA || q < BM * 4)
#pragma unroll
        for (int j = 0; j < 4; ++j) sm.As[(q % 4) * 4 + j][q / 4] = av[l][j];
    }
#pragma unroll
    for (int l = 0; l < T::kQuadsB; ++l) {
      const int q = tid + l * kThreads;
      if (!T::kRaggedB || q < T::kCols * 4)
#pragma unroll
        for (int j = 0; j < 4; ++j) sm.Bs[(q % 4) * 4 + j][q / 4] = bv[l][j];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = sm.As[kk][ty + T::kThrRows * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = sm.Bs[kk][tx + T::kThrCols * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Calls f(m, n, acc[i][j]) for each element of this thread's micro-tile of the
// BM-row tile at (m0, n0); f masks the ragged edge itself.
template <int BM, typename F>
__device__ __forceinline__ void for_tile(int m0, int n0, const float (&acc)[kTM][kTN],
                                         const F& f) {
  using T = Tile<BM>;
  const int tx = threadIdx.x % T::kThrCols;
  const int ty = threadIdx.x / T::kThrCols;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      f(m0 + ty + T::kThrRows * i, n0 + tx + T::kThrCols * j, acc[i][j]);
}

}  // namespace boda
