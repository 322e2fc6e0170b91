// Shared block-tile GEMM core of the hand-written Hopper kernels
// (sgemm.cu: matmul_ext, tconv.cu: tconv).
//
// One thread block computes a BM x BN tile of C[M,N] = epilogue(sum_k A[m,k] * B[n,k])
// with 256 threads, each owning a TM x TN register micro-tile whose rows and
// columns are strided by 16 (so a warp's shared-memory reads are broadcasts
// for A and consecutive words for B). K advances in BK chunks staged through
// shared memory in f32; the products are plain FFMA in full FP32 (no tensor
// cores, hence no TF32), accumulated in registers in f32.
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

// Epilogue: + bias[n] in f32 (bias may be null), then ReLU if relu != 0,
// then one rounding to TOut at the store. C is row-major [M, N].
template <typename TOut, typename LoadA, typename LoadB>
__device__ __forceinline__ void gemm_tile(const LoadA& load_a, const LoadB& load_b,
                                          const float* __restrict__ bias,
                                          TOut* __restrict__ C, int M, int N, int K,
                                          int relu) {
  __shared__ float As[kBK][kBM + kSmemPad];
  __shared__ float Bs[kBK][kBN + kSmemPad];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  // loader mapping: each thread stages 4 consecutive k of one tile row
  const int lrow = tid / 4;
  const int lk = (tid % 4) * 4;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    float av[4], bv[4];
    load_a(m0 + lrow, k0 + lk, av);
    load_b(n0 + lrow, k0 + lk, bv);
    __syncthreads();  // the previous chunk's reads are done
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      As[lk + j][lrow] = av[j];
      Bs[lk + j][lrow] = bv[j];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[n];
      if (relu && v < 0.f) v = 0.f;
      C[(size_t)m * N + n] = from_f32<TOut>(v);
    }
  }
}

}  // namespace boda
