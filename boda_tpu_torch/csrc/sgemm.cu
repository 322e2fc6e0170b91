// matmul_ext: C[M,N] = epilogue(A[M,K] . B[N,K]^T), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of boda_tpu/ops/pallas/sgemm.py: build_matmul_ext
// and its bodies _matmul_kernel, _matmul_bias_kernel and _matmul_relu_kernel.
// Same function: f32 accumulation over K, epilogue of optional +bias[N] in f32,
// optional ReLU, one rounding to the output type. f32 inputs multiply in full
// FP32 (FFMA, never TF32), the port of _dot_precision's Precision.HIGHEST.
//
// B is taken in the filter's natural (N, K) row-major form (a conv filter
// (out_chan, in_chan*ky*kx) as stored), so no transposed copy is made per call.
// Ragged M, N and K are masked inside the kernel; unlike the Pallas version
// nothing is padded in device memory. Every offset into A, B, C and the
// workspace is 64-bit, so M*K, N*K and M*N may pass 2^31.
//
// Both routes run on the GEMM core of hopper_gemm.cuh, the one tconv (B2)
// runs on, with a row-major operand loader in place of tconv's conv window:
//  - bf16 on the tensor cores: 128 x BN block tiles, K in chunks of 64
//    staged by cp.async through 3 swizzled shared-memory stages, two
//    warpgroups each issuing wgmma m64nBNk16 from shared memory. Where K % 8
//    != 0 (a row is not a whole number of 16-byte chunks) or an operand is
//    not 16-byte aligned, a compile-time variant stages element by element.
//  - f32 on FFMA: 128 x BN tiles, 8 x (BN / 16) float4 micro-tiles, K chunks
//    of 8 double-buffered through registers, quad loads where K % 4 == 0.
// BN is 128, or 64 where that wastes fewer columns (N = 64: the res2 1x1s
// and every im2col conv of ResNet-50). The planner (ops/cuda/sgemm.py
// matmul_plan) picks BN by N and splits K over grid.z where the grid is
// small: each split writes f32 partial sums to a workspace and the core's
// split_reduce adds them in split order, then bias, ReLU and the rounding.
//
// What bounds each ResNet-50 case on an H100 SXM (989 TF/s bf16 dense, 67
// TF/s FP32, 3.35 TB/s), and what the design does about it:
//  - res2a 1x1 at b32 (M = 100352, K = N = 64): 16 flop per byte of A and C
//    in f32 and 32 in bf16, under the ridges (20 and 295 flop/B): the bytes
//    bound it (51 MB in f32, 15.3 us; 25.7 MB in bf16, 7.7 us). The 64-wide tile
//    reads every A row once; C leaves in float4 (FFMA) or pair (wgmma) stores.
//  - the res2 3x3 im2col at b32 (K = 576, N = 64): 7.40 GFLOP. In f32 the
//    FFMA rate bounds it (0.110 ms at the FP32 peak); the 128 x 64 tile wastes
//    no column, where a 128-wide one would double the FFMA work. In bf16 the
//    bytes bound it (128 MB, 38 us against 7.5 us of tensor-core work).
//  - fc1000 (K = 2048, N = 1000) at M = 1 and 32: the 8 MB f32 (4 MB bf16)
//    filter must be read once, 2.5 us (1.2 us), and 8 output tiles would
//    leave 124 of 132 SMs idle: split-K spreads the filter's reads over the
//    card. The FFMA route's warps whose rows all lie past M skip their
//    products, so a 128-row tile at M = 1 costs one warp's FFMA, not eight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using namespace boda::hopper;

constexpr int kBK16 = kRowBytes / 2;  // bf16 K chunk

struct Gemm {
  int M, N, K;
  int chunks_per_split;
};

template <typename TOut, int BN, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    matmul_wgmma(const uint16_t* __restrict__ A, const uint16_t* __restrict__ B,
                 const float* __restrict__ bias, TOut* __restrict__ C, float* __restrict__ ws,
                 Gemm g, int relu) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int m0 = blockIdx.x * kTileM;
  const int n0 = blockIdx.y * BN;
  int kc0, kc1;
  split_range((g.K + kBK16 - 1) / kBK16, g.chunks_per_split, kc0, kc1);
  using R = Ring<BN>;
  float acc[BN / 2];
  ring_product<BN>(
      smem, kc0, kc1 - kc0,
      [&](int st, int kc) {
        stage_rows<kTileM, kVec>(A, g.M, g.K, m0, kc, smem_addr(R::a(smem, st)), R::a(smem, st));
        stage_rows<BN, kVec>(B, g.N, g.K, n0, kc, smem_addr(R::b(smem, st)), R::b(smem, st));
      },
      acc);
  for_pairs(acc, [&](int r, int c, float v0, float v1) {
    store_pair(g.M, g.N, m0 + r, n0 + c, v0, v1, bias, C, ws, relu);
  });
}

// v[0..3] = X[row, k .. k+3] of a row-major [rows, K] f32 matrix, zero outside.
// kVec: one 16-byte load (K % 4 == 0, X 16-byte aligned).
template <bool kVec>
__device__ __forceinline__ void quad(const float* __restrict__ X, int rows, int K, int row, int k,
                                     float (&v)[4]) {
  if constexpr (kVec) {
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows && k < K) q = *reinterpret_cast<const float4*>(X + (size_t)row * K + k);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (row < rows && k + e < K) ? X[(size_t)row * K + k + e] : 0.f;
  }
}

template <typename TOut, int BN, bool kVec>
__global__ void __launch_bounds__(kThreads)
    matmul_ffma(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ bias, TOut* __restrict__ C, float* __restrict__ ws,
                Gemm g, int relu) {
  const int m0 = blockIdx.x * kTileM;
  const int n0 = blockIdx.y * BN;
  int kc0, kc1;
  split_range((g.K + kBK32 - 1) / kBK32, g.chunks_per_split, kc0, kc1);
  float acc[8][BN / 16];
  ffma_product<BN, true>(
      kc0, kc1 - kc0, g.M - m0,
      [&](int r, int k, float (&a)[4], float (&b)[4], bool want_b) {
        quad<kVec>(A, g.M, g.K, m0 + r, k, a);
        if (want_b) quad<kVec>(B, g.N, g.K, n0 + r, k, b);
      },
      acc);
  for_quads<BN>(acc, [&](int r, int c, const float (&v)[4]) {
    store_pair(g.M, g.N, m0 + r, n0 + c, v[0], v[1], bias, C, ws, relu);
    store_pair(g.M, g.N, m0 + r, n0 + c + 2, v[2], v[3], bias, C, ws, relu);
  });
}

template <typename TIn, typename TOut, int BN, bool kVec>
cudaError_t launch(const void* A, const void* B, const float* bias, TOut* C, float* ws,
                   const Gemm& g, int splits, int relu, cudaStream_t stream) {
  const dim3 grid((g.M + kTileM - 1) / kTileM, (g.N + BN - 1) / BN, splits);
  if constexpr (sizeof(TIn) == 2) {
    static bool smem_set = false;  // per instantiation
    const cudaError_t e = allow_smem(matmul_wgmma<TOut, BN, kVec>, Ring<BN>::kSmem, smem_set);
    if (e != cudaSuccess) return e;
    matmul_wgmma<TOut, BN, kVec><<<grid, kThreads, Ring<BN>::kSmem, stream>>>(
        static_cast<const uint16_t*>(A), static_cast<const uint16_t*>(B), bias, C, ws, g, relu);
  } else {
    matmul_ffma<TOut, BN, kVec><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(A), static_cast<const float*>(B), bias, C, ws, g, relu);
  }
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
int run(const void* A, const void* B, const void* bias, void* C, void* ws, const Gemm& g,
        int tile_n, int splits, int vec, int relu, cudaStream_t stream) {
  const float* b = static_cast<const float*>(bias);
  TOut* c = static_cast<TOut*>(C);
  float* w = splits > 1 ? static_cast<float*>(ws) : nullptr;
  cudaError_t e;
  if (tile_n == 64)
    e = vec ? launch<TIn, TOut, 64, true>(A, B, b, c, w, g, splits, relu, stream)
            : launch<TIn, TOut, 64, false>(A, B, b, c, w, g, splits, relu, stream);
  else
    e = vec ? launch<TIn, TOut, 128, true>(A, B, b, c, w, g, splits, relu, stream)
            : launch<TIn, TOut, 128, false>(A, B, b, c, w, g, splits, relu, stream);
  if (e == cudaSuccess && splits > 1)
    e = launch_split_reduce<TOut>(w, b, c, (size_t)g.M * g.N, g.N, splits, relu, stream);
  return static_cast<int>(e);
}

}  // namespace

// A, B: f32 or bf16 (in_bf16), both the same type. bias: f32 [N] or null.
// C: f32 or bf16 (out_bf16). The plan of ops/cuda/sgemm.py matmul_plan:
// tile_n (64 or 128), splits (K split count; when > 1, ws is an f32
// workspace of splits * M * N elements), vec (16-byte operand loads: K % 8
// == 0 for bf16, K % 4 == 0 for f32, A and B 16-byte aligned). Returns the
// launches' cudaGetLastError().
extern "C" int boda_matmul_ext(const void* A, const void* B, const void* bias, void* C,
                               int M, int N, int K, int in_bf16, int out_bf16, int relu,
                               void* ws, int tile_n, int splits, int vec, void* stream) {
  if (tile_n != 64 && tile_n != 128) return static_cast<int>(cudaErrorInvalidValue);
  Gemm g;
  g.M = M;
  g.N = N;
  g.K = K;
  const int chunks = (K + (in_bf16 ? kBK16 : kBK32) - 1) / (in_bf16 ? kBK16 : kBK32);
  g.chunks_per_split = (chunks + splits - 1) / splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16 ? run<__nv_bfloat16, __nv_bfloat16>(A, B, bias, C, ws, g, tile_n, splits,
                                                        vec, relu, s)
                    : run<__nv_bfloat16, float>(A, B, bias, C, ws, g, tile_n, splits, vec,
                                                relu, s);
  return out_bf16
             ? run<float, __nv_bfloat16>(A, B, bias, C, ws, g, tile_n, splits, vec, relu, s)
             : run<float, float>(A, B, bias, C, ws, g, tile_n, splits, vec, relu, s);
}
