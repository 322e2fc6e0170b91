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
// nothing is padded in device memory.
//
// What bounds it on an H100: the 1x1 convs of ResNet-50 at small K (64-256)
// have 16-64 flop per f32 byte and sit near the FP32 ridge (67 TFLOP/s over
// 3.35 TB/s, 20 flop/B), so reading A and writing C bound them; the larger-K
// layers are bound by the FFMA issue rate. This first kernel is the simple
// shared-memory tiled form (64x64 tiles, K chunks of 16, 4x4 micro-tile per
// thread): every operand element is read from device memory once per tile row
// or column, and each FFMA needs half a shared-memory load, which caps it well
// below the FP32 peak. TMA loads and wgmma (bf16 tensor cores) come later.
#include "gemm_tile.cuh"

namespace {

using boda::kBM;
using boda::kBN;
using boda::kThreads;

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    matmul_ext_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
                      const float* __restrict__ bias, TOut* __restrict__ C, int M,
                      int N, int K, int relu) {
  boda::gemm_tile<TOut>(boda::RowMajorLoader<TIn>{A, M, K},
                        boda::RowMajorLoader<TIn>{B, N, K},
                        bias, C, M, N, K, relu);
}

template <typename TIn, typename TOut>
void launch(const void* A, const void* B, const void* bias, void* C, int M, int N,
            int K, int relu, cudaStream_t stream) {
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  matmul_ext_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(A), static_cast<const TIn*>(B),
      static_cast<const float*>(bias), static_cast<TOut*>(C), M, N, K, relu);
}

}  // namespace

// A, B: f32 or bf16 (in_bf16), both the same type. bias: f32 [N] or null.
// C: f32 or bf16 (out_bf16). Returns cudaGetLastError() after the launch.
extern "C" int boda_matmul_ext(const void* A, const void* B, const void* bias, void* C,
                               int M, int N, int K, int in_bf16, int out_bf16, int relu,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    if (out_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(A, B, bias, C, M, N, K, relu, s);
    else
      launch<__nv_bfloat16, float>(A, B, bias, C, M, N, K, relu, s);
  } else {
    if (out_bf16)
      launch<float, __nv_bfloat16>(A, B, bias, C, M, N, K, relu, s);
    else
      launch<float, float>(A, B, bias, C, M, N, K, relu, s);
  }
  return static_cast<int>(cudaGetLastError());
}
