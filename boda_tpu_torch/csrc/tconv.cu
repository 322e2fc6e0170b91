// tconv: stride-1 direct convolution as an implicit GEMM, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of boda_tpu/ops/pallas/tconv.py: build_tconv and its
// body `kern`, which DMAs a haloed NHWC row band into VMEM and accumulates the
// ky*kx taps as (TY*ox x C).(C x OCb) MXU dots in f32, then adds bias and ReLU.
//
// Here the same sum is one GEMM with M = n*oy*ox output pixels, N = oc and
// K = ky*kx*C, in that K order (tap-major, channel-minor), so the four
// consecutive k a thread loads are four consecutive channels of one NHWC pixel.
// The im2col matrix never exists: the A loader computes each pixel's input
// coordinate, and conv padding is a masked load (zero outside the image), so
// no padded copy of x is made. The filter is read in its natural OIHW form
// (B[n, k] at n*K + c*ky*kx + tap), strided but small and L2-resident.
// Epilogue: + bias[oc] in f32, optional ReLU, one rounding; the output is
// NHWC [n, oy, ox, oc], which is exactly row-major C[M, N].
//
// What bounds it on an H100: ResNet-50's 3x3 layers (C = oc = 128..512) carry
// 2*9*C flop per output element and are compute-bound; this first kernel runs
// them on FFMA (full FP32 for f32, bf16 operands widened to f32 for bf16), at
// the issue rate the shared 64x64x16 tile core allows. Each input pixel is
// re-read from L1/L2 once per tap that covers it. A TMA halo load into shared
// memory and wgmma on bf16 come later.
#include "gemm_tile.cuh"

namespace {

using boda::kBM;
using boda::kBN;
using boda::kThreads;

struct ConvShape {
  int M, K;           // GEMM rows (n*oy*ox) and depth (ky*kx*C)
  int H, W, C;        // input NHWC extents (batch implied by M)
  int oy, ox;         // output extents
  int ky, kx, py, px; // filter extents and padding
};

// A[m, k] of the implicit im2col: x NHWC, k = (yy*kx + xx)*C + c.
template <typename TIn>
struct Im2colLoader {
  const TIn* __restrict__ x;
  ConvShape s;
  __device__ __forceinline__ void operator()(int m, int k, float v[4]) const {
    if (m >= s.M) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = 0.f;
      return;
    }
    const int img = m / (s.oy * s.ox);
    const int rem = m - img * (s.oy * s.ox);
    const int oyy = rem / s.ox;
    const int oxx = rem - oyy * s.ox;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k + j;
      float val = 0.f;
      if (kk < s.K) {
        const int tap = kk / s.C;
        const int c = kk - tap * s.C;
        const int yy = tap / s.kx;
        const int xx = tap - yy * s.kx;
        const int iy = oyy + yy - s.py;
        const int ix = oxx + xx - s.px;
        if (iy >= 0 && iy < s.H && ix >= 0 && ix < s.W)
          val = boda::to_f32(x[(((size_t)img * s.H + iy) * s.W + ix) * s.C + c]);
      }
      v[j] = val;
    }
  }
};

// B[n, k] read from the OIHW filter w[oc, C, ky, kx], k = tap*C + c.
template <typename TIn>
struct OihwLoader {
  const TIn* __restrict__ w;
  int N, K, C, taps;
  __device__ __forceinline__ void operator()(int n, int k, float v[4]) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k + j;
      float val = 0.f;
      if (n < N && kk < K) {
        const int tap = kk / C;
        const int c = kk - tap * C;
        val = boda::to_f32(w[(size_t)n * K + (size_t)c * taps + tap]);
      }
      v[j] = val;
    }
  }
};

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    tconv_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w,
                 const float* __restrict__ bias, TOut* __restrict__ out, ConvShape s,
                 int oc, int relu) {
  boda::gemm_tile<TOut>(Im2colLoader<TIn>{x, s},
                        OihwLoader<TIn>{w, oc, s.K, s.C, s.ky * s.kx}, bias, out, s.M,
                        oc, s.K, relu);
}

template <typename TIn, typename TOut>
void launch(const void* x, const void* w, const void* bias, void* out, ConvShape s,
            int oc, int relu, cudaStream_t stream) {
  dim3 grid((s.M + kBM - 1) / kBM, (oc + kBN - 1) / kBN);
  tconv_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const TIn*>(w),
      static_cast<const float*>(bias), static_cast<TOut*>(out), s, oc, relu);
}

}  // namespace

// x: NHWC [n, H, W, C]; w: OIHW [oc, C, ky, kx], both f32 or bf16 (in_bf16).
// bias: f32 [oc] or null. out: NHWC [n, oy, ox, oc], f32 or bf16 (out_bf16),
// with oy = H + 2*py - ky + 1 and ox = W + 2*px - kx + 1 (stride 1).
// Returns cudaGetLastError() after the launch.
extern "C" int boda_tconv(const void* x, const void* w, const void* bias, void* out,
                          int n, int H, int W, int C, int oc, int ky, int kx, int py,
                          int px, int in_bf16, int out_bf16, int relu, void* stream) {
  ConvShape s;
  s.H = H;
  s.W = W;
  s.C = C;
  s.ky = ky;
  s.kx = kx;
  s.py = py;
  s.px = px;
  s.oy = H + 2 * py - ky + 1;
  s.ox = W + 2 * px - kx + 1;
  s.M = n * s.oy * s.ox;
  s.K = ky * kx * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    if (out_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(x, w, bias, out, s, oc, relu, st);
    else
      launch<__nv_bfloat16, float>(x, w, bias, out, s, oc, relu, st);
  } else {
    if (out_bf16)
      launch<float, __nv_bfloat16>(x, w, bias, out, s, oc, relu, st);
    else
      launch<float, float>(x, w, bias, out, s, oc, relu, st);
  }
  return static_cast<int>(cudaGetLastError());
}
