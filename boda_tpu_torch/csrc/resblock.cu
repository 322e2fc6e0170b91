// resblock: the fused identity bottleneck of ResNet, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of boda_tpu/ops/pallas/resblock.py:31, build_resblock
// and its body `kern` (:98-135), which DMAs a haloed NHWC row band into VMEM
// and runs the whole block there. Same function and the same roundings (those
// of the kernel body, not of its `fallback`):
//   h1 = relu(x . W1^T + b1), zero outside the image, stored in the compute type;
//   h2 = relu(conv3x3(h1) + b2), accumulated in f32, stored in the compute type;
//   y  = h2 . W3^T + b3 + x, ReLU if relu_out, one rounding to the output type.
// x, the weights and the biases all arrive in the compute type (f32 or bf16).
// Every product accumulates in f32 on FFMA, in full FP32 (never TF32).
//
// How the activations stay out of device memory: one block owns one image and
// a band of `ty` output rows. Phase 1 computes h1 over the band's (ty+2) x (W+2)
// haloed window into shared memory; its ring outside the image is the 3x3's
// zero padding. Phase 2 computes h2 over ty x W x Cm into shared memory, its
// im2col operand read straight from h1 and its filter taken in OHWI order, so
// that both operands' K runs are contiguous. Phase 3 streams W3 tile by tile and
// writes the band's output rows. h1 and h2 never reach device memory. x is read
// in phase 1 (with the two halo rows) and again for the shortcut in phase 3,
// shortly after, from L2. Each phase runs the FFMA tile core of gemm_tile.cuh
// over its (pixels x channels) product, in 64 x 64 tiles, or in 16 x 256 tiles
// where a band holds few pixels (res4, res5).
//
// What bounds it on an H100: a bottleneck carries 2*(2*C*Cm + 9*Cm^2) flop per
// pixel (about 14 GFLOP per ResNet-50 block at batch 32) against one read of x
// and one write of y, so the FFMA issue rate bounds it, plus the work the
// banding adds: phase 1 runs over (ty+2)*(W+2) pixels for ty*W outputs, and a
// band's pixel count is padded to whole tiles. Every block reads all three
// weight matrices from L2 (W2 at res5 is 9.4 MB in f32), so at res5, where a
// band holds 7 pixels, L2 traffic rivals the FFMA time; the operand loads are
// 16-byte (8 for bf16) wherever aligned, since h1 and h2 leave little L1. Shared memory bounds
// ty: the wrapper (ops/cuda/resblock.py, resblock_plan) picks the ty and the
// tile shape with the least tile work per SM while two blocks fit in one SM's
// shared memory. wgmma on bf16 and TMA loads come later.
#include "gemm_tile.cuh"

namespace {

using boda::kThreads;
using boda::kTM;
using boda::kTN;

struct BlockShape {
  int H, W, C, Cm;  // image rows and cols, block channels, bottleneck channels
  int ty;           // output rows per band
  int nbands;       // bands per image: ceil(H / ty)
  int wp;           // haloed band width: W + 2
};

// h1 and h2 of one block, in elements of the compute type.
size_t smem_elems(const BlockShape& s) {
  return ((size_t)(s.ty + 2) * s.wp + (size_t)s.ty * s.W) * s.Cm;
}

// Phase 1's A[m, k] = x[img, y0 - 1 + r, c - 1, k] with m = r*wp + c: the
// haloed band, zero outside the image.
template <typename T>
struct HaloLoader {
  const T* __restrict__ x;
  BlockShape s;
  int img, y0, rows;
  __device__ __forceinline__ void operator()(int m, int k, float v[4]) const {
    int iy = -1, ix = -1;
    if (m < rows) {
      const int r = m / s.wp;
      iy = y0 - 1 + r;
      ix = m - r * s.wp - 1;
    }
    const bool in = iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
    const T* px = x + (((size_t)img * s.H + (in ? iy : 0)) * s.W + (in ? ix : 0)) * s.C;
    if (in && k + 3 < s.C) {
      boda::load_quad(px + k, v);
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (in && k + j < s.C) ? boda::to_f32(px[k + j]) : 0.f;
  }
};

// Phase 2's A[m, k] = h1[ty + yy, xo + xx, c] with m = ty*W + xo and
// k = (yy*3 + xx)*Cm + c: the 3x3's im2col, read from h1 in shared memory.
template <typename T>
struct H1Im2colLoader {
  const T* __restrict__ h1;
  int W, wp, Cm, rows;
  __device__ __forceinline__ void operator()(int m, int k, float v[4]) const {
    const int tyy = m / W;
    const int xo = m - tyy * W;
    const int tap = k / Cm;
    const int c = k - tap * Cm;
    if (m < rows && tap < 9 && c + 3 < Cm) {  // four channels of one tap
      const int yy = tap / 3;
      boda::load_quad(h1 + ((size_t)(tyy + yy) * wp + xo + tap - 3 * yy) * Cm + c, v);
      return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k + j;
      float val = 0.f;
      if (m < rows && kk < 9 * Cm) {
        const int tap = kk / Cm;
        const int c = kk - tap * Cm;
        const int yy = tap / 3;
        const int xx = tap - 3 * yy;
        val = boda::to_f32(h1[((size_t)(tyy + yy) * wp + xo + xx) * Cm + c]);
      }
      v[j] = val;
    }
  }
};

template <typename T, typename TOut, int BM>
__global__ void __launch_bounds__(kThreads)
    resblock_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                    const T* __restrict__ b1, const T* __restrict__ w2,
                    const T* __restrict__ b2, const T* __restrict__ w3,
                    const T* __restrict__ b3, TOut* __restrict__ out, BlockShape s,
                    int relu_out) {
  using Tile = boda::Tile<BM>;
  __shared__ typename Tile::Smem sm;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  T* h1 = reinterpret_cast<T*>(dyn_smem);             // [(ty+2)*wp, Cm]
  T* h2 = h1 + (size_t)(s.ty + 2) * s.wp * s.Cm;      // [ty*W, Cm]
  const int img = blockIdx.x / s.nbands;
  const int y0 = (blockIdx.x - img * s.nbands) * s.ty;
  const int rows1 = (s.ty + 2) * s.wp;
  const int rows2 = s.ty * s.W;
  float acc[kTM][kTN];

  // phase 1: h1 = relu(x . W1^T + b1) over the haloed band, zero outside the image
  const HaloLoader<T> ld_x{x, s, img, y0, rows1};
  const boda::RowMajorLoader<T> ld_w1{w1, s.Cm, s.C};
  for (int m0 = 0; m0 < rows1; m0 += BM)
    for (int n0 = 0; n0 < s.Cm; n0 += Tile::kCols) {
      boda::tile_product<BM>(ld_x, ld_w1, m0, n0, s.C, sm, acc);
      boda::for_tile<BM>(m0, n0, acc, [&](int m, int n, float v) {
        if (m >= rows1 || n >= s.Cm) return;
        const int r = m / s.wp;
        const int iy = y0 - 1 + r;
        const int ix = m - r * s.wp - 1;
        const bool in = iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
        const float h = in ? fmaxf(v + boda::to_f32(b1[n]), 0.f) : 0.f;
        h1[(size_t)m * s.Cm + n] = boda::from_f32<T>(h);
      });
    }
  __syncthreads();  // h1 complete

  // phase 2: h2 = relu(conv3x3(h1) + b2) over the band's ty x W pixels
  const H1Im2colLoader<T> ld_h1{h1, s.W, s.wp, s.Cm, rows2};
  const boda::RowMajorLoader<T> ld_w2{w2, s.Cm, 9 * s.Cm};
  for (int m0 = 0; m0 < rows2; m0 += BM)
    for (int n0 = 0; n0 < s.Cm; n0 += Tile::kCols) {
      boda::tile_product<BM>(ld_h1, ld_w2, m0, n0, 9 * s.Cm, sm, acc);
      boda::for_tile<BM>(m0, n0, acc, [&](int m, int n, float v) {
        if (m >= rows2 || n >= s.Cm) return;
        h2[(size_t)m * s.Cm + n] = boda::from_f32<T>(fmaxf(v + boda::to_f32(b2[n]), 0.f));
      });
    }
  __syncthreads();  // h2 complete

  // phase 3: y = h2 . W3^T + b3 + x, ReLU, one rounding; rows past H are dropped
  const boda::RowMajorLoader<T> ld_h2{h2, rows2, s.Cm};
  const boda::RowMajorLoader<T> ld_w3{w3, s.C, s.Cm};
  for (int m0 = 0; m0 < rows2; m0 += BM)
    for (int n0 = 0; n0 < s.C; n0 += Tile::kCols) {
      boda::tile_product<BM>(ld_h2, ld_w3, m0, n0, s.Cm, sm, acc);
      boda::for_tile<BM>(m0, n0, acc, [&](int m, int n, float v) {
        if (m >= rows2 || n >= s.C) return;
        const int tyy = m / s.W;
        const int oy = y0 + tyy;
        if (oy >= s.H) return;
        const size_t o = (((size_t)img * s.H + oy) * s.W + (m - tyy * s.W)) * s.C + n;
        float y = v + boda::to_f32(b3[n]) + boda::to_f32(x[o]);
        if (relu_out) y = fmaxf(y, 0.f);
        out[o] = boda::from_f32<TOut>(y);
      });
    }
}

template <typename T, typename TOut, int BM>
cudaError_t launch_bm(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, const void* w3, const void* b3, void* out, int n,
                      BlockShape s, int relu_out, cudaStream_t stream) {
  const size_t smem = smem_elems(s) * sizeof(T);
  auto kern = resblock_kernel<T, TOut, BM>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<n * s.nbands, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<const T*>(w3),
      static_cast<const T*>(b3), static_cast<TOut*>(out), s, relu_out);
  return cudaGetLastError();
}

template <typename T, typename TOut>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* w3, const void* b3, void* out, int n,
                   BlockShape s, int bm, int relu_out, cudaStream_t stream) {
  if (bm == 16)
    return launch_bm<T, TOut, 16>(x, w1, b1, w2, b2, w3, b3, out, n, s, relu_out, stream);
  if (bm == 64)
    return launch_bm<T, TOut, 64>(x, w1, b1, w2, b2, w3, b3, out, n, s, relu_out, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: NHWC [n, H, W, C]; w1: [Cm, C]; b1: [Cm]; w2: OHWI [Cm, 3, 3, Cm], the 3x3
// filter with its input channels innermost; b2: [Cm]; w3: [C, Cm]; b3: [C]; all
// of one type, f32 or bf16 (in_bf16). out: NHWC
// [n, H, W, C], f32 or bf16 (out_bf16). ty: output rows per block, 1..H; the
// block's dynamic shared memory is ((ty+2)*(W+2) + ty*W) * Cm elements of the
// input type. bm: rows of the tile core, 64 or 16 (see gemm_tile.cuh's Tile).
// Returns the launch's CUDA error code (0 on success).
extern "C" int boda_resblock(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* w3, const void* b3, void* out,
                             int n, int H, int W, int C, int Cm, int ty, int bm,
                             int in_bf16, int out_bf16, int relu_out, void* stream) {
  BlockShape s;
  s.H = H;
  s.W = W;
  s.C = C;
  s.Cm = Cm;
  s.ty = ty;
  s.nbands = (H + ty - 1) / ty;
  s.wp = W + 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (in_bf16) {
    if (out_bf16)
      e = launch<__nv_bfloat16, __nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, out, n, s,
                                               bm, relu_out, st);
    else
      e = launch<__nv_bfloat16, float>(x, w1, b1, w2, b2, w3, b3, out, n, s, bm,
                                       relu_out, st);
  } else {
    if (out_bf16)
      e = launch<float, __nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, out, n, s, bm,
                                       relu_out, st);
    else
      e = launch<float, float>(x, w1, b1, w2, b2, w3, b3, out, n, s, bm, relu_out, st);
  }
  return static_cast<int>(e);
}
