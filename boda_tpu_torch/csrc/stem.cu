// fused_stem: conv (7x7/s2 in ResNet) + bias + ReLU + ceil-mode max-pool (3x3/s2)
// in one kernel, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of boda_tpu/ops/pallas/stem.py:57, build_fused_stem
// and its body `kern` (:140-189). Same function:
//   out[n, j, i, oc] = max over the pool window of relu(conv(x)[n, oc, ., .] + b[oc])
// with the conv accumulated in f32 over taps x C, the operands in the compute
// type (f32 or bf16, as they arrive), the bias added in f32 without rounding,
// and one rounding to the output type. Pool positions past the conv output
// (the ceil-mode overhang) are left out of the max; the TPU kernel zeroes them,
// which is the same thing after a ReLU. f32 runs FFMA in full FP32, never TF32.
// The TPU kernel's 4x4 phase-plane split, lane padding and pltpu.roll column
// shifts are Mosaic workarounds for strided slices; a strided index costs
// nothing here, so none of them is carried over.
//
// How the conv activation stays out of device memory: one block owns one image,
// a tile of ty x tx pooled outputs and 64 output channels. It stages the input
// patch that tile needs (zero outside the image: the conv padding) and the
// filter into shared memory, computes the conv tile the pool windows cover,
// (ty-1)*psy + pky rows by (tx-1)*psx + pkx cols, into shared memory, and
// max-pools it there. Only the pooled output is written: at ResNet-50 batch 32
// the conv activation would be 102.8 MB of f32 written and read again.
//
// What bounds it on an H100: 2*C*ky*kx flop per conv output (294 for ResNet's
// conv1, 7.6 GFLOP at batch 32, plus the conv rows and cols that two tiles'
// windows share and both compute), against 19 MB of f32 input and 25.7 MB of
// pooled output, so the FFMA issue rate bounds it. Each thread owns 4 output
// channels at up to 10 conv positions: per tap it reads one float4 of filter
// and 10 input values from shared memory for 40 FFMA.
#include <math_constants.h>

#include "gemm_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kOcb = 64;         // output channels per block: 16 groups of 4
constexpr int kPosPerThread = 10;
constexpr int kMaxPos = kThreads / 16 * kPosPerThread;  // conv-tile positions per block

struct StemShape {
  int H, W, C, oc;           // input NHWC extents, output channels
  int ky, kx, sy, sx, py, px;  // conv filter, stride, padding
  int cy, cx;                // conv output extents
  int pky, pkx, psy, psx;    // pool window and stride (pool padding 0)
  int oy, ox;                // pooled output extents
  int ty, tx;                // pooled rows and cols per block
  int cty, ctx;              // conv-tile rows and cols: (ty-1)*psy + pky, ...
  int pr, pc;                // input-patch rows and cols: (cty-1)*sy + ky, ...
  int tiles_y, tiles_x;      // tiles per image
};

// Shared memory of one block, in floats: filter [K][kOcb], conv tile
// [cty*ctx][kOcb], input patch [pr][pc][C].
size_t smem_floats(const StemShape& s) {
  return (size_t)s.C * s.ky * s.kx * kOcb + (size_t)s.cty * s.ctx * kOcb +
         (size_t)s.pr * s.pc * s.C;
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    fused_stem_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w,
                      const float* __restrict__ bias, TOut* __restrict__ out, StemShape s,
                      int relu) {
  extern __shared__ __align__(16) float smem[];
  const int K = s.C * s.ky * s.kx;
  float* ws = smem;                          // [K][kOcb]
  float* ct = ws + (size_t)K * kOcb;         // [cty*ctx][kOcb]
  float* ps = ct + (size_t)s.cty * s.ctx * kOcb;  // [pr][pc][C]
  const int tid = threadIdx.x;
  int b = blockIdx.x;
  const int tile_x = b % s.tiles_x;
  b /= s.tiles_x;
  const int tile_y = b % s.tiles_y;
  const int img = b / s.tiles_y;
  const int oc0 = blockIdx.y * kOcb;
  const int j0 = tile_y * s.ty;              // first pooled row and col
  const int i0 = tile_x * s.tx;
  const int cy0 = j0 * s.psy;                // first conv row and col
  const int cx0 = i0 * s.psx;
  const int iy0 = cy0 * s.sy - s.py;         // first input row and col
  const int ix0 = cx0 * s.sx - s.px;

  // the filter, [k][o] with k = (c*ky + yy)*kx + xx (OIHW order), zero past oc
  for (int idx = tid; idx < K * kOcb; idx += kThreads) {
    const int o = idx / K;
    const int k = idx - o * K;
    ws[k * kOcb + o] = (oc0 + o < s.oc) ? boda::to_f32(w[(size_t)(oc0 + o) * K + k]) : 0.f;
  }
  // the input patch, zero outside the image
  const int npatch = s.pr * s.pc * s.C;
  for (int idx = tid; idx < npatch; idx += kThreads) {
    const int q = idx / s.C;
    const int c = idx - q * s.C;
    const int prow = q / s.pc;
    const int iy = iy0 + prow;
    const int ix = ix0 + q - prow * s.pc;
    ps[idx] = (iy >= 0 && iy < s.H && ix >= 0 && ix < s.W)
                  ? boda::to_f32(x[(((size_t)img * s.H + iy) * s.W + ix) * s.C + c])
                  : 0.f;
  }
  __syncthreads();

  // conv tile: thread (og, pg) owns channels 4*og .. 4*og+3 at positions
  // pg, pg + 16, ... of the cty x ctx tile
  const int og = tid % 16;
  const int pg = tid / 16;
  const int npos = s.cty * s.ctx;
  int off[kPosPerThread];
  float acc[kPosPerThread][4];
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int p = pg + 16 * i < npos ? pg + 16 * i : 0;
    const int r = p / s.ctx;
    off[i] = (r * s.sy * s.pc + (p - r * s.ctx) * s.sx) * s.C;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int c = 0; c < s.C; ++c)
    for (int yy = 0; yy < s.ky; ++yy)
      for (int xx = 0; xx < s.kx; ++xx) {
        const int k = (c * s.ky + yy) * s.kx + xx;
        const float4 wv = *reinterpret_cast<const float4*>(&ws[k * kOcb + 4 * og]);
        const int d = (yy * s.pc + xx) * s.C + c;
#pragma unroll
        for (int i = 0; i < kPosPerThread; ++i) {
          const float v = ps[off[i] + d];
          acc[i][0] = fmaf(v, wv.x, acc[i][0]);
          acc[i][1] = fmaf(v, wv.y, acc[i][1]);
          acc[i][2] = fmaf(v, wv.z, acc[i][2]);
          acc[i][3] = fmaf(v, wv.w, acc[i][3]);
        }
      }
  float bv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = oc0 + 4 * og + j;
    bv[j] = (bias != nullptr && o < s.oc) ? bias[o] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPosPerThread; ++i) {
    const int p = pg + 16 * i;
    if (p >= npos) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = acc[i][j] + bv[j];
      if (relu) v = fmaxf(v, 0.f);
      ct[p * kOcb + 4 * og + j] = v;
    }
  }
  __syncthreads();

  // max-pool the conv tile; channels fastest, so the NHWC stores coalesce
  for (int idx = tid; idx < s.ty * s.tx * kOcb; idx += kThreads) {
    const int o = idx % kOcb;
    const int q = idx / kOcb;
    const int lj = q / s.tx;
    const int li = q - lj * s.tx;
    const int j = j0 + lj;
    const int i = i0 + li;
    if (j >= s.oy || i >= s.ox || oc0 + o >= s.oc) continue;
    float m = -CUDART_INF_F;
    for (int dy = 0; dy < s.pky; ++dy) {
      const int r = lj * s.psy + dy;
      if (cy0 + r >= s.cy) break;
      for (int dx = 0; dx < s.pkx; ++dx) {
        const int cc = li * s.psx + dx;
        if (cx0 + cc >= s.cx) break;
        m = fmaxf(m, ct[(r * s.ctx + cc) * kOcb + o]);
      }
    }
    out[(((size_t)img * s.oy + j) * s.ox + i) * s.oc + oc0 + o] = boda::from_f32<TOut>(m);
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int n,
                   StemShape s, int relu, cudaStream_t stream) {
  const size_t smem = smem_floats(s) * sizeof(float);
  auto kern = fused_stem_kernel<TIn, TOut>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(n * s.tiles_y * s.tiles_x, (s.oc + kOcb - 1) / kOcb);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const TIn*>(x),
                                         static_cast<const TIn*>(w),
                                         static_cast<const float*>(bias),
                                         static_cast<TOut*>(out), s, relu);
  return cudaGetLastError();
}

}  // namespace

// x: NHWC [n, H, W, C]; w: OIHW [oc, C, ky, kx], both f32 or bf16 (in_bf16).
// bias: f32 [oc] or null. out: NHWC [n, oy, ox, oc], f32 or bf16 (out_bf16),
// where (cy, cx) is the conv output and (oy, ox) the ceil-mode pooled output of
// it (pool padding 0; every window starts inside the conv output). ty x tx:
// pooled outputs per block, with ((ty-1)*psy + pky) * ((tx-1)*psx + pkx) <= 160
// conv positions. Returns the launch's CUDA error code (0 on success).
extern "C" int boda_fused_stem(const void* x, const void* w, const void* bias, void* out,
                               int n, int H, int W, int C, int oc, int ky, int kx, int sy,
                               int sx, int py, int px, int pky, int pkx, int psy, int psx,
                               int oy, int ox, int ty, int tx, int in_bf16, int out_bf16,
                               int relu, void* stream) {
  StemShape s;
  s.H = H;
  s.W = W;
  s.C = C;
  s.oc = oc;
  s.ky = ky;
  s.kx = kx;
  s.sy = sy;
  s.sx = sx;
  s.py = py;
  s.px = px;
  s.cy = (H + 2 * py - ky) / sy + 1;
  s.cx = (W + 2 * px - kx) / sx + 1;
  s.pky = pky;
  s.pkx = pkx;
  s.psy = psy;
  s.psx = psx;
  s.oy = oy;
  s.ox = ox;
  s.ty = ty;
  s.tx = tx;
  s.cty = (ty - 1) * psy + pky;
  s.ctx = (tx - 1) * psx + pkx;
  s.pr = (s.cty - 1) * sy + ky;
  s.pc = (s.ctx - 1) * sx + kx;
  s.tiles_y = (oy + ty - 1) / ty;
  s.tiles_x = (ox + tx - 1) / tx;
  if (s.cty * s.ctx > kMaxPos) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (in_bf16) {
    if (out_bf16)
      e = launch<__nv_bfloat16, __nv_bfloat16>(x, w, bias, out, n, s, relu, st);
    else
      e = launch<__nv_bfloat16, float>(x, w, bias, out, n, s, relu, st);
  } else {
    if (out_bf16)
      e = launch<float, __nv_bfloat16>(x, w, bias, out, n, s, relu, st);
    else
      e = launch<float, float>(x, w, bias, out, n, s, relu, st);
  }
  return static_cast<int>(e);
}
