// tconv: stride-1 direct convolution as an implicit GEMM, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of boda_tpu/ops/pallas/tconv.py: build_tconv and its
// body `kern`, which DMAs a haloed NHWC row band into VMEM and accumulates the
// ky*kx taps as (TY*ox x C).(C x OCb) MXU dots in f32, then adds bias and ReLU.
//
// Here the same sum is one GEMM, C[M, N] = A[M, K] . B[N, K]^T, with M = n*oy*ox
// output pixels, N = oc and K = ky*kx*C in tap-major, channel-minor order. The
// im2col matrix A never exists: a block loads each pixel's input window itself,
// and conv padding and the ragged M edge are zero-filled loads. B is the filter
// in OHWI order, [oc, ky, kx, C], which is exactly row-major [N, K]. The epilogue
// adds bias[oc] in f32, applies ReLU and rounds once; the output is NHWC
// [n, oy, ox, oc], which is row-major C[M, N]. The ring, the wgmma and FFMA
// products, the epilogue, the split-K reduce and their helpers are the GEMM
// core of hopper_gemm.cuh, shared with matmul_ext (sgemm.cu) and sgemm_int8
// (qsgemm.cu); this file holds the conv window loader.
//
// What bounds it on an H100 SXM (989 TF/s bf16 dense, 67 TF/s FP32, 3.35 TB/s):
// each ResNet-50 3x3 layer that reaches tconv does 7.40 GFLOP at batch 32. At
// res4b (C = oc = 256, 14^2) that is 0.110 ms in f32 and 7.5 us in bf16 of
// compute against 15.2 / 7.6 MB of traffic (4.5 / 2.3 us): compute-bound. At
// res5 and batch 1 (C = oc = 512, 7^2, M = 49) it is 231 MFLOP and the 9.4 MB
// f32 filter (4.7 MB bf16) must be read once: in f32 the operations bound it
// (3.4 us, over the filter's 2.8 us), in bf16 the filter's bytes (1.4 us).
//
// What the design does about each limit of the first version:
//  1. bf16 runs on the tensor cores: a 128 x 128 block tile, K chunks of 64,
//     two consumer warpgroups, each issuing wgmma.mma_async m64n128k16 (bf16
//     in, f32 accumulators in registers) on its 64 rows, straight from shared
//     memory in the 128-byte-swizzled K-major layout the descriptors name.
//     One wgmma group stays in flight while the next chunk's copies issue.
//     Two blocks share an SM (97 KB of shared memory, <= 128 registers each).
//  2. Wide operand loads: an A copy is 8 bf16 channels (16 bytes) of one input
//     pixel, one tap decode (div/mod) per copy, zero-filled through cp.async's
//     src-size 0 where the pixel lies in the padding or past M. The f32 path
//     loads 4 channels with one 16-byte load, with one bounds check and one
//     div/mod per quad. Where C is not a multiple of 8 (bf16) or 4 (f32), a
//     compile-time variant of the same kernel stages the operands element by
//     element.
//  3. B is read in OHWI order, K-contiguous, with the same 16-byte loads.
//  4. bf16: a ring of 3 shared-memory stages filled by cp.async keeps two K
//     chunks in flight behind the products. What bounds it now is the reload
//     traffic from L2: each 128 x 128 tile re-reads its A rows once per tap
//     and its filter rows once per 128 pixels (about 116 MB at res4b b32).
//     f32: a 128 x 128 tile with an 8 x 8 micro-tile per thread read as float4
//     from shared memory (4 shared loads per 64 FFMA, 0.25 per FFMA where the
//     old 64 x 64 tile issued 0.5), double buffered so the next chunk's global
//     loads overlap the products. f32 stays full FP32 on FFMA: no TF32.
//  5. Split-K where the grid is small (res5 at batch 1 is 1 x 4 tiles on 132
//     SMs): the planner (ops/cuda/tconv.py tconv_plan) splits the K chunks over
//     grid.z; each split writes its f32 partial sums to a workspace the wrapper
//     allocates, and a second kernel adds them in split order, then bias, ReLU
//     and the one rounding. No atomics: results repeat bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using namespace boda::hopper;

constexpr int kTile = 128;  // block tile: 128 pixels x 128 output channels
constexpr int kBK16 = kRowBytes / 2;  // bf16 K chunk: one 128-byte row of a stage

struct ConvShape {
  int M, N, K;         // GEMM rows (n*oy*ox), cols (oc), depth (ky*kx*C)
  int H, W, C;         // input NHWC extents
  int oy, ox;          // output extents
  int kx, py, px;      // filter width and padding
  int chunks_per_split;
};

// The input window of output pixel m: tap (yy, xx), channel c of it is the
// element base + (yy*W + xx)*C + c, inside the image iff 0 <= iy0 + yy < H and
// 0 <= ix0 + xx < W. valid is false past M.
struct Pixel {
  int base, iy0, ix0;
  bool valid;
};

__device__ __forceinline__ Pixel pixel_of(const ConvShape& s, int m) {
  Pixel p;
  p.valid = m < s.M;
  const int mm = p.valid ? m : 0;
  const int img = mm / (s.oy * s.ox);
  const int rem = mm - img * (s.oy * s.ox);
  const int oyy = rem / s.ox;
  p.iy0 = oyy - s.py;
  p.ix0 = rem - oyy * s.ox - s.px;
  p.base = ((img * s.H + p.iy0) * s.W + p.ix0) * s.C;
  return p;
}

// k -> (yy, xx, c): one div/mod for a run of channels of one tap
struct Tap {
  int yy, xx, c;
};

__device__ __forceinline__ Tap tap_of(const ConvShape& s, int k) {
  Tap t;
  const int tap = k / s.C;
  t.c = k - tap * s.C;
  t.yy = tap / s.kx;
  t.xx = tap - t.yy * s.kx;
  return t;
}

__device__ __forceinline__ bool inside(const ConvShape& s, const Pixel& p, const Tap& t) {
  const int iy = p.iy0 + t.yy, ix = p.ix0 + t.xx;
  return p.valid && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
}

__device__ __forceinline__ int offset(const ConvShape& s, const Pixel& p, const Tap& t) {
  return p.base + (t.yy * s.W + t.xx) * s.C + t.c;
}

// ---------------------------------------------------------------- bf16: tensor cores

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage K chunk kc of A (128 pixels) and B (128 filters) into stage buffers
// sa, sb. Thread t copies 16-byte chunk j = t % 8 of rows t / 8 + 32 i. kVec:
// cp.async copies (C % 8 == 0); else element by element, zero outside.
template <bool kVec>
__device__ __forceinline__ void stage_bf16(const ConvShape& s,
                                           const __nv_bfloat16* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ w,
                                           const Pixel (&px)[4], int n0, int kc,
                                           uint32_t sa, uint32_t sb, uint8_t* sa_p,
                                           uint8_t* sb_p) {
  const int j = threadIdx.x & 7;
  const int k = kc * kBK16 + j * 8;
  if constexpr (kVec) {
    const bool kin = k < s.K;
    const Tap t = tap_of(s, kin ? k : 0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (threadIdx.x >> 3) + 32 * i;
      const bool va = kin && inside(s, px[i], t);
      cp_async16(sa + swz(r, j), va ? x + offset(s, px[i], t) : x, va);
      const int n = n0 + r;
      const bool vb = kin && n < s.N;
      cp_async16(sb + swz(r, j), vb ? w + (size_t)n * s.K + k : w, vb);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (threadIdx.x >> 3) + 32 * i;
      const int n = n0 + r;
      float a[8], b[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int kk = k + e;
        a[e] = b[e] = 0.f;
        if (kk < s.K) {
          const Tap t = tap_of(s, kk);
          if (inside(s, px[i], t)) a[e] = boda::to_f32(x[offset(s, px[i], t)]);
          if (n < s.N) b[e] = boda::to_f32(w[(size_t)n * s.K + kk]);
        }
      }
      *reinterpret_cast<uint4*>(sa_p + swz(r, j)) =
          make_uint4(pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]), pack_bf16(a[4], a[5]),
                     pack_bf16(a[6], a[7]));
      *reinterpret_cast<uint4*>(sb_p + swz(r, j)) =
          make_uint4(pack_bf16(b[0], b[1]), pack_bf16(b[2], b[3]), pack_bf16(b[4], b[5]),
                     pack_bf16(b[6], b[7]));
    }
  }
}

// Two warpgroups, each the 64 x 128 product of half the tile's rows. Two
// blocks per SM (2 x 97 KB of shared memory) need at most 128 registers a
// thread.
template <typename TOut, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    tconv_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias, TOut* __restrict__ out,
                      float* __restrict__ ws, ConvShape s, int relu) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;

  Pixel px[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) px[i] = pixel_of(s, m0 + (threadIdx.x >> 3) + 32 * i);

  int kc0, kc1;
  split_range((s.K + kBK16 - 1) / kBK16, s.chunks_per_split, kc0, kc1);
  using R = Ring<kTile>;
  float acc[64];
  ring_product<kTile>(
      smem, kc0, kc1 - kc0,
      [&](int st, int kc) {
        stage_bf16<kVec>(s, x, w, px, n0, kc, smem_addr(R::a(smem, st)),
                         smem_addr(R::b(smem, st)), R::a(smem, st), R::b(smem, st));
      },
      acc);
  for_pairs(acc, [&](int r, int c, float v0, float v1) {
    store_pair(s.M, s.N, m0 + r, n0 + c, v0, v1, bias, out, ws, relu);
  });
}

// ---------------------------------------------------------------- f32: FFMA

// Quad (4 consecutive k) q = k .. k+3 of A row `p` and of B row n, in f32.
template <bool kVec>
__device__ __forceinline__ void quads_f32(const ConvShape& s, const float* __restrict__ x,
                                          const float* __restrict__ w, const Pixel& p, int n,
                                          int k, float (&a)[4], float (&b)[4]) {
  if constexpr (kVec) {
    float4 qa = make_float4(0.f, 0.f, 0.f, 0.f), qb = qa;
    if (k < s.K) {
      const Tap t = tap_of(s, k);
      if (inside(s, p, t)) qa = *reinterpret_cast<const float4*>(x + offset(s, p, t));
      if (n < s.N) qb = *reinterpret_cast<const float4*>(w + (size_t)n * s.K + k);
    }
    a[0] = qa.x, a[1] = qa.y, a[2] = qa.z, a[3] = qa.w;
    b[0] = qb.x, b[1] = qb.y, b[2] = qb.z, b[3] = qb.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k + e;
      a[e] = b[e] = 0.f;
      if (kk < s.K) {
        const Tap t = tap_of(s, kk);
        if (inside(s, p, t)) a[e] = x[offset(s, p, t)];
        if (n < s.N) b[e] = w[(size_t)n * s.K + kk];
      }
    }
  }
}

template <typename TOut, bool kVec>
__global__ void __launch_bounds__(kThreads)
    tconv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, TOut* __restrict__ out,
                     float* __restrict__ ws, ConvShape s, int relu) {
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  // staging: thread t loads quad t % 2 of A row t / 2 and of B row t / 2
  const Pixel p = pixel_of(s, m0 + (threadIdx.x >> 1));
  int kc0, kc1;
  split_range((s.K + kBK32 - 1) / kBK32, s.chunks_per_split, kc0, kc1);
  float acc[8][kTile / 16];
  ffma_product<kTile, false>(
      kc0, kc1 - kc0, s.M - m0,
      [&](int r, int k, float (&a)[4], float (&b)[4], bool) {
        quads_f32<kVec>(s, x, w, p, n0 + r, k, a, b);
      },
      acc);
  // one store per element: the core's pair stores made this kernel slower
  // at res4b b32 in 4 splits (the kernel alone by split count, PERF.md)
  for_quads<kTile>(acc, [&](int r, int c, const float (&v)[4]) {
    const int m = m0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + c + j;
      if (m >= s.M || n >= s.N) continue;
      if (ws != nullptr)
        ws[((size_t)blockIdx.z * s.M + m) * s.N + n] = v[j];
      else
        out[(size_t)m * s.N + n] = finish<TOut>(v[j], bias, n, relu);
    }
  });
}

template <typename TIn, typename TOut, bool kVec>
int launch(const void* x, const void* w, const void* bias, void* out, void* ws,
           const ConvShape& s, int splits, int relu, cudaStream_t stream) {
  const dim3 grid((s.M + kTile - 1) / kTile, (s.N + kTile - 1) / kTile, splits);
  float* wsf = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const float* b = static_cast<const float*>(bias);
  TOut* o = static_cast<TOut*>(out);
  if constexpr (sizeof(TIn) == 2) {
    static bool smem_set = false;  // per instantiation
    const cudaError_t e =
        allow_smem(tconv_bf16_kernel<TOut, kVec>, Ring<kTile>::kSmem, smem_set);
    if (e != cudaSuccess) return static_cast<int>(e);
    tconv_bf16_kernel<TOut, kVec><<<grid, kThreads, Ring<kTile>::kSmem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), b, o, wsf,
        s, relu);
  } else {
    tconv_f32_kernel<TOut, kVec><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), b, o, wsf, s, relu);
  }
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && splits > 1)
    e = launch_split_reduce<TOut>(wsf, b, o, (size_t)s.M * s.N, s.N, splits, relu, stream);
  return static_cast<int>(e);
}

template <typename TIn, typename TOut>
int launch_vec(int vec, const void* x, const void* w, const void* bias, void* out, void* ws,
               const ConvShape& s, int splits, int relu, cudaStream_t stream) {
  return vec ? launch<TIn, TOut, true>(x, w, bias, out, ws, s, splits, relu, stream)
             : launch<TIn, TOut, false>(x, w, bias, out, ws, s, splits, relu, stream);
}

}  // namespace

// x: NHWC [n, H, W, C]; w: OHWI [oc, ky, kx, C], both f32 or bf16 (in_bf16).
// bias: f32 [oc] or null. out: NHWC [n, oy, ox, oc], f32 or bf16 (out_bf16),
// with oy = H + 2*py - ky + 1 and ox = W + 2*px - kx + 1 (stride 1). splits:
// the K split of tconv_plan; when > 1, ws is an f32 workspace of
// splits * n*oy*ox * oc elements. vec: 16-byte operand loads (C % 8 == 0 for
// bf16, C % 4 == 0 for f32, x and w 16-byte aligned). Returns the launches'
// cudaGetLastError().
extern "C" int boda_tconv(const void* x, const void* w, const void* bias, void* out, void* ws,
                          int n, int H, int W, int C, int oc, int ky, int kx, int py, int px,
                          int in_bf16, int out_bf16, int relu, int splits, int vec,
                          void* stream) {
  ConvShape s;
  s.H = H;
  s.W = W;
  s.C = C;
  s.kx = kx;
  s.py = py;
  s.px = px;
  s.oy = H + 2 * py - ky + 1;
  s.ox = W + 2 * px - kx + 1;
  s.M = n * s.oy * s.ox;
  s.N = oc;
  s.K = ky * kx * C;
  const int bk = in_bf16 ? kBK16 : kBK32;
  const int chunks = (s.K + bk - 1) / bk;
  s.chunks_per_split = (chunks + splits - 1) / splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16
               ? launch_vec<__nv_bfloat16, __nv_bfloat16>(vec, x, w, bias, out, ws, s, splits,
                                                          relu, st)
               : launch_vec<__nv_bfloat16, float>(vec, x, w, bias, out, ws, s, splits, relu, st);
  return out_bf16 ? launch_vec<float, __nv_bfloat16>(vec, x, w, bias, out, ws, s, splits, relu, st)
                  : launch_vec<float, float>(vec, x, w, bias, out, ws, s, splits, relu, st);
}
