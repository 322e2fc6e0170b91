// qconv: the int8 convolution of the selective-int8 preset, as an implicit GEMM
// on int8 tensor cores; and the activation quantize that makes its input.
// Hand-written for Hopper (sm_90a).
//
// Replaces the int8 form of the vendor conv in boda_tpu/ops/pallas/conv.py
// (XlaConv.build :187-266, the quant8 / in_q8 / out_q8 forms) and
// boda_tpu/ops/pallas/conv2.py (XlaConv2.build :139-193): an XLA
// conv_general_dilated on int8 operands with int32 results, which torch has no
// counterpart of on CUDA. Same function, in the JAX template's order, all f32
// round to nearest even and no contraction of the multiply and the add:
//   y[n,oy,ox,o] = store(relu?(f32(sum_{ky,kx,c} xq[n, oy*sy+ky-py, ox*sx+kx-px, c]
//                                        * wq[o,ky,kx,c]) * (s_act * sws[o]) + bias[o]))
// with store = f32, bf16, or int8 at clamp(rint(v * q), -127, 127) (q = 127 /
// out_absmax, an out_q8 edge). The int32 sum is exact (the wrapper bounds K).
// s_act is read from device memory: the quantize below writes it, also for a
// dynamic scale, so the host never waits.
//
// The product runs on the GEMM core of hopper_gemm.cuh exactly as sgemm_int8's
// (qsgemm.cu): 128 x 128 block tiles, M = n*oy*ox output pixels by N = oc, K =
// ky*kx*C in tap-major, channel-minor order, in chunks of 128 bytes (128 int8
// values) through the 3-stage swizzled cp.async ring, and two warpgroups each
// issuing wgmma.mma_async m64n128k32 s32.s8.s8 from shared memory. A is never
// formed: tconv.cu's window loader, extended to strides sy, sx, copies 16 int8
// channels of one input pixel per 16-byte cp.async, zero-filled where the pixel
// lies in the padding or past M. B is the filter in OHWI order, [oc, ky, kx, C],
// which is row-major [N, K]. Where C % 16 != 0 (16 channels of a copy would
// straddle a tap) or an operand is not 16-byte aligned, a compile-time variant
// stages element by element.
//
// What bounds it on an H100 SXM (1979 TOPS int8 dense, 3.35 TB/s): ResNet-50's
// int8 sites at batch 32 do 0.9-7.4 G operations each (1-3.7 us at the peak)
// against 1.5-7 MB of int8 input, filter and bf16 output (0.5-2 us): the
// operations, by a little, at the 3x3s; the bytes at the 1x1s of res5. Like
// the core's other tensor-core kernels, the staging from L2 sets its pace.
// Split-K is left out: res5 at batch 32 fills 52 of 132 SMs.
//
// The same kernel runs training's int8 weight gradient (grad_q8; the JAX
// package's boda_tpu/ops/mxu_grad.py _wgrad_q8, :170-205, an XLA int8 conv
// there), driven by ops/cuda/qconv.wgrad_q8: the forward's input as an NHWC
// [C_in, H, W, N] tensor (the batch as the channels contracted) and the
// cotangent as an [O, OH, OW, N] filter, so M = C_in*ky*kx is small and K =
// N*OH*OW long; with no K split, ResNet-50's res3 3x3 (1152 x 128 x 25088 at
// batch 32) fills 9 of 132 SMs.
//
// The activation quantize (`act_quantize`) makes xq from f32 or bf16 x as
// conv.py:162-171 does: q = clamp(rint(x / s_act), -127, 127) with IEEE
// division. A static s_act (float32(act_absmax / 127) rounded on the host from
// the double quotient) takes one launch; a dynamic one, s_act = max|x| / 127 +
// 1e-30 in f32, two: sgemm_int8's partial maxima (quant.cuh, NaN kept), then
// every block reduces them, computes s_act and quantizes. Its bytes bound it:
// x read twice (once when static), xq written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_gemm.cuh"
#include "quant.cuh"  // quant_amax, block_max, q8

namespace {

using namespace boda::hopper;

constexpr int kTile = 128;  // block tile: 128 pixels x 128 output channels
constexpr int kChan = 16;   // int8 channels of one 16-byte copy

struct QShape {
  int M, N, K;     // GEMM rows (n*oy*ox), cols (oc), depth (ky*kx*C)
  int H, W, C;     // input NHWC extents
  int oy, ox;      // output extents
  int kx, sy, sx, py, px;
};

// Output pixel m's window: tap (yy, xx), channel c of it is the element
// base + (yy*W + xx)*C + c, inside the image iff 0 <= iy0 + yy < H and
// 0 <= ix0 + xx < W. valid is false past M.
struct Pixel {
  int base, iy0, ix0;
  bool valid;
};

__device__ __forceinline__ Pixel pixel_of(const QShape& s, int m) {
  Pixel p;
  p.valid = m < s.M;
  const int mm = p.valid ? m : 0;
  const int img = mm / (s.oy * s.ox);
  const int rem = mm - img * (s.oy * s.ox);
  const int oyy = rem / s.ox;
  p.iy0 = oyy * s.sy - s.py;
  p.ix0 = (rem - oyy * s.ox) * s.sx - s.px;
  p.base = ((img * s.H + p.iy0) * s.W + p.ix0) * s.C;
  return p;
}

struct Tap {
  int yy, xx, c;
};

__device__ __forceinline__ Tap tap_of(const QShape& s, int k) {
  Tap t;
  const int tap = k / s.C;
  t.c = k - tap * s.C;
  t.yy = tap / s.kx;
  t.xx = tap - t.yy * s.kx;
  return t;
}

__device__ __forceinline__ bool inside(const QShape& s, const Pixel& p, const Tap& t) {
  const int iy = p.iy0 + t.yy, ix = p.ix0 + t.xx;
  return p.valid && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
}

__device__ __forceinline__ int offset(const QShape& s, const Pixel& p, const Tap& t) {
  return p.base + (t.yy * s.W + t.xx) * s.C + t.c;
}

// Stage K chunk kc of A (128 pixels) and B (128 filters) into the stage
// buffers at shared addresses sa, sb (generic sa_p, sb_p). Thread t copies
// 16-byte chunk j = t % 8 of rows t / 8 + 32 i. kVec: cp.async copies of 16
// channels of one tap (C % 16 == 0); else element by element, zero outside.
template <bool kVec>
__device__ __forceinline__ void stage_q(const QShape& s, const int8_t* __restrict__ x,
                                        const int8_t* __restrict__ w, const Pixel (&px)[4],
                                        int n0, int kc, uint32_t sa, uint32_t sb, uint8_t* sa_p,
                                        uint8_t* sb_p) {
  const int j = threadIdx.x & 7;
  const int k = kc * kRowBytes + j * kChan;
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
      union {
        uint4 v;
        int8_t e[kChan];
      } a, b;
#pragma unroll
      for (int e = 0; e < kChan; ++e) {
        const int kk = k + e;
        a.e[e] = b.e[e] = 0;
        if (kk < s.K) {
          const Tap t = tap_of(s, kk);
          if (inside(s, px[i], t)) a.e[e] = x[offset(s, px[i], t)];
          if (n < s.N) b.e[e] = w[(size_t)n * s.K + kk];
        }
      }
      *reinterpret_cast<uint4*>(sa_p + swz(r, j)) = a.v;
      *reinterpret_cast<uint4*>(sb_p + swz(r, j)) = b.v;
    }
  }
}

// The epilogue of one sum: f32(v) * (s_act * sws[n]) + bias[n], ReLU, each
// step one rounding.
__device__ __forceinline__ float dequant(int v, float s_act, const float* __restrict__ sws,
                                         const float* __restrict__ bias, int n, int relu) {
  float f = __fmul_rn(__int2float_rn(v), __fmul_rn(s_act, sws[n]));
  if (bias != nullptr) f = __fadd_rn(f, bias[n]);
  if (relu && f < 0.f) f = 0.f;
  return f;
}

template <typename T>
struct Store;
template <>
struct Store<float> {
  using T2 = float2;
  __device__ static float cvt(float v, float) { return v; }
  __device__ static float2 pair(float a, float b) { return make_float2(a, b); }
};
template <>
struct Store<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  __device__ static __nv_bfloat16 cvt(float v, float) { return __float2bfloat16_rn(v); }
  __device__ static __nv_bfloat162 pair(__nv_bfloat16 a, __nv_bfloat16 b) {
    __nv_bfloat162 p;
    p.x = a;
    p.y = b;
    return p;
  }
};
template <>
struct Store<int8_t> {  // an int8 edge: clamp(rint(v * q), -127, 127)
  using T2 = char2;
  __device__ static int8_t cvt(float v, float q) {
    return (int8_t)max(-127, min(__float2int_rn(__fmul_rn(v, q)), 127));
  }
  __device__ static char2 pair(int8_t a, int8_t b) { return make_char2(a, b); }
};

// Two warpgroups, each the 64 x 128 product of half the tile's rows. Two
// blocks per SM (2 x 97 KB of shared memory) need at most 128 registers a
// thread.
template <typename TOut, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ s_act_p, const float* __restrict__ sws,
                 const float* __restrict__ bias, TOut* __restrict__ out, QShape s, int relu,
                 float out_q) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;

  Pixel px[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) px[i] = pixel_of(s, m0 + (threadIdx.x >> 3) + 32 * i);

  using R = Ring<kTile>;
  int acc[64];
  ring_product<kTile>(
      smem, 0, (s.K + kRowBytes - 1) / kRowBytes,
      [&](int st, int kc) {
        stage_q<kVec>(s, x, w, px, n0, kc, smem_addr(R::a(smem, st)), smem_addr(R::b(smem, st)),
                      R::a(smem, st), R::b(smem, st));
      },
      acc);
  const float s_act = *s_act_p;
  for_pairs(acc, [&](int r, int c, int v0, int v1) {
    const int m = m0 + r, n = n0 + c;
    if (m >= s.M || n >= s.N) return;
    const size_t i = (size_t)m * s.N + n;
    const TOut o0 = Store<TOut>::cvt(dequant(v0, s_act, sws, bias, n, relu), out_q);
    if (n + 1 >= s.N) {
      out[i] = o0;
      return;
    }
    const TOut o1 = Store<TOut>::cvt(dequant(v1, s_act, sws, bias, n + 1, relu), out_q);
    if (i % 2 == 0) {
      *reinterpret_cast<typename Store<TOut>::T2*>(out + i) = Store<TOut>::pair(o0, o1);
    } else {
      out[i] = o0;
      out[i + 1] = o1;
    }
  });
}

template <typename TOut, bool kVec>
int launch_qconv(const void* x, const void* w, const void* s_act, const void* sws,
                 const void* bias, void* out, const QShape& s, int relu, float out_q,
                 cudaStream_t stream) {
  static bool smem_set = false;  // per instantiation
  const cudaError_t e = allow_smem(qconv_kernel<TOut, kVec>, Ring<kTile>::kSmem, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s.M + kTile - 1) / kTile, (s.N + kTile - 1) / kTile);
  qconv_kernel<TOut, kVec><<<grid, kThreads, Ring<kTile>::kSmem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s_act), static_cast<const float*>(sws),
      static_cast<const float*>(bias), static_cast<TOut*>(out), s, relu, out_q);
  return static_cast<int>(cudaGetLastError());
}

template <typename TOut>
int launch_vec(int vec, const void* x, const void* w, const void* s_act, const void* sws,
               const void* bias, void* out, const QShape& s, int relu, float out_q,
               cudaStream_t stream) {
  return vec ? launch_qconv<TOut, true>(x, w, s_act, sws, bias, out, s, relu, out_q, stream)
             : launch_qconv<TOut, false>(x, w, s_act, sws, bias, out, s, relu, out_q, stream);
}

// ---------------------------------------------------------------- quantize

// xq = q8(x, s_act) over n elements of x (f32 or bf16), in 16-byte runs where
// vec (x 16-byte aligned); s_act the static scale, or, where dynamic, max|x| /
// 127 + 1e-30 from quant_amax's partial maxima, each block reducing them
// itself. Block 0 writes s_act to s_out.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    act_quant_write(const T* __restrict__ x, int8_t* __restrict__ xq, size_t n,
                    const float* __restrict__ part, float s_static, int dynamic,
                    float* __restrict__ s_out, int vec) {
  constexpr int kPer = 16 / sizeof(T);
  float s = s_static;
  if (dynamic) s = __fadd_rn(__fdiv_rn(block_max(part[threadIdx.x]), 127.f), 1e-30f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
  const size_t stride = (size_t)gridDim.x * kThreads;
  const size_t t0 = (size_t)blockIdx.x * kThreads + threadIdx.x;
  size_t tail = 0;
  if (vec) {
    const uint4* x16 = reinterpret_cast<const uint4*>(x);
    for (size_t i = t0; i < n / kPer; i += stride) {
      const uint4 v = __ldg(x16 + i);
      const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
      if constexpr (sizeof(T) == 4) {
        reinterpret_cast<char4*>(xq)[i] =
            make_char4(q8(__uint_as_float(wd[0]), s), q8(__uint_as_float(wd[1]), s),
                       q8(__uint_as_float(wd[2]), s), q8(__uint_as_float(wd[3]), s));
      } else {
        uint32_t o[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const char4 c = make_char4(q8(__uint_as_float(wd[2 * h] << 16), s),
                                     q8(__uint_as_float(wd[2 * h] & 0xffff0000u), s),
                                     q8(__uint_as_float(wd[2 * h + 1] << 16), s),
                                     q8(__uint_as_float(wd[2 * h + 1] & 0xffff0000u), s));
          o[h] = *reinterpret_cast<const uint32_t*>(&c);
        }
        reinterpret_cast<uint2*>(xq)[i] = make_uint2(o[0], o[1]);
      }
    }
    tail = n / kPer * kPer;
  }
  for (size_t i = tail + t0; i < n; i += stride) xq[i] = q8(boda::to_f32(x[i]), s);
}

template <typename T>
int launch_quantize(const void* x, void* xq, float* ws, size_t n, float s_static, int dynamic,
                    cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int vec = reinterpret_cast<size_t>(x) % 16 == 0;
  float* part = ws + 4;
  if (dynamic) {
    quant_amax<T><<<dim3(kParts, 1), kThreads, 0, stream>>>(xt, n, vec, xt, 0, 0, part);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // about 8 16-byte runs a thread, at most 2048 blocks
  const size_t per = (size_t)kThreads * 8 * (16 / sizeof(T));
  size_t gx = (n + per - 1) / per;
  gx = gx < 1 ? 1 : (gx < 2048 ? gx : 2048);
  act_quant_write<T><<<(unsigned)gx, kThreads, 0, stream>>>(
      xt, static_cast<int8_t*>(xq), n, part, s_static, dynamic, ws, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq: int8 NHWC [n, H, W, C]; wq: int8 OHWI [oc, ky, kx, C]. s_act: f32 [1] on
// the device. sws: f32 [oc]; bias: f32 [oc] or null.
// out: NHWC [n, oy, ox, oc] with oy = (H + 2*py - ky) / sy + 1 (ox alike), of
// out_kind 0 f32, 1 bf16, 2 int8 (stored at clamp(rint(v * out_q), -127, 127)).
// vec: 16-byte copies (C % 16 == 0, xq and wq 16-byte aligned). The caller
// keeps K = ky*kx*C <= 2^31 / 127^2, every extent under 2^31 and oc <=
// 65535 * 128. Returns the launch's cudaGetLastError().
extern "C" int boda_qconv(const void* xq, const void* wq, const void* s_act, const void* sws,
                          const void* bias, void* out, int n, int H, int W,
                          int C, int oc, int ky, int kx, int sy, int sx, int py, int px, int relu,
                          int out_kind, float out_q, int vec, void* stream) {
  QShape s;
  s.H = H;
  s.W = W;
  s.C = C;
  s.kx = kx;
  s.sy = sy;
  s.sx = sx;
  s.py = py;
  s.px = px;
  s.oy = (H + 2 * py - ky) / sy + 1;
  s.ox = (W + 2 * px - kx) / sx + 1;
  s.M = n * s.oy * s.ox;
  s.N = oc;
  s.K = ky * kx * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_kind == 0)
    return launch_vec<float>(vec, xq, wq, s_act, sws, bias, out, s, relu, out_q, st);
  if (out_kind == 1)
    return launch_vec<__nv_bfloat16>(vec, xq, wq, s_act, sws, bias, out, s, relu, out_q, st);
  return launch_vec<int8_t>(vec, xq, wq, s_act, sws, bias, out, s, relu, out_q, st);
}

// () -> floats of boda_act_quantize's workspace: ws[0] holds s_act when the
// launches end, ws[4..] the partial maxima.
extern "C" int boda_act_quantize_ws_floats() { return 4 + kParts; }

// x: n elements, f32 or bf16 (in_bf16); xq: n int8. s_static > 0: the static
// scale, one launch; dynamic != 0: two launches. Returns cudaGetLastError()
// after the launches.
extern "C" int boda_act_quantize(const void* x, void* xq, void* ws, long long n, int in_bf16,
                                 float s_static, int dynamic, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  return in_bf16 ? launch_quantize<__nv_bfloat16>(x, xq, wsf, (size_t)n, s_static, dynamic, st)
                 : launch_quantize<float>(x, xq, wsf, (size_t)n, s_static, dynamic, st);
}
