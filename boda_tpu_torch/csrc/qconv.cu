// qconv (B6): the int8 convolution of the selective-int8 preset and of
// training's int8 weight gradient, as an implicit GEMM on int8 tensor cores;
// and the activation quantize that makes its input. Hand-written for Hopper
// (sm_90a).
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
// out_absmax, an out_q8 edge). The int32 sum is exact (the wrapper bounds K),
// so it may be taken in any order: split into K ranges, each range's int32
// partial sums added by a second kernel before the one epilogue, it is the
// same sum bit for bit. s_act is read from device memory: the quantize below
// writes it, also for a dynamic scale, so the host never waits.
//
// The GEMM: M = n*oy*ox output pixels by N = oc over K = ky*kx*C in tap-major,
// channel-minor order, 128 x 128 tiles, K in chunks of 128 bytes.
//
// What bounds it on an H100 SXM (1979 TOPS int8 dense, 3.35 TB/s): ResNet-50's
// int8 sites at batch 32 do 0.9-7.4 G operations each (0.5-3.7 us at the peak)
// against 1.5-7 MB of int8 input, filter and bf16 output (0.5-2 us); the
// weight-gradient role (the batch as the contracted channels, K = N*OH*OW up to
// 25088) does 0.3-7 G. Neither bound is near: a 32 KB chunk feeds 0.28 us of
// int8 wgmma on an SM, and the staging of A (the conv window, copied by
// threads) takes several times that. Taking the wgmma out of the kernel leaves
// its time as it is, taking A's copies out halves it, and a ring of 3, 4 or 5
// stages runs at the same speed; more producer threads, more copies in flight,
// run faster (PERF.md, kernel table). The design:
//  1. Fill. 128 x 128 tiles give 9-490 tiles at these shapes, against 132
//     SMs, and a tile of a long K (36 chunks at res5 3x3, 196 in the res3
//     weight gradient) runs its chunks one after the other on one SM. So the
//     plan (ops/cuda/qconv.qconv_plan) splits K where the tiles do not fill
//     the card, into at most one unit per SM, and where they fill it with a
//     last wave of few tiles, splits those: the full waves' tiles run whole,
//     each split unit writes int32 partial sums to a workspace, and
//     qconv_reduce adds them and runs the epilogue for the split tiles' rows.
//     Splits that make a second wave of units measured slower than none.
//  2. The pipeline (conv_ring.cuh, which B7's bf16 conv runs on too). One
//     block per SM, persistent over the (tile, split) units: two producer
//     warpgroups keep a 4-stage ring of 32 KB stages full
//     (each stage's "full" and "empty" mbarriers, tma_pipe.cuh) while two
//     consumer warpgroups each run wgmma m64n128k32 s32 on their 64 rows; the
//     producers run on into the next unit while the consumers store a tile.
//     B (the filter, row-major [oc, K]) comes by one TMA load per chunk in the
//     128-byte swizzle the wgmma descriptor reads; so does A where the conv
//     is 1x1 with stride 1 and no padding (xq is then a row-major [M, C]
//     matrix, and one producer thread issues both loads). Else A comes by
//     cp.async from the producers' threads, which arrive on the stage's
//     barrier as their copies land (cp.async.mbarrier.arrive.noinc). TMA's
//     im2col mode was not taken: its strides must be multiples of 16 bytes,
//     which leaves out every C % 16 != 0 (GoogLeNet's C = 24, the narrow
//     route below), and one copy route for every window is one to keep
//     right. Each producer thread copies one 16-byte (or narrower) run of
//     several rows per chunk; each row's pixel is worked out once per tile
//     (a shared table), and the tap of the thread's run advances by 128
//     bytes per chunk without a division.
//  3. Narrow channels. Where C % 16 != 0 a 16-byte run would straddle two
//     taps: the copies are 8 bytes (C % 8 == 0) or 4 (C % 4 == 0), still
//     zero-filled by cp.async; only the rest (C = 3) is staged element by
//     element. B then moves by the same copies where K % 16 != 0 (TMA needs
//     16-byte rows).
//  4. The epilogue stages each consumer warpgroup's 64 x 128 results in
//     shared memory and writes 16-byte runs of whole rows.
//
// The activation quantize (`act_quantize`) makes xq from f32 or bf16 x as
// conv.py:162-171 does: q = clamp(rint(x / s_act), -127, 127) with IEEE
// division. A static s_act (float32(act_absmax / 127) rounded on the host from
// the double quotient) takes one launch; a dynamic one, s_act = max|x| / 127 +
// 1e-30 in f32, two: sgemm_int8's partial maxima (quant.cuh, NaN kept), then
// every block reduces them, computes s_act and quantizes. Under a dp split
// (engine/mesh_fwd.py) a slot holds only its rows of the batch whose absmax
// sets the scale, so the dynamic form comes apart: `boda_act_absmax` gives the
// slot's max|x| as a device scalar (the same partial maxima, then one block
// folds them), the engine takes the max over the dp group on the device, and
// the quantize reads that max from device memory and computes s_act from it
// with the same two f32 operations: the scale of the whole batch, bit for bit,
// since a max does not depend on order. The weight gradient
// takes x transposed, [N, H, W, I] stored as [I, H, W, N] (the batch as B6's
// channels): the transposing form writes that layout through a shared tile in
// the same pass. Its per-channel form quantizes the cotangent [N, OH, OW, O]
// per output channel (the JAX _wgrad_q8's s_g, quantize_filter's formula)
// straight into the [O, OH, OW, N] filter B6 takes: the per-channel maxima in
// one launch, the scales and the transposing quantize in a second. Their bytes
// bound them: x read twice (once when static), xq written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "conv_ring.cuh"  // the ring, its loaders and the unit walk
#include "hopper_gemm.cuh"
#include "quant.cuh"  // quant_amax, block_max, nan_max, q8
#include "tma_pipe.cuh"

namespace {

using namespace boda::hopper;
using namespace boda::convring;
namespace tma = boda::tma;

using QShape = ConvShape;
using L = Layout<kTile>;                        // 128 x 128 tiles
constexpr int kEpiStride = 128 * 4 + 32;        // bytes of a staged row of 4-byte results
constexpr int kEpiBytes = 64 * kEpiStride;      // one consumer warpgroup's staging
constexpr int kSmem = L::kOffEpi + 2 * kEpiBytes + 1024;  // and up to 1 KB to align

// The epilogue of one sum: f32(v) * (s_act * sws[n]) + bias[n], ReLU, each
// step one rounding.
__device__ __forceinline__ float dequant(int v, float s_act, const float* __restrict__ sws,
                                         const float* __restrict__ bias, int n, int relu) {
  float f = __fmul_rn(__int2float_rn(v), __fmul_rn(s_act, sws[n]));
  if (bias != nullptr) f = __fadd_rn(f, bias[n]);
  if (relu && f < 0.f) f = 0.f;
  return f;
}

// The stored form of a result: f32, bf16, int8 (an out_q8 edge: clamp(rint(v
// * q), -127, 127)), or int32 (a split's partial sum, stored as summed).
template <typename T>
struct Store;
template <>
struct Store<float> {
  __device__ static float cvt(float v, float) { return v; }
};
template <>
struct Store<__nv_bfloat16> {
  __device__ static __nv_bfloat16 cvt(float v, float) { return __float2bfloat16_rn(v); }
};
template <>
struct Store<int8_t> {
  __device__ static int8_t cvt(float v, float q) {
    return (int8_t)max(-127, min(__float2int_rn(__fmul_rn(v, q)), 127));
  }
};

// The staged row stride of a result type: 128 results and a pad that keeps
// the pair stores of a warp off shared bank conflicts (rows 16-byte aligned).
template <typename T>
__host__ __device__ constexpr int epi_stride() {
  return sizeof(T) == 4 ? kEpiStride : 128 * (int)sizeof(T) + 16;
}

struct Outs {
  const float* s_act;
  const float* sws;
  const float* bias;
  void* out;      // the result [M, N]
  int* ws;        // the split tiles' int32 partial sums [splits, M - m_split, N]
  int m_split;    // their first row: (full / tiles_n) * 128
  int relu;
  float out_q;
};

// A consumer warpgroup's epilogue of its 64 x 128 results (rows m0 .. m0 +
// 63, columns n0 ..): into its staging rows of shared memory, then whole rows
// out to row m - out_m0 of the row-major [.., N] out, in 16-byte runs where
// the row's stride allows, else element by element.
template <typename T>
__device__ __forceinline__ void epilogue(const QShape& s, const Outs& o, const int (&acc)[64],
                                         uint8_t* stg, int wg, int m0, int n0, T* out,
                                         int out_m0) {
  constexpr int kS = epi_stride<T>();
  constexpr bool kPartial = sizeof(T) == 4 && !std::is_same<T, float>::value;
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int r = (t >> 5) * 16 + (lane >> 2);
  tma::named_sync(2 + wg, 128);  // the previous tile's reads of stg are done
  float s_act = 0.f;
  if constexpr (!kPartial) s_act = *o.s_act;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = i * 8 + (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v0 = acc[i * 4 + 2 * h], v1 = acc[i * 4 + 2 * h + 1];
      T* dst = reinterpret_cast<T*>(stg + (r + 8 * h) * kS) + c;
      if constexpr (kPartial) {
        dst[0] = v0;
        dst[1] = v1;
      } else {
        const int n = n0 + c;
        // columns past N are staged but never stored
        dst[0] = Store<T>::cvt(n < s.N ? dequant(v0, s_act, o.sws, o.bias, n, o.relu) : 0.f,
                               o.out_q);
        dst[1] = Store<T>::cvt(
            n + 1 < s.N ? dequant(v1, s_act, o.sws, o.bias, n + 1, o.relu) : 0.f, o.out_q);
      }
    }
  }
  tma::named_sync(2 + wg, 128);
  constexpr int kPer = 16 / sizeof(T);  // results of a 16-byte run
  constexpr int kRuns = 128 / kPer;     // runs of a row
  const bool vec = (s.N * sizeof(T)) % 16 == 0;
#pragma unroll 4
  for (int idx = t; idx < 64 * kRuns; idx += 128) {
    const int row = idx / kRuns, q = idx % kRuns;
    const int m = m0 + row, n = n0 + q * kPer;
    if (m >= s.M || n >= s.N) continue;
    const uint8_t* src = stg + row * kS + q * 16;
    T* dst = out + (size_t)(m - out_m0) * s.N + n;
    if (vec && n + kPer <= s.N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kPer && n + e < s.N; ++e) dst[e] = reinterpret_cast<const T*>(src)[e];
    }
  }
}

// The epilogue of a unit: a whole tile's results in T, a split's int32
// partial sums into the workspace.
template <typename T>
struct QEpi {
  const QShape& s;
  const Outs& o;
  uint8_t* smem;
  struct State {};
  __device__ __forceinline__ void operator()(const Unit<kTile>& un, int wg,
                                             const int (&acc)[64], State&) const {
    uint8_t* stg = smem + L::kOffEpi + wg * kEpiBytes;
    if (un.z < 0)
      epilogue<T>(s, o, acc, stg, wg, un.m0 + 64 * wg, un.n0, static_cast<T*>(o.out), 0);
    else
      epilogue<int>(s, o, acc, stg, wg, un.m0 + 64 * wg, un.n0,
                    o.ws + (size_t)un.z * (s.M - o.m_split) * s.N, o.m_split);
  }
};

// One block per SM walks the units (conv_ring.cuh's ring_conv): int8 wgmma
// m64n128k32 into int32 sums, then QEpi.
template <typename T, int kFill>
__global__ void __launch_bounds__(kBlock, 1)
    qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap xmap, Outs o, QShape s, int units) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  int acc[64];
  ring_conv<int8_t, kTile, kFill>(x, w, &wmap, &xmap, s, units, smem, acc,
                                  QEpi<T>{s, o, smem});
}

// out[m][n] = store(dequant(sum over z of ws[z][m - m_split][n])) for the
// rows m_split .. M - 1 of the split tiles, the int32 partials added exactly;
// 4 results a thread where N % 4 == 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    qconv_reduce(Outs o, int M, int N, int splits) {
  const size_t MN = (size_t)(M - o.m_split) * N;
  const int* ws = o.ws;
  T* out = static_cast<T*>(o.out) + (size_t)o.m_split * N;
  const float s_act = *o.s_act;
  const size_t stride = (size_t)gridDim.x * kThreads;
  if (N % 4 == 0) {
    for (size_t g = (size_t)blockIdx.x * kThreads + threadIdx.x; g < MN / 4; g += stride) {
      int4 v = reinterpret_cast<const int4*>(ws)[g];
      for (int z = 1; z < splits; ++z) {
        const int4 p = reinterpret_cast<const int4*>(ws + (size_t)z * MN)[g];
        v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
      }
      const int n = (int)(4 * g % N);
      const int vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[4 * g + e] = Store<T>::cvt(dequant(vs[e], s_act, o.sws, o.bias, n + e, o.relu), o.out_q);
    }
    return;
  }
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < MN; i += stride) {
    int v = 0;
    for (int z = 0; z < splits; ++z) v += ws[(size_t)z * MN + i];
    out[i] = Store<T>::cvt(dequant(v, s_act, o.sws, o.bias, (int)(i % N), o.relu), o.out_q);
  }
}

template <typename T, int kFill>
int launch_fill(const int8_t* x, const int8_t* w, const CUtensorMap& wmap, const CUtensorMap& xmap,
                const Outs& o, const QShape& s, int grid, cudaStream_t stream) {
  static bool smem_set = false;  // per instantiation
  const cudaError_t e = allow_smem(qconv_kernel<T, kFill>, kSmem, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  qconv_kernel<T, kFill><<<grid, kBlock, kSmem, stream>>>(x, w, wmap, xmap, o, s, units_of(s));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_main(const int8_t* x, const int8_t* w, const CUtensorMap& wmap, const CUtensorMap& xmap,
                int fill, const Outs& o, const QShape& s, int grid, cudaStream_t stream) {
  if (fill == kTmaAB) return launch_fill<T, kTmaAB>(x, w, wmap, xmap, o, s, grid, stream);
  if (fill == kTmaB) return launch_fill<T, kTmaB>(x, w, wmap, xmap, o, s, grid, stream);
  return launch_fill<T, kCopies>(x, w, wmap, xmap, o, s, grid, stream);
}

template <typename T>
int launch_qconv(const int8_t* x, const int8_t* w, const Outs& o, const QShape& s, int grid,
                 cudaStream_t stream) {
  CUtensorMap wmap, xmap;
  memset(&wmap, 0, sizeof(wmap));
  memset(&xmap, 0, sizeof(xmap));
  int fill = kCopies;
  const int re = fill_of(s, x, w, 1, kTile, &wmap, &xmap, &fill);
  if (re != 0) return re;
  const int rc = launch_main<T>(x, w, wmap, xmap, fill, o, s, grid, stream);
  if (rc != 0 || s.full == s.tiles) return rc;
  const size_t MN = (size_t)(s.M - o.m_split) * s.N;
  const size_t need = (MN / (s.N % 4 == 0 ? 4 : 1) + kThreads - 1) / kThreads;
  const int blocks = need < 4096 ? (int)(need > 0 ? need : 1) : 4096;
  qconv_reduce<T><<<blocks, kThreads, 0, stream>>>(o, s.M, s.N, s.splits);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- quantize

// Where the quantize's s_act comes from: the static scale; the partial maxima
// of quant_amax (a dynamic scale, one slot's batch); or a max|x| in device
// memory (a dp group's, from boda_act_absmax and the engine's max).
enum ScaleFrom { kStaticScale = 0, kPartMaxima = 1, kDeviceMax = 2 };

// s_act of a max: max / 127 + 1e-30 in f32, each operation rounded once
__device__ __forceinline__ float scale_of_max(float m) {
  return __fadd_rn(__fdiv_rn(m, 127.f), 1e-30f);
}

// s_act as `from` says, in every thread of the block (kPartMaxima reduces
// part's kParts values over the block; kDeviceMax reads part[0])
__device__ __forceinline__ float act_scale(const float* part, float s_static, int from) {
  if (from == kPartMaxima) return scale_of_max(block_max(part[threadIdx.x]));
  if (from == kDeviceMax) return scale_of_max(part[0]);
  return s_static;
}

// out[0] = the max of quant_amax's kParts partial maxima (NaN kept): one block.
__global__ void __launch_bounds__(kThreads)
    quant_amax_fold(const float* __restrict__ part, float* __restrict__ out) {
  const float m = block_max(part[threadIdx.x]);
  if (threadIdx.x == 0) *out = m;
}

// xq = q8(x, s_act) over n elements of x (f32 or bf16), in 16-byte runs where
// vec (x 16-byte aligned); s_act as act_scale gives it from `from`, each block
// reducing the partial maxima itself. Block 0 writes s_act to s_out.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    act_quant_write(const T* __restrict__ x, int8_t* __restrict__ xq, size_t n,
                    const float* __restrict__ part, float s_static, int from,
                    float* __restrict__ s_out, int vec) {
  constexpr int kPer = 16 / sizeof(T);
  const float s = act_scale(part, s_static, from);
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

constexpr int kXT = 32;  // the transposing quantize's tile: 32 x 32 values
constexpr int kXB = 8;   // and the b a block of it walks

// The transposing quantize: x is [A, B, Cc] (contiguous), xq[c, b, a] =
// q8(x[a, b, c], s) is [Cc, B, A]. Block (b tile, c tile, a tile), for each
// of its kXB b, reads 32 rows of 32 channels, quantizes them into a shared
// tile and writes 32 rows of 32 bytes of the transpose. kPerChan: s = s_c[c],
// from the per-channel partial maxima part[p * Cc + c] (p < nparts), max / 127
// + 1e-30, written to s_out[c] by the blocks of b tile 0 and a tile 0; else s
// is act_scale's from `from` (act_quant_write's), written to s_out[0] by the
// first block.
template <typename T, bool kPerChan>
__global__ void __launch_bounds__(kThreads)
    act_quant_xpose(const T* __restrict__ x, int8_t* __restrict__ xq, int A, int B, int Cc,
                    const float* __restrict__ part, int nparts, float s_static, int from,
                    float* __restrict__ s_out) {
  __shared__ int8_t tile[kXT][kXT + 4];
  __shared__ float sc[kXT];
  const int b0 = blockIdx.x * kXB, c0 = blockIdx.y * kXT, a0 = blockIdx.z * kXT;
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const bool first = blockIdx.x == 0 && blockIdx.z == 0;
  float s = s_static;
  if constexpr (kPerChan) {
    // 8 threads reduce each of the tile's 32 channels
    const int cl = threadIdx.x >> 3, q = threadIdx.x & 7, c = c0 + cl;
    float m = 0.f;
    if (c < Cc)
      for (int p = q; p < nparts; p += 8) m = nan_max(m, part[(size_t)p * Cc + c]);
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (q == 0) {
      sc[cl] = scale_of_max(m);
      if (first && c < Cc) s_out[c] = sc[cl];
    }
    __syncthreads();
  } else {
    s = act_scale(part, s_static, from);
    if (first && blockIdx.y == 0 && threadIdx.x == 0) *s_out = s;
  }
  const float s_c = kPerChan ? sc[lane] : s;
  for (int b = b0; b < min(b0 + kXB, B); ++b) {
#pragma unroll
    for (int i = 0; i < kXT / 8; ++i) {
      const int al = wp + 8 * i, a = a0 + al, c = c0 + lane;
      int8_t q = 0;
      if (a < A && c < Cc) q = q8(boda::to_f32(x[((size_t)a * B + b) * Cc + c]), s_c);
      tile[al][lane] = q;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kXT / 8; ++i) {
      const int cl = wp + 8 * i, c = c0 + cl, a = a0 + lane;
      if (c < Cc && a < A) xq[((size_t)c * B + b) * A + a] = tile[lane][cl];
    }
    __syncthreads();  // the tile is free for the next b
  }
}

constexpr int kColRows = kThreads / kXT;  // rows a block of quant_colmax reads at once

// part[blockIdx.x * Cc + c] = max |x[r, c]| over the rows r of the [rows,
// Cc] x that block row blockIdx.x reads (NaN kept): warp w of block (p, c
// tile) reads rows (p * kColRows + w) + i * gridDim.x * kColRows, one
// channel a lane, 128 contiguous bytes (f32) a warp.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quant_colmax(const T* __restrict__ x, size_t rows, int Cc, float* __restrict__ part) {
  __shared__ float red[kColRows][kXT + 1];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int c = blockIdx.y * kXT + lane;
  const size_t step = (size_t)gridDim.x * kColRows;
  float m0 = 0.f, m1 = 0.f;
  if (c < Cc) {
    size_t r = (size_t)blockIdx.x * kColRows + wp;
    for (; r + step < rows; r += 2 * step) {  // two loads in flight
      m0 = nan_max(m0, fabsf(boda::to_f32(x[r * Cc + c])));
      m1 = nan_max(m1, fabsf(boda::to_f32(x[(r + step) * Cc + c])));
    }
    if (r < rows) m0 = nan_max(m0, fabsf(boda::to_f32(x[r * Cc + c])));
  }
  red[wp][lane] = nan_max(m0, m1);
  __syncthreads();
  if (wp == 0 && c < Cc) {
    float m = red[0][lane];
#pragma unroll
    for (int w = 1; w < kColRows; ++w) m = nan_max(m, red[w][lane]);
    part[(size_t)blockIdx.x * Cc + c] = m;
  }
}

// Block rows of quant_colmax: 64, or fewer where x has fewer rows than 64
// blocks read at once.
inline int colmax_parts(long long rows, long long) {
  const long long p = (rows + kColRows - 1) / kColRows;
  return (int)(p < 64 ? p : 64);
}

template <typename T>
int launch_quantize(const void* x, void* xq, float* ws, const float* amax, long long A,
                    long long B, long long Cc, float s_static, int from, int transpose,
                    int per_chan, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  int8_t* q = static_cast<int8_t*>(xq);
  const size_t n = (size_t)(A * B * Cc);
  const int vec = reinterpret_cast<size_t>(x) % 16 == 0;
  const dim3 tiles((unsigned)((B + kXB - 1) / kXB), (unsigned)((Cc + kXT - 1) / kXT),
                   (unsigned)((A + kXT - 1) / kXT));
  if (per_chan) {
    const int parts = colmax_parts(A * B, Cc);
    float* part = ws + Cc;
    quant_colmax<T><<<dim3(parts, (unsigned)((Cc + kXT - 1) / kXT)), kThreads, 0, stream>>>(
        xt, (size_t)(A * B), (int)Cc, part);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    act_quant_xpose<T, true><<<tiles, kThreads, 0, stream>>>(xt, q, (int)A, (int)B, (int)Cc, part,
                                                             parts, 0.f, 1, ws);
    return static_cast<int>(cudaGetLastError());
  }
  float* part = ws + 4;
  if (from == kPartMaxima) {
    quant_amax<T><<<dim3(kParts, 1), kThreads, 0, stream>>>(xt, n, vec, xt, 0, 0, part);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float* src = from == kDeviceMax ? amax : part;
  if (transpose) {
    act_quant_xpose<T, false><<<tiles, kThreads, 0, stream>>>(xt, q, (int)A, (int)B, (int)Cc, src,
                                                              kParts, s_static, from, ws);
    return static_cast<int>(cudaGetLastError());
  }
  // about 8 16-byte runs a thread, at most 2048 blocks
  const size_t per = (size_t)kThreads * 8 * (16 / sizeof(T));
  size_t gx = (n + per - 1) / per;
  gx = gx < 1 ? 1 : (gx < 2048 ? gx : 2048);
  act_quant_write<T><<<(unsigned)gx, kThreads, 0, stream>>>(xt, q, n, src, s_static, from, ws,
                                                            vec);
  return static_cast<int>(cudaGetLastError());
}

// ws[0] = max|x| over n elements of x: quant_amax's partial maxima into ws + 4,
// then quant_amax_fold.
template <typename T>
int launch_absmax(const void* x, float* ws, size_t n, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int vec = reinterpret_cast<size_t>(x) % 16 == 0;
  quant_amax<T><<<dim3(kParts, 1), kThreads, 0, stream>>>(xt, n, vec, xt, 0, 0, ws + 4);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  quant_amax_fold<<<1, kThreads, 0, stream>>>(ws + 4, ws);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq: int8 NHWC [n, H, W, C]; wq: int8 OHWI [oc, ky, kx, C]. s_act: f32 [1] on
// the device. sws: f32 [oc]; bias: f32 [oc] or null.
// out: NHWC [n, oy, ox, oc] with oy = (H + 2*py - ky) / sy + 1 (ox alike), of
// out_kind 0 f32, 1 bf16, 2 int8 (stored at clamp(rint(v * out_q), -127, 127)).
// va: bytes of one copy of xq (16, 8, 4 or 1; C % va == 0 and xq va-aligned);
// vb: of wq (the same over K = ky*kx*C; 16: by TMA, wq 16-byte aligned).
// full: the 128 x 128 output tiles (row-major over [M / 128, oc / 128],
// a multiple of the tiles along oc) that run whole; the rest run in
// `splits` K ranges each (splits > 1; ws: int32 [splits, M - m_split, oc]
// with m_split = full / (tiles along oc) * 128 their first row, else
// unused). grid: blocks of the persistent walk (at most one per SM). The
// caller keeps K <= 2^31 / 127^2, every extent under 2^31 and splits <= the
// K chunks. Returns the launches' cudaGetLastError(), or tma::kEncodeError +
// the CUresult where a tensor map was refused.
extern "C" int boda_qconv(const void* xq, const void* wq, const void* s_act, const void* sws,
                          const void* bias, void* out, void* ws, int n, int H, int W, int C,
                          int oc, int ky, int kx, int sy, int sx, int py, int px, int relu,
                          int out_kind, float out_q, int va, int vb, int full, int splits,
                          int grid, void* stream) {
  const QShape s =
      conv_shape(n, H, W, C, oc, ky, kx, sy, sx, py, px, 1, kTile, full, splits, va, vb);
  Outs o;
  o.s_act = static_cast<const float*>(s_act);
  o.sws = static_cast<const float*>(sws);
  o.bias = static_cast<const float*>(bias);
  o.out = out;
  o.ws = static_cast<int*>(ws);
  o.m_split = s.full / s.tiles_n * kTile;
  o.relu = relu;
  o.out_q = out_q;
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(wq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_kind == 0) return launch_qconv<float>(x, w, o, s, grid, st);
  if (out_kind == 1) return launch_qconv<__nv_bfloat16>(x, w, o, s, grid, st);
  return launch_qconv<int8_t>(x, w, o, s, grid, st);
}

// Floats of boda_act_quantize's workspace for x of [A, B, Cc]: per_chan: the
// Cc scales, then the per-channel partial maxima; else s_act at ws[0], the
// partial maxima from ws[4].
extern "C" int boda_act_quantize_ws_floats(long long A, long long B, long long Cc, int per_chan) {
  return per_chan ? (int)(Cc + (long long)colmax_parts(A * B, Cc) * Cc) : 4 + kParts;
}

// x: [A, B, Cc] elements, f32 or bf16 (in_bf16); xq: as many int8, [A, B, Cc]
// or, where transpose, [Cc, B, A]. scale_from (ScaleFrom): 0, the static scale
// s_static > 0, one launch; 1, a dynamic scale, two launches; 2, the scale of
// the max at amax (f32 [1] in device memory), one launch. per_chan (with
// transpose and scale_from 1): one dynamic scale per channel c of the last
// dim, written to ws[0 .. Cc). s_act goes to ws[0]. Returns
// cudaGetLastError() after the launches.
extern "C" int boda_act_quantize(const void* x, void* xq, void* ws, const void* amax, long long A,
                                 long long B, long long Cc, int in_bf16, float s_static,
                                 int scale_from, int transpose, int per_chan, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  const float* m = static_cast<const float*>(amax);
  return in_bf16 ? launch_quantize<__nv_bfloat16>(x, xq, wsf, m, A, B, Cc, s_static, scale_from,
                                                  transpose, per_chan, st)
                 : launch_quantize<float>(x, xq, wsf, m, A, B, Cc, s_static, scale_from,
                                          transpose, per_chan, st);
}

// ws[0] = max|x| (NaN where x holds one) over the n f32 or bf16 (in_bf16)
// elements of x; ws holds boda_act_quantize_ws_floats(1, 1, n, 0) floats. Two
// launches; returns cudaGetLastError() after them.
extern "C" int boda_act_absmax(const void* x, void* ws, long long n, int in_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  return in_bf16 ? launch_absmax<__nv_bfloat16>(x, wsf, (size_t)n, st)
                 : launch_absmax<float>(x, wsf, (size_t)n, st);
}
