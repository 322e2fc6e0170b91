// sgemm_int8: C[M,N] = f32(sum_k A[m,k] * B[n,k]) * scale[0], A and B int8,
// the sum in int32; and the quantize pass that makes A, B and the scale from
// f32 operands. Hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of boda_tpu/ops/pallas/qsgemm.py: SgemmInt8.build and
// its body `kern`, an int8 x int8 -> int32 product with the f32 dequant epilogue
// acc * (sa * sb). Same function: the integer sum over K is exact (the wrapper
// bounds K so that it cannot overflow int32), and the epilogue converts it to f32
// (round to nearest even) and multiplies it once, in f32, by the scale product,
// as the Pallas body does. The scale product is read from device memory: the
// quantize pass that makes it runs on the card, and the host never waits for it.
//
// The product. Both operands are row-major with K contiguous, A[M,K] and B[N,K]
// (the quantize pass writes B transposed). It runs on the GEMM core of
// hopper_gemm.cuh, the ring and staging B2's bf16 route uses byte for byte:
// 128 x 128 block tiles, K in chunks of 128 bytes (128 int8 values) staged by
// cp.async through 3 swizzled shared-memory stages, and two warpgroups each
// issuing wgmma.mma_async m64n128k32 s32.s8.s8 from shared memory, four 32-byte
// K steps a chunk. Ragged M, N and K are zero-filled copies; where K % 16 != 0
// (a row is not a whole number of 16-byte chunks) or an operand is not 16-byte
// aligned, a compile-time variant stages element by element. Nothing is padded
// in device memory, where the Pallas version pads both operands to its grid.
// The epilogue stores each thread's column pairs as float2.
//
// What bounds it on an H100 SXM (1979 TOPS int8 dense, 3.35 TB/s): at 4096^3
// the 137 G operations take 69 us at the peak, against 34 MB of int8 operands
// and 67 MB of f32 output (30 us): the operations. At 1024^3 the bytes do
// (6 MB, 1.9 us, against 1.1 us of operations). The dp4a kernel this replaces
// ran on the CUDA cores, capped near 134 TOPS (64 dp4a per SM per clock).
//
// The quantize pass, in two launches (the plain torch chain it replaces made
// some eight passes over each operand):
//  1. quant_amax: the max of |a| and of |b|, one grid of kParts blocks per
//     operand, each block's max written to its own slot of a workspace (no
//     atomics and no zeroed state; max is order-free, so the result repeats).
//  2. quant_write: every block reduces the 2 x kParts slots itself, computes
//     sa = max(amax_a, 1e-30) / 127 and sb the same (IEEE division), writes
//     sa * sb, sa and sb (block 0), and quantizes q = clamp(rint(v / s), -127,
//     127) with __fdiv_rn and round half to even: A row-major in float4 runs,
//     B transposed to [N, K] through a 64 x 64 shared-memory tile.
// A NaN in an operand gives a NaN scale, as in torch's chain and the Pallas
// template's qsym (the maxima keep NaN), so the product is NaN throughout;
// an element whose quotient is NaN quantizes to 0, as their casts do.
// Its bytes bound it: each f32 operand read twice and its int8 copy written
// once, 302 MB at 4096^3, 90 us.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_gemm.cuh"
#include "quant.cuh"  // quant_amax, block_max, nan_max, q8

namespace {

using namespace boda::hopper;

constexpr int kTile = 128;

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    sgemm_int8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                      const float* __restrict__ scale, float* __restrict__ C, int M, int N,
                      int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  using R = Ring<kTile>;
  int acc[64];
  ring_product<kTile>(
      smem, 0, (K + kRowBytes - 1) / kRowBytes,
      [&](int st, int kc) {
        stage_rows<kTile, kVec>(A, M, K, m0, kc, smem_addr(R::a(smem, st)), R::a(smem, st));
        stage_rows<kTile, kVec>(B, N, K, n0, kc, smem_addr(R::b(smem, st)), R::b(smem, st));
      },
      acc);
  const float s = *scale;
  for_pairs(acc, [&](int r, int c, int v0, int v1) {
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) return;
    const float f0 = __fmul_rn(__int2float_rn(v0), s);
    const float f1 = __fmul_rn(__int2float_rn(v1), s);
    float* p = C + (size_t)m * N + n;
    if (n + 1 < N && ((size_t)m * N + n) % 2 == 0) {
      *reinterpret_cast<float2*>(p) = make_float2(f0, f1);
    } else {
      p[0] = f0;
      if (n + 1 < N) p[1] = f1;
    }
  });
}

// ---------------------------------------------------------------- quantize

// scales[0..2] = sa * sb, sa, sb from part (quant_amax), then qa = q(a, sa)
// [M, K] and qb = q(b, sb)^T [N, K] of b [K, N]. blockIdx.y 0 quantizes A in
// runs of 4 (vec_a: a 16-byte aligned); 1 quantizes B by 64 x 64 tiles (vec_b:
// N % 4 == 0 and b 16-byte aligned; vec_q: K % 16 == 0, 16-byte row writes).
__global__ void __launch_bounds__(kThreads)
    quant_write(const float* __restrict__ a, const float* __restrict__ b,
                int8_t* __restrict__ qa, int8_t* __restrict__ qb, const float* __restrict__ part,
                float* __restrict__ scales, int M, int K, int N, int vec_a, int vec_b,
                int vec_q) {
  const float sa = __fdiv_rn(nan_max(block_max(part[threadIdx.x]), 1e-30f), 127.f);
  const float sb = __fdiv_rn(nan_max(block_max(part[kParts + threadIdx.x]), 1e-30f), 127.f);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    scales[0] = __fmul_rn(sa, sb);
    scales[1] = sa;
    scales[2] = sb;
  }
  if (blockIdx.y == 0) {
    const size_t n = (size_t)M * K;
    const size_t stride = (size_t)gridDim.x * kThreads;
    const size_t t0 = (size_t)blockIdx.x * kThreads + threadIdx.x;
    size_t tail = 0;
    if (vec_a) {
      const float4* a4 = reinterpret_cast<const float4*>(a);
      char4* q4 = reinterpret_cast<char4*>(qa);
      for (size_t i = t0; i < n / 4; i += stride) {
        const float4 v = __ldg(a4 + i);
        q4[i] = make_char4(q8(v.x, sa), q8(v.y, sa), q8(v.z, sa), q8(v.w, sa));
      }
      tail = n / 4 * 4;
    }
    for (size_t i = tail + t0; i < n; i += stride) qa[i] = q8(__ldg(a + i), sa);
    return;
  }
  // B [K, N] -> qb [N, K] by tiles of 64 k x 64 n: read rows of b (16 threads
  // a row, a float4 each), write rows of qb (4 threads a row, 16 bytes each)
  __shared__ __align__(16) int8_t tile[64][64 + 16];  // [n][k]
  const int tiles_k = (K + 63) / 64;
  const int tiles = tiles_k * ((N + 63) / 64);
  const int c4 = threadIdx.x & 15, kr = threadIdx.x >> 4;
  const int nn = threadIdx.x >> 2, ch = threadIdx.x & 3;
  for (int ti = blockIdx.x; ti < tiles; ti += gridDim.x) {
    const int k0 = (ti % tiles_k) * 64, n0 = (ti / tiles_k) * 64;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int k = k0 + kr + 16 * p, n = n0 + 4 * c4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (k < K) {
        const float* row = b + (size_t)k * N + n;
        if (vec_b && n < N) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(row));
          v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < N) v[e] = __ldg(row + e);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) tile[4 * c4 + e][kr + 16 * p] = q8(v[e], sb);
    }
    __syncthreads();
    const int n = n0 + nn, k = k0 + 16 * ch;
    if (n < N && k < K) {
      int8_t* dst = qb + (size_t)n * K + k;
      if (vec_q) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&tile[nn][16 * ch]);
      } else {
        for (int e = 0; e < 16 && k + e < K; ++e) dst[e] = tile[nn][16 * ch + e];
      }
    }
    __syncthreads();  // the tile is free for the next one
  }
}

}  // namespace

// A: int8 [M, K], B: int8 [N, K], both row-major; scale: f32 [1] on the device;
// C: f32 [M, N]. The caller keeps K <= 2^31 / 127^2 and N <= 65535 * 128.
// Returns cudaGetLastError() after the launch.
extern "C" int boda_sgemm_int8(const void* A, const void* B, const void* scale, void* C,
                               int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  const bool vec = K % 16 == 0 && reinterpret_cast<size_t>(A) % 16 == 0 &&
                   reinterpret_cast<size_t>(B) % 16 == 0;
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* b = static_cast<const int8_t*>(B);
  const float* sc = static_cast<const float*>(scale);
  float* c = static_cast<float*>(C);
  constexpr int kSmem = Ring<kTile>::kSmem;
  static bool smem_vec = false, smem_elem = false;
  cudaError_t e = vec ? allow_smem(sgemm_int8_kernel<true>, kSmem, smem_vec)
                      : allow_smem(sgemm_int8_kernel<false>, kSmem, smem_elem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (vec)
    sgemm_int8_kernel<true><<<grid, kThreads, kSmem, s>>>(a, b, sc, c, M, N, K);
  else
    sgemm_int8_kernel<false><<<grid, kThreads, kSmem, s>>>(a, b, sc, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// a: f32 [M, K], b: f32 [K, N], both row-major. qa: int8 [M, K]; qb: int8
// [N, K] (b's quantized transpose). ws: f32 workspace of
// boda_quantize_ws_floats() elements, whose first three hold sa * sb, sa and
// sb when the second launch ends. Returns cudaGetLastError() after the
// launches.
extern "C" int boda_quantize_ws_floats() { return 4 + 2 * kParts; }

extern "C" int boda_quantize_int8(const void* a, const void* b, void* qa, void* qb, void* ws,
                                  int M, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* scales = static_cast<float*>(ws);
  float* part = scales + 4;
  const int vec_a = reinterpret_cast<size_t>(a) % 16 == 0;
  const int vec_b = reinterpret_cast<size_t>(b) % 16 == 0;
  quant_amax<float><<<dim3(kParts, 2), kThreads, 0, s>>>(af, (size_t)M * K, vec_a, bf, (size_t)K * N,
                                                  vec_b, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // enough blocks for about 8 float4 runs of A a thread, or one B tile each
  const size_t runs = ((size_t)M * K + 4 * kThreads * 8 - 1) / (4 * kThreads * 8);
  const size_t tiles = (size_t)((K + 63) / 64) * ((N + 63) / 64);
  size_t gx = runs > tiles ? runs : tiles;
  gx = gx < 2048 ? gx : 2048;
  quant_write<<<dim3((unsigned)gx, 2), kThreads, 0, s>>>(
      af, bf, static_cast<int8_t*>(qa), static_cast<int8_t*>(qb), part, scales, M, K, N, vec_a,
      vec_b && N % 4 == 0, K % 16 == 0 && reinterpret_cast<size_t>(qb) % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}
