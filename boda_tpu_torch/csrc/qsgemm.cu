// sgemm_int8: C[M,N] = f32(sum_k A[m,k] * B[n,k]) * scale[0], A and B int8,
// the sum in int32; hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of boda_tpu/ops/pallas/qsgemm.py: SgemmInt8.build and
// its body `kern`, an int8 x int8 -> int32 product with the f32 dequant epilogue
// acc * (sa * sb). Same function: the integer sum over K is exact (the wrapper
// bounds K so that it cannot overflow int32), and the epilogue converts it to f32
// (round to nearest even) and multiplies it once, in f32, by the scale product,
// as the Pallas body does. The scale product is read from device memory: the
// quantize pass that makes it runs on the card, and the host never waits for it.
//
// Both operands are row-major with K contiguous, A[M,K] and B[N,K] (the quantize
// pass writes B transposed). Ragged M, N and K, K not a multiple of 4 included,
// are masked inside the kernel; nothing is padded in device memory, where the
// Pallas version pads both operands to its tile grid.
//
// What bounds it on an H100: this first kernel multiplies on the CUDA cores with
// __dp4a (four int8 products summed into an int32 per instruction), not on the
// int8 tensor cores. An SM issues at most 64 dp4a per clock, about 134 TOPS over
// 132 SMs at 1.98 GHz (spec arithmetic), against 1979 TOPS dense on the tensor
// cores. A block owns a 128 x 128 tile of C. K advances in 64-byte chunks staged
// in shared memory as 32-bit words (4 int8 each) in k-word-major order, so each
// thread's 8 x 8 micro-tile reads its 8 A words and 8 B words with four 16-byte
// shared-memory loads and issues 64 dp4a on them. The next chunk's device loads
// are issued into registers before the current chunk's products. The int8
// wgmma/TMA form is later work.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // tile rows (M)
constexpr int kBN = 128;          // tile cols (N)
constexpr int kBK = 64;           // K bytes per chunk staged in shared memory
constexpr int kKW = kBK / 4;      // 32-bit words per row per chunk
constexpr int kThreads = 256;     // 16 x 16 threads
constexpr int kTM = 8;            // micro-tile rows per thread
constexpr int kTN = 8;            // micro-tile cols per thread
constexpr int kPad = 4;           // words; rows stay 16-byte aligned
// 16-byte pieces (16 int8 of one row) of a tile's K chunk that each thread stages
constexpr int kPieces = kBM * kBK / 16 / kThreads;
static_assert(kBM == kBN && kPieces * kThreads * 16 == kBM * kBK, "tile shape");
static_assert(kTM * 16 == kBM && kTN * 16 == kBN, "micro-tile shape");

// The 16 int8 of row r at k .. k+15 as four little-endian 32-bit words, zero
// where r or k lies outside the [rows, K] matrix. kVec: K % 16 == 0 and the
// matrix 16-byte aligned, so one 16-byte load covers the piece.
template <bool kVec>
__device__ __forceinline__ int4 load_piece(const int8_t* __restrict__ X, int rows,
                                           int K, int r, int k) {
  if (r >= rows || k >= K) return make_int4(0, 0, 0, 0);
  const int8_t* p = X + (size_t)r * K + k;
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const int4*>(p));
  } else {
    int w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + 4 * q + j < K) v |= (uint32_t)(uint8_t)p[4 * q + j] << (8 * j);
      w[q] = (int)v;
    }
    return make_int4(w[0], w[1], w[2], w[3]);
  }
}

// Thread t stages pieces q = t + l * kThreads: tile row q / 4, K bytes
// (q % 4) * 16 .. + 15 of the chunk, i.e. words (q % 4) * 4 .. + 3.
__device__ __forceinline__ void stage(int (*S)[kBM + kPad], const int4 (&v)[kPieces]) {
#pragma unroll
  for (int l = 0; l < kPieces; ++l) {
    const int q = threadIdx.x + l * kThreads;
    const int r = q / 4, w = (q % 4) * 4;
    S[w + 0][r] = v[l].x;
    S[w + 1][r] = v[l].y;
    S[w + 2][r] = v[l].z;
    S[w + 3][r] = v[l].w;
  }
}

// Rows (or cols) 4 * t .. + 3 and 64 + 4 * t .. + 3 of word kw: two 16-byte loads.
__device__ __forceinline__ void read8(const int* row, int t, int (&x)[8]) {
  const int4 lo = *reinterpret_cast<const int4*>(row + 4 * t);
  const int4 hi = *reinterpret_cast<const int4*>(row + 64 + 4 * t);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    sgemm_int8_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                      const float* __restrict__ scale, float* __restrict__ C, int M,
                      int N, int K) {
  __shared__ __align__(16) int As[kKW][kBM + kPad];
  __shared__ __align__(16) int Bs[kKW][kBN + kPad];
  const int tx = threadIdx.x % 16;  // owns cols 4*tx .. +3 and 64 + 4*tx .. +3
  const int ty = threadIdx.x / 16;  // owns rows 4*ty .. +3 and 64 + 4*ty .. +3
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  int4 ra[kPieces], rb[kPieces];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kPieces; ++l) {
      const int q = threadIdx.x + l * kThreads;
      ra[l] = load_piece<kVec>(A, M, K, m0 + q / 4, k0 + (q % 4) * 16);
      rb[l] = load_piece<kVec>(B, N, K, n0 + q / 4, k0 + (q % 4) * 16);
    }
  };
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous chunk's reads are done
    stage(As, ra);
    stage(Bs, rb);
    __syncthreads();
    if (k0 + kBK < K) fetch(k0 + kBK);  // in flight during the products
#pragma unroll
    for (int kw = 0; kw < kKW; ++kw) {
      int a[kTM], b[kTN];
      read8(As[kw], ty, a);
      read8(Bs[kw], tx, b);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
  }

  const float s = *scale;
  const bool quads = N % 4 == 0;  // float4 stores stay 16-byte aligned
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + 4 * tx;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(__int2float_rn(acc[i][4 * h + j]), s);
      float* c = C + (size_t)m * N + n;
      if (quads && n + 3 < N) {
        *reinterpret_cast<float4*>(c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) c[j] = v[j];
      }
    }
  }
}

}  // namespace

// A: int8 [M, K], B: int8 [N, K], both row-major; scale: f32 [1] on the device;
// C: f32 [M, N]. The caller keeps K <= 2^31 / 127^2 and N <= 65535 * 128.
// Returns cudaGetLastError() after the launch.
extern "C" int boda_sgemm_int8(const void* A, const void* B, const void* scale, void* C,
                               int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  const bool vec = K % 16 == 0 && reinterpret_cast<size_t>(A) % 16 == 0 &&
                   reinterpret_cast<size_t>(B) % 16 == 0;
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* b = static_cast<const int8_t*>(B);
  const float* sc = static_cast<const float*>(scale);
  float* c = static_cast<float*>(C);
  if (vec)
    sgemm_int8_kernel<true><<<grid, kThreads, 0, s>>>(a, b, sc, c, M, N, K);
  else
    sgemm_int8_kernel<false><<<grid, kThreads, 0, s>>>(a, b, sc, c, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
