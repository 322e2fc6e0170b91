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
// [n, oy, ox, oc], which is row-major C[M, N].
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

#include "gemm_tile.cuh"  // boda::to_f32, boda::from_f32

namespace {

constexpr int kTile = 128;     // block tile: 128 pixels x 128 output channels
constexpr int kThreads = 256;  // 8 warps
constexpr int kBK16 = 64;      // bf16 K chunk: one 128-byte row of a stage
constexpr int kStages = 3;     // bf16 shared-memory ring
constexpr int kTileBytes16 = kTile * kBK16 * 2;       // one operand's stage, 16 KB
// 96 KB of stages and up to 1 KB to align them
constexpr int kSmem16 = kStages * 2 * kTileBytes16 + 1024;
constexpr int kBK32 = 8;       // f32 K chunk
constexpr int kPad32 = 4;      // f32 shared rows: 132 floats keep stores off one bank

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

// The K chunks of this block's split: [kc0, kc1)
__device__ __forceinline__ void split_range(const ConvShape& s, int bk, int& kc0, int& kc1) {
  const int chunks = (s.K + bk - 1) / bk;
  kc0 = blockIdx.z * s.chunks_per_split;
  kc1 = min(chunks, kc0 + s.chunks_per_split);
}

// Epilogue of one output element: unsplit, + bias, ReLU, one rounding into out;
// split, the f32 partial sum into this split's slice of the workspace.
template <typename TOut>
__device__ __forceinline__ void put(const ConvShape& s, int m, int n, float v,
                                    const float* __restrict__ bias, TOut* __restrict__ out,
                                    float* __restrict__ ws, int relu) {
  if (m >= s.M || n >= s.N) return;
  if (ws != nullptr) {
    ws[((size_t)blockIdx.z * s.M + m) * s.N + n] = v;
    return;
  }
  if (bias != nullptr) v += bias[n];
  if (relu && v < 0.f) v = 0.f;
  out[(size_t)m * s.N + n] = boda::from_f32<TOut>(v);
}

// ---------------------------------------------------------------- bf16: tensor cores

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes where !valid (src-size 0
// reads nothing; src must still be a global address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte offset of 16-byte chunk j (8 k) of row r in a [128][64] bf16 stage:
// rows of 128 bytes with the 16-byte chunks XOR-swizzled by row % 8, which is
// the layout wgmma reads as "K-major, 128-byte swizzle" (8-row groups 1024
// bytes apart). Stage buffers start on 1024-byte boundaries.
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return (uint32_t)(r * (kBK16 * 2) + ((j ^ (r & 7)) << 4));
}

// wgmma shared-memory matrix descriptor of a K-major, 128-byte-swizzled
// operand at shared address addr: start address >> 4 (bits 0-13), leading
// byte offset 1 (unused by this layout), stride byte offset 1024 >> 4
// (bits 32-45), layout type 1 = 128-byte swizzle (bits 62-63). The k16 step
// ks of a 64-wide chunk starts 32 * ks bytes further; the hardware applies
// the swizzle to the computed addresses.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 128 tile of this warpgroup] += A[64 x 16] . B[128 x 16]^T, both
// bf16 K-major in shared memory, f32 accumulators in registers.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (they are the operands it works on).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's writes to shared memory (cp.async or plain stores)
// visible to the asynchronous proxy that wgmma reads operands through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

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
  // stage buffers on 1024-byte boundaries (the swizzle's repeat)
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;        // warpgroup: rows wg*64 .. +63
  const int wq = (threadIdx.x >> 5) & 3;  // warp within it: 16 of those rows

  Pixel px[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) px[i] = pixel_of(s, m0 + (threadIdx.x >> 3) + 32 * i);

  int kc0, kc1;
  split_range(s, kBK16, kc0, kc1);
  const int nloc = kc1 - kc0;

  auto stage_a = [&](int st) { return smem + st * 2 * kTileBytes16; };
  auto stage_b = [&](int st) { return smem + st * 2 * kTileBytes16 + kTileBytes16; };
  auto load = [&](int st, int kc) {
    stage_bf16<kVec>(s, x, w, px, n0, kc, smem_addr(stage_a(st)), smem_addr(stage_b(st)),
                     stage_a(st), stage_b(st));
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nloc) load(st, kc0 + st);
    cp_async_commit();
  }
  // The products of chunk it run while the copies of chunk it + 2 are
  // issued: that stage held chunk it - 1, whose products every warpgroup
  // has finished by the second barrier.
  for (int it = 0; it < nloc; ++it) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // chunk it is in shared memory
    const uint64_t da = smem_desc(smem_addr(stage_a(it % kStages)) + wg * 64 * kBK16 * 2);
    const uint64_t db = smem_desc(smem_addr(stage_b(it % kStages)));
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK16 / 16; ++ks)
      wgmma_m64n128k16(acc, da + 2 * ks, db + 2 * ks);  // + 32 bytes a step
    wgmma_commit();
    wgmma_wait<1>();  // chunk it - 1's products are done
    fence_acc(acc);
    __syncthreads();  // in both warpgroups
    const int nxt = it + kStages - 1;
    if (nxt < nloc) load(nxt % kStages, kc0 + nxt);
    cp_async_commit();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();

  // accumulator i*4 + {0,1,2,3}: rows r, r, r+8, r+8 and columns c, c+1,
  // c, c+1 of 8-column group i, r = 16 wq + lane / 4, c = 8 i + 2 (lane % 4)
  const int m = m0 + wg * 64 + wq * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = n0 + i * 8 + (lane & 3) * 2;
    put(s, m, n, acc[i * 4 + 0], bias, out, ws, relu);
    put(s, m, n + 1, acc[i * 4 + 1], bias, out, ws, relu);
    put(s, m + 8, n, acc[i * 4 + 2], bias, out, ws, relu);
    put(s, m + 8, n + 1, acc[i * 4 + 3], bias, out, ws, relu);
  }
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
  __shared__ __align__(16) float As[2][kBK32][kTile + kPad32];
  __shared__ __align__(16) float Bs[2][kBK32][kTile + kPad32];
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  // staging: thread t loads quad t % 2 of A row t / 2 and of B row t / 2
  const int lr = threadIdx.x >> 1;
  const int kq = (threadIdx.x & 1) * 4;
  const Pixel p = pixel_of(s, m0 + lr);
  // products: thread (tx, ty) owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
  // columns tx*4 + {0..3} and 64 + tx*4 + {0..3} of the tile
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  int kc0, kc1;
  split_range(s, kBK32, kc0, kc1);
  const int nloc = kc1 - kc0;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float av[4], bv[4];
  auto store = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      As[buf][kq + e][lr] = av[e];
      Bs[buf][kq + e][lr] = bv[e];
    }
  };
  if (nloc > 0) {
    quads_f32<kVec>(s, x, w, p, n0 + lr, kc0 * kBK32 + kq, av, bv);
    store(0);
  }
  __syncthreads();
  for (int it = 0; it < nloc; ++it) {
    const int cur = it & 1;
    const bool more = it + 1 < nloc;
    if (more) quads_f32<kVec>(s, x, w, p, n0 + lr, (kc0 + it + 1) * kBK32 + kq, av, bv);
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      put(s, m, n, acc[i][j], bias, out, ws, relu);
    }
  }
}

// ---------------------------------------------------------------- split-K reduce

// out[m, n] = round(relu(sum over splits of ws[split, m, n] + bias[n])), the
// splits added in order.
template <typename TOut>
__global__ void __launch_bounds__(kThreads)
    tconv_reduce(const float* __restrict__ ws, const float* __restrict__ bias,
                 TOut* __restrict__ out, size_t MN, int N, int splits, int relu) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += ws[(size_t)z * MN + i];
    if (bias != nullptr) v += bias[i % N];
    if (relu && v < 0.f) v = 0.f;
    out[i] = boda::from_f32<TOut>(v);
  }
}

template <typename TIn, typename TOut, bool kVec>
int launch(const void* x, const void* w, const void* bias, void* out, void* ws,
           const ConvShape& s, int splits, int relu, cudaStream_t stream) {
  const dim3 grid((s.M + kTile - 1) / kTile, (s.N + kTile - 1) / kTile, splits);
  float* wsf = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const float* b = static_cast<const float*>(bias);
  TOut* o = static_cast<TOut*>(out);
  if constexpr (sizeof(TIn) == 2) {
    static bool attr_set = false;  // per instantiation
    if (!attr_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          tconv_bf16_kernel<TOut, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem16);
      if (e != cudaSuccess) return static_cast<int>(e);
      attr_set = true;
    }
    tconv_bf16_kernel<TOut, kVec><<<grid, kThreads, kSmem16, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), b, o, wsf,
        s, relu);
  } else {
    tconv_f32_kernel<TOut, kVec><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), b, o, wsf, s, relu);
  }
  if (splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t MN = (size_t)s.M * s.N;
    const size_t need = (MN + kThreads - 1) / kThreads;
    const int blocks = need < 8192 ? (int)need : 8192;
    tconv_reduce<TOut><<<blocks, kThreads, 0, stream>>>(wsf, b, o, MN, s.N, splits, relu);
  }
  return static_cast<int>(cudaGetLastError());
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
