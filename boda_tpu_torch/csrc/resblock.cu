// resblock: the fused identity bottleneck of ResNet, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of boda_tpu/ops/pallas/resblock.py:31, build_resblock
// and its body `kern` (:98-135), which DMAs a haloed NHWC row band into VMEM
// and runs the whole block there. Same function and the same roundings (those
// of the kernel body, not of its `fallback`):
//   h1 = relu(x . W1^T + b1), zero outside the image, stored in the compute type;
//   h2 = relu(conv3x3(h1) + b2), accumulated in f32, stored in the compute type;
//   y  = h2 . W3^T + b3 + x, ReLU if relu_out, one rounding to the output type.
// x, the weights and the biases all arrive in the compute type (f32 or bf16);
// W2 arrives in OHWI order, [Cm, 3, 3, Cm], which is row-major [Cm, 9 Cm] with
// K in tap-major, channel-minor order.
//
// How the activations stay out of device memory: a cluster of `cs` blocks owns
// one image band of `ty` output rows. Phase 1 computes h1 over the band's
// (ty+2) x (W+2) haloed window into shared memory; its ring outside the image
// is the 3x3's zero padding. Phase 2 computes h2 over ty x W x Cm into shared
// memory, its im2col operand read straight from h1. Phase 3 streams W3 and
// writes the band's output rows. x is read in phase 1 (with the halo rows) and
// again for the shortcut in phase 3, shortly after, from L2.
//
// What bounds it on an H100 SXM (989 TF/s bf16 dense, 67 TF/s FP32, 3.35 TB/s):
// a bottleneck carries 2*(2*C*Cm + 9*Cm^2) flop per pixel, 13.97 GFLOP per
// ResNet-50 block at batch 32, against one read of x and one write of y. In
// f32 the operations bound it everywhere (0.209 ms). In bf16 the operations
// (0.014 ms) and the activations' bytes (res2: 0.031 ms) are close, and what a
// fused kernel adds comes on top: phase 1 runs (ty+2)*(W+2) pixels for ty*W
// outputs, a band's pixels are padded to whole tiles, and every band streams
// all three weight matrices from L2 (8.9 MB in bf16 at res5, where a whole
// image is 49 pixels): at res2/res3 the tensor-core and FFMA rates set the
// pace, at res4/res5 the weight stream and the cluster's exchange do.
//
// What the design does about it:
//  1. bf16 runs the three products on the tensor-core route of the GEMM core
//     (hopper_gemm.cuh: cp.async ring, 128-byte swizzle, wgmma from shared
//     memory). h1 and h2 live in shared memory in the ring's own layout,
//     [Cm / 64][rows][128 bytes] swizzled by row % 8. Phase 1 stages the
//     haloed band of x with zero-filling 16-byte copies. Phase 2's K chunk of
//     64 lies inside one tap (Cm % 64 == 0), so its A rows are 128-byte rows
//     of h1 shifted by the tap: the loader copies them into the ring stage.
//     Phase 3's wgmma reads h2 in place; only W3 streams through the ring.
//     A block tile is 128 x BN (each warpgroup 64 rows), or 64 x 128 with the
//     two warpgroups splitting the columns where a band holds few pixels, so
//     that a 49-pixel image is one 64-row tile. All tiles of a phase run as
//     one pipeline (ring_passes): a tile's first copies are in flight while
//     the tile before it runs its epilogue. The epilogues work out a row's
//     pixel once, not once per accumulator, and phase 3 reads x and writes a
//     bf16 output 16 bytes a lane (the lanes of a quad trade column pairs
//     for whole groups of 8 channels): before that, the epilogues' integer
//     divisions and 4-byte accesses took more time than the products.
//  2. Channel-split clusters fill the card where an image band is all of a
//     small image (res4, res5, batch 1): block r of the cluster computes
//     output channels [r N / cs, (r+1) N / cs) of each phase and writes its
//     slice of h1, then h2, into every block's shared memory (wgmma cannot
//     read another block's), then the cluster synchronises. Each block holds
//     all of h1 and h2 for the next phase's K and streams 1 / cs of each
//     weight matrix: weight traffic per band stays one read.
//  3. One block per SM where that is what fits: the ring overlaps the copies
//     with the products inside a block. The planner (ops/cuda/resblock.py,
//     resblock_plan) picks ty, the cluster size and the tile from the shape
//     and the SM count.
//  4. f32, and shapes whose channels are not multiples of 64, run the same
//     skeleton on the core's FFMA route (128 x BN tiles, full FP32, never
//     TF32), with h1 and h2 row-major in shared memory and the same clusters;
//     channels that are not multiples of 4 are staged element by element.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace boda::hopper;
using bf16 = __nv_bfloat16;

constexpr size_t kMaxSmem = 232448;  // dynamic + static shared memory of a block

struct BlockShape {
  int H, W, C, Cm;  // image rows and cols, block channels, bottleneck channels
  int ty;           // output rows per band
  int nbands;       // bands per image: ceil(H / ty)
  int wp;           // haloed band width: W + 2
  int cs;           // blocks of the cluster that shares a band
};

// Haloed pixel m = r*wp + c of the band at y0 is image pixel (y0 - 1 + r,
// c - 1); false where that lies outside the image (the 3x3's zero padding).
__device__ __forceinline__ bool in_image(const BlockShape& s, int y0, int m, int& iy, int& ix) {
  const int r = m / s.wp;
  iy = y0 - 1 + r;
  ix = m - r * s.wp - 1;
  return iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
}

// Orders this thread's shared-memory stores, its own block's or another's,
// before the asynchronous proxy's reads (wgmma) that follow the next barrier.
__device__ __forceinline__ void fence_proxy_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// ---------------------------------------------------------------- bf16: tensor cores

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of channels n, n + 1 (n even) of row m of an activation held as
// [Cm / 64][rows][128 bytes], each 128-byte row swizzled as a ring stage's.
__device__ __forceinline__ uint32_t act_off(int rows, int m, int n) {
  return (uint32_t)((n >> 6) * rows) * kRowBytes + swz(m, (n & 63) >> 3) + (n & 7) * 2;
}

// The accumulators of a thread (the fragment layout of hopper_gemm.cuh's
// for_pairs): for the column group i of 8 and the row half h, acc[4i + 2h]
// and acc[4i + 2h + 1] are columns 8i + frag_col(), + 1 of row frag_row() +
// 8h of the warpgroup's 64-row tile.
__device__ __forceinline__ int frag_row() {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int frag_col() { return (threadIdx.x & 3) * 2; }

__device__ __forceinline__ float2 bf16_pair(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 bf16_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Transposes the 4 x 4 matrix that the four lanes of a quad hold as a[0..3]
// each: lane l ends with what lanes 0..3 held in their a[l]. With it a lane
// trades the one column pair it owns in each of four column groups for the
// four pairs (8 channels, 16 bytes) of one group. All 32 lanes must call it.
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4]) {
  const bool b0 = threadIdx.x & 1, b1 = threadIdx.x & 2;
  uint32_t t;
  t = __shfl_xor_sync(0xffffffffu, b0 ? a[0] : a[1], 1);
  if (b0) a[0] = t; else a[1] = t;
  t = __shfl_xor_sync(0xffffffffu, b0 ? a[2] : a[3], 1);
  if (b0) a[2] = t; else a[3] = t;
  t = __shfl_xor_sync(0xffffffffu, b1 ? a[0] : a[2], 2);
  if (b1) a[0] = t; else a[2] = t;
  t = __shfl_xor_sync(0xffffffffu, b1 ? a[1] : a[3], 2);
  if (b1) a[1] = t; else a[3] = t;
}

// kSplitN false: 128 x BN tiles, warpgroup w rows 64w .. 64w+63 of a tile.
// kSplitN true: 64 x BN tiles, warpgroup w columns w BN/2 .. of a tile.
// Shared memory: the ring, then h2 [Cm/64][rows2 padded to whole tiles][128 B]
// (wgmma reads it in place), then h1 [Cm/64][rows1][128 B].
template <typename TOut, int BN, bool kSplitN>
__global__ void __launch_bounds__(kThreads, 1)
    resblock_mma(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                 const bf16* __restrict__ b2, const bf16* __restrict__ w3,
                 const bf16* __restrict__ b3, TOut* __restrict__ out, BlockShape s,
                 int relu_out) {
  constexpr int TM = kSplitN ? 64 : kTileM;
  constexpr int NA = kSplitN ? BN / 4 : BN / 2;
  constexpr int kRows = TM / 32;  // A rows each thread stages per chunk
  using R = Ring<BN, TM>;
  extern __shared__ __align__(16) uint8_t smem_mma[];
  uint8_t* smem = align_1024(smem_mma);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = s.cs;
  const int rank = (int)cluster.block_rank();
  const int band = blockIdx.x / cs;
  const int img = band / s.nbands;
  const int y0 = (band - img * s.nbands) * s.ty;
  const int rows1 = (s.ty + 2) * s.wp;
  const int rows2 = s.ty * s.W;
  const int rows2p = (rows2 + TM - 1) / TM * TM;
  const int planes = s.Cm / 64;
  uint8_t* h2 = smem + kStages * R::kStageBytes;
  uint8_t* h1 = h2 + (size_t)planes * rows2p * kRowBytes;
  const int wg = threadIdx.x >> 7;
  const int row_off = kSplitN ? 0 : wg * 64;        // of this warpgroup in a tile
  const int col_off = kSplitN ? wg * (BN / 2) : 0;
  const int j = threadIdx.x & 7;    // 16-byte chunk this thread stages
  const int tr = threadIdx.x >> 3;  // and its rows tr + 32 i
  const int fr = frag_row(), fc = frag_col();
  const auto ring_a = [&](int st, int, int) { return smem_addr(R::a(smem, st)); };
  float acc[NA];
  uint32_t pk[NA / 2];  // a pass's results in bf16: pk[2i + h] of acc[4i + 2h], + 1
  // Stores pk into activation `act` ([Cm / 64][stride][128 B]) of every block
  // of the cluster: rows m, m + 8 below `rows`, channels n + 8i below ne.
  const auto store_act = [&](uint8_t* act, int stride, int rows, int m, int n, int ne,
                             const uint32_t (&pk)[NA / 2]) {
    for (int to = 0; to < cs; ++to) {
      uint8_t* dst = cluster.map_shared_rank(act, to);
#pragma unroll
      for (int i = 0; i < NA / 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (m + 8 * h < rows && n + 8 * i < ne)
            *reinterpret_cast<uint32_t*>(dst + act_off(stride, m + 8 * h, n + 8 * i)) =
                pk[2 * i + h];
    }
  };

  // every block of the cluster runs before any writes into its shared memory
  cluster.sync();

  // Each phase is one pipeline of passes (ring_passes): pass p is the tile at
  // rows m0 = TM (p / ntn) and channels n0 = nb + BN (p % ntn), nb .. ne - 1
  // being this block's channels.

  // phase 1: h1 = relu(x . W1^T + b1) over the haloed band, zero outside the
  // image, this block's Cm / cs channels into every block of the cluster
  {
    const int per = s.Cm / cs, nb = rank * per, ne = nb + per;
    const int ntn = (per + BN - 1) / BN;
    int xoff[kRows];  // this thread's pixels of the pass being staged in x,
    int n0l = 0;      // -1 outside the image; and that pass's first channel
    ring_passes<BN, kSplitN>(
        smem, (rows1 + TM - 1) / TM * ntn, 0, s.C / 64,
        [&](int st, int p, int kc) {
          if (kc == 0) {
            const int mi = p / ntn;
            n0l = nb + (p - mi * ntn) * BN;
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const int m = mi * TM + tr + 32 * i;
              int iy, ix;
              xoff[i] = (m < rows1 && in_image(s, y0, m, iy, ix))
                            ? ((img * s.H + iy) * s.W + ix) * s.C
                            : -1;
            }
          }
          const uint32_t sa = smem_addr(R::a(smem, st));
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const bool v = xoff[i] >= 0;
            cp_async16(sa + swz(tr + 32 * i, j), v ? x + xoff[i] + kc * 64 + j * 8 : x, v);
          }
          stage_rows<BN, true>(w1, ne, s.C, n0l, kc, smem_addr(R::b(smem, st)), R::b(smem, st));
        },
        ring_a,
        [&](int p) {
          const int mi = p / ntn;
          const int m0 = mi * TM + row_off + fr, n0 = nb + (p - mi * ntn) * BN + col_off + fc;
          bool in[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int iy, ix;
            in[h] = m0 + 8 * h < rows1 && in_image(s, y0, m0 + 8 * h, iy, ix);
          }
#pragma unroll
          for (int i = 0; i < NA / 4; ++i) {
            const int n = n0 + 8 * i;
            const float2 b = n < ne ? bf16_pair(b1 + n) : make_float2(0.f, 0.f);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              pk[2 * i + h] = in[h] ? pack_bf16(fmaxf(acc[4 * i + 2 * h] + b.x, 0.f),
                                                fmaxf(acc[4 * i + 2 * h + 1] + b.y, 0.f))
                                    : 0u;
          }
          store_act(h1, rows1, rows1, m0, n0, ne, pk);
        },
        acc);
  }
  fence_proxy_async_all();
  cluster.sync();  // h1 complete in every block

  // phase 2: h2 = relu(conv3x3(h1) + b2) over the band's ty x W pixels. K
  // chunk kc is tap kc / planes, channels 64 (kc % planes) ..: row m of A is
  // the 128-byte row of h1's pixel (m / W + yy, m % W + xx) in that plane.
  {
    const int per = s.Cm / cs, nb = rank * per, ne = nb + per;
    const int ntn = (per + BN - 1) / BN;
    int p0[kRows];  // this thread's pixels of the pass being staged: their
    int n0l = 0;    // tap (0, 0) in h1; and that pass's first channel
    ring_passes<BN, kSplitN>(
        smem, rows2p / TM * ntn, 0, 9 * planes,
        [&](int st, int p, int kc) {
          if (kc == 0) {
            const int mi = p / ntn;
            n0l = nb + (p - mi * ntn) * BN;
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const int m = min(mi * TM + tr + 32 * i, rows2 - 1);
              const int tyy = m / s.W;
              p0[i] = tyy * s.wp + (m - tyy * s.W);
            }
          }
          const int tap = kc / planes;
          const int yy = tap / 3;
          const int shift = yy * s.wp + (tap - 3 * yy);
          const uint8_t* src = h1 + (size_t)(kc - tap * planes) * rows1 * kRowBytes;
          uint8_t* sa = R::a(smem, st);
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            *reinterpret_cast<uint4*>(sa + swz(tr + 32 * i, j)) =
                *reinterpret_cast<const uint4*>(src + swz(p0[i] + shift, j));
          stage_rows<BN, true>(w2, ne, 9 * s.Cm, n0l, kc, smem_addr(R::b(smem, st)),
                               R::b(smem, st));
        },
        ring_a,
        [&](int p) {
          const int mi = p / ntn;
          const int m0 = mi * TM + row_off + fr, n0 = nb + (p - mi * ntn) * BN + col_off + fc;
#pragma unroll
          for (int i = 0; i < NA / 4; ++i) {
            const int n = n0 + 8 * i;
            const float2 b = n < ne ? bf16_pair(b2 + n) : make_float2(0.f, 0.f);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              pk[2 * i + h] = pack_bf16(fmaxf(acc[4 * i + 2 * h] + b.x, 0.f),
                                        fmaxf(acc[4 * i + 2 * h + 1] + b.y, 0.f));
          }
          store_act(h2, rows2p, rows2, m0, n0, ne, pk);
        },
        acc);
  }
  fence_proxy_async_all();
  cluster.sync();  // h2 complete in every block; no block is written into again

  // phase 3: y = h2 . W3^T + b3 + x, ReLU, one rounding, for this block's
  // C / cs channels; wgmma reads h2 where it lies; rows past H are dropped
  {
    const int per = s.C / cs, nb = rank * per, ne = nb + per;
    const int ntn = (per + BN - 1) / BN;
    const uint32_t h2a = smem_addr(h2);
    int n0l = 0;  // the first channel of the pass being staged
    ring_passes<BN, kSplitN>(
        smem, rows2p / TM * ntn, 0, planes,
        [&](int st, int p, int kc) {
          if (kc == 0) n0l = nb + (p % ntn) * BN;
          stage_rows<BN, true>(w3, ne, s.Cm, n0l, kc, smem_addr(R::b(smem, st)),
                               R::b(smem, st));
        },
        [&](int, int p, int kc) {
          return h2a + (uint32_t)(kc * rows2p + p / ntn * TM) * kRowBytes;
        },
        [&](int p) {
          const int mi = p / ntn;
          const int m0 = mi * TM + row_off + fr, n0 = nb + (p - mi * ntn) * BN + col_off;
          size_t o[2];  // this thread's two output pixels in x and out
          bool ok[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + 8 * h;
            const int tyy = m / s.W;
            ok[h] = m < rows2 && y0 + tyy < s.H;
            o[h] = (((size_t)img * s.H + y0 + tyy) * s.W + (m - tyy * s.W)) * s.C;
          }
          // 32 channels at a time: the lane owns a column pair in each of
          // their four groups of 8, and moves the 8 channels (16 bytes) of
          // group threadIdx.x % 4 of x and of a bf16 output. All of the
          // pass's loads of x are issued before the first is used.
          uint4 xq[NA / 16][2];
#pragma unroll
          for (int k = 0; k < NA / 16; ++k)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int cn = n0 + 32 * k + 8 * (threadIdx.x & 3);
              xq[k][h] = make_uint4(0u, 0u, 0u, 0u);
              if (ok[h] && cn < ne) xq[k][h] = *reinterpret_cast<const uint4*>(x + o[h] + cn);
            }
#pragma unroll
          for (int k = 0; k < NA / 16; ++k) {
            const int cn = n0 + 32 * k + 8 * (threadIdx.x & 3);
            float2 b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int n = n0 + 32 * k + 8 * i + fc;
              b[i] = n < ne ? bf16_pair(b3 + n) : make_float2(0.f, 0.f);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t v[4] = {xq[k][h].x, xq[k][h].y, xq[k][h].z, xq[k][h].w};
              quad_transpose(v);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float2 sc = bf16_pair(v[i]);
                float v0 = acc[4 * (4 * k + i) + 2 * h] + b[i].x + sc.x;
                float v1 = acc[4 * (4 * k + i) + 2 * h + 1] + b[i].y + sc.y;
                if (relu_out) {
                  v0 = fmaxf(v0, 0.f);
                  v1 = fmaxf(v1, 0.f);
                }
                if constexpr (sizeof(TOut) == 4) {
                  const int n = n0 + 32 * k + 8 * i + fc;
                  if (ok[h] && n < ne)
                    *reinterpret_cast<float2*>(out + o[h] + n) = make_float2(v0, v1);
                } else {
                  v[i] = pack_bf16(v0, v1);
                }
              }
              if constexpr (sizeof(TOut) == 2) {
                quad_transpose(v);
                if (ok[h] && cn < ne)
                  *reinterpret_cast<uint4*>(out + o[h] + cn) = make_uint4(v[0], v[1], v[2], v[3]);
              }
            }
          }
        },
        acc);
  }
}

// ---------------------------------------------------------------- FFMA route

// v[0..3] = p[k .. k+3] of a run of K values in f32, zero from K on. kVec:
// K % 4 == 0, one wide load.
template <bool kVec, typename T>
__device__ __forceinline__ void quad_of(const T* __restrict__ p, int k, int K, float (&v)[4]) {
  if constexpr (kVec) {
    boda::load_quad(p + k, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = k + e < K ? boda::to_f32(p[k + e]) : 0.f;
  }
}

// The three phases as one loop over 128 x BN tiles of the core's FFMA product
// (one instance of its staging buffers). Dynamic shared memory: h1
// [rows1][Cm], then h2 [rows2][Cm], row-major in the compute type T.
template <typename T, typename TOut, int BN, bool kVec>
__global__ void __launch_bounds__(kThreads)
    resblock_ffma(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                  const T* __restrict__ w2, const T* __restrict__ b2,
                  const T* __restrict__ w3, const T* __restrict__ b3, TOut* __restrict__ out,
                  BlockShape s, int relu_out) {
  extern __shared__ __align__(16) uint8_t smem_ffma[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = s.cs;
  const int rank = (int)cluster.block_rank();
  const int band = blockIdx.x / cs;
  const int img = band / s.nbands;
  const int y0 = (band - img * s.nbands) * s.ty;
  const int rows1 = (s.ty + 2) * s.wp;
  const int rows2 = s.ty * s.W;
  T* h1 = reinterpret_cast<T*>(smem_ffma);
  T* h2 = h1 + (size_t)rows1 * s.Cm;
  const int lr = threadIdx.x >> 1;  // the tile row this thread stages
  float acc[8][BN / 16];

  cluster.sync();  // every block of the cluster runs before any writes into it
  for (int phase = 0; phase < 3; ++phase) {
    const int M = phase == 0 ? rows1 : rows2;
    const int K = phase == 0 ? s.C : phase == 1 ? 9 * s.Cm : s.Cm;
    const T* __restrict__ wmat = phase == 0 ? w1 : phase == 1 ? w2 : w3;
    const T* __restrict__ bias = phase == 0 ? b1 : phase == 1 ? b2 : b3;
    T* hdst = phase == 0 ? h1 : h2;
    const int per = (phase == 2 ? s.C : s.Cm) / cs, nb = rank * per, ne = nb + per;
    for (int m0 = 0; m0 < M; m0 += kTileM) {
      // this thread's A row: a pixel of x (phase 1), the tap (0, 0) pixel of
      // h1 (phase 2), a row of h2 (phase 3); null where it is all zero
      const int ma = m0 + lr;
      const T* arow = nullptr;
      if (ma < M) {
        if (phase == 0) {
          int iy, ix;
          if (in_image(s, y0, ma, iy, ix))
            arow = x + (((size_t)img * s.H + iy) * s.W + ix) * s.C;
        } else if (phase == 1) {
          const int tyy = ma / s.W;
          arow = h1 + (size_t)(tyy * s.wp + (ma - tyy * s.W)) * s.Cm;
        } else {
          arow = h2 + (size_t)ma * s.Cm;
        }
      }
      for (int n0 = nb; n0 < ne; n0 += BN) {
        const T* brow = n0 + lr < ne ? wmat + (size_t)(n0 + lr) * K : nullptr;
        ffma_product<BN, true>(
            0, (K + kBK32 - 1) / kBK32, M - m0,
            [&](int, int k, float (&a)[4], float (&b)[4], bool want_b) {
              a[0] = a[1] = a[2] = a[3] = 0.f;
              if (arow != nullptr && k < K) {
                if (phase != 1) {
                  quad_of<kVec>(arow, k, K, a);
                } else if constexpr (kVec) {  // four channels of one tap
                  const int tap = k / s.Cm;
                  const int yy = tap / 3;
                  boda::load_quad(arow + (yy * s.wp + tap - 3 * yy) * s.Cm + (k - tap * s.Cm), a);
                } else {
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    const int kk = k + e;
                    if (kk >= K) continue;
                    const int tap = kk / s.Cm;
                    const int yy = tap / 3;
                    a[e] = boda::to_f32(
                        arow[(yy * s.wp + tap - 3 * yy) * s.Cm + (kk - tap * s.Cm)]);
                  }
                }
              }
              if (!want_b) return;
              b[0] = b[1] = b[2] = b[3] = 0.f;
              if (brow != nullptr && k < K) quad_of<kVec>(brow, k, K, b);
            },
            acc);
        for_quads<BN>(acc, [&](int r, int c, const float (&v)[4]) {
          const int m = m0 + r;
          if (m >= M) return;
          int iy = 0, ix = 0;
          const bool in = phase != 0 || in_image(s, y0, m, iy, ix);
          const int tyy = m / s.W;
          if (phase == 2 && y0 + tyy >= s.H) return;
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) {
            const int n = n0 + c + jn;
            if (n >= ne) continue;
            float val = v[jn] + boda::to_f32(bias[n]);
            if (phase < 2) {
              const T h = boda::from_f32<T>(in ? fmaxf(val, 0.f) : 0.f);
              T* dst = hdst + (size_t)m * s.Cm + n;
              for (int q = 0; q < cs; ++q) *cluster.map_shared_rank(dst, q) = h;
            } else {
              const size_t o =
                  (((size_t)img * s.H + y0 + tyy) * s.W + (m - tyy * s.W)) * s.C + n;
              val += boda::to_f32(x[o]);
              if (relu_out) val = fmaxf(val, 0.f);
              out[o] = boda::from_f32<TOut>(val);
            }
          }
        });
      }
    }
    if (phase < 2) cluster.sync();  // h1, then h2, complete in every block
  }
}

// ---------------------------------------------------------------- launch

// One instantiation, its static shared memory, and the dynamic shared memory
// it was opted into so far.
struct Kernel {
  const void* fn;
  int static_smem;
  int* allowed;
};

template <typename TOut, int BN, bool kSplitN>
Kernel mma_kernel() {
  static int allowed = 0;
  return {reinterpret_cast<const void*>(&resblock_mma<TOut, BN, kSplitN>), 0, &allowed};
}

template <typename T, typename TOut, int BN, bool kVec>
Kernel ffma_kernel() {
  static int allowed = 0;
  // the core's staging buffers are static shared memory
  return {reinterpret_cast<const void*>(&resblock_ffma<T, TOut, BN, kVec>),
          2 * kBK32 * (kTileM + kPad32 + BN + kPad32) * 4, &allowed};
}

template <typename TOut>
Kernel pick_mma(int tile_m, int tile_n) {
  if (tile_m == 64 && tile_n == 128) return mma_kernel<TOut, 128, true>();
  if (tile_m == 128 && tile_n == 128) return mma_kernel<TOut, 128, false>();
  if (tile_m == 128 && tile_n == 64) return mma_kernel<TOut, 64, false>();
  return {nullptr, 0, nullptr};
}

template <typename T, typename TOut>
Kernel pick_ffma(int tile_n, int vec) {
  if (tile_n != 64 && tile_n != 128) return {nullptr, 0, nullptr};
  if constexpr (sizeof(T) == 4) {
    if (vec) return tile_n == 64 ? ffma_kernel<T, TOut, 64, true>()
                                 : ffma_kernel<T, TOut, 128, true>();
  } else {
    // bf16 comes here only with ragged channels: staged element by element
    if (vec) return {nullptr, 0, nullptr};
  }
  return tile_n == 64 ? ffma_kernel<T, TOut, 64, false>() : ffma_kernel<T, TOut, 128, false>();
}

// How one call runs: the plan of ops/cuda/resblock.py resblock_plan.
struct Plan {
  int cluster, mma, tile_m, tile_n, vec, in_bf16, out_bf16;
};

// The kernel of a plan, its dynamic shared memory and its launch
// configuration on n * nbands clusters; false where the plan or the shape is
// not one the kernels take, or h1 and h2 do not fit.
bool configure(const Plan& pl, const BlockShape& s, int n, cudaStream_t stream, Kernel& k,
               cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  const int cs = pl.cluster;
  if (cs != 1 && cs != 2 && cs != 4 && cs != 8) return false;
  if (s.C % cs != 0 || s.Cm % cs != 0 || s.ty < 1 || s.ty > s.H) return false;
  const size_t rows1 = (size_t)(s.ty + 2) * s.wp, rows2 = (size_t)s.ty * s.W;
  size_t smem;
  if (pl.mma) {
    if (!pl.in_bf16 || s.C % 64 != 0 || s.Cm % 64 != 0 || (s.Cm / cs) % 2 != 0) return false;
    k = pl.out_bf16 ? pick_mma<bf16>(pl.tile_m, pl.tile_n) : pick_mma<float>(pl.tile_m, pl.tile_n);
    const size_t rows2p = (rows2 + pl.tile_m - 1) / pl.tile_m * pl.tile_m;
    smem = 1024 + (size_t)kStages * (pl.tile_m + pl.tile_n) * kRowBytes +
           (size_t)(s.Cm / 64) * (rows1 + rows2p) * kRowBytes;
  } else {
    if (pl.vec && (s.C % 4 != 0 || s.Cm % 4 != 0)) return false;
    if (pl.in_bf16)
      k = pl.out_bf16 ? pick_ffma<bf16, bf16>(pl.tile_n, pl.vec)
                      : pick_ffma<bf16, float>(pl.tile_n, pl.vec);
    else
      k = pl.out_bf16 ? pick_ffma<float, bf16>(pl.tile_n, pl.vec)
                      : pick_ffma<float, float>(pl.tile_n, pl.vec);
    smem = (rows1 + rows2) * s.Cm * (pl.in_bf16 ? 2 : 4);
  }
  if (k.fn == nullptr || smem + k.static_smem > kMaxSmem) return false;
  if ((int)smem > *k.allowed) {
    if (cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess)
      return false;
    *k.allowed = (int)smem;
  }
  cfg = {};
  cfg.gridDim = dim3(n * s.nbands * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return true;
}

BlockShape block_shape(int H, int W, int C, int Cm, int ty, int cluster) {
  BlockShape s;
  s.H = H;
  s.W = W;
  s.C = C;
  s.Cm = Cm;
  s.ty = ty;
  s.nbands = ty > 0 ? (H + ty - 1) / ty : 0;
  s.wp = W + 2;
  s.cs = cluster;
  return s;
}

}  // namespace

// x: NHWC [n, H, W, C]; w1: [Cm, C]; b1: [Cm]; w2: OHWI [Cm, 3, 3, Cm]; b2:
// [Cm]; w3: [C, Cm]; b3: [C]; all of one type, f32 or bf16 (in_bf16). out:
// NHWC [n, H, W, C], f32 or bf16 (out_bf16). The plan of ops/cuda/resblock.py
// resblock_plan: ty, output rows per band, 1..H; cluster, the blocks that
// share a band and split each phase's output channels, 1, 2, 4 or 8, dividing
// C and Cm; mma, the tensor-core route (bf16 with C % 64 == 0, Cm % 64 == 0
// and Cm / cluster even), tile_m x tile_n = 128 x 128, 128 x 64 or 64 x 128,
// else the FFMA route, 128 x tile_n with tile_n 64 or 128 and vec (f32 only:
// C % 4 == 0 and Cm % 4 == 0, 16-byte operand loads). A band's h1 and h2 must
// fit a block's shared memory beside the route's staging buffers. Returns the
// launch's CUDA error code (0 on success).
extern "C" int boda_resblock(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* w3, const void* b3, void* out,
                             int n, int H, int W, int C, int Cm, int ty, int cluster, int mma,
                             int tile_m, int tile_n, int vec, int in_bf16, int out_bf16,
                             int relu_out, void* stream) {
  BlockShape s = block_shape(H, W, C, Cm, ty, cluster);
  const Plan pl = {cluster, mma, tile_m, tile_n, vec, in_bf16, out_bf16};
  Kernel k;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (!configure(pl, s, n, static_cast<cudaStream_t>(stream), k, cfg, attr))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &w1, &b1, &w2, &b2, &w3, &b3, &out, &s, &relu_out};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, k.fn, args);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The clusters of a plan (boda_resblock's arguments) that the card runs at
// once, which the planner's wave count rests on; -1 where boda_resblock would
// refuse the plan or the query fails.
extern "C" int boda_resblock_max_clusters(int H, int W, int C, int Cm, int ty, int cluster,
                                          int mma, int tile_m, int tile_n, int vec,
                                          int in_bf16, int out_bf16) {
  const BlockShape s = block_shape(H, W, C, Cm, ty, cluster);
  const Plan pl = {cluster, mma, tile_m, tile_n, vec, in_bf16, out_bf16};
  Kernel k;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (!configure(pl, s, 1, nullptr, k, cfg, attr)) return -1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, k.fn, &cfg) != cudaSuccess) return -1;
  return clusters;
}
