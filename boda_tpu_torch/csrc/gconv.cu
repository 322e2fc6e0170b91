// gconv (B8): the grouped conv in bf16 with f32 sums, NHWC in and out, with
// the bias, ReLU and bf16 store fused into its epilogue. Hand-written for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no grouped conv. It runs the
// grouped 3x3s of ResNeXt (xla_conv steps whose sig carries groups > 1,
// under prec=bf16 with NHWC storage): in g groups, output channel o sums
// over the channels of its own group alone,
//   y[n,oy,ox,o] = bf16(relu?(f32(sum_{ky,kx,c} x[n, oy*sy+ky-py, ox*sx+kx-px,
//                                                 (o / og) * cg + c] * w[o,ky,kx,c])
//                                 + bias[o]))
// with cg = og = C / g channels a group; bf16 products exact, summed in f32 by
// mma.sync m16n8k16; the bias added in f32 with no contraction; one rounding
// to bf16 (B7's epilogue, csrc/bconv.cu).
//
// What bounds it on an H100 SXM (989 TF/s bf16 dense, 3.35 TB/s): its bytes.
// A group's product is an implicit GEMM of M = pixels, N = og, K = 9 cg, so a
// layer does 4.5 og flops per byte of bf16 input and output: 18 at ResNeXt-101
// (64x4d)'s res2 (og = 4) to 144 at res5 (og = 32), under the card's ridge of
// about 295. B7 does not fit it: wgmma's least N (8) and K (16) are larger
// than a group of 4, and its 128-wide tiles are shaped for compute-bound
// layers. So the kernel has to stream x in and y out at the card's rate, and
// everything else has to hide under that stream. The work is cut in tiles of
// ty x tx output pixels of one image over a slab of 64 channels (the slab's
// groups), in and out; a unit is p groups of cg channels whose block-diagonal
// product is one GEMM of cp = p * cg outputs over their cp channels (p = 2
// at cg = 4, the two groups' off-diagonal blocks zero, so no mma column is
// spent on padding; p = 1 from cg = 8 up). Its design, by part:
// - Persistence and the filter held: the grid is one or two blocks an SM
//   (ops/cuda/gconv.gconv_plan), each pinned to one slab, walking that
//   slab's tiles (image, tile row, tile column) in a static stride, so that
//   the blocks of a slab take neighbouring tiles at once and read their
//   halos' overlap from L2. A block loads its slab's filter once, packed on
//   the host in the order the fragments are read (gconv.pack_filter, once
//   per weight): up to cg 16 into registers, each consumer warp holding the
//   B fragments of its 8 or 16 output columns for every k16 step (10
//   registers at cg 4 and 8, 36 at cg 16); from cg 32 up, where that would
//   take 72 and keep an SM to one block (whose warps then could not hide the
//   math under the stream), into shared memory (18 or 36 KB), read at each
//   step. Each warp holds its columns' biases.
// - The ring: the producer warp's lane 0 keeps up to 4 tile halos in flight
//   (the plan's stages), each one TMA load of a box (64 channels, hx, hy, 1)
//   of x's NHWC tensor map at signed coordinates, so the hardware zero-fills
//   the padding and past the image's edges, with full/empty mbarriers
//   (tma_pipe.cuh). TMA, not cp.async: a halo is one instruction of one
//   thread, each dimension of its box is within TMA's 256, and a pixel's 64
//   bf16 are exactly one row of the 128-byte swizzle, so the rows of a
//   fragment fall in other banks with no padding. Where a stride-1 tile
//   spans the output's width, the box's rows are widened to tx modulo 8, so
//   that the 8 rows of an ldmatrix that cross a tile row's end fall in other
//   banks too (the extra columns lie past the image: zero fill, no reads).
// - ldmatrix without a tap table: 8 consumer warps read A straight from the
//   staged halo by ldmatrix.x4, each lane giving its own fragment row's
//   address at the tap (a pixel of the halo, a 16-byte chunk of the unit's
//   channels, swizzled). The rows' halo offsets are a table made once per
//   block (the tile's shape never changes) and read once per fragment; the
//   taps' offsets are registers made once per block; the k loop is unrolled
//   at compile time over 9 taps (the packed filter is zero past a conv's
//   own), with no division in it. At cg = 4 and 8 a k16 step is two taps of
//   8 channels, from cg = 16 up one tap's 16. A warp takes two m16 fragments
//   at a time, so two mma chains run side by side.
// - The TMA store: the epilogue (the f32 bias by __fadd_rn, the ReLU, one
//   rounding to bf16) writes one of two swizzled staging tiles; the producer
//   warp joins the consumers' barrier at the tile's end and stores the tile
//   by a TMA tensor store (box 64 channels, tx, ty, 1), which clips the
//   ragged edge, so no consumer stalls starting a copy. The store runs on
//   under the next tile's math; before the barrier the producer waits until
//   the store of the tile before has read the other staging tile, which the
//   consumers write next.
// What bounds it then: the stream, and shared memory's 128 bytes a clock.
// ldmatrix reads each staged input row once a tap (about 9 times the input,
// beside the TMA's writes and the store's reads), so the layers through res4
// run at 1.1-1.3 times a device copy of the same bytes on an H100 SXM, held
// by shared memory and DRAM together; res5 (cg 32, 144 flops a byte) is held
// by the math.
// The zero blocks of a unit and the padding of K take x's finite values
// times 0: an Inf or NaN input reaches the sums of the other group of its
// unit (and a tap past a smaller filter's), which cuDNN's grouped conv would
// not; a net's finite activations never show it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_gemm.cuh"
#include "tma_pipe.cuh"

namespace {

namespace tma = boda::tma;
using boda::hopper::align_1024;
using boda::hopper::fence_proxy_async;
using boda::hopper::smem_addr;

constexpr int kConsumers = 8;                    // consumer warps
constexpr int kThreads = (kConsumers + 1) * 32;  // and one producer warp
constexpr int kSlab = 64;                        // channels of a block's slab, in and out
constexpr int kPixel = 128;                      // bytes of a pixel's slab: one swizzled row
constexpr int kMaxTaps = 9;
constexpr int kMaxStages = 4;

// An instance's geometry, from its group width.
template <int CG>
struct Inst {
  static constexpr int P = CG < 8 ? 8 / CG : 1;  // groups of a unit
  static constexpr int CP = P * CG;              // a unit's channels, in and out
  static constexpr int NW = CP >= 16 ? 2 : 1;    // n8 fragments of a warp
  static constexpr int G = 8 / NW;               // column groups of a slab
  static constexpr int S = kConsumers / G;       // warps that split a column group's pixels
  static constexpr int KS = (kMaxTaps * CP + 15) / 16;  // k16 steps of a unit
  // the filter in registers (2 NW KS of them), or from cg 32 up, where that
  // would keep an SM to one block, in shared memory: the slab's, KS KB
  static constexpr bool kRegs = CG <= 16;
  static constexpr int kFilterBytes = kRegs ? 0 : 8 * KS * 32 * 8;
};

struct GShape {
  int sy, sx, py, px, kx, taps;
  int ty, tx, hy, hx, tiles_y, tiles_x;
  int slabs, tiles;  // slabs of C; tiles of a slab (n * tiles_y * tiles_x)
  int per_slab;      // blocks of a slab
  int npix, pairs;   // pixels of a tile; pairs of its m16 fragments
  int stages, stage_bytes, stg_bytes;
  int relu;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory, from a 1024-byte boundary: the ring (stages halos of hy x hx
// pixels, each stage_bytes), the two staging tiles (npix pixels, each
// stg_bytes), the slab's filter where it is not in registers, the fragment
// rows' table (pairs * 32 halo rows) and the ring's full and empty mbarriers.
// wp: the packed filter, [slabs][8 n8 fragments][KS k16 steps][32 lanes] of
// (b0, b1) (gconv.pack_filter); bias f32 [C] or null.
template <int CG>
__global__ void __launch_bounds__(kThreads, 2)
    gconv_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap ymap, const uint2* __restrict__ wp,
                 const float* __restrict__ bias, GShape s) {
  using I = Inst<CG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t ring = smem_addr(smem);
  uint8_t* stg = smem + s.stages * s.stage_bytes;
  uint2* wsm = reinterpret_cast<uint2*>(stg + 2 * s.stg_bytes);
  int* rowtab = reinterpret_cast<int*>(stg + 2 * s.stg_bytes + I::kFilterBytes);
  const uint32_t full0 = smem_addr(rowtab + s.pairs * 32), empty0 = full0 + 8 * s.stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slab = blockIdx.x % s.slabs, first = blockIdx.x / s.slabs;
  const int nt = (s.tiles - first + s.per_slab - 1) / s.per_slab;  // the block's tiles

  if constexpr (!I::kRegs) {
    // the slab's filter, for the block's life
    const uint4* src = reinterpret_cast<const uint4*>(wp) + (size_t)slab * (I::kFilterBytes / 16);
    for (int i = threadIdx.x; i < I::kFilterBytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(wsm)[i] = src[i];
  }
  // each fragment row's halo row at tap 0 (row 0 past the tile's pixels)
  for (int i = threadIdx.x; i < s.pairs * 32; i += kThreads)
    rowtab[i] = i < s.npix ? (i / s.tx) * s.sy * s.hx + (i % s.tx) * s.sx : 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < s.stages; ++i) {
      tma::mbar_init(full0 + 8 * i, 1);
      tma::mbar_init(empty0 + 8 * i, kConsumers);
    }
    tma::fence_mbar_init();
  }
  __syncthreads();

  if (warp == kConsumers) {
    // the producer warp: its lane 0 keeps the ring's halos loading up to
    // `stages` tiles ahead of the consumers, and stores each tile the
    // consumers have staged (the barrier at its end), once the store of the
    // tile before has read the other staging tile, which the consumers
    // write next. No consumer stalls starting a copy.
    if (lane == 0) {
      tma::prefetch_map(&xmap);
      tma::prefetch_map(&ymap);
    }
    const uint32_t bytes = s.hy * s.hx * kPixel;
    for (int i = 0, jl = 0, t = first; i < nt; ++i, t += s.per_slab) {
      for (; jl < nt && jl < i + s.stages; ++jl) {
        const int st = jl % s.stages, tl = first + jl * s.per_slab;
        const int txi = tl % s.tiles_x, r = tl / s.tiles_x;
        tma::mbar_wait(empty0 + 8 * st, ((jl / s.stages) & 1) ^ 1);
        if (lane == 0) {
          tma::mbar_expect_tx(full0 + 8 * st, bytes);
          tma::tma_load_4d(ring + st * s.stage_bytes, &xmap, slab * kSlab,
                           txi * s.tx * s.sx - s.px, (r % s.tiles_y) * s.ty * s.sy - s.py,
                           r / s.tiles_y, full0 + 8 * st);
        }
      }
      if (lane == 0) tma::bulk_wait_read<0>();
      __syncwarp();
      tma::named_sync(1, kThreads);  // tile i is staged
      if (lane == 0) {
        const int txi = t % s.tiles_x, r = t / s.tiles_x;
        tma::tma_store_4d(&ymap, slab * kSlab, txi * s.tx, (r % s.tiles_y) * s.ty, r / s.tiles_y,
                          smem_addr(stg + (i & 1) * s.stg_bytes));
        tma::bulk_commit();
      }
    }
    // the last store has read its staging tile before the block's shared
    // memory goes
    if (lane == 0) tma::bulk_wait_all();
    return;
  }

  // a consumer warp: n8 fragments nf0 .. nf0 + NW of the slab's 64 outputs
  // (in unit u), over the fragment pairs split, split + S, ... of each tile
  const int nf0 = (warp % I::G) * I::NW, split = warp / I::G;
  const int u = nf0 * 8 / I::CP;
  const int g = lane >> 2, q = lane & 3;
  const int hi = lane >> 4;                // the k8 half of the lane's ldmatrix row
  const int mr = (lane & 7) + (lane & 8);  // and that row of the m16 fragment

  // the warp's filter, for the block's life: the B fragments of each k16
  // step in registers (up to cg 16), else read at each step from the slab's
  // filter in shared memory
  uint2 bw[I::kRegs ? I::NW : 1][I::kRegs ? I::KS : 1];
  const uint2* wsrc = wp + (size_t)(slab * 8 + nf0) * I::KS * 32 + lane;
  const uint2* wsh = wsm + nf0 * I::KS * 32 + lane;
  if constexpr (I::kRegs) {
#pragma unroll
    for (int j = 0; j < I::NW; ++j)
#pragma unroll
      for (int ks = 0; ks < I::KS; ++ks) bw[j][ks] = wsrc[(j * I::KS + ks) * 32];
  }
  // the columns' biases, -0.0 where there is none (x + -0.0 is x, signed
  // zeros too)
  float2 bz[I::NW];
#pragma unroll
  for (int j = 0; j < I::NW; ++j) {
    const int n = slab * kSlab + (nf0 + j) * 8 + 2 * q;
    bz[j] = bias != nullptr ? make_float2(bias[n], bias[n + 1]) : make_float2(-0.f, -0.f);
  }
  // where the lane's ldmatrix row lies at step ks, from its fragment row's
  // halo row at tap 0: 8 x the tap's halo rows + the 16-byte chunk of the
  // unit's channels (taps past the filter's: row 0, their filter zero)
  int koff[I::KS];
#pragma unroll
  for (int ks = 0; ks < I::KS; ++ks) {
    const int k8 = 2 * ks + hi;
    const int tap = k8 * 8 / I::CP, c8 = k8 % (I::CP / 8);
    const int toff = tap < s.taps ? (tap / s.kx) * s.hx + tap % s.kx : 0;
    koff[ks] = toff * 8 + u * (I::CP / 8) + c8;
  }

  for (int i = 0; i < nt; ++i) {
    const int st = i % s.stages;
    const uint32_t xs = ring + st * s.stage_bytes;
    uint8_t* ob = stg + (i & 1) * s.stg_bytes;
    tma::mbar_wait(full0 + 8 * st, (i / s.stages) & 1);
    for (int p = split; p < s.pairs; p += I::S) {
      int r8[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) r8[h] = rowtab[(2 * p + h) * 16 + mr] * 8;
      float acc[2][I::NW][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < I::NW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < I::KS; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // row v >> 3, chunk v & 7, swizzled by the row as TMA wrote it
          const int v = r8[h] + koff[ks];
          ldsm_x4(a[h], xs + ((v ^ ((v >> 3) & 7)) << 4));
        }
#pragma unroll
        for (int j = 0; j < I::NW; ++j) {
          uint2 b;
          if constexpr (I::kRegs)
            b = bw[j][ks];
          else
            b = wsh[(j * I::KS + ks) * 32];
#pragma unroll
          for (int h = 0; h < 2; ++h) mma_bf16(acc[h][j], a[h], b.x, b.y);
        }
      }
      // the epilogue into the staging tile: bias, ReLU, one rounding
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = (2 * p + h) * 16 + g + 8 * e;
          if (m >= s.npix) continue;
#pragma unroll
          for (int j = 0; j < I::NW; ++j) {
            float v0 = __fadd_rn(acc[h][j][2 * e], bz[j].x);
            float v1 = __fadd_rn(acc[h][j][2 * e + 1], bz[j].y);
            if (s.relu) {
              if (v0 < 0.f) v0 = 0.f;
              if (v1 < 0.f) v1 = 0.f;
            }
            *reinterpret_cast<__nv_bfloat162*>(ob + m * kPixel + (((nf0 + j) ^ (m & 7)) << 4) +
                                               q * 4) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
    // the warp is done with the stage, which the producer may load again,
    // and its part of the tile is staged (its writes seen by the TMA store)
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(empty0 + 8 * st);
    tma::named_sync(1, kThreads);
  }
}

template <int CG>
int launch(const CUtensorMap& xmap, const CUtensorMap& ymap, const void* wp, const float* bias,
           const GShape& s, long smem, cudaStream_t stream) {
  smem += Inst<CG>::kFilterBytes;
  if (smem > 227L * 1024) return static_cast<int>(cudaErrorInvalidConfiguration);
  static bool smem_set = false;  // per instantiation
  const cudaError_t e = allow_smem(gconv_kernel<CG>, 227 * 1024, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  gconv_kernel<CG><<<s.slabs * s.per_slab, kThreads, (int)smem, stream>>>(
      xmap, ymap, static_cast<const uint2*>(wp), bias, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: bf16 NHWC [n, H, W, C], 16-byte aligned; wp: B8's packed filter of a
// bf16 OHWI [C, ky, kx, C / groups] (ops/cuda/gconv.pack_filter); bias: f32
// [C] or null; y: bf16 NHWC [n, oy, ox, C], 16-byte aligned, oy = (H + 2*py -
// ky) / sy + 1 (ox alike). Groups of cg = C / groups channels in and out, cg
// one of 4, 8, 16, 32, 64, C a multiple of 64, at most 9 taps. The plan
// (ops/cuda/gconv.gconv_plan): ty x tx output pixels a tile, a ring of
// `stages` halos, per_slab blocks walking each slab's tiles. The caller keeps
// every extent under 2^31. Returns the launch's cudaGetLastError(),
// cudaErrorInvalidValue for a shape or plan it has no instance for,
// cudaErrorInvalidConfiguration where the block's shared memory passes 227
// KB, or tma::kEncodeError + the CUresult of a tensor map cuTensorMapEncodeTiled refused.
extern "C" int boda_gconv(const void* x, const void* wp, const void* bias, void* y, int n, int H,
                          int W, int C, int groups, int ky, int kx, int sy, int sx, int py,
                          int px, int ty, int tx, int hx, int stages, int per_slab, int relu,
                          void* stream) {
  if (groups < 2 || C % groups != 0 || C % kSlab != 0 || ty < 1 || tx < 1 || ky < 1 ||
      kx < 1 || ky * kx > kMaxTaps || sy < 1 || sx < 1 || stages < 2 || stages > kMaxStages ||
      per_slab < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GShape s;
  s.sy = sy;
  s.sx = sx;
  s.py = py;
  s.px = px;
  s.kx = kx;
  s.taps = ky * kx;
  const int oy = (H + 2 * py - ky) / sy + 1, ox = (W + 2 * px - kx) / sx + 1;
  s.ty = ty;
  s.tx = tx;
  s.hy = (ty - 1) * sy + ky;
  s.hx = hx;
  if (hx < (tx - 1) * sx + kx || s.hy > 256 || s.hx > 256 || ty > 256 || tx > 256)
    return static_cast<int>(cudaErrorInvalidValue);  // past a TMA box's dimension
  s.tiles_y = (oy + ty - 1) / ty;
  s.tiles_x = (ox + tx - 1) / tx;
  s.slabs = C / kSlab;
  s.tiles = n * s.tiles_y * s.tiles_x;
  s.per_slab = per_slab;
  if (per_slab > s.tiles) return static_cast<int>(cudaErrorInvalidValue);
  s.npix = ty * tx;
  s.pairs = (s.npix + 31) / 32;
  s.stages = stages;
  s.stage_bytes = (s.hy * s.hx * kPixel + 1023) / 1024 * 1024;
  s.stg_bytes = (s.npix * kPixel + 1023) / 1024 * 1024;
  s.relu = relu;
  // as gconv_plan counts it: 1 KB to align, the ring, the staging, (the
  // filter, by instance,) the rows' table, the barriers
  const long smem = 1024L + (long)stages * s.stage_bytes + 2L * s.stg_bytes + s.pairs * 128L +
                    16L * stages;
  CUtensorMap xmap, ymap;
  int rc = tma::encode_nhwc_bf16(&xmap, x, n, H, W, C, s.hx, s.hy);
  if (rc != 0) return rc;
  rc = tma::encode_nhwc_bf16(&ymap, y, n, oy, ox, C, s.tx, s.ty);
  if (rc != 0) return rc;
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C / groups) {
    case 4:
      return launch<4>(xmap, ymap, wp, bf, s, smem, st);
    case 8:
      return launch<8>(xmap, ymap, wp, bf, s, smem, st);
    case 16:
      return launch<16>(xmap, ymap, wp, bf, s, smem, st);
    case 32:
      return launch<32>(xmap, ymap, wp, bf, s, smem, st);
    case 64:
      return launch<64>(xmap, ymap, wp, bf, s, smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
