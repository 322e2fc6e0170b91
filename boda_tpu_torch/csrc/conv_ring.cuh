// The implicit-GEMM conv ring shared by qconv (B6, int8, qconv.cu) and bconv
// (B7, bf16, bconv.cu): the conv's shape, the walk over (tile, K split) units,
// the loaders of A (the conv window) and B (the filter), and the block's
// warp-specialized pipeline, producers to consumers. Each kernel brings its
// own accumulators (int32 or f32) and epilogue.
//
// The GEMM: M = n*oy*ox output pixels by N = oc over K = ky*kx*C in tap-major,
// channel-minor order, 128 x BN tiles (BN = 128, or 64 for B7's narrow convs),
// K in chunks of 128 bytes (128 int8 or 64 bf16 values). Element type E is the
// operands' (int8_t or __nv_bfloat16); every extent below counts elements,
// every copy width and stage offset bytes.
//
// The pipeline. One block per SM, persistent over the (tile, split) units: two
// producer warpgroups keep a 4-stage ring full (each stage's "full" and
// "empty" mbarriers, tma_pipe.cuh) while two consumer warpgroups each run
// wgmma on their 64 rows; the producers run on into the next unit while the
// consumers store a tile. B (the filter, row-major [oc, K]) comes by one TMA
// load per chunk in the 128-byte swizzle the wgmma descriptor reads; so does
// A where the conv is 1x1 with stride 1 and no padding (x is then a row-major
// [M, C] matrix, and one producer thread issues both loads). Else A comes by
// cp.async from the producers' threads, which arrive on the stage's barrier
// as their copies land (cp.async.mbarrier.arrive.noinc). Each producer thread
// copies one 16-byte (or narrower) run of several rows per chunk; each row's
// pixel is worked out once per tile (a shared table), and the tap of the
// thread's run advances by a chunk without a division. Where C * sizeof(E) %
// 16 != 0 a 16-byte run would straddle two taps: the copies are 8 or 4 bytes,
// still zero-filled by cp.async; where no copy fits (C = 3) A is staged
// element by element. B then moves by the same copies where its rows are not
// whole 16-byte runs (TMA needs them).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_gemm.cuh"
#include "tma_pipe.cuh"

namespace boda {
namespace convring {

using namespace boda::hopper;
namespace tma = boda::tma;

constexpr int kTile = 128;                  // block tile rows (output pixels)
constexpr int kRing = 4;                    // stages of the ring
constexpr int kBytesA = kTile * kRowBytes;  // 16 KB of A per stage
constexpr int kProducers = 256;             // warpgroups 0 and 1
constexpr int kBlock = kProducers + 2 * 128;  // and two consumer warpgroups

// The shared memory of a 128 x BN ring: the stages (A then B), the pixel
// table, the barriers, then the kernel's own epilogue staging from kOffEpi.
template <int BN>
struct Layout {
  static_assert(BN == 64 || BN == 128, "tile width");
  static constexpr int kBytesB = BN * kRowBytes;
  static constexpr int kStageBytes = kBytesA + kBytesB;
  static constexpr int kOffPix = kRing * kStageBytes;
  static constexpr int kOffBar = kOffPix + kTile * 16;
  // after the 2 * kRing barriers, on a 1024-byte boundary (a TMA box in
  // the 128-byte swizzle starts on one)
  static constexpr int kOffEpi = (kOffBar + 64 + 1023) / 1024 * 1024;
};

struct ConvShape {
  int M, N, K;     // GEMM rows (n*oy*ox), cols (oc), depth (ky*kx*C)
  int H, W, C;     // input NHWC extents
  int oy, ox;      // output extents
  int ky, kx, sy, sx, py, px;
  int chunks;      // K chunks of 128 bytes
  int tiles_n;     // tiles along N
  int tiles;       // tiles of the output
  int full;        // tiles [0, full) run whole, each one unit (a multiple of tiles_n)
  int splits;      // the rest, tiles [full, tiles), in this many K ranges each
  int va, vb;      // bytes of one copy of A / of B (16, 8, 4, or sizeof(E): element by element)
};

// The shape of x [n, H, W, C] by an [N, ky, kx, C] filter, K in chunks of
// 128 bytes of elements of esize bytes, on tiles 128 x bn.
inline ConvShape conv_shape(int n, int H, int W, int C, int N, int ky, int kx, int sy, int sx,
                            int py, int px, int esize, int bn, int full, int splits, int va,
                            int vb) {
  ConvShape s;
  s.H = H;
  s.W = W;
  s.C = C;
  s.ky = ky;
  s.kx = kx;
  s.sy = sy;
  s.sx = sx;
  s.py = py;
  s.px = px;
  s.oy = (H + 2 * py - ky) / sy + 1;
  s.ox = (W + 2 * px - kx) / sx + 1;
  s.M = n * s.oy * s.ox;
  s.N = N;
  s.K = ky * kx * C;
  const int chunk = kRowBytes / esize;
  s.chunks = (s.K + chunk - 1) / chunk;
  s.tiles_n = (s.N + bn - 1) / bn;
  s.tiles = ((s.M + kTile - 1) / kTile) * s.tiles_n;
  s.full = splits > 1 ? full : s.tiles;
  s.splits = splits;
  s.va = va;
  s.vb = vb;
  return s;
}

// Output pixel m's window: tap (yy, xx), channel c of it is the element
// base + (yy*W + xx)*C + c, inside the image iff 0 <= iy0 + yy < H and
// 0 <= ix0 + xx < W. A row past M gets iy0 far below 0 (never inside).
__device__ __forceinline__ int4 pixel_of(const ConvShape& s, int m) {
  if (m >= s.M) return make_int4(0, -(1 << 30), -(1 << 30), 0);
  const int img = m / (s.oy * s.ox);
  const int rem = m - img * (s.oy * s.ox);
  const int oyy = rem / s.ox;
  const int iy0 = oyy * s.sy - s.py;
  const int ix0 = (rem - oyy * s.ox) * s.sx - s.px;
  return make_int4(((img * s.H + iy0) * s.W + ix0) * s.C, iy0, ix0, 0);
}

// The tap (yy, xx) and channel c of depth k, advanced a chunk (kChunk
// elements) at a time.
template <int kChunk>
struct Tap {
  int c, xx, yy;
  __device__ __forceinline__ void at(const ConvShape& s, int k) {
    const int tap = k / s.C;
    c = k - tap * s.C;
    yy = tap / s.kx;
    xx = tap - yy * s.kx;
  }
  __device__ __forceinline__ void next_chunk(const ConvShape& s) {
    c += kChunk;
    while (c >= s.C) {
      c -= s.C;
      if (++xx == s.kx) xx = 0, ++yy;
    }
  }
};

// Byte offset of byte b of row r in a stage buffer: 16-byte chunk b / 16
// XOR-swizzled by r % 8 (swz of hopper_gemm.cuh, which TMA's 128-byte
// swizzle also writes).
__device__ __forceinline__ uint32_t swz_byte(int r, int b) {
  return (uint32_t)(r * kRowBytes + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15)));
}

// An element's bits, for the element-by-element stores.
template <typename E>
using Raw = typename std::conditional<sizeof(E) == 1, uint8_t, uint16_t>::type;

// Producer thread t's copies of A for one chunk, V bytes each: run j = t %
// (128 / V) of the rows t / (128 / V) + RS * i, RS = kProducers / (128 /
// V) rows a pass; tap the tap of its run. V = sizeof(E): element by element
// into shared memory.
template <int V, typename E, typename T>
__device__ __forceinline__ void stage_a(const ConvShape& s, const E* __restrict__ x,
                                        const int4* pix, const T& tap, uint32_t sa,
                                        uint8_t* sa_p) {
  constexpr int R = kRowBytes / V;    // runs per row
  constexpr int RS = kProducers / R;  // rows per pass
  static_assert(kTile % RS == 0, "whole passes over the tile's rows");
  const int t = threadIdx.x;
  const int b = (t % R) * V;
  const bool kin = tap.yy < s.ky;
  const int toff = (tap.yy * s.W + tap.xx) * s.C + tap.c;
#pragma unroll 8
  for (int i = 0; i < kTile / RS; ++i) {
    const int r = t / R + RS * i;
    const int4 p = pix[r];
    const bool ok = kin && (unsigned)(p.y + tap.yy) < (unsigned)s.H &&
                    (unsigned)(p.z + tap.xx) < (unsigned)s.W;
    if constexpr (V == sizeof(E)) {
      *reinterpret_cast<Raw<E>*>(sa_p + swz_byte(r, b)) =
          ok ? reinterpret_cast<const Raw<E>*>(x)[p.x + toff] : (Raw<E>)0;
    } else {
      tma::cp_async<V>(sa + swz_byte(r, b), ok ? x + p.x + toff : x, ok);
    }
  }
}

// Producer thread t's copies of B (rows n0 .. n0 + BN - 1 of the row-major
// [N, K] filter) for chunk kc where B does not come by TMA.
template <int V, int BN, typename E>
__device__ __forceinline__ void stage_b(const ConvShape& s, const E* __restrict__ w, int n0,
                                        int kc, uint32_t sb, uint8_t* sb_p) {
  constexpr int R = kRowBytes / V;
  constexpr int RS = kProducers / R;
  static_assert(BN % RS == 0, "whole passes over the tile's rows");
  const int t = threadIdx.x;
  const int b = (t % R) * V;
  const int k = (kc * kRowBytes + b) / (int)sizeof(E);
#pragma unroll 8
  for (int i = 0; i < BN / RS; ++i) {
    const int r = t / R + RS * i;
    const int n = n0 + r;
    const bool ok = k < s.K && n < s.N;
    const E* src = ok ? w + (size_t)n * s.K + k : w;
    if constexpr (V == sizeof(E)) {
      *reinterpret_cast<Raw<E>*>(sb_p + swz_byte(r, b)) =
          ok ? *reinterpret_cast<const Raw<E>*>(src) : (Raw<E>)0;
    } else {
      tma::cp_async<V>(sb + swz_byte(r, b), src, ok);
    }
  }
}

// Unit u of the walk: tile (mt, nt) and its chunks [kc0, kc1). The first
// `full` units are tiles 0 .. full - 1, each whole (z = -1); then split z
// of every later tile, the chunks in `splits` ranges whose sizes differ by
// at most one, split 0 of each first.
template <int BN>
struct Unit {
  int z, m0, n0, kc0, kc1;
  __device__ __forceinline__ Unit(const ConvShape& s, int u) {
    int tile = u;
    z = -1;
    kc0 = 0;
    kc1 = s.chunks;
    if (u >= s.full) {
      const int rest = s.tiles - s.full, v = u - s.full;
      z = v / rest;
      tile = s.full + (v - z * rest);
      kc0 = z * s.chunks / s.splits;
      kc1 = (z + 1) * s.chunks / s.splits;
    }
    m0 = (tile / s.tiles_n) * kTile;
    n0 = (tile % s.tiles_n) * BN;
  }
};

// The number of units: the whole tiles and every split of the rest.
__host__ __device__ inline int units_of(const ConvShape& s) {
  return s.full + (s.tiles - s.full) * s.splits;
}

// How a stage is filled: A and B by the producers' copies; B by TMA (s.vb
// == 16); or both by TMA, where A is the row-major [M, C] matrix x is (a
// 1x1 conv of stride 1, no padding, s.va == 16).
enum Fill { kCopies, kTmaB, kTmaAB };

// The fill a conv takes, with its tensor maps (row-major byte matrices:
// the filter [N, K * esize], read in BN-row boxes, and where A comes by TMA x
// as [M, C * esize]). Returns 0, or tma::kEncodeError + the CUresult.
inline int fill_of(const ConvShape& s, const void* x, const void* w, int esize, int bn,
                   CUtensorMap* wmap, CUtensorMap* xmap, int* fill) {
  *fill = kCopies;
  if (s.vb != 16) return 0;
  const int rc = tma::encode_2d_u8(wmap, w, s.N, (uint64_t)s.K * esize, bn, kRowBytes);
  if (rc != 0) return rc;
  *fill = kTmaB;
  if (s.va == 16 && s.ky == 1 && s.kx == 1 && s.sy == 1 && s.sx == 1 && s.py == 0 &&
      s.px == 0) {
    const int rx = tma::encode_2d_u8(xmap, x, s.M, (uint64_t)s.C * esize, kTile, kRowBytes);
    if (rx != 0) return rx;
    *fill = kTmaAB;
  }
  return 0;
}

// The block's walk over units u = blockIdx.x, + gridDim.x, ...: the two
// producer warpgroups fill the ring (one thread of them where both operands
// come by TMA), the two consumer warpgroups multiply, warpgroup wg its rows
// 64 wg .. 64 wg + 63 into acc (int[64] for int8, float[BN / 2] for bf16:
// hopper_gemm.cuh's wgmma of that type and width), then call epi(unit, wg,
// acc, state) with the unit's sums and the warpgroup's Epi::State, which
// lasts from unit to unit. smem is the 1024-aligned dynamic shared memory
// of Layout<BN>; wmap and xmap are the kernel's __grid_constant__ maps.
template <typename E, int BN, int kFill, typename Acc, int NA, typename Epi>
__device__ __forceinline__ void ring_conv(const E* __restrict__ x, const E* __restrict__ w,
                                          const CUtensorMap* wmap, const CUtensorMap* xmap,
                                          const ConvShape& s, int units, uint8_t* smem,
                                          Acc (&acc)[NA], const Epi& epi) {
  using L = Layout<BN>;
  constexpr int kChunk = kRowBytes / sizeof(E);
  static_assert(NA == BN / 2, "accumulators of a warpgroup's 64 x BN");
  const uint32_t ring = smem_addr(smem);
  int4* pix = reinterpret_cast<int4*>(smem + L::kOffPix);
  const uint32_t full0 = smem_addr(smem + L::kOffBar), empty0 = full0 + 8 * kRing;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kRing; ++st) {
      tma::mbar_init(full0 + 8 * st,
                     kFill == kTmaAB ? 1 : kProducers + (kFill == kTmaB ? 1 : 0));
      tma::mbar_init(empty0 + 8 * st, 8);  // one arrival per consumer warp
    }
    tma::fence_mbar_init();
    if constexpr (kFill != kCopies) tma::prefetch_map(wmap);
    if constexpr (kFill == kTmaAB) tma::prefetch_map(xmap);
  }
  __syncthreads();

  int st = 0;
  uint32_t phase = 0;
  if (kFill == kTmaAB && threadIdx.x < kProducers) {
    // ---- producer, both operands by TMA: one thread, two loads a chunk
    if (threadIdx.x == 0) {
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit<BN> un(s, u);
        for (int kc = un.kc0; kc < un.kc1; ++kc) {
          const uint32_t full = full0 + 8 * st;
          tma::mbar_wait(empty0 + 8 * st, phase ^ 1);
          const uint32_t sa = ring + st * L::kStageBytes;
          tma::mbar_expect_tx(full, L::kStageBytes);
          tma::tma_load_2d(sa, xmap, kc * kRowBytes, un.m0, full);
          tma::tma_load_2d(sa + kBytesA, wmap, kc * kRowBytes, un.n0, full);
          if (++st == kRing) st = 0, phase ^= 1;
        }
      }
    }
  } else if (threadIdx.x < kProducers) {
    // ---- producers: fill the ring, unit after unit
    const int t = threadIdx.x;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit<BN> un(s, u);
      tma::named_sync(1, kProducers);  // the previous unit's copies are issued
      if (t < kTile) pix[t] = pixel_of(s, un.m0 + t);
      tma::named_sync(1, kProducers);
      const int runs = kRowBytes / s.va;
      Tap<kChunk> tap;
      tap.at(s, un.kc0 * kChunk + (t % runs) * s.va / (int)sizeof(E));
      for (int kc = un.kc0; kc < un.kc1; ++kc) {
        const uint32_t full = full0 + 8 * st;
        tma::mbar_wait(empty0 + 8 * st, phase ^ 1);
        const uint32_t sa = ring + st * L::kStageBytes, sb = sa + kBytesA;
        uint8_t* sa_p = smem + st * L::kStageBytes;
        if constexpr (kFill == kTmaB) {
          if (t == 0) {
            tma::mbar_expect_tx(full, L::kBytesB);
            tma::tma_load_2d(sb, wmap, kc * kRowBytes, un.n0, full);
          }
        }
        switch (s.va) {
          case 16: stage_a<16>(s, x, pix, tap, sa, sa_p); break;
          case 8: stage_a<8>(s, x, pix, tap, sa, sa_p); break;
          case 4: stage_a<4>(s, x, pix, tap, sa, sa_p); break;
          default: stage_a<sizeof(E)>(s, x, pix, tap, sa, sa_p); break;
        }
        if constexpr (kFill == kCopies) {
          switch (s.vb) {
            case 16: stage_b<16, BN>(s, w, un.n0, kc, sb, sa_p + kBytesA); break;
            case 8: stage_b<8, BN>(s, w, un.n0, kc, sb, sa_p + kBytesA); break;
            case 4: stage_b<4, BN>(s, w, un.n0, kc, sb, sa_p + kBytesA); break;
            default: stage_b<sizeof(E), BN>(s, w, un.n0, kc, sb, sa_p + kBytesA); break;
          }
        }
        if (s.va == (int)sizeof(E) || s.vb == (int)sizeof(E)) {
          // element stores: every copy of this thread landed, then one
          // release arrival (the writes visible to the async proxy first)
          tma::cp_async_wait_all();
          fence_proxy_async();
          tma::mbar_arrive(full);
        } else {
          tma::cp_async_arrive(full);
        }
        tap.next_chunk(s);
        if (++st == kRing) st = 0, phase ^= 1;
      }
    }
    tma::cp_async_wait_all();
  } else {
    // ---- consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63
    const int wg = (threadIdx.x - kProducers) >> 7;
    const bool lead = (threadIdx.x & 31) == 0;
    typename Epi::State state{};
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit<BN> un(s, u);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = 0;
      int prev = -1;
      for (int kc = un.kc0; kc < un.kc1; ++kc) {
        tma::mbar_wait(full0 + 8 * st, phase);
        fence_proxy_async();  // the producers' copies, seen by wgmma's reads
        const uint32_t sa = ring + st * L::kStageBytes;
        const uint64_t da = smem_desc(sa + wg * 64 * kRowBytes);
        const uint64_t db = smem_desc(sa + kBytesA);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kRowBytes / 32; ++ks) wgmma(acc, da + 2 * ks, db + 2 * ks);
        wgmma_commit();
        wgmma_wait<1>();  // the previous chunk's products are done: free its stage
        fence_acc(acc);
        if (prev >= 0 && lead) tma::mbar_arrive(empty0 + 8 * prev);
        prev = st;
        if (++st == kRing) st = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (prev >= 0 && lead) tma::mbar_arrive(empty0 + 8 * prev);
      epi(un, wg, acc, state);
    }
  }
}

}  // namespace convring
}  // namespace boda
