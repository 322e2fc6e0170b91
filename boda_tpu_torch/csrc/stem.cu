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
// which is the same thing after a ReLU. The TPU kernel's 4x4 phase-plane
// split, lane padding and pltpu.roll column shifts are Mosaic workarounds for
// strided slices; a strided index costs nothing here, so none is carried over.
//
// How the conv activation stays out of device memory: a tile is one image, ty
// x tx pooled outputs and 64 output channels. Its input patch (zero outside
// the image: the conv padding) goes to shared memory, the conv tile the pool
// windows cover, (ty-1)*psy + pky rows by (tx-1)*psx + pkx cols, is computed
// into shared memory, and max-pooled there. Only the pooled output is written:
// at ResNet-50 batch 32 the conv activation would be 102.8 MB of f32.
//
// What bounds it on an H100 SXM (989 TF/s bf16 dense, 67 TF/s FP32, 3.35
// TB/s): 2*C*ky*kx flop per conv output, 7.55 GFLOP for ResNet's conv1 at
// batch 32, against 9.6 MB (bf16) of input and 12.8 MB of pooled output. The
// operations bound it in both types (0.0076 ms bf16, 0.1127 ms f32), and what
// a fused kernel adds comes on top: the conv rows and cols that two tiles'
// windows share are computed by both, K is padded for the tensor cores, and
// the conv tile crosses shared memory once on its way to the pool.
//
// What the design does about it:
//  1. Persistent blocks. A block stages the filter into shared memory once,
//     in the layout its product reads, then walks over tiles t = blockIdx.x,
//     + gridDim.x, .. (blockIdx.y is the block of 64 output channels). A small
//     kernel launched before it reorders the filter from OIHW once per call
//     (stem_filter_kernel, the layout of ops/cuda/stem.py stem_filter), so the
//     blocks copy rows and divide nothing.
//  2. bf16 runs the conv on the tensor cores as a product of M = the conv
//     positions of the tile (64-row groups), N = 64 channels, K = taps x C.
//     K runs in (yy, xx, c) order, so the K values of one filter row at one
//     conv position are kx*C consecutive values of one patch row. Each filter
//     row is padded to a multiple of 16 with zero weights (7x7x3: 21 -> 32, K
//     = 224, 14 wgmma k-steps) and wgmma m64n64k16 takes A from registers:
//     a lane's fragment is four 4-byte loads straight from the patch, no
//     im2col copy. The loads must be 4-byte aligned; where a conv position's
//     first K value lies at an odd element ((px*C) odd, as in ResNet), the
//     filter rows start with one zero weight (`lead`) and the loads start one
//     element earlier. The filter lies in the GEMM core's chunked, 128-byte
//     swizzled layout (hopper_gemm.cuh), read by wgmma where it lies. The
//     padded taps read patch values of neighbouring positions against zero
//     weights, so a non-finite input value also reaches the outputs whose
//     padded taps cover it.
//  3. f32, and bf16 shapes wgmma cannot take (sx*C odd), run the same skeleton
//     on the core's FFMA tile (ffma_product: 128 rows x 64, 8x4 float4
//     micro-tile, full FP32, never TF32): A rows are gathered from the patch
//     through a table of tap offsets, K = ky*kx*C padded to the chunk of 8
//     with zero weights, the filter [64][K] resident in shared memory.
//  4. The patch comes from device memory in 16-byte cp.async copies over whole
//     input rows (one warp per row, one lane per 16 bytes: the index
//     arithmetic is per row), kept at its global 16-byte phase in shared
//     memory (`shift`), zero outside the image; a segment that straddles the
//     image edge, or an input whose rows are not 16-byte multiples, is
//     assembled element by element. The next tile's copies are in flight
//     under this tile's pool, and two blocks share an SM where shared memory
//     allows, so one block's product runs under the other's pool and copies
//     (a second patch buffer, the copies under the product too, changed no
//     time in the `stem plan` sweep and is not kept).
//  5. The conv tile lies in shared memory in the output type: rounding is
//     monotone, max(round(a), round(b)) == round(max(a, b)), so with a bf16
//     output the epilogue adds the f32 bias, applies ReLU, rounds once and the
//     pool takes maxima of bf16 values, bit-equal to pooling in f32 and
//     rounding after, at half the bytes. The pool reads and writes 16 bytes a
//     lane, channels fastest.
//  6. The tile follows the product's rows: 7 x 8 pooled outputs are a 15 x 17
//     conv tile, 255 of 256 rows of four wgmma groups (or two FFMA tiles), at
//     1.14x recompute; ops/cuda/stem.py stem_plan picks tile and grid from the
//     shape and the SM count.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase kernels;
// PERF.md section 6), conv1 + pool1 at batch 32, the first form (plain FFMA
// in both types) timed in turns with it: bf16 0.0709 and 0.0737 ms
// (first form 0.5750 and 0.5836; the cuDNN conv + ReLU + pool sequence
// 0.4749; its two launches alone 0.0667 in the 7 x 8 tile), f32 0.3761 and
// 0.3729 ms (0.5786 and 0.5813; sequence 0.6787; alone 0.3425 in the 3 x 8
// tile, which two blocks per SM favour: an f32 conv tile of 7 x 8 takes 73
// KB). Of a bf16 tile's 9.6 us on an SM that two blocks share, the fit of the
// `stem plan` sweep gives the pool 4.4, the patch rows 2.1, barriers and
// index arithmetic 2.4 and the 28 wgmma steps 0.8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using namespace boda::hopper;
using bf16 = __nv_bfloat16;

constexpr int kOcb = 64;             // output channels per block
constexpr size_t kMaxSmem = 232448;  // dynamic + static shared memory of a block
// static shared memory of the core's FFMA staging buffers at BN = 64
constexpr int kFfmaStatic = 2 * kBK32 * (kTileM + kPad32 + kOcb + kPad32) * 4;

struct StemShape {
  int H, W, C, oc;             // input NHWC extents, output channels
  int ky, kx, sy, sx, py, px;  // conv filter, stride, padding
  int cy, cx;                  // conv output extents
  int pky, pkx, psy, psx;      // pool window and stride (pool padding 0)
  int oy, ox;                  // pooled output extents
  int ty, tx;                  // pooled rows and cols per tile
  int cty, ctx, npos;          // conv-tile rows, cols and positions
  int pr, pc;                  // input-patch rows and cols
  int tiles_y, tiles_x, ntiles;  // tiles per image, and over all images
  int es;                      // bytes of an input element
  int pitch, patch_bytes;      // bytes of a patch row, and of the patch
  int vec;                     // 16-byte cp.async patch copies
  int lead, KR, Kp;            // zero weights before a filter row; K of a
                               // filter row and of the whole filter, padded
  int ct_pitch;                // bytes of a conv-tile row (64 outputs, padded)
  int vec_out;                 // 16-byte pooled stores
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Tile t of the launch: its image and the first pooled row and col.
__device__ __forceinline__ void tile_of(const StemShape& s, int t, int& img, int& j0, int& i0) {
  const int per = s.tiles_y * s.tiles_x;
  img = t / per;
  const int r = t - img * per;
  const int tyi = r / s.tiles_x;
  j0 = tyi * s.ty;
  i0 = (r - tyi * s.tiles_x) * s.tx;
}

// The bytes by which a patch row is moved right in its shared-memory row, so
// that 16-byte segments of shared and of device memory line up: the 16-byte
// phase of input col ix0 in its image row (rows are 16-byte multiples where
// vec; any value of the right parity serves the element-staged form).
__device__ __forceinline__ int shift_of(const StemShape& s, int ix0) {
  return ((ix0 * s.C * s.es) % 16 + 16) % 16;
}

// Stage the input patch of a tile: rows iy0 .. iy0 + pr - 1, elements
// [ix0 * C, (ix0 + pc) * C) of each row at byte `shift` of its pitch-byte
// row in buf, zero outside the image and in the rest of the row. Warp w
// takes rows w, w + 8, ..; a lane one 16-byte segment.
template <typename T>
__device__ __forceinline__ void stage_patch(const T* __restrict__ x, const StemShape& s, int img,
                                            int iy0, int ix0, uint8_t* buf) {
  constexpr int kPer = 16 / (int)sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int shift = shift_of(s, ix0);
  const int segs = s.pitch / 16;
  // elements of a row, counted from col ix0, that lie in the image and the patch
  const int vb = max(0, -ix0) * s.C, ve = min(s.pc, s.W - ix0) * s.C;
  for (int r = warp; r < s.pr; r += kThreads / 32) {
    const int iy = iy0 + r;
    const bool row_ok = iy >= 0 && iy < s.H;
    const long long g0 = ((long long)img * s.H + iy) * s.W * s.C + (long long)ix0 * s.C;
    uint8_t* row = buf + r * s.pitch;
    for (int sg = lane; sg < segs; sg += 32) {
      const int e0 = (16 * sg - shift) / (int)sizeof(T);  // exact: shift % sizeof(T) == 0
      if (!row_ok || e0 + kPer <= vb || e0 >= ve) {
        *reinterpret_cast<uint4*>(row + 16 * sg) = make_uint4(0u, 0u, 0u, 0u);
      } else if (s.vec && e0 >= vb && e0 + kPer <= ve) {
        cp_async16(smem_addr(row + 16 * sg), x + (g0 + e0), true);
      } else {
        union {
          uint4 v;
          T e[kPer];
        } u;
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          u.e[i] = (e0 + i >= vb && e0 + i < ve) ? x[g0 + e0 + i] : T(0);
        *reinterpret_cast<uint4*>(row + 16 * sg) = u.v;
      }
    }
  }
}

__device__ __forceinline__ void store_run(float* p, const float* v, int n) {
  if (n == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}
__device__ __forceinline__ void store_run(bf16* p, const float* v, int n) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  if (n == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = lo;
  } else {
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<uint32_t*>(&lo);
    q.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
  }
}

// The epilogue of n (2 or 4) adjacent channels of one conv position: + bias,
// ReLU, one rounding, into the conv tile.
template <typename TOut>
__device__ __forceinline__ void finish_run(uint8_t* ct, const StemShape& s, int p, int c,
                                           const float* acc, const float* b, int n, int relu) {
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = i < n ? acc[i] + b[i] : 0.f;
    if (relu) v[i] = fmaxf(v[i], 0.f);
  }
  store_run(reinterpret_cast<TOut*>(ct + (size_t)p * s.ct_pitch) + c, v, n);
}

// 16 bytes of conv-tile values (4 f32 or 8 bf16): -inf in each, and the
// elementwise maximum of a word of them.
__device__ __forceinline__ uint4 lowest(float) {
  const uint32_t ninf = 0xff800000u;
  return make_uint4(ninf, ninf, ninf, ninf);
}
__device__ __forceinline__ uint4 lowest(bf16) {
  const uint32_t ninf = 0xff80ff80u;
  return make_uint4(ninf, ninf, ninf, ninf);
}
__device__ __forceinline__ uint32_t max_word(uint32_t a, uint32_t b, float) {
  return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
}
__device__ __forceinline__ uint32_t max_word(uint32_t a, uint32_t b, bf16) {
  const __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

// Max-pool the conv tile of a tile into out: a lane takes 16 bytes of
// channels (8 bf16 or 4 f32) of one pooled output, windows cut at the conv
// output's edge.
template <typename TOut>
__device__ __forceinline__ void pool_store(const uint8_t* ct, const StemShape& s, int img, int j0,
                                           int i0, int oc0, TOut* __restrict__ out) {
  constexpr int kPer = 16 / (int)sizeof(TOut);
  constexpr int kGroups = kOcb / kPer;
  const int cy0 = j0 * s.psy, cx0 = i0 * s.psx;
  for (int idx = threadIdx.x; idx < s.ty * s.tx * kGroups; idx += kThreads) {
    const int jg = idx % kGroups;
    const int q = idx / kGroups;
    const int lj = q / s.tx;
    const int li = q - lj * s.tx;
    const int j = j0 + lj, i = i0 + li, ch = oc0 + jg * kPer;
    if (j >= s.oy || i >= s.ox || ch >= s.oc) continue;
    const int r0 = lj * s.psy, c0 = li * s.psx;
    const int nr = min(s.pky, s.cy - cy0 - r0), nc = min(s.pkx, s.cx - cx0 - c0);
    uint4 m = lowest(TOut());
    const uint8_t* src = ct + (size_t)(r0 * s.ctx + c0) * s.ct_pitch + jg * 16;
    const auto take = [&](const uint4& v) {
      m.x = max_word(m.x, v.x, TOut());
      m.y = max_word(m.y, v.y, TOut());
      m.z = max_word(m.z, v.z, TOut());
      m.w = max_word(m.w, v.w, TOut());
    };
    if (nr == 3 && nc == 3) {
      // a whole 3x3 window: its nine loads are issued before the first maximum
      uint4 v[9];
#pragma unroll
      for (int d = 0; d < 9; ++d)
        v[d] = *reinterpret_cast<const uint4*>(src +
                                               (size_t)((d / 3) * s.ctx + d % 3) * s.ct_pitch);
#pragma unroll
      for (int d = 0; d < 9; ++d) take(v[d]);
    } else {
      for (int dy = 0; dy < nr; ++dy)
        for (int dx = 0; dx < nc; ++dx)
          take(*reinterpret_cast<const uint4*>(src + (size_t)(dy * s.ctx + dx) * s.ct_pitch));
    }
    TOut* dst = out + (((size_t)img * s.oy + j) * s.ox + i) * s.oc + ch;
    if (s.vec_out && ch + kPer <= s.oc) {
      *reinterpret_cast<uint4*>(dst) = m;
    } else {
      const TOut* e = reinterpret_cast<const TOut*>(&m);
      for (int k = 0; k < kPer && ch + k < s.oc; ++k) dst[k] = e[k];
    }
  }
}

// The walk of a persistent block over its tiles, shared by both routes:
// product(ix0) computes the tile's conv tile into ct from the staged patch,
// whose first col is input col ix0. The next tile's copies run under this
// tile's pool.
template <typename T, typename TOut, typename Product>
__device__ __forceinline__ void walk_tiles(const T* __restrict__ x, TOut* __restrict__ out,
                                           const StemShape& s, uint8_t* patch, uint8_t* ct,
                                           int oc0, const Product& product) {
  const auto stage = [&](int t) {
    int img, j0, i0;
    tile_of(s, t, img, j0, i0);
    stage_patch(x, s, img, j0 * s.psy * s.sy - s.py, i0 * s.psx * s.sx - s.px, patch);
    cp_async_commit();
  };
  int tile = blockIdx.x;
  if (tile < s.ntiles) stage(tile);
  for (; tile < s.ntiles; tile += gridDim.x) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // the patch (and, the first time, the filter) is in shared memory
    int img, j0, i0;
    tile_of(s, tile, img, j0, i0);
    product(i0 * s.psx * s.sx - s.px);
    __syncthreads();  // the conv tile is complete, the patch free
    if (tile + gridDim.x < s.ntiles) stage(tile + gridDim.x);
    pool_store(ct, s, img, j0, i0, oc0, out);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- bf16: tensor cores

// Shared memory: the filter, Kp / 64 chunks of 64 rows x 128 bytes in the
// ring's swizzled layout; the patch; the conv tile.
template <typename TOut>
__global__ void __launch_bounds__(kThreads, 2)
    stem_mma(const bf16* __restrict__ x, const bf16* __restrict__ wk,
             const float* __restrict__ bias, TOut* __restrict__ out, StemShape s, int relu) {
  extern __shared__ __align__(16) uint8_t smem_mma[];
  uint8_t* fb = align_1024(smem_mma);
  const int nchunks = s.Kp / 64;
  uint8_t* patch = fb + (size_t)nchunks * kOcb * kRowBytes;
  uint8_t* ct = patch + s.patch_bytes;
  const int oc0 = blockIdx.y * kOcb;
  for (int kc = 0; kc < nchunks; ++kc)
    stage_rows<kOcb, true>(wk, s.oc, s.Kp, oc0, kc, smem_addr(fb + kc * kOcb * kRowBytes),
                           fb + kc * kOcb * kRowBytes);
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;
  const int fr = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);  // fragment row, and + 8
  const int fc = (lane & 3) * 2;                               // fragment col in a group of 8
  float bv[16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = oc0 + 8 * i + fc + e;
      bv[2 * i + e] = (bias != nullptr && n < s.oc) ? bias[n] : 0.f;
    }
  const uint64_t fdesc = smem_desc(smem_addr(fb));
  const int halves = s.KR / 16;  // k-steps per filter row
  const int nks = s.ky * halves;
  const int ngroups = (s.npos + 63) / 64;

  walk_tiles(x, out, s, patch, ct, oc0, [&](int ix0) {
    // byte 0 of a position's K values in its patch row, for this lane
    const uint8_t* base = patch + shift_of(s, ix0) - 2 * s.lead + 2 * fc;
    for (int mg = wg; mg < ngroups; mg += 2) {
      const uint8_t* rowp[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = min(mg * 64 + fr + 8 * h, s.npos - 1);
        const int r = p / s.ctx;
        rowp[h] = base + r * s.sy * s.pitch + (p - r * s.ctx) * s.sx * s.C * 2;
      }
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      int ro = 0, hf = 0;  // byte offset of the next k-step in the patch rows
      const auto load_a = [&](uint32_t (&a)[4]) {
        a[0] = *reinterpret_cast<const uint32_t*>(rowp[0] + ro);
        a[1] = *reinterpret_cast<const uint32_t*>(rowp[1] + ro);
        a[2] = *reinterpret_cast<const uint32_t*>(rowp[0] + ro + 16);
        a[3] = *reinterpret_cast<const uint32_t*>(rowp[1] + ro + 16);
        if (++hf == halves) {
          hf = 0;
          ro += s.pitch - 32 * (halves - 1);
        } else {
          ro += 32;
        }
      };
      const auto product = [&](const uint32_t (&a)[4], int ks) {
        wgmma_fence();
        wgmma_ra(acc, a, fdesc + (uint64_t)((ks >> 2) * (kOcb * kRowBytes >> 4) + 2 * (ks & 3)));
        wgmma_commit();
        wgmma_wait<1>();  // the k-step before is done: its registers are free
      };
      // two register sets in turns: one k-step's loads run under the
      // product of the step before
      uint32_t a0[4], a1[4];
      fence_acc(acc);
      int ks = 0;
      for (; ks + 1 < nks; ks += 2) {
        load_a(a0);
        product(a0, ks);
        load_a(a1);
        product(a1, ks + 1);
      }
      if (ks < nks) {
        load_a(a0);
        product(a0, ks);
      }
      wgmma_wait<0>();
      fence_acc(acc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mg * 64 + fr + 8 * h;
        if (p >= s.npos) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          finish_run<TOut>(ct, s, p, 8 * i + fc, &acc[4 * i + 2 * h], &bv[2 * i], 2, relu);
      }
    }
  });
}

// ---------------------------------------------------------------- FFMA route

// Shared memory: the filter [64][Kp] in T; the tap table, the element offset
// of K value k from a position's first patch element; the patch; the conv
// tile. The core's staging buffers are static shared memory.
template <typename T, typename TOut>
__global__ void __launch_bounds__(kThreads, 2)
    stem_ffma(const T* __restrict__ x, const T* __restrict__ wk, const float* __restrict__ bias,
              TOut* __restrict__ out, StemShape s, int relu) {
  extern __shared__ __align__(16) uint8_t smem_ffma[];
  T* fs = reinterpret_cast<T*>(smem_ffma);
  int* ktab = reinterpret_cast<int*>(smem_ffma + (size_t)kOcb * s.Kp * sizeof(T));
  uint8_t* patch = reinterpret_cast<uint8_t*>(ktab + s.Kp);
  uint8_t* ct = patch + s.patch_bytes;
  const int oc0 = blockIdx.y * kOcb;
  const int pitch_e = s.pitch / (int)sizeof(T);
  for (int r = threadIdx.x >> 5; r < kOcb; r += kThreads / 32)
    for (int k = threadIdx.x & 31; k < s.Kp; k += 32)
      fs[r * s.Kp + k] = oc0 + r < s.oc ? wk[(size_t)(oc0 + r) * s.Kp + k] : T(0);
  const int krow = s.kx * s.C;
  for (int k = threadIdx.x; k < s.Kp; k += kThreads) {
    const int yy = k / krow;
    ktab[k] = k < s.ky * krow ? yy * pitch_e + (k - yy * krow) : 0;
  }
  const int lr = threadIdx.x >> 1;  // the tile row this thread stages
  const int c4 = (threadIdx.x & 15) * 4;  // its four output channels
  float bq[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    bq[e] = (bias != nullptr && oc0 + c4 + e < s.oc) ? bias[oc0 + c4 + e] : 0.f;
  const T* brow = fs + (lr < kOcb ? lr : 0) * s.Kp;

  walk_tiles(x, out, s, patch, ct, oc0, [&](int ix0) {
    const T* base = reinterpret_cast<const T*>(patch + shift_of(s, ix0));
    float acc[8][kOcb / 16];
    for (int m0 = 0; m0 < s.npos; m0 += kTileM) {
      const int p = min(m0 + lr, s.npos - 1);
      const int r = p / s.ctx;
      const T* arow = base + r * s.sy * pitch_e + (p - r * s.ctx) * s.sx * s.C;
      ffma_product<kOcb, true>(
          0, s.Kp / kBK32, s.npos - m0,
          [&](int, int k, float (&a)[4], float (&b)[4], bool want_b) {
            const int4 kt = *reinterpret_cast<const int4*>(ktab + k);
            a[0] = boda::to_f32(arow[kt.x]);
            a[1] = boda::to_f32(arow[kt.y]);
            a[2] = boda::to_f32(arow[kt.z]);
            a[3] = boda::to_f32(arow[kt.w]);
            if (want_b) boda::load_quad(brow + k, b);
          },
          acc);
      for_quads<kOcb>(acc, [&](int row, int c, const float (&v)[4]) {
        if (m0 + row < s.npos) finish_run<TOut>(ct, s, m0 + row, c, v, bq, 4, relu);
      });
    }
  });
}

// ---------------------------------------------------------------- filter

// The OIHW filter w in the kernels' layout: wk[o][yy * KR + lead + xx * C + c]
// = w[o][c][yy][xx], zero elsewhere in [oc][Kp] (ops/cuda/stem.py stem_filter
// is the same function in plain PyTorch).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stem_filter_kernel(const T* __restrict__ w, T* __restrict__ wk, int oc, int C, int ky, int kx,
                       int lead, int KR, int Kp) {
  for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < oc * Kp; idx += gridDim.x * kThreads) {
    const int o = idx / Kp;
    const int k = idx - o * Kp;
    const int yy = k / KR;
    const int r = k - yy * KR - lead;
    T v = T(0);
    if (yy < ky && r >= 0 && r < kx * C) {
      const int xx = r / C;
      v = w[((o * C + (r - xx * C)) * ky + yy) * kx + xx];
    }
    wk[idx] = v;
  }
}

// ---------------------------------------------------------------- launch

struct Kernel {
  const void* fn;
  int static_smem;
  int* allowed;  // the dynamic shared memory it was opted into so far
};

template <typename TOut>
Kernel mma_kernel() {
  static int allowed = 0;
  return {reinterpret_cast<const void*>(&stem_mma<TOut>), 0, &allowed};
}

template <typename T, typename TOut>
Kernel ffma_kernel() {
  static int allowed = 0;
  return {reinterpret_cast<const void*>(&stem_ffma<T, TOut>), kFfmaStatic, &allowed};
}

// The plan of ops/cuda/stem.py stem_plan, as boda_fused_stem takes it.
struct Plan {
  int ty, tx, mma, vec, Kp, in_bf16, out_bf16;
};

// The shape, kernel and dynamic shared memory of a launch; false where the
// plan or the shape is not one the kernels take or the tile does not fit.
bool configure(StemShape& s, const Plan& pl, int n, Kernel& k, size_t& smem) {
  if (pl.ty < 1 || pl.tx < 1) return false;
  if (s.sy < 1 || s.sx < 1 || s.pky < 1 || s.pkx < 1 || s.psy < 1 || s.psx < 1) return false;
  s.es = pl.in_bf16 ? 2 : 4;
  const int os = pl.out_bf16 ? 2 : 4;
  s.cy = (s.H + 2 * s.py - s.ky) / s.sy + 1;
  s.cx = (s.W + 2 * s.px - s.kx) / s.sx + 1;
  s.ty = pl.ty;
  s.tx = pl.tx;
  s.cty = (s.ty - 1) * s.psy + s.pky;
  s.ctx = (s.tx - 1) * s.psx + s.pkx;
  s.npos = s.cty * s.ctx;
  s.pr = (s.cty - 1) * s.sy + s.ky;
  s.pc = (s.ctx - 1) * s.sx + s.kx;
  s.tiles_y = (s.oy + s.ty - 1) / s.ty;
  s.tiles_x = (s.ox + s.tx - 1) / s.tx;
  s.ntiles = n * s.tiles_y * s.tiles_x;
  s.vec = pl.vec;
  if (s.vec && (s.W * s.C * s.es) % 16 != 0) return false;
  s.ct_pitch = kOcb * os + (os == 4 ? 32 : 16);
  size_t filter;
  if (pl.mma) {
    if (!pl.in_bf16 || (s.sx * s.C) % 2 != 0) return false;
    s.lead = (s.px * s.C) & 1;
    s.KR = round_up(s.lead + s.kx * s.C, 16);
    s.Kp = round_up(s.ky * s.KR, 64);
    s.pitch = round_up(16 + ((s.ctx - 1) * s.sx * s.C + s.KR) * 2, 16);
    filter = 1024 + (size_t)s.Kp * kRowBytes;
    k = pl.out_bf16 ? mma_kernel<bf16>() : mma_kernel<float>();
  } else {
    s.lead = 0;
    s.KR = s.kx * s.C;
    s.Kp = round_up(s.ky * s.KR, kBK32);
    s.pitch = round_up(16 + s.pc * s.C * s.es, 16);
    filter = (size_t)kOcb * s.Kp * s.es + (size_t)s.Kp * 4;
    if (pl.in_bf16)
      k = pl.out_bf16 ? ffma_kernel<bf16, bf16>() : ffma_kernel<bf16, float>();
    else
      k = pl.out_bf16 ? ffma_kernel<float, bf16>() : ffma_kernel<float, float>();
  }
  if (s.Kp != pl.Kp) return false;
  s.patch_bytes = s.pr * s.pitch;
  smem = filter + (size_t)s.patch_bytes + (size_t)s.npos * s.ct_pitch;
  if (smem + k.static_smem > kMaxSmem) return false;
  if ((int)smem > *k.allowed) {
    if (cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess)
      return false;
    *k.allowed = (int)smem;
  }
  return true;
}

StemShape conv_shape(int H, int W, int C, int oc, int ky, int kx, int sy, int sx, int py, int px,
                     int pky, int pkx, int psy, int psx, int oy, int ox) {
  StemShape s = {};
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
  s.pky = pky;
  s.pkx = pkx;
  s.psy = psy;
  s.psx = psx;
  s.oy = oy;
  s.ox = ox;
  return s;
}

}  // namespace

// x: NHWC [n, H, W, C], f32 or bf16 (in_bf16). w: the OIHW filter [oc, C, ky,
// kx] of x's type. wk: workspace of [oc, Kp] elements of that type, which a
// first launch fills with the filter as ops/cuda/stem.py stem_filter lays it
// out: K in (yy, xx, c) order; mma: each filter row after `lead` = (px*C) & 1
// zeros, padded to a multiple of 16, the whole to a multiple of 64; else
// unpadded rows, the whole to a multiple of 8. bias: f32 [oc] or null. out: NHWC [n, oy, ox, oc],
// f32 or bf16 (out_bf16), where (oy, ox) is the ceil-mode pooled extent of the
// conv output (pool padding 0; every window starts inside the conv output).
// The plan of stem_plan: ty x tx pooled outputs per tile; mma, the tensor-core
// route (bf16 in, sx*C even), else the FFMA route; vec, 16-byte patch copies
// (W*C*sizeof % 16 == 0 and x 16-byte aligned); blocks, the persistent blocks
// per 64 output channels. Returns the launch's CUDA error code (0 on success).
extern "C" int boda_fused_stem(const void* x, const void* w, void* wk, const void* bias, void* out,
                               int n, int H, int W, int C, int oc, int ky, int kx, int sy, int sx,
                               int py, int px, int pky, int pkx, int psy, int psx, int oy, int ox,
                               int ty, int tx, int mma, int vec, int Kp, int blocks, int in_bf16,
                               int out_bf16, int relu, void* stream) {
  StemShape s = conv_shape(H, W, C, oc, ky, kx, sy, sx, py, px, pky, pkx, psy, psx, oy, ox);
  const Plan pl = {ty, tx, mma, vec, Kp, in_bf16, out_bf16};
  Kernel k;
  size_t smem;
  if (blocks < 1 || !configure(s, pl, n, k, smem)) return static_cast<int>(cudaErrorInvalidValue);
  if (vec && reinterpret_cast<size_t>(x) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  s.vec_out = (oc * (out_bf16 ? 2 : 4)) % 16 == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int fblocks = (oc * s.Kp + kThreads - 1) / kThreads;
  if (in_bf16)
    stem_filter_kernel<<<fblocks, kThreads, 0, st>>>(static_cast<const bf16*>(w),
                                                     static_cast<bf16*>(wk), oc, C, ky, kx, s.lead,
                                                     s.KR, s.Kp);
  else
    stem_filter_kernel<<<fblocks, kThreads, 0, st>>>(static_cast<const float*>(w),
                                                     static_cast<float*>(wk), oc, C, ky, kx, s.lead,
                                                     s.KR, s.Kp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(blocks < s.ntiles ? blocks : s.ntiles, (oc + kOcb - 1) / kOcb);
  void* args[] = {&x, &wk, &bias, &out, &s, &relu};
  e = cudaLaunchKernel(k.fn, grid, dim3(kThreads), args, smem, st);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// What stem_plan's shared-memory sum must equal: the dynamic plus static
// shared memory of a block under a plan (boda_fused_stem's arguments), or -1
// where boda_fused_stem would refuse it.
extern "C" int boda_fused_stem_smem(int H, int W, int C, int oc, int ky, int kx, int sy, int sx,
                                    int py, int px, int pky, int pkx, int psy, int psx, int oy,
                                    int ox, int ty, int tx, int mma, int vec, int Kp, int in_bf16,
                                    int out_bf16) {
  StemShape s = conv_shape(H, W, C, oc, ky, kx, sy, sx, py, px, pky, pkx, psy, psx, oy, ox);
  const Plan pl = {ty, tx, mma, vec, Kp, in_bf16, out_bf16};
  Kernel k;
  size_t smem;
  if (!configure(s, pl, 1, k, smem)) return -1;
  return (int)smem + k.static_smem;
}

// The blocks of that plan one SM holds at once, which stem_plan's grid rests
// on; -1 where boda_fused_stem would refuse the plan or the query fails.
extern "C" int boda_fused_stem_blocks_per_sm(int H, int W, int C, int oc, int ky, int kx, int sy,
                                             int sx, int py, int px, int pky, int pkx, int psy,
                                             int psx, int oy, int ox, int ty, int tx, int mma,
                                             int vec, int Kp, int in_bf16, int out_bf16) {
  StemShape s = conv_shape(H, W, C, oc, ky, kx, sy, sx, py, px, pky, pkx, psy, psx, oy, ox);
  const Plan pl = {ty, tx, mma, vec, Kp, in_bf16, out_bf16};
  Kernel k;
  size_t smem;
  if (!configure(s, pl, 1, k, smem)) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k.fn, kThreads, smem) != cudaSuccess)
    return -1;
  return per_sm;
}
