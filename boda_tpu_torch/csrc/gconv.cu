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
// layers. An FFMA kernel would be bound by its operations at res4 and res5
// (FFMA's ridge is about 20 flops a byte). So:
// - each block computes a tile of ty x tx output pixels of one image over a
//   slab of 64 input channels (the slab's groups) and writes the same 64
//   output channels: it stages the tile's input halo in shared memory once,
//   by 16-byte cp.async with zero fill outside the image, so each input byte
//   crosses device memory about once (the halo's overlap with the next tile
//   is read again, mostly from L2; blocks of neighbouring tiles run side by
//   side, the slab the fastest index);
// - the warps run mma.sync m16n8k16 per unit of groups, straight from the
//   staged halo (a fragment row is a pixel, its K a tap's channels), with the
//   slab's filter staged beside it; where og < 8 (res2's 4) two groups make
//   one block-diagonal unit of 8 outputs over their 8 channels, the filter's
//   off-diagonal blocks zero, so no mma column is wasted on padding;
// - the epilogue stages the tile's bf16 results in shared memory, and the
//   block writes them out by 16-byte stores, each pixel's 128 bytes whole.
// Pixels are padded by 16 bytes in shared memory (and the filter's rows to
// 4 words past a multiple of 8), so the 8 rows of a fragment fall in other
// banks. The zero blocks of a unit and the padding of K take x's finite
// values times 0: an Inf or NaN input reaches the sums of the other group of
// its unit, which cuDNN's grouped conv would not; a net's finite activations
// never show it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using E = __nv_bfloat16;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 64;            // channels of a block's slab, in and out
constexpr int kPsw = kSlab / 2 + 4;  // shared words of a staged pixel

struct GShape {
  int H, W, C, oc, ky, kx, sy, sx, py, px, oy, ox;
  int ty, tx, hy, hx, tiles_y, tiles_x, slabs, relu;
  int kpad;  // a unit's K in whole k16 steps (zero past ky * kx * cp)
  int swb;   // shared words of a staged filter row: kpad / 2 + 4
};

// A unit: p groups of cg channels whose block-diagonal product is one GEMM
// of cp = p * cg outputs over their cp channels (p = 1 from cg = 8 up).
template <int CG>
struct Unit {
  static constexpr int P = CG < 8 ? 8 / CG : 1;
  static constexpr int CP = P * CG;
  static constexpr int NF = CP / 8;        // n8 fragments of a unit's outputs
  static constexpr int U = kSlab / CP;     // units of a slab
  static constexpr int V = CG < 8 ? 4 : 8; // bf16 values of a filter copy
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block: output pixels [oy0, oy0 + ty) x [ox0, ox0 + tx) of image img,
// channels [c0, c0 + 64) of x in and of y out. Shared memory: the input halo
// (hy x hx pixels of kPsw words), the slab's filter (64 rows of swb words,
// row r = output c0 + r, k = tap * cp + channel within its unit, zero off a
// unit's diagonal and past its taps), the staged output (ty * tx pixels of
// kPsw words) and the tap table (halo pixel offset of each tap; 0 for the
// taps of K's padding, whose filter is zero).
template <int CG>
__global__ void __launch_bounds__(kThreads)
    gconv_kernel(const E* __restrict__ x, const E* __restrict__ w,
                 const float* __restrict__ bias, E* __restrict__ y, GShape s) {
  using Un = Unit<CG>;
  extern __shared__ __align__(16) uint32_t sm[];
  const int taps_n = s.ky * s.kx;
  const int tpad = s.kpad / Un::CP;
  const int hpix = s.hy * s.hx, npix = s.ty * s.tx;
  uint32_t* xs = sm;
  uint32_t* ws = xs + hpix * kPsw;
  uint32_t* os = ws + kSlab * s.swb;
  int* taps = reinterpret_cast<int*>(os + npix * kPsw);

  int b = blockIdx.x;
  const int slab = b % s.slabs;
  b /= s.slabs;
  const int txi = b % s.tiles_x;
  b /= s.tiles_x;
  const int tyi = b % s.tiles_y;
  const int img = b / s.tiles_y;
  const int oy0 = tyi * s.ty, ox0 = txi * s.tx;
  const int iy0 = oy0 * s.sy - s.py, ix0 = ox0 * s.sx - s.px;
  const int c0 = slab * kSlab;

  // the halo, 8 copies of 16 bytes a pixel, zeros outside the image
  for (int i = threadIdx.x; i < hpix * 8; i += kThreads) {
    const int p = i >> 3, v = i & 7;
    const int iy = iy0 + p / s.hx, ix = ix0 + p % s.hx;
    const bool in = iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
    const E* src = in ? x + (((size_t)img * s.H + iy) * s.W + ix) * s.C + c0 + v * 8 : x;
    cp_async16(xs + p * kPsw + v * 4, src, in ? 16 : 0);
  }
  // the slab's filter, each unit block-diagonal: row r, columns k .. k + V
  const int kv = s.kpad / Un::V;
  for (int i = threadIdx.x; i < kSlab * kv; i += kThreads) {
    const int r = i / kv, k = (i % kv) * Un::V;
    const int tap = k / Un::CP, c = k % Un::CP;
    const bool on = tap < taps_n && (r % Un::CP) / CG == c / CG;
    const E* src = on ? w + ((size_t)(c0 + r) * taps_n + tap) * CG + c % CG : w;
    uint32_t* dst = ws + r * s.swb + k / 2;
    if (Un::V == 8) {
      cp_async16(dst, src, on ? 16 : 0);
    } else {
      cp_async8(dst, src, on ? 8 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int t = threadIdx.x; t < tpad; t += kThreads) {
    taps[t] = t < taps_n ? (t / s.kx) * s.hx + t % s.kx : 0;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int mf = (npix + 15) / 16;
  const int ksteps = s.kpad / 16;
  for (int item = warp; item < mf * Un::U; item += kWarps) {
    const int f = item % mf, u = item / mf;
    int base[2];  // halo pixel of the fragment rows g and g + 8 at tap 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = f * 16 + g + 8 * h;
      base[h] = m < npix ? (m / s.tx) * s.sy * s.hx + (m % s.tx) * s.sx : 0;
    }
    float acc[Un::NF][4];
#pragma unroll
    for (int j = 0; j < Un::NF; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const uint32_t* xu = xs + u * (Un::CP / 2);
    const uint32_t* wu = ws + (u * Un::CP + g) * s.swb + q;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = ks * 16 + h * 8 + 2 * q;
        const int off = taps[k / Un::CP];
        const int cw = (k % Un::CP) / 2;
        a[2 * h] = xu[(base[0] + off) * kPsw + cw];
        a[2 * h + 1] = xu[(base[1] + off) * kPsw + cw];
      }
#pragma unroll
      for (int j = 0; j < Un::NF; ++j) {
        const uint32_t* wr = wu + j * 8 * s.swb + ks * 8;
        mma_bf16(acc[j], a, wr[0], wr[4]);
      }
    }
    // the epilogue into the staged output: bias, ReLU, one rounding
#pragma unroll
    for (int j = 0; j < Un::NF; ++j) {
      const int n = u * Un::CP + j * 8 + 2 * q;
      const float b0 = bias != nullptr ? bias[c0 + n] : 0.f;
      const float b1 = bias != nullptr ? bias[c0 + n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = f * 16 + g + 8 * h;
        if (m >= npix) continue;
        float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        if (s.relu) {
          if (v0 < 0.f) v0 = 0.f;
          if (v1 < 0.f) v1 = 0.f;
        }
        const __nv_bfloat162 pr = __floats2bfloat162_rn(v0, v1);
        os[m * kPsw + n / 2] = *reinterpret_cast<const uint32_t*>(&pr);
      }
    }
  }
  __syncthreads();

  // each staged pixel out whole: 8 stores of 16 bytes
  for (int i = threadIdx.x; i < npix * 8; i += kThreads) {
    const int m = i >> 3, v = i & 7;
    const int oyy = oy0 + m / s.tx, oxx = ox0 + m % s.tx;
    if (oyy < s.oy && oxx < s.ox) {
      const uint4 val = *reinterpret_cast<const uint4*>(os + m * kPsw + v * 4);
      *reinterpret_cast<uint4*>(y + (((size_t)img * s.oy + oyy) * s.ox + oxx) * s.oc + c0 +
                                v * 8) = val;
    }
  }
}

template <int CG>
int launch(const E* x, const E* w, const float* bias, E* y, const GShape& s, int blocks,
           int smem, cudaStream_t stream) {
  static bool smem_set = false;  // per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gconv_kernel<CG>, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  gconv_kernel<CG><<<blocks, kThreads, smem, stream>>>(x, w, bias, y, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: bf16 NHWC [n, H, W, C]; w: bf16 OHWI [oc, ky, kx, C / groups]; bias: f32
// [oc] or null; y: bf16 NHWC [n, oy, ox, oc], oy = (H + 2*py - ky) / sy + 1
// (ox alike). Groups of cg = C / groups = oc / groups channels, cg one of 4,
// 8, 16, 32, 64, and C a multiple of 64; ty x tx: a block's output tile
// (ops/cuda/gconv.gconv_plan). The caller keeps every extent under 2^31.
// Returns the launch's cudaGetLastError(), cudaErrorInvalidValue for a shape
// it has no instance for, or cudaErrorInvalidConfiguration where the tile's
// shared memory passes 227 KB.
extern "C" int boda_gconv(const void* x, const void* w, const void* bias, void* y, int n, int H,
                          int W, int C, int oc, int groups, int ky, int kx, int sy, int sx,
                          int py, int px, int ty, int tx, int relu, void* stream) {
  if (groups < 2 || C % groups != 0 || oc != C || C % kSlab != 0 || ty < 1 || tx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cg = C / groups;
  const int p = cg < 8 ? 8 / cg : 1;
  GShape s;
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
  s.oy = (H + 2 * py - ky) / sy + 1;
  s.ox = (W + 2 * px - kx) / sx + 1;
  s.ty = ty;
  s.tx = tx;
  s.hy = (ty - 1) * sy + ky;
  s.hx = (tx - 1) * sx + kx;
  s.tiles_y = (s.oy + ty - 1) / ty;
  s.tiles_x = (s.ox + tx - 1) / tx;
  s.slabs = C / kSlab;
  s.relu = relu;
  s.kpad = (ky * kx * p * cg + 15) / 16 * 16;
  s.swb = s.kpad / 2 + 4;
  const long smem = 4L * ((long)(s.hy * s.hx + ty * tx) * kPsw + (long)kSlab * s.swb +
                          s.kpad / (p * cg));
  if (smem > 227L * 1024) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long blocks = (long)n * s.tiles_y * s.tiles_x * s.slabs;
  const E* xe = static_cast<const E*>(x);
  const E* we = static_cast<const E*>(w);
  const float* bf = static_cast<const float*>(bias);
  E* ye = static_cast<E*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cg) {
    case 4:
      return launch<4>(xe, we, bf, ye, s, (int)blocks, (int)smem, st);
    case 8:
      return launch<8>(xe, we, bf, ye, s, (int)blocks, (int)smem, st);
    case 16:
      return launch<16>(xe, we, bf, ye, s, (int)blocks, (int)smem, st);
    case 32:
      return launch<32>(xe, we, bf, ye, s, (int)blocks, (int)smem, st);
    case 64:
      return launch<64>(xe, we, bf, ye, s, (int)blocks, (int)smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
