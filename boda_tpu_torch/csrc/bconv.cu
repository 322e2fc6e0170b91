// bconv (B7): the bf16 form of the vendor conv (xla_conv, xla_conv2 and
// s2d_conv under prec=bf16 with NHWC storage) as an implicit GEMM on bf16
// tensor cores with f32 sums. Hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: in the JAX package these are XLA convs
// (boda_tpu/ops/pallas/conv.py XlaConv.build :206-233, conv2.py XlaConv2),
// bf16 operands with an f32 result, and torch has no such conv on CUDA: its
// bf16 conv rounds the sum to bf16 before the bias, one rounding more, which
// misses the 5e-3 gate (tests/test_torch_conv2.py). Until this kernel the
// port ran the role on cuDNN in full FP32 on the rounded operands, with casts,
// layout transforms, a bias add, a ReLU pass and per-member copies around it.
// Per output element, in the JAX template's order:
//   y[n,oy,ox,o] = store(relu?(f32(sum_{ky,kx,c} x[n, oy*sy+ky-py, ox*sx+kx-px, c]
//                                        * w[o,ky,kx,c]) + bias[o]))
// bf16 products exact, summed in f32 by wgmma m64nNk16; the bias added in f32
// with no contraction; store = f32, bf16 (round to nearest even), or an int8
// edge at clamp(rint(v * q), -127, 127) (q = 127 / out_absmax, B6's formula).
// The GEMM's N columns are the members of a sibling group (xla_conv2: up to 4
// convs over one input, their filters concatenated on oc); the epilogue writes
// each member's columns straight into that member's own NHWC output, with its
// own bias, ReLU flag and stored type.
//
// What bounds it on an H100 SXM (989 TF/s bf16 dense, 3.35 TB/s): a b128
// ResNet-50 forward's convs do 988 G flop (1.0 ms at the peak) over about
// 1.5 GB of bf16 input, filter and output (0.45 ms); its 3x3 convs sit above
// the roofline's ridge, its 1x1 convs with C = 64 below it (x and y of res2's
// expand: 0.25 GB for 13 G flop). The ring is B6's (conv_ring.cuh): staging
// A, the conv window, through shared memory is what sets the pace there too,
// and a bf16 chunk holds half the values of an int8 one. So the design keeps
// every A byte staged once per N tile: 128 x 128 tiles, and 128 x 64 only
// where the whole N fits one (oc <= 64: GoogLeNet's narrow convs, res2's
// reduce), so that no 128-wide tile is three-quarters zeros; split-K, as B6's
// plan, where the tiles do not fill the card. Split partial sums are f32 in a
// workspace, added in a fixed order (split 0 first) by bconv_reduce before
// the same epilogue: results repeat bit for bit from run to run. The 1x1
// convs of small C are bound by their epilogue, not their products (res2's
// expand, 64 -> 256 at b128: 0.019 ms of ring with no epilogue, 0.31 with a
// store per run of 4 results from the f32 staging): so a tile's bias and
// ReLU come from a table of its columns, and a tile that lies in one bf16
// member goes out by an asynchronous TMA store from a double-buffered bf16
// staging, while the warpgroup multiplies its next tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "conv_ring.cuh"  // the ring, its loaders and the unit walk
#include "hopper_gemm.cuh"
#include "tma_pipe.cuh"

namespace {

using namespace boda::hopper;
using namespace boda::convring;
namespace tma = boda::tma;

using E = __nv_bfloat16;
constexpr int kMaxMembers = 4;

// One member of the output: columns [n0, n0 + n) of the GEMM, stored to its
// own row-major [M, n] out (NHWC) as kind 0 f32, 1 bf16, 2 int8 (at q);
// bias f32 [n] or null. vec: n0 and n multiples of 4 and out aligned for 4
// results, so a run of 4 is one store.
struct Member {
  void* out;
  const float* bias;
  int n0, n, relu, kind, vec;
  int tma;  // a bf16 out the TMA store takes (n % 8 == 0, 16-byte aligned)
  float q;
};

// Each member's out as a row-major [M, n * 2] byte matrix in 64-row boxes of
// 128 bytes (64 bf16 results) in the 128-byte swizzle: what TMA stores a
// tile from (set where the member's tma flag is).
struct OutMaps {
  CUtensorMap m[kMaxMembers];
};

struct BOuts {
  Member mem[kMaxMembers];
  int nmem;
  float* ws;    // the split tiles' f32 partial sums [splits, M - m_split, N]
  int m_split;  // their first row: (full / tiles_n) * 128
};

__device__ __forceinline__ int member_of(const BOuts& o, int n) {
  int j = 0;
  while (j + 1 < o.nmem && n >= o.mem[j].n0 + o.mem[j].n) ++j;
  return j;
}

// A finished result: the sum plus the bias, then the ReLU, each one f32 step.
__device__ __forceinline__ float finish(const Member& mb, float v, int col) {
  if (mb.bias != nullptr) v = __fadd_rn(v, mb.bias[col]);
  if (mb.relu && v < 0.f) v = 0.f;
  return v;
}

__device__ __forceinline__ void store_one(const Member& mb, size_t i, float v) {
  if (mb.kind == 0) {
    static_cast<float*>(mb.out)[i] = v;
  } else if (mb.kind == 1) {
    static_cast<E*>(mb.out)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<int8_t*>(mb.out)[i] =
        (int8_t)max(-127, min(__float2int_rn(__fmul_rn(v, mb.q)), 127));
  }
}

// Stores finished results v[0..3] of row m, member columns col .. col + 3 of
// mb (a member whose runs of 4 are one store) as one store of its kind.
__device__ __forceinline__ void store_quad(const Member& mb, int m, int col, const float4& f) {
  const size_t i = (size_t)m * mb.n + col;
  if (mb.kind == 1) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(f.x, f.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(f.z, f.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<E*>(mb.out) + i) = u;
  } else if (mb.kind == 0) {
    *reinterpret_cast<float4*>(static_cast<float*>(mb.out) + i) = f;
  } else {
    char4 c;
    c.x = (int8_t)max(-127, min(__float2int_rn(__fmul_rn(f.x, mb.q)), 127));
    c.y = (int8_t)max(-127, min(__float2int_rn(__fmul_rn(f.y, mb.q)), 127));
    c.z = (int8_t)max(-127, min(__float2int_rn(__fmul_rn(f.z, mb.q)), 127));
    c.w = (int8_t)max(-127, min(__float2int_rn(__fmul_rn(f.w, mb.q)), 127));
    *reinterpret_cast<char4*>(static_cast<int8_t*>(mb.out) + i) = c;
  }
}

// Sums v[0..3] of row m, columns n .. n + 3 (those below N) finished and
// stored into their members: one store where the run lies in one member that
// takes it, else element by element.
__device__ __forceinline__ void store_run(const BOuts& o, int N, int m, int n, const float (&v)[4]) {
  const Member& mb = o.mem[member_of(o, n)];
  const int col = n - mb.n0;
  if (mb.vec && col + 4 <= mb.n) {
    store_quad(mb, m, col,
               make_float4(finish(mb, v[0], col), finish(mb, v[1], col + 1),
                           finish(mb, v[2], col + 2), finish(mb, v[3], col + 3)));
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (n + e >= N) break;
    const Member& me = o.mem[member_of(o, n + e)];
    const int ce = n + e - me.n0;
    store_one(me, (size_t)m * me.n + ce, finish(me, v[e], ce));
  }
}

// The f32 staging of a consumer warpgroup's 64 x BN results: BN f32 a row
// and a pad that keeps the pair stores of a warp off shared bank conflicts.
template <int BN>
constexpr int kStagedRow = BN * 4 + 32;

// The out path of a staged tile that no TMA store takes (its columns in
// more than one member, or in one of f32 or int8, or a split's partial
// sums): rows m0 .. m0 + 63 of columns n0 .. out, finished where z < 0 into
// each member the tile meets (its columns of whole rows in runs of 4
// results, one store of the member's kind, where the member allows, else
// element by element), else as split z's partial sums into the workspace in
// runs of 4.
template <int BN>
__device__ __forceinline__ void write_staged(const ConvShape& s, const BOuts& o,
                                             const uint8_t* stg, int n0, int m0, int z) {
  constexpr int kS = kStagedRow<BN>;
  const int t = threadIdx.x & 127;
  const int rows = min(64, s.M - m0);
  if (z >= 0) {
    constexpr int kRuns = BN / 4;  // runs of 4 results in a row
    float* ws = o.ws + ((size_t)z * (s.M - o.m_split) + (m0 - o.m_split)) * s.N;
#pragma unroll 4
    for (int idx = t; idx < 64 * kRuns; idx += 128) {
      const int row = idx / kRuns, q = idx % kRuns;
      const int n = n0 + q * 4;
      if (row >= rows || n >= s.N) continue;
      const float4 f = *reinterpret_cast<const float4*>(stg + row * kS + q * 16);
      float* dst = ws + (size_t)row * s.N + n;
      if (s.N % 4 == 0) {
        *reinterpret_cast<float4*>(dst) = f;
      } else {
        const float v[4] = {f.x, f.y, f.z, f.w};
        for (int e = 0; e < 4 && n + e < s.N; ++e) dst[e] = v[e];
      }
    }
    return;
  }
  for (int j = 0; j < o.nmem; ++j) {
    const Member& mb = o.mem[j];
    const int a = max(mb.n0, n0), b = min(mb.n0 + mb.n, n0 + BN);
    if (a >= b) continue;
    if (mb.vec) {
      // runs of 4: thread t takes run q of row `row`, then every 128th run
      // after it (no division in the loop)
      const int nr = (b - a) >> 2;
      int row = t / nr, q = t - row * nr;
      const int step_r = 128 / nr, step_q = 128 - step_r * nr;
      for (; row < rows;) {
        const int col = a + 4 * q;
        const float4 f = *reinterpret_cast<const float4*>(stg + row * kS + (col - n0) * 4);
        store_quad(mb, m0 + row, col - mb.n0, f);
        row += step_r;
        q += step_q;
        if (q >= nr) q -= nr, ++row;
      }
    } else {
      const int nc = b - a;
      for (int idx = t; idx < rows * nc; idx += 128) {
        const int row = idx / nc, col = a + idx % nc;
        const float v = reinterpret_cast<const float*>(stg + row * kS)[col - n0];
        store_one(mb, (size_t)(m0 + row) * mb.n + (col - mb.n0), v);
      }
    }
  }
}

// A consumer warpgroup's epilogue of its 64 x BN sums (rows m0 .. m0 + 63,
// columns n0 ..). A whole tile's: first a table of the tile's columns in
// shared memory (each column's bias and ReLU floor, looked up in its member
// once a tile), then each sum finished in registers (bias, ReLU) with no
// branch. Where the
// tile's columns lie in one bf16 member that TMA stores, the results are
// rounded in registers into one of two staging buffers in TMA's 128-byte
// swizzle, and one thread has TMA store them: the store runs on while the
// warpgroup multiplies its next tile, and the buffer is taken again two
// such tiles later, once the store has read it. Else they are staged in f32
// and go out by write_staged, as does a split's partial sums. The f32
// staging shares its room with the two buffers, so it first waits for every
// store issued.
template <int BN>
struct BEpi {
  static constexpr int kS = kStagedRow<BN>;
  static constexpr int kStage = 64 * kS;
  static constexpr int kBox = 64 * 128;      // a TMA box: 64 rows of 64 bf16
  static constexpr int kBuf = (BN / 64) * kBox;  // a staging buffer of the TMA store
  static_assert(2 * kBuf <= kStage, "the two buffers fit the f32 staging");
  // and the column table, to the next 1024 bytes (each warpgroup's
  // buffers start on the boundary a swizzled TMA box needs)
  static constexpr int kBytes = (kStage + BN * 8 + 1023) / 1024 * 1024;
  const ConvShape& s;
  const BOuts& o;
  const OutMaps& om;
  uint8_t* smem;
  struct State {
    int buf;  // the buffer of the next TMA-stored tile
  };
  __device__ __forceinline__ void operator()(const Unit<BN>& un, int wg,
                                             const float (&acc)[BN / 2], State& st) const {
    uint8_t* stg = smem + Layout<BN>::kOffEpi + wg * kBytes;
    float* cbias = reinterpret_cast<float*>(stg + kStage);
    float* cfloor = reinterpret_cast<float*>(stg + kStage + BN * 4);
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int r = (t >> 5) * 16 + (lane >> 2);
    const int m0 = un.m0 + 64 * wg;
    const bool whole = un.z < 0;
    // a tile TMA stores: whole, its columns below N in one member that takes it
    const int j0 = member_of(o, un.n0);
    const bool tma_tile = whole && o.mem[j0].tma &&
                          member_of(o, min(un.n0 + BN, s.N) - 1) == j0;
    if (t == 0) {
      // the buffer two TMA-stored tiles back, or all of them before f32 staging
      if (tma_tile)
        tma::bulk_wait_read<1>();
      else
        tma::bulk_wait_read<0>();
    }
    tma::named_sync(2 + wg, 128);  // the previous tile's reads of stg are done
    if (whole && t < BN) {
      // a column's bias, -0.0 where it has none (x + -0.0 is x, signed
      // zeros too), and the floor of its ReLU, -inf where it has none
      const int n = un.n0 + t;
      float b = -0.f, lo = -__int_as_float(0x7f800000);
      if (n < s.N) {
        const Member& mb = o.mem[member_of(o, n)];
        if (mb.relu) lo = 0.f;
        if (mb.bias != nullptr) b = mb.bias[n - mb.n0];
      }
      cbias[t] = b;
      cfloor[t] = lo;
    }
    if (whole) tma::named_sync(2 + wg, 128);
    uint8_t* tb = stg + st.buf * kBuf;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int c = i * 8 + (lane & 3) * 2;
      const float ninf = -__int_as_float(0x7f800000);
      float2 b = make_float2(-0.f, -0.f), lo = make_float2(ninf, ninf);
      if (whole) {
        b = *reinterpret_cast<const float2*>(cbias + c);
        lo = *reinterpret_cast<const float2*>(cfloor + c);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the bias in f32, no contraction, then the ReLU (a NaN stays)
        float v0 = __fadd_rn(acc[i * 4 + 2 * h], b.x);
        float v1 = __fadd_rn(acc[i * 4 + 2 * h + 1], b.y);
        v0 = v0 < lo.x ? lo.x : v0;
        v1 = v1 < lo.y ? lo.y : v1;
        if (tma_tile) {
          // box c / 64, byte (c % 64) * 2 of its row r, swizzled as TMA reads it
          const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(tb + (c >> 6) * kBox +
                                             swz_byte(r + 8 * h, (c & 63) * 2)) = p;
        } else {
          float* dst = reinterpret_cast<float*>(stg + (r + 8 * h) * kS) + c;
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        }
      }
    }
    if (tma_tile) {
      fence_proxy_async();  // this thread's writes, seen by the TMA store
      tma::named_sync(2 + wg, 128);
      if (t == 0) {
        const Member& mb = o.mem[j0];
        for (int box = 0; box < BN / 64; ++box) {
          const int col = un.n0 - mb.n0 + 64 * box;
          if (col < mb.n) tma::tma_store_2d(&om.m[j0], col * 2, m0, smem_addr(tb + box * kBox));
        }
        tma::bulk_commit();
      }
      st.buf ^= 1;
      return;
    }
    tma::named_sync(2 + wg, 128);
    write_staged<BN>(s, o, stg, un.n0, m0, un.z);
  }
};

// One block per SM walks the units (conv_ring.cuh's ring_conv): bf16 wgmma
// m64n{BN}k16 into f32 sums, then BEpi.
template <int BN, int kFill>
__global__ void __launch_bounds__(kBlock, 1)
    bconv_kernel(const E* __restrict__ x, const E* __restrict__ w,
                 const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ OutMaps omaps, BOuts o, ConvShape s, int units) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  float acc[BN / 2];
  ring_conv<E, BN, kFill>(x, w, &wmap, &xmap, s, units, smem, acc,
                          BEpi<BN>{s, o, omaps, smem});
  // the stores issued by each consumer warpgroup's thread 0 are done
  // before the block's shared memory goes
  if (threadIdx.x >= kProducers && (threadIdx.x & 127) == 0) tma::bulk_wait_all();
}

template <int BN>
constexpr int smem_bytes() {
  return Layout<BN>::kOffEpi + 2 * BEpi<BN>::kBytes + 1024;  // and up to 1 KB to align
}

// The split tiles' rows m_split .. M - 1: the f32 partials of every split
// added in order, split 0 first, then finished and stored as the kernel's
// epilogue does; 4 results a thread where N % 4 == 0.
__global__ void __launch_bounds__(kThreads) bconv_reduce(BOuts o, int M, int N, int splits) {
  const size_t MN = (size_t)(M - o.m_split) * N;
  const float* ws = o.ws;
  const size_t stride = (size_t)gridDim.x * kThreads;
  if (N % 4 == 0) {
    for (size_t g = (size_t)blockIdx.x * kThreads + threadIdx.x; g < MN / 4; g += stride) {
      float4 v = reinterpret_cast<const float4*>(ws)[g];
      for (int z = 1; z < splits; ++z) {
        const float4 p = reinterpret_cast<const float4*>(ws + (size_t)z * MN)[g];
        v.x = __fadd_rn(v.x, p.x);
        v.y = __fadd_rn(v.y, p.y);
        v.z = __fadd_rn(v.z, p.z);
        v.w = __fadd_rn(v.w, p.w);
      }
      const size_t i = 4 * g;
      const float vs[4] = {v.x, v.y, v.z, v.w};
      store_run(o, N, o.m_split + (int)(i / N), (int)(i % N), vs);
    }
    return;
  }
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < MN; i += stride) {
    float v = ws[i];
    for (int z = 1; z < splits; ++z) v = __fadd_rn(v, ws[(size_t)z * MN + i]);
    const int n = (int)(i % N);
    const Member& mb = o.mem[member_of(o, n)];
    const int col = n - mb.n0;
    store_one(mb, (size_t)(o.m_split + (int)(i / N)) * mb.n + col, finish(mb, v, col));
  }
}

template <int BN, int kFill>
int launch_fill(const E* x, const E* w, const CUtensorMap& wmap, const CUtensorMap& xmap,
                const OutMaps& om, const BOuts& o, const ConvShape& s, int grid,
                cudaStream_t stream) {
  static bool smem_set = false;  // per instantiation
  const cudaError_t e = allow_smem(bconv_kernel<BN, kFill>, smem_bytes<BN>(), smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  bconv_kernel<BN, kFill><<<grid, kBlock, smem_bytes<BN>(), stream>>>(x, w, wmap, xmap, om, o, s,
                                                                      units_of(s));
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_main(const E* x, const E* w, const CUtensorMap& wmap, const CUtensorMap& xmap,
                const OutMaps& om, int fill, const BOuts& o, const ConvShape& s, int grid,
                cudaStream_t stream) {
  if (fill == kTmaAB) return launch_fill<BN, kTmaAB>(x, w, wmap, xmap, om, o, s, grid, stream);
  if (fill == kTmaB) return launch_fill<BN, kTmaB>(x, w, wmap, xmap, om, o, s, grid, stream);
  return launch_fill<BN, kCopies>(x, w, wmap, xmap, om, o, s, grid, stream);
}

}  // namespace

// x: bf16 NHWC [n, H, W, C]; w: bf16 OHWI [oc, ky, kx, C], the members'
// filters concatenated on oc. nmem members (1-4): member j takes the next
// meta[4 j] columns into outs[j], a row-major [n*oy*ox, meta[4 j]] (NHWC) of
// kind meta[4 j + 2] (0 f32, 1 bf16, 2 int8 stored at clamp(rint(v * q[j]),
// -127, 127)), with bias biases[j] (f32, or null) and ReLU where meta[4 j +
// 1]; meta[4 j + 3]: the member's columns and out allow 4-result stores. A
// bf16 member of a width n % 8 == 0 at a 16-byte aligned out is stored by
// TMA from the tiles that lie in it. outs, biases, meta and q are host
// arrays. oy = (H + 2*py - ky) / sy + 1 (ox
// alike). tile_n: 128 or 64. va: bytes of one copy of x (16, 8, 4, or 2:
// element by element; C * 2 % va == 0 and x va-aligned); vb: of w over K =
// ky*kx*C (16: by TMA, w 16-byte aligned). full: the 128 x tile_n output
// tiles (row-major over [M / 128, oc / tile_n], a multiple of the tiles along
// oc) that run whole; the rest run in `splits` K ranges each (splits > 1;
// ws: f32 [splits, M - m_split, oc] with m_split = full / (tiles along oc) *
// 128 their first row, else unused). grid: blocks of the persistent walk (at
// most one per SM). The caller keeps every extent under 2^31 and splits <=
// the K chunks. Returns the launches' cudaGetLastError(), or tma::kEncodeError
// + the CUresult where a tensor map was refused.
extern "C" int boda_bconv(const void* x, const void* w, void* ws, int n, int H, int W, int C,
                          int oc, int ky, int kx, int sy, int sx, int py, int px, int tile_n,
                          int va, int vb, int full, int splits, int grid, int nmem,
                          const void* outs, const void* biases, const void* meta,
                          const void* q, void* stream) {
  const int bn = tile_n == 64 ? 64 : 128;
  const ConvShape s =
      conv_shape(n, H, W, C, oc, ky, kx, sy, sx, py, px, 2, bn, full, splits, va, vb);
  BOuts o;
  memset(&o, 0, sizeof(o));
  OutMaps om;
  memset(&om, 0, sizeof(om));
  void* const* po = static_cast<void* const*>(outs);
  const void* const* pb = static_cast<const void* const*>(biases);
  const int* pm = static_cast<const int*>(meta);
  const float* pq = static_cast<const float*>(q);
  int n0 = 0;
  o.nmem = nmem;
  for (int j = 0; j < nmem && j < kMaxMembers; ++j) {
    Member& mb = o.mem[j];
    mb.out = po[j];
    mb.bias = static_cast<const float*>(pb[j]);
    mb.n0 = n0;
    mb.n = pm[4 * j];
    mb.relu = pm[4 * j + 1];
    mb.kind = pm[4 * j + 2];
    mb.vec = pm[4 * j + 3];
    mb.q = pq[j];
    mb.tma = mb.kind == 1 && mb.n % 8 == 0 && reinterpret_cast<size_t>(mb.out) % 16 == 0;
    if (mb.tma) {
      const int rc = tma::encode_2d_u8(&om.m[j], mb.out, s.M, (uint64_t)mb.n * 2, 64, 128);
      if (rc != 0) return rc;
    }
    n0 += mb.n;
  }
  o.ws = static_cast<float*>(ws);
  o.m_split = s.full / s.tiles_n * kTile;
  const E* xe = static_cast<const E*>(x);
  const E* we = static_cast<const E*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap wmap, xmap;
  memset(&wmap, 0, sizeof(wmap));
  memset(&xmap, 0, sizeof(xmap));
  int fill = kCopies;
  const int re = fill_of(s, x, w, 2, bn, &wmap, &xmap, &fill);
  if (re != 0) return re;
  const int rc = bn == 64 ? launch_main<64>(xe, we, wmap, xmap, om, fill, o, s, grid, st)
                          : launch_main<128>(xe, we, wmap, xmap, om, fill, o, s, grid, st);
  if (rc != 0 || s.full == s.tiles) return rc;
  const size_t MN = (size_t)(s.M - o.m_split) * s.N;
  const size_t need = (MN / (s.N % 4 == 0 ? 4 : 1) + kThreads - 1) / kThreads;
  const int blocks = need < 4096 ? (int)(need > 0 ? need : 1) : 4096;
  bconv_reduce<<<blocks, kThreads, 0, st>>>(o, s.M, s.N, s.splits);
  return static_cast<int>(cudaGetLastError());
}
