// The Hopper GEMM core shared by tconv (B2, tconv.cu), matmul_ext (B1,
// sgemm.cu), sgemm_int8 (B3, qsgemm.cu), resblock (B5, resblock.cu) and
// fused_stem (B4, stem.cu), and the pieces of it that qconv (B6, qconv.cu)
// takes (the swizzle, the wgmma descriptor and int8 wgmma; its pipeline is
// tma_pipe.cuh's):
// C[M, N] = A[M, K] . B[N, K]^T with both operands K-contiguous. Each kernel
// brings its own operand loader (B2: the implicit-im2col window of a conv;
// B1, B3: a row-major matrix, stage_rows below; B5: an image band, then its
// own intermediate results in shared memory; B4: an image patch, its A
// fragments loaded from it into registers, wgmma_ra, its filter resident in
// the stage layout) and its own epilogue; the core holds what they share.
//
// Tensor-core route (bf16 and int8). A block tile is 128 rows of A by BN
// (128 or 64) rows of B (or, for products with few rows, 64 rows of A that
// both warpgroups share, each taking half of B's rows: resblock.cu). K
// advances in chunks of 128 bytes of each row (64 bf16 or 128 int8
// values), staged by cp.async through a ring of 3
// shared-memory stages: rows of 128 bytes in 16-byte chunks XOR-swizzled by
// row % 8, which is the layout wgmma reads as "K-major, 128-byte swizzle".
// Two warpgroups each multiply their 64 rows of A by the whole B tile with
// wgmma.mma_async straight from shared memory: m64n128k16 or m64n64k16 for
// bf16 (f32 accumulators), m64n128k32 for int8 (s32 accumulators). Both
// step 32 bytes along K, so a chunk is 4 steps in either type and the ring,
// the descriptors and the fragment layout of the accumulators are the same
// code for both. One wgmma group stays in flight while the next chunk's
// copies issue, and a kernel that runs several products in a row keeps the
// ring going across them (ring_passes; ring_product is the single product).
//
// FFMA route (f32). A block tile is 128 rows by BN (128 or 64) columns, K in
// chunks of 8, double-buffered through registers into shared memory; each
// thread owns an 8 x (BN / 16) micro-tile read as float4 from shared memory
// and sums in full FP32 (never TF32). In matmul_ext a warp whose 16 rows
// all lie past M skips the products (ffma_product).
//
// Split-K: a kernel may run the K chunks of grid.z splits into an f32
// workspace; split_reduce then adds the splits in order, then bias, ReLU and
// the one rounding. No atomics: results repeat bit for bit.
//
// What bounds the core on an H100 SXM (989 TF/s bf16 and 1979 TOPS int8
// dense, 67 TF/s FP32, 3.35 TB/s HBM) where a product is large enough to
// fill the card (each kernel's header gives its own cases):
//  - tensor-core route: every 128 x 128 tile stages its 128 + 128 rows from
//    L2 for each chunk, 32 KB that feed 64 bf16 flop or 128 int8 operations
//    per staged byte; at the peak rates that is about 15.5 TB/s of L2 reads
//    over the card, several times the HBM rate, so the staging and its
//    latency, not the tensor cores, set the pace. The 3-stage ring keeps two
//    chunks in flight and two blocks share an SM (97 KB of shared memory
//    each, <= 128 registers a thread). tma_pipe.cuh holds the warp-
//    specialized TMA / mbarrier pipeline B6 runs on instead (producer
//    warps, full and empty barriers per stage, B by TMA), the pattern for
//    moving B1, B2 and B5 off this ring; wider tiles (128 x 256) or a TMA
//    multicast of B across a cluster are not tried.
//  - FFMA route: 4 float4 shared loads per 64 FFMA (8 x 8 micro-tile) or 3
//    per 32 (8 x 4), so the FFMA issue rate of 67 TF/s bounds it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "gemm_tile.cuh"  // boda::to_f32, boda::from_f32

namespace boda {
namespace hopper {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kTileM = 128;     // rows of A per block tile, 64 per warpgroup
constexpr int kRowBytes = 128;  // bytes of one row in one K chunk of a stage
constexpr int kStages = 3;      // shared-memory ring of the tensor-core route

// The stage buffers of an AM x BN tensor-core tile (AM = 128 rows of A, or
// 64 where both warpgroups share the same rows): A then B in each stage,
// every buffer on a 1024-byte boundary (the swizzle's repeat).
template <int BN, int AM = kTileM>
struct Ring {
  static_assert(BN == 64 || BN == 128, "tile width");
  static_assert(AM == 64 || AM == 128, "tile rows");
  static constexpr int kBytesA = AM * kRowBytes;  // 16 or 8 KB
  static constexpr int kBytesB = BN * kRowBytes;  // 16 or 8 KB
  static constexpr int kStageBytes = kBytesA + kBytesB;
  // the ring and up to 1 KB to align it
  static constexpr int kSmem = kStages * kStageBytes + 1024;
  __device__ static uint8_t* a(uint8_t* smem, int st) { return smem + st * kStageBytes; }
  __device__ static uint8_t* b(uint8_t* smem, int st) {
    return smem + st * kStageBytes + kBytesA;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory of a tensor-core kernel, moved up to 1024 bytes.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
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

// Byte offset of 16-byte chunk j of row r in a stage buffer: rows of 128
// bytes with the chunks XOR-swizzled by row % 8 (8-row groups 1024 bytes
// apart).
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return (uint32_t)(r * kRowBytes + ((j ^ (r & 7)) << 4));
}

// wgmma shared-memory matrix descriptor of a K-major, 128-byte-swizzled
// operand at shared address addr: start address >> 4 (bits 0-13), leading
// byte offset 1 (unused by this layout), stride byte offset 1024 >> 4
// (bits 32-45), layout type 1 = 128-byte swizzle (bits 62-63). The 32-byte
// K step ks of a chunk starts 32 * ks bytes further (+ 2 * ks in the
// descriptor); the hardware applies the swizzle to the computed addresses.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 128 tile of this warpgroup] += A[64 x 16] . B[128 x 16]^T, both
// bf16 K-major in shared memory, f32 accumulators in registers.
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db) {
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

// d[64 x 64] += A[64 x 16] . B[64 x 16]^T, bf16, f32 accumulators.
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] . B[64 x 16]^T, bf16, with A from registers: warp
// w of the warpgroup holds rows 16 w .. 16 w + 15 as the m16n8k16 fragment,
// a[0], a[1]: K values 2 (lane % 4), + 1 of rows lane / 4 and lane / 4 + 8;
// a[2], a[3]: the same rows at K + 8 (a kernel whose A is a gather that no
// 128-byte row holds, fused_stem's im2col of a 3-channel patch). The
// registers must stay as they are until the product has been waited for.
__device__ __forceinline__ void wgmma_ra(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 32] . B[128 x 32]^T, int8 K-major, s32
// accumulators (exact; integer wgmma takes no scale or transpose immediates).
__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (they are the operands it works on).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

// The tensor-core products of one block as one pipeline: `npass` products
// ("passes") of nk K chunks each, kc0 .. kc0 + nk - 1, run back to back
// through the ring, so that a pass's first copies are in flight while the
// pass before it finishes and runs its epilogue. load(st, p, kc) stages chunk
// kc of pass p into ring stage st (the core commits the copies), then each
// warpgroup issues the chunk's four 32-byte wgmma steps. a_addr(st, p, kc) is
// the shared address of the pass's A rows for that chunk: the ring's stage,
// or an operand that already lies in shared memory in the stage layout (then
// load stages B alone). After a pass's last chunk, epi(p) runs with the
// pass's sums in acc; acc is zeroed before each pass. kSplitN false: a 128 x
// BN tile, each warpgroup its 64 rows of A by all BN rows of B (acc: 64 x BN,
// float[BN / 2] for bf16, int[64] for int8). kSplitN true: a 64 x BN tile,
// both warpgroups the same 64 rows of A, each by its BN / 2 rows of B (acc:
// 64 x BN / 2), for products with few rows; the ring is then Ring<BN, 64>.
// Every thread of the block must call it, and must pass a block barrier
// before the ring is written again.
template <int BN, bool kSplitN, typename Acc, int NA, typename Load, typename AAddr,
          typename Epi>
__device__ __forceinline__ void ring_passes(uint8_t* smem, int npass, int kc0, int nk,
                                            const Load& load, const AAddr& a_addr,
                                            const Epi& epi, Acc (&acc)[NA]) {
  using R = Ring<BN, kSplitN ? 64 : kTileM>;
  static_assert(NA == (kSplitN ? BN / 4 : BN / 2), "accumulators of the warpgroup's tile");
  const int wg = threadIdx.x >> 7;  // warpgroup
  const uint32_t a_off = kSplitN ? 0 : wg * 64 * kRowBytes;
  const uint32_t b_off = kSplitN ? wg * (BN / 2) * kRowBytes : 0;
  const int steps = npass * nk;
  int lp = 0, lk = 0;  // pass and chunk of the next copy
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) {
      load(st, lp, kc0 + lk);
      if (++lk == nk) lk = 0, ++lp;
    }
    cp_async_commit();
  }
  // The products of step g (chunk kc of pass p) run while the copies of step
  // g + 2 are issued, be they of this pass or the next: that stage held step
  // g - 1, whose products every warpgroup has finished by the second
  // barrier. The accumulators are read only after a pass's own wait, outside
  // the chunk loop: read inside it, they make the compiler serialize the
  // wgmma groups.
  int g = 0;
  for (int p = 0; p < npass; ++p) {
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0;
    for (int kc = 0; kc < nk; ++kc, ++g) {
      const int st = g % kStages;
      cp_async_wait<kStages - 2>();
      fence_proxy_async();
      __syncthreads();  // step g is in shared memory
      const uint64_t da = smem_desc(a_addr(st, p, kc0 + kc) + a_off);
      const uint64_t db = smem_desc(smem_addr(R::b(smem, st)) + b_off);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kRowBytes / 32; ++ks) wgmma(acc, da + 2 * ks, db + 2 * ks);
      wgmma_commit();
      wgmma_wait<1>();  // step g - 1's products are done
      fence_acc(acc);
      __syncthreads();  // in both warpgroups
      if (g + kStages - 1 < steps) {
        load((g + kStages - 1) % kStages, lp, kc0 + lk);
        if (++lk == nk) lk = 0, ++lp;
      }
      cp_async_commit();
    }
    wgmma_wait<0>();  // the pass's sums are complete
    fence_acc(acc);
    epi(p);
  }
  cp_async_wait<0>();
}

// One product of a 128 x BN tile over the K chunks kc0 .. kc0 + nloc - 1,
// A and B both through the ring (Ring<BN>::a / ::b): load(st, kc) stages a
// chunk; the sums are left in acc.
template <int BN, typename Acc, int NA, typename Load>
__device__ __forceinline__ void ring_product(uint8_t* smem, int kc0, int nloc, const Load& load,
                                             Acc (&acc)[NA]) {
  ring_passes<BN, false>(
      smem, 1, kc0, nloc, [&](int st, int, int kc) { load(st, kc); },
      [&](int st, int, int) { return smem_addr(Ring<BN>::a(smem, st)); }, [](int) {}, acc);
}

// Calls f(r, c, v0, v1) for each pair of accumulators of this thread: rows
// r and r + 8 of the block tile each hold columns c and c + 1. Accumulator
// i*4 + {0,1,2,3}: rows r, r, r+8, r+8 and columns c, c+1, c, c+1 of 8-column
// group i, r = 64 wg + 16 wq + lane / 4, c = 8 i + 2 (lane % 4). The same
// layout holds for f32 and s32 accumulators.
template <typename Acc, int NA, typename F>
__device__ __forceinline__ void for_pairs(const Acc (&acc)[NA], const F& f) {
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < NA / 4; ++i) {
    const int c = i * 8 + (lane & 3) * 2;
    f(r, c, acc[i * 4 + 0], acc[i * 4 + 1]);
    f(r + 8, c, acc[i * 4 + 2], acc[i * 4 + 3]);
  }
}

// Stage K chunk kc (128 bytes of each row) of rows r0 .. r0 + R - 1 of a
// row-major [rows, K] matrix X of 1- or 2-byte elements into the stage
// buffer at shared address s (generic pointer sp). Thread t copies 16-byte
// chunk j = t % 8 of tile rows t / 8 + 32 i. kVec: cp.async copies, zero-
// filled past `rows` and K (K * sizeof(T) % 16 == 0 and X 16-byte aligned);
// else element by element, zero outside. Offsets are 64-bit.
template <int R, bool kVec, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ X, int rows, int K, int r0,
                                           int kc, uint32_t s, uint8_t* sp) {
  constexpr int kPer = 16 / sizeof(T);  // elements of a 16-byte chunk
  const int j = threadIdx.x & 7;
  const int k = kc * (kRowBytes / (int)sizeof(T)) + j * kPer;
#pragma unroll
  for (int i = 0; i < R / 32; ++i) {
    const int r = (threadIdx.x >> 3) + 32 * i;
    const int row = r0 + r;
    if constexpr (kVec) {
      const bool v = row < rows && k < K;
      cp_async16(s + swz(r, j), v ? X + (size_t)row * K + k : X, v);
    } else {
      union {
        uint4 v;
        T e[kPer];
      } u;
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        u.e[e] = (row < rows && k + e < K) ? X[(size_t)row * K + k + e] : T(0);
      *reinterpret_cast<uint4*>(sp + swz(r, j)) = u.v;
    }
  }
}

// ---------------------------------------------------------------- FFMA route

constexpr int kBK32 = 8;   // f32 K chunk
constexpr int kPad32 = 4;  // f32 shared rows padded: stores stay off one bank

// The FFMA product of one 128 x BN block tile over the K chunks kc0 ..
// kc0 + nloc - 1. load(r, k, a, b, want_b) fills a[0..3] with A's tile row r
// at k .. k+3 and, where want_b, b[0..3] with B's tile row r, in f32 and
// zero outside the matrices; thread t loads row t / 2 at quad t % 2 of each
// chunk. acc[i][j]: rows (i < 4 ? 4 ty + i : 64 + 4 ty + i - 4) and columns
// 4 tx + (j % 4) + 64 (j / 4) of the tile, tx = t % 16, ty = t / 16.
// kSkipIdle: a warp whose rows all lie past rows_left = M - m0 skips the
// products (its accumulators are never stored). matmul_ext sets it: its fc
// at M = 1 or 32 fills one or four of a tile's eight warps. tconv does not:
// its tiles are full, and its FFMA loop ran faster without the branch (the
// kernel alone by split count, PERF.md). Every thread must call it.
template <int BN, bool kSkipIdle, typename Load>
__device__ __forceinline__ void ffma_product(int kc0, int nloc, int rows_left, const Load& load,
                                             float (&acc)[8][BN / 16]) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float As[2][kBK32][kTileM + kPad32];
  __shared__ __align__(16) float Bs[2][kBK32][BN + kPad32];
  const int lr = threadIdx.x >> 1;
  const int kq = (threadIdx.x & 1) * 4;
  const bool want_b = BN == kTileM || lr < BN;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  // warp w owns rows 8w .. 8w+7 and 64 + 8w .. 64 + 8w + 7
  const bool active = !kSkipIdle || 8 * (threadIdx.x >> 5) < rows_left;

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float av[4], bv[4];
  auto store = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      As[buf][kq + e][lr] = av[e];
      if (want_b) Bs[buf][kq + e][lr] = bv[e];
    }
  };
  if (nloc > 0) {
    load(lr, kc0 * kBK32 + kq, av, bv, want_b);
    store(0);
  }
  __syncthreads();
  for (int it = 0; it < nloc; ++it) {
    const int cur = it & 1;
    const bool more = it + 1 < nloc;
    if (more) load(lr, (kc0 + it + 1) * kBK32 + kq, av, bv, want_b);
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kBK32; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float b[TN];
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 bq = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 * h + tx * 4]);
          b[4 * h + 0] = bq.x;
          b[4 * h + 1] = bq.y;
          b[4 * h + 2] = bq.z;
          b[4 * h + 3] = bq.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (more) store(cur ^ 1);
    __syncthreads();
  }
}

// Calls f(r, c, v) for each run of four columns c .. c+3 of one tile row r
// in this thread's FFMA accumulators, v[0..3] their values.
template <int BN, typename F>
__device__ __forceinline__ void for_quads(const float (&acc)[8][BN / 16], const F& f) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
#pragma unroll
    for (int h = 0; h < BN / 64; ++h) {
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
      f(r, 64 * h + tx * 4, v);
    }
  }
}

// ---------------------------------------------------------------- split-K

// The K chunks of this block's split: [kc0, kc1) of `chunks`.
__device__ __forceinline__ void split_range(int chunks, int chunks_per_split, int& kc0,
                                            int& kc1) {
  kc0 = blockIdx.z * chunks_per_split;
  kc1 = min(chunks, kc0 + chunks_per_split);
}

// The epilogue of one output element: + bias[n] in f32 (bias may be null),
// ReLU where relu != 0, one rounding to TOut.
template <typename TOut>
__device__ __forceinline__ TOut finish(float v, const float* __restrict__ bias, int n, int relu) {
  if (bias != nullptr) v += bias[n];
  if (relu && v < 0.f) v = 0.f;
  return from_f32<TOut>(v);
}

// The epilogue of two adjacent outputs (m, n) and (m, n + 1) of a row-major
// [M, N] product, n even: with ws, the f32 sums into this split's slice of
// the workspace; else finished into C. One pair store where both lie inside
// and the pair is aligned; offsets are 64-bit.
template <typename TOut>
__device__ __forceinline__ void store_pair(int M, int N, int m, int n, float v0, float v1,
                                           const float* __restrict__ bias, TOut* __restrict__ C,
                                           float* __restrict__ ws, int relu) {
  if (m >= M || n >= N) return;
  const bool two = n + 1 < N;
  if (ws != nullptr) {
    const size_t j = ((size_t)blockIdx.z * M + m) * N + n;
    if (two && j % 2 == 0) {
      *reinterpret_cast<float2*>(ws + j) = make_float2(v0, v1);
    } else {
      ws[j] = v0;
      if (two) ws[j + 1] = v1;
    }
    return;
  }
  const size_t i = (size_t)m * N + n;
  const TOut o0 = finish<TOut>(v0, bias, n, relu);
  if (!two) {
    C[i] = o0;
    return;
  }
  const TOut o1 = finish<TOut>(v1, bias, n + 1, relu);
  if (i % 2 != 0) {
    C[i] = o0;
    C[i + 1] = o1;
  } else if constexpr (sizeof(TOut) == 4) {
    *reinterpret_cast<float2*>(C + i) = make_float2(o0, o1);
  } else {
    __nv_bfloat162 v;
    v.x = o0;
    v.y = o1;
    *reinterpret_cast<__nv_bfloat162*>(C + i) = v;
  }
}

}  // namespace hopper
}  // namespace boda

namespace {

// out[i] = finish(sum over splits z of ws[z * MN + i]), the splits added in
// order, for the MN elements of a row-major [M, N] output.
template <typename TOut>
__global__ void __launch_bounds__(boda::hopper::kThreads)
    split_reduce(const float* __restrict__ ws, const float* __restrict__ bias,
                 TOut* __restrict__ out, size_t MN, int N, int splits, int relu) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += ws[(size_t)z * MN + i];
    out[i] = boda::hopper::finish<TOut>(v, bias, (int)(i % N), relu);
  }
}

template <typename TOut>
cudaError_t launch_split_reduce(const float* ws, const float* bias, TOut* out, size_t MN, int N,
                                int splits, int relu, cudaStream_t stream) {
  constexpr int kT = boda::hopper::kThreads;
  const size_t need = (MN + kT - 1) / kT;
  const int blocks = need < 8192 ? (int)need : 8192;
  split_reduce<TOut><<<blocks, kT, 0, stream>>>(ws, bias, out, MN, N, splits, relu);
  return cudaGetLastError();
}

// Opts a tensor-core kernel into the dynamic shared memory of its ring (over
// the 48 KB default), once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

}  // namespace
