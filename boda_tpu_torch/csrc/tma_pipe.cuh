// The warp-specialized pipeline helpers of Hopper kernels: mbarriers, named
// barriers, the cp.async copies that signal an mbarrier when they land, 2-D
// TMA tile loads, and the host-side encoding of a TMA tensor map through the
// entry point cudaGetDriverEntryPoint returns (so a library with a plain C
// interface, linked by nvcc alone, needs no -lcuda). qconv.cu (B6) runs on
// them; hopper_gemm.cuh's cp.async ring is the older pattern that B1, B2, B3,
// B4 and B5 still use.
//
// The ring: stage s of a K-chunk ring has a "full" barrier, which the
// producer's copies complete, and an "empty" one, on which the consumers
// arrive once they are done reading the stage. Both sides walk the same
// sequence of chunks, so they agree on (stage, phase): the consumer waits for
// full[s] at parity `phase`, the producer for empty[s] at parity `phase ^ 1`
// (a fresh barrier counts as having completed the phase before its first, so
// the producer's first pass through the ring does not wait).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; nothing of libcuda is linked)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>
#include <stdint.h>

namespace boda {
namespace tma {

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes initialized mbarriers visible to the other threads and to the async
// proxy (TMA); a block barrier must follow before they are used.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival (release: this thread's earlier shared-memory writes are seen
// by a thread that waits for the phase).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also expects `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Whether the phase of parity `parity` has completed (acquire where it has).
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Cycles a wait may spin (some seconds, far past any real wait) before it
// traps: a pipeline whose arrivals never come ends its launch with an error
// instead of holding the card.
constexpr long long kHangCycles = 20000000000LL;

// Spin until the phase of parity `parity` has completed (acquire).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

// An arrival on `bar` once every cp.async this thread issued before it has
// landed. .noinc: it counts as one of the arrivals the barrier was
// initialized to expect.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// V bytes (16, 8 or 4) from global to shared, or V zero bytes where !valid
// (src-size 0 reads nothing; src must still be a global address). 16-byte
// copies bypass L1 (.cg); the narrower ones can only go through it (.ca).
template <int V>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  static_assert(V == 16 || V == 8 || V == 4, "cp.async size");
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(V),
                 "r"(valid ? V : 0)
                 : "memory");
  }
}

// The block's threads [id's group] meet: `count` threads (a multiple of 32)
// call it with the same id (1-15; 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The box at (c0 innermost, c1) of a 2-D tensor map into shared memory at
// dst, completing `bytes` of transactions on bar. The map must live in
// kernel parameter space (a __grid_constant__ parameter).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The box at (c0 innermost, c1) of a 2-D tensor map, from shared memory at
// src (laid out as tma_load_2d writes it), stored asynchronously in this
// thread's current bulk group; parts of the box past the tensor are not
// written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int c0, int c1,
                                             uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until every bulk group of this thread has completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Errors of encode_2d_u8 come back as kEncodeError + the CUresult (or +
// 999 where libcuda has no cuTensorMapEncodeTiled), above every
// cudaError_t, so a caller that reports launch codes can tell them apart.
constexpr int kEncodeError = 10000;

// cuTensorMapEncodeTiled from libcuda, looked up once.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The map of a row-major [rows, cols] byte matrix at ptr (cols % 16 == 0,
// ptr 16-byte aligned), read in boxes of box_rows x box_cols (box_cols <=
// 128) written to shared memory in the 128-byte swizzle that hopper_gemm.cuh's
// swz and wgmma descriptor read (chunk j of box row r at r*128 + ((j ^ (r %
// 8)) << 4), from a 1024-byte-aligned destination). Boxes past the matrix are
// zero-filled. Returns 0 or kEncodeError + the CUresult.
inline int encode_2d_u8(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
                        uint32_t box_rows, uint32_t box_cols) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled_fn();
  if (fn == nullptr) return kEncodeError + 999;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols};  // bytes between rows
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides,
                        box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

}  // namespace tma
}  // namespace boda
