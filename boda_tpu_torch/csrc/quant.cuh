// The int8 quantize steps shared by sgemm_int8's quantize pass (qsgemm.cu) and
// the int8 conv's activation quantize (qconv.cu): the NaN-keeping max, its
// block reduction, the partial maxima of |x| over one or two operands, and
// q8, the symmetric quantize of one value with IEEE division and round half
// to even.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_gemm.cuh"  // boda::hopper::kThreads

namespace {

constexpr int kParts = boda::hopper::kThreads;  // amax partial maxima per operand

// max(a, b), NaN where either is NaN, as torch.amax and jnp.max take it (fmaxf
// drops a NaN operand, which would give a NaN-holding operand a finite scale)
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

// max(m, |v|) over the values of 16 bytes of f32 (4) or bf16 (8); a bf16 is
// the high half of the f32 of the same value
template <typename T>
__device__ __forceinline__ float abs_max16(float m, uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      m = nan_max(m, fabsf(__uint_as_float(w[i])));
    } else {
      m = nan_max(m, nan_max(fabsf(__uint_as_float(w[i] << 16)),
                             fabsf(__uint_as_float(w[i] & 0xffff0000u))));
    }
  }
  return m;
}

// The max of v over the block, in every thread.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float red[boda::hopper::kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red is free (a previous call's reads are done)
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < boda::hopper::kThreads / 32; ++w) v = nan_max(v, red[w]);
  return v;
}

// part[y * kParts + x] = max |.| over block x's share of operand y (0: a of
// na elements, 1: b of nb; a grid of one row reads a alone). vec: the operand
// is 16-byte aligned, read in 16-byte loads.
template <typename T>
__global__ void __launch_bounds__(boda::hopper::kThreads)
    quant_amax(const T* __restrict__ a, size_t na, int vec_a, const T* __restrict__ b, size_t nb,
               int vec_b, float* __restrict__ part) {
  constexpr int kPer = 16 / sizeof(T);
  const T* x = blockIdx.y ? b : a;
  const size_t n = blockIdx.y ? nb : na;
  const bool vec = blockIdx.y ? vec_b : vec_a;
  const size_t stride = (size_t)gridDim.x * boda::hopper::kThreads;
  const size_t t0 = (size_t)blockIdx.x * boda::hopper::kThreads + threadIdx.x;
  float m = 0.f;
  size_t tail = 0;
  if (vec) {
    const uint4* x16 = reinterpret_cast<const uint4*>(x);
    const size_t n16 = n / kPer;
    size_t i = t0;
    for (; i + 3 * stride < n16; i += 4 * stride) {  // four loads in flight
      const uint4 v0 = __ldg(x16 + i), v1 = __ldg(x16 + i + stride);
      const uint4 v2 = __ldg(x16 + i + 2 * stride), v3 = __ldg(x16 + i + 3 * stride);
      m = abs_max16<T>(abs_max16<T>(m, v0), v1);
      m = abs_max16<T>(abs_max16<T>(m, v2), v3);
    }
    for (; i < n16; i += stride) m = abs_max16<T>(m, __ldg(x16 + i));
    tail = n16 * kPer;
  }
  for (size_t i = tail + t0; i < n; i += stride) m = nan_max(m, fabsf(boda::to_f32(x[i])));
  m = block_max(m);
  if (threadIdx.x == 0) part[blockIdx.y * kParts + blockIdx.x] = m;
}

// clamp(round_half_even(v / s), -127, 127); NaN (a NaN operand, or inf / inf)
// becomes 0, as torch's and XLA's float-to-int8 conversions make it
__device__ __forceinline__ int8_t q8(float v, float s) {
  return (int8_t)max(-127, min(__float2int_rn(__fdiv_rn(v, s)), 127));
}

}  // namespace
