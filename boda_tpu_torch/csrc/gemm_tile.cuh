// Element helpers shared by every kernel of the port: the conversions between
// the compute types (f32, bf16) and the f32 the sums run in, and a wide load
// of four consecutive elements (stem.cu and the Hopper GEMM core
// hopper_gemm.cuh take to_f32 / from_f32; resblock.cu's FFMA route also
// load_quad).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace boda {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v[0..3] = p[0..3] in f32, read with one 16-byte (f32) or 8-byte (bf16) load
// where p is aligned for it, else element by element. One wide load matters
// where a kernel's shared memory leaves little L1 to catch the narrow ones.
template <typename T>
__device__ __forceinline__ void load_quad(const T* p, float v[4]) {
  if (reinterpret_cast<size_t>(p) % (4 * sizeof(T)) == 0) {
    if constexpr (sizeof(T) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
      const float2 lo = __bfloat1622float2(q[0]);
      const float2 hi = __bfloat1622float2(q[1]);
      v[0] = lo.x;
      v[1] = lo.y;
      v[2] = hi.x;
      v[3] = hi.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = to_f32(p[j]);
  }
}

}  // namespace boda
