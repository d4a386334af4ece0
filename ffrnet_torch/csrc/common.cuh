// Helpers shared by the port's kernels: fp32 <-> storage-type conversion
// and a warp sum. Every kernel computes in fp32 and stores in the input's
// type (float or bf16), as the Pallas kernels it replaces do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ffr {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 1 / max(sqrt(s), 1e-12): F.normalize's eps applies to the norm, not to s.
__device__ __forceinline__ float inv_norm(float sum_sq) {
  return 1.0f / fmaxf(sqrtf(sum_sq), 1e-12f);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

}  // namespace ffr
